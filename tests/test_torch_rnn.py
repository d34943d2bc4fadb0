"""PyTorch port, LSTM: the plain versions of kernels B, 2 and 3 (both
directions and one), ``BiLstmScan``/``LstmScan``, ``bilstm_apply`` and
``lstm_apply`` against the JAX package's Pallas LSTM kernels in interpret
mode.

float32; atol 1e-6 on forwards, atol 2e-5 + rtol 1e-4 on backwards and
gradients (the JAX kernel tests' bars).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from danet_tpu.ops import rnn as jrnn  # noqa: E402
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.ops import rnn as trnn  # noqa: E402
from danet_tpu_torch.ops.cuda import lstm as cuda_lstm  # noqa: E402


@pytest.mark.parametrize("act", ["tanh", "linear"])
def test_torch_bilstm_apply_matches_pallas_interpret(fresh_hparams, act):
    T, B, I, H = 8, 3, 5, 6
    params = jrnn.bilstm_init(jax.random.PRNGKey(7), I, H,
                              gate_bias=(0.0, 1.5, -1.0, 1.0))
    x = np.random.RandomState(7).randn(B, T, I).astype(np.float32)
    ref = np.asarray(jrnn.bilstm_apply(params, jnp.asarray(x), act,
                                       backend="pallas-interpret"))
    tparams = weights.from_jax(jax.device_get(params))
    for backend in ("auto", "pallas", "xla"):
        out = trnn.bilstm_apply(tparams, torch.from_numpy(x), act,
                                backend=backend).numpy()
        assert out.shape == (B, T, 2 * H)
        np.testing.assert_allclose(out, ref, atol=1e-6)


def _lean_cases(b_default):
    """(tanh_cand, B) of the lean scans' tests: both candidates at the
    case's own batch (ids as before) and at the serving batches 1 and 4."""
    return [pytest.param(tanh, b, id=str(tanh) if b == b_default
                         else "%s-B%d" % (tanh, b))
            for b in (b_default, 1, 4) for tanh in (True, False)]


@pytest.mark.parametrize("tanh_cand, B", _lean_cases(2))
def test_torch_bilstm_scan_plain_matches_pallas_interpret(fresh_hparams,
                                                          tanh_cand, B):
    """The scan alone, with nonzero initial state (the kernel's full
    contract, not only the zeros bilstm_apply passes)."""
    from danet_tpu.ops.pallas.lstm import bilstm_scan_pallas

    T, H = 7, 5
    rs = np.random.RandomState(3)
    xp = rs.randn(T, 2, B, 4 * H).astype(np.float32)
    wh = (rs.randn(2, H, 4 * H) * 0.4).astype(np.float32)
    c0 = rs.randn(2, B, H).astype(np.float32)
    h0 = rs.randn(2, B, H).astype(np.float32)
    ref = np.asarray(bilstm_scan_pallas(*map(jnp.asarray, (xp, wh, c0, h0)),
                                        tanh_cand, True))
    args = [torch.from_numpy(a) for a in (xp, wh, c0, h0)]
    before = cuda_lstm.bilstm_scan.launches
    out = cuda_lstm.bilstm_scan(*args, tanh_cand).numpy()
    assert cuda_lstm.bilstm_scan.launches == before  # CPU: plain version
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_torch_bilstm_rejects_unknown_backend(fresh_hparams):
    tparams = {d: {"wx": torch.zeros(2, 4, 3), "wh": torch.zeros(3, 4, 3),
                   "b": torch.zeros(4, 3)} for d in ("fwd", "bwd")}
    with pytest.raises(ValueError):
        trnn.bilstm_apply(tparams, torch.zeros(1, 4, 2), backend="cudnn")


def _scan_case(seed, t=7, b=2, h=5):
    """xp, wh, c0, h0 with a nonzero initial state, and a cotangent d_hs."""
    rs = np.random.RandomState(seed)
    xp = rs.randn(t, 2, b, 4 * h).astype(np.float32)
    wh = (rs.randn(2, h, 4 * h) * 0.4).astype(np.float32)
    c0 = rs.randn(2, b, h).astype(np.float32)
    h0 = rs.randn(2, b, h).astype(np.float32)
    d_hs = rs.randn(t, 2, b, h).astype(np.float32)
    return (xp, wh, c0, h0), d_hs


@pytest.mark.parametrize("tanh_cand", [True, False])
def test_torch_bilstm_scan_train_plain_matches_pallas_interpret(
        fresh_hparams, tanh_cand):
    """Kernel 2's plain version against the residual-saving Pallas forward
    (hs, cs, acts), atol 1e-6."""
    from danet_tpu.ops.pallas.lstm import _fwd_call_jit

    args, _ = _scan_case(4)
    ref = _fwd_call_jit(*map(jnp.asarray, args), tanh_cand=tanh_cand,
                        interpret=True, n_dirs=2, save=True)
    targs = [torch.from_numpy(a) for a in args]
    before = cuda_lstm.bilstm_scan_train.launches
    out = cuda_lstm.bilstm_scan_train(*targs, tanh_cand)
    assert cuda_lstm.bilstm_scan_train.launches == before
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


@pytest.mark.parametrize("tanh_cand", [True, False])
def test_torch_bilstm_scan_bwd_plain_matches_pallas_interpret(
        fresh_hparams, tanh_cand):
    """Kernel 3's plain version against the Pallas backward (dxp, dc0,
    dh0) on the same residuals, atol 2e-5 / rtol 1e-4."""
    from danet_tpu.ops.pallas.lstm import _bwd_call_jit, _fwd_call_jit

    (xp, wh, c0, h0), d_hs = _scan_case(5)
    _, cs, acts = _fwd_call_jit(*map(jnp.asarray, (xp, wh, c0, h0)),
                                tanh_cand=tanh_cand, interpret=True,
                                n_dirs=2, save=True)
    cs, acts = np.array(cs), np.array(acts)
    c_prev = np.concatenate([c0[None], cs[:-1]])
    ref = _bwd_call_jit(*map(jnp.asarray, (d_hs, acts, cs, c_prev, wh)),
                        tanh_cand=tanh_cand, interpret=True, n_dirs=2)
    before = cuda_lstm.bilstm_scan_bwd.launches
    out = cuda_lstm.bilstm_scan_bwd(
        *[torch.from_numpy(a) for a in (d_hs, acts, cs, c_prev, wh)],
        tanh_cand)
    assert cuda_lstm.bilstm_scan_bwd.launches == before
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("tanh_cand", [True, False])
def test_torch_bilstm_scan_grads_match_jax(fresh_hparams, tanh_cand):
    """BiLstmScan's gradients of xp, wh, c0 and h0 (nonzero initial state)
    against jax.grad through bilstm_scan_pallas in interpret mode, atol
    2e-5 / rtol 1e-4; the plain backward route gives the same."""
    from danet_tpu.ops.pallas.lstm import bilstm_scan_pallas

    args, d_hs = _scan_case(6)
    ref = jax.grad(
        lambda *a: jnp.sum(bilstm_scan_pallas(*a, tanh_cand, True)
                           * jnp.asarray(d_hs)),
        argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    for use_kernel in (True, False):
        targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
        hs = cuda_lstm.BiLstmScan.apply(*targs, tanh_cand, use_kernel)
        hs.backward(torch.from_numpy(d_hs))
        for a, r in zip(targs, ref):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(r),
                                       atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("tanh_cand", [True, False])
def test_torch_bilstm_scan_bwd_plain_matches_autograd(fresh_hparams,
                                                      tanh_cand):
    """The hand-written backward against torch.autograd of the plain
    forward, on the same inputs and cotangent."""
    args, d_hs = _scan_case(7)
    grads = []
    for custom in (True, False):
        targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
        hs = (cuda_lstm.BiLstmScan.apply(*targs, tanh_cand, False) if custom
              else cuda_lstm.bilstm_scan_plain(*targs, tanh_cand))
        hs.backward(torch.from_numpy(d_hs))
        grads.append([a.grad.numpy() for a in targs])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("act", ["tanh", "linear"])
def test_torch_bilstm_apply_grads_match_jax(fresh_hparams, act):
    """Parameter and input gradients of bilstm_apply against the JAX
    package's fused Pallas BiLSTM (interpret mode)."""
    T, B, I, H = 8, 3, 5, 6
    params = jrnn.bilstm_init(jax.random.PRNGKey(8), I, H,
                              gate_bias=(0.0, 1.5, -1.0, 1.0))
    x = np.random.RandomState(8).randn(B, T, I).astype(np.float32)
    g_ref, gx_ref = jax.grad(lambda p, v: jnp.sum(jrnn.bilstm_apply(
        p, v, act, backend="pallas-interpret") ** 2), argnums=(0, 1))(
            params, jnp.asarray(x))
    tparams = weights.from_jax(jax.device_get(params))
    ps = weights.leaves(tparams)
    for p in ps:
        p.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    (trnn.bilstm_apply(tparams, tx, act) ** 2).sum().backward()
    ref = weights.leaves(weights.from_jax(jax.device_get(g_ref)))
    for p, r in zip(ps, ref):
        np.testing.assert_allclose(p.grad.numpy(), r.numpy(), atol=2e-5,
                                   rtol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_ref),
                               atol=2e-5, rtol=1e-4)


def test_torch_dropout_statistics_and_identity(fresh_hparams):
    """Inverted dropout keeps about keep_prob of the elements, scaled by
    1/keep_prob, from an explicit generator; keep_prob 1 is the identity,
    also through bilstm_apply."""
    from danet_tpu_torch.ops.nn import dropout

    x = torch.ones(200, 500)
    y = dropout(torch.Generator().manual_seed(0), x, 0.8)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / 0.8, rtol=1e-6)
    assert abs(float(y.mean()) - 1.0) < 0.02
    y2 = dropout(torch.Generator().manual_seed(0), x, 0.8)
    assert torch.equal(y, y2)
    assert dropout(torch.Generator(), x, 1.0) is x

    tparams = weights.from_jax(jax.device_get(jrnn.bilstm_init(
        jax.random.PRNGKey(9), 4, 3)))
    v = torch.from_numpy(np.random.RandomState(9).randn(2, 5, 4).astype(
        np.float32))
    ref = trnn.bilstm_apply(tparams, v)
    same = trnn.bilstm_apply(tparams, v, dropout_rng=torch.Generator(),
                             keep_prob=1.0)
    assert torch.equal(ref, same)
    dropped = trnn.bilstm_apply(tparams, v,
                                dropout_rng=torch.Generator().manual_seed(1),
                                keep_prob=0.5)
    nz = dropped != 0
    np.testing.assert_allclose(dropped[nz].numpy(), 2 * ref[nz].numpy(),
                               rtol=1e-6)


def test_torch_bilstm_wrappers_refuse_other_devices(fresh_hparams):
    """A wrapper takes its plain version only for CPU tensors: on any other
    device than CPU or CUDA it raises (on CUDA it launches its kernel)."""
    args = [torch.zeros(s, device="meta") for s in
            ((3, 2, 1, 8), (2, 2, 8), (2, 1, 2), (2, 1, 2))]
    with pytest.raises(ValueError):
        cuda_lstm.bilstm_scan(*args, True)
    with pytest.raises(ValueError):
        cuda_lstm.bilstm_scan_train(*args, True)
    with pytest.raises(ValueError):
        cuda_lstm.bilstm_scan_bwd(torch.zeros((3, 2, 1, 2), device="meta"),
                                  args[0], args[2], args[2], args[1], True)


# ------------------------------------------------- one-direction LSTM
def _uni_case(seed, t=7, b=3, h=5):
    """xp [T, B, 4H], wh [H, 4H], nonzero c0/h0 [B, H], d_hs [T, B, H]."""
    rs = np.random.RandomState(seed)
    xp = rs.randn(t, b, 4 * h).astype(np.float32)
    wh = (rs.randn(h, 4 * h) * 0.4).astype(np.float32)
    c0 = rs.randn(b, h).astype(np.float32)
    h0 = rs.randn(b, h).astype(np.float32)
    d_hs = rs.randn(t, b, h).astype(np.float32)
    return (xp, wh, c0, h0), d_hs


@pytest.mark.parametrize("tanh_cand, B", _lean_cases(3))
def test_torch_lstm_scan_plain_matches_pallas_interpret(fresh_hparams,
                                                        tanh_cand, B):
    """The one-direction lean forward against lstm_scan_pallas, atol 1e-6;
    on CPU tensors the wrapper launches nothing."""
    from danet_tpu.ops.pallas.lstm import lstm_scan_pallas

    args, _ = _uni_case(11, b=B)
    ref = lstm_scan_pallas(*map(jnp.asarray, args), tanh_cand, True)
    before = cuda_lstm.lstm_scan.launches
    out = cuda_lstm.lstm_scan(*[torch.from_numpy(a) for a in args],
                              tanh_cand)
    assert cuda_lstm.lstm_scan.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("tanh_cand", [True, False])
def test_torch_lstm_scan_train_plain_matches_pallas_interpret(
        fresh_hparams, tanh_cand):
    """hs, cs and acts against _fwd_call with n_dirs=1, save=True."""
    from danet_tpu.ops.pallas.lstm import _fwd_call_jit

    args, _ = _uni_case(12, t=8)
    ref = _fwd_call_jit(*map(jnp.asarray, args), tanh_cand=tanh_cand,
                        interpret=True, n_dirs=1, save=True)
    before = cuda_lstm.lstm_scan_train.launches
    out = cuda_lstm.lstm_scan_train(*[torch.from_numpy(a) for a in args],
                                    tanh_cand)
    assert cuda_lstm.lstm_scan_train.launches == before
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


@pytest.mark.parametrize("tanh_cand", [True, False])
def test_torch_lstm_scan_bwd_plain_matches_pallas_interpret(
        fresh_hparams, tanh_cand):
    """dxp, dc0, dh0 against _bwd_call with n_dirs=1 on the same
    residuals, atol 2e-5 / rtol 1e-4."""
    from danet_tpu.ops.pallas.lstm import _bwd_call_jit, _fwd_call_jit

    (xp, wh, c0, h0), d_hs = _uni_case(13)
    _, cs, acts = (np.array(v) for v in _fwd_call_jit(
        *map(jnp.asarray, (xp, wh, c0, h0)), tanh_cand=tanh_cand,
        interpret=True, n_dirs=1, save=True))
    c_prev = np.concatenate([c0[None], cs[:-1]])
    ref = _bwd_call_jit(*map(jnp.asarray, (d_hs, acts, cs, c_prev, wh)),
                        tanh_cand=tanh_cand, interpret=True, n_dirs=1)
    before = cuda_lstm.lstm_scan_bwd.launches
    out = cuda_lstm.lstm_scan_bwd(
        *[torch.from_numpy(a) for a in (d_hs, acts, cs, c_prev, wh)],
        tanh_cand)
    assert cuda_lstm.lstm_scan_bwd.launches == before
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("tanh_cand", [True, False])
def test_torch_lstm_scan_grads_match_jax(fresh_hparams, tanh_cand):
    """LstmScan's gradients of xp, wh, c0 and h0 against jax.grad through
    lstm_scan_pallas in interpret mode; both backward routes."""
    from danet_tpu.ops.pallas.lstm import lstm_scan_pallas

    args, d_hs = _uni_case(14)
    ref = jax.grad(
        lambda *a: jnp.sum(lstm_scan_pallas(*a, tanh_cand, True)
                           * jnp.asarray(d_hs)),
        argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    for use_kernel in (True, False):
        targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
        cuda_lstm.LstmScan.apply(*targs, tanh_cand, use_kernel).backward(
            torch.from_numpy(d_hs))
        for a, r in zip(targs, ref):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(r),
                                       atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("act", ["tanh", "linear"])
@pytest.mark.parametrize("reverse", [False, True])
def test_torch_lstm_apply_matches_pallas_interpret(fresh_hparams, act,
                                                   reverse):
    """lstm_apply against JAX lstm_apply(backend='pallas-interpret'), atol
    1e-6, on every backend value; explicit nonzero c0/h0 as well."""
    T, B, I, H = 10, 4, 6, 8
    params = jrnn.lstm_init(jax.random.PRNGKey(10), I, H,
                            gate_bias=(0.0, 1.5, -1.0, 1.0))
    rs = np.random.RandomState(10)
    x = rs.randn(B, T, I).astype(np.float32)
    c0, h0 = (rs.randn(B, H).astype(np.float32) for _ in range(2))
    tparams = weights.from_jax(jax.device_get(params))
    ref = np.asarray(jrnn.lstm_apply(params, jnp.asarray(x), act,
                                     reverse=reverse,
                                     backend="pallas-interpret"))
    for backend in ("auto", "pallas", "xla", "pallas-interpret"):
        out = trnn.lstm_apply(tparams, torch.from_numpy(x), act,
                              reverse=reverse, backend=backend).numpy()
        assert out.shape == (B, T, H)
        np.testing.assert_allclose(out, ref, atol=1e-6)
    ref = np.asarray(jrnn.lstm_apply(
        params, jnp.asarray(x), act, reverse=reverse, c0=jnp.asarray(c0),
        h0=jnp.asarray(h0), backend="pallas-interpret"))
    out = trnn.lstm_apply(tparams, torch.from_numpy(x), act, reverse=reverse,
                          c0=torch.from_numpy(c0), h0=torch.from_numpy(h0))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("act", ["tanh", "linear"])
def test_torch_lstm_apply_grads_match_jax(fresh_hparams, act):
    """Gradients of wx, wh, b and of the input through lstm_apply against
    the JAX package's Pallas LSTM (interpret mode)."""
    T, B, I, H = 8, 3, 5, 7
    params = jrnn.lstm_init(jax.random.PRNGKey(11), I, H,
                            gate_bias=(0.0, 1.5, -1.0, 1.0))
    x = np.random.RandomState(11).randn(B, T, I).astype(np.float32)
    g_ref, gx_ref = jax.grad(lambda p, v: jnp.sum(jrnn.lstm_apply(
        p, v, act, backend="pallas-interpret") ** 2), argnums=(0, 1))(
            params, jnp.asarray(x))
    tparams = weights.from_jax(jax.device_get(params))
    for p in weights.leaves(tparams):
        p.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    (trnn.lstm_apply(tparams, tx, act) ** 2).sum().backward()
    g_ref = jax.device_get(g_ref)
    for k in ("wx", "wh", "b"):
        np.testing.assert_allclose(tparams[k].grad.numpy(), g_ref[k],
                                   atol=2e-5, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_ref),
                               atol=2e-5, rtol=1e-4)


def test_torch_lstm_apply_refuses_unported(fresh_hparams):
    """An unknown backend raises; return_state (the final carry) under
    autograd runs the state form of the saving forward (its plain version
    on the CPU), whose carry carries a gradient."""
    tparams = {"wx": torch.zeros(2, 4, 3), "wh": torch.zeros(3, 4, 3),
               "b": torch.zeros(4, 3)}
    x = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError):
        trnn.lstm_apply(tparams, x, backend="cudnn")
    x.requires_grad_(True)
    out, (c, h) = trnn.lstm_apply(tparams, x, return_state=True)
    assert out.requires_grad and c.requires_grad and h.requires_grad
    assert c.dtype == torch.float32
    assert type(c.grad_fn).__name__.startswith("LstmScanState")


def test_torch_lstm_wrappers_refuse_other_devices(fresh_hparams):
    """The one-direction wrappers, like the bidirectional ones, raise for a
    tensor on any device other than CPU or CUDA."""
    xp, wh = torch.zeros(3, 1, 8, device="meta"), \
        torch.zeros(2, 8, device="meta")
    z = torch.zeros(1, 2, device="meta")
    with pytest.raises(ValueError):
        cuda_lstm.lstm_scan(xp, wh, z, z, True)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_scan_train(xp, wh, z, z, True)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_scan_bwd(torch.zeros(3, 1, 2, device="meta"), xp,
                                torch.zeros(3, 1, 2, device="meta"),
                                torch.zeros(3, 1, 2, device="meta"), wh,
                                True)


# ------------------------------------------------- kernel B, both forms
@pytest.mark.parametrize("n_dirs, wrapper, pallas", [
    (2, "bilstm_scan", "bilstm_scan_pallas"),
    (1, "lstm_scan", "lstm_scan_pallas")])
@pytest.mark.parametrize("tanh_cand", [True, False])
def test_torch_lean_scan_bf16_matches_pallas_interpret(
        fresh_hparams, n_dirs, wrapper, pallas, tanh_cand):
    """bfloat16 storage, f32 math: the lean forward's hs against the Pallas
    kernel in bf16, nonzero initial state.  Both round the same f32 values
    at the same places (the products of bf16 operands are exact in f32),
    so they agree but for f32 sums taken in another order, which may move
    one rounding of h by one bf16 ulp: atol one ulp of the output's peak,
    2^(floor(log2 peak) - 7)."""
    from danet_tpu.ops.pallas import lstm as jlstm

    (xp, wh, c0, h0), _ = (_scan_case(14, t=8, b=4, h=8) if n_dirs == 2
                           else _uni_case(14, t=8, b=4, h=8))
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (xp, wh, c0, h0)]
    ref = np.asarray(getattr(jlstm, pallas)(*jargs, tanh_cand, True)
                     .astype(jnp.float32))
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in jargs]
    out = getattr(cuda_lstm, wrapper)(*targs, tanh_cand)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=ulp)


@pytest.mark.parametrize("n_dirs", [1, 2])
@pytest.mark.parametrize("b", [1, 4, 33])
@pytest.mark.parametrize("h", [5, 300, 600])
def test_torch_lean_scan_exchange_words(fresh_hparams, n_dirs, b, h):
    """Kernel B's scratch: the rows h_t its blocks exchange, [2, D, B, H]
    contiguous 8-byte words (a float32 value and its step's tag, one
    buffer per parity of t), 8-byte aligned, on the device of the call."""
    x = cuda_lstm.exchange_words(n_dirs, b, h, "cpu")
    assert tuple(x.shape) == (2, n_dirs, b, h) and x.element_size() == 8
    assert x.is_contiguous() and x.device.type == "cpu"
    assert x.data_ptr() % 8 == 0
    m = cuda_lstm.exchange_words(n_dirs, b, h, "meta")
    assert m.device.type == "meta" and tuple(m.shape) == (2, n_dirs, b, h)


@pytest.mark.parametrize("tanh_cand", [True, False])
def test_torch_lstm_scan_train_bf16_matches_pallas_interpret(fresh_hparams,
                                                             tanh_cand):
    """bfloat16 storage, f32 math: the one-direction saving forward's hs,
    cs and acts against _fwd_call (n_dirs=1, save=True) in bf16, nonzero
    initial state; atol one bf16 ulp of each output's peak, for the reason
    of the lean forward's bf16 test above."""
    from danet_tpu.ops.pallas.lstm import _fwd_call_jit

    (xp, wh, c0, h0), _ = _uni_case(15, t=8, b=4, h=8)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (xp, wh, c0, h0)]
    ref = _fwd_call_jit(*jargs, tanh_cand=tanh_cand, interpret=True,
                        n_dirs=1, save=True)
    out = cuda_lstm.lstm_scan_train(*[torch.from_numpy(np.array(
        a.astype(jnp.float32))).to(torch.bfloat16) for a in jargs],
        tanh_cand)
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        r = np.asarray(r.astype(jnp.float32))
        assert o.dtype == torch.bfloat16 and tuple(o.shape) == r.shape
        ulp = 2.0 ** (np.floor(np.log2(np.abs(r).max())) - 7)
        np.testing.assert_allclose(o.float().numpy(), r, atol=ulp)


@pytest.mark.parametrize("tanh_cand", [True, False])
def test_torch_bilstm_scan_train_bf16_matches_pallas_interpret(fresh_hparams,
                                                               tanh_cand):
    """bfloat16 storage, f32 math: kernel 2's hs, cs and acts against
    _fwd_call (n_dirs=2, save=True) in bf16, nonzero initial state; atol one
    bf16 ulp of each output's peak, for the reason of the lean forward's
    bf16 test above."""
    from danet_tpu.ops.pallas.lstm import _fwd_call_jit

    (xp, wh, c0, h0), _ = _scan_case(16, t=8, b=4, h=8)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (xp, wh, c0, h0)]
    ref = _fwd_call_jit(*jargs, tanh_cand=tanh_cand, interpret=True,
                        n_dirs=2, save=True)
    out = cuda_lstm.bilstm_scan_train(*[torch.from_numpy(np.array(
        a.astype(jnp.float32))).to(torch.bfloat16) for a in jargs],
        tanh_cand)
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        r = np.asarray(r.astype(jnp.float32))
        assert o.dtype == torch.bfloat16 and tuple(o.shape) == r.shape
        ulp = 2.0 ** (np.floor(np.log2(np.abs(r).max())) - 7)
        np.testing.assert_allclose(o.float().numpy(), r, atol=ulp)


def _c_arg_names(entry: str) -> list:
    """The argument names of ``entry``'s extern "C" declaration in
    csrc/*.cu."""
    import glob
    import os
    import re

    from danet_tpu_torch.ops.cuda import _build

    for path in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        found = re.search(r'extern "C" int %s\(([^)]*)\)' % entry,
                          open(path).read())
        if found:
            return [a.strip().rsplit(" ", 1)[1].lstrip("*")
                    for a in found.group(1).split(",")]
    raise AssertionError("no extern \"C\" %s in csrc" % entry)


@pytest.mark.parametrize("wrapper, n_dirs, save", [
    ("bilstm_scan_train", 2, True), ("lstm_scan_train", 1, True),
    ("bilstm_scan", 2, False), ("lstm_scan", 1, False)])
@pytest.mark.parametrize("b", [1, 33])
def test_torch_forward_launch_passes_exchange_scratch(fresh_hparams,
                                                      monkeypatch, wrapper,
                                                      n_dirs, save, b):
    """Every LSTM forward, kernel 2 included, hands its C entry point the
    inputs, the outputs and an exchange scratch of [2, D, B, H] int64
    words, contiguous and 8-byte aligned on the device of the call, then
    (T, B, H, dtype code, tanh_cand, row groups), in the order of its
    extern "C" declaration; one row group off the card.  Recorded on the
    CPU with the launch replaced."""
    calls = []
    monkeypatch.setattr(cuda_lstm, "_on_cuda", lambda x, what: True)
    monkeypatch.setattr(cuda_lstm, "_launch",
                        lambda *a: calls.append(a))
    t, h = 3, 5
    args, _ = _scan_case(17, t=t, b=b, h=h)
    targs = [torch.from_numpy(np.ascontiguousarray(
        a if n_dirs == 2 else a[:, 0] if a.ndim == 4 else a[0]))
        for a in args]
    getattr(cuda_lstm, wrapper)(*targs, True)
    assert len(calls) == 1
    entry, _, device, tensors, ints = calls[0]
    assert entry == "danet_" + wrapper and device == targs[0].device
    names = _c_arg_names(entry)
    assert names[len(tensors):] == ["n_steps", "batch", "hdim", "dtype",
                                    "tanh_cand", "groups", "stream"]
    by_name = dict(zip(names, tensors))
    assert list(by_name) == ["xp", "wh", "c0", "h0", "hs"] + (
        ["cs", "acts"] if save else []) + ["xch"]
    for name, x in zip(("xp", "wh", "c0", "h0"), targs):
        assert by_name[name] is x
    hshape = (t,) + ((2, b, h) if n_dirs == 2 else (b, h))
    for name in ("hs", "cs") if save else ("hs",):
        assert tuple(by_name[name].shape) == hshape
    if save:
        assert tuple(by_name["acts"].shape) == tuple(targs[0].shape)
    xch = by_name["xch"]
    assert xch.dtype == torch.int64 and tuple(xch.shape) == (2, n_dirs, b, h)
    assert xch.is_contiguous() and xch.data_ptr() % 8 == 0
    assert xch.device == targs[0].device
    assert tuple(ints) == (t, b, h, 0, 1, 1)


@pytest.mark.parametrize("n_dirs", [1, 2])
def test_torch_lstm_plain_scans_keep_float64(fresh_hparams, n_dirs):
    """float64 inputs (a float64 run of the plain path) stay float64
    through the plain scans, forward and backward: torch.autograd.gradcheck
    of LstmScan / BiLstmScan at T=4, B=2, H=3 (the scans' float32 gate
    math would miss gradcheck's float64 bounds), with the output in
    float64."""
    rs = np.random.RandomState(n_dirs)
    d = (2,) if n_dirs == 2 else ()

    def t(*shape):
        return torch.from_numpy(rs.randn(*shape)).requires_grad_(True)
    xp, wh = t(4, *d, 2, 12), t(*d, 3, 12)
    c0, h0 = t(*d, 2, 3), t(*d, 2, 3)
    scan = cuda_lstm.BiLstmScan if n_dirs == 2 else cuda_lstm.LstmScan
    assert scan.apply(xp, wh, c0, h0, True, False).dtype == torch.float64
    assert torch.autograd.gradcheck(
        lambda *a: scan.apply(*a, True, False), (xp, wh, c0, h0))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("act", ["tanh", "linear"])
def test_torch_lstm_state_grad_matches_jax(fresh_hparams, reverse, act):
    """The final carry's gradient: a loss on hs and on both carries (c, h)
    of ``lstm_apply(..., return_state=True)`` from a nonzero c0 / h0,
    differentiated to the parameters, the input and c0 / h0 through the
    saving forward's state entry and kernel 3's seeded form (their plain
    versions here), against ``jax.grad`` of JAX's (2e-5 atol, 1e-4 rtol)."""
    rs = np.random.RandomState(12)
    jp = jrnn.lstm_init(jax.random.PRNGKey(12), 5, 6,
                        gate_bias=(0.0, 1.5, -1.0, 1.0))
    x, c0, h0 = (rs.randn(*s).astype(np.float32) * 0.7
                 for s in ((3, 9, 5), (3, 6), (3, 6)))

    def jloss(p, xv, c, h):
        hs, (cT, hT) = jrnn.lstm_apply(p, xv, act, reverse, c, h,
                                       backend="xla", return_state=True)
        return jnp.sum(jnp.sin(hs)) + 0.7 * jnp.sum(cT ** 2) \
            + 1.3 * jnp.sum(hT)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jp, jnp.asarray(x), jnp.asarray(c0), jnp.asarray(h0))
    tp = weights.from_jax(jax.device_get(jp))
    for v in tp.values():
        v.requires_grad_(True)
    tx, tc, th = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, c0, h0))
    hs, (cT, hT) = trnn.lstm_apply(tp, tx, act, reverse, tc, th,
                                   return_state=True)
    (torch.sum(torch.sin(hs)) + 0.7 * torch.sum(cT ** 2)
     + 1.3 * torch.sum(hT)).backward()
    for k in ("wx", "wh", "b"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(
            want[0][k]), atol=2e-5, rtol=1e-4, err_msg=k)
    for got, w in zip((tx, tc, th), want[1:]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("rows", [2, 5])
def test_torch_lstm_state_wrappers_split_batch(monkeypatch, rows):
    """The state form of the saving forward and the seeded backward on a
    (faked) card: a batch of 5 above the row ceiling ``rows`` runs as
    ceil(5 / rows) launches, c_T and dc_T split with it, each launch
    counted, the joined outputs the plain versions' (1e-6)."""
    rs = np.random.RandomState(rows)
    t, b, h = 4, 5, 3

    def r(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))
    xp, wh, c0, h0 = r(t, b, 4 * h), r(h, 4 * h) * 0.3, r(b, h), r(b, h)
    d_hs, dc_t = r(t, b, h), r(b, h)

    def fake_launch(entry, what, device, tensors, ints):
        tanh = bool(ints[4])
        if entry == "danet_lstm_scan_train_state":
            outs = cuda_lstm.lstm_scan_train_state_plain(*tensors[:4], tanh)
            dst = tensors[4:8]
        else:
            assert entry == "danet_lstm_scan_bwd_seeded", entry
            outs = cuda_lstm.lstm_scan_bwd_plain(*tensors[:5], tanh,
                                                 tensors[8])
            dst = tensors[5:8]
        assert tensors[0].shape[-2] == ints[1] <= rows
        for dd, o in zip(dst, outs):
            dd.copy_(o)
    monkeypatch.setattr(cuda_lstm, "_launch", fake_launch)
    fwd, bwd = cuda_lstm.lstm_scan_train_state, cuda_lstm.lstm_scan_bwd_seeded
    fwd.launches = bwd.launches = 0
    got = cuda_lstm._fwd(fwd, "danet_lstm_scan_train_state", 1, True, xp, wh,
                         c0, h0, True, rows=rows, state=True)
    want = cuda_lstm.lstm_scan_train_state_plain(xp, wh, c0, h0, True)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-6)
    hs, cs, acts, _ = want
    c_prev = torch.cat([c0[None], cs[:-1]])
    got = cuda_lstm._bwd(bwd, "danet_lstm_scan_bwd_seeded", 1, d_hs, acts, cs,
                         c_prev, wh, True, rows=rows, dc_T=dc_t)
    want = cuda_lstm.lstm_scan_bwd_plain(d_hs, acts, cs, c_prev, wh, True,
                                         dc_t)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-6)
    assert fwd.launches == bwd.launches == -(-b // rows)
    fwd.launches = bwd.launches = 0
    with pytest.raises(ValueError, match="dc_T"):
        cuda_lstm._bwd(bwd, "danet_lstm_scan_bwd_seeded", 1, d_hs, acts, cs,
                       c_prev, wh, True, rows=rows, dc_T=dc_t.double())
