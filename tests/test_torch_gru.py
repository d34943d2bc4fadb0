"""PyTorch port, GRU: the plain versions of the GRU kernels (lean forward,
residual-saving forward, backward), ``GruScan`` and ``gru_apply`` against
the JAX package's Pallas GRU kernels in interpret mode.

Small widths (T <= 10, B <= 4, H <= 8), inputs from numpy seeds.
Tolerances, float32: atol 1e-6 on forwards, atol 2e-5 + rtol 1e-4 on
backwards and gradients (the JAX kernel tests' bars, tests/test_pallas.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from danet_tpu.ops import rnn as jrnn  # noqa: E402
from danet_tpu.ops.pallas import gru as jgru  # noqa: E402
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.ops import rnn as trnn  # noqa: E402
from danet_tpu_torch.ops.cuda import gru as cuda_gru  # noqa: E402


def _case(seed, t=7, b=3, h=5, dtype=np.float32):
    """gx, cx, wgh, wch, c0 (nonzero) and a cotangent d_cs."""
    rs = np.random.RandomState(seed)
    gx = rs.randn(t, b, 2 * h).astype(dtype)
    cx = rs.randn(t, b, h).astype(dtype)
    wgh = (rs.randn(h, 2 * h) * 0.4).astype(dtype)
    wch = (rs.randn(h, h) * 0.4).astype(dtype)
    c0 = rs.randn(b, h).astype(dtype)
    d_cs = rs.randn(t, b, h).astype(dtype)
    return (gx, cx, wgh, wch, c0), d_cs


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_torch_gru_scan_plain_matches_pallas_interpret(fresh_hparams):
    """The lean forward with a nonzero initial state, atol 1e-6; on CPU
    tensors the wrapper runs its plain version and launches nothing."""
    args, _ = _case(1)
    ref = jgru.gru_scan_pallas(*map(jnp.asarray, args), True)
    before = cuda_gru.gru_scan.launches
    out = cuda_gru.gru_scan(*_t(args))
    assert cuda_gru.gru_scan.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_torch_gru_scan_train_plain_matches_pallas_interpret(fresh_hparams):
    """The residual-saving forward: cs and acts = [r | u | cand]."""
    args, _ = _case(2, t=8)
    ref = jgru._fwd_call_jit(*map(jnp.asarray, args), interpret=True,
                             save=True)
    before = cuda_gru.gru_scan_train.launches
    out = cuda_gru.gru_scan_train(*_t(args))
    assert cuda_gru.gru_scan_train.launches == before
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


def test_torch_gru_scan_bwd_plain_matches_pallas_interpret(fresh_hparams):
    """The backward on the same residuals: dgx, dcx, dc0."""
    (gx, cx, wgh, wch, c0), d_cs = _case(3)
    cs, acts = (np.array(v) for v in jgru._fwd_call_jit(
        *map(jnp.asarray, (gx, cx, wgh, wch, c0)), interpret=True,
        save=True))
    c_prev = np.concatenate([c0[None], cs[:-1]])
    ref = jgru._bwd_call_jit(*map(jnp.asarray, (d_cs, acts, c_prev, wgh,
                                                wch)), interpret=True)
    before = cuda_gru.gru_scan_bwd.launches
    out = cuda_gru.gru_scan_bwd(*_t((d_cs, acts, c_prev, wgh, wch)))
    assert cuda_gru.gru_scan_bwd.launches == before
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_torch_gru_scan_grads_match_jax(fresh_hparams, use_kernel):
    """GruScan's gradients of gx, cx, wgh, wch and c0 against jax.grad
    through gru_scan_pallas in interpret mode; both backward routes."""
    args, d_cs = _case(4)
    ref = jax.grad(
        lambda *a: jnp.sum(jgru.gru_scan_pallas(*a, True)
                           * jnp.asarray(d_cs)),
        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    targs = [a.requires_grad_(True) for a in _t(args)]
    cuda_gru.GruScan.apply(*targs, use_kernel).backward(
        torch.from_numpy(d_cs))
    for a, r in zip(targs, ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r),
                                   atol=2e-5, rtol=1e-4)


def test_torch_gru_scan_bwd_plain_matches_autograd(fresh_hparams):
    """The hand-written backward against torch.autograd of the plain
    forward, on the same inputs and cotangent."""
    args, d_cs = _case(5)
    grads = []
    for custom in (True, False):
        targs = [a.requires_grad_(True) for a in _t(args)]
        cs = (cuda_gru.GruScan.apply(*targs, False) if custom
              else cuda_gru.gru_scan_plain(*targs))
        cs.backward(torch.from_numpy(d_cs))
        grads.append([a.grad.numpy() for a in targs])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4)


def test_torch_gru_scan_bf16_matches_pallas_interpret(fresh_hparams):
    """bfloat16 storage, f32 math: cs and acts against the Pallas kernel
    in bf16.  Both round the same f32 values at the same places (the
    products of bf16 operands are exact in f32), so they agree but for
    f32 sums taken in another order, which may move one rounding by one
    bf16 ulp: atol 4e-3, one ulp (2^-8) of a value near 1.  On this CPU
    they agree exactly."""
    args, _ = _case(6, t=8, b=4, h=8)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    ref = jgru._fwd_call_jit(*jargs, interpret=True, save=True)
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in jargs]
    out = cuda_gru.gru_scan_train(*targs)
    for o, r in zip(out, ref):
        assert o.dtype == torch.bfloat16
        np.testing.assert_allclose(o.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   atol=4e-3)


def test_torch_gru_apply_matches_pallas_interpret(fresh_hparams):
    """gru_apply (hoisted projections + the scan) against JAX gru_apply
    with backend 'pallas-interpret', on every backend value."""
    T, B, I, H = 10, 4, 6, 8
    params = jrnn.gru_init(jax.random.PRNGKey(3), I, H)
    x = np.random.RandomState(3).randn(B, T, I).astype(np.float32)
    ref = np.asarray(jrnn.gru_apply(params, jnp.asarray(x),
                                    backend="pallas-interpret"))
    tparams = weights.from_jax(jax.device_get(params))
    for backend in ("auto", "pallas", "xla", "pallas-interpret"):
        out = trnn.gru_apply(tparams, torch.from_numpy(x),
                             backend=backend).numpy()
        assert out.shape == (B, T, H)
        np.testing.assert_allclose(out, ref, atol=1e-6)


def test_torch_gru_apply_grads_match_jax(fresh_hparams):
    """Gradients of all six GRU parameters and of the input."""
    T, B, I, H = 8, 3, 5, 7
    params = jrnn.gru_init(jax.random.PRNGKey(4), I, H)
    x = np.random.RandomState(4).randn(B, T, I).astype(np.float32)
    g_ref, gx_ref = jax.grad(lambda p, v: jnp.sum(jrnn.gru_apply(
        p, v, backend="pallas-interpret") ** 2), argnums=(0, 1))(
            params, jnp.asarray(x))
    tparams = weights.from_jax(jax.device_get(params))
    for p in weights.leaves(tparams):
        p.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    (trnn.gru_apply(tparams, tx) ** 2).sum().backward()
    g_ref = jax.device_get(g_ref)
    for k in ("wgx", "wgh", "bg", "wcx", "wch", "bc"):
        np.testing.assert_allclose(tparams[k].grad.numpy(), g_ref[k],
                                   atol=2e-5, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_ref),
                               atol=2e-5, rtol=1e-4)


def test_torch_gru_apply_refuses_unported(fresh_hparams):
    """An unknown backend raises; return_state (the final carry, the last
    row of cs) under autograd runs GruScan, whose cs cotangent carries the
    carry's."""
    tparams = weights.from_jax(jax.device_get(
        jrnn.gru_init(jax.random.PRNGKey(5), 3, 4)))
    x = torch.zeros(1, 5, 3)
    with pytest.raises(ValueError):
        trnn.gru_apply(tparams, x, backend="cudnn")
    x.requires_grad_(True)
    out, c = trnn.gru_apply(tparams, x, return_state=True)
    assert out.requires_grad and c.requires_grad
    assert type(c.grad_fn).__name__ != "NoneType"


def test_torch_gru_wrappers_refuse_other_devices(fresh_hparams):
    """A wrapper takes its plain version only for CPU tensors: on any other
    device than CPU or CUDA it raises (on CUDA it launches its kernel)."""
    t, b, h = 3, 1, 2
    gx, cx = torch.zeros(t, b, 2 * h, device="meta"), \
        torch.zeros(t, b, h, device="meta")
    wgh, wch = torch.zeros(h, 2 * h, device="meta"), \
        torch.zeros(h, h, device="meta")
    c0 = torch.zeros(b, h, device="meta")
    with pytest.raises(ValueError):
        cuda_gru.gru_scan(gx, cx, wgh, wch, c0)
    with pytest.raises(ValueError):
        cuda_gru.gru_scan_train(gx, cx, wgh, wch, c0)
    with pytest.raises(ValueError):
        cuda_gru.gru_scan_bwd(cx, torch.zeros(t, b, 3 * h, device="meta"),
                              cx, wgh, wch)


@pytest.mark.parametrize("b, h", [(1, 600), (33, 300), (2, 5)])
def test_torch_gru_exchange_rows(fresh_hparams, b, h):
    """Kernel 4f's scratch: the two rows its blocks exchange each step (dt(c)
    and dt(c * r)) as [2, B, H] contiguous 8-byte words, each a float32
    value and its step's tag, on the device of the call."""
    x = cuda_gru.exchange_rows(b, h, "cpu")
    assert tuple(x.shape) == (2, b, h) and x.element_size() == 8
    assert x.is_contiguous() and x.device.type == "cpu"
    assert x.data_ptr() % 8 == 0
    assert cuda_gru.exchange_rows(b, h, "meta").device.type == "meta"


@pytest.mark.parametrize("b", [1, 5])
def test_torch_gru_scan_bwd_plain_matches_pallas_interpret_batches(
        fresh_hparams, b):
    """The backward at B=1 (a single row) and at an odd B, beside the B=3
    case above: dgx, dcx, dc0 against _bwd_call, atol 2e-5 / rtol 1e-4."""
    (gx, cx, wgh, wch, c0), d_cs = _case(7 + b, b=b)
    cs, acts = (np.array(v) for v in jgru._fwd_call_jit(
        *map(jnp.asarray, (gx, cx, wgh, wch, c0)), interpret=True,
        save=True))
    c_prev = np.concatenate([c0[None], cs[:-1]])
    ref = jgru._bwd_call_jit(*map(jnp.asarray, (d_cs, acts, c_prev, wgh,
                                                wch)), interpret=True)
    out = cuda_gru.gru_scan_bwd(*_t((d_cs, acts, c_prev, wgh, wch)))
    assert [tuple(o.shape) for o in out] == [(7, b, 10), (7, b, 5), (b, 5)]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=1e-4)


def _bf16_ulp(ref: np.ndarray) -> float:
    """One bfloat16 ulp of the peak of ``ref``: 2^(floor(log2 peak) - 7)."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def test_torch_gru_scan_bwd_bf16_matches_pallas_interpret(fresh_hparams):
    """bfloat16 storage, f32 math: the backward's dgx, dcx and dc0 against
    the Pallas backward in bf16 on the same bf16 residuals.  Both round
    the same f32 values at the same places (dcx and dgx before their
    products, whose bf16 operands multiply exactly in f32), so they agree
    but for f32 sums taken in another order, which may move one rounding
    by one bf16 ulp: atol one ulp of each output's peak."""
    (gx, cx, wgh, wch, c0), d_cs = _case(9, t=8, b=4, h=8)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (gx, cx, wgh, wch, c0)]
    cs, acts = jgru._fwd_call_jit(*jargs, interpret=True, save=True)
    c_prev = jnp.concatenate([jargs[4][None], cs[:-1]])
    bargs = (jnp.asarray(d_cs, jnp.bfloat16), acts, c_prev, jargs[2],
             jargs[3])
    ref = jgru._bwd_call_jit(*bargs, interpret=True)
    out = cuda_gru.gru_scan_bwd(*[torch.from_numpy(np.array(
        a.astype(jnp.float32))).to(torch.bfloat16) for a in bargs])
    for o, r in zip(out, ref):
        r = np.asarray(r.astype(jnp.float32))
        assert o.dtype == torch.bfloat16 and tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.float().numpy(), r, atol=_bf16_ulp(r))


@pytest.mark.parametrize("h", [5, 300, 600])
def test_torch_gru_exchange_flags(fresh_hparams, h):
    """Kernel 4b's scratch: [2, H] contiguous int32, one flag per block (8
    units each, so H covers every block) for each of the two rows its
    blocks exchange each step, 4-byte aligned, on the device of the call."""
    x = cuda_gru.exchange_flags(h, "cpu")
    assert tuple(x.shape) == (2, h) and x.dtype == torch.int32
    assert x.is_contiguous() and x.device.type == "cpu"
    assert x.data_ptr() % 4 == 0 and x.shape[1] >= -(-h // 8)
    m = cuda_gru.exchange_flags(h, "meta")
    assert m.device.type == "meta" and tuple(m.shape) == (2, h)


def _c_entries() -> dict:
    """{name: [ctypes type of each argument]} of every extern "C" entry
    point in danet_tpu_torch/csrc/*.cu, parsed from the sources."""
    import ctypes
    import glob
    import os
    import re

    from danet_tpu_torch.ops.cuda import _build

    types = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}
    out = {}
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        text = open(path).read()
        for name, args in re.findall(
                r'extern "C" (?:int|const char\*) (danet_\w+)\(([^)]*)\)',
                text):
            out[name] = [
                ctypes.c_void_p if "*" in a else
                types[re.sub(r"^const ", "", a.strip()).rsplit(" ", 1)[0]]
                for a in args.split(",")]
    return out


def test_torch_c_entries_all_have_signatures(fresh_hparams):
    """Every C entry point in the CUDA sources is bound in
    _build._SIGNATURES and nothing else is: a signature that the sources
    do not have shows only on the card, when the library loads."""
    from danet_tpu_torch.ops.cuda import _build

    assert sorted(_c_entries()) == sorted(n for n, _, _ in
                                          _build._SIGNATURES)


@pytest.mark.parametrize("entry", [
    "danet_stft_ri", "danet_bilstm_scan", "danet_bilstm_scan_train",
    "danet_bilstm_scan_bwd", "danet_lstm_scan", "danet_lstm_scan_train",
    "danet_lstm_scan_bwd", "danet_lstm_scan_state",
    "danet_lstm_scan_train_state", "danet_lstm_scan_bwd_seeded",
    "danet_gru_scan", "danet_gru_scan_train",
    "danet_gru_scan_bwd", "danet_flash_attn", "danet_flash_attn_bwd_dkv",
    "danet_flash_attn_bwd_dq", "danet_error_string"])
def test_torch_c_entry_signature_matches_source(fresh_hparams, entry):
    """The argtypes that ctypes passes to each C entry point (pointers as
    c_void_p, int, long long, float) are, in count and in order, the
    arguments of its extern "C" declaration in csrc/*.cu."""
    from danet_tpu_torch.ops.cuda import _build

    argtypes = {n: a for n, _, a in _build._SIGNATURES}[entry]
    assert argtypes == _c_entries()[entry]


def test_torch_gru_state_grad_matches_jax(fresh_hparams):
    """The GRU's final carry is the last row of cs, so its cotangent
    reaches GruScan's backward through cs's: a loss on cs and on the carry
    of ``gru_apply(..., return_state=True)`` from a nonzero c0, against
    ``jax.grad`` of JAX's (2e-5 atol, 1e-4 rtol), to the parameters, the
    input and c0."""
    rs = np.random.RandomState(13)
    jp = jrnn.gru_init(jax.random.PRNGKey(13), 5, 6, w_scale=0.5)
    x, c0 = (rs.randn(*s).astype(np.float32) * 0.7
             for s in ((3, 9, 5), (3, 6)))

    def jloss(p, xv, c):
        cs, cT = jrnn.gru_apply(p, xv, c, backend="xla", return_state=True)
        return jnp.sum(jnp.sin(cs)) + 0.7 * jnp.sum(cT ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(x),
                                              jnp.asarray(c0))
    tp = weights.from_jax(jax.device_get(jp))
    for v in tp.values():
        v.requires_grad_(True)
    tx, tc = (torch.from_numpy(a).requires_grad_(True) for a in (x, c0))
    cs, cT = trnn.gru_apply(tp, tx, tc, return_state=True)
    (torch.sum(torch.sin(cs)) + 0.7 * torch.sum(cT ** 2)).backward()
    for k in ("wgx", "wgh", "bg", "wcx", "wch", "bc"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(
            want[0][k]), atol=2e-5, rtol=1e-4, err_msg=k)
    for got, w in zip((tx, tc), want[1:]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   atol=2e-5, rtol=1e-4)
