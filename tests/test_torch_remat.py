"""PyTorch port, REMAT and the LSTM wrappers' batch split on the CPU.

REMAT (``models/encoders.py::_maybe_remat``) recomputes the layers of
lstm-orig and bilstm-orig and the blocks of tcn-v1 and dprnn-v1 in the
backward: with the same seed, ``train_loss`` and every gradient equal the
non-REMAT ones bit for bit at DROPOUT_KEEP_PROB 0.8 (the masks are drawn
outside the recomputed region, or before it), and REMAT's gradients
match JAX's REMAT gradients (``jax.checkpoint``, as
``tests/test_modules.py:352`` runs it) at 2e-5 atol + 1e-4 rtol, with
dropout off (the two packages draw other masks).  The batch split of
``ops/cuda/lstm.py`` (``_fwd``/``_bwd`` above a row ceiling) runs here
through the wrappers' launch path with the launch replaced by the plain
version, against one unsplit plain call, to 1e-6: the rows are
independent, but the plain version's batched matmuls round otherwise at
another batch size.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import danet_tpu.models.encoders as jenc  # noqa: E402
from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
import danet_tpu_torch.models.encoders as tenc  # noqa: E402
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402
from danet_tpu_torch.ops.cuda import lstm as cuda_lstm  # noqa: E402
from danet_tpu_torch.train import Trainer  # noqa: E402

GRAD = dict(atol=2e-5, rtol=1e-4)

# the four encoders REMAT reaches, at narrow widths: (keys, frames)
CASES = {
    "lstm-orig": ({"ENCODER_TYPE": "lstm-orig"}, 9),
    "bilstm-orig": ({"ENCODER_TYPE": "bilstm-orig"}, 9),
    "tcn-v1": ({"ENCODER_TYPE": "tcn-v1", "TCN_DIM": 16, "TCN_HIDDEN": 24,
                "TCN_BLOCKS": 3, "TCN_REPEATS": 1}, 11),
    "dprnn-v1": ({"ENCODER_TYPE": "dprnn-v1", "DPRNN_DIM": 12,
                  "DPRNN_HIDDEN": 8, "DPRNN_CHUNK": 8, "DPRNN_BLOCKS": 2},
                 19),
}
RECURRENT = {"lstm-orig": (jenc.LstmEncoder, tenc.LstmEncoder),
             "bilstm-orig": (jenc.BiLstmEncoder, tenc.BiLstmEncoder)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrow(monkeypatch, encoder):
    for cls in RECURRENT.get(encoder, ()):
        monkeypatch.setattr(cls, "HDIM", 6)
        monkeypatch.setattr(cls, "N_LAYERS", 2)


def _src_ri(seed, t, b=2, n=2, f=129):
    rs = np.random.RandomState(seed)
    z = rs.randn(b, n, t, f) + 1j * rs.randn(b, n, t, f)
    return np.stack([z.real, z.imag], -1).astype(np.float32)


def _loss_and_grads(model, params, batch, seed):
    leaves = weights.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    loss, _ = model.train_loss(params, torch.from_numpy(batch), gen)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # the inference estimator's anchors take no part in the loss
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("encoder", sorted(CASES))
def test_torch_remat_matches_no_remat_bit_for_bit(monkeypatch, encoder):
    """REMAT=true against false from one seed, DROPOUT_KEEP_PROB 0.8: the
    loss and every gradient bit for bit (the dropout masks are the same
    draws, and the recompute repeats the forward's arithmetic)."""
    _narrow(monkeypatch, encoder)
    keys, t = CASES[encoder]
    batch = _src_ri(1, t)
    out = []
    for remat in (False, True):
        hp = load_config(**dict(keys, REMAT=remat, DROPOUT_KEEP_PROB=0.8))
        model = TorchDaNet(hp)
        params = model.init(torch.Generator().manual_seed(0))
        out.append(_loss_and_grads(model, params, batch, 3))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    if encoder != "lstm-orig":                 # its apply ignores train
        dropped = _loss_and_grads(model, params, batch, None)[0]
        assert not torch.equal(l0, dropped)    # dropout was on
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("encoder", sorted(CASES))
def test_torch_remat_grads_match_jax_remat(fresh_hparams, monkeypatch,
                                           encoder):
    """REMAT's gradients of ``train_loss`` against JAX's REMAT gradients
    (``jax.checkpoint`` around the same layers), 2e-5 + 1e-4 rtol."""
    _narrow(monkeypatch, encoder)
    keys, t = CASES[encoder]
    keys = dict(keys, REMAT=True)
    fresh_hparams.load(keys)
    fresh_hparams.digest()
    jm = JaxDaNet()
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TorchDaNet(load_config(**keys))
    tp = weights.from_jax(jax.device_get(jp))
    batch = _src_ri(2, t)
    (jl, _), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(
        jp, jnp.asarray(batch), None)
    loss, grads = _loss_and_grads(tm, tp, batch, None)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), **GRAD)
    ref = weights.leaves(weights.from_jax(jax.device_get(jg)))
    for name, g, r in zip(weights.leaf_names(tp), grads, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=name,
                                   **GRAD)


def test_torch_remat_recomputes_the_saving_forward(monkeypatch):
    """A REMAT step of bilstm-orig runs the saving forward twice per layer
    (the non-reentrant checkpoint's forward, then its recompute in the
    backward) and the backward once; without REMAT once each."""
    _narrow(monkeypatch, "bilstm-orig")
    calls = {"fwd": 0, "bwd": 0}
    fwd, fwd_plain, bwd, bwd_plain = cuda_lstm._TRAIN_KERNELS[2]

    def counted(key, fn):
        def run(*args):
            calls[key] += 1
            return fn(*args)
        return run
    monkeypatch.setitem(cuda_lstm._TRAIN_KERNELS, 2, (
        counted("fwd", fwd), counted("fwd", fwd_plain),
        counted("bwd", bwd), counted("bwd", bwd_plain)))
    batch = _src_ri(4, 9)
    for remat, want in ((False, 1), (True, 2)):
        calls.update(fwd=0, bwd=0)
        model = TorchDaNet(load_config(ENCODER_TYPE="bilstm-orig",
                                       REMAT=remat))
        params = model.init(torch.Generator().manual_seed(0))
        _loss_and_grads(model, params, batch, None)
        assert calls == {"fwd": 2 * want, "bwd": 2}


@pytest.mark.parametrize("encoder", ["bilstm-orig", "dprnn-v1"])
def test_torch_trainer_remat_step_bit_for_bit(monkeypatch, encoder):
    """Trainer steps (train_steps, K=2, on the CPU eager) with REMAT leave
    the parameters, the Adam moments and the metrics bit for bit as
    without, at DROPOUT_KEEP_PROB 0.8 from one seed."""
    _narrow(monkeypatch, encoder)
    keys, t = CASES[encoder]
    stack = np.stack([_src_ri(s, t) for s in (5, 6)])
    runs = []
    for remat in (False, True):
        hp = load_config(**dict(keys, REMAT=remat, DROPOUT_KEEP_PROB=0.8,
                                BATCH_SIZE=2))
        tr = Trainer(TorchDaNet(hp), hp, "cpu")
        st = tr.init_state(torch.Generator().manual_seed(0))
        m = tr.train_steps(st, stack)
        runs.append((m, weights.leaves(st["params"]) + st["opt"].mu
                     + st["opt"].nu))
    (m0, s0), (m1, s1) = runs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))


# ------------------------------------------------------------- batch split
def _fake_launch(entry, what, device, tensors, ints):
    """A kernel launch on the CPU: the entry point's plain version, copied
    into the launch's output tensors."""
    t, b, hdim, _, tanh, _ = ints
    two = entry.startswith("danet_bilstm")
    if entry.endswith("_bwd"):
        plain = (cuda_lstm.bilstm_scan_bwd_plain if two
                 else cuda_lstm.lstm_scan_bwd_plain)
        outs = plain(*tensors[:5], bool(tanh))
        dst = tensors[5:8]
    else:
        save = entry.endswith("_train")
        plain = {(True, False): cuda_lstm.bilstm_scan_plain,
                 (True, True): cuda_lstm.bilstm_scan_train_plain,
                 (False, False): cuda_lstm.lstm_scan_plain,
                 (False, True): cuda_lstm.lstm_scan_train_plain}[two, save]
        outs = plain(*tensors[:4], bool(tanh))
        outs = outs if save else (outs,)
        dst = tensors[4:4 + len(outs)]
    assert tensors[0].shape[-2] == b
    for d, o in zip(dst, outs):
        d.copy_(o)


def _same(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_dirs", [1, 2])
@pytest.mark.parametrize("rows", [1, 3, 4, 16])
def test_torch_lstm_wrappers_split_batch(monkeypatch, n_dirs, rows):
    """Above the row ceiling (forced to ``rows`` through ``_fwd``'s and
    ``_bwd``'s parameter) a batch of 10 runs as ceil(10 / rows) launches of
    at most ``rows`` rows, each counted; the joined outputs equal one
    unsplit plain call to 1e-6 (lean forward, saving forward,
    backward)."""
    monkeypatch.setattr(cuda_lstm, "_launch", _fake_launch)
    rs = np.random.RandomState(rows)
    t, b, h = 4, 10, 5
    d = (n_dirs,) if n_dirs == 2 else ()

    def r(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))
    xp, wh = r(t, *d, b, 4 * h), r(*d, h, 4 * h) * 0.3
    c0, h0, d_hs = r(*d, b, h), r(*d, b, h), r(t, *d, b, h)
    pre = "bi" if n_dirs == 2 else ""
    lean, train, bwd = (getattr(cuda_lstm, pre + n) for n in (
        "lstm_scan", "lstm_scan_train", "lstm_scan_bwd"))
    plain = [getattr(cuda_lstm, pre + n + "_plain") for n in (
        "lstm_scan", "lstm_scan_train", "lstm_scan_bwd")]
    launches = -(-b // rows)
    for fn in (lean, train, bwd):
        fn.launches = 0
    got = cuda_lstm._fwd(lean, "danet_%slstm_scan" % pre, n_dirs, False, xp,
                         wh, c0, h0, True, rows=rows)
    _same(got, plain[0](xp, wh, c0, h0, True))
    hs, cs, acts = cuda_lstm._fwd(train, "danet_%slstm_scan_train" % pre,
                                  n_dirs, True, xp, wh, c0, h0, True,
                                  rows=rows)
    want = plain[1](xp, wh, c0, h0, True)
    for a, w in zip((hs, cs, acts), want):
        _same(a, w)
    c_prev = torch.cat([c0[None], cs[:-1]])
    got = cuda_lstm._bwd(bwd, "danet_%slstm_scan_bwd" % pre, n_dirs, d_hs,
                         acts, cs, c_prev, wh, True, rows=rows)
    want = plain[2](d_hs, acts, cs, c_prev, wh, True)
    for a, w in zip(got, want):
        _same(a, w)
    assert (lean.launches, train.launches, bwd.launches) == (launches,) * 3
    for fn in (lean, train, bwd):
        fn.launches = 0


def test_torch_lstm_split_is_even():
    """The launches of a split batch are as even as can be: 2,048 rows at
    a ceiling of 885 go as 683, 683 and 682."""
    sizes = []
    cuda_lstm._by_rows(lambda v: sizes.append(v.shape[-2]) or v, 885,
                       torch.zeros(3, 2048, 1))
    assert sizes == [683, 683, 682]
