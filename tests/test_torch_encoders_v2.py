"""PyTorch port, the convolution ops and the encoders tcn-v1, dprnn-v1 and
conv-bilstm-v1 against the JAX package on the CPU, with the same weights
(carried by ``danet_tpu_torch.weights``) and the same numpy inputs.

JAX runs its recurrent layers on the 'xla' scan (what 'auto' takes on the
CPU), the port on the kernels' plain versions.  Narrow widths (tcn-v1:
D 16, H 24, 3 x 1 blocks; dprnn-v1: D 12, H 8, P 8, 2 blocks;
conv-bilstm-v1: FFT_SIZE 32, so H 32 over 64 inputs), one full-width
forward per config file on a short T.  Tolerances: 1e-5 rtol and 1e-5 of
the output's peak (at least 1e-5) atol on float32 forwards, float32 sums
in another order: dprnn-v1's layer norms over D amplify them, so that at
T 19 JAX's own output moves by 4.2e-5 (peak 32.8) when its input moves by
1e-7 relative, and a float64 run of the JAX encoder puts JAX 3.2e-5 and
the port 2.7e-5 from it (tcn-v1 and conv-bilstm-v1 hold 1e-5 flat);
2e-5 atol + 1e-4
rtol on ``train_loss`` and its gradients, the JAX kernel tests' gradient
bar; bfloat16 forwards at 2e-2 rtol and 5e-2 atol, the bound of the
port's bfloat16 objective tests (``test_torch_objectives.py``: a bf16
ulp, 2^-8 relative, that falls otherwise under another float32 summation
order compounds through the layers), the atol scaled by the output's peak
as in float32 (tcn-v1 and dprnn-v1 reach 31 and 38 at these widths, and
JAX's own bfloat16 output lies 0.38 and 0.91 from its float32 one), and
the port's bfloat16 output at most twice as far from JAX's float32 output
as JAX's bfloat16 output is; the bfloat16 ops at one bf16 ulp of the
output's peak.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
from danet_tpu.models.encoders import DprnnEncoder as JaxDprnn  # noqa: E402
from danet_tpu.ops import nn as jnn  # noqa: E402
from danet_tpu_torch import __main__ as cli  # noqa: E402
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402
from danet_tpu_torch.models.encoders import DprnnEncoder  # noqa: E402
from danet_tpu_torch.ops import nn as tnn  # noqa: E402
from danet_tpu_torch.train import checkpoint as ckpt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=5e-2, rtol=2e-2)

TCN = dict(ENCODER_TYPE="tcn-v1", TCN_DIM=16, TCN_HIDDEN=24, TCN_KERNEL=3,
           TCN_BLOCKS=3, TCN_REPEATS=1)
DPRNN = dict(ENCODER_TYPE="dprnn-v1", DPRNN_DIM=12, DPRNN_HIDDEN=8,
             DPRNN_CHUNK=8, DPRNN_BLOCKS=2)
CONV = dict(ENCODER_TYPE="conv-bilstm-v1", FFT_SIZE=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, atol, rtol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=rtol)


def _close_peak(a, b, tol=FWD):
    """``tol``'s rtol, and its atol scaled by the peak of ``b`` (when above
    1): the forwards' bound (module docstring)."""
    b = np.asarray(b, np.float32)
    _close(a, b, atol=tol["atol"] * max(1.0, float(np.abs(b).max())),
           rtol=tol["rtol"])


def _bf16_ulp(ref) -> float:
    """One bfloat16 ulp of the peak of ``ref``: 2^(floor(log2 peak) - 7)."""
    return 2.0 ** (np.floor(np.log2(np.abs(np.asarray(ref)).max())) - 7)


def _pair(hp_jax, keys, seed=0):
    """(jax model, jax params, torch model, torch params) from default.json
    + ``keys``, the port's weights carried from JAX's."""
    hp_jax.load(keys)
    hp_jax.digest()
    jm = JaxDaNet()
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = TorchDaNet(load_config(**keys))
    return jm, jp, tm, weights.from_jax(jax.device_get(jp))


def _spectra(seed, b, t, f):
    return np.abs(np.random.RandomState(seed).randn(b, t, f)).astype(
        np.float32)


def _src_ri(seed, b, t, f, n=2):
    rs = np.random.RandomState(seed)
    z = rs.randn(b, n, t, f) + 1j * rs.randn(b, n, t, f)
    return np.stack([z.real, z.imag], -1).astype(np.float32)


# --------------------------------------------------------------------- ops
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_torch_conv1d_depthwise_matches_jax(fresh_hparams, dtype, causal,
                                            dilation):
    """The depthwise dilated convolution over T in float32 (cast back),
    'SAME' or left-padded; bfloat16 to one bf16 ulp of the peak (the two
    round float32 results that differ in the last float32 bits)."""
    rs = np.random.RandomState(dilation)
    x = rs.randn(2, 13, 6).astype(np.float32)
    jp = jnn.conv1d_depthwise_init(jax.random.PRNGKey(dilation), 6, 3)
    jp["b"] = jnp.asarray(rs.randn(6).astype(np.float32))
    ref = jnn.conv1d_depthwise_apply(jp, jnp.asarray(x).astype(dtype),
                                     dilation=dilation, causal=causal)
    out = tnn.conv1d_depthwise_apply(
        weights.from_jax(jax.device_get(jp)),
        torch.from_numpy(x).to(getattr(torch, dtype)), dilation=dilation,
        causal=causal)
    assert out.dtype == getattr(torch, dtype) and out.shape == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    tol = FWD if dtype == "float32" else dict(atol=_bf16_ulp(ref), rtol=0)
    _close(out.float(), ref, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ksize", [3, 4, 5])
def test_torch_conv2d_matches_jax(fresh_hparams, dtype, ksize):
    """NCHW 'SAME' convolution at an odd size (H 7, W 9), kernel and output
    in the activation's dtype (an even kernel pads one zero more after);
    bfloat16 to one bf16 ulp of the peak."""
    rs = np.random.RandomState(ksize)
    x = rs.randn(2, 3, 7, 9).astype(np.float32)
    jp = jnn.conv2d_init(jax.random.PRNGKey(ksize), 3, 4, ksize)
    jp["b"] = jnp.asarray(rs.randn(4).astype(np.float32))
    ref = jnn.conv2d_apply(jp, jnp.asarray(x).astype(dtype))
    out = tnn.conv2d_apply(weights.from_jax(jax.device_get(jp)),
                           torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    assert tuple(out.shape) == ref.shape == (2, 4, 7, 9)
    ref = np.asarray(ref.astype(jnp.float32))
    tol = FWD if dtype == "float32" else dict(atol=_bf16_ulp(ref), rtol=0)
    _close(out.float(), ref, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_max_pool_matches_jax(fresh_hparams, dtype):
    """2x2 VALID max pool at odd H and W: the last row and column drop,
    exactly as JAX's reduce_window."""
    x = np.random.RandomState(3).randn(2, 3, 7, 9).astype(np.float32)
    ref = jnn.max_pool_2x2(jnp.asarray(x).astype(dtype))
    out = tnn.max_pool_2x2(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tuple(out.shape) == ref.shape == (2, 3, 3, 4)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))



def test_torch_conv_ops_force_cudnn_flags(monkeypatch):
    """Each convolution op, forward and backward, runs with cuDNN's TF32
    off, its deterministic algorithms on and benchmark off, whatever the
    process set (here PyTorch's default TF32 on, and the other two
    reversed), and restores the process's settings after."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cudnn = torch.backends.cudnn
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(cudnn, "deterministic", False)
    monkeypatch.setattr(cudnn, "benchmark", True)
    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.__name__.startswith("convolution"):
                seen.append((func.__name__, cudnn.allow_tf32,
                             cudnn.deterministic, cudnn.benchmark))
            return func(*args, **(kwargs or {}))

    g = torch.Generator().manual_seed(0)
    p2, p1 = tnn.conv2d_init(g, 3, 4, 3), tnn.conv1d_depthwise_init(g, 4, 3)
    x = torch.randn(2, 3, 7, 9, requires_grad=True)
    with Record():
        y = tnn.conv2d_apply(p2, x)
        z = tnn.conv1d_depthwise_apply(p1, y.mean(2).transpose(1, 2),
                                       dilation=2)
        z.sum().backward()
    names = sorted(name for name, *_ in seen)
    assert names == ["convolution.default"] * 2 \
        + ["convolution_backward.default"] * 2, names
    assert all(tuple(flags) == (False, True, False) for _, *flags in seen), \
        seen
    assert (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark) == (
        True, False, True)


def test_torch_conv_init_layouts():
    """The port's inits give JAX's parameter shapes and scales' bounds."""
    g = torch.Generator().manual_seed(0)
    p = tnn.conv2d_init(g, 3, 4, 5, w_scale=0.3)
    assert tuple(p["w"].shape) == (4, 3, 5, 5) and tuple(p["b"].shape) == (4,)
    assert float(p["w"].abs().max()) <= 0.3
    p = tnn.conv1d_depthwise_init(g, 6, 3)
    assert tuple(p["w"].shape) == (6, 1, 3)
    assert float(p["w"].abs().max()) <= np.sqrt(6.0 / 6)


# ---------------------------------------------------------------- encoders
ENCODER_CASES = {
    "tcn": (TCN, 19),
    "tcn-causal": (dict(TCN, TCN_CAUSAL=True), 19),
    "dprnn": (DPRNN, 19),
    "dprnn-inter-causal": (dict(DPRNN, DPRNN_INTER_CAUSAL=True), 19),
    "dprnn-short": (DPRNN, 5),                     # T < P: one chunk of T
    "dprnn-hop2": (dict(DPRNN, DPRNN_HOP=2), 21),  # up to 4 addends a frame
    "conv-bilstm": (CONV, 20),
    "conv-bilstm-legacy": (dict(CONV, LSTM_LEGACY_CELL=True), 20),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_torch_new_encoder_matches_jax(fresh_hparams, case):
    """Each new encoder's forward against JAX's, float32, 1e-5."""
    keys, t = ENCODER_CASES[case]
    jm, jp, tm, tp = _pair(fresh_hparams, keys)
    f = tm.hp.FEATURE_SIZE
    x = _spectra(t, 2, t, f)
    ref = jm.encoder.apply(jp["encoder"], jnp.asarray(x))
    out = tm.encoder.apply(tp["encoder"], torch.from_numpy(x))
    assert tuple(out.shape) == (2, t, f, tm.hp.EMBED_SIZE)
    _close_peak(out, ref)


@pytest.mark.parametrize("case", ["tcn", "dprnn", "conv-bilstm"])
def test_torch_new_encoder_bf16_matches_jax(fresh_hparams, case):
    """Each new encoder in bfloat16 against JAX in bfloat16 (the weights
    cast by each package's layers), at BF16 scaled by the peak; and no
    farther than twice JAX's bfloat16 output from JAX's float32 one."""
    keys, t = ENCODER_CASES[case]
    jm, jp, tm, tp = _pair(fresh_hparams, keys)
    x = _spectra(t + 1, 2, t, tm.hp.FEATURE_SIZE)
    ref = np.asarray(jm.encoder.apply(
        jp["encoder"], jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    ref32 = np.asarray(jm.encoder.apply(jp["encoder"], jnp.asarray(x)))
    out = tm.encoder.apply(tp["encoder"],
                           torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    assert np.all(np.isfinite(out))
    _close_peak(out, ref, BF16)
    assert np.abs(out - ref32).max() <= 2 * np.abs(ref - ref32).max()


@pytest.mark.parametrize("case", ["tcn", "dprnn", "conv-bilstm"])
def test_torch_new_encoder_train_loss_grads_match_jax(fresh_hparams, case):
    """``DaNet.train_loss`` and every gradient (encoder, anchors) against
    ``jax.grad``, 2e-5 atol + 1e-4 rtol."""
    keys, t = ENCODER_CASES[case]
    jm, jp, tm, tp = _pair(fresh_hparams, keys)
    batch = _src_ri(7, 2, t, tm.hp.FEATURE_SIZE)
    (jl, _), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(
        jp, jnp.asarray(batch), None)
    leaves = weights.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = tm.train_loss(tp, torch.from_numpy(batch), None)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    ref = weights.leaves(weights.from_jax(jax.device_get(jg)))
    assert len(grads) == len(ref)
    _close(loss.detach(), jl, **GRAD)
    for name, g, r in zip(weights.leaf_names(tp), grads, ref):
        g = torch.zeros_like(r) if g is None else g
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=name,
                                   **GRAD)


def _config(name):
    with open(os.path.join(REPO, "configs", name)) as f:
        return json.load(f)


@pytest.mark.parametrize("keys", [
    _config("tcn.json"), _config("dprnn.json"),
    {"ENCODER_TYPE": "conv-bilstm-v1"}], ids=["tcn", "dprnn", "conv-bilstm"])
def test_torch_new_encoder_full_width_matches_jax(fresh_hparams, keys):
    """configs/tcn.json and configs/dprnn.json as written, and
    conv-bilstm-v1 at default.json's widths (H 256 over 512 inputs), on a
    short T in float32, so the weight bridge is proven at the widths the
    card runs."""
    jm, jp, tm, tp = _pair(fresh_hparams, keys)
    x = _spectra(9, 1, 8, tm.hp.FEATURE_SIZE)
    ref = jm.encoder.apply(jp["encoder"], jnp.asarray(x))
    out = tm.encoder.apply(tp["encoder"], torch.from_numpy(x))
    _close_peak(out, ref)


@pytest.mark.parametrize("hop", [None, 3, 8])
@pytest.mark.parametrize("t", [16, 19, 8, 5])
def test_torch_dprnn_segment_merge_roundtrip(t, hop):
    """Count-normalised overlap-add inverts the segmentation exactly, also
    when T is not a multiple of the hop (``tests/test_modules.py:471``),
    and the chunks are JAX's."""
    x = np.random.RandomState(t).randn(3, t, 6).astype(np.float32)
    p = min(8, t)
    chunks, seg = DprnnEncoder._segment(torch.from_numpy(x), p, hop)
    jchunks, _ = JaxDprnn._segment(jnp.asarray(x), p, hop)
    np.testing.assert_array_equal(chunks.numpy(), np.asarray(jchunks))
    back = DprnnEncoder._merge(chunks, seg)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-6)


def test_torch_dprnn_refuses_bad_hop(fresh_hparams):
    """DPRNN_HOP outside [1, DPRNN_CHUNK] raises JAX's ValueError."""
    for hop in (0, 9):
        with pytest.raises(ValueError, match="DPRNN_HOP"):
            TorchDaNet(load_config(**dict(DPRNN, DPRNN_HOP=hop))) \
                .encoder.init(torch.Generator().manual_seed(0))


def test_torch_conv_bilstm_refuses_unaligned_length(fresh_hparams):
    """conv-bilstm-v1 takes T a multiple of 4 (JAX fails on other lengths
    with a shape error); the port raises ValueError naming LENGTH_ALIGN."""
    tm = TorchDaNet(load_config(**CONV))
    tp = tm.init(torch.Generator().manual_seed(0))
    for t in (18, 19, 21):
        with pytest.raises(ValueError, match="LENGTH_ALIGN"):
            tm.encoder.apply(tp["encoder"], torch.rand(1, t, 17))


@pytest.mark.parametrize("case,taps", [
    ("tcn", ["block0_h", "block1_h", "block2_h"]),
    ("dprnn", ["block0_chunks", "block1_chunks"]),
    ("conv-bilstm", ["conv_act", "lstm_act", "mid4"])])
def test_torch_new_encoder_debug_taps_match_jax(fresh_hparams, case, taps):
    """``Encoder.apply_debug`` returns the taps JAX's debug mode fetches,
    each at 1e-5."""
    keys, t = ENCODER_CASES[case]
    jm, jp, tm, tp = _pair(fresh_hparams, keys)
    x = _spectra(11, 2, t, tm.hp.FEATURE_SIZE)
    want = {}
    jm.encoder.apply(jp["encoder"], jnp.asarray(x), tap=want.__setitem__)
    _, got = tm.encoder.apply_debug(tp["encoder"], torch.from_numpy(x))
    assert sorted(got) == sorted(want) == sorted(taps)
    for name in taps:
        _close_peak(got[name], want[name])


def test_torch_new_encoders_dropout(fresh_hparams):
    """With train and a generator each new encoder drops out: one seed
    gives one loss, another seed another, no generator none."""
    for keys, t in (ENCODER_CASES["tcn"], ENCODER_CASES["dprnn"],
                    ENCODER_CASES["conv-bilstm"]):
        tm = TorchDaNet(load_config(**dict(keys, DROPOUT_KEEP_PROB=0.8)))
        tp = tm.init(torch.Generator().manual_seed(0))
        batch = torch.from_numpy(_src_ri(3, 2, t, tm.hp.FEATURE_SIZE))
        a, b, c = (float(tm.train_loss(tp, batch, g)[0]) for g in (
            torch.Generator().manual_seed(1),
            torch.Generator().manual_seed(1),
            torch.Generator().manual_seed(2)))
        assert a == b != c
        assert float(tm.train_loss(tp, batch, None)[0]) not in (a, c)


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("cfg,narrow", [
    ("configs/tcn.json", {"TCN_DIM": 16, "TCN_HIDDEN": 24,
                          "TCN_REPEATS": 1}),
    ("configs/dprnn.json", {"DPRNN_DIM": 12, "DPRNN_HIDDEN": 8,
                            "DPRNN_CHUNK": 16, "DPRNN_BLOCKS": 2}),
    (None, {"ENCODER_TYPE": "conv-bilstm-v1"})],
    ids=["tcn", "dprnn", "conv-bilstm"])
def test_torch_cli_trains_new_encoders(tmp_path, capsys, cfg, narrow):
    """``python -m danet_tpu_torch -m train -c configs/<file>`` builds,
    trains and saves on the CPU with narrowed widths (``--set``); then
    ``-m valid`` from the checkpoint.  conv-bilstm-v1 from default.json
    (its BiLSTMs at H 256; 2 batches of 2 x 32 frames)."""
    sets = dict(narrow, BATCH_SIZE=2, MAX_TRAIN_LEN=32,
                SUMMARY_DIR=str(tmp_path / "logs"))
    model = ["-ds", "toy", "--device", "cpu"]
    if cfg:
        model += ["-c", os.path.join(REPO, cfg)]
    for k, v in sets.items():
        model += ["--set", "%s=%s" % (k, v if isinstance(v, str)
                                      else json.dumps(v))]
    here = os.getcwd()
    os.chdir(tmp_path)
    try:
        cli.main(model + ["-m", "train", "-ne", "1", "-o", "ckpt",
                          "--no-valid-on-epoch", "--no-save-on-epoch"])
        assert ckpt.exists(str(tmp_path / "ckpt"))
        capsys.readouterr()
        cli.main(model + ["-m", "valid", "-i", "ckpt"])
        out = capsys.readouterr().out
    finally:
        os.chdir(here)
    assert out and "nan" not in out.lower()
