"""PyTorch port, the forward kernels as ``torch.library`` ops
(``danet_tpu_torch/ops/cuda/library.py``) on the CPU.

Each op's CPU implementation is its kernel's plain version, bit for bit;
``torch.library.opcheck`` passes for each (schema, fake tensors, the
dispatcher paths an export takes); a model exported on the CPU names the
ops of its kernels among its graph's nodes, which is what carries the
kernels into an artifact exported on the card; the no-gradient paths of
the recurrent layers and of the flash attention go through them; and
``DaNet.parameter_count`` equals the JAX package's.  The ops' CUDA
implementations (the kernels) run only on the card: ``chip_smoke.py``
phase 25 (a).
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import danet_tpu_torch.models.encoders as tenc  # noqa: E402
from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
from danet_tpu_torch import serve, weights  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.ops import rnn as trnn  # noqa: E402
from danet_tpu_torch.ops.cuda import attention as cuda_attn  # noqa: E402
from danet_tpu_torch.ops.cuda import gru as cuda_gru  # noqa: E402
from danet_tpu_torch.ops.cuda import library  # noqa: E402
from danet_tpu_torch.ops.cuda import lstm as cuda_lstm  # noqa: E402
from danet_tpu_torch.ops.cuda import stft as cuda_stft  # noqa: E402
from danet_tpu_torch.windows import WINDOW_REGISTRY  # noqa: E402

T, B, H = 5, 3, 4


def _r(rs, *shape, scale=1.0):
    return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32))


def _cases():
    """(op, its plain version, arguments) of every op at tiny shapes."""
    rs = np.random.RandomState(0)
    r = lambda *s: _r(rs, *s)  # noqa: E731
    w = WINDOW_REGISTRY["sqrt-hann"](256).astype(np.float32)
    x = r(2, 1000)
    seg = torch.zeros(2, 128, dtype=torch.int32)
    seg[:, 100:] = 1
    qkv = [r(2, 128, 2, 16) for _ in range(3)]
    lstm1 = (r(T, B, 4 * H), r(H, 4 * H) * 0.3, r(B, H), r(B, H))
    return {
        "stft_ri": (library.stft_ri_op,
                    lambda *a: cuda_stft.stft_ri_plain(x, 256, 64, w),
                    (x, 256, 64, "sqrt-hann", "float32", False)),
        "stft_ri_logmag": (library.stft_ri_op,
                           lambda *a: cuda_stft.stft_ri_plain(x, 256, 64, w,
                                                              True),
                           (x, 256, 64, "sqrt-hann", "float32", True)),
        "bilstm_scan": (library.bilstm_scan, cuda_lstm.bilstm_scan_plain,
                        (r(T, 2, B, 4 * H), r(2, H, 4 * H) * 0.3,
                         r(2, B, H), r(2, B, H), True)),
        "lstm_scan": (library.lstm_scan, cuda_lstm.lstm_scan_plain,
                      lstm1 + (False,)),
        "lstm_scan_state": (library.lstm_scan_state,
                            lambda *a: cuda_lstm.lstm_scan_plain(
                                *a, return_state=True), lstm1 + (True,)),
        "gru_scan": (library.gru_scan, cuda_gru.gru_scan_plain,
                     (r(T, B, 2 * H), r(T, B, H), r(H, 2 * H) * 0.3,
                      r(H, H) * 0.3, r(B, H))),
        "flash_attn": (library.flash_attn, cuda_attn.flash_attn_plain,
                       tuple(qkv) + (seg, 0.25)),
        "flash_attn_noseg": (library.flash_attn, cuda_attn.flash_attn_plain,
                             tuple(qkv) + (None, 0.25)),
    }


CASES = sorted(_cases())


@pytest.mark.parametrize("name", CASES)
def test_torch_op_cpu_is_the_plain_version(name):
    """On a CPU tensor each op returns its kernel's plain version bit for
    bit, and counts no kernel launch."""
    op, plain, args = _cases()[name]
    counters = [cuda_stft.stft_ri, cuda_stft.stft_logmag,
                cuda_lstm.bilstm_scan, cuda_lstm.lstm_scan,
                cuda_gru.gru_scan, cuda_attn.flash_attn]
    before = [c.launches for c in counters]
    got, want = op(*args), plain(*args)
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("name", CASES)
def test_torch_op_passes_opcheck(name):
    """``torch.library.opcheck``: the schema, the fake implementation
    against the real one, and the dispatch an export and AOT autograd
    take."""
    op, _, args = _cases()[name]
    torch.library.opcheck(op, args)


def test_torch_stft_op_names_its_window():
    """The STFT op takes its window by registry name and dtype: the helper
    finds them from the array; a window of no registry entry raises."""
    w = WINDOW_REGISTRY["hann"](200).astype(np.float64)
    assert library.window_key(w) == ("hann", "float64")
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 700))
    np.testing.assert_array_equal(
        library.stft_ri(x, 200, 50, w).numpy(),
        cuda_stft.stft_ri_plain(x, 200, 50, w).numpy())
    with pytest.raises(ValueError, match="window of the registry"):
        library.stft_ri(x, 200, 50, w * 0.5)


ATTN = dict(ATTN_DIM=32, ATTN_HEADS=2, ATTN_LAYERS=2)
# (config keys, the danet.* nodes the exported graph holds)
GRAPHS = {
    "bilstm-orig": ({}, {"danet.stft_ri.default": 1,
                         "danet.bilstm_scan.default": 2}),
    "lstm-orig": ({}, {"danet.stft_ri.default": 1,
                       "danet.lstm_scan.default": 2}),
    "gru-v1": ({}, {"danet.stft_ri.default": 1,
                    "danet.gru_scan.default": 2}),
    "attn-v1": (dict(ATTN, ATTN_BACKEND="flash"),
                {"danet.stft_ri.default": 1,
                 "danet.flash_attn.default": 2}),
}


@pytest.mark.parametrize("encoder", sorted(GRAPHS))
def test_torch_export_names_the_kernel_ops(monkeypatch, tmp_path, encoder):
    """A narrow DaNet exported on the CPU (``serve.export_separator``)
    holds one ``danet.stft_ri`` and one scan or flash op per layer among
    its graph's nodes, and nothing else of the namespace: an export on the
    card records the same nodes, whose CUDA implementations launch the
    kernels.  The loaded program equals the live model on the padded
    wave."""
    for cls in (tenc.LstmEncoder, tenc.GruEncoder, tenc.BiLstmEncoder):
        monkeypatch.setattr(cls, "HDIM", 8)
        monkeypatch.setattr(cls, "N_LAYERS", 2)
    keys, want = GRAPHS[encoder]
    hp = load_config(ENCODER_TYPE=encoder, **keys)
    model = hp.get_model()(hp)
    params = model.init(torch.Generator().manual_seed(0))
    length = 64 * 127                               # T = 128 frames
    serve.export_separator(model, params, str(tmp_path), [length],
                           device="cpu")
    program = torch.export.load(str(tmp_path / ("sep_%d.pt2" % length)))
    nodes = collections.Counter(
        str(n.target) for n in program.graph.nodes
        if n.op == "call_function" and str(n.target).startswith("danet."))
    assert dict(nodes) == want
    wav = torch.from_numpy(np.random.RandomState(5).randn(1, length).astype(
        np.float32) * 0.1)
    with torch.no_grad():
        got = program.module()(wav)
        live = model.separate_wav(params, wav)
    assert torch.equal(got, live)


@pytest.mark.parametrize("backend, op", [("auto", "bilstm_scan"),
                                         ("xla", None)])
def test_torch_no_grad_scan_takes_the_op(monkeypatch, backend, op):
    """Without a gradient, ``bilstm_apply`` on the kernel backends calls
    ``danet::bilstm_scan``; on 'xla' the plain version directly; under
    autograd the autograd Function (no op)."""
    calls = []
    real = library.bilstm_scan
    monkeypatch.setattr(library, "bilstm_scan",
                        lambda *a: calls.append(a) or real(*a))
    rs = np.random.RandomState(2)
    params = trnn.bilstm_init(torch.Generator().manual_seed(0), 6, 4)
    x = _r(rs, 2, 7, 6)
    with torch.no_grad():
        y = trnn.bilstm_apply(params, x, backend=backend)
    assert len(calls) == (1 if op else 0)
    params["fwd"]["wh"].requires_grad_(True)
    y2 = trnn.bilstm_apply(params, x, backend=backend)
    assert len(calls) == (1 if op else 0)
    assert torch.equal(y, y2.detach())


def test_torch_parameter_count_matches_jax(fresh_hparams, monkeypatch):
    """``DaNet.parameter_count`` equals the JAX package's (the CLI prints
    it)."""
    import danet_tpu.models.encoders as jenc
    for cls in (jenc.BiLstmEncoder, tenc.BiLstmEncoder):
        monkeypatch.setattr(cls, "HDIM", 8)
    fresh_hparams.ENCODER_TYPE = "bilstm-orig"
    fresh_hparams.digest()
    jm = JaxDaNet()
    jp = jm.init(jax.random.PRNGKey(0))
    hp = load_config(ENCODER_TYPE="bilstm-orig")
    tm = hp.get_model()(hp)
    tp = weights.from_jax(jax.device_get(jp))
    assert tm.parameter_count(tp) == jm.parameter_count(jp) > 0
    assert tm.parameter_count(tm.init(torch.Generator())) \
        == jm.parameter_count(jp)
