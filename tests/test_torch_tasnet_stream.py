"""PyTorch port, tasnet-v1's exact causal streaming
(``TasNet.stream_init`` / ``stream_step``, ``danet_tpu/models/tasnet.py:
407-496``) on the CPU, against the JAX package at
``tests/test_tasnet.py:152``'s widths (TASNET_FILTERS 48, BOTTLENECK 24,
HIDDEN 32, 3 x 2 blocks, TASNET_CAUSAL), the same weights
(``weights.from_jax``) and numpy waves in both packages.

Tolerances: the stream against JAX's offline separation of the
zero-prefixed wave and against JAX's own stream, rtol 2e-4 / atol 2e-5
(that test's bar); the port's chunkings against each other at the JAX
stream test's 1e-5 / 1e-6; the stream bundle against the port's live
stream 1e-6 and JAX's live stream at the tasnet bar.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from danet_tpu.models import TasNet as JaxTasNet  # noqa: E402
from danet_tpu_torch import serve, weights  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402

CAUSAL = dict(MODEL_TYPE="tasnet-v1", BATCH_SIZE=1, TASNET_FILTERS=48,
              TASNET_BOTTLENECK=24, TASNET_HIDDEN=32, TASNET_BLOCKS=3,
              TASNET_REPEATS=2, TASNET_CAUSAL=True)
TASNET = dict(rtol=2e-4, atol=2e-5)
CHUNKINGS = ((1024,), (256,) * 4, (64,) * 16, (8,) * 128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def causal(fresh_hparams):
    """(jax model, jax params, port model, port params), causal tasnet-v1
    at tests/test_tasnet.py:152's widths and seed."""
    fresh_hparams.load(CAUSAL)
    fresh_hparams.digest()
    jm = JaxTasNet()
    jp = jm.init(jax.random.PRNGKey(1))
    hp = load_config(**CAUSAL)
    return jm, jp, hp.get_model()(hp), weights.from_jax(jax.device_get(jp))


def _stream(model, params, wav, chunks, to=np.asarray, of=lambda x: x):
    """``wav`` [1, L] through stream_init + stream_step in ``chunks``."""
    out, state = model.stream_init(params, of(wav[:, :chunks[0]]))
    parts, off = [to(out)], chunks[0]
    for c in chunks[1:]:
        out, state = model.stream_step(params, state,
                                       of(wav[:, off:off + c]))
        parts.append(to(out))
        off += c
    return np.concatenate(parts, axis=-1)


def _torch_stream(model, params, wav, chunks):
    with torch.no_grad():
        return _stream(model, params, wav, chunks, to=lambda x: x.numpy(),
                       of=torch.from_numpy)


@pytest.mark.parametrize("chunks", CHUNKINGS, ids=lambda c: str(c[0]))
def test_torch_tasnet_stream_is_exact_against_jax(causal, chunks):
    """(test_tasnet.py:167) the port's stream equals JAX's offline
    separation of the zero-prefixed wave, delayed by win - stride, and
    JAX's own stream, at every chunking."""
    jm, jp, tm, tp = causal
    lag = tm.stream_latency_samples()
    assert lag == jm.stream_latency_samples() == 8
    assert tm.stream_granularity_samples() == 8
    wav = np.random.RandomState(0).randn(1, 1024).astype(np.float32) * 0.3
    pre = np.concatenate([np.zeros((1, lag), np.float32), wav], axis=-1)
    offline = np.asarray(jm.separate_wav(jp, jnp.asarray(pre)))[..., :1024]
    got = _torch_stream(tm, tp, wav, chunks)
    assert got.shape == (1, 2, 1024)
    np.testing.assert_allclose(got, offline, **TASNET)
    want = _stream(jm, jp, wav, chunks, of=jnp.asarray)
    np.testing.assert_allclose(got, want, **TASNET)


def test_torch_tasnet_stream_is_chunk_invariant(causal):
    """The port's stream does not depend on the chunking (1e-5 / 1e-6),
    and its state keeps JAX's keys and shapes (the conv tails in
    COMPUTE_DTYPE, the wave and overlap-add tails float32)."""
    _, _, tm, tp = causal
    wav = np.random.RandomState(2).randn(1, 1024).astype(np.float32) * 0.3
    outs = [_torch_stream(tm, tp, wav, c) for c in CHUNKINGS]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=1e-5, atol=1e-6)
    state = tm.stream_state_init(3)
    assert sorted(state) == ["conv_tails", "ola_tail", "wav_tail"]
    assert tuple(state["wav_tail"].shape) == (3, 8)
    assert tuple(state["ola_tail"].shape) == (3, 2, 8)
    assert [tuple(t.shape) for t in state["conv_tails"]] == [
        (3, 2 * 2 ** (i % 3), 32) for i in range(6)]
    assert {t.dtype for t in state["conv_tails"]} == {torch.float32}
    with pytest.raises(ValueError, match="multiple of TASNET_STRIDE"):
        tm.stream_step(tp, state, torch.zeros(3, 12))


def test_torch_tasnet_stream_requires_causal(fresh_hparams):
    """(test_tasnet.py:196) a non-causal tasnet-v1 refuses to stream, with
    JAX's error, also through ``serve.Streamer``."""
    hp = load_config(**dict(CAUSAL, TASNET_CAUSAL=False))
    model = hp.get_model()(hp)
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="TASNET_CAUSAL"):
        model.stream_init(params, torch.zeros(1, 64))
    s = serve.Streamer(model, params, "cpu", 64, 256)
    with pytest.raises(ValueError, match="TASNET_CAUSAL"):
        s.start(np.zeros(256, np.float32))


def test_torch_tasnet_live_streamer(causal):
    """The live ``Streamer`` asks the model for its granularity and lag:
    TASNET_STRIDE-sized chunks are accepted (8 samples, which FFT_STRIDE
    does not divide), the lag is win - stride, and the output is the
    model's stream."""
    _, _, tm, tp = causal
    s = serve.Streamer(tm, tp, "cpu", 8, 256)
    assert s.latency_samples == 8
    wav = np.random.RandomState(3).randn(1, 320).astype(np.float32) * 0.3
    got = [s.start(wav[0, :256])] + [s.feed(wav[0, i:i + 8])
                                     for i in range(256, 320, 8)]
    np.testing.assert_allclose(np.concatenate(got, -1),
                               _torch_stream(tm, tp, wav, (256,) + (8,) * 8),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="granularity 8"):
        serve.Streamer(tm, tp, "cpu", 12, 256)


def test_torch_tasnet_stream_bundle(causal, tmp_path):
    """(test_tasnet.py:202) ``export_streamer`` takes the model's
    granularity and lag; the bundle reproduces the port's live stream
    (1e-6) and JAX's (the tasnet bar)."""
    jm, jp, tm, tp = causal
    man = serve.export_streamer(tm, tp, str(tmp_path), chunk_samples=64,
                                warmup_samples=256, device="cpu")
    assert man["latency_samples"] == 8 and man["fft_stride"] == 8
    bundle = serve.load_streamer(str(tmp_path))
    wav = np.random.RandomState(1).randn(1, 512).astype(np.float32) * 0.3
    got = np.concatenate([bundle.start(wav[0, :256])] + [
        bundle.feed(wav[0, lo:lo + 64]) for lo in range(256, 512, 64)], -1)
    chunks = (256,) + (64,) * 4
    np.testing.assert_allclose(got, _torch_stream(tm, tp, wav, chunks),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        got, _stream(jm, jp, wav, chunks, of=jnp.asarray), **TASNET)
