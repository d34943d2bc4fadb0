"""PyTorch port, the stream bundle (``serve.export_streamer``,
``StreamerBundle``, ``load_streamer``) on the CPU, against the JAX
package's live ``stream_init`` / ``stream_step``, as
``tests/test_serve.py:227`` holds JAX's own bundle: tcn-v1, dprnn-v1 and
attn-v1 at that test's widths, and lstm-orig (2 layers of 8 units).  The
same weights (``weights.from_jax``) and numpy chunks go to both packages.
Tolerance: rtol 1e-5, atol 1e-6, the JAX test's; and the bundle equals the
port's own live stream to 1e-6 (the same eager ops, traced).
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import danet_tpu.models.encoders as jenc  # noqa: E402
import danet_tpu_torch.models.encoders as tenc  # noqa: E402
from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
from danet_tpu_torch import serve, weights  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402

STRIDE = 64
# tests/test_serve.py:208's narrow configs, and lstm-orig
CONFIGS = {
    "tcn-v1": dict(ENCODER_TYPE="tcn-v1", TCN_CAUSAL=True, TCN_DIM=16,
                   TCN_HIDDEN=24, TCN_BLOCKS=2, TCN_REPEATS=1),
    "attn-v1": dict(ENCODER_TYPE="attn-v1", ATTN_CAUSAL=True,
                    ATTN_LOOKBACK=8, ATTN_DIM=32, ATTN_HEADS=4,
                    ATTN_LAYERS=2),
    "dprnn-v1": dict(ENCODER_TYPE="dprnn-v1", DPRNN_DIM=16, DPRNN_HIDDEN=12,
                     DPRNN_CHUNK=4, DPRNN_HOP=4, DPRNN_BLOCKS=2,
                     DPRNN_INTER_CAUSAL=True),
    "lstm-orig": dict(ENCODER_TYPE="lstm-orig"),
}
# the kernel ops each step program holds
STEP_OPS = {"tcn-v1": {}, "attn-v1": {},
            "dprnn-v1": {"danet.bilstm_scan.default": 2,
                         "danet.lstm_scan_state.default": 2},
            "lstm-orig": {"danet.lstm_scan_state.default": 2}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("encoder", sorted(CONFIGS))
def test_torch_stream_bundle_matches_jax(fresh_hparams, monkeypatch,
                                         tmp_path, encoder):
    """A warm-up of 8 frames and three 4-frame chunks through the port's
    stream bundle against JAX's live stream, the state threaded through
    the programs (tcn-v1's conv tails, dprnn-v1's per-position carries,
    attn-v1's K/V caches and int64 counts, lstm-orig's (c, h)); a feed
    before ``start`` raises."""
    for cls in (jenc.LstmEncoder, tenc.LstmEncoder):
        monkeypatch.setattr(cls, "HDIM", 8)
        monkeypatch.setattr(cls, "N_LAYERS", 2)
    keys = dict(CONFIGS[encoder], BATCH_SIZE=1)
    fresh_hparams.load(keys)
    fresh_hparams.digest()
    jm = JaxDaNet()
    jp = jm.init(jax.random.PRNGKey(0))
    hp = load_config(**keys)
    tm = hp.get_model()(hp)
    tp = weights.from_jax(jax.device_get(jp))
    warm_n, chunk_n = 8 * STRIDE, 4 * STRIDE
    man = serve.export_streamer(tm, tp, str(tmp_path), chunk_n, warm_n,
                                device="cpu")
    assert man["latency_samples"] == 256 - STRIDE
    assert man["format"] == "danet-tpu-torch-serve-stream-v1"
    step = torch.export.load(str(tmp_path / "stream_step.pt2"))
    assert dict(collections.Counter(
        str(n.target) for n in step.graph.nodes
        if str(n.target).startswith("danet."))) == STEP_OPS[encoder]

    rs = np.random.RandomState(0)
    warm = rs.randn(1, warm_n).astype(np.float32) * 0.1
    chunks = [rs.randn(1, chunk_n).astype(np.float32) * 0.1
              for _ in range(3)]
    bundle = serve.load_streamer(str(tmp_path))
    assert isinstance(bundle, serve.StreamerBundle)
    got = [bundle.start(warm)] + [bundle.feed(c) for c in chunks]
    out, state = jm.stream_init(jp, jnp.asarray(warm))
    want = [np.asarray(out)]
    with torch.no_grad():
        live, tstate = tm.stream_init(tp, torch.from_numpy(warm))
    lives = [live.numpy()]
    for c in chunks:
        out, state = jm.stream_step(jp, state, jnp.asarray(c))
        want.append(np.asarray(out))
        with torch.no_grad():
            live, tstate = tm.stream_step(tp, tstate, torch.from_numpy(c))
        lives.append(live.numpy())
    for g, w, v in zip(got, want, lives):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g, v, rtol=0, atol=1e-6)
    fresh = serve.load_streamer(str(tmp_path))
    with pytest.raises(RuntimeError, match="start"):
        fresh.feed(chunks[0])
