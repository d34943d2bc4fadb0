"""PyTorch port, long-form and causal streaming separation against the JAX
package on the CPU: the streaming DSP (``ops/dsp.py``), the recurrent ops'
``return_state``, the encoders' stream hooks, ``DaNet.separate_stream``,
``stream_init`` / ``stream_step`` and ``separate_long``, and
``serve.Streamer``.  The same numpy inputs go to both packages, the weights
carried by ``weights.from_jax``; JAX runs its 'xla' scans, the port the
kernels' plain versions.

Narrow widths (the recurrent encoders 2 layers of 8 units; attn-v1 and
moe-v1 width 32, 4 heads, 2 blocks, ATTN_LOOKBACK 12; tcn-v1 3 blocks of
16 / 24; dprnn-v1 2 blocks, D 12, H 8, segments of 8).  Tolerances: the
streaming DSP 2e-5 (the JAX package's STFT bar); ``return_state`` 1e-6
(the forward bar), its gradient 2e-5 + 1e-4 relative (the gradient bar);
the hooks 1e-5 relative and 1e-5 of the output's peak (float32 sums in
other orders, amplified by the layer norms as in
``test_torch_encoders_v2.py``); the separations 1e-4 of the peak (the
``separate_wav`` bar), and chunk invariance at JAX's own bound
(``tests/test_modules.py:676``: 2e-5 + 1e-4 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import danet_tpu.models.encoders as jenc  # noqa: E402
import danet_tpu_torch.models.encoders as tenc  # noqa: E402
from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
from danet_tpu.ops import dsp as jdsp  # noqa: E402
from danet_tpu.ops import rnn as jrnn  # noqa: E402
from danet_tpu_torch import serve, weights  # noqa: E402
from danet_tpu_torch.hparams import WINDOW_REGISTRY, load_config  # noqa
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402
from danet_tpu_torch.ops import dsp as tdsp  # noqa: E402
from danet_tpu_torch.ops import rnn as trnn  # noqa: E402
from danet_tpu_torch.ops.cuda import lstm as cuda_lstm  # noqa: E402

FFT, STRIDE = 256, 64
DSP_TOL = 2e-5
HOOK = dict(atol=1e-5, rtol=1e-5)
SEP_RTOL = 1e-4
INVARIANCE = dict(atol=2e-5, rtol=1e-4)
ATTN = dict(ATTN_DIM=32, ATTN_HEADS=4, ATTN_LAYERS=2, ATTN_CAUSAL=True,
            ATTN_LOOKBACK=12)
ENCODERS = {
    "lstm-orig": {},
    "gru-v1": {},
    "attn-v1": ATTN,
    "moe-v1": dict(ATTN, MOE_EXPERTS=3, MOE_TOP_K=2),
    "tcn-v1": dict(TCN_DIM=16, TCN_HIDDEN=24, TCN_BLOCKS=3, TCN_REPEATS=1,
                   TCN_CAUSAL=True),
    "dprnn-v1": dict(DPRNN_DIM=12, DPRNN_HIDDEN=8, DPRNN_CHUNK=8,
                     DPRNN_HOP=8, DPRNN_BLOCKS=2, DPRNN_INTER_CAUSAL=True),
}
# frames per chunk fed back to back (dprnn-v1: whole segments of 8)
CHUNKS = {"dprnn-v1": (16, 8, 24)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def narrow(monkeypatch):
    """The recurrent encoders of both packages at 2 layers of 8 units."""
    for pair in ((jenc.LstmEncoder, tenc.LstmEncoder),
                 (jenc.GruEncoder, tenc.GruEncoder),
                 (jenc.BiLstmEncoder, tenc.BiLstmEncoder)):
        for cls in pair:
            monkeypatch.setattr(cls, "HDIM", 8)
            monkeypatch.setattr(cls, "N_LAYERS", 2)


def _window():
    return WINDOW_REGISTRY["sqrt-hann"](FFT).astype(np.float32)


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=rtol)


def _close_peak(a, b, rtol):
    """Within ``rtol`` of the peak of ``b``."""
    b = np.asarray(b, np.float32)
    _close(a, b, atol=rtol * float(np.abs(b).max()))


def _pair(hp_jax, keys, seed=0):
    """(jax model, jax params, torch model, torch params) from default.json
    + ``keys``."""
    hp_jax.load(keys)
    hp_jax.digest()
    jm = JaxDaNet()
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = TorchDaNet(load_config(**keys))
    return jm, jp, tm, weights.from_jax(jax.device_get(jp))


def _mix_ri(seed, t, f=129):
    return np.random.RandomState(seed).randn(t, f, 2).astype(np.float32)


# ------------------------------------------------------------ streaming DSP
def test_torch_stream_frames_matches_jax():
    """Framing a chunk after the carried tail: the frames and the new
    tail, chunk after chunk."""
    rs = np.random.RandomState(0)
    tail_j = jnp.zeros((2, FFT - STRIDE))
    tail_t = torch.zeros(2, FFT - STRIDE)
    for k in (3, 1, 5):
        chunk = rs.randn(2, k * STRIDE).astype(np.float32)
        fj, tail_j = jdsp.stream_frames(tail_j, jnp.asarray(chunk), FFT,
                                        STRIDE)
        ft, tail_t = tdsp.stream_frames(tail_t, torch.from_numpy(chunk), FFT,
                                        STRIDE)
        assert tuple(ft.shape) == fj.shape == (2, k, FFT)
        _close(ft, fj, 0.0)
        _close(tail_t, tail_j, 0.0)
    with pytest.raises(ValueError, match="multiple of the stride"):
        tdsp.stream_frames(tail_t, torch.zeros(2, STRIDE + 1), FFT, STRIDE)


def test_torch_stft_frames_ri_matches_jax():
    frames = np.random.RandomState(1).randn(2, 7, FFT).astype(np.float32)
    ref = jdsp.stft_frames_ri(jnp.asarray(frames), _window())
    out = tdsp.stft_frames_ri(torch.from_numpy(frames), _window())
    assert tuple(out.shape) == ref.shape == (2, 7, 129, 2)
    _close(out, ref, DSP_TOL)


@pytest.mark.parametrize("stride", [64, 100, 128])
def test_torch_ola_periodic_denom_matches_jax(stride):
    ref = jdsp.ola_periodic_denom(_window(), stride)
    out = tdsp.ola_periodic_denom(_window(), stride)
    assert out.dtype == ref.dtype == np.float32
    _close(out, ref, 0.0)


def test_torch_istft_stream_ri_matches_jax():
    """The streaming iSTFT's samples and carried numerator, chunk after
    chunk, N sources."""
    rs = np.random.RandomState(2)
    ola_j = jnp.zeros((1, 2, FFT - STRIDE))
    ola_t = torch.zeros(1, 2, FFT - STRIDE)
    for k in (4, 1, 3):
        spec = rs.randn(1, 2, k, 129, 2).astype(np.float32)
        oj, ola_j = jdsp.istft_stream_ri(jnp.asarray(spec), STRIDE,
                                         _window(), ola_j)
        ot, ola_t = tdsp.istft_stream_ri(torch.from_numpy(spec), STRIDE,
                                         _window(), ola_t)
        assert tuple(ot.shape) == oj.shape == (1, 2, k * STRIDE)
        _close(ot, oj, DSP_TOL)
        _close(ola_t, ola_j, DSP_TOL)


def test_torch_streaming_stft_istft_roundtrip():
    """(test_dsp.py:154) Streaming STFT -> iSTFT with the carried tails
    gives the input back, FFT - STRIDE samples late, whatever the
    chunking."""
    w = _window()
    p = FFT - STRIDE
    wav = torch.from_numpy(np.random.RandomState(11).randn(
        1, 48 * STRIDE).astype(np.float32))
    scale = float(np.sum(w))

    def run(chunk_frames):
        tail, ola, outs = torch.zeros(1, p), torch.zeros(1, p), []
        step = chunk_frames * STRIDE
        for i in range(0, wav.shape[1], step):
            frames, tail = tdsp.stream_frames(tail, wav[:, i:i + step], FFT,
                                              STRIDE)
            o, ola = tdsp.istft_stream_ri(
                tdsp.stft_frames_ri(frames, w) * scale, STRIDE, w, ola)
            outs.append(o)
        return torch.cat(outs, dim=-1).numpy()

    big = run(16)
    np.testing.assert_allclose(big[:, p:], wav.numpy()[:, :big.shape[1] - p],
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(run(4), big, atol=1e-6)


# ----------------------------------------------------------- return_state
@pytest.mark.parametrize("reverse", [False, True])
def test_torch_lstm_return_state_matches_jax(reverse):
    """The sequence and the final carry (c, h) from a nonzero c0 / h0;
    reversed: the state after the first frame.  c in float32."""
    rs = np.random.RandomState(3)
    jp = jrnn.lstm_init(jax.random.PRNGKey(3), 5, 6,
                        gate_bias=(0.0, 1.5, -1.0, 1.0))
    x, c0, h0 = (rs.randn(*s).astype(np.float32) * 0.7
                 for s in ((3, 9, 5), (3, 6), (3, 6)))
    hs_j, (c_j, h_j) = jrnn.lstm_apply(
        jp, jnp.asarray(x), "tanh", reverse, jnp.asarray(c0),
        jnp.asarray(h0), backend="xla", return_state=True)
    hs_t, (c_t, h_t) = trnn.lstm_apply(
        weights.from_jax(jax.device_get(jp)), torch.from_numpy(x), "tanh",
        reverse, torch.from_numpy(c0), torch.from_numpy(h0),
        return_state=True)
    assert c_t.dtype == torch.float32
    for got, want in ((hs_t, hs_j), (c_t, c_j), (h_t, h_j)):
        assert tuple(got.shape) == want.shape
        _close(got, want, 1e-6)


@pytest.mark.parametrize("reverse", [False, True])
def test_torch_gru_return_state_matches_jax(reverse):
    rs = np.random.RandomState(4)
    jp = jrnn.gru_init(jax.random.PRNGKey(4), 5, 6, w_scale=0.5)
    x, c0 = (rs.randn(*s).astype(np.float32) * 0.7
             for s in ((3, 9, 5), (3, 6)))
    xj = jnp.asarray(x[:, ::-1] if reverse else x)
    cs_j, c_j = jrnn.gru_apply(jp, xj, jnp.asarray(c0), backend="xla",
                               return_state=True)
    xt = torch.from_numpy(np.array(xj))
    cs_t, c_t = trnn.gru_apply(weights.from_jax(jax.device_get(jp)), xt,
                               torch.from_numpy(c0), return_state=True)
    _close(cs_t, cs_j, 1e-6)
    _close(c_t, c_j, 1e-6)


def test_torch_lstm_return_state_is_differentiable_on_the_plain_path():
    """Under autograd on the CPU the carry comes from the plain scan and
    carries gradients: d(sum hs + sum c + sum h)/dx against JAX's."""
    rs = np.random.RandomState(5)
    jp = jrnn.lstm_init(jax.random.PRNGKey(5), 4, 6)
    x = rs.randn(2, 7, 4).astype(np.float32)

    def jloss(xv):
        hs, (c, h) = jrnn.lstm_apply(jp, xv, backend="xla",
                                     return_state=True)
        return jnp.sum(hs) + jnp.sum(c) + jnp.sum(h)

    want = jax.grad(jloss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    hs, (c, h) = trnn.lstm_apply(weights.from_jax(jax.device_get(jp)), xt,
                                 return_state=True)
    (hs.sum() + c.sum() + h.sum()).backward()
    _close(xt.grad, want, 2e-5, 1e-4)


def test_torch_lstm_scan_state_wrapper_carries_float32():
    """``lstm_scan(..., return_state=True)`` on the CPU: the plain version;
    c_T is the float32 carry, from a float32 c0 whatever the storage dtype,
    and in float32 it equals the saving forward's last cs."""
    rs = np.random.RandomState(6)
    t, b, h = 5, 3, 4
    xp = torch.from_numpy(rs.randn(t, b, 4 * h).astype(np.float32))
    wh = torch.from_numpy(rs.randn(h, 4 * h).astype(np.float32) * 0.3)
    c0 = torch.from_numpy(rs.randn(b, h).astype(np.float32))
    h0 = torch.from_numpy(rs.randn(b, h).astype(np.float32) * 0.5)
    hs, c_t = cuda_lstm.lstm_scan(xp, wh, c0, h0, True, return_state=True)
    ref_hs, ref_cs, _ = cuda_lstm.lstm_scan_train_plain(xp, wh, c0, h0, True)
    assert c_t.dtype == torch.float32 and tuple(c_t.shape) == (b, h)
    _close(hs, ref_hs, 0.0)
    _close(c_t, ref_cs[-1], 0.0)
    bf = [v.to(torch.bfloat16) for v in (xp, wh, h0)]
    hs16, c16 = cuda_lstm.lstm_scan(bf[0], bf[1], c0, bf[2], True,
                                    return_state=True)
    assert hs16.dtype == torch.bfloat16 and c16.dtype == torch.float32


def test_torch_by_rows_splits_the_final_carry():
    """A batch above the row ceiling: every output, c_T [B, H] beside hs
    [T, B, H], is cut and joined on the batch axis."""
    xp = torch.arange(2 * 7 * 3.0).reshape(2, 7, 3)
    c0 = torch.arange(7 * 3.0).reshape(7, 3)
    calls = []

    def run(xp, c0, h0):
        calls.append(xp.shape[-2])
        return xp * 2, c0 + 1
    hs, c_t = cuda_lstm._by_rows(run, 3, xp, c0, c0)
    assert calls == [3, 3, 1]
    _close(hs, xp * 2, 0.0)
    _close(c_t, c0 + 1, 0.0)


# ----------------------------------------------------------------- hooks
@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_torch_encoder_stream_hooks_match_jax(fresh_hparams, narrow,
                                              encoder):
    """Chunks fed back to back through ``stream_hidden``: the hidden
    sequence against JAX's hooks on the same chunks, and the head over it
    (centred by its own mean) against the port's offline ``apply``."""
    keys = dict(ENCODERS[encoder], ENCODER_TYPE=encoder)
    jm, jp, tm, tp = _pair(fresh_hparams, keys)
    t = 48
    logmag = np.abs(np.random.RandomState(7).randn(2, t, 129)).astype(
        np.float32)
    x = logmag - logmag.mean(axis=(1, 2), keepdims=True)
    js = jm.encoder.stream_state_init(2)
    ts = tm.encoder.stream_state_init(2)
    outs_j, outs_t, lo = [], [], 0
    for c in CHUNKS.get(encoder, (5, 11, 32)):
        hj, js = jm.encoder.stream_hidden(jp["encoder"],
                                          jnp.asarray(x[:, lo:lo + c]), js)
        ht, ts = tm.encoder.stream_hidden(tp["encoder"],
                                          torch.from_numpy(x[:, lo:lo + c]),
                                          ts)
        outs_j.append(np.asarray(hj))
        outs_t.append(ht)
        lo += c
    h_t = torch.cat(outs_t, dim=1)
    want = np.concatenate(outs_j, axis=1)
    assert tuple(h_t.shape) == want.shape
    _close(h_t, want, HOOK["atol"] * max(1.0, float(np.abs(want).max())),
           HOOK["rtol"])
    embed = tm.encoder.stream_head(tp["encoder"], h_t,
                                   h_t.mean(dim=(1, 2), keepdim=True))
    offline = tm.encoder.apply(tp["encoder"], torch.from_numpy(logmag))
    _close(embed, offline, HOOK["atol"] * max(
        1.0, float(offline.abs().max())), HOOK["rtol"])


# ------------------------------------------------------------- separation
@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_torch_separate_stream_matches_jax(fresh_hparams, narrow, encoder):
    """``separate_stream`` against JAX's at 1e-4 of the peak, and the
    port's output invariant to the chunk size, a T the chunks do not
    divide included."""
    keys = dict(ENCODERS[encoder], ENCODER_TYPE=encoder)
    jm, jp, tm, tp = _pair(fresh_hparams, keys)
    g = 8 if encoder == "dprnn-v1" else 1
    mix = _mix_ri(3, 40)
    want = np.asarray(jm.separate_stream(jp, jnp.asarray(mix), 24, 16))
    with torch.no_grad():
        big = tm.separate_stream(tp, torch.from_numpy(mix), 24, 16)
        small = tm.separate_stream(tp, torch.from_numpy(mix), 4 * g, 16)
        pad = tm.separate_stream(tp, torch.from_numpy(mix), 7 if g == 1
                                 else 16, 16)
    assert tuple(big.shape) == want.shape == (2, 40, 129, 2)
    _close_peak(big, want, SEP_RTOL)
    _close(small, big, **INVARIANCE)
    _close(pad, big, **INVARIANCE)


def test_torch_separate_stream_refuses_other_encoders(fresh_hparams,
                                                      narrow):
    """bilstm-orig, and dprnn-v1 without its online keys: ValueError, as
    in JAX; dprnn-v1's chunks in whole segments."""
    mix = torch.zeros(16, 129, 2)
    dprnn = dict(ENCODERS["dprnn-v1"], ENCODER_TYPE="dprnn-v1")
    for keys in (dict(ENCODER_TYPE="bilstm-orig"),
                 dict(dprnn, DPRNN_HOP=4),
                 dict(dprnn, DPRNN_INTER_CAUSAL=False)):
        model = TorchDaNet(load_config(**keys))
        params = model.init(torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="causal"):
            model.separate_stream(params, mix)
        with pytest.raises(ValueError, match="causal"):
            model.stream_init(params, torch.zeros(1, 8 * STRIDE))
        if keys.get("ENCODER_TYPE") != "bilstm-orig":
            with pytest.raises(ValueError, match="causal"):
                model.encoder.stream_state_init(1)
    model = TorchDaNet(load_config(**dprnn))
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="multiple of the encoder"):
        model.separate_stream(params, mix, chunk_frames=12, warmup_frames=8)
    with pytest.raises(ValueError, match="segments"):
        model.stream_init(params, torch.zeros(1, 12 * STRIDE))


@pytest.mark.parametrize("encoder", ["lstm-orig", "tcn-v1", "dprnn-v1"])
def test_torch_stream_init_step_match_jax(fresh_hparams, narrow, encoder):
    """(test_serve.py:308) ``stream_init`` then ``stream_step`` over
    waveforms: the warm-up's and each step's samples against JAX's at 1e-4
    of the peak, the states' tails alike, and the port's steps invariant to
    the chunking."""
    keys = dict(ENCODERS[encoder], ENCODER_TYPE=encoder)
    jm, jp, tm, tp = _pair(fresh_hparams, keys)
    wav = np.random.RandomState(3).randn(1, 48 * STRIDE).astype(
        np.float32) * 0.1
    warm, rest = wav[:, :16 * STRIDE], wav[:, 16 * STRIDE:]
    out_j, st_j = jm.stream_init(jp, jnp.asarray(warm))
    with torch.no_grad():
        out_t, st_t = tm.stream_init(tp, torch.from_numpy(warm))
    assert sorted(st_t) == sorted(st_j)
    _close_peak(out_t, out_j, SEP_RTOL)
    step = 16 * STRIDE if encoder == "dprnn-v1" else 8 * STRIDE
    big_parts, parts, st2 = [], [], st_t
    for i in range(0, rest.shape[1], step):
        chunk = rest[:, i:i + step]
        oj, st_j = jm.stream_step(jp, st_j, jnp.asarray(chunk))
        with torch.no_grad():
            ot, st_t = tm.stream_step(tp, st_t, torch.from_numpy(chunk))
        _close_peak(ot, oj, SEP_RTOL)
        big_parts.append(ot)
    for name in ("stft_tail", "ola_tail", "mu_in", "mu_head", "attractors"):
        _close_peak(st_t[name], st_j[name], SEP_RTOL)
    half = step // 2 if encoder != "dprnn-v1" else 8 * STRIDE
    with torch.no_grad():
        for i in range(0, rest.shape[1], half):
            o, st2 = tm.stream_step(tp, st2,
                                    torch.from_numpy(rest[:, i:i + half]))
            parts.append(o)
    _close(torch.cat(parts, -1), torch.cat(big_parts, -1), **INVARIANCE)


@pytest.mark.parametrize("t", [300, 100])
def test_torch_separate_long_matches_jax(fresh_hparams, narrow, t):
    """(test_modules.py:318) bilstm-orig's ``separate_long``: two disjoint
    bands, chunks of 128 frames overlapping by 32 (300 frames: 3 chunks,
    aligned and crossfaded; 100: one), against JAX's at 1e-4 of the
    peak."""
    jm, jp, tm, tp = _pair(fresh_hparams, dict(ENCODER_TYPE="bilstm-orig"))
    rng = np.random.RandomState(0)
    lo = np.zeros((t, 129), np.complex64)
    hi = np.zeros((t, 129), np.complex64)
    lo[:, 5:20] = rng.randn(t, 15) + 1j * rng.randn(t, 15)
    hi[:, 60:75] = rng.randn(t, 15) + 1j * rng.randn(t, 15)
    mix = lo + hi
    mix_ri = np.stack([mix.real, mix.imag], -1).astype(np.float32)
    want = np.asarray(jm.separate_long(jp, jnp.asarray(mix_ri), 128, 32))
    with torch.no_grad():
        out = tm.separate_long(tp, torch.from_numpy(mix_ri), 128, 32)
    assert tuple(out.shape) == want.shape == (2, t, 129, 2)
    assert torch.isfinite(out).all()
    _close_peak(out, want, SEP_RTOL)
    with pytest.raises(ValueError, match="overlap"):
        tm.separate_long(tp, torch.from_numpy(mix_ri), 32, 32)


# --------------------------------------------------------------- Streamer
def test_torch_streamer_equals_stream_init_and_step(fresh_hparams, narrow,
                                                    tmp_path):
    """``serve.load_streamer`` on saved weights: ``start`` plus ``feed``s
    give ``stream_init`` plus ``stream_step``; feeding before ``start`` and
    a chunk of another size raise."""
    keys = dict(ENCODERS["tcn-v1"], ENCODER_TYPE="tcn-v1")
    model = TorchDaNet(load_config(**keys))
    params = model.init(torch.Generator().manual_seed(2))
    path = str(tmp_path / "w.npz")
    weights.save_npz(path, params)
    cfg = tmp_path / "cfg.json"
    import json
    cfg.write_text(json.dumps(keys))
    s = serve.load_streamer(path, [str(cfg)], chunk_samples=4 * STRIDE,
                            warmup_samples=8 * STRIDE, device="cpu")
    assert s.latency_samples == FFT - STRIDE
    with pytest.raises(RuntimeError, match="start"):
        s.feed(np.zeros(4 * STRIDE, np.float32))
    wav = np.random.RandomState(9).randn(20 * STRIDE).astype(np.float32)
    got = [s.start(wav[:8 * STRIDE])]
    for i in range(8 * STRIDE, 20 * STRIDE, 4 * STRIDE):
        got.append(s.feed(wav[i:i + 4 * STRIDE]))
    with pytest.raises(ValueError, match="chunk"):
        s.feed(np.zeros(3 * STRIDE, np.float32))
    with torch.no_grad():
        out, st = model.stream_init(params,
                                    torch.from_numpy(wav[None, :8 * STRIDE]))
        want = [out.numpy()]
        for i in range(8 * STRIDE, 20 * STRIDE, 4 * STRIDE):
            out, st = model.stream_step(
                params, st, torch.from_numpy(wav[None, i:i + 4 * STRIDE]))
            want.append(out.numpy())
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _close(g, w, 1e-6)
    with pytest.raises(ValueError, match="multiples"):
        serve.Streamer(model, params, "cpu", 100, 8 * STRIDE)


def test_torch_state_refusal_names_its_item(monkeypatch):
    """return_state under autograd no longer refuses the card: on a (faked)
    card it launches the saving forward's state entry and kernel 3 seeded
    with the final carry's cotangent, once each, and its gradients equal
    the CPU's plain ones."""
    from danet_tpu_torch.ops.cuda import lstm as cuda_lstm
    rs = np.random.RandomState(11)
    p = {k: torch.from_numpy(rs.uniform(-0.4, 0.4, shape).astype(
        np.float32)) for k, shape in (("wx", (3, 4, 5)), ("wh", (5, 4, 5)),
                                      ("b", (4, 5)))}
    x = torch.from_numpy(rs.randn(2, 6, 3).astype(np.float32))

    def grads():
        ps = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        y, (c, h) = trnn.lstm_apply(ps, x, return_state=True)
        (torch.sum(torch.sin(y)) + torch.sum(c * c) + torch.sum(h)).backward()
        return [ps[k].grad for k in sorted(ps)]

    want = grads()
    plain = {n: getattr(cuda_lstm, n) for n in (
        "lstm_scan_train_state_plain", "lstm_scan_bwd_plain")}

    def fake_launch(entry, what, device, tensors, ints):
        tanh = bool(ints[4])
        if entry == "danet_lstm_scan_train_state":
            outs = plain["lstm_scan_train_state_plain"](*tensors[:4], tanh)
            dst = tensors[4:8]
        else:
            assert entry == "danet_lstm_scan_bwd_seeded", entry
            outs = plain["lstm_scan_bwd_plain"](*tensors[:5], tanh,
                                                tensors[8])
            dst = tensors[5:8]
        for d, o in zip(dst, outs):
            d.copy_(o)
    monkeypatch.setattr(cuda_lstm, "_on_cuda", lambda t, what: True)
    monkeypatch.setattr(cuda_lstm, "_launch", fake_launch)
    monkeypatch.setattr(cuda_lstm, "max_rows", lambda *a: 0)
    kernels = (cuda_lstm.lstm_scan_train_state,
               cuda_lstm.lstm_scan_bwd_seeded)
    for fn in kernels:
        fn.launches = 0
    got = grads()
    assert [fn.launches for fn in kernels] == [1, 1]
    for fn in kernels:
        fn.launches = 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6)
