"""PyTorch port, the separator bundle (``serve.export_separator``,
``SeparatorBundle``, ``load_separator``, the ``export`` / ``run -d`` CLI)
on the CPU, against the JAX package's ``export_separator`` +
``load_separator`` and its live ``separate_wav``.

The same weights (carried by ``weights.from_jax``) and numpy requests go
to both packages; the toy encoder of default.json unless a test says
otherwise.  Tolerances: against JAX 1e-4 of the output's peak (ROADMAP's
``separate_wav`` bar); against the port's own live model on the padded
wave 1e-6 (the same eager ops, traced); bfloat16 weights 5e-2 of the
float32 bundle, as ``tests/test_serve.py:322``; the CLI's WAVs one int16
step.  Ported from ``tests/test_serve.py``: the bucket errors, the format
guard, the caller's hparams left as they were and the bf16 weights.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io.wavfile

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from danet_tpu import serve as jserve  # noqa: E402
from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
from danet_tpu_torch import serve, weights  # noqa: E402
from danet_tpu_torch.data import audio  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENGTHS = [4096, 8192]
SEP_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_pair(keys, seed=0):
    """(jax model, jax params, port model, port params) from default.json
    + ``keys``; the JAX hparams singleton is restored afterwards by the
    caller's ``fresh_hparams`` or by ``_toy``."""
    from danet_tpu.hparams import hparams
    hparams.load_json(os.path.join(REPO, "default.json"))
    hparams.load(dict(keys, BATCH_SIZE=1))
    hparams.digest()
    jm = JaxDaNet()
    jp = jm.init(jax.random.PRNGKey(seed))
    hp = load_config(**keys)
    tm = hp.get_model()(hp)
    return jm, jp, tm, weights.from_jax(jax.device_get(jp))


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy model of both packages and their bundles at LENGTHS: the
    port's exported on the CPU, JAX's by its own export."""
    import copy

    from danet_tpu.hparams import hparams
    saved = copy.copy(hparams.__dict__)
    try:
        jm, jp, tm, tp = _jax_pair(dict(ENCODER_TYPE="toy"))
        root = tmp_path_factory.mktemp("bundles")
        manifest = serve.export_separator(tm, tp, str(root / "port"),
                                          LENGTHS, device="cpu")
        jserve.export_separator(jm, jp, str(root / "jax"), LENGTHS)
        yield dict(jm=jm, jp=jp, tm=tm, tp=tp, root=root,
                   manifest=manifest, port=str(root / "port"),
                   jax=str(root / "jax"))
    finally:
        hparams.__dict__.clear()
        hparams.__dict__.update(saved)


def _close_peak(a, b, rtol):
    b = np.asarray(b, np.float32)
    np.testing.assert_allclose(np.asarray(a, np.float32), b,
                               atol=rtol * float(np.abs(b).max()))


def _wav(seed, *shape):
    return (np.random.RandomState(seed).randn(*shape) * 0.1).astype(
        np.float32)


def _padded(wav, bucket):
    out = np.zeros((1, bucket), np.float32)
    out[0, :wav.shape[-1]] = wav
    return out


@pytest.mark.parametrize("n", [3000, 8192])
def test_torch_bundle_matches_jax_bundle(toy, n):
    """A 3000-sample and an 8192-sample request through the port's bundle
    and JAX's: equal within 1e-4 of the peak; and within 1e-6 of the
    port's live ``separate_wav`` on the request padded to its bucket."""
    bundle = serve.load_separator(toy["port"])
    assert isinstance(bundle, serve.SeparatorBundle)
    assert bundle.lengths == LENGTHS
    assert toy["manifest"]["format"] == "danet-tpu-torch-serve-v1"
    assert toy["manifest"]["platforms"] == ["cpu"]
    wav = _wav(n, n)
    got = bundle.separate(wav)
    want = jserve.load_separator(toy["jax"]).separate(wav)
    assert got.shape == want.shape == (2, n)
    assert np.isfinite(got).all()
    _close_peak(got, want, SEP_RTOL)
    bucket = 4096 if n <= 4096 else 8192
    with torch.no_grad():
        live = toy["tm"].separate_wav(toy["tp"], torch.from_numpy(
            _padded(wav, bucket)))[0, :, :n].numpy()
    np.testing.assert_allclose(got, live, atol=1e-6, rtol=0)


def test_torch_bundle_bucket_errors(toy):
    """(test_serve.py:77) a request above the largest bucket and one of
    another batch raise JAX's errors; a rank-2 request of the exported
    batch keeps its batch axis."""
    bundle = serve.load_separator(toy["port"])
    with pytest.raises(ValueError, match="exceeds the largest"):
        bundle.separate(np.zeros(10000, np.float32))
    with pytest.raises(ValueError, match="batch=1"):
        bundle.separate(np.zeros((2, 1000), np.float32))
    out = bundle.separate(np.zeros((1, 1000), np.float32))
    assert out.shape == (1, 2, 1000)


def test_torch_bundle_refuses_other_formats(toy, tmp_path):
    """(test_serve.py:93) a manifest of another format, a JAX artifact
    included, is refused, by the stream loader too."""
    with pytest.raises(ValueError, match="not a danet-tpu serving"):
        serve.load_separator(toy["jax"])
    os.makedirs(tmp_path / "bad")
    with open(tmp_path / "bad" / "manifest.json", "w") as f:
        json.dump({"format": "something-else"}, f)
    with pytest.raises(ValueError, match="not a danet-tpu serving"):
        serve.load_separator(str(tmp_path / "bad"))
    with pytest.raises(ValueError, match="not a danet-tpu streaming"):
        serve.load_streamer(toy["port"])


def test_torch_export_leaves_hparams_as_they_were(toy, tmp_path):
    """(test_serve.py:55) exporting changes neither the caller's hparams
    nor its model."""
    tm = toy["tm"]
    before = dict(tm.hp.__dict__)
    serve.export_separator(tm, toy["tp"], str(tmp_path / "a"), [4096],
                           device="cpu")
    after = dict(tm.hp.__dict__)
    assert sorted(before) == sorted(after)
    for k, v in before.items():
        assert after[k] is v or np.array_equal(after[k], v), k


def test_torch_bundle_bf16_weights(toy, tmp_path):
    """(test_serve.py:322) bfloat16 weights: an artifact under 0.75 of the
    float32 one, finite, within 5e-2 of the float32 bundle; an integer
    dtype raises."""
    d16 = str(tmp_path / "bf16")
    m = serve.export_separator(toy["tm"], toy["tp"], d16, [4096],
                               device="cpu", weights_dtype="bfloat16")
    assert m["weights_dtype"] == "bfloat16"
    s32 = os.path.getsize(os.path.join(toy["port"], "sep_4096.pt2"))
    s16 = os.path.getsize(os.path.join(d16, "sep_4096.pt2"))
    assert s16 < 0.75 * s32, (s16, s32)
    wav = _wav(1, 4096)
    got16 = serve.load_separator(d16).separate(wav)
    got32 = serve.load_separator(toy["port"]).separate(wav)
    assert np.isfinite(got16).all()
    np.testing.assert_allclose(got16, got32, atol=5e-2)
    with pytest.raises(ValueError, match="float dtype"):
        serve.export_separator(toy["tm"], toy["tp"], str(tmp_path / "bad"),
                               [4096], device="cpu", weights_dtype="int8")


def test_torch_bundle_loads_without_model_code(toy, tmp_path):
    """A fresh interpreter loads the bundle and answers a request with
    neither the port's models nor its hparams nor jax imported, and gives
    this process's answer bit for bit."""
    wav = _wav(7, 5000)
    np.save(str(tmp_path / "wav.npy"), wav)
    code = (
        "import sys, numpy as np\n"
        "from danet_tpu_torch.serve import load_separator\n"
        "b = load_separator(sys.argv[1])\n"
        "np.save(sys.argv[3], b.separate(np.load(sys.argv[2])))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'danet_tpu') or m.startswith('danet_tpu_torch.models') "
        "or m == 'danet_tpu_torch.hparams']\n"
        "assert not bad, bad\n")
    out = str(tmp_path / "out.npy")
    proc = subprocess.run(
        [sys.executable, "-c", code, toy["port"], str(tmp_path / "wav.npy"),
         out], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_array_equal(
        np.load(out), serve.load_separator(toy["port"]).separate(wav))


@pytest.mark.parametrize("keys", [
    dict(ENCODER_TYPE="attn-v1", ATTN_DIM=32, ATTN_HEADS=2, ATTN_LAYERS=1),
    dict(ENCODER_TYPE="toy", INFER_ESTIMATOR_METHOD="kmeans")],
    ids=["attn-v1", "kmeans"])
def test_torch_bundle_matches_jax_live(fresh_hparams, tmp_path, keys):
    """(test_serve.py:145,169) attn-v1 and the kmeans inference estimator:
    the port's bundle against JAX's live ``separate_wav`` of the padded
    wave, 1e-4 of the peak."""
    jm, jp, tm, tp = _jax_pair(keys)
    man = serve.export_separator(tm, tp, str(tmp_path), [4096], device="cpu")
    assert man["infer_estimator"] == keys.get("INFER_ESTIMATOR_METHOD",
                                              "anchor")
    wav = _wav(0, 4000)
    got = serve.load_separator(str(tmp_path)).separate(wav)
    want = np.asarray(jax.jit(lambda w: jm.separate_wav(jp, w))(
        jnp.asarray(_padded(wav, 4096))))[0, :, :4000]
    _close_peak(got, want, SEP_RTOL)


def test_torch_load_separator_keeps_the_live_form(toy, tmp_path):
    """``load_separator`` of weights (no manifest) is the live
    ``Separator``, as before bundles; its answer equals the bundle's on a
    request of a bucket's length, 1e-6."""
    path = str(tmp_path / "w.npz")
    weights.save_npz(path, toy["tp"])
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"ENCODER_TYPE": "toy"}))
    live = serve.load_separator(path, [str(cfg)], device="cpu")
    assert isinstance(live, serve.Separator)
    wav = _wav(3, 4096)
    np.testing.assert_allclose(
        live.separate(wav), serve.load_separator(toy["port"]).separate(wav),
        atol=1e-6, rtol=0)


def _int16(out):
    """The int16 samples the CLI writes for ``out`` (one scale for all
    stems)."""
    scale = max(float(np.max(np.abs(out))), 1.0)
    return (np.clip(out / scale, -1.0, 1.0) * 32767.0).astype(np.int16)


def _read(path):
    return scipy.io.wavfile.read(path)[1].astype(np.int32)


def test_torch_serve_cli_export_and_run(toy, tmp_path):
    """``serve export`` then ``run -d`` on the CPU: the manifest the CLI
    prints, and WAVs within one int16 step of the bundle's result."""
    path = str(tmp_path / "w.npz")
    weights.save_npz(path, toy["tp"])
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"ENCODER_TYPE": "toy"}))
    out_dir = str(tmp_path / "bundle")
    serve._main(["export", "-c", str(cfg), "-i", path, "-o", out_dir,
                 "--lengths", "8192,4096", "--device", "cpu"])
    with open(os.path.join(out_dir, "manifest.json")) as f:
        assert json.load(f)["lengths"] == LENGTHS
    wav = _wav(11, 5000) * 3
    wav_path = str(tmp_path / "mix.wav")
    audio.save_wav_raw(wav_path, wav, 8000)
    prefix = str(tmp_path / "sep")
    serve._main(["run", "-d", out_dir, "-if", wav_path, "-o", prefix])
    want = _int16(serve.load_separator(out_dir).separate(
        audio.load_wav_raw(wav_path, 8000)))
    for i in range(2):
        got = _read("%s_%d.wav" % (prefix, i))
        assert got.shape == (5000,)
        assert np.abs(got - want[i]).max() <= 1


def test_torch_serve_cli_export_stream_and_run_stream(tmp_path):
    """``serve export-stream`` then ``run-stream`` on the CPU (a causal
    tcn-v1): the stream's padding to whole chunks, the trim to len(wav) +
    latency and one scale for all stems; WAVs within one int16 step of the
    bundle fed by hand."""
    keys = dict(ENCODER_TYPE="tcn-v1", TCN_CAUSAL=True, TCN_DIM=16,
                TCN_HIDDEN=24, TCN_BLOCKS=2, TCN_REPEATS=1)
    hp = load_config(**keys)
    model = hp.get_model()(hp)
    path = str(tmp_path / "w.npz")
    weights.save_npz(path, model.init(torch.Generator().manual_seed(4)))
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(keys))
    out_dir = str(tmp_path / "stream")
    serve._main(["export-stream", "-c", str(cfg), "-i", path, "-o", out_dir,
                 "--chunk", "256", "--warmup", "512", "--device", "cpu"])
    wav = _wav(12, 1300) * 3
    wav_path = str(tmp_path / "mix.wav")
    audio.save_wav_raw(wav_path, wav, 8000)
    prefix = str(tmp_path / "sep")
    serve._main(["run-stream", "-d", out_dir, "-if", wav_path, "-o",
                 prefix])
    bundle = serve.load_streamer(out_dir)
    assert bundle.latency_samples == 192
    x = np.zeros(512 + 4 * 256, np.float32)       # 1300 -> 4 whole chunks
    x[:1300] = audio.load_wav_raw(wav_path, 8000)
    parts = [bundle.start(x[:512])] + [
        bundle.feed(x[lo:lo + 256]) for lo in range(512, len(x), 256)]
    want = _int16(np.concatenate(parts, -1)[0][:, :1300 + 192])
    for i in range(2):
        got = _read("%s_%d.wav" % (prefix, i))
        assert got.shape == (1492,)
        assert np.abs(got - want[i]).max() <= 1
