"""PyTorch port, the command line ``python -m danet_tpu_torch``
(``danet_tpu_torch/__main__.py``), the counterpart of ``main.py``: its
modes on the toy dataset with ``--device cpu`` as ``tests/test_cli.py``
drives ``main.py`` (each test names its JAX counterpart), run in this
process (``main(argv)``) in a temporary directory; the debug mode's
fetches against the JAX package's on the same weights and input (1e-5);
``apply_overrides`` as ``tests/test_hparams.py`` holds JAX's.
"""
import json
import os
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import danet_tpu.models.encoders as jenc  # noqa: E402
import danet_tpu_torch.models.encoders as tenc  # noqa: E402
from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
from danet_tpu_torch import __main__ as cli  # noqa: E402
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.hparams import apply_overrides, load_config  # noqa
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402
from danet_tpu_torch.train import checkpoint as ckpt  # noqa: E402

BASE = ["-ds", "toy", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and the test workers share the cores (a pool per worker oversubscribes
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cwd, args, capsys):
    """main(args) with ``cwd`` as the working directory; -> stdout."""
    here = os.getcwd()
    os.chdir(cwd)
    try:
        capsys.readouterr()
        cli.main(args)
        return capsys.readouterr().out
    finally:
        os.chdir(here)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """One toy training run (-o ckpt) shared by the mode tests."""
    cwd = str(tmp_path_factory.mktemp("cli"))
    with open(os.path.join(cwd, "cfg.json"), "w") as f:
        json.dump({"BATCH_SIZE": 4, "MAX_TRAIN_LEN": 32,
                   "SUMMARY_DIR": os.path.join(cwd, "logs")}, f)
    here = os.getcwd()
    os.chdir(cwd)
    try:
        cli.main(BASE + ["-m", "train", "-ne", "1", "-c", "cfg.json",
                         "-o", "ckpt", "--no-valid-on-epoch",
                         "--no-save-on-epoch"])
    finally:
        os.chdir(here)
    return cwd


def test_torch_cli_train_and_checkpoint(workdir):
    """(test_cli.py:44) -m train -o writes the checkpoint directory; no
    epoch checkpoints under --no-save-on-epoch."""
    assert ckpt.exists(os.path.join(workdir, "ckpt"))
    assert not os.path.exists(os.path.join(workdir, "saves"))
    state = ckpt.load_checkpoint(os.path.join(workdir, "ckpt"),
                                 cli.g_state)
    assert state["epoch"] == 1 and state["step"] == 10


@pytest.mark.parametrize("mode,name", [("test", "Test"),
                                       ("valid", "Valid")])
def test_torch_cli_test_mode(workdir, capsys, mode, name):
    """(test_cli.py:48) -m test and -m valid with -i: main.py's lines,
    and the metrics of the restored weights."""
    out = _run(workdir, BASE + ["-m", mode, "-c", "cfg.json", "-i",
                                "ckpt"], capsys)
    lines = out.splitlines()
    assert "Loading parameters from ckpt ... done" in lines
    (line,) = [ln for ln in lines if ln.startswith(name + ": ")]
    kv = dict(p.split("=") for p in line.split()[1:])
    assert sorted(kv) == ["SNR", "loss"]
    assert all(np.isfinite(float(v)) for v in kv.values())


def _read_wav(path):
    import scipy.io.wavfile
    rate, data = scipy.io.wavfile.read(path)
    return rate, data


def test_torch_cli_demo_mode_writes_separated_wavs(workdir, capsys):
    """(test_cli.py:55) -m demo: BATCH_SIZE 1 with main.py's warning, the
    mixture to demo.wav, the N separated sources to demo_separated_<i>.wav,
    the no-display warning; then -if a WAV of our own."""
    env = os.environ.pop("DISPLAY", None)
    try:
        out = _run(workdir, BASE + ["-m", "demo", "-c", "cfg.json", "-i",
                                    "ckpt"], capsys)
        assert ('  Warning: setting hparams.BATCH_SIZE to 1 for "demo" '
                'mode') in out
        assert "Mixture written to demo.wav" in out
        assert "Warning: no display found, not generating plot" in out
        seps = sorted(f for f in os.listdir(workdir) if "_separated_" in f)
        assert seps == ["demo_separated_1.wav", "demo_separated_2.wav"]
        rate, mix = _read_wav(os.path.join(workdir, "demo.wav"))
        _, sep = _read_wav(os.path.join(workdir, seps[0]))
        assert rate == 8000 and sep.shape == mix.shape
        assert np.isfinite(sep).all()
        # a 16-bit WAV of our own at another rate, resampled on load
        tone = (np.sin(np.arange(11025) * 0.05) * 8000).astype(np.int16)
        with wave.open(os.path.join(workdir, "mine.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(11025)
            w.writeframes(tone.tobytes())
        out = _run(workdir, BASE + ["-m", "demo", "-c", "cfg.json", "-i",
                                    "ckpt", "-if", "mine.wav"], capsys)
        for i in (1, 2):
            assert "Separated source written to mine_separated_%d.wav" % i \
                in out
            assert os.path.exists(os.path.join(workdir,
                                               "mine_separated_%d.wav" % i))
    finally:
        if env is not None:
            os.environ["DISPLAY"] = env


def _write_mixture(path, seconds=1.5):
    """A 16-bit WAV at 8 kHz: two gliding harmonic tones and noise, at
    int16 scale (the demo keeps the file's sample scale)."""
    rs = np.random.RandomState(5)
    t = np.arange(int(8000 * seconds)) / 8000.0
    x = sum(np.sin(2 * np.pi * f * (1 + 0.05 * t) * t * k) / k
            for f in (140.0, 230.0) for k in (1, 2, 3))
    x = 3000.0 * x + 200.0 * rs.randn(len(t))
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(np.clip(x, -32768, 32767).astype(np.int16).tobytes())


def _fill(template, tree):
    """JAX's parameter tree ``template`` with the leaves of ``tree`` (a
    checkpoint's numpy tree, which drops empty components)."""
    return {k: _fill(v, tree.get(k, {})) if isinstance(v, dict)
            else jnp.asarray(tree[k]) for k, v in template.items()}


@pytest.mark.parametrize("args", [["--stream", "--stream-chunk", "16",
                                   "--stream-warmup", "32"],
                                  ["--set", "DEMO_CHUNK_FRAMES=48"]])
def test_torch_cli_demo_stream_mode(workdir, capsys, fresh_hparams,
                                    monkeypatch, tmp_path, args):
    """(test_cli.py:64) -m demo --stream (lstm-orig, 2 layers of 8 units,
    trained one toy epoch here: a causal encoder) and -m demo with
    DEMO_CHUNK_FRAMES 48 (the shared toy run; DEMO_OVERLAP_FRAMES 32) on a
    1.5 s WAV of our own (188 frames): the separated WAVs within one int16
    step of JAX's main.py demo path (``separate_stream`` /
    ``separate_long`` on the same checkpoint's weights and WAV, then
    JAX's ``save_wavfile``)."""
    from danet_tpu.data import audio as jaudio
    stream = args[0] == "--stream"
    keys = {"BATCH_SIZE": 4, "MAX_TRAIN_LEN": 32}
    cwd = workdir
    if stream:
        for cls in (jenc.LstmEncoder, tenc.LstmEncoder):
            monkeypatch.setattr(cls, "HDIM", 8)
            monkeypatch.setattr(cls, "N_LAYERS", 2)
        keys["ENCODER_TYPE"] = "lstm-orig"
        cwd = str(tmp_path)
        with open(os.path.join(cwd, "cfg.json"), "w") as f:
            json.dump(dict(keys, SUMMARY_DIR=os.path.join(cwd, "logs")), f)
        _run(cwd, BASE + ["-m", "train", "-ne", "1", "-c", "cfg.json", "-o",
                          "ckpt", "--no-valid-on-epoch",
                          "--no-save-on-epoch"], capsys)
    name = "stream" if stream else "long"
    _write_mixture(os.path.join(cwd, name + ".wav"))
    env = os.environ.pop("DISPLAY", None)
    try:
        out = _run(cwd, BASE + ["-m", "demo", "-c", "cfg.json", "-i", "ckpt",
                                "-if", name + ".wav"] + args, capsys)
    finally:
        if env is not None:
            os.environ["DISPLAY"] = env
    for i in (1, 2):
        assert "Separated source written to %s_separated_%d.wav" % (
            name, i) in out

    # JAX's main.py demo on the same weights and WAV
    hp = fresh_hparams
    hp.load(dict(keys, DEMO_CHUNK_FRAMES=0 if stream else 48))
    hp.digest()
    jm = JaxDaNet()
    tm = TorchDaNet(load_config(**keys))
    tree = ckpt.load_eval_params(os.path.join(cwd, "ckpt"), tm.init(
        torch.Generator()))
    jp = _fill(jax.device_get(jm.init(jax.random.PRNGKey(0))), tree)
    raw = jaudio.load_wavfile(os.path.join(cwd, name + ".wav"))
    pad = (-len(raw)) % hp.LENGTH_ALIGN
    if pad:
        raw = np.pad(raw, [(0, pad), (0, 0)])
    mix_ri = jnp.asarray(jaudio.to_ri(raw[None])[0])
    assert mix_ri.shape[0] > 48
    sep = (jm.separate_stream(jp, mix_ri, 16, 32) if stream
           else jm.separate_long(jp, mix_ri, 48, hp.DEMO_OVERLAP_FRAMES))
    for i, s in enumerate(jaudio.from_ri(np.asarray(sep))):
        ref_path = str(tmp_path / ("jax_%d.wav" % (i + 1)))
        jaudio.save_wavfile(ref_path, s)
        rate, got = _read_wav(os.path.join(cwd, "%s_separated_%d.wav"
                                           % (name, i + 1)))
        _, want = _read_wav(ref_path)
        assert rate == 8000 and got.shape == want.shape
        assert np.abs(want).max() > 10.0
        np.testing.assert_allclose(got, want, atol=1.0, rtol=0)


def _jax_debug(model, params, src_ri):
    """main.py's debug_fetch (its DaNet branch) on the JAX package."""
    from danet_tpu.models.danet import mixture_features
    _, src_pwr, mix_pwr, logmag, phase_unit = mixture_features(
        src_ri, model.hp.EPS)
    embed, fetches = model.encoder.apply_debug(params["encoder"], logmag)
    attrs = model.train_estimator.apply(params["train_estimator"], embed,
                                        src_pwr=src_pwr, mix_pwr=mix_pwr)
    masks = model.separator.apply(
        params["separator"], mix_pwr, attrs,
        embed.reshape(embed.shape[0], -1, embed.shape[-1]))
    return dict(embed=embed, attrs=attrs, masks=masks,
                output=masks[..., None] * phase_unit[:, None], **fetches)


@pytest.mark.parametrize("encoder,taps", [
    ("toy", ["mid_act"]), ("bilstm-orig", ["lstm0_h", "lstm1_h"]),
    ("lstm-orig", ["lstm0_h", "lstm1_h"]), ("gru-v1", ["gru0_h", "gru1_h"]),
    ("attn-v1", ["block0_h"])])
def test_torch_debug_fetches_match_jax(fresh_hparams, monkeypatch, encoder,
                                       taps):
    """(test_cli.py:81,94) The debug mode's fetches, the encoder's taps
    (``Encoder.apply_debug``) included, have JAX's names and shapes and
    agree with JAX's on the same weights and batch to 1e-5."""
    keys = dict(ENCODER_TYPE=encoder, LSTM_BACKEND="xla", ATTN_DIM=16,
                ATTN_HEADS=2, ATTN_LAYERS=1)
    for pair in ((jenc.BiLstmEncoder, tenc.BiLstmEncoder),
                 (jenc.LstmEncoder, tenc.LstmEncoder),
                 (jenc.GruEncoder, tenc.GruEncoder)):
        for cls in pair:
            monkeypatch.setattr(cls, "HDIM", 6)
            monkeypatch.setattr(cls, "N_LAYERS", 2)
    fresh_hparams.load(keys)
    fresh_hparams.digest()
    jm = JaxDaNet()
    jp = jm.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    src = (rs.randn(1, 2, 12, 129, 2) * 0.5).astype(np.float32)
    want = jax.jit(lambda p, x: _jax_debug(jm, p, x))(jp, jnp.asarray(src))
    hp = load_config(**keys)
    got = cli.debug_fetch(TorchDaNet(hp), weights.from_jax(
        jax.device_get(jp)), torch.from_numpy(src))
    assert sorted(got) == sorted(want) == sorted(
        ["embed", "attrs", "masks", "output"] + taps)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_torch_cli_debug_mode_writes_mat(workdir, capsys):
    """(test_cli.py:81) -m debug writes debug/debug_data.mat with
    main.py's keys: the input and the shared tail, and the toy encoder's
    tap."""
    import scipy.io
    out = _run(workdir, BASE + ["-m", "debug", "-c", "cfg.json", "-i",
                                "ckpt"], capsys)
    assert "Debug data written to debug/debug_data.mat" in out
    mat = scipy.io.loadmat(os.path.join(workdir, "debug/debug_data.mat"))
    keys = sorted(k for k in mat if not k.startswith("__"))
    assert keys == sorted(["input", "embed", "attrs", "masks", "output",
                           "mid_act"])
    n, t, f, _ = mat["input"].shape
    assert (n, f) == (2, 129)
    assert mat["embed"].shape == (1, t, f, 20)
    assert mat["attrs"].shape == (1, n, 20)
    assert mat["masks"].shape == (1, n, t, f)
    assert mat["output"].shape == (1, n, t, f, 2)
    assert mat["mid_act"].shape == (1, t, 512)


def test_torch_cli_interactive_mode(workdir, capsys):
    """(test_cli.py:106) -m interactive builds everything and returns,
    leaving the module's globals set."""
    out = _run(workdir, BASE + ["-m", "interactive", "-c", "cfg.json"],
               capsys)
    assert "Now in interactive mode, you should run this with python -i" \
        in out
    assert cli.g_state["step"] == 0 and cli.g_dataset is not None


def test_torch_cli_rejects_unknown_mode(workdir, capsys):
    """(test_cli.py:113)"""
    with pytest.raises(ValueError, match='Unknown mode "bogus"'):
        _run(workdir, BASE + ["-m", "bogus", "-c", "cfg.json"], capsys)


def test_torch_apply_overrides(capsys):
    """(test_hparams.py:75) --set: JSON-typed values, a missing '='
    rejected, the key pattern enforced, a warning for an unknown key."""
    hp = load_config()
    apply_overrides(hp, ["TCN_BLOCKS=5", "TCN_CAUSAL=true",
                         "SUMMARY_TITLE=plain string"])
    assert hp.TCN_BLOCKS == 5 and hp.TCN_CAUSAL is True
    assert hp.SUMMARY_TITLE == "plain string"
    with pytest.raises(ValueError, match="KEY=VALUE"):
        apply_overrides(hp, ["TCN_BLOCKS"])
    with pytest.raises(NameError):
        apply_overrides(hp, ["tcn_blocks=5"])
    capsys.readouterr()
    apply_overrides(hp, ["TCN_BLOCK=5"])
    assert "TCN_BLOCK" in capsys.readouterr().err
