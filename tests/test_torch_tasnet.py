"""PyTorch port, ``MODEL_TYPE='tasnet-v1'`` (``danet_tpu_torch/models/
tasnet.py``) against the JAX package's ``danet_tpu/models/tasnet.py`` on
the CPU, with the same weights (carried by ``danet_tpu_torch.weights``)
and the same numpy inputs.

Narrow widths as ``tests/test_tasnet.py`` has them (TASNET_FILTERS 64,
BOTTLENECK 32, HIDDEN 48, 3 x 2 blocks).  Tolerances: the framing and the
overlap-add exactly (the port sums each sample's frames in ascending
order, as JAX's scatter-add on the CPU); the raw forward
(``_separate_wav_padded``) to 1e-6 of its output's peak and
``separate_wav`` to 1e-4 of it (``chip_smoke.py``'s SERVE_RTOL), float32
sums in another order; ``train_loss``, its gradients, the metrics and one
Adam step to 2e-5 atol / 1e-4 rtol, the JAX kernel tests' gradient bar,
the gradients' atol scaled by each tensor's peak when above 1: the
iSTFT of a batch leaves its last FFT_STRIDE samples zero, whose
all-zero frames meet the layer norms at zero variance (rsqrt(1e-6) per
norm, in both packages), so that the biases' gradients reach 1e13 and
2e-5 flat lies far below a float32 ulp there; the debug taps to 1e-5 of
each tap's peak.
"""
import json
import os

import numpy as np
import pytest
import scipy.io
import scipy.io.wavfile

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from danet_tpu import optim as joptim  # noqa: E402
from danet_tpu.models import TasNet as JaxTasNet  # noqa: E402
from danet_tpu.models import tasnet as jtasnet  # noqa: E402
from danet_tpu_torch import __main__ as cli  # noqa: E402
from danet_tpu_torch import serve, weights  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import TasNet  # noqa: E402
from danet_tpu_torch.models import tasnet as ttasnet  # noqa: E402
from danet_tpu_torch.ops import dsp  # noqa: E402
from danet_tpu_torch.train import Trainer  # noqa: E402

TINY = dict(MODEL_TYPE="tasnet-v1", BATCH_SIZE=2, TASNET_FILTERS=64,
            TASNET_BOTTLENECK=32, TASNET_HIDDEN=48, TASNET_BLOCKS=3,
            TASNET_REPEATS=2)
GRAD = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(hp_jax, **keys):
    """(jax model, jax params, port model, port params) from default.json +
    TINY + ``keys``, the port's weights carried from JAX's."""
    keys = dict(TINY, **keys)
    hp_jax.load(keys)
    hp_jax.digest()
    jm = JaxTasNet()
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TasNet(load_config(**keys))
    return jm, jp, tm, weights.from_jax(jax.device_get(jp))


def _src_ri(seed, b=2, n=2, t=24, f=129):
    rs = np.random.RandomState(seed)
    z = rs.randn(b, n, t, f) + 1j * rs.randn(b, n, t, f)
    return np.stack([z.real, z.imag], -1).astype(np.float32)


def _close(a, b, atol, rtol=0.0, err_msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=rtol, err_msg=err_msg)


def _close_peak(a, b, share):
    """|a - b| within ``share`` of the peak of ``b``."""
    b = np.asarray(b, np.float32)
    _close(a, b, atol=share * float(np.abs(b).max()))


def _close_grad(a, b, name):
    """GRAD's rtol, and its atol scaled by the tensor's peak when above 1
    (module docstring: the biases' gradients reach 1e13)."""
    b = np.asarray(b, np.float32)
    _close(a, b, atol=GRAD["atol"] * max(1.0, float(np.abs(b).max())),
           rtol=GRAD["rtol"], err_msg=name)


@pytest.mark.parametrize("win,stride", [(16, 8), (12, 8), (256, 64),
                                        (5, 2), (8, 8)])
def test_torch_tasnet_frame_and_overlap_add_match_jax(win, stride):
    """``_frame`` and the overlap-add (``dsp.overlap_add``) equal JAX's
    ``_frame`` and ``_overlap_add`` exactly, at a stride
    that divides the window, one that does not (12 / 8, 5 / 2, up to 3
    frames on a sample) and no overlap; with leading axes."""
    rs = np.random.RandomState(win + stride)
    k = 9
    x = rs.randn(2, 3, (k - 1) * stride + win).astype(np.float32)
    frames = ttasnet._frame(torch.from_numpy(x), win, stride)
    want = np.asarray(jtasnet._frame(jnp.asarray(x), win, stride))
    assert tuple(frames.shape) == want.shape == (2, 3, k, win)
    np.testing.assert_array_equal(frames.numpy(), want)
    f = rs.randn(2, 3, k, win).astype(np.float32)
    got = dsp.overlap_add(torch.from_numpy(f), stride).numpy()
    want = np.asarray(jtasnet._overlap_add(jnp.asarray(f), stride))
    assert got.shape == want.shape == (2, 3, (k - 1) * stride + win)
    np.testing.assert_array_equal(got, want)


def test_torch_tasnet_init_layout_and_count(fresh_hparams):
    """The port's init has JAX's tree: the same keys, shapes and
    parameter count."""
    jm, jp, tm, _ = _pair(fresh_hparams)
    mine = tm.init(torch.Generator().manual_seed(0))
    ref = jax.device_get(jp)
    shapes = {n: tuple(v.shape) for n, v in zip(weights.leaf_names(mine),
                                                 weights.leaves(mine))}
    assert shapes == {n: tuple(v.shape) for n, v in zip(
        weights.leaf_names(ref), weights.leaves(ref))}
    assert tm.parameter_count(mine) == jm.parameter_count(jp)


MASKS = [dict(TASNET_MASK="sigmoid"), dict(TASNET_MASK="relu"),
         dict(TASNET_MASK="softmax"), dict(TASNET_CAUSAL=True)]


@pytest.mark.parametrize("keys", MASKS,
                         ids=["sigmoid", "relu", "softmax", "causal"])
def test_torch_tasnet_forward_matches_jax(fresh_hparams, keys):
    """The raw forward to 1e-6 of its peak and ``separate_wav`` (an odd
    length, padded to the stride and trimmed back) to 1e-4, for each
    TASNET_MASK and TASNET_CAUSAL's offline path."""
    jm, jp, tm, tp = _pair(fresh_hparams, **keys)
    rs = np.random.RandomState(1)
    wav = (rs.randn(2, 1001) * 0.5).astype(np.float32)
    padded = np.pad(wav, [(0, 0), (0, tm._pad_len(1001) - 1001)])
    want = np.asarray(jax.jit(jm._separate_wav_padded)(
        jp, jnp.asarray(padded)))
    with torch.no_grad():
        got = tm._separate_wav_padded(tp, torch.from_numpy(padded)).numpy()
        sep = tm.separate_wav(tp, torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 2, 1008 + 8)
    _close_peak(got, want, 1e-6)
    ref = np.asarray(jax.jit(jm.separate_wav)(jp, jnp.asarray(wav)))
    assert sep.shape == ref.shape == (2, 2, 1001)
    _close_peak(sep, ref, 1e-4)


@pytest.mark.parametrize("keys", [{}, dict(REG_APPLY=True),
                                  dict(TASNET_MASK="softmax",
                                       TASNET_CAUSAL=True)],
                         ids=["default", "reg", "softmax-causal"])
def test_torch_tasnet_train_loss_and_grads_match_jax(fresh_hparams, keys):
    """``train_loss`` (uPIT negative SI-SNR), its SNR and permutations,
    and the gradient of every parameter against JAX's
    value_and_grad(train_loss)."""
    jm, jp, tm, tp = _pair(fresh_hparams, **keys)
    batch = _src_ri(3)
    (jl, aux), jg = jax.jit(jax.value_and_grad(
        lambda p, x: jm.train_loss(p, x, None), has_aux=True))(
            jp, jnp.asarray(batch))
    for p in weights.leaves(tp):
        p.requires_grad_(True)
    loss, taux = tm.train_loss(tp, torch.from_numpy(batch))
    grads = torch.autograd.grad(loss, weights.leaves(tp))
    _close(loss.detach(), jl, **GRAD)
    _close(taux["snr"].detach(), aux["snr"], **GRAD)
    np.testing.assert_array_equal(taux["perm_idx"].numpy(),
                                  np.asarray(aux["perm_idx"]))
    names = weights.leaf_names(tp)
    for name, a, b in zip(names, grads, jax.tree_util.tree_leaves(jg)):
        _close_grad(a, b, name)


def test_torch_tasnet_mix_snr_db_matches_jax(fresh_hparams, monkeypatch):
    """MIX_SNR_DB: the port's draw replaced by JAX's (fold_in(rng, 0x5e2),
    uniform in +/- 3 dB), then the loss and gradients against JAX; with a
    generator and DROPOUT_KEEP_PROB 1 the blocks draw nothing else."""
    jm, jp, tm, tp = _pair(fresh_hparams, MIX_SNR_DB=6.0)
    rng = jax.random.PRNGKey(5)
    batch = _src_ri(4)
    db = np.asarray(jax.random.uniform(jax.random.fold_in(rng, 0x5e2),
                                       (2, 2, 1), minval=-3.0, maxval=3.0))
    draw = tm.mix_gain_db((2, 2, 1), 6.0, torch.Generator())
    assert tuple(draw.shape) == db.shape and float(draw.abs().max()) <= 3.0
    monkeypatch.setattr(tm, "mix_gain_db", lambda *a: torch.tensor(db))
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.train_loss, has_aux=True))(
        jp, jnp.asarray(batch), rng)
    for p in weights.leaves(tp):
        p.requires_grad_(True)
    loss, _ = tm.train_loss(tp, torch.from_numpy(batch), torch.Generator())
    grads = torch.autograd.grad(loss, weights.leaves(tp))
    _close(loss.detach(), jl, **GRAD)
    for name, a, b in zip(weights.leaf_names(tp), grads,
                          jax.tree_util.tree_leaves(jg)):
        _close_grad(a, b, name)


def test_torch_tasnet_valid_metrics_match_jax(fresh_hparams):
    """``valid_metrics`` with EVAL_SI_SNR and EVAL_SDR (16 taps): loss,
    SNR, SI_SNR, SDR, SIR and SAR."""
    jm, jp, tm, tp = _pair(fresh_hparams, EVAL_SI_SNR=True, EVAL_SDR=True,
                           BSS_FILT_LEN=16)
    batch = _src_ri(5)
    want = jax.jit(jm.valid_metrics)(jp, jnp.asarray(batch))
    with torch.no_grad():
        got = tm.valid_metrics(tp, torch.from_numpy(batch))
    assert sorted(got) == sorted(want) == ["SAR", "SDR", "SIR", "SI_SNR",
                                           "SNR", "loss"]
    for k in want:
        _close(got[k], want[k], err_msg=k, **GRAD)


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_torch_tasnet_separate_spectra_matches_jax(fresh_hparams, backend):
    """``separate`` (ri spectra in and out: iSTFT, the forward, the STFT by
    STFT_BACKEND) to 1e-4 of the peak."""
    jm, jp, tm, tp = _pair(fresh_hparams, STFT_BACKEND=backend)
    mix = _src_ri(6).sum(axis=1)
    want = np.asarray(jax.jit(jm.separate)(jp, jnp.asarray(mix)))
    with torch.no_grad():
        got = tm.separate(tp, torch.from_numpy(mix)).numpy()
    assert got.shape == want.shape == (2, 2, 24, 129, 2)
    _close_peak(got, want, 1e-4)


def test_torch_tasnet_trainer_step_matches_jax(fresh_hparams):
    """One Trainer step (Adam with the value clip) against
    value_and_grad(train_loss) + danet_tpu.optim: the loss, the SNR and
    every parameter after the update."""
    jm, jp, tm, _ = _pair(fresh_hparams)
    batch = _src_ri(7)
    (jl, aux), g = jax.jit(jax.value_and_grad(
        lambda p, x: jm.train_loss(p, x, None), has_aux=True))(
            jp, jnp.asarray(batch))
    opt = joptim.make_optimizer(fresh_hparams)
    upd, _ = opt.update(g, opt.init(jp), jp)
    jparams = optax.apply_updates(jp, upd)
    trainer = Trainer(tm, tm.hp, "cpu")
    state = trainer.init_state(params=jax.device_get(jp))
    m = trainer.train_step(state, batch)
    _close(m["loss"], jl, **GRAD)
    _close(m["SNR"], aux["snr"], **GRAD)
    for name, a, b in zip(weights.leaf_names(state["params"]),
                          weights.leaves(weights.to_jax(state["params"])),
                          jax.tree_util.tree_leaves(jparams)):
        _close(a, b, err_msg=name, **GRAD)


def _jax_debug(jm, params, src_ri):
    """main.py's waveform branch of the debug mode (main.py:194-208)."""
    fetches = {}
    wav_src = jm._src_wavs(src_ri)
    mix = jnp.sum(wav_src, axis=1)
    padded = jm._pad_len(mix.shape[-1])
    mix_p = jnp.pad(mix, [(0, 0), (0, padded - mix.shape[-1])])
    sep = jm._separate_wav_padded(
        params, mix_p, tap=lambda k, v: fetches.__setitem__(k, v))
    return dict(fetches, mixture=mix, output=sep)


def test_torch_tasnet_debug_taps_match_jax(fresh_hparams):
    """The CLI's debug fetches of a waveform model
    (``debug_fetch_wave``): main.py's names and shapes, each within 1e-5
    of its peak of JAX's."""
    jm, jp, tm, tp = _pair(fresh_hparams)
    src = _src_ri(8, b=1)
    want = jax.jit(lambda p, x: _jax_debug(jm, p, x))(jp, jnp.asarray(src))
    got = cli.debug_fetch_wave(tm, tp, torch.from_numpy(src))
    assert sorted(got) == sorted(want) == sorted(
        ["basis_feats", "masks", "mixture", "output"]
        + ["block%d_h" % i for i in range(6)])
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        _close(got[k], want[k], err_msg=k,
               atol=1e-5 * max(1.0, float(jnp.max(jnp.abs(want[k])))))


@pytest.mark.parametrize("key,value,err", [
    ("MESH_MODEL", 2, ValueError), ("MESH_PIPE", 2, ValueError),
    ("MESH_EXPERT", 2, ValueError), ("MESH_DATA", 2, NotImplementedError),
    ("MESH_SEQ", 2, NotImplementedError)])
def test_torch_tasnet_refuses_mesh_axes(fresh_hparams, key, value, err):
    """MESH_MODEL, MESH_PIPE and MESH_EXPERT > 1 raise JAX's ValueError
    word for word; MESH_DATA and MESH_SEQ, which JAX routes, are not
    ported (NotImplementedError)."""
    hp = load_config(**dict(TINY, **{key: value}))
    with pytest.raises(err) as got:
        TasNet(hp)
    if err is ValueError:
        fresh_hparams.load({key: value})
        with pytest.raises(ValueError) as want:
            JaxTasNet()
        assert str(got.value) == str(want.value)
    else:
        assert "queue 1 item 6" in str(got.value)


def test_torch_tasnet_refuses_unknown_mask():
    hp = load_config(**dict(TINY, TASNET_MASK="tanh"))
    with pytest.raises(ValueError, match="TASNET_MASK"):
        Trainer(TasNet(hp), hp, "cpu")


def _set_args(keys: dict) -> list:
    out = []
    for k, v in keys.items():
        out += ["--set", "%s=%s" % (k, json.dumps(v))]
    return out


def test_torch_tasnet_cli_train_debug_test_and_serve(tmp_path, capsys):
    """``python -m danet_tpu_torch`` with MODEL_TYPE tasnet-v1 on the toy
    data: train (-o), -m test and -m debug from the checkpoint (the .mat
    holds main.py's waveform keys), and ``serve run`` from the same
    checkpoint on a WAV: one separated WAV per source, the request's
    length, and equal to serve.Separator's answer."""
    keys = dict(TINY, MAX_TRAIN_LEN=16, SUMMARY_DIR=str(tmp_path / "logs"))
    base = ["-ds", "toy", "--device", "cpu"] + _set_args(keys)
    here = os.getcwd()
    os.chdir(tmp_path)
    try:
        cli.main(base + ["-m", "train", "-ne", "1", "-o", "ckpt",
                         "--no-valid-on-epoch", "--no-save-on-epoch"])
        out = capsys.readouterr().out
        assert "Epoch 1/1" in out and "nan" not in out.lower()
        cli.main(base + ["-m", "test", "-i", "ckpt"])
        out = capsys.readouterr().out
        assert "Test: " in out and "nan" not in out.lower()
        cli.main(base + ["-m", "debug", "-i", "ckpt"])
        assert "Debug data written" in capsys.readouterr().out
        mat = scipy.io.loadmat("debug/debug_data.mat")
        assert sorted(k for k in mat if not k.startswith("__")) == sorted(
            ["input", "mixture", "output", "basis_feats", "masks"]
            + ["block%d_h" % i for i in range(6)])
        n, t, f, _ = mat["input"].shape
        assert (n, f) == (2, 129)
        assert mat["mixture"].shape == (1, t * 64)
        assert mat["output"].shape == (1, 2, t * 64 + 8)
        assert mat["masks"].shape == (1, 2, t * 8, 64)

        rs = np.random.RandomState(0)
        wav = (rs.randn(2400) * 3000).astype(np.int16)
        scipy.io.wavfile.write("mix.wav", 8000, wav)
        cfg = tmp_path / "cfg.json"
        cfg.write_text(json.dumps(TINY))
        serve._main(["run", "-c", str(cfg), "-w", "ckpt", "-if", "mix.wav",
                     "-o", "sep", "--device", "cpu"])
        sep = serve.load_separator("ckpt", [str(cfg)], "cpu")
        ref = sep.separate(wav.astype(np.float32) / 32768.0)
        for i in range(2):
            rate, got = scipy.io.wavfile.read("sep_%d.wav" % i)
            assert rate == 8000 and got.shape == (2400,)
        assert ref.shape == (2, 2400) and np.isfinite(ref).all()
    finally:
        os.chdir(here)


def _rows(logs) -> list:
    (run_dir,) = os.listdir(str(logs))
    with open(os.path.join(str(logs), run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in ("t", "train/step_time")}
            for r in rows]


def test_torch_tasnet_cli_trains_from_wav_dir(tmp_path, capsys):
    """tasnet-v1 through the CLI from a folder of int16 WAVs (wav-dir): on
    the int16 wave wire, 2-step calls (PROFILE_STEPS 1: a trace under the
    run directory) give the rows of single steps bit for bit; the spectra
    wire trains too; then -m test from the checkpoint."""
    rs = np.random.RandomState(9)
    (tmp_path / "wavs").mkdir()
    for i in range(24):
        wav = (rs.randn(2000) * 2000).astype(np.int16)
        scipy.io.wavfile.write(str(tmp_path / "wavs" / ("u%02d.wav" % i)),
                               8000, wav)
    wire = dict(TRANSFER_DOMAIN="wave", TRANSFER_DTYPE="int16",
                WAVE_PCM_SCALE=32768.0)
    here = os.getcwd()
    os.chdir(tmp_path)
    try:
        for tag, keys in (("k1", wire),
                          ("k2", dict(wire, TRAIN_STEPS_PER_CALL=2,
                                      PROFILE_STEPS=1)),
                          ("spectra", {})):
            keys = dict(TINY, WAVDIR_PATH=str(tmp_path / "wavs"),
                        SUMMARY_DIR=str(tmp_path / tag), **keys)
            cli.main(["-ds", "wav-dir", "--device", "cpu", "-m", "train",
                      "-ne", "1", "-o", "ckpt_" + tag, "--no-save-on-epoch"]
                     + _set_args(keys))
            out = capsys.readouterr().out
            assert "Epoch 1/1" in out and "nan" not in out.lower(), out
        assert _rows(tmp_path / "k1") == _rows(tmp_path / "k2")
        assert len(_rows(tmp_path / "k1")) == 6      # 5 steps, 1 sweep
        (run_dir,) = os.listdir(str(tmp_path / "k2"))
        assert os.path.exists(tmp_path / "k2" / run_dir / "profile"
                              / "trace.json")
        cli.main(["-ds", "wav-dir", "--device", "cpu", "-m", "test", "-i",
                  "ckpt_k2"] + _set_args(dict(
                      TINY, WAVDIR_PATH=str(tmp_path / "wavs"))))
        out = capsys.readouterr().out
        assert "Test: " in out and "nan" not in out.lower()
    finally:
        os.chdir(here)
