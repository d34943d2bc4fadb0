"""PyTorch port, the trainer's host path: prepare_batch_wave, the wire
casts and ingest, the wire's refusals, TRAIN_STEPS_PER_CALL on the CPU,
METRICS_EVERY and the metric files, PROFILE_STEPS' trace, the prefetch
thread, the hang
watchdog, and the CLI on configs/tpu.json over a wsj0 fixture; against
the JAX package on the CPU where it has a counterpart.

Tolerances: the batch preparation, the casts and the K-step equality bit
for bit (the same numpy code; the same eager ops in the same order); the
ingest's spectra 2e-5 (the STFT's bar: the JAX GEMM against kernel A's
plain version, float32 sums in another order).
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from danet_tpu.ops import dsp as jdsp  # noqa: E402
from danet_tpu.train.trainer import prepare_batch_wave as jax_prepare_wave  # noqa
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.data.dataset import WhiteNoiseData  # noqa: E402
from danet_tpu_torch.data.synth import SyntheticTonesData  # noqa: E402
from danet_tpu_torch.data.synth_speech import SyntheticSpeechData  # noqa
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import DaNet  # noqa: E402
from danet_tpu_torch.ops.dsp import stft_frame_count  # noqa: E402
from danet_tpu_torch.train import trainer as trainer_mod  # noqa: E402
from danet_tpu_torch.train.trainer import (  # noqa: E402
    PinnedStaging, Trainer, prefetch_to_device, prepare_batch_wave)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(BATCH_SIZE=2, SMPRATE=4000, SYNTH_BATCHES=2)


def _trainer(**keys):
    hp = load_config(**dict(TINY, **keys))
    return Trainer(DaNet(hp), hp, "cpu")


# --------------------------------------------------------- batch prep
@pytest.mark.parametrize("n_samples,max_len,bucket", [
    (6000, None, None), (6000, 32, None), (6000, 30, 16), (5001, None, 32),
    (777, 128, 32), (2000, 8, 8)])
def test_torch_prepare_batch_wave_matches_jax(n_samples, max_len, bucket):
    """The crop (the same RandomState draw), the bucket in frames and the
    snap to (t - 1) * stride equal JAX's prepare_batch_wave bit for bit;
    the frame count is the bucketed crop."""
    flat = np.random.RandomState(n_samples).randn(4, n_samples).astype(
        np.float32)
    a = prepare_batch_wave(flat, 2, 2, 256, 64, max_len=max_len,
                           bucket=bucket, rng=np.random.RandomState(1))
    b = jax_prepare_wave(flat, 2, 2, 256, 64, max_len=max_len,
                         bucket=bucket, rng=np.random.RandomState(1))
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    t = stft_frame_count(n_samples, 256, 64)
    if max_len is not None:
        t = min(t, max_len)
    if bucket:
        t += (-t) % bucket
    assert a.shape[-1] == (t - 1) * 64
    assert stft_frame_count(a.shape[-1], 256, 64) == t
    with pytest.raises(ValueError):
        prepare_batch_wave(flat, 2, 2, 256, 64, max_len=4)
    with pytest.raises(ValueError):
        prepare_batch_wave(flat, 3, 2, 256, 64)


# ---------------------------------------------------------- the wire
def _jax_trainer(fresh_hparams, **keys):
    from danet_tpu.models import DaNet as JaxDaNet
    from danet_tpu.parallel import make_mesh
    from danet_tpu.train.trainer import Trainer as JaxTrainer
    fresh_hparams.load(dict(TINY, **keys))
    fresh_hparams.digest()
    return JaxTrainer(JaxDaNet(), name="wire",
                      mesh=make_mesh(1, 1, devices=jax.devices()[:1]))


@pytest.mark.parametrize("dtype,scale", [("bfloat16", 1.0), ("int16", 1.0),
                                         ("int16", 4.0), ("int16", 32768.0)])
def test_torch_wire_casts_match_jax(fresh_hparams, dtype, scale):
    """The host casts equal JAX's _wire_cast bit for bit: bfloat16 by
    round to nearest even (ml_dtypes in JAX, torch here), int16 PCM with
    its clip; for_eval ships the float32 batch unchanged."""
    keys = dict(TRANSFER_DOMAIN="wave", TRANSFER_DTYPE=dtype,
                WAVE_PCM_SCALE=scale)
    jtr = _jax_trainer(fresh_hparams, **keys)
    tr = _trainer(**keys)
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 2, 700) * scale * 0.7).astype(np.float32)
    x[0, 0, :4] = [scale * 3, -scale * 3, scale, -scale]   # clipped peaks
    out, ref = tr.wire_cast(x), jtr._wire_cast(x)
    if dtype == "bfloat16":
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(out.view(torch.int16).numpy(),
                                      ref.view(np.int16))
    else:
        assert out.dtype == torch.int16 and ref.dtype == np.int16
        np.testing.assert_array_equal(out.numpy(), ref)
    ev = tr.wire_cast(x, for_eval=True)
    assert ev.dtype == torch.float32
    np.testing.assert_array_equal(ev.numpy(), x)


def test_torch_int16_wire_exact_for_16bit_material():
    """At WAVE_PCM_SCALE 32768, integer samples cross the int16 wire and
    the dequantisation of ingest exactly."""
    tr = _trainer(TRANSFER_DOMAIN="wave", TRANSFER_DTYPE="int16",
                  WAVE_PCM_SCALE=32768.0, STFT_BACKEND="xla")
    ints = np.random.RandomState(0).randint(
        -32768, 32768, size=(2, 2, 256)).astype(np.float32)
    wire = tr.wire_cast(ints)
    np.testing.assert_array_equal(wire.numpy().astype(np.float32), ints)
    np.testing.assert_array_equal(
        (wire.float() * tr._dequant).numpy(), ints)


@pytest.mark.parametrize("dtype,backend", [
    ("float32", "auto"), ("bfloat16", "auto"), ("int16", "auto"),
    ("int16", "xla"), ("int16", "pallas")])
def test_torch_ingest_matches_jax(fresh_hparams, dtype, backend):
    """The device side of the wave wire (upcast, int16 dequantisation,
    STFT) against JAX's ingest (the same casts, then dsp.stft_ri, its
    GEMM STFT), within 2e-5; eval batches (float32) likewise."""
    keys = dict(TRANSFER_DOMAIN="wave", TRANSFER_DTYPE=dtype,
                WAVE_PCM_SCALE=4.0, STFT_BACKEND=backend)
    jtr = _jax_trainer(fresh_hparams, **keys)
    tr = _trainer(**keys)
    hp = tr.hp
    flat = (np.random.RandomState(3).randn(4, 3000) * 0.8).astype(np.float32)
    batch = prepare_batch_wave(flat, 2, 2, 256, 64, bucket=32)
    for for_eval in (False, True):
        wire = batch if for_eval else jtr._wire_cast(batch)
        x = jnp.asarray(wire).astype(jnp.float32)
        if wire.dtype == np.int16:
            x = x * (4.0 / 32768.0)
        ref = np.asarray(jdsp.stft_ri(x, hp.FFT_SIZE, hp.FFT_STRIDE,
                                      np.asarray(hp.FFT_WND_ARRAY)))
        out = tr.ingest(batch, for_eval=for_eval)
        assert out.dtype == torch.float32
        assert tuple(out.shape) == ref.shape == (2, 2, 64, 129, 2)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-5)


def test_torch_spectra_wire_bfloat16_ingest():
    """On the spectra wire bfloat16 is the upcast of the rounded batch."""
    tr = _trainer(TRANSFER_DTYPE="bfloat16")
    x = np.random.RandomState(0).randn(2, 2, 32, 129, 2).astype(np.float32)
    out = tr.ingest(x)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(
        out.numpy(), torch.from_numpy(x).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(tr.ingest(x, for_eval=True).numpy(), x)


@pytest.mark.parametrize("keys,match", [
    ({"TRANSFER_DOMAIN": "waves"}, "TRANSFER_DOMAIN"),
    ({"TRANSFER_DTYPE": "fp16"}, "TRANSFER_DTYPE"),
    ({"TRANSFER_DTYPE": "int16"}, "int16"),
    ({"TRANSFER_DOMAIN": "wave", "STFT_BACKEND": "fft"}, "STFT_BACKEND")])
def test_torch_wire_config_errors(fresh_hparams, keys, match):
    """The wire's ValueErrors at construction, as JAX raises them (an
    unknown STFT_BACKEND as DaNet.separate_wav raises it)."""
    with pytest.raises(ValueError, match=match):
        _trainer(**keys)
    if "STFT_BACKEND" not in keys:
        with pytest.raises(ValueError, match=match):
            _jax_trainer(fresh_hparams, **keys)


def test_torch_wire_dataset_errors(tmp_path):
    """The wave wire refuses a spectra-only dataset, and the int16 wire a
    WAVE_PCM_SCALE other than the dataset's WAVE_SCALE (train batches
    only: an eval sweep ships float32)."""
    logs = str(tmp_path / "logs")
    tr = _trainer(TRANSFER_DOMAIN="wave", SUMMARY_DIR=logs)
    toy = WhiteNoiseData(tr.hp)
    toy.install_and_load()
    with pytest.raises(ValueError, match="wave-capable"):
        tr.train(1, toy, valid_on_epoch=False)
    tr = _trainer(TRANSFER_DOMAIN="wave", TRANSFER_DTYPE="int16",
                  SUMMARY_DIR=logs)
    ds = SyntheticSpeechData(tr.hp)
    ds.install_and_load()
    with pytest.raises(ValueError, match="WAVE_PCM_SCALE"):
        tr.train(1, ds, valid_on_epoch=False)
    assert tr._epoch_fn(ds, for_eval=True) == ds.epoch_wave
    tr = _trainer(TRANSFER_DOMAIN="wave", TRANSFER_DTYPE="int16",
                  WAVE_PCM_SCALE=4.0)
    assert tr._epoch_fn(ds) == ds.epoch_wave


# ----------------------------------------------------- K steps per call
class VaryingLenData(WhiteNoiseData):
    """Toy spectra of two bucketed lengths, so that a K=4 epoch has a
    group flushed by a shape change, a full group and a remainder."""
    LENS = [32, 32, 16, 32, 32, 32, 32, 16, 32, 32]

    def epoch(self, subset, batch_size, shuffle=False, rng=None, rand=None):
        for t in self.LENS:
            yield (rng.rand(batch_size, t, self.hp.FEATURE_SIZE).astype(
                np.float32),)


def _run_k(tmp_path, k, dataset_cls=WhiteNoiseData, **keys):
    hp = load_config(**dict(
        BATCH_SIZE=2, TRAIN_STEPS_PER_CALL=k, TIME_BUCKET=16,
        SUMMARY_DIR=str(tmp_path / ("logs%d" % k)), **keys))
    tr = Trainer(DaNet(hp), hp, "cpu")
    ds = dataset_cls(hp)
    ds.install_and_load()
    state = tr.train(1, ds, save_on_epoch=False, valid_on_epoch=False,
                     state=tr.init_state(torch.Generator().manual_seed(0)))
    return state


@pytest.mark.parametrize("dataset_cls", [WhiteNoiseData, VaryingLenData])
def test_torch_steps_per_call_equal_single_steps(tmp_path, capsys,
                                                 dataset_cls):
    """TRAIN_STEPS_PER_CALL=4 on the CPU gives K=1's parameters, Adam
    moments and epoch line bit for bit: 10 batches are two groups and a
    remainder of two, or (two lengths) a group flushed by a shape
    change, a full group and single steps."""
    s1 = _run_k(tmp_path, 1, dataset_cls)
    line1 = capsys.readouterr().out.split("Epoch 1/1 ")[1].split(" (")[0]
    s4 = _run_k(tmp_path, 4, dataset_cls)
    line4 = capsys.readouterr().out.split("Epoch 1/1 ")[1].split(" (")[0]
    assert s1["step"] == s4["step"] == 10
    assert line1 == line4
    pairs = list(zip(weights.leaves(s1["params"]),
                     weights.leaves(s4["params"])))
    pairs += list(zip(s1["opt"].mu + s1["opt"].nu,
                      s4["opt"].mu + s4["opt"].nu))
    for a, b in pairs:
        assert torch.equal(a.detach(), b.detach())
    assert s1["opt"].count == s4["opt"].count == 10


def _train_rows(tmp_path, k):
    (run_dir,) = os.listdir(str(tmp_path / ("logs%d" % k)))
    with open(os.path.join(str(tmp_path / ("logs%d" % k)), run_dir,
                           "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [{key: v for key, v in r.items()
             if key not in ("t", "train/step_time")} for r in rows]


def test_torch_metrics_rows_independent_of_metrics_every(tmp_path):
    """metrics.jsonl holds one train row per step (loss, SNR, LR at its
    step number) and one valid row per epoch, the same numbers whether
    the metrics are fetched every step, every 3 steps, or every 3 steps
    of 2-step calls."""
    runs = []
    for k, every in ((1, 1), (2, 3), (3, 3)):
        hp = load_config(BATCH_SIZE=2, METRICS_EVERY=every,
                         TRAIN_STEPS_PER_CALL=1 if k == 3 else k,
                         SUMMARY_DIR=str(tmp_path / ("logs%d" % k)))
        tr = Trainer(DaNet(hp), hp, "cpu")
        ds = WhiteNoiseData(hp)
        ds.install_and_load()
        tr.train(1, ds, save_on_epoch=False, state=tr.init_state(
            torch.Generator().manual_seed(0)))
        runs.append(_train_rows(tmp_path, k))
    ref = runs[0]
    assert [r["step"] for r in ref] == list(range(10)) + [10]
    assert sorted(ref[0]) == ["step", "train/LR", "train/SNR", "train/loss"]
    assert "valid/loss" in ref[-1]
    for rows in runs[1:]:
        assert rows == ref


def test_torch_step_time_adds_up_to_the_wall_between_fetches(
        tmp_path, monkeypatch):
    """METRICS_EVERY=3: the rows of one fetch share a step_time, the wall
    time since the previous fetch ended over the steps it brought, so
    that step_time x steps adds up to the loop's wall time between two
    fetches (the rows' write times) within 10 %; each step is made 20 ms
    longer, so that the host's jitter stays well under that."""
    step = Trainer.train_step

    def slow_step(self, state, batch):
        time.sleep(0.02)
        return step(self, state, batch)

    monkeypatch.setattr(Trainer, "train_step", slow_step)
    logs = tmp_path / "logs"
    hp = load_config(BATCH_SIZE=2, METRICS_EVERY=3, SUMMARY_DIR=str(logs))
    tr = Trainer(DaNet(hp), hp, "cpu")
    ds = WhiteNoiseData(hp)
    ds.install_and_load()
    tr.train(1, ds, save_on_epoch=False, valid_on_epoch=False,
             state=tr.init_state(torch.Generator().manual_seed(0)))
    (run_dir,) = os.listdir(str(logs))
    with open(os.path.join(str(logs), run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    rows = [r for r in rows if "train/loss" in r]
    assert [r["step"] for r in rows] == list(range(10))
    # the fetches: after steps 3, 6, 9 and at the epoch's end
    groups = [rows[0:3], rows[3:6], rows[6:9], rows[9:10]]
    for g in groups:
        assert len({r["train/step_time"] for r in g}) == 1
    for prev, g in zip(groups, groups[1:]):
        wall = g[0]["t"] - prev[0]["t"]
        timed = g[0]["train/step_time"] * len(g)
        assert abs(timed - wall) <= 0.1 * wall, (timed, wall)
        assert timed >= 0.02 * len(g)


@pytest.mark.parametrize("k", [1, 2])
def test_torch_profile_steps_writes_a_trace(tmp_path, capsys, k):
    """PROFILE_STEPS=2: Trainer.train on the CPU writes a torch.profiler
    trace (Chrome JSON, CPU op events) to <run dir>/profile/trace.json,
    from the first call that starts 3 steps or more into the run: the
    4th and 5th steps of the toy epoch's 10, or with 2-step calls the
    call of the 5th and 6th (whole calls); metrics.jsonl's rows equal
    those of a run without it."""
    rows, traces = {}, {}
    for n in (0, 2):
        logs = tmp_path / ("logs%d" % (k + 2 * n))
        hp = load_config(BATCH_SIZE=2, MAX_TRAIN_LEN=16, PROFILE_STEPS=n,
                         TRAIN_STEPS_PER_CALL=k, SUMMARY_DIR=str(logs))
        tr = Trainer(DaNet(hp), hp, "cpu")
        ds = WhiteNoiseData(hp)
        ds.install_and_load()
        capsys.readouterr()
        tr.train(1, ds, save_on_epoch=False, valid_on_epoch=False)
        out = capsys.readouterr().out
        rows[n] = _train_rows(tmp_path, k + 2 * n)
        (run_dir,) = os.listdir(str(logs))
        traces[n] = os.path.join(str(logs), run_dir, "profile",
                                 "trace.json")
    assert not os.path.exists(traces[0])
    assert len(rows[0]) == 10 and rows[2] == rows[0]
    assert "[profile: steps %s traced into %s]" % (
        "4 to 5" if k == 1 else "5 to 6", traces[2]) in out
    with open(traces[2]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_torch_profile_window_keeps_captures_out(tmp_path):
    """ProfileWindow: nothing before start + 3; a call that captures a new
    CUDA graph neither opens the window nor runs inside it (the trace is
    closed before it); one window per train call; a K-step call that
    overshoots the count is traced whole."""
    w = trainer_mod.ProfileWindow(2, 0, str(tmp_path / "a"), "cpu")
    w.before(0, False)
    w.before(3, True)
    assert w.prof is None
    w.before(4, False)
    assert w.prof is not None and w.started == 4
    w.after(5)
    assert w.prof is not None
    w.before(5, True)
    assert w.prof is None and os.path.exists(w.path)
    w.before(9, False)
    assert w.prof is None
    w = trainer_mod.ProfileWindow(2, 10, str(tmp_path / "b"), "cpu")
    w.before(12, False)
    assert w.prof is None
    w.before(13, False)
    w.after(21)
    assert w.prof is None and w.path == str(tmp_path / "b" / "trace.json")
    w.stop(21)


# -------------------------------------------------- prefetch, watchdog
def test_torch_prefetch_worker_exits_when_consumer_abandons():
    """An abandoned prefetch generator releases its worker thread."""
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield i

    before = threading.active_count()
    it = prefetch_to_device(gen(), lambda x: x, depth=1)
    assert next(it) == 0
    it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert len(produced) < 100


def test_torch_prefetch_raises_the_workers_error():
    def gen():
        yield 1
        raise KeyError("bad batch")

    it = prefetch_to_device(gen(), lambda x: x + 1)
    assert next(it) == 2
    with pytest.raises(KeyError):
        next(it)


def test_torch_pinned_staging_reuses_a_buffer_after_its_copy(monkeypatch):
    """A lent buffer comes back only once its copy's event has completed,
    matched by shape and dtype; at most max_free idle buffers are kept
    (pinned allocation faked: there is no card here)."""
    class Event:
        done = False

        def query(self):
            return self.done

    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda shape, dtype=None,
                        pin_memory=False: real_empty(shape, dtype=dtype))
    st = PinnedStaging(max_free=2)
    a = st.take((2, 3), torch.int16)
    ev = Event()
    st._lent.append((ev, a))
    assert st.take((2, 3), torch.int16) is not a      # still in flight
    ev.done = True
    assert st.take((2, 4), torch.int16) is not a      # another shape
    assert st.take((2, 3), torch.int16) is a
    bufs = [st.take((i + 1,), torch.float32) for i in range(4)]
    for buf in bufs:
        done = Event()
        done.done = True
        st._lent.append((done, buf))
    st.take((9,), torch.float32)
    assert len(st._free) == 2 and st._free[0] is bufs[2]


def test_torch_hang_watchdog_fires_on_stale_heartbeat(monkeypatch):
    """WATCHDOG_SECS > 0: a stale heartbeat ends the process with
    WATCHDOG_EXIT_CODE (os._exit patched here); a refreshed one does not;
    nested use leaves the outer watchdog running."""
    tr = _trainer(WATCHDOG_SECS=0.5)
    fired = []
    done = threading.Event()

    def fake_exit(code):
        fired.append(code)
        done.set()

    monkeypatch.setattr(trainer_mod.os, "_exit", fake_exit)
    with tr._hang_watchdog():
        for _ in range(5):
            tr._heartbeat = time.monotonic()
            time.sleep(0.2)
        assert not fired
        assert done.wait(5.0), "the watchdog did not fire"
    assert fired[0] == trainer_mod.WATCHDOG_EXIT_CODE == 114
    with tr._hang_watchdog():
        assert tr._watchdog_on
        with tr._hang_watchdog():
            pass
        assert tr._watchdog_on
    assert not tr._watchdog_on


# ---------------------------------------------------------------- CLI
def test_torch_train_cli_tpu_json_on_wsj0_fixture(tmp_path):
    """python -m danet_tpu_torch.train -c configs/tpu.json with a config
    that points WSJ0_PATH at a written wsj0 fixture and narrows the
    model: tpu.json's trainer keys in force (the int16 wave wire at
    WAVE_PCM_SCALE 32768, TRAIN_STEPS_PER_CALL 8, METRICS_EVERY 30,
    WATCHDOG_SECS 900) on the CPU; prints its Epoch and Valid lines and
    writes metrics.jsonl."""
    pytest.importorskip("h5py")
    from test_torch_data import _write_wsj0_h5
    path = str(tmp_path / "wsj0-danet.hdf5")
    _write_wsj0_h5(path, [1500 + 37 * i for i in range(38)])
    cfg = tmp_path / "small.json"
    cfg.write_text(json.dumps({
        "WSJ0_PATH": path, "BATCH_SIZE": 2, "ATTN_DIM": 16,
        "ATTN_HEADS": 2, "ATTN_LAYERS": 1, "EMBED_SIZE": 4,
        "MAX_TRAIN_LEN": 16, "TIME_BUCKET": 16,
        "SUMMARY_DIR": str(tmp_path / "logs")}))
    proc = subprocess.run(
        [sys.executable, "-m", "danet_tpu_torch.train",
         "-c", os.path.join(REPO, "configs", "tpu.json"), "-c", str(cfg),
         "-ne", "1", "--no-save-on-epoch", "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert 'Preparing dataset "wsj0" ... done' in proc.stdout
    epoch = [ln for ln in lines if ln.startswith("Epoch 1/1 loss=")]
    valid = [ln for ln in lines if ln.startswith("Valid  1/1 ")]
    assert epoch and valid, proc.stdout
    assert "SI_SNR=" in valid[0]
    (run_dir,) = os.listdir(str(tmp_path / "logs"))
    with open(os.path.join(str(tmp_path / "logs"), run_dir,
                           "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    # 36 train rows make 9 batches of 2 mixtures: one 8-step call and a
    # single step, then the valid sweep
    assert [r["step"] for r in rows] == list(range(9)) + [9]


def test_torch_train_step_after_inference_mode(monkeypatch):
    """The step's cached device constants (anchor subsets, permutations)
    are built outside inference mode even when serving builds them first,
    so that a later train step can save them for backward."""
    from danet_tpu_torch.ops import nn as tnn
    monkeypatch.setattr(tnn, "_CONSTANTS", {})
    hp = load_config(BATCH_SIZE=2, INFER_ESTIMATOR_METHOD="kmeans",
                     ANCHOR_AUX_LOSS=0.5, TRAIN_LOSS_TYPE="pit-si-snr")
    tr = Trainer(DaNet(hp), hp, "cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    batch = np.random.RandomState(0).rand(2, 2, 32, 129, 2).astype(
        np.float32)
    with torch.inference_mode():
        tr.model.valid_metrics(state["params"], tr.ingest(batch))
    assert np.isfinite(float(tr.train_step(state, batch)["loss"]))


@pytest.mark.parametrize("t,d", [(1, 16), (37, 16), (128, 64), (1251, 256)])
def test_torch_posenc_matches_jax(t, d):
    """attn-v1's positions, now built on the device on each call: the JAX
    package's numpy table bit for bit, in float32 and bfloat16."""
    from danet_tpu.models.encoders import AttentionEncoder as JaxAttention
    from danet_tpu_torch.models.encoders import AttentionEncoder
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = AttentionEncoder._posenc(t, d, tdt, "cpu").float().numpy()
        want = np.asarray(JaxAttention._posenc(t, d, jdt).astype(
            jnp.float32))
        np.testing.assert_array_equal(got, want)


def test_torch_serving_lengths_add_no_device_constants(monkeypatch):
    """Requests of new lengths, served and trained on, leave the cache of
    device constants as it was: it holds only what does not depend on the
    input's length (bases, window, permutations, anchor subsets, the
    positions' wavelengths), so a long-running server does not grow it."""
    from danet_tpu_torch.ops import nn as tnn
    from danet_tpu_torch.serve import Separator
    monkeypatch.setattr(tnn, "_CONSTANTS", {})
    hp = load_config(BATCH_SIZE=2, ENCODER_TYPE="attn-v1", ATTN_DIM=16,
                     ATTN_HEADS=2, ATTN_LAYERS=1,
                     INFER_ESTIMATOR_METHOD="kmeans", ANCHOR_AUX_LOSS=0.5,
                     TRAIN_LOSS_TYPE="pit-si-snr")
    model = DaNet(hp)
    sep = Separator(model, weights.to_jax(
        model.init(torch.Generator().manual_seed(0))), "cpu")
    tr = Trainer(model, hp, "cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)

    def serve_and_train(n):
        out = sep.separate((rs.randn(n) * 0.1).astype(np.float32))
        assert out.shape == (2, n) and np.isfinite(out).all()
        batch = rs.rand(2, 2, n // 64, 129, 2).astype(np.float32)
        assert np.isfinite(float(tr.train_step(state, batch)["loss"]))

    serve_and_train(3000)
    cached = sorted(map(repr, tnn._CONSTANTS))
    for n in (4100, 5333, 9000):
        serve_and_train(n)
    assert sorted(map(repr, tnn._CONSTANTS)) == cached


# ------------------------------------------------- graph capture rules
class _HostReads(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the ops that read a tensor's value on the host or give a
    data-dependent shape: a CUDA graph capture fails on them."""
    BAD = ("aten::_local_scalar_dense", "aten::nonzero",
           "aten::masked_select", "aten::unique")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in self.BAD:
            self.seen.append(func._schema.name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("keys", [
    dict(ENCODER_TYPE="attn-v1", ATTN_BACKEND="flash", ATTN_DIM=16,
         ATTN_HEADS=2, ATTN_LAYERS=1, INFER_ESTIMATOR_METHOD="kmeans",
         ANCHOR_AUX_LOSS=0.5, DROPOUT_KEEP_PROB=0.9, TRANSFER_DOMAIN="wave",
         TRANSFER_DTYPE="int16", COMPUTE_DTYPE="bfloat16"),
    dict(ENCODER_TYPE="attn-v1", ATTN_DIM=16, ATTN_HEADS=2, ATTN_LAYERS=1,
         TRANSFER_DOMAIN="wave", STFT_BACKEND="xla",
         TRAIN_LOSS_TYPE="pit-si-snr"),
    dict(ENCODER_TYPE="toy", DC_LOSS_WEIGHT=0.1, GRAD_CLIP_NORM=1.0)])
def test_torch_warm_step_is_capturable(monkeypatch, keys):
    """What a CUDA graph of train steps needs of the step, held on the
    CPU: after a first step, a step reads no value on the host (no
    .item(), float(t), nonzero or boolean-mask index) and builds no
    tensor from host data (each would be a blocking copy under capture;
    the optimizer's scalars come from the graph's static buffer);
    tpu.json's path (attn-v1 flash, kmeans, ANCHOR_AUX_LOSS, dropout,
    the int16 wave wire, bfloat16), the dense attention with the plain
    STFT and the SI-SNR loss, and the DC loss with the norm clip."""
    hp = load_config(**dict(BATCH_SIZE=2, **keys))
    tr = Trainer(DaNet(hp), hp, "cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    flat = (np.random.RandomState(0).randn(4, 128 * 64) * 0.3).astype(
        np.float32)
    if tr._wave_mode:
        batch = prepare_batch_wave(flat, 2, 2, 256, 64, max_len=128,
                                   rng=np.random.RandomState(1))
    else:
        batch = np.random.RandomState(0).rand(2, 2, 128, 129, 2).astype(
            np.float32)
    src = tr._put(tr._host_batch(batch))
    tr.train_step(state, src)
    opt = state["opt"]
    scalars = opt.device_scalars(opt.count + 1)   # a static buffer's row
    built = []
    for name in ("from_numpy", "as_tensor", "tensor"):
        real = getattr(torch, name)

        def spy(*a, _real=real, _name=name, **kw):
            built.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(torch, name, spy)
    with _HostReads() as reads:   # one step as ``Trainer._capture`` runs it
        m, grads = tr.loss_and_grads(state["params"], tr.ingest(src),
                                     state["generator"])
        opt.step(grads, scalars[0])
    monkeypatch.undo()
    assert reads.seen == [] and built == []
    assert np.isfinite(float(m["loss"]))
