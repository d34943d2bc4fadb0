"""PyTorch port, the epoch loop's recoveries: the NaN rollback, the
valid-crash rollback (VALID_CRASH_FACTOR), keep-best and the preemption
save, each test the counterpart of a JAX test (``tests/test_train.py``,
``tests/test_cli.py``) named in its docstring.  On the CPU with the toy
encoder at B=2; the preemption test runs the CLI in a subprocess and
signals it.
"""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from danet_tpu_torch import __main__ as cli  # noqa: E402
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.data.dataset import WhiteNoiseData  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402
from danet_tpu_torch.train import Trainer  # noqa: E402
from danet_tpu_torch.train import checkpoint as ckpt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(BATCH_SIZE=2, MAX_TRAIN_LEN=16, TIME_BUCKET=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and the test workers share the cores (a pool per worker oversubscribes
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(tmp_path, name, **keys):
    hp = load_config(**dict(TINY, SUMMARY_DIR=str(tmp_path / "logs"),
                            **keys))
    ds = WhiteNoiseData(hp)
    ds.install_and_load()
    return Trainer(TorchDaNet(hp), hp, "cpu", name=name,
                   save_dir=str(tmp_path)), ds


class _Scripted:
    """Train batches of 16 frames whose draws are recorded per call of
    ``epoch('train')``: each batch draws two indices, then its spectra;
    the ``nan_call``-th call (1-based) puts a NaN into its first batch.
    ``draw`` is the package's generator: numpy's global one for JAX, the
    ``rng`` the port's loop passes."""

    def __init__(self, feature_size, nan_call):
        self.f, self.nan_call, self.calls = feature_size, nan_call, []

    def batches(self, draw, batch_size):
        self.calls.append([])
        for i in range(3):
            self.calls[-1].append(draw.randint(0, 10 ** 6, size=2))
            x = draw.rand(batch_size, 16, self.f).astype(np.float32)
            if len(self.calls) == self.nan_call and i == 0:
                x[0, 0, 0] = np.nan
            yield (x,)


def _port_scripted(script):
    class Data(WhiteNoiseData):
        def epoch(self, subset, batch_size, shuffle=False, rng=None,
                  rand=None):
            return script.batches(rng, batch_size)
    return Data


@pytest.mark.parametrize("saved", [True, False])
def test_torch_nan_rollback_matches_jax(fresh_hparams, tmp_path, capsys,
                                        saved):
    """(test_train.py's NaN sentinel, trainer.py:993-1015) Epoch 2's first
    attempt meets a NaN batch.  With epoch checkpoints, both packages
    print the same rollback line, restore <name>_e1 and retry epoch 2 on
    the retry-1 data stream: the same batch indices in both, other than
    the first attempt's; the run ends finite after 3 epochs.  Without
    checkpoints, both print the same line and exit with -1."""
    from danet_tpu.data.dataset import WhiteNoiseData as JaxToy
    from danet_tpu.models import DaNet as JaxDaNet
    from danet_tpu.parallel import make_mesh
    from danet_tpu.train.trainer import Trainer as JaxTrainer

    keys = dict(TINY, SUMMARY_DIR=str(tmp_path / "logs"))
    fresh_hparams.load(keys)
    fresh_hparams.digest()
    jscript = _Scripted(fresh_hparams.FEATURE_SIZE, nan_call=2)

    class JaxData(JaxToy):
        def epoch(self, subset, batch_size, shuffle=False):
            return jscript.batches(np.random, batch_size)

    jtr = JaxTrainer(JaxDaNet(), name="nan", save_dir=str(tmp_path / "jax"),
                     mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    jds = JaxData()
    jds.install_and_load()
    capsys.readouterr()
    if saved:
        jtr.train(3, jds, save_on_epoch=True, valid_on_epoch=False)
    else:
        with pytest.raises(SystemExit) as jexit:
            jtr.train(3, jds, save_on_epoch=False, valid_on_epoch=False)
    ref = capsys.readouterr().out

    tr, _ = _trainer(tmp_path / "port", "nan")
    script = _Scripted(tr.hp.FEATURE_SIZE, nan_call=2)
    ds = _port_scripted(script)(tr.hp)
    ds.install_and_load()
    if saved:
        state = tr.train(3, ds, save_on_epoch=True, valid_on_epoch=False)
    else:
        with pytest.raises(SystemExit) as exit_:
            tr.train(3, ds, save_on_epoch=False, valid_on_epoch=False)
    out = capsys.readouterr().out

    def said(text):
        return [ln.strip(":S") for ln in text.splitlines()
                if "NaN" in ln]

    assert said(out) == said(ref) and len(said(out)) == 1, (out, ref)
    if not saved:
        assert exit_.value.code == jexit.value.code == -1
        assert said(out)[0].startswith("Run into NaN during epoch 2")
        return
    assert said(out)[0] == ("Epoch 2/3 got NaN values, restoring last "
                            "checkpoint ... done")
    assert len(script.calls) == len(jscript.calls) == 4
    for a, b in zip(script.calls, jscript.calls):
        np.testing.assert_array_equal(np.stack(a), np.stack(b))
    assert not np.array_equal(np.stack(script.calls[1]),
                              np.stack(script.calls[2]))
    # the failed attempt's 3 steps were rolled back with the state
    assert state["epoch"] == 3 and state["step"] == 9
    assert all(torch.isfinite(p).all()
               for p in weights.leaves(state["params"]))
    epochs = [ln.split()[1] for ln in out.splitlines()
              if ln.startswith("Epoch ") and "NaN" not in ln]
    assert epochs == ["1/3", "2/3", "3/3"]


def _scripted_sweep(scripted, calls):
    def fake_sweep(state, dataset, subset, rng, rand):
        v = scripted[min(len(calls), len(scripted) - 1)]
        calls.append(v)
        return {"loss": v, "SNR": 0.0}
    return fake_sweep


def test_torch_valid_crash_rollback_restores_best(tmp_path):
    """(test_train.py:618) A finite valid-loss spike past
    VALID_CRASH_FACTOR x the best rolls back to <name>_best and replays
    the epoch; the replay recovers."""
    tr, ds = _trainer(tmp_path, "crash", VALID_CRASH_FACTOR=2.0)
    calls = []
    tr._metrics_sweep = _scripted_sweep([0.001, 100.0, 0.0009], calls)
    state = tr.train(2, ds, save_on_epoch=False, valid_on_epoch=True,
                     save_best=True)
    assert calls == [0.001, 100.0, 0.0009], calls
    assert state["epoch"] == 2 and state["step"] == 20
    assert ckpt.exists(str(tmp_path / "crash_best"))


def test_torch_valid_crash_rollback_epoch_checkpoint_path(tmp_path):
    """(test_train.py:648) Without keep-best the rollback goes to the
    previous epoch's checkpoint, and the spiked epoch's checkpoint is gone
    before the restore; the replayed epoch saves it again."""
    tr, ds = _trainer(tmp_path, "crash3", VALID_CRASH_FACTOR=2.0)
    calls = []
    tr._metrics_sweep = _scripted_sweep([0.001, 100.0, 0.0009], calls)
    seen = {}
    orig = tr.load_params

    def spy_load(state, path):
        seen["spiked_exists"] = os.path.isdir(tr.save_path(2))
        seen["target"] = path
        return orig(state, path)

    tr.load_params = spy_load
    state = tr.train(2, ds, save_on_epoch=True, valid_on_epoch=True,
                     save_best=False)
    assert calls == [0.001, 100.0, 0.0009], calls
    assert state["epoch"] == 2
    assert not os.path.isdir(str(tmp_path / "crash3_best"))
    assert seen == {"spiked_exists": False, "target": tr.save_path(1)}
    assert ckpt.exists(tr.save_path(2))


def test_torch_valid_crash_rollback_caps_retries(tmp_path, capsys):
    """(test_train.py:695) A spike that recurs after every rollback is
    rolled back at most 3 times, then accepted."""
    tr, ds = _trainer(tmp_path, "crash2", VALID_CRASH_FACTOR=2.0)
    calls = []
    tr._metrics_sweep = _scripted_sweep([0.001, 100.0], calls)
    state = tr.train(2, ds, save_on_epoch=False, valid_on_epoch=True,
                     save_best=True)
    assert state["epoch"] == 2
    assert len(calls) == 5, calls
    assert capsys.readouterr().out.count("crash rollback to") == 3


def test_torch_save_best_keeps_best_valid_checkpoint(tmp_path):
    """(test_train.py:377) save_best keeps <name>_best, the state of the
    epoch with the lowest valid loss."""
    tr, ds = _trainer(tmp_path, "best")
    calls = []
    tr._metrics_sweep = _scripted_sweep([0.5, 0.2, 0.3], calls)
    state = tr.train(3, ds, save_on_epoch=False, valid_on_epoch=True,
                     save_best=True)
    assert state["epoch"] == 3
    best = ckpt.load_checkpoint(str(tmp_path / "best_best"), state)
    assert best["epoch"] == 2 and best["step"] == 20


def test_torch_cli_preemption_checkpoint(tmp_path, monkeypatch, capsys):
    """(test_cli.py:141) SIGTERM to a training CLI process: it saves
    saves/<name>_preempt at the next step and exits 0; resuming from that
    checkpoint restarts the interrupted epoch and finishes it."""
    cwd = str(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "danet_tpu_torch", "-m", "train", "-ds",
         "toy", "-ne", "500", "-bs", "2", "-tl", "16", "-n", "preemptme",
         "--no-valid-on-epoch", "--device", "cpu",
         "--set", 'SUMMARY_DIR="logs"'],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.time() + 120
        while time.time() < deadline and proc.poll() is None \
                and not ckpt.exists(os.path.join(cwd, "saves",
                                                 "preemptme_e1")):
            time.sleep(0.2)
        assert ckpt.exists(os.path.join(cwd, "saves", "preemptme_e1")), \
            "training never reached an epoch save"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "[signal %d: checkpointing" % signal.SIGTERM in out, out
    assert "preempted: saved" in out, out
    path = os.path.join(cwd, "saves", "preemptme_preempt")
    assert ckpt.exists(path), out

    monkeypatch.chdir(tmp_path)
    cli.main(["-m", "train", "-ds", "toy", "-ne", "1", "-bs", "2", "-tl",
              "16", "-n", "resumed", "-i", path, "--no-valid-on-epoch",
              "--no-save-on-epoch", "--device", "cpu",
              "--set", 'SUMMARY_DIR="logs"'])
    saved = ckpt.load_checkpoint(path, cli.g_state)
    state = cli.g_state
    assert state["epoch"] == saved["epoch"] + 1
    assert state["step"] == saved["step"] + 10
    text = capsys.readouterr().out
    assert "Epoch %d/%d" % (state["epoch"], state["epoch"]) in text
