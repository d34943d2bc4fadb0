"""PyTorch port, train-state checkpoints (``danet_tpu_torch/train/
checkpoint.py``, ``Trainer.save_params`` / ``load_params`` / ``restore``,
``weights.from_jax_state``), each test the counterpart of a JAX test of
``tests/test_train.py`` named in its docstring.

On the CPU at tiny widths (the toy encoder and dataset, or bilstm-orig
with HDIM 6 and 2 layers).  A resumed run equals the straight run bit for
bit (parameters, moments, dropout generator, every step's loss).  A JAX
state carried into the port continues as JAX's own: losses within 1e-6
relative, parameters and moments within 2e-5 atol / 1e-4 rtol (the JAX
kernel tests' gradient bar).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import danet_tpu_torch.models.encoders as tenc  # noqa: E402
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch import __main__ as cli  # noqa: E402
from danet_tpu_torch.data.dataset import WhiteNoiseData  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402
from danet_tpu_torch.train import Trainer  # noqa: E402
from danet_tpu_torch.train import checkpoint as ckpt  # noqa: E402

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


def _trainer(tmp_path, name="ck", **keys):
    hp = load_config(**dict(TINY, SUMMARY_DIR=str(tmp_path / "logs"),
                            **keys))
    return Trainer(TorchDaNet(hp), hp, "cpu", name=name,
                   save_dir=str(tmp_path / "saves"))


def _toy(hp):
    ds = WhiteNoiseData(hp)
    ds.install_and_load()
    return ds


def _state_arrays(state):
    """name -> numpy array of every tensor of a state, and the generator's
    state."""
    out = {"params/" + n: t.detach().numpy() for n, t in zip(
        weights.leaf_names(state["params"]),
        weights.leaves(state["params"]))}
    opt = state["opt"]
    for m in ("mu", "nu"):
        for i, t in enumerate(getattr(opt, m) or []):
            out["%s/%d" % (m, i)] = t.numpy()
    if state.get("ema") is not None:
        out.update({"ema/" + n: t.numpy() for n, t in zip(
            weights.leaf_names(state["ema"]),
            weights.leaves(state["ema"]))})
    out["generator"] = state["generator"].get_state().numpy()
    return out


def _assert_states_equal(a, b):
    sa, sb = _state_arrays(a), _state_arrays(b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    for k in ("step", "epoch"):
        assert type(b[k]) is int and a[k] == b[k], k
    assert a["opt"].count == b["opt"].count
    assert a["opt"].lr == b["opt"].lr


def test_torch_trainer_epoch_and_checkpoint_roundtrip(tmp_path):
    """(test_train.py:50, :273) One epoch with save_on_epoch writes
    <name>_e1; loading it into a fresh state restores every tensor, the
    moments, the EMA, the counters (as ints), the LR and the dropout
    generator's state bit for bit, in place: the loaded state keeps its
    own tensors."""
    tr = _trainer(tmp_path, EMA_DECAY=0.5)
    ds = _toy(tr.hp)
    state = tr.train(1, ds, save_on_epoch=True, valid_on_epoch=False)
    assert state["step"] == 10 and state["epoch"] == 1
    assert ckpt.exists(tr.save_path(1))
    assert os.listdir(tr.save_path(1)) == [ckpt.STATE_FILE]
    fresh = tr.init_state(torch.Generator().manual_seed(42))
    tensors = [id(t) for t in weights.leaves(fresh["params"])] + \
        [id(t) for t in fresh["opt"].mu] + \
        [id(t) for t in weights.leaves(fresh["ema"])]
    restored = tr.load_params(fresh, tr.save_path(1))
    assert restored is fresh
    assert tensors == [id(t) for t in weights.leaves(fresh["params"])] + \
        [id(t) for t in fresh["opt"].mu] + \
        [id(t) for t in weights.leaves(fresh["ema"])]
    assert all(a is b for a, b in zip(fresh["opt"].params,
                                      weights.leaves(fresh["params"])))
    _assert_states_equal(state, restored)
    # a host tree (load_checkpoint's) saves as it loads
    again = str(tmp_path / "again")
    ckpt.save_checkpoint(again, ckpt.load_checkpoint(tr.save_path(1), state))
    _assert_states_equal(state, tr.load_params(
        tr.init_state(torch.Generator().manual_seed(7)), again))


def _cli(tmp_path, monkeypatch, args):
    """python -m danet_tpu_torch's main(args) in tmp_path (bilstm-orig
    at HDIM 6 x 2 layers, dropout at keep 0.8, --device cpu)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tenc.BiLstmEncoder, "HDIM", 6)
    monkeypatch.setattr(tenc.BiLstmEncoder, "N_LAYERS", 2)
    cli.main(["-ds", "toy", "-bs", "2", "-tl", "16", "--device", "cpu",
              "--no-valid-on-epoch",
              "--set", 'ENCODER_TYPE="bilstm-orig"',
              "--set", "DROPOUT_KEEP_PROB=0.8",
              "--set", 'SUMMARY_DIR="%s"' % (tmp_path / "logs")] + args)
    return cli.g_trainer, cli.g_state


def _step_losses(tmp_path):
    rows = []
    for run in sorted(os.listdir(tmp_path / "logs")):
        with open(tmp_path / "logs" / run / "metrics.jsonl") as f:
            rows += [json.loads(line) for line in f]
    return [(r["step"], r["train/loss"]) for r in rows if "train/loss" in r]


def test_torch_resumed_training_accumulates_epochs(tmp_path, monkeypatch):
    """(test_train.py:289) Through the CLI: 2 epochs straight against 1
    epoch, then ``-i saves/<name>_e1`` and 1 more: the epoch numbering
    continues (Epoch 2/2), and the parameters, moments, dropout generator
    and every step's loss equal the straight run's bit for bit."""
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    straight.mkdir()
    resumed.mkdir()
    _, s2 = _cli(straight, monkeypatch, ["-ne", "2", "-n", "run"])
    _cli(resumed, monkeypatch, ["-ne", "1", "-n", "run"])
    tr, r2 = _cli(resumed, monkeypatch,
                  ["-ne", "1", "-n", "run", "-i", "saves/run_e1"])
    assert s2["epoch"] == r2["epoch"] == 2 and r2["step"] == 20
    _assert_states_equal(s2, r2)
    a, b = _step_losses(straight), _step_losses(resumed)
    assert [s for s, _ in a] == [s for s, _ in b] == list(range(20))
    assert a == b
    # the e2 checkpoints of both runs are the same bytes' worth of state
    ca = ckpt.load_checkpoint(str(straight / "saves/run_e2"), s2)
    cb = ckpt.load_checkpoint(str(resumed / "saves/run_e2"), r2)
    for (ka, va), (kb, vb) in zip(
            zip(weights.leaf_names(ca), weights.leaves(ca)),
            zip(weights.leaf_names(cb), weights.leaves(cb))):
        assert ka == kb
        np.testing.assert_array_equal(va, vb, err_msg=ka)


def test_torch_lr_survives_resume(tmp_path):
    """(test_train.py:308) A restored state carries the decayed LR; train
    without ``lr`` keeps decaying from it, an explicit ``lr`` wins."""
    tr = _trainer(tmp_path, LR_DECAY_TYPE="fixed", NUM_EPOCH_PER_LR_DECAY=1)
    hp, ds = tr.hp, _toy(tr.hp)
    state = tr.train(2, ds, save_on_epoch=False, valid_on_epoch=False)
    decayed = tr.get_learn_rate(state)
    np.testing.assert_allclose(decayed, hp.LR * hp.LR_DECAY ** 2, rtol=1e-12)
    tr.save_params(state, str(tmp_path / "mid"))
    restored = tr.load_params(tr.init_state(torch.Generator().manual_seed(1)),
                              str(tmp_path / "mid"))
    assert tr.get_learn_rate(restored) == decayed
    restored = tr.train(1, ds, save_on_epoch=False, valid_on_epoch=False,
                        state=restored)
    np.testing.assert_allclose(tr.get_learn_rate(restored),
                               decayed * hp.LR_DECAY, rtol=1e-12)
    restored = tr.train(1, ds, save_on_epoch=False, valid_on_epoch=False,
                        state=restored, lr=0.5)
    np.testing.assert_allclose(tr.get_learn_rate(restored),
                               0.5 * hp.LR_DECAY, rtol=1e-12)


def test_torch_epoch_checkpoint_embeds_completed_epoch(tmp_path):
    """(test_train.py:459) saves/<name>_e<k> holds epoch k."""
    tr = _trainer(tmp_path, name="epk")
    tr.train(2, _toy(tr.hp), save_on_epoch=True, valid_on_epoch=False)
    for k in (1, 2):
        restored = tr.load_params(
            tr.init_state(torch.Generator().manual_seed(1)), tr.save_path(k))
        assert restored["epoch"] == k and restored["step"] == 10 * k


def test_torch_ema_checkpoint_compat_both_directions(tmp_path):
    """(test_train.py:519) A checkpoint without an EMA restores under
    EMA_DECAY > 0 (the EMA re-seeded from the restored parameters), and
    one with an EMA restores under EMA_DECAY 0 (the EMA dropped)."""
    tr0 = _trainer(tmp_path)
    s0 = tr0.init_state(torch.Generator().manual_seed(1))
    tr0.save_params(s0, str(tmp_path / "pre_ema"))
    tr1 = _trainer(tmp_path, EMA_DECAY=0.9)
    s1 = tr1.load_params(tr1.init_state(torch.Generator().manual_seed(2)),
                         str(tmp_path / "pre_ema"))
    for a, b in zip(weights.leaves(s1["ema"]), weights.leaves(s1["params"])):
        assert torch.equal(a, b.detach())
    tr1.save_params(s1, str(tmp_path / "with_ema"))
    tr2 = _trainer(tmp_path)
    s2 = tr2.load_params(tr2.init_state(torch.Generator().manual_seed(3)),
                         str(tmp_path / "with_ema"))
    assert "ema" not in s2
    for a, b in zip(weights.leaves(s0["params"]),
                    weights.leaves(s2["params"])):
        assert torch.equal(a, b)


def test_torch_load_eval_params_prefers_ema(tmp_path):
    """(test_train.py:553) load_eval_params returns the EMA when the
    checkpoint holds one, else the parameters; serve's -w takes such a
    directory and serves the same weights."""
    from danet_tpu_torch.serve import load_separator
    tr = _trainer(tmp_path, EMA_DECAY=0.5)
    state = tr.init_state(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for e in weights.leaves(state["ema"]):
            e.add_(1.0)
    tr.save_params(state, str(tmp_path / "ck_ema"))
    template = weights.to_jax(state["params"])
    got = ckpt.load_eval_params(str(tmp_path / "ck_ema"), template)
    for a, b in zip(weights.leaves(got), weights.leaves(state["ema"])):
        np.testing.assert_array_equal(a, b.numpy())
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY))
    sep = load_separator(str(tmp_path / "ck_ema"), [str(cfg)], "cpu")
    for a, b in zip(weights.leaves(sep.params), weights.leaves(state["ema"])):
        assert torch.equal(a, b)
    state.pop("ema")
    tr0 = _trainer(tmp_path)
    tr0.save_params(state, str(tmp_path / "ck_raw"))
    got = ckpt.load_eval_params(str(tmp_path / "ck_raw"), template)
    for a, b in zip(weights.leaves(got), weights.leaves(state["params"])):
        np.testing.assert_array_equal(a, b.detach().numpy())


@pytest.mark.parametrize("partial", [False, True])
def test_torch_checkpoint_of_another_architecture_raises(tmp_path, partial):
    """(checkpoint.py:41-68) A checkpoint of another ENCODER_TYPE raises a
    ValueError naming the leaf counts (not a KeyError), for a whole state
    and a params-only (partial) template alike; so does load_eval_params;
    and a directory without a checkpoint raises FileNotFoundError."""
    toy = _trainer(tmp_path)
    toy.save_params(toy.init_state(), str(tmp_path / "toy"))
    lstm = _trainer(tmp_path, ENCODER_TYPE="lstm-orig")
    st = lstm.init_state()
    template = {"params": st["params"]} if partial else st
    with pytest.raises(ValueError, match=r"holds \d+ leaves but the "
                       r"expected state has \d+"):
        ckpt.load_checkpoint(str(tmp_path / "toy"), template, partial)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_eval_params(str(tmp_path / "toy"), st["params"])
    with pytest.raises(FileNotFoundError):
        lstm.load_params(st, str(tmp_path))


def test_torch_checkpoint_save_is_atomic(tmp_path, monkeypatch):
    """A save that dies while writing leaves the previous checkpoint
    readable where -i reads it (the temporary file is renamed over it only
    once complete)."""
    tr = _trainer(tmp_path)
    state = tr.init_state()
    path = str(tmp_path / "ck")
    tr.save_params(state, path)
    before = ckpt.load_checkpoint(path, state)
    state["step"] = 5

    def dying_savez(f, **arrays):
        f.write(b"PK\x03\x04 half a zip")
        raise KeyboardInterrupt

    monkeypatch.setattr(ckpt.np, "savez", dying_savez)
    with pytest.raises(KeyboardInterrupt):
        tr.save_params(state, path)
    monkeypatch.undo()
    after = ckpt.load_checkpoint(path, state)
    assert after["step"] == before["step"] == 0


def test_torch_optstate_1tuple_checkpoint_compat(fresh_hparams, tmp_path,
                                                 capsys):
    """(test_train.py:802, carrying optax's chain state) A JAX Trainer
    trains one epoch; its state, through ``weights.from_jax_state`` and
    ``Trainer.restore`` (or saved as a port checkpoint and loaded: the
    same state), continues in the port: one more epoch of both on
    the same batches (toy, DROPOUT_KEEP_PROB 1) gives the same epoch loss
    and SNR within 1e-6 relative and the same parameters, Adam moments,
    count, LR and EMA within 2e-5 atol / 1e-4 rtol."""
    from danet_tpu.data.dataset import WhiteNoiseData as JaxToy
    from danet_tpu.models import DaNet as JaxDaNet
    from danet_tpu.parallel import make_mesh
    from danet_tpu.train.trainer import Trainer as JaxTrainer
    keys = dict(TINY, LR=1e-3, EMA_DECAY=0.5,
                SUMMARY_DIR=str(tmp_path / "logs"))
    fresh_hparams.load(keys)
    fresh_hparams.digest()
    jtr = JaxTrainer(JaxDaNet(), name="carry", save_dir=str(tmp_path),
                     mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    jds = JaxToy()
    jds.install_and_load()
    jstate = jtr.train(1, jds, save_on_epoch=False, valid_on_epoch=False)
    tree = weights.from_jax_state(jax.tree_util.tree_map(np.asarray, jstate))
    assert tree["step"] == 10 and tree["epoch"] == 1
    assert tree["opt"]["count"] == 10 and "ema" in tree
    # saved as a port checkpoint, it resumes as the restored tree does
    carried = str(tmp_path / "carried")
    ckpt.save_checkpoint(carried, tree)
    capsys.readouterr()
    jstate = jtr.train(1, jds, save_on_epoch=False, valid_on_epoch=False,
                       state=jstate)
    ref = capsys.readouterr().out

    hp = load_config(**keys)
    tr = Trainer(TorchDaNet(hp), hp, "cpu")
    state = tr.restore(tr.init_state(), tree)
    loaded = tr.load_params(tr.init_state(), carried)
    for a, b in zip(weights.leaves(state["params"]) + state["opt"].mu
                    + state["opt"].nu + weights.leaves(state["ema"]),
                    weights.leaves(loaded["params"]) + loaded["opt"].mu
                    + loaded["opt"].nu + weights.leaves(loaded["ema"])):
        assert torch.equal(a, b)
    assert (loaded["step"], loaded["opt"].count, loaded["opt"].lr) == (
        state["step"], state["opt"].count, state["opt"].lr)
    state = tr.train(1, _toy(hp), save_on_epoch=False, valid_on_epoch=False,
                     state=state)
    out = capsys.readouterr().out

    def epoch_line(text):
        (line,) = [ln for ln in text.splitlines() if ln.startswith("Epoch")]
        parts = line.split()
        assert parts[1] == "2/2", line
        return {k: float(v) for k, v in
                (p.split("=", 1) for p in parts[2:] if "=" in p)}

    a, b = epoch_line(out), epoch_line(ref)
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=0, err_msg=k)
    want = weights.from_jax_state(jax.tree_util.tree_map(np.asarray, jstate))
    got = {"params": weights.to_jax(state["params"]),
           "mu": dict(zip(weights.leaf_names(state["params"]),
                          [t.numpy() for t in state["opt"].mu])),
           "nu": dict(zip(weights.leaf_names(state["params"]),
                          [t.numpy() for t in state["opt"].nu])),
           "ema": weights.to_jax(state["ema"])}
    for part, ref_tree in (("params", want["params"]),
                           ("mu", want["opt"]["mu"]),
                           ("nu", want["opt"]["nu"]), ("ema", want["ema"])):
        names = weights.leaf_names(ref_tree)
        mine = got[part] if part in ("mu", "nu") else dict(
            zip(weights.leaf_names(got[part]), weights.leaves(got[part])))
        for name, r in zip(names, weights.leaves(ref_tree)):
            np.testing.assert_allclose(mine[name], r, atol=2e-5, rtol=1e-4,
                                       err_msg="%s/%s" % (part, name))
    assert state["opt"].count == want["opt"]["count"] == 20
    assert state["step"] == want["step"] and state["epoch"] == 2
    np.testing.assert_allclose(state["opt"].lr, want["opt"]["lr"],
                               rtol=1e-7)
