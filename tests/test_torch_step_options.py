"""PyTorch port, the train step's options: GRAD_ACCUM, EMA_DECAY and
NAN_CHECKS, in the eager step and in the K-step call (which on the CPU runs
its K steps eagerly; on the card they are one CUDA graph, held against the
eager steps bit for bit by ``chip_smoke.py`` phase 20 (b)).  Each test is
the counterpart of a JAX test of ``tests/test_train.py`` named in its
docstring; against the JAX package at the same weights and batches,
losses within 1e-6 relative, parameters, moments and EMA within 2e-5 atol
/ 1e-4 rtol.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import danet_tpu.models.encoders as jenc  # noqa: E402
import danet_tpu_torch.models.encoders as tenc  # noqa: E402
from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
from danet_tpu.parallel import make_mesh  # noqa: E402
from danet_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402
from danet_tpu_torch.train import Trainer, prepare_batch  # noqa: E402

TINY = dict(BATCH_SIZE=4, MAX_TRAIN_LEN=32, TIME_BUCKET=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and the test workers share the cores (a pool per worker oversubscribes
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(hp, seed, t=32):
    flat = np.random.RandomState(seed).rand(
        hp.BATCH_SIZE * hp.MAX_N_SIGNAL, t, hp.FEATURE_SIZE).astype(
            np.float32)
    return prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL)


def _jax_trainer(fresh_hparams, keys):
    fresh_hparams.load(keys)
    fresh_hparams.digest()
    return JaxTrainer(JaxDaNet(), name="opts",
                      mesh=make_mesh(1, 1, devices=jax.devices()[:1]))


def _leaves_close(got, want, what):
    names = weights.leaf_names(want)
    for name, a, b in zip(names, weights.leaves(got), weights.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5,
                                   rtol=1e-4, err_msg="%s/%s" % (what, name))


def _opt_trees(state):
    names = weights.leaf_names(state["params"])

    def tree(ts):
        out = {}
        for n, t in zip(names, ts):
            node = out
            *parents, leaf = n.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = t.numpy()
        return out

    return tree(state["opt"].mu), tree(state["opt"].nu)


@pytest.mark.parametrize("encoder", ["toy", "bilstm-orig"])
def test_torch_grad_accum_matches_full_batch(fresh_hparams, monkeypatch,
                                             encoder):
    """(test_train.py:389) GRAD_ACCUM=2 against JAX's accumulated step
    (its scan over microbatches) from the same weights: 2 steps, each
    step's loss and SNR, then the parameters and Adam moments.  The port's
    accumulated step also equals its whole-batch step to float32 noise."""
    for cls in (jenc.BiLstmEncoder, tenc.BiLstmEncoder):
        monkeypatch.setattr(cls, "HDIM", 6)
        monkeypatch.setattr(cls, "N_LAYERS", 2)
    keys = dict(TINY, GRAD_ACCUM=2, DROPOUT_KEEP_PROB=1.0, LR=1e-3,
                ENCODER_TYPE=encoder, LSTM_BACKEND="xla")
    jtr = _jax_trainer(fresh_hparams, keys)
    js = jtr.init_state(jax.random.PRNGKey(0))
    p0 = jax.device_get(js["params"])
    hp = load_config(**keys)
    tr = Trainer(TorchDaNet(hp), hp, "cpu")
    st = tr.init_state(params=p0)
    full = Trainer(TorchDaNet(load_config(**dict(keys, GRAD_ACCUM=1))),
                   device="cpu")
    sf = full.init_state(params=p0)
    for i in range(2):
        batch = _batch(hp, 10 + i)
        js["params"], js["opt_state"], jm = jtr._train_step(
            js["params"], js["opt_state"], jtr._put_batch(batch),
            jax.random.PRNGKey(i))
        m = tr.train_step(st, batch)
        mf = full.train_step(sf, batch)
        assert sorted(m) == ["SNR", "loss"]
        for k in ("loss", "SNR"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(float(m[k]), float(mf[k]), rtol=1e-5)
    want = weights.from_jax_state(jax.tree_util.tree_map(np.asarray, js))
    _leaves_close(weights.to_jax(st["params"]), want["params"], "params")
    mu, nu = _opt_trees(st)
    _leaves_close(mu, want["opt"]["mu"], "mu")
    _leaves_close(nu, want["opt"]["nu"], "nu")


def test_torch_grad_accum_must_divide_batch():
    """(test_train.py:423)"""
    hp = load_config(**dict(TINY, GRAD_ACCUM=3))
    with pytest.raises(ValueError, match="GRAD_ACCUM"):
        Trainer(TorchDaNet(hp), hp, "cpu")


def test_torch_dc_metric_notice_under_grad_accum(capsys):
    """(test_train.py:840) DC_LOSS_WEIGHT > 0 under GRAD_ACCUM > 1: the
    trainer says at build time that the DC column is not reported, and
    the step reports none."""
    hp = load_config(**dict(TINY, GRAD_ACCUM=2, DC_LOSS_WEIGHT=0.3))
    tr = Trainer(TorchDaNet(hp), hp, "cpu")
    assert "raw-DC diagnostic" in capsys.readouterr().out
    m = tr.train_step(tr.init_state(), _batch(hp, 0))
    assert "DC" not in m and np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("decay", [-0.1, 1.0])
def test_torch_ema_decay_out_of_range_raises(decay):
    hp = load_config(**dict(TINY, EMA_DECAY=decay))
    with pytest.raises(ValueError, match="EMA_DECAY"):
        Trainer(TorchDaNet(hp), hp, "cpu")


def test_torch_ema_updates_and_drives_eval(fresh_hparams, tmp_path):
    """(test_train.py:475) EMA_DECAY 0.5 over one toy epoch (10 steps)
    from the same weights as JAX's loop: the EMA agrees with JAX's
    state["ema"], moved from the init and lags the parameters; the valid
    step runs on it (its metrics equal JAX's valid_metrics on JAX's EMA),
    and so does ``separate``."""
    from danet_tpu.data.dataset import WhiteNoiseData as JaxToy
    from danet_tpu_torch.data.dataset import WhiteNoiseData
    keys = dict(TINY, EMA_DECAY=0.5, LR=1e-3,
                SUMMARY_DIR=str(tmp_path / "logs"))
    jtr = _jax_trainer(fresh_hparams, keys)
    js0 = jtr.init_state(jax.random.PRNGKey(0))
    p0 = jax.device_get(js0["params"])
    jds = JaxToy()
    jds.install_and_load()
    js = jtr.train(1, jds, save_on_epoch=False, valid_on_epoch=False,
                   state=js0)
    hp = load_config(**keys)
    tr = Trainer(TorchDaNet(hp), hp, "cpu")
    ds = WhiteNoiseData(hp)
    ds.install_and_load()
    st = tr.train(1, ds, save_on_epoch=False, valid_on_epoch=False,
                  state=tr.init_state(params=p0))
    jema = jax.device_get(js["ema"])
    _leaves_close(weights.to_jax(st["ema"]), jema, "ema")

    def maxdiff(a, b):
        return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
                   for x, y in zip(weights.leaves(weights.to_jax(a)),
                                   weights.leaves(weights.to_jax(b))))

    assert maxdiff(st["ema"], p0) > 1e-6
    assert maxdiff(st["ema"], st["params"]) > 1e-8
    assert tr.eval_params(st) is st["ema"]
    batch = _batch(hp, 5)
    ref = jtr.model.valid_metrics(jema, jnp.asarray(batch))
    out = tr.valid_step(st, batch)
    for k in ("loss", "SNR"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
    mix = batch.sum(axis=1)
    np.testing.assert_allclose(
        tr.separate(st, mix),
        np.asarray(jtr.model.separate(jema, jnp.asarray(mix))),
        atol=1e-4, rtol=1e-4)


def test_torch_steps_per_call_matches_single_steps():
    """(test_train.py:720) TRAIN_STEPS_PER_CALL 4 with EMA_DECAY 0.9 and
    GRAD_ACCUM 2 on (and dropout, bilstm-orig at HDIM 6): one K=4 call
    equals 4 single steps from the same state bit for bit, parameters,
    moments, EMA, generator and per-step metrics (the CPU's K-step call
    is the eager loop; the card's graph is held to it in chip_smoke.py)."""
    keys = dict(TINY, TRAIN_STEPS_PER_CALL=4, EMA_DECAY=0.9, GRAD_ACCUM=2,
                ENCODER_TYPE="bilstm-orig", DROPOUT_KEEP_PROB=0.8)
    hp = load_config(**keys)
    old = tenc.BiLstmEncoder.HDIM, tenc.BiLstmEncoder.N_LAYERS
    tenc.BiLstmEncoder.HDIM, tenc.BiLstmEncoder.N_LAYERS = 6, 2
    try:
        tr = Trainer(TorchDaNet(hp), hp, "cpu")
        p0 = weights.to_jax(tr.model.init(torch.Generator().manual_seed(0)))
        sk = tr.init_state(torch.Generator().manual_seed(3), params=p0)
        s1 = tr.init_state(torch.Generator().manual_seed(3), params=p0)
        batches = [_batch(hp, i) for i in range(4)]
        mk = tr.train_steps(sk, np.stack(batches))
        m1 = [tr.train_step(s1, b) for b in batches]
    finally:
        tenc.BiLstmEncoder.HDIM, tenc.BiLstmEncoder.N_LAYERS = old
    assert sk["step"] == s1["step"] == 4 and sk["opt"].count == 4
    for name in mk:
        assert torch.equal(mk[name], torch.stack([m[name] for m in m1]))
    for a, b in zip(weights.leaves(sk["params"]) + sk["opt"].mu
                    + sk["opt"].nu + weights.leaves(sk["ema"]),
                    weights.leaves(s1["params"]) + s1["opt"].mu
                    + s1["opt"].nu + weights.leaves(s1["ema"])):
        assert torch.equal(a, b)
    assert torch.equal(sk["generator"].get_state(),
                       s1["generator"].get_state())


def test_torch_nan_checks_mode(capsys):
    """(test_train.py:184) NAN_CHECKS: a clean batch passes; a poisoned
    one raises FloatingPointError naming the first parameter leaf whose
    gradient is not finite, before the update (the state does not move);
    TRAIN_STEPS_PER_CALL is forced to 1 with JAX's message."""
    hp = load_config(**dict(TINY, NAN_CHECKS=True, TRAIN_STEPS_PER_CALL=4))
    tr = Trainer(TorchDaNet(hp), hp, "cpu")
    assert "disabled under NAN_CHECKS" in capsys.readouterr().out
    assert tr._steps_per_call == 1
    state = tr.init_state()
    batch = _batch(hp, 0)
    assert np.isfinite(float(tr.train_step(state, batch)["loss"]))
    before = [t.detach().clone() for t in weights.leaves(state["params"])]
    bad = batch.copy()
    bad[0, 0, 0, 0, 0] = np.nan
    with pytest.raises(FloatingPointError,
                       match="step 2: non-finite gradient of "
                             "encoder/linear0/w, the first of"):
        tr.train_step(state, bad)
    assert state["step"] == 1
    for a, b in zip(before, weights.leaves(state["params"])):
        assert torch.equal(a, b)
