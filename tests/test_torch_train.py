"""PyTorch port, training: losses, optimizers, the train step,
``valid_metrics``, the data path and the CLI, against the JAX package on
the CPU with the same weights (carried by ``danet_tpu_torch.weights``) and
the same numpy inputs.

Narrow widths (HDIM 6, 2 layers, T 9, B 3; HDIM and N_LAYERS patched on
BOTH packages' encoder classes); the JAX side runs its Pallas LSTM kernels
in interpret mode.  Tolerances: 1e-5 on losses and metrics (float32 sums
in another order); 2e-5 atol / 1e-4 rtol on gradients and on parameters
after 3 optimizer steps, the JAX kernel tests' gradient bar.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import danet_tpu.models.encoders as jenc  # noqa: E402
from danet_tpu import optim as joptim  # noqa: E402
from danet_tpu.data.dataset import WhiteNoiseData as JaxToy  # noqa: E402
from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
from danet_tpu.ops import loss as jloss  # noqa: E402
from danet_tpu.train.trainer import prepare_batch as jax_prepare  # noqa
import danet_tpu_torch.models.encoders as tenc  # noqa: E402
from danet_tpu_torch import optim as toptim  # noqa: E402
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.data.dataset import WhiteNoiseData  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402
from danet_tpu_torch.ops import loss as tloss  # noqa: E402
from danet_tpu_torch.train import Trainer, prepare_batch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(a, b, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _src_ri(seed, b=3, n=2, t=9, f=129):
    """Per-source ri spectra with random magnitudes and phases."""
    rs = np.random.RandomState(seed)
    z = rs.randn(b, n, t, f) + 1j * rs.randn(b, n, t, f)
    return np.stack([z.real, z.imag], -1).astype(np.float32)


# the recurrent encoders by registry key: (JAX class, port class)
ENCODERS = {
    "bilstm-orig": (jenc.BiLstmEncoder, tenc.BiLstmEncoder),
    "lstm-orig": (jenc.LstmEncoder, tenc.LstmEncoder),
    "gru-v1": (jenc.GruEncoder, tenc.GruEncoder),
}


def _pair(hp_jax, monkeypatch, hdim=6, layers=2, encoder="bilstm-orig",
          **keys):
    """(jax model, jax params, torch model) at the given encoder width,
    built from default.json + ENCODER_TYPE=encoder + ``keys``, with the
    JAX recurrent kernels in Pallas interpret mode."""
    for cls in ENCODERS[encoder]:
        monkeypatch.setattr(cls, "HDIM", hdim)
        monkeypatch.setattr(cls, "N_LAYERS", layers)
    keys = dict(ENCODER_TYPE=encoder, **keys)
    hp_jax.load(dict(keys, LSTM_BACKEND="pallas-interpret"))
    hp_jax.digest()
    jmodel = JaxDaNet()
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams, TorchDaNet(load_config(**keys))


# ---------------------------------------------------------------- losses
@pytest.mark.parametrize("n_src", [2, 3])
def test_torch_pit_mse_masked_ri_matches_jax(fresh_hparams, n_src):
    src = _src_ri(1, n=n_src, t=5, f=7)
    rs = np.random.RandomState(2)
    sep_pwr = np.abs(rs.randn(3, n_src, 5, 7)).astype(np.float32)
    mix = src.sum(1)
    phase = mix / (np.sqrt((mix ** 2).sum(-1, keepdims=True)) + 1e-7)

    def jfn(m):
        loss, _, idx, snr = jloss.pit_mse_masked_ri(
            jnp.asarray(src), m, jnp.asarray(phase))
        return loss, (idx, snr)

    (jl, (jidx, jsnr)), jg = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(sep_pwr))
    m = _t(sep_pwr).requires_grad_(True)
    loss, perms, idx, snr = tloss.pit_mse_masked_ri(_t(src), m, _t(phase))
    loss.backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(perms.numpy(),
                                  jloss.permutations_array(n_src))
    _close(loss.detach(), jl)
    _close(snr.detach(), jsnr)
    _close(m.grad, jg)


@pytest.mark.parametrize("n_src", [2, 3])
@pytest.mark.parametrize("complex_ri", [False, True])
def test_torch_pit_mse_loss_and_unpermute_match_jax(fresh_hparams, n_src,
                                                    complex_ri):
    rs = np.random.RandomState(3)
    shape = (3, n_src, 4, 6) + ((2,) if complex_ri else ())
    x = rs.randn(*shape).astype(np.float32)
    y = rs.randn(*shape).astype(np.float32)

    def jfn(yv):
        loss, perms, idx = jloss.pit_mse_loss(jnp.asarray(x), yv,
                                              complex_ri=complex_ri)
        return loss, jloss.unpermute(yv, perms, idx)

    (jl, jy), jg = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(y))
    ty = _t(y).requires_grad_(True)
    loss, perms, idx = tloss.pit_mse_loss(_t(x), ty, complex_ri=complex_ri)
    loss.backward()
    _close(loss.detach(), jl)
    _close(tloss.unpermute(ty.detach(), perms, idx), jy)
    _close(ty.grad, jg)


@pytest.mark.parametrize("complex_ri", [False, True])
def test_torch_batch_snr_matches_jax(fresh_hparams, complex_ri):
    rs = np.random.RandomState(4)
    x = rs.randn(3, 2, 5, 7, 2).astype(np.float32)
    y = x + 0.3 * rs.randn(*x.shape).astype(np.float32)
    ref = jloss.batch_snr(jnp.asarray(x), jnp.asarray(y),
                          complex_ri=complex_ri)
    out = tloss.batch_snr(_t(x), _t(y), complex_ri=complex_ri)
    assert tuple(out.shape) == (3,)
    _close(out, ref)


# ------------------------------------------------------------ optimizers
@pytest.mark.parametrize("rule", ["sgd", "adam", "adamw"])
def test_torch_optimizer_matches_optax(fresh_hparams, rule):
    """Three updates with both clips biting (global norm, then value) and
    a learning-rate change, against danet_tpu.optim on optax."""
    hp = fresh_hparams
    hp.OPTIMIZER_TYPE = rule
    hp.GRAD_CLIP_NORM = 4.0
    hp.GRAD_CLIP_THRES = 0.2
    hp.WEIGHT_DECAY = 0.01
    rs = np.random.RandomState(5)
    params = {"a": {"w": rs.randn(4, 3).astype(np.float32)},
              "b": rs.randn(7).astype(np.float32)}
    grads = [{"a": {"w": rs.randn(4, 3).astype(np.float32)},
              "b": rs.randn(7).astype(np.float32)} for _ in range(3)]
    opt = joptim.make_optimizer(hp)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    tp = weights.from_jax(params)
    topt = toptim.make_optimizer(load_config(
        OPTIMIZER_TYPE=rule, GRAD_CLIP_NORM=4.0, GRAD_CLIP_THRES=0.2,
        WEIGHT_DECAY=0.01), tp)
    for i, g in enumerate(grads):
        if i == 2:
            joptim.set_learn_rate(state, 1e-2)
            toptim.set_learn_rate(topt, 1e-2)
        upd, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(weights.leaves(weights.from_jax(g)))
    # optax keeps the learning rate in float32
    assert np.float32(toptim.get_learn_rate(topt)) == np.float32(
        joptim.get_learn_rate(state))
    for a, b in zip(weights.leaves(tp),
                    weights.leaves(weights.from_jax(jax.device_get(jp)))):
        _close(a, b, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------ train step
def test_torch_train_step_matches_jax(fresh_hparams, monkeypatch):
    """The flagship step at narrow width: truth-weighted estimator,
    dot-sigmoid-orig, pit-mse, Adam with the value clip (hit in step 1).
    Loss and SNR of each of 3 steps, the gradients of step 1, and the
    parameters after step 3 match JAX's value_and_grad(train_loss) +
    danet_tpu.optim; the trained parameters load into the JAX model."""
    jm, jp, tm = _pair(fresh_hparams, monkeypatch)
    batches = [_src_ri(10 + i) for i in range(3)]
    vg = jax.jit(jax.value_and_grad(jm.train_loss, has_aux=True))
    (_, _), g1 = vg(jp, jnp.asarray(batches[0]))
    # value clip below the largest gradient, so that it bites
    thres = 0.5 * max(float(jnp.max(jnp.abs(g)))
                      for g in jax.tree_util.tree_leaves(g1))
    fresh_hparams.GRAD_CLIP_THRES = thres
    tm.hp.GRAD_CLIP_THRES = thres
    opt = joptim.make_optimizer(fresh_hparams)
    ostate = opt.init(jp)

    trainer = Trainer(tm, tm.hp, "cpu")
    state = trainer.init_state(params=jax.device_get(jp))
    _, tg1 = trainer.loss_and_grads(state["params"], _t(batches[0]))
    for a, b in zip(tg1, weights.leaves(weights.from_jax(
            jax.device_get(g1)))):
        _close(a, b, atol=2e-5, rtol=1e-4)

    jparams = jp
    for batch in batches:
        (jl, aux), g = vg(jparams, jnp.asarray(batch))
        upd, ostate = opt.update(g, ostate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        m = trainer.train_step(state, batch)
        _close(m["loss"], jl, atol=2e-5, rtol=1e-4)
        _close(m["SNR"], aux["snr"], atol=2e-5, rtol=1e-4)
    assert state["step"] == 3
    trained = weights.to_jax(state["params"])
    for a, b in zip(weights.leaves(trained),
                    weights.leaves(jax.device_get(jparams))):
        _close(a, b, atol=2e-5, rtol=1e-4)

    # to_jax of the port's trained parameters loads into the JAX model
    batch = _src_ri(20)
    ref = jm.valid_metrics(jax.tree_util.tree_map(jnp.asarray, trained),
                           jnp.asarray(batch))
    out = trainer.valid_step(state, batch)
    _close(out["loss"], ref["loss"])
    _close(out["SNR"], ref["SNR"])


@pytest.mark.parametrize("encoder", ["lstm-orig", "gru-v1"])
def test_torch_unidirectional_train_loss_and_grads_match_jax(
        fresh_hparams, monkeypatch, encoder):
    """train_loss of lstm-orig and gru-v1 and its gradient for every
    parameter against JAX's value_and_grad(train_loss), 2e-5 / 1e-4.  As
    in the JAX package, these encoders drop nothing in training: the loss
    at DROPOUT_KEEP_PROB 0.5 is the loss at 1."""
    jm, jp, tm = _pair(fresh_hparams, monkeypatch, encoder=encoder)
    batch = _src_ri(40)
    (jl, aux), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(
        jp, jnp.asarray(batch))
    trainer = Trainer(tm, tm.hp, "cpu")
    state = trainer.init_state(params=jax.device_get(jp))
    m, grads = trainer.loss_and_grads(state["params"], _t(batch))
    loss = m["loss"]
    _close(loss, jl, atol=2e-5, rtol=1e-4)
    _close(m["SNR"], aux["snr"], atol=2e-5, rtol=1e-4)
    ref = weights.leaves(weights.from_jax(jax.device_get(jg)))
    assert len(grads) == len(ref)
    for a, b in zip(grads, ref):
        _close(a, b, atol=2e-5, rtol=1e-4)
    tm.hp.DROPOUT_KEEP_PROB = 0.5
    dropped = tm.train_loss(state["params"], _t(batch),
                            torch.Generator().manual_seed(0))[0].detach()
    assert float(dropped) == float(loss)


@pytest.mark.parametrize("encoder", ["lstm-orig", "gru-v1"])
def test_torch_unidirectional_trainer_step_matches_jax(fresh_hparams,
                                                       monkeypatch, encoder):
    """One Trainer step of lstm-orig and gru-v1 (Adam with the value clip)
    against value_and_grad + danet_tpu.optim: its loss, and every
    parameter after the update, 2e-5 / 1e-4."""
    jm, jp, tm = _pair(fresh_hparams, monkeypatch, encoder=encoder)
    batch = _src_ri(41)
    (jl, _), g = jax.value_and_grad(jm.train_loss, has_aux=True)(
        jp, jnp.asarray(batch))
    opt = joptim.make_optimizer(fresh_hparams)
    upd, _ = opt.update(g, opt.init(jp), jp)
    jparams = optax.apply_updates(jp, upd)
    trainer = Trainer(tm, tm.hp, "cpu")
    state = trainer.init_state(params=jax.device_get(jp))
    m = trainer.train_step(state, batch)
    _close(m["loss"], jl, atol=2e-5, rtol=1e-4)
    assert state["step"] == 1
    for a, b in zip(weights.leaves(weights.to_jax(state["params"])),
                    weights.leaves(jax.device_get(jparams))):
        _close(a, b, atol=2e-5, rtol=1e-4)


def test_torch_trainer_runs_on_the_card_by_default(fresh_hparams):
    """Trainer's device defaults to CUDA, as the CLI's and
    serve.load_separator's do: it never falls back to the CPU.  Where
    torch has no card, init_state (which places the parameters) raises."""
    hp = load_config(ENCODER_TYPE="bilstm-orig")
    trainer = Trainer(TorchDaNet(hp), hp)
    assert trainer.device.type == "cuda"
    if torch.cuda.is_available():
        state = trainer.init_state()
        assert all(p.is_cuda for p in weights.leaves(state["params"]))
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            trainer.init_state()


@pytest.mark.parametrize("legacy", [False, True])
def test_torch_valid_metrics_matches_jax(fresh_hparams, monkeypatch,
                                         legacy):
    """Validation through the anchor inference estimator."""
    jm, jp, tm = _pair(fresh_hparams, monkeypatch, LSTM_LEGACY_CELL=legacy)
    batch = _src_ri(30)
    ref = jm.valid_metrics(jp, jnp.asarray(batch))
    out = tm.valid_metrics(weights.from_jax(jax.device_get(jp)), _t(batch))
    for key in ("loss", "SNR", "separated_ri"):
        _close(out[key], ref[key])


def test_torch_truth_weighted_inference_estimator_matches_jax(
        fresh_hparams, monkeypatch):
    """TRAIN_ESTIMATOR_METHOD == INFER_ESTIMATOR_METHOD == 'truth-weighted'
    builds and validates in both packages (valid_metrics passes the true
    sources); separation, which has none, raises ValueError."""
    jm, jp, tm = _pair(fresh_hparams, monkeypatch,
                       INFER_ESTIMATOR_METHOD="truth-weighted")
    assert tm.same_method and tm.infer_estimator.USE_TRUTH
    batch = _src_ri(31)
    ref = jm.valid_metrics(jp, jnp.asarray(batch))
    tp = weights.from_jax(jax.device_get(jp))
    out = tm.valid_metrics(tp, _t(batch))
    for key in ("loss", "SNR", "separated_ri"):
        _close(out[key], ref[key])
    with pytest.raises(ValueError):
        tm.separate(tp, _t(batch).sum(1))
    with pytest.raises(ValueError):
        tm.separate_wav(tp, torch.zeros(1, 2000))
    # a separate inference estimator that needs the truth stays refused
    with pytest.raises(ValueError):
        TorchDaNet(load_config(ENCODER_TYPE="bilstm-orig",
                               TRAIN_ESTIMATOR_METHOD="anchor",
                               INFER_ESTIMATOR_METHOD="truth-weighted"))


def test_torch_train_loss_dropout(fresh_hparams, monkeypatch):
    """DROPOUT_KEEP_PROB < 1 drops in train_loss only, reproducibly from
    the generator; keep 1 and valid_metrics see no dropout."""
    jm, jp, tm = _pair(fresh_hparams, monkeypatch)
    tp = weights.from_jax(jax.device_get(jp))
    batch = _t(_src_ri(32))
    full = tm.train_loss(tp, batch, torch.Generator().manual_seed(0))[0]
    _close(full, jm.train_loss(jp, jnp.asarray(_src_ri(32)))[0])
    tm.hp.DROPOUT_KEEP_PROB = 0.5
    a = tm.train_loss(tp, batch, torch.Generator().manual_seed(1))[0]
    b = tm.train_loss(tp, batch, torch.Generator().manual_seed(1))[0]
    assert torch.isfinite(a) and float(a) == float(b)
    assert float(a) != float(full)
    v = tm.valid_metrics(tp, batch)["loss"]
    tm.hp.DROPOUT_KEEP_PROB = 1.0
    assert float(v) == float(tm.valid_metrics(tp, batch)["loss"])


@pytest.mark.parametrize("key,value", [
    ("GRAD_ACCUM", 2), ("EMA_DECAY", 0.99), ("NAN_CHECKS", True),
    ("MESH_DATA", 2), ("REMAT", True), ("VALID_CRASH_FACTOR", 1.5)])
def test_torch_trainer_refuses_unported(fresh_hparams, key, value):
    """The options still to port raise NotImplementedError when the
    Trainer is built; the ported ones (GRAD_ACCUM, EMA_DECAY, NAN_CHECKS,
    REMAT, VALID_CRASH_FACTOR) build."""
    hp = load_config(ENCODER_TYPE="bilstm-orig", **{key: value})
    if key in ("GRAD_ACCUM", "EMA_DECAY", "NAN_CHECKS", "REMAT",
               "VALID_CRASH_FACTOR"):
        assert Trainer(TorchDaNet(hp), hp, "cpu").hp is hp
        return
    with pytest.raises(NotImplementedError):
        Trainer(TorchDaNet(hp), hp, "cpu")


@pytest.mark.parametrize("keys", [
    {"TRAIN_LOSS_TYPE": "pit-l1"},
    {"DC_LOSS_WEIGHT": 0.1, "DC_WEIGHT_TYPE": "log"}])
def test_torch_train_loss_refuses_unknown_types(fresh_hparams, monkeypatch,
                                                keys):
    """An unknown TRAIN_LOSS_TYPE, or DC_WEIGHT_TYPE under
    DC_LOSS_WEIGHT > 0, raises ValueError in train_loss, as in the JAX
    package, and already when the Trainer is built."""
    jm, jp, tm = _pair(fresh_hparams, monkeypatch, **keys)
    batch = _src_ri(42)
    with pytest.raises(ValueError):
        jm.train_loss(jp, jnp.asarray(batch))
    with pytest.raises(ValueError):
        tm.train_loss(weights.from_jax(jax.device_get(jp)), _t(batch))
    with pytest.raises(ValueError):
        Trainer(tm, tm.hp, "cpu")


# ------------------------------------------------------------- data path
def test_torch_toy_data_and_prepare_batch_match_jax(fresh_hparams):
    """The toy stream from RandomState(s) equals the JAX toy stream after
    np.random.seed(s); the crop (same RandomState draws) and bucket pad
    match prepare_batch of the JAX trainer."""
    hp = load_config()
    ds = WhiteNoiseData(hp)
    ds.install_and_load()
    jds = JaxToy()
    jds.install_and_load()
    np.random.seed(7)
    ref = [x[0] for x in jds.epoch("train", 4)]
    out = [x[0] for x in ds.epoch("train", 4, rng=np.random.RandomState(7))]
    assert len(out) == len(ref) == 10
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    flat = ref[0][:, :100]
    a = prepare_batch(flat, 2, 2, max_len=50, bucket=32,
                      rng=np.random.RandomState(8))
    b = jax_prepare(flat, 2, 2, max_len=50, bucket=32,
                    rng=np.random.RandomState(8))
    assert a.shape == b.shape == (2, 2, 64, 129, 2)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        prepare_batch(flat, 2, 2, max_len=50)


def test_torch_train_cli_toy(fresh_hparams, tmp_path):
    """python -m danet_tpu_torch.train on the toy dataset and encoder
    (default.json): one epoch with its validation sweep, printed as the
    JAX CLI prints them (the metric files under a temporary
    SUMMARY_DIR), and its epoch checkpoint saved under saves/ in the
    working directory."""
    cfg = tmp_path / "logs.json"
    cfg.write_text(json.dumps({"SUMMARY_DIR": str(tmp_path / "logs")}))
    proc = subprocess.run(
        [sys.executable, "-m", "danet_tpu_torch.train", "-ds", "toy",
         "-ne", "1", "-bs", "2", "--device", "cpu", "-c", str(cfg)],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert os.path.isfile(str(tmp_path / "saves" / "UnnamedExperiment_e1"
                              / "state.npz")), proc.stdout
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    epoch = [ln for ln in lines if ln.startswith("Epoch 1/1 loss=")]
    valid = [ln for ln in lines if ln.startswith("Valid  1/1 SNR=")]
    assert epoch and valid, proc.stdout
    assert "LR=0.0003" in epoch[0]


# ------------------------------------------------------------ epoch loop
def _epoch_lines(out: str) -> list:
    """[(kind, epoch, {key: value})] of every 'Epoch i/N ...' and 'Valid
    i/N ...' line the train loop printed (the s/step figure dropped)."""
    rows = []
    for line in out.splitlines():
        parts = line.split()
        if not parts or parts[0] not in ("Epoch", "Valid"):
            continue
        kv = dict(p.split("=", 1) for p in parts[2:] if "=" in p)
        rows.append((parts[0], parts[1], {k: float(v) for k, v in kv.items()}))
    return rows


def _assert_epoch_lines_match(out, ref, n_epoch, valid=True):
    assert len(ref) == n_epoch * (2 if valid else 1), ref
    assert [r[:2] for r in out] == [r[:2] for r in ref]
    for (_, _, a), (_, _, b) in zip(out, ref):
        assert sorted(a) == sorted(b)
        for key in b:
            _close(a[key], b[key], atol=0.0, rtol=1e-5)


@pytest.mark.parametrize("decay", ["fixed", "adaptive", "cosine"])
def test_torch_epoch_loop_matches_jax(fresh_hparams, tmp_path, capsys,
                                      decay):
    """Trainer.train against the JAX loop: the toy encoder and dataset, 3
    epochs at B=2 and LR 1e-3 from the same weights under each LR policy
    (NUM_EPOCH_PER_LR_DECAY 1).  Every epoch's loss, SNR and LR and every
    validation line agree to 1e-5 relative."""
    from danet_tpu.parallel import make_mesh
    from danet_tpu.train.trainer import Trainer as JaxTrainer
    keys = dict(BATCH_SIZE=2, LR=1e-3, LR_DECAY_TYPE=decay,
                NUM_EPOCH_PER_LR_DECAY=1, SUMMARY_DIR=str(tmp_path / "logs"))
    fresh_hparams.load(keys)
    fresh_hparams.digest()
    jtr = JaxTrainer(JaxDaNet(), name="loop", save_dir=str(tmp_path),
                     mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    p0 = jax.device_get(jstate["params"])
    jds = JaxToy()
    jds.install_and_load()
    capsys.readouterr()
    jtr.train(3, jds, save_on_epoch=False, valid_on_epoch=True,
              state=jstate)
    ref = _epoch_lines(capsys.readouterr().out)

    hp = load_config(**keys)
    tr = Trainer(TorchDaNet(hp), hp, "cpu")
    ds = WhiteNoiseData(hp)
    ds.install_and_load()
    tr.train(3, ds, save_on_epoch=False, valid_on_epoch=True,
             state=tr.init_state(params=p0))
    out = _epoch_lines(capsys.readouterr().out)
    _assert_epoch_lines_match(out, ref, 3)


@pytest.mark.parametrize("dtype", ["int16", "bfloat16"])
def test_torch_epoch_loop_wave_wire_matches_jax(fresh_hparams, tmp_path,
                                                capsys, dtype):
    """The same on the wave wire: synth (5 batches, SMPRATE 4000),
    TRAIN_STEPS_PER_CALL 2 (two 2-step calls and a single step; JAX scans
    them in one call, the port's CPU runs them eagerly), METRICS_EVERY 3,
    crops of 32 frames, the int16 and the bfloat16 wires; 2 epochs, each
    line within 1e-5 relative."""
    from danet_tpu.data.synth import SyntheticTonesData as JaxSynth
    from danet_tpu.parallel import make_mesh
    from danet_tpu.train.trainer import Trainer as JaxTrainer
    from danet_tpu_torch.data.synth import SyntheticTonesData
    keys = dict(BATCH_SIZE=2, SMPRATE=4000, SYNTH_BATCHES=5, LR=1e-3,
                TRANSFER_DOMAIN="wave", TRANSFER_DTYPE=dtype,
                TRAIN_STEPS_PER_CALL=2, METRICS_EVERY=3, MAX_TRAIN_LEN=32,
                LR_DECAY_TYPE="fixed", NUM_EPOCH_PER_LR_DECAY=1,
                SUMMARY_DIR=str(tmp_path / "logs"))
    fresh_hparams.load(keys)
    fresh_hparams.digest()
    jtr = JaxTrainer(JaxDaNet(), name="waveloop", save_dir=str(tmp_path),
                     mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    p0 = jax.device_get(jstate["params"])
    jds = JaxSynth()
    jds.install_and_load()
    capsys.readouterr()
    jtr.train(2, jds, save_on_epoch=False, valid_on_epoch=True,
              state=jstate)
    ref = _epoch_lines(capsys.readouterr().out)

    hp = load_config(**keys)
    tr = Trainer(TorchDaNet(hp), hp, "cpu")
    ds = SyntheticTonesData(hp)
    ds.install_and_load()
    state = tr.train(2, ds, save_on_epoch=False, valid_on_epoch=True,
                     state=tr.init_state(params=p0))
    out = _epoch_lines(capsys.readouterr().out)
    assert state["step"] == 10
    _assert_epoch_lines_match(out, ref, 2)
