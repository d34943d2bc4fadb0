"""PyTorch port, data and tensor parallelism (``danet_tpu_torch/parallel``)
against the JAX package's sharded values on the CPU.

The port's mesh runs as real processes: ``parallel/smoke.py`` starts 4
(and 2) gloo ranks on a free localhost port, each running several cases,
and writes each rank's results; the JAX side runs in this process on the
conftest's 8-device CPU mesh (``make_mesh(4, 1)``, ``make_mesh(2, 2)``),
with JAX's parameters carried across (``weights.save_npz``) and numpy-
seeded inputs.  Narrow widths: bilstm-orig with HDIM 16 and 2 layers
(HDIM and N_LAYERS patched on BOTH packages' encoder classes, in the ranks
through the spec's ``dims``), B=8 (6 where the batch does not divide over
data x model), T=16.  Tolerances are JAX's own (tests/test_parallel.py):
the loss at rtol 1e-5 under DP and 1e-4 under TP, gradients at atol 1e-5 /
rtol 1e-4, the BiLSTM's TP route at rtol 1e-5 / atol 5e-5; a full step
with Adam at the gradient bar of the port's training tests (2e-5 atol,
1e-4 rtol).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import danet_tpu.models.encoders as jenc  # noqa: E402
from danet_tpu.hparams import hparams as jhp  # noqa: E402
from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
from danet_tpu.ops import rnn as jrnn  # noqa: E402
from danet_tpu.parallel import batch_sharding  # noqa: E402
from danet_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from danet_tpu.parallel import param_pspecs as jax_pspecs  # noqa: E402
from danet_tpu.parallel import shard_params as jax_shard  # noqa: E402
from danet_tpu.parallel import sharding as jsharding  # noqa: E402
import danet_tpu_torch.models.encoders as tenc  # noqa: E402
from danet_tpu_torch import serve, weights  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402
from danet_tpu_torch.ops import rnn as trnn  # noqa: E402
from danet_tpu_torch.parallel import sharding, smoke  # noqa: E402
from danet_tpu_torch.train import Trainer  # noqa: E402
from danet_tpu_torch.weights import leaf_names, leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = [16, 2]
BILSTM = {"ENCODER_TYPE": "bilstm-orig", "BATCH_SIZE": 8}
ATTN = {"ENCODER_TYPE": "attn-v1", "BATCH_SIZE": 8, "ATTN_DIM": 32,
        "ATTN_HEADS": 2, "ATTN_LAYERS": 1}
TASNET = {"MODEL_TYPE": "tasnet-v1", "BATCH_SIZE": 4, "TASNET_FILTERS": 64,
          "TASNET_BOTTLENECK": 32, "TASNET_HIDDEN": 48, "TASNET_BLOCKS": 3,
          "TASNET_REPEATS": 2}
# clip-norm active (the global norm of the slices), EMA, two microbatches
OPTIONS = {"GRAD_CLIP_NORM": 0.05, "EMA_DECAY": 0.9, "GRAD_ACCUM": 2}
GRAD = dict(atol=1e-5, rtol=1e-4)
STEP = dict(atol=2e-5, rtol=1e-4)
TOY = {"BATCH_SIZE": 8, "MAX_TRAIN_LEN": 32, "TIME_BUCKET": 32,
       "LR_DECAY_TYPE": "adaptive", "NUM_EPOCH_PER_LR_DECAY": 1}


def _src(seed, b, t=16):
    rs = np.random.RandomState(seed)
    return rs.randn(b, 2, t, 129, 2).astype(np.float32)


def _flat(tree) -> dict:
    return dict(zip(leaf_names(tree), (np.asarray(v) for v in leaves(tree))))


def _rank(res, r, case):
    pre = case + "/"
    return {k[len(pre):]: v for k, v in res[r].items() if k.startswith(pre)}


def _whole(d, what):
    pre = what + "/"
    return {k[len(pre):]: v for k, v in d.items() if k.startswith(pre)}


def _jax_model(keys, dims=None):
    """A JAX DaNet of default.json + ``keys`` (the caller restores the
    singleton and the encoder classes)."""
    jhp.load_json(os.path.join(REPO, "default.json"))
    jhp.load(keys)
    jhp.digest()
    if dims:
        jcls = {"bilstm-orig": jenc.BiLstmEncoder}[keys["ENCODER_TYPE"]]
        jcls.HDIM, jcls.N_LAYERS = dims
    return JaxDaNet()


def _one_process(keys, params, src, dims=None, adam=False):
    """The port's one-process values: (loss, grads) and, with ``adam``,
    the parameters after one train step (and the moments)."""
    case = {"keys": keys, "dims": dims}
    hp, model = smoke.build(case)
    tr = Trainer(model, hp, "cpu")
    st = tr.init_state(torch.Generator().manual_seed(0),
                       params=weights.load_npz(params) if params else None)
    m, g = tr.loss_and_grads(st["params"], tr.ingest(src), None)
    out = {"loss": float(m["loss"]),
           "grads": dict(zip(leaf_names(st["params"]),
                             (t.numpy() for t in g)))}
    if adam:
        tr.train_step(st, src)
        out["params"] = {n: t.detach().numpy() for n, t in zip(
            leaf_names(st["params"]), leaves(st["params"]))}
    return out


@pytest.fixture(scope="module")
def mesh4(tmp_path_factory):
    """The 4-rank spawn (DP, TP, the BiLSTM's TP route, attn-v1, the step
    options) and the JAX package's values for the same inputs."""
    d = tmp_path_factory.mktemp("mesh4")
    saved = dict(jhp.__dict__)
    dims0 = (jenc.BiLstmEncoder.HDIM, jenc.BiLstmEncoder.N_LAYERS)
    tdims0 = (tenc.BiLstmEncoder.HDIM, tenc.BiLstmEncoder.N_LAYERS)
    try:
        jm = _jax_model(BILSTM, DIMS)
        jp = jm.init(jax.random.PRNGKey(0))
        weights.save_npz(str(d / "p.npz"), jax.device_get(jp))
        src = _src(0, 8)
        np.savez(d / "b.npz", src=src)
        np.savez(d / "b6.npz", src=src[:6])

        def loss_fn(p, x):
            return jm.train_loss(p, x, None)[0]

        vg = jax.jit(jax.value_and_grad(loss_fn))
        jax_vals = {}
        for name, (nd, nm), x in (("dp", (4, 1), src), ("tp", (2, 2), src),
                                  ("tp6", (2, 2), src[:6])):
            mesh = jax_make_mesh(nd, nm)
            l, g = vg(jax_shard(mesh, jp),
                      jax.device_put(x, batch_sharding(mesh)))
            jax_vals[name] = (float(l), _flat(jax.device_get(g)))
        # one BiLSTM layer for the TP route: B=8, T=12, F=10, H=16
        layer = jrnn.bilstm_init(jax.random.PRNGKey(0), 10, 16)
        weights.save_npz(str(d / "layer.npz"), jax.device_get(layer))
        np.savez(d / "x.npz", x=np.random.RandomState(0).randn(
            8, 12, 10).astype(np.float32))
        # attn-v1 (no kernel route of its own: the generic mesh path)
        tenc.BiLstmEncoder.HDIM, tenc.BiLstmEncoder.N_LAYERS = DIMS
        _, am = smoke.build({"keys": ATTN})
        weights.save_npz(str(d / "pa.npz"), am.init(
            torch.Generator().manual_seed(3)))
    finally:
        jhp.__dict__.clear()
        jhp.__dict__.update(saved)
        jenc.BiLstmEncoder.HDIM, jenc.BiLstmEncoder.N_LAYERS = dims0
    cases = [
        {"name": "dp", "kind": "step", "adam": True,
         "keys": dict(BILSTM, MESH_DATA=4, MESH_MODEL=1)},
        {"name": "tp", "kind": "step", "adam": True,
         "keys": dict(BILSTM, MESH_DATA=2, MESH_MODEL=2)},
        {"name": "tp6", "kind": "step", "batch": "b6.npz",
         "keys": dict(BILSTM, BATCH_SIZE=6, MESH_DATA=2, MESH_MODEL=2)},
        {"name": "options", "kind": "step", "adam": True,
         "keys": dict(BILSTM, MESH_DATA=2, MESH_MODEL=2, **OPTIONS)},
        {"name": "attn", "kind": "step", "adam": True, "params": "pa.npz",
         "keys": dict(ATTN, MESH_DATA=2, MESH_MODEL=2)},
        {"name": "apply_tp", "kind": "bilstm_tp", "params": "layer.npz",
         "x": "x.npz", "backend": "xla",
         "keys": {"BATCH_SIZE": 8, "MESH_DATA": 2, "MESH_MODEL": 2}},
    ]
    for c in cases:
        c.setdefault("dims", DIMS)
        c.setdefault("params", "p.npz")
        c.setdefault("batch", "b.npz")
    with open(d / "spec.json", "w") as f:
        json.dump({"cases": cases}, f)
    try:
        smoke.launch(str(d / "spec.json"), str(d / "out"), 4, timeout=240)
        one = {
            "dp": _one_process(BILSTM, str(d / "p.npz"), src, DIMS, True),
            "tp6": _one_process(dict(BILSTM, BATCH_SIZE=6),
                                str(d / "p.npz"), src[:6], DIMS),
            "options": _one_process(dict(BILSTM, **OPTIONS),
                                    str(d / "p.npz"), src, DIMS, True),
            "attn": _one_process(ATTN, str(d / "pa.npz"), src, None, True)}
    finally:
        tenc.BiLstmEncoder.HDIM, tenc.BiLstmEncoder.N_LAYERS = tdims0
    one["tp"] = one["dp"]
    return {"dir": d, "res": smoke.load_results(str(d / "out"), 4),
            "jax": jax_vals, "one": one, "layer": _flat(jax.device_get(
                layer)), "x": np.load(d / "x.npz")["x"]}


def _grads_close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("case", ["dp", "tp", "tp6"])
def test_torch_mesh_matches_jax_sharded(mesh4, case):
    """DP over 4 gloo ranks and TP at 2 x 2 (rows over data x model, and
    at B=6, which divides over data only: each 'model' group shares its
    rows): every rank's loss and gradients equal JAX's on the same mesh
    shape (loss rtol 1e-5 under DP, 1e-4 under TP; gradients atol 1e-5,
    rtol 1e-4) and the port's one-process values."""
    jl, jg = mesh4["jax"][case]
    one = mesh4["one"][case]
    rows = set()
    for r in range(4):
        d = _rank(mesh4["res"], r, case)
        rows.add(tuple(d["rows"]))
        np.testing.assert_allclose(float(d["loss"]), jl,
                                   rtol=1e-5 if case == "dp" else 1e-4)
        np.testing.assert_allclose(float(d["loss"]), one["loss"], rtol=1e-5)
        _grads_close(_whole(d, "grads"), jg, **GRAD)
        _grads_close(_whole(d, "grads"), one["grads"], **GRAD)
    assert len(rows) == (2 if case == "tp6" else 4)


@pytest.mark.parametrize("case", ["dp", "tp", "options", "attn"])
def test_torch_mesh_step_matches_one_process(mesh4, case):
    """A full step with Adam on the mesh (4 x 1, 2 x 2; with
    GRAD_CLIP_NORM's global norm over the slices, EMA_DECAY and GRAD_ACCUM
    2; attn-v1, whose leaves shard by the same rules) equals the
    one-process step, and every rank holds the same whole parameters."""
    one = mesh4["one"][case]
    first = None
    for r in range(4):
        got = _whole(_rank(mesh4["res"], r, case), "params")
        _grads_close(got, one["params"], **STEP)
        if first is None:
            first = got
        for k in got:
            np.testing.assert_array_equal(got[k], first[k], err_msg=k)


def test_torch_mesh_shards_at_rest(mesh4):
    """A rank holds only its slice of each leaf that JAX's rules shard on
    'model' (and of that leaf's Adam moments): at 2 x 2 its bytes are the
    replicated leaves plus half of the sharded ones."""
    hp, model = smoke.build({"keys": BILSTM})
    saved = (tenc.BiLstmEncoder.HDIM, tenc.BiLstmEncoder.N_LAYERS)
    tenc.BiLstmEncoder.HDIM, tenc.BiLstmEncoder.N_LAYERS = DIMS
    try:
        params = model.init(torch.Generator().manual_seed(0))
    finally:
        tenc.BiLstmEncoder.HDIM, tenc.BiLstmEncoder.N_LAYERS = saved
    mesh = sharding.make_mesh(2, 2, devices=range(4))
    axes = sharding.model_axes(params, mesh)
    full = sum(p.numel() for p in leaves(params))
    sharded = sum(p.numel() for p, a in zip(leaves(params), axes)
                  if a is not None)
    assert sharded > 0.9 * full
    for r in range(4):
        assert int(_rank(mesh4["res"], r, "dp")["bytes"]) == 3 * 4 * full
        assert int(_rank(mesh4["res"], r, "tp")["bytes"]) == \
            3 * 4 * (full - sharded // 2)


def test_torch_bilstm_apply_tp_matches_plain(mesh4):
    """``rnn.bilstm_apply_tp`` per rank (the layer's slices gathered over
    the 'model' group exactly, the rank's rows of the batch over data x
    model) equals the plain scan on the whole batch, forward and the
    gradients of sum(sin(y)) summed over the ranks (rtol 1e-5, atol
    5e-5), as JAX's test of its own TP route."""
    layer = weights.from_jax(weights.load_npz(
        str(mesh4["dir"] / "layer.npz")))
    ps = [p.clone().requires_grad_(True) for p in leaves(layer)]
    tree = sharding.nest(leaf_names(layer), ps)
    y = trnn.bilstm_apply(tree, torch.from_numpy(mesh4["x"]), "tanh",
                          backend="xla")
    grads = torch.autograd.grad(torch.sum(torch.sin(y)), ps)
    ys = []
    for r in range(4):
        d = _rank(mesh4["res"], r, "apply_tp")
        assert bool(d["gathered_exact"])
        a, b = (int(v) for v in d["rows"])
        np.testing.assert_allclose(d["y"], y.detach().numpy()[a:b],
                                   rtol=1e-5, atol=5e-5)
        ys.append((a, d["y"]))
        _grads_close(_whole(d, "grads"), dict(zip(
            leaf_names(layer), (g.numpy() for g in grads))),
            rtol=1e-5, atol=5e-5)
    assert [a for a, _ in sorted(ys)] == [0, 2, 4, 6]


def test_torch_bilstm_apply_tp_refuses_a_slice():
    """``bilstm_apply_tp`` takes the full weights: one rank's slice of
    them raises ValueError."""
    layer = trnn.bilstm_init(torch.Generator().manual_seed(0), 10, 16)
    mesh = sharding.make_mesh(1, 2, devices=range(2))
    part = sharding.shard_params(mesh, layer)
    with pytest.raises(ValueError, match="full weights"):
        trnn.bilstm_apply_tp(part, torch.zeros(2, 3, 10), mesh)


# ---------------------------------------------------------------- 2 ranks
@pytest.fixture(scope="module")
def mesh2(tmp_path_factory):
    """The 2-rank spawn: two Trainer epochs on toy data from a
    one-process checkpoint, lstm-orig / gru-v1 / tasnet-v1 steps under
    MESH_DATA=2, the ranks' dropout generators."""
    d = tmp_path_factory.mktemp("mesh2")
    hp, model = smoke.build({"keys": TOY})
    tr = Trainer(model, hp, "cpu", save_dir=str(d))
    st = tr.init_state(torch.Generator().manual_seed(5))
    tr.save_params(st, str(d / "init"))
    src = _src(1, 8)
    np.savez(d / "b.npz", src=src)
    np.savez(d / "b4.npz", src=src[:4])
    cases = [
        {"name": "train", "kind": "train", "epochs": 2, "keys": TOY,
         "init": str(d / "init")},
        {"name": "dropout", "kind": "dropout",
         "keys": {"MESH_DATA": 2, "BATCH_SIZE": 8}},
        {"name": "preempt", "kind": "train", "epochs": 2, "keys": TOY,
         "signal_at": [1, 3]},
    ]
    for enc in ("lstm-orig", "gru-v1"):
        cases.append({"name": enc, "kind": "step", "adam": True,
                      "dims": DIMS, "batch": "b.npz",
                      "keys": {"ENCODER_TYPE": enc, "BATCH_SIZE": 8,
                               "MESH_DATA": 2}})
    cases.append({"name": "tasnet-v1", "kind": "step", "adam": True,
                  "batch": "b4.npz", "keys": dict(TASNET, MESH_DATA=2)})
    with open(d / "spec.json", "w") as f:
        json.dump({"cases": cases}, f)
    smoke.launch(str(d / "spec.json"), str(d / "out"), 2, timeout=240)
    return {"dir": d, "res": smoke.load_results(str(d / "out"), 2),
            "src": src}


def test_torch_two_process_training(mesh2):
    """Two processes train 2 epochs on toy data (the default mesh: 2 of
    B=8 over 'data'), from a one-process checkpoint that each loads bit
    for bit, with the adaptive LR: both print the same per-step and valid
    losses (reduced: a rank that kept its own rows' numbers would
    diverge), end with the same LR, step, epoch and parameters (checksum
    rtol 1e-6); the mesh's last checkpoint then loads in one process bit
    for bit and trains on."""
    with np.load(str(mesh2["dir"] / "init" / "state.npz")) as f:
        init = {k[len("params/"):]: f[k] for k in f.files
                if k.startswith("params/")}
    ranks = [_rank(mesh2["res"], r, "train") for r in range(2)]
    for d in ranks:
        loaded = _whole(d, "loaded")
        for k in init:
            np.testing.assert_array_equal(loaded[k], init[k], err_msg=k)
        assert int(d["epoch"]) == 2 and int(d["step"]) == 20
        assert np.all(np.isfinite(d["train_loss"]))
    a, b = ranks
    np.testing.assert_array_equal(a["train_loss"], b["train_loss"])
    np.testing.assert_array_equal(a["valid_loss"], b["valid_loss"])
    np.testing.assert_allclose(float(a["checksum"]), float(b["checksum"]),
                               rtol=1e-6)
    assert float(a["lr"]) == float(b["lr"])
    for k, v in _whole(a, "params").items():
        np.testing.assert_array_equal(v, _whole(b, "params")[k])

    hp, model = smoke.build({"keys": TOY})
    tr = Trainer(model, hp, "cpu", name="resumed",
                 save_dir=str(mesh2["dir"] / "one"))
    st = tr.load_params(tr.init_state(torch.Generator().manual_seed(9)),
                        str(mesh2["dir"] / "out" / "saves" / "train_e2"))
    for n, p in zip(leaf_names(st["params"]), leaves(st["params"])):
        np.testing.assert_array_equal(p.detach().numpy(),
                                      _whole(a, "params")[n], err_msg=n)
    assert st["epoch"] == 2 and tr.get_learn_rate(st) == float(a["lr"])
    from danet_tpu_torch.data.dataset import WhiteNoiseData
    ds = WhiteNoiseData(hp)
    ds.install_and_load()
    st = tr.train(1, ds, save_on_epoch=False, valid_on_epoch=False,
                  state=st)
    assert st["epoch"] == 3
    assert all(torch.isfinite(p).all() for p in leaves(st["params"]))


def test_torch_preemption_stops_every_rank(mesh2):
    """SIGTERM to one rank (rank 1, after step 3) stops both at the same
    step boundary: both return at step 3 of epoch 1, and the collective
    save wrote <name>_preempt, whose step is 3."""
    for r in range(2):
        d = _rank(mesh2["res"], r, "preempt")
        assert int(d["step"]) == 3 and int(d["epoch"]) == 0
    path = mesh2["dir"] / "out" / "saves" / "preempt_preempt" / "state.npz"
    with np.load(str(path)) as f:
        assert int(f["step"]) == 3


def test_torch_multihost_single_process():
    """Without a launcher's environment ``initialize`` joins nothing and
    returns False, and a process loads the whole batch, as JAX's."""
    from danet_tpu_torch.parallel import multihost
    assert multihost.host_batch_slice(32) == slice(0, 32)
    assert multihost.initialize("cpu") is False


@pytest.mark.parametrize("case,keys,dims", [
    ("lstm-orig", {"ENCODER_TYPE": "lstm-orig", "BATCH_SIZE": 8}, DIMS),
    ("gru-v1", {"ENCODER_TYPE": "gru-v1", "BATCH_SIZE": 8}, DIMS),
    ("tasnet-v1", TASNET, None)])
def test_torch_data_parallel_models(mesh2, case, keys, dims):
    """lstm-orig, gru-v1 and tasnet-v1 under MESH_DATA=2: the loss and
    gradients equal the one-process values (rtol 1e-5; atol 1e-5, rtol
    1e-4) and so does one step with Adam (2e-5 / 1e-4)."""
    src = mesh2["src"][:4] if case == "tasnet-v1" else mesh2["src"]
    cls = {"lstm-orig": tenc.LstmEncoder, "gru-v1": tenc.GruEncoder}.get(
        case)
    saved = (cls.HDIM, cls.N_LAYERS) if cls else None
    try:
        one = _one_process(keys, None, src, dims, adam=True)
    finally:
        if cls:
            cls.HDIM, cls.N_LAYERS = saved
    for r in range(2):
        d = _rank(mesh2["res"], r, case)
        np.testing.assert_allclose(float(d["loss"]), one["loss"], rtol=1e-5)
        _grads_close(_whole(d, "grads"), one["grads"], **GRAD)
        _grads_close(_whole(d, "params"), one["params"], **STEP)


def test_torch_ranks_draw_their_own_dropout(mesh2):
    """Each row slice draws dropout from a generator of its own: the
    first rank's seed is the one-process Trainer's, the second's is
    another, and their masks differ."""
    a, b = (_rank(mesh2["res"], r, "dropout") for r in range(2))
    hp, model = smoke.build({"keys": {"BATCH_SIZE": 8}})
    one = Trainer(model, hp, "cpu").init_state(
        torch.Generator().manual_seed(0))["generator"]
    assert int(a["seed"]) == one.initial_seed() != int(b["seed"])
    assert not np.array_equal(a["mask"], b["mask"])


# ---------------------------------------------------------------- in process
@pytest.mark.parametrize("factors", [
    (None, None), (2, None), (None, 2), (4, 2), (2, 2), (1, 8), (8, 1),
    (3, None), (2, 2, 2, 1, 1), (2, 1, 1, 2, 1), (2, 1, 1, 1, 4),
    (3, 3), (16, 1)])
def test_torch_make_mesh_matches_jax(factors):
    """make_mesh's factor table over 8 devices (None filled in, explicit
    factors on a prefix, the pipe/expert/seq axes) and its
    MeshUnavailableError text equal JAX's."""
    n_data, n_model = factors[:2]
    extra = dict(zip(("n_pipe", "n_expert", "n_seq"), factors[2:]))
    try:
        want = jax_make_mesh(n_data, n_model, **extra)
    except jsharding.MeshUnavailableError as e:
        with pytest.raises(sharding.MeshUnavailableError) as got:
            sharding.make_mesh(n_data, n_model, devices=range(8), **extra)
        assert str(got.value) == str(e)
        return
    got = sharding.make_mesh(n_data, n_model, devices=range(8), **extra)
    assert got.shape == dict(want.shape)
    np.testing.assert_array_equal(
        got.devices, np.vectorize(lambda dev: dev.id)(want.devices))


@pytest.mark.parametrize("keys", [
    {"BATCH_SIZE": 12}, {"BATCH_SIZE": 9}, {"BATCH_SIZE": 32},
    {"MESH_DATA": 2, "MESH_PIPE": 4}, {"MESH_DATA": 4, "MESH_EXPERT": 2},
    {"MESH_DATA": 2, "MESH_SEQ": 4}, {"MESH_DATA": 4, "MESH_MODEL": 2}])
def test_torch_mesh_from_hparams_matches_jax(fresh_hparams, keys):
    """mesh_from_hparams over 8 devices: the configured axes, and the
    all-1 default's largest divisor of the batch (12 -> 6, 9 -> 3), as
    JAX's."""
    fresh_hparams.load(dict(keys, MESH_MODEL=keys.get("MESH_MODEL", 0),
                            MESH_DATA=keys.get("MESH_DATA", 0)))
    want = jsharding.mesh_from_hparams(fresh_hparams)
    got = sharding.mesh_from_hparams(load_config(**keys), devices=range(8))
    assert got.shape == dict(want.shape)


@pytest.mark.parametrize("encoder", ["bilstm-orig", "attn-v1", "moe-v1"])
def test_torch_param_pspecs_match_jax(fresh_hparams, encoder):
    """The partition specs of the port's own parameter tree equal JAX's
    leaf by leaf at n_model 1, 2, 4 and 8, at full width: h=300 and the
    2580-wide head shard at 2 and 4 and fall back to replicated at 8."""
    keys = {"ENCODER_TYPE": encoder}
    fresh_hparams.load(keys)
    fresh_hparams.digest()
    jp = JaxDaNet().init(jax.random.PRNGKey(0))
    tp = TorchDaNet(load_config(**keys)).init(torch.Generator())
    assert sorted(leaf_names(tp)) == sorted(leaf_names(jp))
    for n in (1, 2, 4, 8):
        want = jax_pspecs(jp, jax_make_mesh(8 // n, n))
        want = dict(zip(leaf_names(want), (tuple(v) for v in leaves(want))))
        got = sharding.param_pspecs(
            tp, sharding.make_mesh(8 // n, n, devices=range(8)))
        assert dict(zip(leaf_names(got), leaves(got))) == want, n
    if encoder == "bilstm-orig":
        specs = sharding.param_pspecs(tp, sharding.make_mesh(
            1, 8, devices=range(8)))
        assert specs["encoder"]["lstm0"]["fwd"]["wx"] == ()
        assert specs["encoder"]["output"]["w"] == ()


def test_torch_route_mesh_only_unavailable_routes_dense(monkeypatch):
    """_route_mesh: a mesh that cannot be built on the processes at hand
    (MeshUnavailableError: MESH_MODEL 2 in one process) routes dense; any
    other error propagates; a registered mesh with the axis routes."""
    hp = load_config(ENCODER_TYPE="bilstm-orig", MESH_MODEL=2)
    assert tenc._route_mesh(hp, "model", 2) is None
    enc = TorchDaNet(hp).encoder
    assert enc._tp_kernel_mesh() is None

    def boom(hp=None):
        raise ValueError("broken mesh config")
    monkeypatch.setattr(sharding, "active_mesh", boom)
    with pytest.raises(ValueError, match="broken"):
        tenc._route_mesh(hp, "model", 2)
    mesh = sharding.make_mesh(1, 2, devices=range(2))
    monkeypatch.setattr(sharding, "active_mesh", lambda hp=None: mesh)
    assert enc._tp_kernel_mesh() is mesh
    monkeypatch.setattr(enc.hp, "LSTM_BACKEND", "xla")
    assert enc._tp_kernel_mesh() is None


def test_torch_mesh_refusals(fresh_hparams):
    """moe-v1's routed training (MOE_TOP_K > 0) on a data x model mesh
    builds (its capacity counts the global batch's tokens,
    ``expert.moe_mlp_topk``'s mesh), and so does its soft mixture, and
    under MESH_SEQ (sequence-parallel attention); tcn-v1 builds under
    MESH_SEQ (its halo-exchanging TCN stack), its blocks owned by 'seq';
    a mesh without the configured 'model' or 'seq' axis is refused by the
    Trainer."""
    moe = {"ENCODER_TYPE": "moe-v1", "MESH_DATA": 2, "ATTN_DIM": 32,
           "ATTN_HEADS": 2, "ATTN_LAYERS": 1}
    TorchDaNet(load_config(**dict(moe, MOE_TOP_K=2, MESH_MODEL=2)))
    TorchDaNet(load_config(**moe))
    TorchDaNet(load_config(**dict(moe, MESH_SEQ=2)))
    tcn = TorchDaNet(load_config(ENCODER_TYPE="tcn-v1", MESH_SEQ=2))
    assert tcn.seq_leaves() == r"encoder/(bottleneck|block\d+)/"
    for key, axis in (("MESH_MODEL", "model"), ("MESH_SEQ", "seq")):
        hp = load_config(ENCODER_TYPE="bilstm-orig", **{key: 2})
        with pytest.raises(ValueError, match="no matching '%s' axis" % axis):
            Trainer(TorchDaNet(hp), hp, "cpu",
                    mesh=sharding.make_mesh(2, 1, devices=range(2)))


def test_torch_serve_drops_mesh_keys(tmp_path, monkeypatch):
    """A model trained under configs/multichip.json (MESH_DATA 4 x
    MESH_MODEL 2) serves densely on one device: ``load_model`` and the
    live Separator drop the MESH_* keys, and its answer equals that of the
    same weights without them."""
    for cls in (tenc.BiLstmEncoder,):
        monkeypatch.setattr(cls, "HDIM", 8)
        monkeypatch.setattr(cls, "N_LAYERS", 2)
    cfg = os.path.join(REPO, "configs", "multichip.json")
    narrow = tmp_path / "narrow.json"
    narrow.write_text(json.dumps({"COMPUTE_DTYPE": "float32"}))
    hp = load_config(cfg, str(narrow))
    assert hp.MESH_DATA == 4 and hp.MESH_MODEL == 2
    dense = serve.dense_config(hp)
    assert (dense.MESH_DATA, dense.MESH_MODEL, hp.MESH_MODEL) == (1, 1, 2)
    params = TorchDaNet(dense).init(torch.Generator().manual_seed(0))
    weights.save_npz(str(tmp_path / "w.npz"), params)
    model, loaded = serve.load_model(str(tmp_path / "w.npz"),
                                     [cfg, str(narrow)])
    assert model.hp.MESH_MODEL == 1
    wav = np.random.RandomState(0).randn(4096).astype(np.float32) * 0.1
    got = serve.Separator(model, loaded, "cpu").separate(wav)
    again = serve.Separator(TorchDaNet(hp), loaded, "cpu")
    assert again.hp.MESH_MODEL == 1
    np.testing.assert_array_equal(again.separate(wav), got)
    want = serve.Separator(TorchDaNet(dense), loaded, "cpu").separate(wav)
    np.testing.assert_array_equal(got, want)
