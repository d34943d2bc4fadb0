"""PyTorch port, pipeline and expert parallelism (``parallel/pipeline.py``,
``parallel/expert.py``) and the 8-rank meshes, against the JAX package's
values on the CPU.

The port's mesh runs as real processes: ``parallel/smoke.py`` starts 4
and then 8 gloo ranks, each running several cases; the JAX side runs in
this process on the conftest's 8 CPU devices, with JAX's parameters
carried across (``weights.save_npz``) and numpy-seeded inputs.  Shapes and
tolerances are JAX's own (``tests/test_parallel.py``): the pipelined stack
at B=8, T=12, F=10, H=7 (4 stages x 4 microbatches; 2 stages of 2 layers
x 2), atol 2e-5 / rtol 1e-4 forward and 5e-5 / 1e-4 for gradients; the
soft EP MLP at d=16, ff=32, E=4, atol 1e-5 / rtol 1e-4; the routed one at
B=2, T=32, D=12, E=4, FF=24, k=1 / cf 1.0 and k=2 / cf 1.25, atol 1e-5
forward and 1e-4 for gradients.  Trainer steps hold the loss and gradients
against JAX's jitted ``train_loss`` on the same mesh shape (rtol 1e-4;
atol 1e-5, rtol 1e-4) and the updated parameters against the port's
one-process step (atol 2e-5, rtol 1e-4).  bilstm-orig runs at HDIM 72
(JAX asserts the inter-stage width 2H covers the 129 features), 4 layers;
moe-v1 at ATTN_DIM 32, 2 blocks, 4 experts.  configs/pipeline.json and
configs/moe-ep.json run as written at 8 ranks (bfloat16) at those widths,
against the port's one-process bfloat16 step at chip_smoke's phase 27
bound; configs/multichip.json's mesh (4 x 2) and 1 x 8 in float32 at
HDIM 12, which an 8-wide 'model' axis does not divide.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

import danet_tpu.models.encoders as jenc  # noqa: E402
from danet_tpu.hparams import hparams as jhp  # noqa: E402
from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
from danet_tpu.ops import nn as jnn  # noqa: E402
from danet_tpu.ops import rnn as jrnn  # noqa: E402
from danet_tpu.parallel import batch_sharding, set_active_mesh  # noqa: E402
from danet_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from danet_tpu.parallel import shard_params as jax_shard  # noqa: E402
from danet_tpu.parallel import expert as jexpert  # noqa: E402
from danet_tpu.parallel import pipeline as jpipeline  # noqa: E402
from danet_tpu.parallel import sharding as jsharding  # noqa: E402
import danet_tpu_torch.models.encoders as tenc  # noqa: E402
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402
from danet_tpu_torch.parallel import expert as texpert  # noqa: E402
from danet_tpu_torch.parallel import pipeline as tpipeline  # noqa: E402
from danet_tpu_torch.parallel import sharding, smoke  # noqa: E402
from danet_tpu_torch.train import Trainer  # noqa: E402
from danet_tpu_torch.weights import leaf_names, leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STACK = dict(atol=2e-5, rtol=1e-4)
STACK_GRAD = dict(atol=5e-5, rtol=1e-4)
GRAD = dict(atol=1e-5, rtol=1e-4)
STEP = dict(atol=2e-5, rtol=1e-4)
PIPE_DIMS = [72, 4]
REG = {"REG_APPLY": True, "REG_TYPE": "L2", "REG_SCALE": 0.01}
BILSTM = {"ENCODER_TYPE": "bilstm-orig", "BATCH_SIZE": 8,
          "PIPE_MICROBATCHES": 4, "DROPOUT_KEEP_PROB": 1.0}
MOE = {"ENCODER_TYPE": "moe-v1", "ATTN_DIM": 32, "ATTN_LAYERS": 2,
       "ATTN_HEADS": 4, "MOE_EXPERTS": 4, "BATCH_SIZE": 4}
MC_DIMS = [12, 2]
MC_KEYS = {"COMPUTE_DTYPE": "float32"}
BF16_GRAD_REL, BF16_LOSS_REL = 2e-2, 1e-2


def _src(seed, b, t=16):
    return np.random.RandomState(seed).randn(b, 2, t, 129, 2).astype(
        np.float32)


def _flat(tree) -> dict:
    return dict(zip(leaf_names(tree), (np.asarray(v) for v in leaves(tree))))


def _rank(res, r, case):
    pre = case + "/"
    return {k[len(pre):]: v for k, v in res[r].items() if k.startswith(pre)}


def _whole(d, what):
    pre = what + "/"
    return {k[len(pre):]: v for k, v in d.items() if k.startswith(pre)}


def _close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


class _Narrow:
    """HDIM and N_LAYERS of both packages' bilstm-orig, restored on exit
    with the JAX hparams singleton and its active mesh."""

    def __init__(self, dims):
        self.dims = dims

    def __enter__(self):
        self.saved = dict(jhp.__dict__)
        self.j = (jenc.BiLstmEncoder.HDIM, jenc.BiLstmEncoder.N_LAYERS)
        self.t = (tenc.BiLstmEncoder.HDIM, tenc.BiLstmEncoder.N_LAYERS)
        if self.dims:
            jenc.BiLstmEncoder.HDIM, jenc.BiLstmEncoder.N_LAYERS = self.dims
            tenc.BiLstmEncoder.HDIM, tenc.BiLstmEncoder.N_LAYERS = self.dims
        return self

    def __exit__(self, *exc):
        jhp.__dict__.clear()
        jhp.__dict__.update(self.saved)
        jenc.BiLstmEncoder.HDIM, jenc.BiLstmEncoder.N_LAYERS = self.j
        tenc.BiLstmEncoder.HDIM, tenc.BiLstmEncoder.N_LAYERS = self.t
        set_active_mesh(None)


def _jax_hp(keys, configs=()):
    jhp.load_json(os.path.join(REPO, "default.json"))
    for c in configs:
        jhp.load_json(os.path.join(REPO, c))
    jhp.load(keys)
    jhp.digest()


def _jax_step_values(keys, params_np, src, mesh, configs=()):
    """JAX's (loss, gradients) of ``train_loss`` on ``mesh`` (the active
    mesh, which the pipe / expert routes read), sharded by its rules."""
    _jax_hp(keys, configs)
    set_active_mesh(mesh)
    jm = JaxDaNet()
    jp = jm.init(jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(
        lambda a, b: jnp.asarray(b, a.dtype), jp,
        _nest_like(jp, params_np))

    def loss_fn(p, x):
        return jm.train_loss(p, x, None)[0]

    vg = jax.jit(jax.value_and_grad(loss_fn))
    l, g = vg(jax_shard(mesh, jp), jax.device_put(src, batch_sharding(mesh)))
    return float(l), _flat(jax.device_get(g))


def _nest_like(tree, flat: dict):
    """``flat`` ({'a/b': array}) in the structure of the JAX tree."""
    return jax.tree_util.tree_map_with_path(
        lambda path, _: flat["/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path)],
        tree)


def _one_process(keys, params, src, configs=(), adam=True):
    """The port's one-process (loss, grads, params after one step)."""
    hp, model = smoke.build({"keys": keys, "configs": list(configs)})
    tr = Trainer(model, hp, "cpu")
    st = tr.init_state(torch.Generator().manual_seed(0),
                       params=weights.load_npz(params))
    m, g = tr.loss_and_grads(st["params"], tr.ingest(src), None)
    out = {"loss": float(m["loss"]),
           "grads": dict(zip(leaf_names(st["params"]),
                             (t.float().numpy() for t in g)))}
    if adam:
        tr.train_step(st, src)
        out["params"] = {n: t.detach().numpy() for n, t in zip(
            leaf_names(st["params"]), leaves(st["params"]))}
    return out


def _save_model(path, keys, dims=None, seed=0, configs=()):
    with _Narrow(dims):
        _, model = smoke.build({"keys": keys, "configs": list(configs)})
        params = model.init(torch.Generator().manual_seed(seed))
    weights.save_npz(str(path), params)
    return params


# ---------------------------------------------------------------- 4 ranks
@pytest.fixture(scope="module")
def pe4(tmp_path_factory):
    """The 4-rank spawn: the pipelined stack (4 x 4, 2 x 2 over data 2,
    and on stack_pipeline_params' stages), the EP MLPs, routed capacity
    over data shards, Trainer steps on expert, routed and pipe meshes,
    checkpoints both ways; and JAX's values for the same inputs."""
    d = tmp_path_factory.mktemp("pe4")
    jv = {}
    B, T, F, H = 8, 12, 10, 7
    layers = [jrnn.bilstm_init(jax.random.PRNGKey(i),
                               F if i == 0 else 2 * H, H) for i in range(4)]
    weights.save_npz(str(d / "layers.npz"), jax.device_get(
        {"lstm%d" % i: p for i, p in enumerate(layers)}))
    x = np.random.RandomState(0).randn(B, T, F).astype(np.float32)
    np.savez(d / "x.npz", x=x)

    def dense_loss(xx):
        y = xx
        for p in layers:
            y = jrnn.bilstm_apply(p, y, "tanh")
        return jnp.sum(jnp.sin(y))

    jv["dx"] = np.asarray(jax.jit(jax.grad(dense_loss))(jnp.asarray(x)))

    def pp_loss(ls, mesh, n_micro):
        return jnp.sum(jnp.sin(jpipeline.bilstm_stack_pipelined(
            ls, jnp.asarray(x), mesh, n_micro=n_micro)))

    for n_stages, n_micro in ((4, 4), (2, 2)):
        mesh = JaxMesh(np.asarray(jax.devices()[:n_stages]), ("pipe",))
        y = jpipeline.bilstm_stack_pipelined(layers, jnp.asarray(x), mesh,
                                             n_micro=n_micro)
        l, g = jax.jit(jax.value_and_grad(pp_loss), static_argnums=(1, 2))(
            layers, mesh, n_micro)
        jv["pipe%d" % n_stages] = (np.asarray(y), float(l), {
            "lstm%d/%s" % (i, k): v for i, lg in enumerate(g)
            for k, v in _flat(jax.device_get(lg)).items()})

    # the MoE MLPs
    d_, ff, e = 16, 32, 4
    k = jax.random.split(jax.random.PRNGKey(0), 3)
    soft = {"router": jnn.uniform_init(k[0], (d_, e), 0.1),
            "w_in": jnn.uniform_init(k[1], (e, d_, ff), 0.2),
            "w_out": jnn.uniform_init(k[2], (e, ff, d_), 0.2)}
    weights.save_npz(str(d / "soft.npz"), jax.device_get(soft))
    xs = np.random.RandomState(0).randn(2, 6, d_).astype(np.float32)
    np.savez(d / "xs.npz", x=xs)
    mesh4 = JaxMesh(np.asarray(jax.devices()[:4]), ("expert",))

    def values(f, p):
        """(f(p), the gradient of sum(f(p)^2)), jitted."""
        y, g = jax.jit(lambda p: (f(p), jax.grad(
            lambda q: jnp.sum(f(q) ** 2))(p)))(p)
        return np.asarray(y), _flat(jax.device_get(g))

    jv["soft"] = values(lambda p: jexpert.moe_mlp_ep(
        p, jnp.asarray(xs), mesh4), soft)
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    routed = {"router": jnn.uniform_init(ks[0], (12, 4), 0.5),
              "w_in": jnn.uniform_init(ks[1], (4, 12, 24), 0.3),
              "w_out": jnn.uniform_init(ks[2], (4, 24, 12), 0.3)}
    weights.save_npz(str(d / "routed.npz"), jax.device_get(routed))
    xr = np.random.RandomState(0).randn(2, 32, 12).astype(np.float32)
    xr4 = np.random.RandomState(1).randn(4, 32, 12).astype(np.float32)
    np.savez(d / "xr.npz", x=xr)
    np.savez(d / "xr4.npz", x=xr4)
    mesh22 = JaxMesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                     ("data", "expert"))
    for kk, cf in ((1, 1.0), (2, 1.25)):
        for tag, xx, mesh in (("r%d" % kk, xr, mesh4),
                              ("rd%d" % kk, xr4, mesh22)):
            jv[tag] = values(lambda p, xx=xx, mesh=mesh, kk=kk, cf=cf:
                             jexpert.moe_mlp_ep_routed(
                                 p, jnp.asarray(xx), mesh, k=kk,
                                 capacity_factor=cf), routed)
        jv["dm%d" % kk] = values(lambda p, kk=kk, cf=cf: jexpert.moe_mlp_topk(
            p, jnp.asarray(xr4), k=kk, capacity_factor=cf), routed)

    # Trainer steps
    src4, src8 = _src(0, 4), _src(1, 8)
    np.savez(d / "b4.npz", src=src4)
    np.savez(d / "b8.npz", src=src8)
    pm = _save_model(d / "pm.npz", MOE, seed=1)
    pb = _save_model(d / "pb.npz", BILSTM, PIPE_DIMS)
    pm_np, pb_np = _flat(weights.to_jax(pm)), _flat(weights.to_jax(pb))
    with _Narrow(None):
        jv["ep22"] = _jax_step_values(
            dict(MOE, MESH_DATA=2, MESH_EXPERT=2), pm_np, src4,
            jax_make_mesh(2, 1, n_expert=2))
    with _Narrow(None):
        jv["rt22"] = _jax_step_values(
            dict(MOE, MESH_DATA=2, MESH_EXPERT=2, MOE_TOP_K=2), pm_np, src4,
            jax_make_mesh(2, 1, n_expert=2))
    with _Narrow(None):
        jv["rtdm"] = _jax_step_values(
            dict(MOE, MESH_DATA=2, MESH_MODEL=2, MOE_TOP_K=2), pm_np, src4,
            jax_make_mesh(2, 2))
    with _Narrow(PIPE_DIMS):
        jv["pp22"] = _jax_step_values(
            dict(BILSTM, MESH_DATA=2, MESH_PIPE=2), pb_np, src8,
            jax_make_mesh(2, 1, n_pipe=2))
    # REG_APPLY's term, whole on every rank, on leaves owned by 'expert'
    # and by 'pipe'
    with _Narrow(None):
        jv["ep22reg"] = _jax_step_values(
            dict(MOE, MESH_DATA=2, MESH_EXPERT=2, **REG), pm_np, src4,
            jax_make_mesh(2, 1, n_expert=2))
    with _Narrow(PIPE_DIMS):
        jv["pp22reg"] = _jax_step_values(
            dict(BILSTM, MESH_DATA=2, MESH_PIPE=2, **REG), pb_np, src8,
            jax_make_mesh(2, 1, n_pipe=2))
    # one-process checkpoints for the meshes to load
    with _Narrow(PIPE_DIMS):
        for name, keys, params in (("ckm", MOE, pm), ("ckb", BILSTM, pb)):
            hp, model = smoke.build({"keys": keys})
            tr = Trainer(model, hp, "cpu")
            tr.save_params(tr.init_state(torch.Generator().manual_seed(0),
                                         params=params), str(d / name))
    cases = [
        {"name": "pipe44", "kind": "pipeline", "n_micro": 4,
         "keys": {"MESH_DATA": 1, "MESH_PIPE": 4}},
        {"name": "pipe22", "kind": "pipeline", "n_micro": 2,
         "keys": {"MESH_DATA": 2, "MESH_PIPE": 2}},
        {"name": "pipe44s", "kind": "pipeline", "n_micro": 4,
         "stacked": True, "keys": {"MESH_DATA": 1, "MESH_PIPE": 4}},
        {"name": "soft", "kind": "moe", "params": "soft.npz",
         "x": "xs.npz", "keys": {"MESH_DATA": 1, "MESH_EXPERT": 4}},
    ]
    for c in cases:
        c.setdefault("params", "layers.npz")
        c.setdefault("x", "x.npz")
        c["backend"] = "xla"
    for kk, cf in ((1, 1.0), (2, 1.25)):
        cases += [
            {"name": "r%d" % kk, "kind": "moe", "params": "routed.npz",
             "x": "xr.npz", "k": kk, "cf": cf,
             "keys": {"MESH_DATA": 1, "MESH_EXPERT": 4}},
            {"name": "rd%d" % kk, "kind": "moe", "params": "routed.npz",
             "x": "xr4.npz", "k": kk, "cf": cf,
             "keys": {"MESH_DATA": 2, "MESH_EXPERT": 2}},
            {"name": "dm%d" % kk, "kind": "moe", "params": "routed.npz",
             "x": "xr4.npz", "k": kk, "cf": cf, "keys": {"MESH_DATA": 4}}]
    cases += [
        {"name": "ep22", "kind": "step", "adam": True, "valid": True,
         "params": "pm.npz", "batch": "b4.npz", "init": str(d / "ckm"),
         "save": True, "keys": dict(MOE, MESH_DATA=2, MESH_EXPERT=2)},
        {"name": "rt22", "kind": "step", "params": "pm.npz",
         "batch": "b4.npz",
         "keys": dict(MOE, MESH_DATA=2, MESH_EXPERT=2, MOE_TOP_K=2)},
        {"name": "rtdm", "kind": "step", "adam": True, "params": "pm.npz",
         "batch": "b4.npz",
         "keys": dict(MOE, MESH_DATA=2, MESH_MODEL=2, MOE_TOP_K=2)},
        {"name": "pp22", "kind": "step", "adam": True, "valid": True,
         "params": "pb.npz", "batch": "b8.npz", "dims": PIPE_DIMS,
         "init": str(d / "ckb"), "save": True,
         "keys": dict(BILSTM, MESH_DATA=2, MESH_PIPE=2)},
        {"name": "ep22reg", "kind": "step", "params": "pm.npz",
         "batch": "b4.npz",
         "keys": dict(MOE, MESH_DATA=2, MESH_EXPERT=2, **REG)},
        {"name": "pp22reg", "kind": "step", "params": "pb.npz",
         "batch": "b8.npz", "dims": PIPE_DIMS,
         "keys": dict(BILSTM, MESH_DATA=2, MESH_PIPE=2, **REG)},
    ]
    with open(d / "spec.json", "w") as f:
        json.dump({"cases": cases}, f)
    smoke.launch(str(d / "spec.json"), str(d / "out"), 4, timeout=400)
    with _Narrow(PIPE_DIMS):
        one = {"ep": _one_process(MOE, str(d / "pm.npz"), src4),
               "rtdm": _one_process(dict(MOE, MOE_TOP_K=2),
                                    str(d / "pm.npz"), src4),
               "pp": _one_process(BILSTM, str(d / "pb.npz"), src8)}
    return {"dir": d, "res": smoke.load_results(str(d / "out"), 4),
            "jax": jv, "one": one, "x": x, "xr4": xr4,
            "routed": weights.load_npz(str(d / "routed.npz")),
            "pm": _flat(weights.to_jax(pm)), "pb": _flat(weights.to_jax(pb))}


@pytest.mark.parametrize("case,jax_case", [("pipe44", "pipe4"),
                                           ("pipe22", "pipe2"),
                                           ("pipe44s", "pipe4")])
def test_torch_pipelined_stack_matches_jax(pe4, case, jax_case):
    """``bilstm_stack_pipelined`` on 4 stages x 4 microbatches, on 2 stages
    of 2 layers x 2 microbatches with each data shard pipelining its rows,
    and on ``stack_pipeline_params``' padded stages: every rank's output
    equals JAX's pipelined stack (atol 2e-5, rtol 1e-4), with and
    without autograd, and the gradients of sum(sin(y)) over the whole
    batch, each stage's layers summed from their stage, equal JAX's
    (atol 5e-5, rtol 1e-4), and so does each rank's gradient of its rows
    of the input to the sequential stack's."""
    jy, jl, jg = pe4["jax"][jax_case]
    rows = set()
    for r in range(4):
        d = _rank(pe4["res"], r, case)
        a, b = (int(v) for v in d["rows"])
        rows.add((a, b))
        np.testing.assert_allclose(d["y"], jy[a:b], **STACK)
        np.testing.assert_array_equal(d["y_nograd"], d["y"])
        np.testing.assert_allclose(float(d["loss"]), jl, rtol=1e-5)
        _close(_whole(d, "grads"), jg, **STACK_GRAD)
        np.testing.assert_allclose(d["dx"], pe4["jax"]["dx"][a:b],
                                   **STACK_GRAD)
    assert len(rows) == (2 if case == "pipe22" else 1)


def test_torch_stage_stack_matches_jax():
    """``_stage_stack`` (layer 0's input rows zero-padded to 2H, [S, L,
    ...] leaves) equals JAX's, and ``stack_pipeline_params`` is a rank's
    stage of it."""
    layers = [jrnn.bilstm_init(jax.random.PRNGKey(i), 10 if i == 0 else 14,
                               7) for i in range(4)]
    want, wwidth = jpipeline._stage_stack(layers, 2)
    tl = [weights.from_jax(jax.device_get(p)) for p in layers]
    got, width = tpipeline._stage_stack(tl, 2)
    assert width == wwidth == 14
    _close(_flat(got), _flat(jax.device_get(want)), atol=0, rtol=0)
    mesh = sharding.make_mesh(1, 1, devices=range(2), n_pipe=2)
    mesh.coords = {"data": 0, "model": 0, "pipe": 1}
    mine = tpipeline.stack_pipeline_params(tl, mesh)
    for k, v in _flat(mine).items():
        np.testing.assert_array_equal(v, np.asarray(_flat(want)[k])[1])


@pytest.mark.parametrize("case", ["soft", "r1", "r2", "rd1", "rd2", "dm1",
                                  "dm2"])
def test_torch_moe_ep_matches_jax(pe4, case):
    """``moe_mlp_ep`` over 4 expert ranks (atol 1e-5, rtol 1e-4);
    ``moe_mlp_ep_routed`` over 4 (k=1 / cf 1.0, k=2 / cf 1.25) and over
    data 2 x expert 2, where each T-shard routes the global batch's rows
    with the data shards' counts all-gathered; and ``moe_mlp_topk`` on a
    4-wide data mesh with the global capacity (GSPMD's value): every
    rank's rows equal JAX's (atol 1e-5), and the gradients of sum(y^2)
    over the batch JAX's (atol 1e-4; the soft form 1e-5 / 1e-4)."""
    jy, jg = pe4["jax"][case]
    tol = dict(atol=1e-5, rtol=1e-4) if case == "soft" else \
        dict(atol=1e-5, rtol=0)
    for r in range(4):
        d = _rank(pe4["res"], r, case)
        a, b = (int(v) for v in d["rows"])
        np.testing.assert_allclose(d["y"], jy[a:b], **tol)
        _close(_whole(d, "grads"), jg, **(
            GRAD if case == "soft" else dict(atol=1e-4, rtol=1e-4)))


@pytest.mark.parametrize("k,cf", [(1, 1.0), (2, 1.25)])
def test_torch_routed_capacity_is_global(pe4, k, cf):
    """The data x expert and data-mesh cases drop tokens that a rank
    routing only its own rows would keep: the value that JAX's global
    count gives differs from the rank-local one, so the count reaches
    across the data shards."""
    x = torch.from_numpy(pe4["xr4"])
    p = pe4["routed"]
    local = torch.cat([texpert.moe_mlp_topk(p, x[i:i + 1], k=k,
                                            capacity_factor=cf)
                       for i in range(4)]).numpy()
    assert np.abs(local - pe4["jax"]["dm%d" % k][0]).max() > 1e-3
    half = x.shape[1] // 2
    shard = torch.cat([torch.cat([texpert.moe_mlp_topk(
        p, x[i:i + 2, s * half:(s + 1) * half], k=k, capacity_factor=cf)
        for s in range(2)], 1) for i in (0, 2)]).numpy()
    assert np.abs(shard - pe4["jax"]["rd%d" % k][0]).max() > 1e-3


@pytest.mark.parametrize("case", ["ep22", "rt22", "rtdm", "pp22",
                                  "ep22reg", "pp22reg"])
def test_torch_pipe_expert_steps_match_jax(pe4, case):
    """Trainer steps at data 2 x expert 2 (soft and MOE_TOP_K 2), routed
    moe-v1 on a data 2 x model 2 mesh (the global capacity), and data 2
    x pipe 2 (PIPE_MICROBATCHES 4), the soft expert and pipe steps also
    with REG_APPLY (L2 at 0.01: the term is whole on every rank, and a
    leaf owned by 'expert' or 'pipe' keeps 1 / n of its gradient): every
    rank's loss and gradients equal JAX's train_loss on the same mesh
    shape (rtol 1e-4; atol 1e-5, rtol 1e-4)."""
    jl, jg = pe4["jax"][case]
    for r in range(4):
        d = _rank(pe4["res"], r, case)
        np.testing.assert_allclose(float(d["loss"]), jl, rtol=1e-4)
        _close(_whole(d, "grads"), jg, **GRAD)


@pytest.mark.parametrize("case,one", [("ep22", "ep"), ("rtdm", "rtdm"),
                                      ("pp22", "pp")])
def test_torch_pipe_expert_step_matches_one_process(pe4, case, one):
    """A full step with Adam on the expert, routed data x model and pipe
    meshes equals the one-process step (atol 2e-5, rtol 1e-4; routed
    moe-v1 at data x model routes the global batch, as one process
    does), and every rank holds the same whole parameters."""
    want = pe4["one"][one]
    first = None
    for r in range(4):
        d = _rank(pe4["res"], r, case)
        np.testing.assert_allclose(float(d["loss"]), want["loss"],
                                   rtol=1e-5)
        got = _whole(d, "params")
        _close(got, want["params"], **STEP)
        first = first or got
        for k in got:
            np.testing.assert_array_equal(got[k], first[k], err_msg=k)


def test_torch_pipe_expert_checkpoints(pe4):
    """A one-process checkpoint loads on the expert and pipe meshes as its
    whole weights (each rank its slices: the experts' at half), and the
    meshes' checkpoints, written whole by rank 0, load in one process as
    the ranks' gathered weights, bit for bit; an expert rank holds half of
    each expert leaf at rest, a pipe rank every leaf."""
    full = sum(v.size for v in pe4["pm"].values())
    experts = sum(v.size for k, v in pe4["pm"].items()
                  if k.split("/")[-1] in ("router", "w_in", "w_out"))
    for case, init, keys, dims in (("ep22", pe4["pm"], MOE, None),
                                   ("pp22", pe4["pb"], BILSTM, PIPE_DIMS)):
        for r in range(4):
            loaded = _whole(_rank(pe4["res"], r, case), "loaded")
            _close(loaded, init, atol=0, rtol=0)
        with _Narrow(dims):
            hp, model = smoke.build({"keys": keys})
            tr = Trainer(model, hp, "cpu")
            st = tr.load_params(tr.init_state(
                torch.Generator().manual_seed(7)),
                str(pe4["dir"] / "out" / "saves" / case))
        got = dict(zip(leaf_names(st["params"]),
                       (p.detach().numpy() for p in leaves(st["params"]))))
        _close(got, _whole(_rank(pe4["res"], 0, case), "params"),
               atol=0, rtol=0)
        assert st["step"] == 1
    for r in range(4):
        assert int(_rank(pe4["res"], r, "ep22")["bytes"]) == \
            3 * 4 * (full - experts // 2)
        assert int(_rank(pe4["res"], r, "pp22")["bytes"]) == \
            3 * 4 * sum(v.size for v in pe4["pb"].values())


# ---------------------------------------------------------------- 8 ranks
@pytest.fixture(scope="module")
def pe8(tmp_path_factory):
    """The 8-rank spawn: the configs' own meshes (pipeline.json 2 x 4,
    moe-ep.json 4 x 2, multichip.json 4 x 2) and 1 x 8, JAX's Trainer
    tests at data 2 x pipe 4 and data 4 x expert 2."""
    d = tmp_path_factory.mktemp("pe8")
    src4, src8, src16 = _src(2, 4), _src(3, 8), _src(4, 16)
    src128 = _src(5, 128)
    for name, s in (("b4", src4), ("b8", src8), ("b16", src16),
                    ("b128", src128)):
        np.savez(d / ("%s.npz" % name), src=s)
    pb = _flat(weights.to_jax(_save_model(d / "pb.npz", BILSTM, PIPE_DIMS)))
    pm = _flat(weights.to_jax(_save_model(d / "pm.npz", MOE, seed=1)))
    pj = _save_model(d / "pj.npz", {}, PIPE_DIMS,
                     configs=["configs/pipeline.json"])
    mj = _save_model(d / "mj.npz", {"ATTN_DIM": 32, "ATTN_LAYERS": 2},
                     seed=2, configs=["configs/moe-ep.json"])
    mc = _flat(weights.to_jax(_save_model(
        d / "mc.npz", MC_KEYS, MC_DIMS, seed=3,
        configs=["configs/multichip.json"])))
    del pj, mj
    jv = {}
    with _Narrow(PIPE_DIMS):
        jv["pipe24"] = _jax_step_values(
            dict(BILSTM, MESH_DATA=2, MESH_PIPE=4), pb, src8,
            jax_make_mesh(2, 1, n_pipe=4))
    with _Narrow(None):
        jv["ep42"] = _jax_step_values(
            dict(MOE, MESH_DATA=4, MESH_EXPERT=2), pm, src4,
            jax_make_mesh(4, 1, n_expert=2))
    for name, (nd, nm) in (("mc42", (4, 2)), ("mc18", (1, 8))):
        with _Narrow(MC_DIMS):
            jv[name] = _jax_step_values(
                dict(MC_KEYS, MESH_DATA=nd, MESH_MODEL=nm), mc, src128,
                jax_make_mesh(nd, nm), configs=["configs/multichip.json"])
    cases = [
        {"name": "pipe24", "kind": "step", "adam": True, "params": "pb.npz",
         "batch": "b8.npz", "dims": PIPE_DIMS,
         "keys": dict(BILSTM, MESH_DATA=2, MESH_PIPE=4)},
        {"name": "ep42", "kind": "step", "adam": True, "params": "pm.npz",
         "batch": "b4.npz", "keys": dict(MOE, MESH_DATA=4, MESH_EXPERT=2)},
        {"name": "mc42", "kind": "step", "params": "mc.npz",
         "batch": "b128.npz", "dims": MC_DIMS,
         "configs": ["configs/multichip.json"], "keys": MC_KEYS},
        {"name": "mc18", "kind": "step", "params": "mc.npz",
         "batch": "b128.npz", "dims": MC_DIMS,
         "configs": ["configs/multichip.json"],
         "keys": dict(MC_KEYS, MESH_DATA=1, MESH_MODEL=8)},
        {"name": "pipeline.json", "kind": "step", "params": "pj.npz",
         "batch": "b16.npz", "dims": PIPE_DIMS,
         "configs": ["configs/pipeline.json"], "keys": {}},
        {"name": "moe-ep.json", "kind": "step", "params": "mj.npz",
         "batch": "b16.npz", "configs": ["configs/moe-ep.json"],
         "keys": {"ATTN_DIM": 32, "ATTN_LAYERS": 2}},
    ]
    with open(d / "spec.json", "w") as f:
        json.dump({"cases": cases}, f)
    smoke.launch(str(d / "spec.json"), str(d / "out"), 8, timeout=600)
    one_keys = {"MESH_DATA": 1, "MESH_PIPE": 1, "MESH_EXPERT": 1}
    with _Narrow(PIPE_DIMS):
        one = {"pipe24": _one_process(BILSTM, str(d / "pb.npz"), src8),
               "ep42": _one_process(MOE, str(d / "pm.npz"), src4),
               "pipeline.json": _one_process(
                   one_keys, str(d / "pj.npz"), src16,
                   ["configs/pipeline.json"], adam=False),
               "moe-ep.json": _one_process(
                   dict(one_keys, ATTN_DIM=32, ATTN_LAYERS=2),
                   str(d / "mj.npz"), src16, ["configs/moe-ep.json"],
                   adam=False)}
    return {"res": smoke.load_results(str(d / "out"), 8), "jax": jv,
            "one": one, "mc": mc}


@pytest.mark.parametrize("case", ["pipe24", "ep42", "mc42", "mc18"])
def test_torch_eight_ranks_match_jax(pe8, case):
    """Eight gloo ranks: the Trainer at data 2 x pipe 4 (JAX's
    test_trainer_pipeline_parallel_step's mesh: microbatches of 2 rows,
    one per data shard) and data 4 x expert 2 (test_trainer_expert_
    parallel_step's), and configs/multichip.json's keys (in float32) at
    its own 4 x 2 and at 1 x 8: every rank's loss and gradients equal
    JAX's on the same mesh shape (rtol 1e-4; atol 1e-5, rtol 1e-4)."""
    jl, jg = pe8["jax"][case]
    for r in range(8):
        d = _rank(pe8["res"], r, case)
        np.testing.assert_allclose(float(d["loss"]), jl, rtol=1e-4)
        _close(_whole(d, "grads"), jg, **GRAD)


@pytest.mark.parametrize("case", ["pipe24", "ep42"])
def test_torch_eight_rank_step_matches_one_process(pe8, case):
    """The 2 x 4 pipe and 4 x 2 expert steps with Adam equal the
    one-process step (atol 2e-5, rtol 1e-4) on every rank."""
    want = pe8["one"][case]
    for r in range(8):
        _close(_whole(_rank(pe8["res"], r, case), "params"),
               want["params"], **STEP)


def test_torch_model_axis_eight_replicates_as_jax(fresh_hparams, pe8):
    """At MESH_MODEL 8 the leaves that 8 does not divide (HDIM 12 here, as
    h=300 at full width, and the 2580-wide head) are replicated, as JAX's
    rules replicate them: the port's specs equal JAX's leaf by leaf, and
    an 8-wide rank holds the replicated leaves whole and 1/8 of the rest
    (with their moments)."""
    with _Narrow(MC_DIMS):
        _jax_hp(dict(MC_KEYS, MESH_DATA=1, MESH_MODEL=8),
                ["configs/multichip.json"])
        jp = JaxDaNet().init(jax.random.PRNGKey(0))
        want = jsharding.param_pspecs(jp, jax_make_mesh(1, 8))
        hp, model = smoke.build({"keys": MC_KEYS,
                                 "configs": ["configs/multichip.json"]})
        tp = model.init(torch.Generator())
    mesh = sharding.make_mesh(1, 8, devices=range(8))
    got = sharding.param_pspecs(tp, mesh)
    want = dict(zip(leaf_names(want), (tuple(v) for v in leaves(want))))
    assert dict(zip(leaf_names(got), leaves(got))) == want
    axes = sharding.model_axes(tp, mesh)
    assert axes[leaf_names(tp).index("encoder/lstm0/fwd/wx")] is None
    assert axes[leaf_names(tp).index("encoder/output/w")] is None
    size = sum(p.numel() if a is None else p.numel() // 8
               for p, a in zip(leaves(tp), axes))
    for r in range(8):
        assert int(_rank(pe8["res"], r, "mc18")["bytes"]) == 3 * 4 * size


@pytest.mark.parametrize("case", ["pipeline.json", "moe-ep.json"])
def test_torch_configs_run_as_written(pe8, case):
    """configs/pipeline.json (data 2 x pipe 4, bfloat16, B=16,
    PIPE_MICROBATCHES 8) and configs/moe-ep.json (data 4 x expert 2,
    bfloat16, B=16) run as written on 8 ranks at narrow widths: finite,
    and the loss within 1e-2 and each gradient within 2e-2 of its peak of
    the one-process bfloat16 step (chip_smoke phase 27's bound)."""
    want = pe8["one"][case]
    for r in range(8):
        d = _rank(pe8["res"], r, case)
        assert abs(float(d["loss"]) - want["loss"]) <= \
            BF16_LOSS_REL * abs(want["loss"])
        for k, ref in want["grads"].items():
            got = d["grads/" + k]
            assert np.all(np.isfinite(got)), k
            assert np.abs(got - ref).max() <= \
                BF16_GRAD_REL * max(np.abs(ref).max(), 1e-30), k


# ---------------------------------------------------------------- in process
def test_torch_mesh_from_hparams_pipe_expert(fresh_hparams):
    """MESH_PIPE / MESH_EXPERT configs give meshes with the extra axes, as
    JAX's test_mesh_from_hparams_pipe_expert."""
    hp = fresh_hparams
    hp.MESH_DATA, hp.MESH_PIPE = 2, 4
    want = jsharding.mesh_from_hparams(hp)
    got = sharding.mesh_from_hparams(load_config(MESH_DATA=2, MESH_PIPE=4),
                                     devices=range(8))
    assert got.shape == dict(want.shape) == {"data": 2, "model": 1,
                                             "pipe": 4}
    hp.MESH_PIPE, hp.MESH_EXPERT, hp.MESH_DATA = 1, 2, 4
    want = jsharding.mesh_from_hparams(hp)
    got = sharding.mesh_from_hparams(
        load_config(MESH_DATA=4, MESH_EXPERT=2), devices=range(8))
    assert got.shape == dict(want.shape) == {"data": 4, "model": 1,
                                             "expert": 2}


def test_torch_route_mesh_dense_fallback_is_narrow(monkeypatch):
    """_route_mesh falls back dense only on MeshUnavailableError (MESH_SEQ
    64 on one process); a broken MESH_PIPE raises, as JAX's
    test_route_mesh_dense_fallback_is_narrow; on one process a MESH_PIPE
    config runs bilstm-orig's stack densely."""
    sharding.set_active_mesh(None)
    assert tenc._route_mesh(load_config(MESH_SEQ=64), "seq", 64) is None
    with pytest.raises((TypeError, ValueError)):
        tenc._route_mesh(load_config(MESH_PIPE="garbage"), "pipe", 2)
    hp = load_config(ENCODER_TYPE="bilstm-orig", MESH_PIPE=2)
    assert tenc._route_mesh(hp, "pipe", 2) is None
    monkeypatch.setattr(tenc.BiLstmEncoder, "HDIM", 8)
    monkeypatch.setattr(tenc.BiLstmEncoder, "N_LAYERS", 2)
    model = TorchDaNet(hp)
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 129, generator=torch.Generator().manual_seed(1))
    dense = TorchDaNet(load_config(ENCODER_TYPE="bilstm-orig"))
    np.testing.assert_array_equal(
        model.encoder.apply(params["encoder"], x).numpy(),
        dense.encoder.apply(params["encoder"], x).numpy())
