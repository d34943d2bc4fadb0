"""PyTorch port, sequence parallelism of tcn-v1, dprnn-v1, conv-bilstm-v1
and tasnet-v1 (``parallel/seq_parallel.py``: ``tcn_stack_sp``,
``dprnn_stack_sp``, ``conv_bilstm_sp``; ``TasNet._forward_sp``; the
encoders' MESH_SEQ routes; ``collectives.sum_parts``;
``sharding.leaf_owners``), against the JAX package's values on the CPU.

One module-scoped spawn of 4 gloo ranks (``parallel/smoke.py``) runs every
case; the JAX side runs in this process on the conftest's 8 CPU devices,
with JAX's parameters carried across (``weights.save_npz``) and
numpy-seeded inputs.  Shapes and tolerances are JAX's own
(``tests/test_parallel.py:339-423,1207-1357``,
``tests/test_tasnet.py:229-298``): the TCN stack at TCN_DIM 16, HIDDEN 24,
3 x 2 blocks, B=2, T=64 over 4 ranks, causal and not (atol 2e-5, rtol
1e-4); the dual-path stack at DPRNN_DIM 16, HIDDEN 12, CHUNK = HOP 8, 2
blocks, inter-causal and not (5e-5 / 1e-4); conv-bilstm-v1 at FFT_SIZE 32,
EMBED_SIZE 4, B=2, T=32 over seq 2, seq 4 and data 2 x seq 2 (forward 2e-5
/ 1e-5, gradients 5e-4 / 1e-4); tasnet-v1 at FILTERS 48, BOTTLENECK 24,
HIDDEN 32, 3 x 2 blocks, separate_wav of [2, 1024] at data 2 x seq 2 (1e-5
/ 1e-6).  The stacks' gradients of sum(y^2), summed over the ranks, are
held to 5e-4 / 1e-4 (the relay's bound).  Trainer steps at data 2 x seq 2
hold every rank's loss against JAX's train_loss on the same mesh shape
(rtol 1e-5; tasnet-v1 1e-4, JAX's own bound there) and gradients (atol
1e-5, rtol 1e-4), and the parameters after one Adam step against the
port's one-process step (atol 5e-5, dprnn-v1 2e-4; rtol 1e-4); steps with
dropout at seq 4 against the port's one-process dropout step (the masks
drawn whole, each rank's block kept).
"""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from danet_tpu.hparams import hparams as jhp  # noqa: E402
from danet_tpu.parallel import batch_sharding, set_active_mesh  # noqa: E402
from danet_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from danet_tpu.parallel import shard_params as jax_shard  # noqa: E402
from danet_tpu.parallel.seq_parallel import (  # noqa: E402
    conv_bilstm_sp as jcbsp, dprnn_stack_sp as jdsp, tcn_stack_sp as jtsp)
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402
from danet_tpu_torch.models import encoders as tenc  # noqa: E402
from danet_tpu_torch.models.tasnet import TasNet  # noqa: E402
from danet_tpu_torch.parallel import seq_parallel, sharding, smoke  # noqa: E402,E501
from danet_tpu_torch.weights import leaf_names  # noqa: E402
from tests.test_torch_parallel_seq import (  # noqa: E402
    GRAD, STACK_GRAD, _close, _flat, _jax_hp, _Narrow, _nest_like,
    _one_process, _rank, _whole)

TCN = {"ENCODER_TYPE": "tcn-v1", "TCN_DIM": 16, "TCN_HIDDEN": 24,
       "TCN_BLOCKS": 3, "TCN_REPEATS": 2}
DPRNN = {"ENCODER_TYPE": "dprnn-v1", "DPRNN_DIM": 16, "DPRNN_HIDDEN": 12,
         "DPRNN_CHUNK": 8, "DPRNN_HOP": 8, "DPRNN_BLOCKS": 2}
CONV = {"ENCODER_TYPE": "conv-bilstm-v1", "FFT_SIZE": 32, "EMBED_SIZE": 4}
TASNET = {"MODEL_TYPE": "tasnet-v1", "TASNET_FILTERS": 48,
          "TASNET_BOTTLENECK": 24, "TASNET_HIDDEN": 32, "TASNET_BLOCKS": 3,
          "TASNET_REPEATS": 2}
MODELS = {"tcn": TCN, "dprnn": DPRNN, "conv": CONV, "tasnet": TASNET}
STEP_KEYS = {"BATCH_SIZE": 4, "DROPOUT_KEEP_PROB": 1.0}
TCN_TOL = dict(atol=2e-5, rtol=1e-4)
DPRNN_TOL = dict(atol=5e-5, rtol=1e-4)
CONV_TOL = dict(atol=2e-5, rtol=1e-5)
TASNET_TOL = dict(atol=1e-6, rtol=1e-5)
SEQ4 = {"MESH_DATA": 1, "MESH_SEQ": 4}
DP_SP = {"MESH_DATA": 2, "MESH_SEQ": 2}
REG = {"REG_APPLY": True, "REG_TYPE": "L2", "REG_SCALE": 0.01}


def _blocks(res, case, n, shape):
    """The global output of a stack case from its ranks' blocks."""
    out = np.full(shape, np.nan, np.float32)
    for r in range(n):
        d = _rank(res, r, case)
        if not d:
            continue
        a, b = (int(v) for v in d["rows"])
        t0, t1 = (int(v) for v in d["cols"])
        out[a:b, t0:t1] = d["y"]
        np.testing.assert_array_equal(d["y_nograd"], d["y"])
    assert not np.isnan(out).any()
    return out


def _jax_encoder(keys):
    """A JAX encoder of ``keys`` over default.json and its parameters."""
    _jax_hp(keys)
    enc = jhp.get_encoder()(jhp, "encoder")
    return enc, enc.init(jax.random.PRNGKey(0))


def _jax_sp(fn, params, x, mesh, *args, **kw):
    """(y, gradients of sum(y^2)) of a JAX SP stack, jitted."""
    def run(p):
        return fn(p, jnp.asarray(x), mesh, *args, **kw)
    y, g = jax.jit(lambda p: (run(p), jax.grad(
        lambda q: jnp.sum(run(q) ** 2))(p)))(params)
    return np.asarray(y), _flat(jax.device_get(g))


def _jax_model_step(keys, params_np, src, mesh):
    """JAX's (loss, gradients) of the configured model's ``train_loss`` on
    ``mesh`` (the active mesh, which the 'seq' routes read)."""
    _jax_hp(keys)
    set_active_mesh(mesh)
    jm = jhp.get_model()()
    jp = jm.init(jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(lambda a, b: jnp.asarray(b, a.dtype), jp,
                                _nest_like(jp, params_np))
    vg = jax.jit(jax.value_and_grad(lambda p, x: jm.train_loss(p, x,
                                                               None)[0]))
    loss, g = vg(jax_shard(mesh, jp), jax.device_put(src,
                                                     batch_sharding(mesh)))
    return float(loss), _flat(jax.device_get(g))


def _save(path, keys, seed=0):
    """The port's seeded parameters of the model of ``keys``, saved."""
    _, model = smoke.build({"keys": keys})
    params = model.init(torch.Generator().manual_seed(seed))
    weights.save_npz(str(path), params)
    return _flat(weights.to_jax(params))


def _src(seed, b, f, t=16):
    return np.random.RandomState(seed).randn(b, 2, t, f, 2).astype(
        np.float32)


@pytest.fixture(scope="module")
def spc(tmp_path_factory):
    """The 4-rank spawn: the TCN and dual-path stacks (with REMAT),
    conv_bilstm_sp at seq 2, seq 4 and data 2 x seq 2, sum_parts against
    leave_sum, tasnet-v1's forward and separate_wav, Trainer steps at data
    2 x seq 2 and dropout steps at seq 4; and JAX's values for the same
    inputs, computed while the ranks run (each JAX job with its own keys
    loaded: the JAX modules read the hparams singleton)."""
    d = tmp_path_factory.mktemp("spc")
    cases, jobs = [], {}
    mesh4 = JaxMesh(np.asarray(jax.devices()[:4]), ("seq",))
    with _Narrow(None):
        # the TCN and dual-path stacks over 4 ranks
        x64 = np.random.RandomState(1).randn(2, 64, 129).astype(np.float32)
        xc = x64 - x64.mean(axis=(1, 2), keepdims=True)
        np.savez(d / "x64.npz", x=xc)
        for stack, flag, fn in (("tcn", "TCN_CAUSAL", jtsp),
                                ("dprnn", "DPRNN_INTER_CAUSAL", jdsp)):
            for on in (False, True):
                keys = dict(MODELS[stack], **{flag: on})
                enc, p = _jax_encoder(keys)
                name = "%s%d" % (stack, on)
                weights.save_npz(str(d / ("%s.npz" % name)),
                                 jax.device_get(p))
                body = {k: v for k, v in p.items() if k != "output"}
                if stack == "tcn":
                    args, kw = (), dict(dilations=[
                        enc._dilation(i) for i in range(enc._n_blocks())],
                        kernel=3, causal=on, alpha=jhp.RELU_LEAKAGE)
                else:
                    args, kw = (8, 2, on), dict(backend="xla")
                jobs[name] = (keys, lambda fn=fn, body=body, args=args,
                              kw=kw: _jax_sp(fn, body, xc, mesh4, *args,
                                             **kw))
                for remat in (False, True):
                    cases.append({"name": name + "r" * remat,
                                  "kind": "sp_conv", "stack": stack,
                                  "params": "%s.npz" % name, "x": "x64.npz",
                                  "remat": remat,
                                  "keys": dict(keys, **SEQ4)})
        # conv_bilstm_sp at seq 2, seq 4 and data 2 x seq 2
        enc, p = _jax_encoder(CONV)
        weights.save_npz(str(d / "conv.npz"), jax.device_get(p))
        xcb = np.random.RandomState(0).randn(
            2, 32, jhp.FEATURE_SIZE).astype(np.float32)
        np.savez(d / "xcb.npz", x=xcb)
        xj = jnp.asarray(xcb)
        args = (jhp.FFT_SIZE, jhp.FEATURE_SIZE, jhp.EMBED_SIZE,
                jhp.RELU_LEAKAGE, "tanh")
        jobs["conv_dense"] = (CONV, lambda: (
            np.asarray(jax.jit(enc.apply)(p, xj)), _flat(jax.device_get(
                jax.jit(jax.grad(lambda q: jnp.sum(enc.apply(q, xj) ** 2)))(
                    p)))))
        jobs["conv2"] = (CONV, lambda: _jax_sp(jcbsp, p, xcb, JaxMesh(
            np.asarray(jax.devices()[:2]), ("seq",)), *args))
        for name, mesh in (("conv4", mesh4), ("convdp", JaxMesh(
                np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "seq")))):
            jobs[name] = (CONV, lambda m=mesh: np.asarray(jax.jit(
                lambda q: jcbsp(q, xj, m, *args))(p)))
        for name, mesh in (("conv2", {"MESH_DATA": 1, "MESH_SEQ": 2}),
                           ("conv4", SEQ4), ("convdp", DP_SP)):
            cases.append({"name": name, "kind": "sp_conv",
                          "stack": "conv_bilstm", "params": "conv.npz",
                          "x": "xcb.npz", "keys": dict(CONV, **mesh)})
        cases.append({"name": "convr", "kind": "sp_conv",
                      "stack": "conv_bilstm", "params": "conv.npz",
                      "x": "xcb.npz", "remat": True,
                      "keys": dict(CONV, **SEQ4)})
        # sum_parts, and leave_sum in its place
        xs = np.random.RandomState(3).randn(2, 16, 3).astype(np.float32)
        np.savez(d / "xs.npz", x=xs)
        for stack in ("sum_parts", "leave_sum"):
            cases.append({"name": stack, "kind": "sp_conv", "stack": stack,
                          "x": "xs.npz", "keys": dict(TCN, **SEQ4)})
        # tasnet-v1's forward and separate_wav
        tas = dict(TASNET, BATCH_SIZE=2)
        _jax_hp(tas)
        p_tas = jhp.get_model()().init(jax.random.PRNGKey(0))
        weights.save_npz(str(d / "tasnet.npz"), jax.device_get(p_tas))
        wav = np.random.RandomState(0).randn(2, 1024).astype(np.float32)
        np.savez(d / "wav.npz", x=wav)

        def tasnet_sp():
            set_active_mesh(jax_make_mesh(2, 1, jax.devices()[:4], n_seq=2))
            try:
                return np.asarray(jax.jit(jhp.get_model()().separate_wav)(
                    p_tas, jnp.asarray(wav)))
            finally:
                set_active_mesh(None)
        jobs["tasnet_dense"] = (tas, lambda: np.asarray(jax.jit(
            jhp.get_model()().separate_wav)(p_tas, jnp.asarray(wav))))
        jobs["tasnet_sp"] = (dict(tas, MESH_SEQ=2), tasnet_sp)
        cases.append({"name": "tasnet_fwd", "kind": "sp_conv",
                      "stack": "tasnet", "params": "tasnet.npz",
                      "x": "wav.npz", "keys": dict(TASNET, **SEQ4)})
        cases.append({"name": "tasnet_sep", "kind": "sp_conv",
                      "stack": "tasnet", "separate_wav": True,
                      "params": "tasnet.npz", "x": "wav.npz",
                      "keys": dict(tas, **DP_SP)})

        # Trainer steps at data 2 x seq 2, dropout steps at seq 4
        srcs = {}
        for name, keys in MODELS.items():
            keys = dict(keys, **STEP_KEYS)
            f = load_config(**keys).FEATURE_SIZE
            srcs["step_" + name] = _src(0, 4, f)
            srcs["drop_" + name] = _src(1, 4, f, t=32)
            flat = _save(d / ("p%s.npz" % name), keys)
            jobs["step_" + name] = (keys, lambda k=dict(keys, **DP_SP),
                                    flat=flat, src=srcs["step_" + name]:
                                    _jax_model_step(k, flat, src,
                                                    jax_make_mesh(2, 1,
                                                                  n_seq=2)))
            steps = [("step_", DP_SP), ("drop_", dict(
                SEQ4, DROPOUT_KEEP_PROB=0.8))]
            if name == "tcn":
                # REG_APPLY's term, computed whole on every rank
                srcs["reg_tcn"] = srcs["step_tcn"]
                steps.append(("reg_", dict(DP_SP, **REG)))
                jobs["reg_tcn"] = (keys, lambda k=dict(keys, **dict(
                    DP_SP, **REG)), flat=flat, src=srcs["step_tcn"]:
                    _jax_model_step(k, flat, src,
                                    jax_make_mesh(2, 1, n_seq=2)))
            for tag, extra in steps:
                np.savez(d / ("%s%s.npz" % (tag, name)),
                         src=srcs[tag + name])
                cases.append({"name": tag + name, "kind": "step",
                              "adam": tag != "reg_",
                              "valid": tag == "step_",
                              "params": "p%s.npz" % name,
                              "batch": "%s%s.npz" % (tag, name),
                              "keys": dict(keys, **extra)})

        with open(d / "spec.json", "w") as f:
            json.dump({"cases": cases}, f)
        failed = []

        def spawn():
            try:
                smoke.launch(str(d / "spec.json"), str(d / "out"), 4,
                             timeout=500)
            except RuntimeError as e:
                failed.append(e)
        ranks = threading.Thread(target=spawn)
        ranks.start()
        try:
            jv = {}
            for name, (keys, job) in jobs.items():
                _jax_hp(keys)
                jv[name] = job()
            one = {}
            for name, keys in MODELS.items():
                for tag in ("step_", "drop_"):
                    extra = {"DROPOUT_KEEP_PROB": 0.8} if tag == "drop_" \
                        else {}
                    one[tag + name] = _one_process(
                        dict(keys, **dict(STEP_KEYS, **extra)),
                        str(d / ("p%s.npz" % name)), srcs[tag + name])
        finally:
            ranks.join()
    if failed:
        raise failed[0]
    return {"res": smoke.load_results(str(d / "out"), 4), "jax": jv,
            "one": one, "xs": xs}


@pytest.mark.parametrize("case", ["tcn0", "tcn1"])
def test_torch_tcn_stack_sp_matches_jax(spc, case):
    """tcn_stack_sp over 4 'seq' ranks, non-causal and causal, equals JAX's
    tcn_stack_sp (atol 2e-5, rtol 1e-4), with and without autograd; the
    gradients of sum(y^2), summed over the ranks, equal JAX's (5e-4 /
    1e-4); every rank holds the input's whole gradient."""
    jy, jg = spc["jax"][case]
    got = _blocks(spc["res"], case, 4, jy.shape)
    np.testing.assert_allclose(got, jy, **TCN_TOL)
    dx = [_rank(spc["res"], r, case)["dx"] for r in range(4)]
    for r in range(4):
        g = _whole(_rank(spc["res"], r, case), "grads")
        _close({k: v for k, v in g.items() if not k.startswith("output")},
               jg, **STACK_GRAD)
        np.testing.assert_array_equal(dx[r], dx[0])


@pytest.mark.parametrize("case", ["dprnn0", "dprnn1"])
def test_torch_dprnn_stack_sp_matches_jax(spc, case):
    """dprnn_stack_sp over 4 'seq' ranks (hop = chunk 8, 2 blocks; the
    inter path a BiLSTM, or under DPRNN_INTER_CAUSAL one LSTM direction)
    equals JAX's dprnn_stack_sp (atol 5e-5, rtol 1e-4); the gradients,
    summed over the ranks, equal JAX's (5e-4 / 1e-4)."""
    jy, jg = spc["jax"][case]
    got = _blocks(spc["res"], case, 4, jy.shape)
    np.testing.assert_allclose(got, jy, **DPRNN_TOL)
    for r in range(4):
        g = _whole(_rank(spc["res"], r, case), "grads")
        _close({k: v for k, v in g.items() if not k.startswith("output")},
               jg, **STACK_GRAD)


@pytest.mark.parametrize("case", ["tcn0", "tcn1", "dprnn0", "dprnn1",
                                  "conv4"])
def test_torch_conv_sp_remat_equals_plain(spc, case):
    """REMAT on the TCN and dual-path stacks (each block under
    torch.utils.checkpoint, its halos or all-to-alls replayed in the
    backward) and on conv_bilstm_sp's relay: the outputs bit for bit and
    the gradients within 1e-4 / 1e-4 of the plain stack's."""
    remat = "convr" if case == "conv4" else case + "r"
    for r in range(4):
        a, b = _rank(spc["res"], r, case), _rank(spc["res"], r, remat)
        np.testing.assert_array_equal(a["y"], b["y"])
        _close(_whole(b, "grads"), _whole(a, "grads"), atol=1e-4,
               rtol=1e-4)


@pytest.mark.parametrize("case,n", [("conv2", 2), ("conv4", 4),
                                    ("convdp", 4)])
def test_torch_conv_bilstm_sp_matches_jax(spc, case, n):
    """conv_bilstm_sp at seq 2, seq 4 and data 2 x seq 2 (the conv halos,
    the centrings over sum_parts, the relay) equals JAX's dense encoder
    and JAX's conv_bilstm_sp on the same mesh (atol 2e-5, rtol 1e-5); its
    gradients, summed over the ranks that split the batch, equal the
    dense encoder's and, at seq 2, JAX's sharded ones (5e-4 / 1e-4)."""
    dense, g_dense = spc["jax"]["conv_dense"]
    jy = spc["jax"][case][0] if case == "conv2" else spc["jax"][case]
    got = _blocks(spc["res"], case, n, dense.shape)
    np.testing.assert_allclose(got, dense, **CONV_TOL)
    np.testing.assert_allclose(got, jy, **CONV_TOL)
    for r in range(n):
        g = _whole(_rank(spc["res"], r, case), "grads")
        _close(g, g_dense, **STACK_GRAD)
        if case == "conv2":
            _close(g, spc["jax"]["conv2"][1], **STACK_GRAD)


def test_torch_sum_parts_gradient(spc):
    """sum_parts: y = x * (the sum of x over its row, all ranks' chunks)
    on 4 ranks equals the dense product, and d sum(y^2) / dx equals the
    dense one, which needs every rank's cotangent of the sum; leave_sum
    in its place (its backward hands each rank its own cotangent) gives
    the same forward and another gradient."""
    x = torch.from_numpy(spc["xs"]).requires_grad_(True)
    y = x * torch.sum(x, dim=(1, 2), keepdim=True)
    (dx,) = torch.autograd.grad(torch.sum(y ** 2), [x])
    for stack in ("sum_parts", "leave_sum"):
        got = _blocks(spc["res"], stack, 4, tuple(y.shape))
        np.testing.assert_allclose(got, y.detach().numpy(), atol=1e-5,
                                   rtol=1e-5)
    for r in range(4):
        np.testing.assert_allclose(_rank(spc["res"], r, "sum_parts")["dx"],
                                   dx.numpy(), atol=1e-4, rtol=1e-5)
        wrong = _rank(spc["res"], r, "leave_sum")["dx"]
        assert np.abs(wrong - dx.numpy()).max() > 1e-2 * np.abs(
            dx.numpy()).max()


def test_torch_tasnet_sp_forward_matches_jax(spc):
    """tasnet-v1's sequence-parallel forward: _forward_sp over 4 ranks
    (its gradients summed over them) and separate_wav at data 2 x seq 2
    equal JAX's dense separate_wav and JAX's MESH_SEQ 2 separate_wav
    (atol 1e-6, rtol 1e-5), on every rank."""
    dense, sp = spc["jax"]["tasnet_dense"], spc["jax"]["tasnet_sp"]
    for r in range(4):
        got = _rank(spc["res"], r, "tasnet_sep")["y"]
        np.testing.assert_allclose(got, dense, **TASNET_TOL)
        np.testing.assert_allclose(got, sp, **TASNET_TOL)
        fwd = _rank(spc["res"], r, "tasnet_fwd")
        np.testing.assert_allclose(fwd["y"][..., :dense.shape[-1]], dense,
                                   **TASNET_TOL)
        np.testing.assert_array_equal(fwd["y_nograd"], fwd["y"])


@pytest.mark.parametrize("name", ["tcn", "dprnn", "conv", "tasnet"])
def test_torch_seq_conv_steps_match_jax(spc, name):
    """Trainer steps at data 2 x seq 2 (tcn-v1, dprnn-v1, conv-bilstm-v1,
    tasnet-v1): every rank's loss equals JAX's train_loss on the same
    mesh shape (rtol 1e-5; tasnet-v1 1e-4, JAX's bound for its step) and
    its gradients JAX's (atol 1e-5, rtol 1e-4; tasnet-v1's, whose
    waveform sums reach 1e2, each within 1e-4 of its tensor's peak, the
    bound chip_smoke holds sequence-parallel gradients to: a leaf with the
    wrong owner is off by a factor of the axis' size), the parameters
    after one Adam step the port's one-process step (atol 5e-5, dprnn-v1
    2e-4; rtol 1e-4), and the ranks' parameters agree bit for bit."""
    jl, jg = spc["jax"]["step_" + name]
    want = spc["one"]["step_" + name]
    atol = 2e-4 if name == "dprnn" else 5e-5
    ranks = [_rank(spc["res"], r, "step_" + name) for r in range(4)]
    for d in ranks:
        np.testing.assert_allclose(float(d["loss"]), jl,
                                   rtol=1e-4 if name == "tasnet" else 1e-5)
        grads = _whole(d, "grads")
        if name == "tasnet":
            assert set(grads) == set(jg)
            for k, ref in jg.items():
                assert np.abs(grads[k] - ref).max() <= \
                    1e-4 * np.abs(ref).max(), k
        else:
            _close(grads, jg, **GRAD)
        _close(_whole(d, "params"), want["params"], atol=atol, rtol=1e-4)
        for k, v in _whole(d, "params").items():
            np.testing.assert_array_equal(v, _whole(ranks[0], "params")[k])


def test_torch_seq_reg_term_counted_once(spc):
    """REG_APPLY under MESH_SEQ (tcn-v1 at data 2 x seq 2, L2 at 0.01):
    every rank computes the whole regulariser, so a leaf owned by 'seq'
    keeps 1 / S of its term's gradient (``reg_loss``'s shares, set by the
    Trainer); the loss and gradients equal JAX's train_loss on the same
    mesh (rtol 1e-5; atol 1e-5, rtol 1e-4)."""
    jl, jg = spc["jax"]["reg_tcn"]
    for r in range(4):
        d = _rank(spc["res"], r, "reg_tcn")
        np.testing.assert_allclose(float(d["loss"]), jl, rtol=1e-5)
        _close(_whole(d, "grads"), jg, **GRAD)


@pytest.mark.parametrize("name", ["tcn", "dprnn", "conv", "tasnet"])
def test_torch_seq_conv_dropout_step_equals_dense(spc, name):
    """With DROPOUT_KEEP_PROB 0.8 at seq 4 the ranks draw each mask whole,
    in the dense path's order, and keep their block, so the step equals
    the port's one-process dropout step (the parameters within atol 5e-5,
    dprnn-v1 2e-4, rtol 1e-4; JAX folds the device's coordinates into
    its keys, so there is no JAX value to hold)."""
    want = spc["one"]["drop_" + name]
    atol = 2e-4 if name == "dprnn" else 5e-5
    for r in range(4):
        d = _rank(spc["res"], r, "drop_" + name)
        assert np.isfinite(float(d["step_loss"]))
        _close(_whole(d, "params"), want["params"], atol=atol, rtol=1e-4)


def test_torch_seq_conv_launch_counts(spc):
    """On the CPU the ranks run the plain versions, and no kernel wrapper
    counts a launch: every count of the stacks' and steps' runs is 0."""
    for r in range(4):
        for case in ("dprnn0", "conv4", "step_dprnn", "step_conv"):
            d = _rank(spc["res"], r, case)
            assert all(int(v) == 0 for k, v in d.items()
                       if k.startswith("launches/")), case


# ---------------------------------------------------------------- in process
@pytest.mark.parametrize("name", ["tcn", "dprnn", "conv", "tasnet"])
def test_torch_seq_conv_leaf_owners(name):
    """On a mesh with 'seq', the leaves each rank differentiates from its
    chunk alone are owned by 'seq': tcn-v1's and dprnn-v1's bottleneck and
    blocks (not the head, which runs after the gather), every leaf of
    conv-bilstm-v1's encoder (the gather follows its head) and every leaf
    of tasnet-v1 (the gather follows its overlap-add); the estimators by
    none.  Off 'seq' no leaf is owned by it."""
    keys = MODELS[name]
    hp = load_config(**keys)
    model = hp.get_model()(hp)
    params = model.init(torch.Generator())
    mesh = sharding.make_mesh(2, 1, devices=range(8), n_seq=4)
    owners = dict(zip(leaf_names(params),
                      sharding.leaf_owners(params, mesh, model)))
    for leaf, owner in owners.items():
        if name == "tasnet":
            want = "seq"
        elif name == "conv":
            want = "seq" if leaf.startswith("encoder/") else None
        else:
            want = "seq" if leaf.startswith(("encoder/bottleneck",
                                             "encoder/block")) else None
        assert owner == want, (name, leaf)
    flat = sharding.make_mesh(8, 1, devices=range(8))
    assert not any(sharding.leaf_owners(params, flat, model))


def _error(fn):
    try:
        fn()
    except (AssertionError, ValueError) as e:
        return type(e), str(e)
    raise AssertionError("no error")


@pytest.mark.parametrize("what", ["tcn_t", "tcn_span", "dprnn_t",
                                  "dprnn_p", "conv_t", "conv_short"])
def test_torch_conv_sp_stack_errors(what):
    """Each stack's argument checks raise ValueError with JAX's words,
    where JAX asserts (tcn_stack_sp's T split and largest span,
    conv_bilstm_sp's chunk length) or raises (dprnn_stack_sp's segment
    and position splits; conv_bilstm_sp's pooled grid, which JAX asserts
    too), before any collective."""
    jmesh = {s: JaxMesh(np.asarray(jax.devices()[:s]), ("seq",))
             for s in (2, 4)}
    tmesh = {s: sharding.make_mesh(1, 1, devices=range(s), n_seq=s)
             for s in (2, 4)}
    tcn = dict(dilations=[1, 2, 4], kernel=3, causal=False, alpha=0.0)
    cases = {
        "tcn_t": (4, (2, 62, 4), lambda f, x, m: f({}, x, m, **tcn)),
        "tcn_span": (4, (2, 16, 4), lambda f, x, m: f({}, x, m, **dict(
            tcn, dilations=[1, 8]))),
        "dprnn_t": (4, (2, 48, 4), lambda f, x, m: f({}, x, m, 8, 2, False)),
        "dprnn_p": (4, (2, 96, 4), lambda f, x, m: f({}, x, m, 6, 2, False)),
        "conv_t": (4, (2, 40, 17), lambda f, x, m: f(
            {}, x, m, 32, 17, 4, 0.0, "tanh")),
        "conv_short": (4, (2, 16, 17), lambda f, x, m: f(
            {}, x, m, 32, 17, 4, 0.0, "tanh"))}
    s, shape, call = cases[what]
    fns = {"tcn": (jtsp, seq_parallel.tcn_stack_sp),
           "dprnn": (jdsp, seq_parallel.dprnn_stack_sp),
           "conv": (jcbsp, seq_parallel.conv_bilstm_sp)}[what.split("_")[0]]
    want = _error(lambda: call(fns[0], jnp.zeros(shape), jmesh[s]))
    got = _error(lambda: call(fns[1], torch.zeros(shape), tmesh[s]))
    assert got[0] is ValueError
    assert got[1] == want[1]


@pytest.mark.parametrize("what", ["tcn_t", "dprnn_hop", "conv_grid",
                                  "tasnet_len"])
def test_torch_seq_conv_route_errors(fresh_hparams, what):
    """The routes' own checks under MESH_SEQ 2, with JAX's words: tcn-v1's
    frame count, dprnn-v1's DPRNN_HOP == DPRNN_CHUNK, conv-bilstm-v1's
    pooled grid, tasnet-v1's padded waveform length; each raised before
    any collective, on the active mesh."""
    keys = {"tcn_t": TCN, "dprnn_hop": dict(DPRNN, DPRNN_HOP=4),
            "conv_grid": CONV, "tasnet_len": TASNET}[what]
    keys = dict(keys, MESH_DATA=1, MESH_SEQ=2)
    fresh_hparams.load(keys)
    fresh_hparams.digest()
    hp = load_config(**keys)
    t = {"tcn_t": 15, "dprnn_hop": 16, "conv_grid": 12}.get(what)
    set_active_mesh(JaxMesh(np.asarray(jax.devices()[:2]), ("seq",)))
    sharding.set_active_mesh(sharding.make_mesh(1, 1, devices=range(2),
                                                n_seq=2))
    try:
        if what == "tasnet_len":
            jm, tm = fresh_hparams.get_model()(), TasNet(hp)
            jp = jm.init(jax.random.PRNGKey(0))
            tp = tm.init(torch.Generator())
            want = _error(lambda: jm._separate_wav_padded(
                jp, jnp.zeros((1, 1000))))
            got = _error(lambda: tm._separate_wav_padded(
                tp, torch.zeros(1, 1000)))
        else:
            f = hp.FEATURE_SIZE
            jenc = fresh_hparams.get_encoder()(fresh_hparams, "encoder")
            tencoder = hp.get_encoder()(hp, "encoder")
            jp = jenc.init(jax.random.PRNGKey(0))
            tp = tencoder.init(torch.Generator())
            want = _error(lambda: jenc.apply(jp, jnp.zeros((1, t, f))))
            got = _error(lambda: tencoder.apply(tp, torch.zeros(1, t, f)))
    finally:
        set_active_mesh(None)
        sharding.set_active_mesh(None)
    assert want[0] is ValueError
    assert got == want


def test_torch_seq_conv_models_build(fresh_hparams):
    """MESH_SEQ > 1 builds tcn-v1, dprnn-v1 and conv-bilstm-v1 DaNets and
    tasnet-v1, as JAX does; their routes run dense off a 'seq' mesh
    (serving on one process): the output equals MESH_SEQ 1's."""
    for name, keys in MODELS.items():
        hp = load_config(**dict(keys, MESH_SEQ=2))
        one = load_config(**keys)
        model = hp.get_model()(hp)
        assert isinstance(model, TasNet if name == "tasnet" else TorchDaNet)
        params = model.init(torch.Generator().manual_seed(0))
        wav = torch.from_numpy(np.random.RandomState(0).randn(
            1, 64 * 31).astype(np.float32))
        with torch.no_grad():
            np.testing.assert_array_equal(
                model.separate_wav(params, wav).numpy(),
                one.get_model()(one).separate_wav(params, wav).numpy())
    assert tenc.ConvBiLstmEncoder.SEQ_LEAVES == ""
