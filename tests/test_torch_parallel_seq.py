"""PyTorch port, sequence parallelism (``parallel/seq_parallel.py``,
``ring_attention.py``, ``ulysses.py``, the encoders' MESH_SEQ routes,
``DaNet.separate_sp``, ``effective_bucket``), against the JAX package's
values on the CPU.

The port's mesh runs as real processes: ``parallel/smoke.py`` starts 4
and then 8 gloo ranks, each running several cases; the JAX side runs in
this process on the conftest's 8 CPU devices, with JAX's parameters
carried across (``weights.save_npz``) and numpy-seeded inputs.  Shapes and
tolerances are JAX's own (``tests/test_parallel.py:240-335,426-465,
579-744,820-1016,1058,1107``): the relay BiLSTM stack at B=2, T=64, F=12,
H=16, 2 layers (forward atol 2e-5 / rtol 1e-5 against the dense stack,
gradients 5e-4 / 1e-4), the halo stack at T=128, the GRU relay at F=10,
H=12 (gradients 5e-5 / 1e-4), the relay with data 2 x seq 2 at B=4, T=32,
F=8, H=8; ring and Ulysses attention at B=2, T=32, H=3 / 4, D=8 (atol 2e-5
/ rtol 1e-4), their gradients at T=16 (3e-5 / 1e-3); separate_sp at
JAX's widths (2e-4 / 1e-3).  Trainer steps at data 2 x seq 2 hold the
loss and gradients against JAX's jitted ``train_loss`` on the same mesh
shape (rtol 1e-4; atol 1e-5, rtol 1e-4) and the updated parameters
against the port's one-process step (atol 2e-5, rtol 1e-4); the recurrent
encoders run there at HDIM 32 x 2 layers (JAX's test runs the full 300 x
4 and 600 x 4, which the tier-1 budget does not hold on 4 CPU ranks).
configs/seq-parallel.json runs as written (data 2 x seq 4, bfloat16) on 8
ranks at HDIM 16 x 2 layers against the port's one-process bfloat16 step
(chip_smoke phase 27's bounds), and in float32 against JAX's step on
make_mesh(2, 1, n_seq=4).
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
from danet_tpu.ops import rnn as jrnn  # noqa: E402
from danet_tpu.parallel import batch_sharding, set_active_mesh  # noqa: E402
from danet_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from danet_tpu.parallel import shard_params as jax_shard  # noqa: E402
from danet_tpu.parallel.ring_attention import ring_attention as jring  # noqa: E402,E501
from danet_tpu.parallel.seq_parallel import (bilstm_stack_sp as jbsp,  # noqa: E402,E501
                                             gru_stack_sp as jgsp)
from danet_tpu.parallel.ulysses import ulysses_attention as july  # noqa: E402
from danet_tpu.train.trainer import effective_bucket as jbucket  # noqa: E402
import danet_tpu_torch.models.encoders as tenc  # noqa: E402
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402
from danet_tpu_torch.parallel import seq_parallel, sharding, smoke  # noqa: E402,E501
from danet_tpu_torch.train import Trainer  # noqa: E402
from danet_tpu_torch.train.trainer import effective_bucket  # noqa: E402
from danet_tpu_torch.weights import leaf_names, leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = dict(atol=2e-5, rtol=1e-5)
STACK_GRAD = dict(atol=5e-4, rtol=1e-4)
GRU_GRAD = dict(atol=5e-5, rtol=1e-4)
ATTN = dict(atol=2e-5, rtol=1e-4)
ATTN_GRAD = dict(atol=3e-5, rtol=1e-3)
SEP = dict(atol=2e-4, rtol=1e-3)
GRAD = dict(atol=1e-5, rtol=1e-4)
STEP = dict(atol=2e-5, rtol=1e-4)
BF16_GRAD_REL, BF16_LOSS_REL = 2e-2, 1e-2
RNN_DIMS = [32, 2]
SEQ8_DIMS = [16, 2]
ATTN_KEYS = {"ENCODER_TYPE": "attn-v1", "ATTN_DIM": 32, "ATTN_LAYERS": 2,
             "ATTN_HEADS": 4, "BATCH_SIZE": 4, "DROPOUT_KEEP_PROB": 1.0}
BILSTM = {"ENCODER_TYPE": "bilstm-orig", "BATCH_SIZE": 4,
          "DROPOUT_KEEP_PROB": 1.0, "SP_HALO": 8}
GRU = {"ENCODER_TYPE": "gru-v1", "BATCH_SIZE": 4, "SP_HALO": 8}
SEQ_JSON = "configs/seq-parallel.json"


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


def _assemble(res, case, n, shape):
    """The global output of a ``sp_stack`` case from its ranks' blocks."""
    out = np.full(shape, np.nan, np.float32)
    for r in range(n):
        d = _rank(res, r, case)
        a, b = (int(v) for v in d["rows"])
        t0, t1 = (int(v) for v in d["cols"])
        out[a:b, t0:t1] = d["y"]
        np.testing.assert_array_equal(d["y_nograd"], d["y"])
    assert not np.isnan(out).any()
    return out


class _Narrow:
    """HDIM and N_LAYERS of both packages' recurrent encoders, restored on
    exit with the JAX hparams singleton and its active mesh."""

    def __init__(self, dims):
        self.dims = dims

    def __enter__(self):
        self.saved = dict(jhp.__dict__)
        self.classes = [getattr(m, n) for m in (jenc, tenc)
                        for n in ("BiLstmEncoder", "GruEncoder")]
        self.old = [(c.HDIM, c.N_LAYERS) for c in self.classes]
        if self.dims:
            for c in self.classes:
                c.HDIM, c.N_LAYERS = self.dims
        return self

    def __exit__(self, *exc):
        jhp.__dict__.clear()
        jhp.__dict__.update(self.saved)
        for c, (h, n) in zip(self.classes, self.old):
            c.HDIM, c.N_LAYERS = h, n
        set_active_mesh(None)


def _jax_hp(keys, configs=()):
    jhp.load_json(os.path.join(REPO, "default.json"))
    for c in configs:
        jhp.load_json(os.path.join(REPO, c))
    jhp.load(keys)
    jhp.digest()


def _nest_like(tree, flat: dict):
    return jax.tree_util.tree_map_with_path(
        lambda path, _: flat["/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path)],
        tree)


def _jax_step_values(keys, params_np, src, mesh, configs=()):
    """JAX's (loss, gradients) of ``train_loss`` on ``mesh`` (the active
    mesh, which the 'seq' routes read), sharded by its rules."""
    _jax_hp(keys, configs)
    set_active_mesh(mesh)
    jm = JaxDaNet()
    jp = jm.init(jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(lambda a, b: jnp.asarray(b, a.dtype), jp,
                                _nest_like(jp, params_np))

    def loss_fn(p, x):
        return jm.train_loss(p, x, None)[0]

    vg = jax.jit(jax.value_and_grad(loss_fn))
    l, g = vg(jax_shard(mesh, jp), jax.device_put(src, batch_sharding(mesh)))
    return float(l), _flat(jax.device_get(g))


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


def _src(seed, b, t=16):
    return np.random.RandomState(seed).randn(b, 2, t, 129, 2).astype(
        np.float32)


def _jax_stack_values(fn, layers, x, mesh, **kw):
    """(y, grads of sum(y^2)) of a JAX SP stack, jitted."""
    def run(ps):
        return fn(ps, jnp.asarray(x), mesh, **kw)
    y, g = jax.jit(lambda ps: (run(ps), jax.grad(
        lambda qs: jnp.sum(run(qs) ** 2))(ps)))(layers)
    return np.asarray(y), g


def _dense_values(apply, layers, x):
    """(y, grads of sum(y^2), d sum(y^2) / dx) of JAX's dense stack."""
    def run(ls, xx):
        y = xx
        for p in ls:
            y = apply(p, y)
        return y
    y = jax.jit(run)(layers, jnp.asarray(x))
    g, dx = jax.jit(jax.grad(lambda ls, xx: jnp.sum(run(ls, xx) ** 2),
                             argnums=(0, 1)))(layers, jnp.asarray(x))
    return np.asarray(y), g, np.asarray(dx)


def _named(layer_grads, prefix) -> dict:
    return {"%s%d/%s" % (prefix, i, k): v for i, lg in enumerate(layer_grads)
            for k, v in _flat(jax.device_get(lg)).items()}


def _attn_inputs(seed, b, t, h, d=8):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(3))
    return q, k, v, rng.rand(b, t) > 0.2


def _dense_attention(q, k, v, mask, window=0):
    t = q.shape[1]
    lg = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    full = np.asarray(mask)[:, None, None, :]
    if window:
        qi, ki = np.arange(t)[:, None], np.arange(t)[None, :]
        full = full & ((ki <= qi) & (ki > qi - window))[None, None]
    lg = jnp.where(full, lg, -1e9)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(lg, -1), v)


# ---------------------------------------------------------------- 4 ranks
@pytest.fixture(scope="module")
def sp4(tmp_path_factory):
    """The 4-rank spawn: the relay and halo stacks (BiLSTM and GRU, with
    REMAT, and data 2 x seq 2), ring and Ulysses attention with their
    gradients and the causal band, separate_sp, Trainer steps at data 2 x
    seq 2 and the wave wire at seq 2; and JAX's values for the same
    inputs."""
    d = tmp_path_factory.mktemp("sp4")
    jv, cases = {}, []
    seq4 = {"MESH_DATA": 1, "MESH_SEQ": 4}
    mesh4 = JaxMesh(np.asarray(jax.devices()[:4]), ("seq",))

    # the relay and halo BiLSTM stacks
    bl = [jrnn.bilstm_init(jax.random.PRNGKey(i), 12 if i == 0 else 32, 16)
          for i in range(2)]
    weights.save_npz(str(d / "bl.npz"), jax.device_get(
        {"lstm%d" % i: p for i, p in enumerate(bl)}))
    x64 = np.random.RandomState(0).randn(2, 64, 12).astype(np.float32)
    x128 = np.random.RandomState(0).randn(2, 128, 12).astype(np.float32)
    np.savez(d / "x64.npz", x=x64)
    np.savez(d / "x128.npz", x=x128)
    lstm = lambda p, y: jrnn.bilstm_apply(p, y, "tanh")  # noqa: E731
    y, g, dx = _dense_values(lstm, bl, x64)
    jv["dense64"] = (y, _named(g, "lstm"), dx)
    jv["dense128"] = np.asarray(_dense_values(lstm, bl, x128)[0])
    y, g = _jax_stack_values(jbsp, bl, x64, mesh4, backend="xla")
    jv["relay"] = (y, _named(g, "lstm"))
    for halo in (4, 24):
        y, g = _jax_stack_values(jbsp, bl, x128, mesh4, halo=halo,
                                 backend="xla", scheme="halo")
        jv["halo%d" % halo] = (y, _named(g, "lstm"))
        for remat in (False, True):
            cases.append({"name": "halo%d%s" % (halo, "r" * remat),
                          "kind": "sp_stack", "params": "bl.npz",
                          "x": "x128.npz", "scheme": "halo", "halo": halo,
                          "remat": remat, "keys": seq4})
    for remat in (False, True):
        cases.append({"name": "relay%s" % ("r" * remat), "kind": "sp_stack",
                      "params": "bl.npz", "x": "x64.npz", "remat": remat,
                      "keys": seq4})
    # the GRU stacks
    gl = [jrnn.gru_init(jax.random.PRNGKey(i), 10 if i == 0 else 12, 12)
          for i in range(2)]
    weights.save_npz(str(d / "gl.npz"), jax.device_get(
        {"gru%d" % i: p for i, p in enumerate(gl)}))
    xg = np.random.RandomState(1).randn(2, 64, 10).astype(np.float32)
    np.savez(d / "xg.npz", x=xg)
    y, g, dx = _dense_values(lambda p, yy: jrnn.gru_apply(p, yy), gl, xg)
    jv["gdense"] = (y, _named(g, "gru"), dx)
    for scheme in ("relay", "halo"):
        y, g = _jax_stack_values(jgsp, gl, xg, mesh4, halo=8,
                                 backend="xla", scheme=scheme)
        jv["g" + scheme] = (y, _named(g, "gru"))
        cases.append({"name": "g" + scheme, "kind": "sp_stack",
                      "rnn": "gru", "params": "gl.npz", "x": "xg.npz",
                      "scheme": scheme, "halo": 8, "keys": seq4})
    cases.append({"name": "grelayr", "kind": "sp_stack", "rnn": "gru",
                  "params": "gl.npz", "x": "xg.npz", "remat": True,
                  "keys": seq4})
    # the relay with the batch co-sharded over 'data'
    dl = [jrnn.bilstm_init(jax.random.PRNGKey(7), 8, 8)]
    weights.save_npz(str(d / "dl.npz"), jax.device_get({"lstm0": dl[0]}))
    xd = np.random.RandomState(2).randn(4, 32, 8).astype(np.float32)
    np.savez(d / "xd.npz", x=xd)
    jv["dp"] = np.asarray(jrnn.bilstm_apply(dl[0], jnp.asarray(xd), "tanh"))
    cases.append({"name": "dp", "kind": "sp_stack", "params": "dl.npz",
                  "x": "xd.npz", "keys": {"MESH_DATA": 2, "MESH_SEQ": 2}})

    # ring and Ulysses attention
    attn = {"ring": (_attn_inputs(0, 2, 32, 3), 0),
            "uly": (_attn_inputs(1, 2, 32, 4), 0),
            "cring": (_attn_inputs(2, 2, 32, 4), 11),
            "culy": (_attn_inputs(2, 2, 32, 4), 11)}
    for w in (0, 7):
        for pat in ("ring", "uly"):
            attn["g%s%d" % (pat, w)] = (_attn_inputs(0, 2, 16, 4), w)
    for name, ((q, k, v, mask), w) in attn.items():
        np.savez(d / ("%s.npz" % name), q=q, k=k, v=v, mask=mask)
        pat = "ulysses" if "uly" in name else "ring"
        f = july if pat == "ulysses" else jring

        def sp(q, k, v, f=f, mask=mask, w=w):
            return f(q, k, v, mesh4, key_mask=jnp.asarray(mask),
                     causal_window=w)

        def dense(q, k, v, mask=mask, w=w):
            return _dense_attention(q, k, v, mask, w)
        args = tuple(jnp.asarray(a) for a in (q, k, v))

        def both(f):
            return jax.jit(lambda *a: (f(*a), jax.grad(
                lambda *b: jnp.sum(jnp.sin(f(*b))), argnums=(0, 1, 2))(*a)))
        ysp, gsp = both(sp)(*args)
        ydn, gdn = both(dense)(*args)
        jv["attn_" + name] = (np.asarray(ysp), np.asarray(ydn),
                              [np.asarray(a) for a in gsp],
                              [np.asarray(a) for a in gdn])
        cases.append({"name": "a" + name, "kind": "sp_attention",
                      "x": "%s.npz" % name, "pattern": pat, "window": w,
                      "keys": seq4})

    # separate_sp
    sep = {"sbil": ({"ENCODER_TYPE": "bilstm-orig", "BATCH_SIZE": 2}, 128,
                    "ring"),
           "sring": ({"ENCODER_TYPE": "attn-v1", "ATTN_DIM": 64,
                      "ATTN_LAYERS": 2, "BATCH_SIZE": 2}, 32, "ring"),
           "suly": ({"ENCODER_TYPE": "attn-v1", "ATTN_DIM": 64,
                     "ATTN_LAYERS": 2, "BATCH_SIZE": 2}, 32, "ulysses")}
    for pat in ("ring", "ulysses"):
        sep["sc" + pat] = ({"ENCODER_TYPE": "attn-v1", "ATTN_DIM": 64,
                            "ATTN_LAYERS": 2, "ATTN_CAUSAL": True,
                            "ATTN_LOOKBACK": 12, "SP_ATTN": pat,
                            "BATCH_SIZE": 2}, 32, pat)
    for name, (keys, t, pat) in sep.items():
        mix = np.random.RandomState(0).randn(2, t, 129, 2).astype(np.float32)
        np.savez(d / ("m%s.npz" % name), mix=mix)
        with _Narrow(None):
            _jax_hp(keys)
            jm = JaxDaNet()
            jp = jm.init(jax.random.PRNGKey(0))
            weights.save_npz(str(d / ("p%s.npz" % name)), jax.device_get(jp))
            jv[name] = np.asarray(jax.jit(jm.separate)(
                jp, jnp.asarray(mix)))
        cases.append({"name": name, "kind": "separate_sp",
                      "params": "p%s.npz" % name, "mix": "m%s.npz" % name,
                      "sp_attn": pat, "halo": 24,
                      "keys": dict(keys, **seq4)})

    # Trainer steps at data 2 x seq 2
    src4 = _src(0, 4)
    np.savez(d / "b4.npz", src=src4)
    pa = _flat(weights.to_jax(_save_model(d / "pa.npz", ATTN_KEYS)))
    pbl = _flat(weights.to_jax(_save_model(d / "pbl.npz", BILSTM, RNN_DIMS)))
    pg = _flat(weights.to_jax(_save_model(d / "pg.npz", GRU, RNN_DIMS)))
    steps = {"tring": (dict(ATTN_KEYS, SP_ATTN="ring"), "pa", None),
             "tuly": (dict(ATTN_KEYS, SP_ATTN="ulysses"), "pa", None),
             "tbil": (BILSTM, "pbl", RNN_DIMS),
             "tbilh": (dict(BILSTM, SP_RNN_SCHEME="halo"), "pbl", RNN_DIMS),
             "tgru": (GRU, "pg", RNN_DIMS)}
    flats = {"pa": pa, "pbl": pbl, "pg": pg}
    for name, (keys, p, dims) in steps.items():
        with _Narrow(dims):
            jv[name] = _jax_step_values(
                dict(keys, MESH_DATA=2, MESH_SEQ=2), flats[p], src4,
                jax_make_mesh(2, 1, n_seq=2))
        cases.append({"name": name, "kind": "step", "adam": True,
                      "valid": True, "params": "%s.npz" % p,
                      "batch": "b4.npz", "dims": dims,
                      "keys": dict(keys, MESH_DATA=2, MESH_SEQ=2)})
    cases.append({"name": "tdrop", "kind": "step", "adam": True,
                  "params": "pbl.npz", "batch": "b4.npz", "dims": RNN_DIMS,
                  "keys": dict(BILSTM, MESH_DATA=2, MESH_SEQ=2,
                               DROPOUT_KEEP_PROB=0.8)})
    # the wave wire at seq 2: the STFT runs before the T split
    wave_keys = dict(BILSTM, BATCH_SIZE=2, TRANSFER_DOMAIN="wave",
                     MAX_TRAIN_LEN=None)
    hp = load_config(**dict(wave_keys, MESH_SEQ=2))
    wave = np.random.RandomState(5).randn(4, 1400).astype(np.float32) * 0.3
    from danet_tpu_torch.train.trainer import prepare_batch_wave
    wbatch = prepare_batch_wave(wave, 2, 2, hp.FFT_SIZE, hp.FFT_STRIDE,
                                bucket=effective_bucket(hp))
    np.savez(d / "w2.npz", src=wbatch)
    cases.append({"name": "twave", "kind": "step", "params": "pbl.npz",
                  "batch": "w2.npz", "dims": RNN_DIMS,
                  "keys": dict(wave_keys, MESH_DATA=1, MESH_SEQ=2)})

    with open(d / "spec.json", "w") as f:
        json.dump({"cases": cases}, f)
    smoke.launch(str(d / "spec.json"), str(d / "out"), 4, timeout=500)
    with _Narrow(RNN_DIMS):
        one = {n: _one_process(k, str(d / ("%s.npz" % p)), src4)
               for n, (k, p, _) in steps.items()}
        one["twave"] = _one_process(wave_keys, str(d / "pbl.npz"), wbatch,
                                    adam=False)
    return {"res": smoke.load_results(str(d / "out"), 4), "jax": jv,
            "one": one, "frames": wbatch.shape}


@pytest.mark.parametrize("case", ["relay", "relayr"])
def test_torch_relay_stack_matches_jax(sp4, case):
    """The relay BiLSTM stack over 4 'seq' ranks (with and without REMAT)
    reproduces the dense stack (atol 2e-5, rtol 1e-5), with and without
    autograd, and JAX's relay stack; the gradients of sum(y^2) summed over
    the ranks equal the dense stack's (atol 5e-4, rtol 1e-4) and JAX's
    relay's, and every rank holds the input's whole gradient."""
    y, g, dx = sp4["jax"]["dense64"]
    jy, jg = sp4["jax"]["relay"]
    got = _assemble(sp4["res"], case, 4, y.shape[:2] + (32,))
    np.testing.assert_allclose(got, y, **EXACT)
    np.testing.assert_allclose(got, jy, **EXACT)
    for r in range(4):
        d = _rank(sp4["res"], r, case)
        _close(_whole(d, "grads"), g, **STACK_GRAD)
        _close(_whole(d, "grads"), jg, **STACK_GRAD)
        np.testing.assert_allclose(d["dx"], dx, **STACK_GRAD)


def test_torch_relay_remat_equals_plain(sp4):
    """REMAT on the relay recomputes the chunk scans in the backward: its
    gradients equal the plain relay's (atol 1e-4, rtol 1e-4, JAX's
    test_sp_remat_gradients_match bound); so do the halo stack's and the
    GRU relay's."""
    for a, b in (("relay", "relayr"), ("halo24", "halo24r"),
                 ("halo4", "halo4r"), ("grelay", "grelayr")):
        for r in range(4):
            _close(_whole(_rank(sp4["res"], r, b), "grads"),
                   _whole(_rank(sp4["res"], r, a), "grads"),
                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("halo", [4, 24])
def test_torch_halo_stack_matches_jax(sp4, halo):
    """The halo BiLSTM stack over 4 ranks equals JAX's halo stack (output
    2e-5 / 1e-5, gradients 5e-4 / 1e-4), and as in JAX its error against
    the exact scan shrinks with the halo and stays within 5 % of the
    output's mean magnitude (+ 1e-3) at halo 24."""
    exact = sp4["jax"]["dense128"]
    jy, jg = sp4["jax"]["halo%d" % halo]
    got = _assemble(sp4["res"], "halo%d" % halo, 4, exact.shape[:2] + (32,))
    np.testing.assert_allclose(got, jy, **EXACT)
    for r in range(4):
        _close(_whole(_rank(sp4["res"], r, "halo%d" % halo), "grads"), jg,
               **STACK_GRAD)
    e = {h: np.abs(_assemble(sp4["res"], "halo%d" % h, 4, got.shape)
                   - exact).mean() for h in (4, 24)}
    assert e[24] < e[4], e
    assert e[24] < 0.05 * np.abs(exact).mean() + 1e-3, e


@pytest.mark.parametrize("scheme", ["relay", "halo"])
def test_torch_gru_stack_matches_jax(sp4, scheme):
    """The GRU stack over 4 ranks: the relay equals the dense stack (2e-5
    / 1e-5; gradients 5e-5 / 1e-4), and both schemes equal JAX's
    gru_stack_sp, forward and gradients."""
    y, g, dx = sp4["jax"]["gdense"]
    jy, jg = sp4["jax"]["g" + scheme]
    got = _assemble(sp4["res"], "g" + scheme, 4, y.shape)
    np.testing.assert_allclose(got, jy, **EXACT)
    if scheme == "relay":
        np.testing.assert_allclose(got, y, **EXACT)
    for r in range(4):
        d = _rank(sp4["res"], r, "g" + scheme)
        _close(_whole(d, "grads"), jg, **GRU_GRAD)
        if scheme == "relay":
            _close(_whole(d, "grads"), g, **GRU_GRAD)
            np.testing.assert_allclose(d["dx"], dx, **GRU_GRAD)


def test_torch_relay_dp_cosharding(sp4):
    """The relay with the batch co-sharded over 'data' (data 2 x seq 2):
    each rank runs its rows' chunk, and the blocks make the dense stack
    (atol 2e-5, rtol 1e-5)."""
    want = sp4["jax"]["dp"]
    got = _assemble(sp4["res"], "dp", 4, want.shape)
    np.testing.assert_allclose(got, want, **EXACT)
    rows = {tuple(int(v) for v in _rank(sp4["res"], r, "dp")["rows"])
            for r in range(4)}
    assert rows == {(0, 2), (2, 4)}


@pytest.mark.parametrize("case", ["ring", "uly", "cring", "culy"])
def test_torch_sp_attention_exact(sp4, case):
    """Ring (H=3) and Ulysses (H=4) attention over 4 ranks equal full
    attention with the key mask (atol 2e-5, rtol 1e-4), and JAX's
    collectives; with causal_window 11 (straddling the T/S=8 chunks) the
    dense attention under the same global band."""
    jy, dense, _, _ = sp4["jax"]["attn_" + case]
    for r in range(4):
        got = _rank(sp4["res"], r, "a" + case)["y"]
        np.testing.assert_allclose(got, dense, **ATTN)
        np.testing.assert_allclose(got, jy, **ATTN)


@pytest.mark.parametrize("case", ["gring0", "gring7", "guly0", "guly7"])
def test_torch_sp_attention_gradients(sp4, case):
    """Both patterns differentiate like dense attention: the q, k, v
    gradients of sum(sin(y)), whole on every rank, equal the dense ones
    and JAX's collectives' (atol 3e-5, rtol 1e-3), the band (window 7) in
    the backward too."""
    _, _, gsp, gdn = sp4["jax"]["attn_" + case]
    for r in range(4):
        d = _whole(_rank(sp4["res"], r, "a" + case), "grads")
        for n, a, b in zip("qkv", gdn, gsp):
            np.testing.assert_allclose(d[n], a, err_msg=n, **ATTN_GRAD)
            np.testing.assert_allclose(d[n], b, err_msg=n, **ATTN_GRAD)


@pytest.mark.parametrize("case", ["sbil", "sring", "suly", "scring",
                                  "sculysses"])
def test_torch_separate_sp_matches_jax(sp4, case):
    """DaNet.separate_sp over 4 ranks: bilstm-orig at full width (the
    relay, T=128) and attn-v1 (ATTN_DIM 64, 2 blocks, T=32) with ring and
    Ulysses attention, also under ATTN_CAUSAL with a lookback of 12 that
    straddles the chunks, equal JAX's single-device separate on every rank
    (atol 2e-4, rtol 1e-3), the bound of JAX's separate_sp tests against
    the same."""
    exact = sp4["jax"][case]
    for r in range(4):
        got = _rank(sp4["res"], r, case)["y"]
        assert got.shape == exact.shape
        np.testing.assert_allclose(got, exact, **SEP)


@pytest.mark.parametrize("case", ["tring", "tuly", "tbil", "tbilh", "tgru"])
def test_torch_seq_steps_match_jax(sp4, case):
    """Trainer steps at data 2 x seq 2 (attn-v1 with ring and Ulysses
    attention; bilstm-orig with the relay and with the halo scheme at
    SP_HALO 8 = T / 2, exact at S=2; gru-v1's relay): every rank's loss
    and gradients equal JAX's train_loss on the same mesh shape (rtol
    1e-4; atol 1e-5, rtol 1e-4), and the parameters after one Adam step
    the port's one-process step (atol 2e-5, rtol 1e-4)."""
    jl, jg = sp4["jax"][case]
    want = sp4["one"][case]
    for r in range(4):
        d = _rank(sp4["res"], r, case)
        np.testing.assert_allclose(float(d["loss"]), jl, rtol=1e-4)
        _close(_whole(d, "grads"), jg, **GRAD)
        _close(_whole(d, "params"), want["params"], **STEP)


def test_torch_seq_dropout_step_is_finite(sp4):
    """bilstm-orig at data 2 x seq 2 with DROPOUT_KEEP_PROB 0.8: the step
    runs finite and the replicas agree (the ranks of a 'seq' group draw
    the same whole mask and keep their chunk)."""
    ranks = [_rank(sp4["res"], r, "tdrop") for r in range(4)]
    for d in ranks:
        assert np.isfinite(float(d["step_loss"]))
        for k, v in _whole(d, "params").items():
            np.testing.assert_array_equal(v, _whole(ranks[0], "params")[k])


def test_torch_wave_wire_under_mesh_seq(sp4):
    """The wave wire at MESH_SEQ 2: the batch pads to the bucket's frame
    quantum (effective_bucket: 2 frames), the STFT runs on each rank
    before the T split, and the step's loss and gradients equal the
    one-process wave-wire step (rtol 2e-4, atol 2e-5, JAX's
    test_wave_wire_under_mesh_seq bound)."""
    want = sp4["one"]["twave"]
    for r in range(2):
        d = _rank(sp4["res"], r, "twave")
        np.testing.assert_allclose(float(d["loss"]), want["loss"],
                                   rtol=2e-4)
        _close(_whole(d, "grads"), want["grads"], rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------- 8 ranks
@pytest.fixture(scope="module")
def sp8(tmp_path_factory):
    """The 8-rank spawn: configs/seq-parallel.json as written (data 2 x
    seq 4, bfloat16, the relay) at narrow widths, and in float32 with the
    relay and the halo scheme, against JAX's make_mesh(2, 1, n_seq=4)
    step."""
    d = tmp_path_factory.mktemp("sp8")
    src = _src(6, 8, t=32)
    np.savez(d / "b8.npz", src=src)
    ps = _flat(weights.to_jax(_save_model(d / "ps.npz", {}, SEQ8_DIMS,
                                          configs=[SEQ_JSON])))
    f32 = {"COMPUTE_DTYPE": "float32"}
    jv = {}
    for name, keys in (("f32", f32),
                       ("f32h", dict(f32, SP_RNN_SCHEME="halo"))):
        with _Narrow(SEQ8_DIMS):
            jv[name] = _jax_step_values(keys, ps, src,
                                        jax_make_mesh(2, 1, n_seq=4),
                                        configs=[SEQ_JSON])
    cases = [{"name": n, "kind": "step", "params": "ps.npz",
              "batch": "b8.npz", "dims": SEQ8_DIMS, "configs": [SEQ_JSON],
              "keys": k}
             for n, k in (("json", {}), ("f32", f32),
                          ("f32h", dict(f32, SP_RNN_SCHEME="halo")))]
    with open(d / "spec.json", "w") as f:
        json.dump({"cases": cases}, f)
    smoke.launch(str(d / "spec.json"), str(d / "out"), 8, timeout=500)
    with _Narrow(SEQ8_DIMS):
        one = _one_process({"MESH_DATA": 1, "MESH_SEQ": 1},
                           str(d / "ps.npz"), src, [SEQ_JSON], adam=False)
    return {"res": smoke.load_results(str(d / "out"), 8), "jax": jv,
            "one": one}


def test_torch_seq_parallel_json_runs_as_written(sp8):
    """configs/seq-parallel.json as written (data 2 x seq 4, bfloat16,
    B=8, the relay) on 8 ranks at HDIM 16 x 2 layers: finite, the loss
    within 1e-2 and each gradient within 2e-2 of its peak of the
    one-process bfloat16 step (chip_smoke phase 27's bounds)."""
    want = sp8["one"]
    for r in range(8):
        d = _rank(sp8["res"], r, "json")
        assert abs(float(d["loss"]) - want["loss"]) <= \
            BF16_LOSS_REL * abs(want["loss"])
        for k, ref in want["grads"].items():
            got = d["grads/" + k]
            assert np.all(np.isfinite(got)), k
            assert np.abs(got - ref).max() <= \
                BF16_GRAD_REL * max(np.abs(ref).max(), 1e-30), k


@pytest.mark.parametrize("case", ["f32", "f32h"])
def test_torch_seq_parallel_json_matches_jax(sp8, case):
    """The same config in float32, the relay and the halo scheme (the
    halo min(SP_HALO 16, T / S = 8) = 8 frames): every rank's loss and
    gradients equal JAX's step on make_mesh(2, 1, n_seq=4) (rtol 1e-4;
    atol 1e-5, rtol 1e-4)."""
    jl, jg = sp8["jax"][case]
    for r in range(8):
        d = _rank(sp8["res"], r, case)
        np.testing.assert_allclose(float(d["loss"]), jl, rtol=1e-4)
        _close(_whole(d, "grads"), jg, **GRAD)


# ---------------------------------------------------------------- in process
def test_torch_mesh_from_hparams_seq():
    """MESH_DATA 2 x MESH_SEQ 4 makes a mesh with a trailing 'seq' axis,
    as JAX's mesh_from_hparams; 'seq' ranks are neighbours and share their
    rows."""
    hp = load_config(MESH_DATA=2, MESH_SEQ=4, BATCH_SIZE=8)
    mesh = sharding.mesh_from_hparams(hp, devices=range(8))
    assert mesh.shape == {"data": 2, "model": 1, "seq": 4}
    assert mesh.devices.reshape(-1).tolist() == list(range(8))
    for r in range(8):
        m = sharding.make_mesh(2, 1, devices=range(8), n_seq=4)
        m.rank, m.coords = r, dict(zip(m.axis_names, np.argwhere(
            m.devices == r)[0].tolist()))
        assert sharding.batch_rows(m, 8) == slice(4 * (r // 4),
                                                  4 * (r // 4) + 4)


def test_torch_mesh_strategy_encoder_guard(fresh_hparams):
    """A MESH_* strategy the encoder cannot route fails at model build with
    JAX's ValueError (toy under MESH_SEQ, MESH_PIPE, MESH_EXPERT; pipe and
    seq together)."""
    for key in ("MESH_SEQ", "MESH_PIPE", "MESH_EXPERT"):
        fresh_hparams.load({"ENCODER_TYPE": "toy", key: 2})
        fresh_hparams.digest()
        with pytest.raises(ValueError) as want:
            JaxDaNet()
        with pytest.raises(ValueError) as got:
            TorchDaNet(load_config(**{"ENCODER_TYPE": "toy", key: 2}))
        assert str(got.value) == str(want.value)
        fresh_hparams.load({key: 1})
    with pytest.raises(ValueError, match="cannot combine"):
        TorchDaNet(load_config(ENCODER_TYPE="bilstm-orig", MESH_PIPE=2,
                               MESH_SEQ=2))


@pytest.mark.parametrize("keys,want", [
    ({"TIME_BUCKET": 12, "MESH_SEQ": 1}, 12),
    ({"TIME_BUCKET": 12, "MESH_SEQ": 8}, 24),
    ({"TIME_BUCKET": None, "MESH_SEQ": 8}, 8),
    ({"TIME_BUCKET": None, "MESH_SEQ": 1}, None),
    ({"ENCODER_TYPE": "dprnn-v1", "DPRNN_CHUNK": 8, "MESH_SEQ": 2,
      "TIME_BUCKET": 12}, 48),
    ({"ENCODER_TYPE": "dprnn-v1", "DPRNN_CHUNK": 8, "MESH_SEQ": 2,
      "TIME_BUCKET": None}, 16),
    ({"ENCODER_TYPE": "conv-bilstm-v1", "MESH_SEQ": 2, "TIME_BUCKET": 12},
     24),
    ({"ENCODER_TYPE": "conv-bilstm-v1", "MESH_SEQ": 2, "TIME_BUCKET": None},
     8)])
def test_torch_effective_bucket_seq_alignment(fresh_hparams, keys, want):
    """Under MESH_SEQ the time bucket rounds up so that every padded T
    splits into MESH_SEQ chunks of the encoder's sp_granularity (dprnn-v1
    DPRNN_CHUNK, conv-bilstm-v1 4): JAX's effective_bucket value, case by
    case."""
    fresh_hparams.load(keys)
    assert jbucket(fresh_hparams) == want
    assert effective_bucket(load_config(**keys)) == want


def test_torch_sp_halo_zero_rejected():
    """SP_HALO 0 and an unknown SP_RNN_SCHEME are rejected with JAX's
    words, before any collective."""
    mesh = sharding.make_mesh(1, 1, devices=range(4), n_seq=4)
    x = torch.zeros(2, 64, 8)
    with pytest.raises(AssertionError, match="halo must be >= 1"):
        seq_parallel.bilstm_stack_sp([], x, mesh, halo=0, scheme="halo")
    with pytest.raises(ValueError, match="SP_RNN_SCHEME"):
        seq_parallel.bilstm_stack_sp([], x, mesh, scheme="bogus")
    with pytest.raises(ValueError, match="SP_RNN_SCHEME"):
        seq_parallel.gru_stack_sp([], x, mesh, scheme="bogus")


def test_torch_seq_leaves_owned_by_seq():
    """On a mesh with 'seq' the layers of bilstm-orig's and gru-v1's
    stacks are owned by 'seq' (each rank computes its chunk's part of
    their gradient); the heads, estimators and attention blocks by no
    axis (computed whole on every rank of the group)."""
    mesh = sharding.make_mesh(2, 1, devices=range(8), n_seq=4)
    for enc in ("bilstm-orig", "gru-v1", "attn-v1"):
        hp = load_config(ENCODER_TYPE=enc, ATTN_DIM=32, ATTN_LAYERS=1)
        with _Narrow([8, 2]):
            model = TorchDaNet(hp)
            params = model.init(torch.Generator())
        owners = dict(zip(leaf_names(params),
                          sharding.leaf_owners(params, mesh, model)))
        for name, owner in owners.items():
            rnn_leaf = name.startswith(("encoder/lstm", "encoder/gru"))
            assert owner == ("seq" if rnn_leaf else None), (enc, name)
