"""PyTorch port, moe-v1 on one device: the mixture-of-experts forms of
``danet_tpu_torch/parallel/expert.py`` and the ``MoEAttentionEncoder``,
against the JAX package on the CPU with the same numpy inputs and the same
weights (carried by ``danet_tpu_torch.weights``).

Routing is discrete: a top-k choice or a capacity drop that fell otherwise
in one package would show as an error of the size of a whole expert's
output, not as rounding.  The routers here are random (scale 0.5 on the
forms, the encoder's own 0.02 on the model), so that no two
probabilities of a token tie within float32 rounding; exact ties are
tested on their own (the lower expert index first, as ``jax.lax.top_k``).
Narrow widths: B=2, T=24, d 12, 4 experts of 16 on the forms; ATTN_DIM 32,
2 heads, 2 layers, MLP x2, 4 experts, T = 64 on the model.

Tolerances: 1e-6 on float32 forwards; 2e-5 atol and 1e-4 rtol on
gradients, on the train and valid losses, on the SNR and on an optimizer
step; 1e-4 on ``separate_wav``; bfloat16 forwards to two bf16 ulps of the
output's peak (JAX's CPU backend rounds some intermediates inside a
fusion otherwise than PyTorch's eager steps).
"""
import copy

import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from danet_tpu import optim as joptim  # noqa: E402
from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
from danet_tpu.ops import nn as jnn  # noqa: E402
from danet_tpu.parallel import expert as jex  # noqa: E402
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.hparams import DEFAULT_JSON, load_config  # noqa: E402
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402
from danet_tpu_torch.models import encoders as tenc  # noqa: E402
from danet_tpu_torch.parallel import expert as tex  # noqa: E402
from danet_tpu_torch.train import Trainer  # noqa: E402

B, T, D, E, FF = 2, 24, 12, 4, 16
GRAD = dict(atol=2e-5, rtol=1e-4)
NARROW = dict(ENCODER_TYPE="moe-v1", ATTN_DIM=32, ATTN_HEADS=2,
              ATTN_LAYERS=2, ATTN_MLP_MULT=2, MOE_EXPERTS=4, BATCH_SIZE=2)
MODEL_T = 64
FORMS = {"soft": (jex.moe_mlp, tex.moe_mlp, {}),
         "dropless": (jex.moe_mlp_topk_dropless, tex.moe_mlp_topk_dropless,
                      {"k": 2}),
         "dropless-k1": (jex.moe_mlp_topk_dropless,
                         tex.moe_mlp_topk_dropless, {"k": 1}),
         "topk": (jex.moe_mlp_topk, tex.moe_mlp_topk,
                  {"k": 2, "capacity_factor": 1.25}),
         "topk-k1": (jex.moe_mlp_topk, tex.moe_mlp_topk,
                     {"k": 1, "capacity_factor": 1.0}),
         # demand of 2 x 48 slots for 4 x 12: tokens drop
         "topk-drops": (jex.moe_mlp_topk, tex.moe_mlp_topk,
                        {"k": 2, "capacity_factor": 0.5})}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, atol, rtol=0.0, err_msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=rtol, err_msg=err_msg)


def _moe_params(seed=3):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return jax.device_get({
        "router": jnn.uniform_init(ks[0], (D, E), 0.5),
        "w_in": jnn.uniform_init(ks[1], (E, D, FF), 0.3),
        "w_out": jnn.uniform_init(ks[2], (E, FF, D), 0.3)})


def _x(seed=4, t=T):
    return np.random.RandomState(seed).randn(B, t, D).astype(np.float32)


# ------------------------------------------------------------ the forms
@pytest.mark.parametrize("form", sorted(FORMS))
def test_torch_moe_forms_match_jax(fresh_hparams, form):
    """Each form's output (1e-6) and the gradients of sum(y * dy) in
    router, w_in, w_out and x (2e-5 / 1e-4) against JAX's."""
    jfn, tfn, kw = FORMS[form]
    p, x = _moe_params(), _x()
    dy = np.random.RandomState(5).randn(B, T, D).astype(np.float32)
    names = ("router", "w_in", "w_out")
    want, vjp = jax.vjp(lambda r, wi, wo, xx: jfn(
        {"router": r, "w_in": wi, "w_out": wo}, xx, **kw),
        *[jnp.asarray(p[n]) for n in names], jnp.asarray(x))
    jgrads = vjp(jnp.asarray(dy))
    tp = {n: torch.from_numpy(np.array(p[n])).requires_grad_(True)
          for n in names}
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tfn(tp, tx, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, D)
    _close(got.detach(), want, 1e-6, 1e-6)
    (got * torch.from_numpy(dy)).sum().backward()
    for name, g, r in zip(names + ("x",), [tp[n].grad for n in names]
                          + [tx.grad], jgrads):
        _close(g, r, err_msg=name, **GRAD)
    assert float(tp["router"].grad.abs().max()) > 0


@pytest.mark.parametrize("form", ["soft", "dropless", "topk"])
def test_torch_moe_forms_bf16_match_jax(fresh_hparams, form):
    """The forms on bfloat16 activations (routing in float32 from them):
    a bfloat16 output within two bf16 ulps of the peak of JAX's."""
    jfn, tfn, kw = FORMS[form]
    p, x = _moe_params(), _x()
    want = np.asarray(jfn(p, jnp.asarray(x).astype(jnp.bfloat16),
                          **kw).astype(jnp.float32))
    got = tfn(weights.from_jax(p), torch.from_numpy(x).to(torch.bfloat16),
              **kw)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    _close(got.float(), want, 2 * ulp)


def test_torch_moe_capacity_drops_tokens_like_jax(fresh_hparams):
    """At capacity factor 0.5 some top-k slots drop: the port's dispatch
    and combine tensors equal JAX's (dispatch exactly, the gated combine
    at 1e-6), the same number of slots is kept, fewer than k N, and a
    dropped slot contributes nothing to the output."""
    p, x = _moe_params(), _x()
    xf = x.reshape(B * T, D)
    logits = xf @ np.asarray(p["router"])
    cap = tex._capacity(B * T, E, 2, 0.5)
    assert cap == jex._capacity(B * T, E, 2, 0.5) == 12
    jd, jc = jex._topk_dispatch(jnp.asarray(logits), 2, cap)
    td, tc = tex._topk_dispatch(torch.from_numpy(logits), 2, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    _close(tc, jc, 1e-6)
    kept = float(td.sum())
    assert kept == float(jd.sum()) and kept < 2 * B * T
    # each expert holds at most cap tokens, each slot at most one
    assert float(td.sum(0).max()) == 1.0
    assert torch.all(td.sum((0, 2)) <= cap)


def test_torch_moe_dispatch_overflow_and_ties(fresh_hparams):
    """(test_parallel.py:1442) Every token routed to expert 0 with one
    slot: only token 0 is kept, the rest contribute zero, where
    ``torch.nn.functional.one_hot`` of an index past the capacity would
    raise.  All-equal logits tie every expert: both packages take the
    lower indices first (experts 0 and 1 at k = 2), slot for slot."""
    logits = np.zeros((6, 4), np.float32)
    logits[:, 0] = 10.0
    d, c = tex._topk_dispatch(torch.from_numpy(logits), 1, 1)
    assert float(d.sum()) == 1.0 and float(d[0, 0, 0]) == 1.0
    assert float(c[1:].sum()) == 0.0
    ties = np.zeros((5, 4), np.float32)
    for k, cap in ((2, 3), (3, 5)):
        jd, jc = jex._topk_dispatch(jnp.asarray(ties), k, cap)
        td, tc = tex._topk_dispatch(torch.from_numpy(ties), k, cap)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        _close(tc, jc, 1e-7)
        assert set(np.nonzero(td.numpy().sum((0, 2)))[0]) <= set(range(k))
    vals, idx = tex._top_k(torch.tensor([[0.25, 0.25, 0.5, 0.0]]), 2)
    assert idx.tolist() == [[2, 0]] and vals.tolist() == [[0.5, 0.25]]


def test_torch_moe_dropless_equals_capacity_without_drops(fresh_hparams):
    """(test_parallel.py:1359) Where capacity cannot drop (factor E: C =
    N), the dropless form equals the capacity form (1e-5), and the
    dropless form is positionwise: chunking T changes nothing (1e-6)."""
    p, x = weights.from_jax(_moe_params()), torch.from_numpy(_x())
    want = tex.moe_mlp_topk(p, x, k=2, capacity_factor=float(E))
    got = tex.moe_mlp_topk_dropless(p, x, k=2)
    _close(got, want, 1e-5, 1e-5)
    chunked = torch.cat([tex.moe_mlp_topk_dropless(p, x[:, :7], k=2),
                         tex.moe_mlp_topk_dropless(p, x[:, 7:], k=2)], dim=1)
    _close(chunked, got, 1e-6, 1e-6)


def test_torch_moe_capacity_matches_jax(fresh_hparams):
    """_capacity over token counts, expert counts, k and factors, the
    edges included (at least 1 slot; at most N, reached when E < k cf)."""
    for n in (1, 2, 5, 48, 2048):
        for e in (1, 3, 4, 8):
            for k in (1, 2, 3):
                for cf in (0.01, 0.5, 1.0, 1.25, 4.0, 100.0):
                    assert tex._capacity(n, e, k, cf) \
                        == jex._capacity(n, e, k, cf), (n, e, k, cf)
    assert tex._capacity(5, 4, 2, 0.01) == 1
    assert tex._capacity(5, 1, 2, 1.25) == 5
    assert tex._capacity(2048, 8, 2, 1.25) == 640


# ------------------------------------------------------------ the encoder
def _spectra(seed, b=2, t=MODEL_T, f=129):
    x = np.abs(np.random.RandomState(seed).randn(b, t, f)).astype(np.float32)
    x[1, t - 20:] = 0.0
    return x


def _src_ri(seed, b=2, n=2, t=MODEL_T, f=129):
    rs = np.random.RandomState(seed)
    z = rs.randn(b, n, t, f) + 1j * rs.randn(b, n, t, f)
    z[1, :, t - 20:] = 0.0
    return np.stack([z.real, z.imag], -1).astype(np.float32)


def _pair(hp_jax, **keys):
    """(jax model, its params as numpy, the port's model) at NARROW +
    ``keys``."""
    cfg = dict(NARROW, **keys)
    hp_jax.load(cfg)
    hp_jax.digest()
    jm = JaxDaNet()
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    return jm, jp, TorchDaNet(load_config(**cfg))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + k + "/") if isinstance(v, dict)
                   else {prefix + k: np.asarray(v)})
    return out


def test_torch_moe_init_matches_jax_layout(fresh_hparams):
    """moe-v1's init: the same leaf names and shapes as JAX's (block<i>/
    moe/{router [d, E], w_in [E, d, MLP d], w_out [E, MLP d, d]}), no
    mlp_in or mlp_out; the router uniform within 0.02 and the experts within
    sqrt(6 / (d + MLP d)); registered as "moe-v1", a subclass of attn-v1."""
    jm, jp, tm = _pair(fresh_hparams)
    assert isinstance(tm.encoder, tenc.MoEAttentionEncoder)
    assert isinstance(tm.encoder, tenc.AttentionEncoder)
    want = _flat(jp)
    mine = _flat(weights.to_jax(tm.init(torch.Generator().manual_seed(0))))
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in want.items()}
    assert mine["encoder/block1/moe/w_in"].shape == (4, 32, 64)
    assert not any("mlp_in" in k for k in mine)
    assert np.abs(mine["encoder/block0/moe/router"]).max() <= 0.02
    assert np.abs(mine["encoder/block0/moe/w_out"]).max() <= np.sqrt(
        6.0 / (32 + 64))
    tm.hp.MOE_EXPERTS = None
    assert tm.encoder._n_experts() == 4


@pytest.mark.parametrize("keys", [{"MOE_TOP_K": 0}, {"MOE_TOP_K": 2},
                                  {"MOE_TOP_K": 2, "ATTN_CAUSAL": True,
                                   "ATTN_LOOKBACK": 8}])
def test_torch_moe_encoder_matches_jax(fresh_hparams, keys):
    """The encoder's forward (inference: soft, or dropless top-2; with
    ATTN_CAUSAL the chunked band, 8 chunks of 8) against JAX's, every row,
    1e-6."""
    jm, jp, tm = _pair(fresh_hparams, **keys)
    x = _spectra(1)
    want = np.asarray(jm.encoder.apply(jp["encoder"], jnp.asarray(x)))
    got = tm.encoder.apply(weights.from_jax(jp)["encoder"],
                           torch.from_numpy(x))
    assert tuple(got.shape) == (2, MODEL_T, 129, 20)
    _close(got, want, 1e-6, 1e-6)


@pytest.fixture(scope="module", params=[(0, 1.25), (2, 1.25), (2, 0.25)],
                ids=["soft", "top2", "top2-drops"])
def moe_ref(request):
    """JAX's moe-v1 at (MOE_TOP_K, MOE_CAPACITY_FACTOR): the soft mixture,
    top-2 at 1.25, and top-2 at 0.25, where the train step's capacity (16
    slots an expert for 256 top-2 claims over 4 experts) drops tokens: its
    parameters, train_loss with its gradients and one optimizer step (with
    the optimizer state), valid_metrics, and separate_wav (L = 4032, T =
    64)."""
    from danet_tpu.hparams import hparams as jhp
    k, cf = request.param
    saved = copy.copy(jhp.__dict__)
    try:
        jhp.load_json(DEFAULT_JSON)
        jm, jp, _ = _pair(jhp, MOE_TOP_K=k, MOE_CAPACITY_FACTOR=cf)
        batch = jnp.asarray(_src_ri(2))
        (loss, aux), g = jax.value_and_grad(jm.train_loss, has_aux=True)(
            jp, batch)
        opt = joptim.make_optimizer(jhp)
        upd, opt_state = opt.update(g, opt.init(jp), jp)
        stepped = optax.apply_updates(jp, upd)
        vm = jm.valid_metrics(jp, batch)
        wav = (np.random.RandomState(3).randn(2, 4032) * 0.5).astype(
            np.float32)
        out = {"k": k, "cf": cf, "params": jp, "loss": float(loss),
               "snr": float(aux["snr"]), "grads": jax.device_get(g),
               "stepped": jax.device_get(stepped),
               "state": jax.tree_util.tree_map(np.asarray, {
                   "params": stepped, "opt_state": opt_state, "step": 1,
                   "epoch": 0}),
               "valid": {k: float(vm[k]) for k in ("loss", "SNR")},
               "wav_in": wav,
               "wav": np.asarray(jm.separate_wav(jp, jnp.asarray(wav)))}
    finally:
        jhp.__dict__.clear()
        jhp.__dict__.update(saved)
    return out


def _port(ref):
    return TorchDaNet(load_config(**dict(NARROW, MOE_TOP_K=ref["k"],
                                         MOE_CAPACITY_FACTOR=ref["cf"])))


def test_torch_moe_train_loss_and_grads_match_jax(fresh_hparams, moe_ref,
                                                  monkeypatch):
    """train_loss (soft, or top-2 with capacity 1.25 or 0.25, where every
    block drops top-2 claims) and its gradient for every parameter, the
    experts' 3-D weights and the routers included, against JAX's
    value_and_grad: 2e-5 / 1e-4."""
    tm = _port(moe_ref)
    kept = []
    real = tex._topk_dispatch

    def recording(logits, k, cap):
        d, c = real(logits, k, cap)
        kept.append((float(d.sum()), k * logits.shape[0]))
        return d, c
    monkeypatch.setattr(tex, "_topk_dispatch", recording)
    trainer = Trainer(tm, tm.hp, "cpu")
    state = trainer.init_state(params=moe_ref["params"])
    m, grads = trainer.loss_and_grads(state["params"],
                                      torch.from_numpy(_src_ri(2)))
    assert len(kept) == (2 if moe_ref["k"] else 0)        # one per block
    if moe_ref["cf"] < 1.0:
        assert all(n < claims for n, claims in kept), kept
    _close(m["loss"], moe_ref["loss"], **GRAD)
    _close(m["SNR"], moe_ref["snr"], **GRAD)
    names = weights.leaf_names(state["params"])
    ref = weights.leaves(weights.from_jax(moe_ref["grads"]))
    assert len(grads) == len(ref) and "encoder/block0/moe/router" in names
    for name, a, b in zip(names, grads, ref):
        _close(a, b, err_msg=name, **GRAD)
        if "moe/" in name:
            assert float(a.abs().max()) > 0, name


def test_torch_moe_valid_metrics_match_jax(fresh_hparams, moe_ref):
    """valid_metrics (inference: the soft or the dropless form) against
    JAX's loss and SNR: 2e-5 / 1e-4."""
    tm = _port(moe_ref)
    with torch.no_grad():
        vm = tm.valid_metrics(weights.from_jax(moe_ref["params"]),
                              torch.from_numpy(_src_ri(2)))
    for k in ("loss", "SNR"):
        _close(float(vm[k]), moe_ref["valid"][k], err_msg=k, **GRAD)


def test_torch_moe_trainer_step_and_state_match_jax(fresh_hparams, moe_ref):
    """One CPU Trainer step against value_and_grad + danet_tpu.optim: every
    parameter, and Adam's mu and nu, within 2e-5 / 1e-4 of JAX's state,
    which ``weights.from_jax_state`` carries (the moe sub-trees, 3-D
    leaves and their moments included) and ``Trainer.restore`` takes
    bit for bit."""
    tm = _port(moe_ref)
    trainer = Trainer(tm, tm.hp, "cpu")
    state = trainer.init_state(params=moe_ref["params"])
    m = trainer.train_step(state, _src_ri(2))
    _close(m["loss"], moe_ref["loss"], **GRAD)
    tree = weights.from_jax_state(moe_ref["state"])
    names = weights.leaf_names(state["params"])
    assert weights.leaf_names(tree["params"]) == names
    assert weights.leaf_names(tree["opt"]["mu"]) == names
    assert tree["opt"]["mu"]["encoder"]["block1"]["moe"]["w_in"].shape \
        == (4, 32, 64)
    for name, a, b in zip(names, weights.leaves(state["params"]),
                          weights.leaves(tree["params"])):
        _close(a.detach(), b, err_msg=name, **GRAD)
    for moments, ref in ((state["opt"].mu, tree["opt"]["mu"]),
                         (state["opt"].nu, tree["opt"]["nu"])):
        for name, a, b in zip(names, moments, weights.leaves(ref)):
            _close(a, b, err_msg=name, atol=2e-5 * max(
                1.0, float(np.abs(b).max())), rtol=1e-4)
    restored = trainer.restore(trainer.init_state(params=moe_ref["params"]),
                               tree)
    for a, b in zip(weights.leaves(restored["params"])
                    + restored["opt"].mu + restored["opt"].nu,
                    weights.leaves(tree["params"])
                    + weights.leaves(tree["opt"]["mu"])
                    + weights.leaves(tree["opt"]["nu"])):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    assert restored["step"] == 1 and restored["opt"].count == 1


def test_torch_moe_separate_wav_matches_jax(fresh_hparams, moe_ref):
    """separate_wav of moe-v1 (L = 4032, T = 64) against JAX's: 1e-4."""
    tm = _port(moe_ref)
    got = tm.separate_wav(weights.from_jax(moe_ref["params"]),
                          torch.from_numpy(moe_ref["wav_in"])).numpy()
    assert got.shape == moe_ref["wav"].shape and np.all(np.isfinite(got))
    _close(got, moe_ref["wav"], 1e-4)


def test_torch_moe_checkpoint_round_trip(fresh_hparams, moe_ref, tmp_path):
    """A moe-v1 train state after one step saved and loaded into a fresh
    state: parameters, Adam moments, count and step bit for bit."""
    tm = _port(moe_ref)
    trainer = Trainer(tm, tm.hp, "cpu")
    state = trainer.init_state(params=moe_ref["params"])
    trainer.train_step(state, _src_ri(2))
    path = str(tmp_path / "moe")
    trainer.save_params(state, path)
    loaded = trainer.load_params(
        trainer.init_state(torch.Generator().manual_seed(9)), path)

    def by_name(st):        # the fresh state's own init orders its leaves
        names = weights.leaf_names(st["params"])
        return {(part, n): t for part, ts in (
            ("p", weights.leaves(st["params"])), ("mu", st["opt"].mu),
            ("nu", st["opt"].nu)) for n, t in zip(names, ts)}
    want, got = by_name(state), by_name(loaded)
    assert sorted(want) == sorted(got) and ("p", "encoder/block1/moe/w_out") \
        in want
    for key, t in want.items():
        assert torch.equal(got[key], t), key
    assert (loaded["step"], loaded["opt"].count) == (1, 1)


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
    {"MOE_TOP_K": 2, "ATTN_CAUSAL": True, "ATTN_LOOKBACK": 8},
    {"MOE_TOP_K": 0}])
def test_torch_moe_warm_step_reads_nothing_on_host(fresh_hparams, keys):
    """A warm train step of moe-v1 (the top-2 dispatch with its cumsum, the
    chunked band's reshapes and concatenations) reads no value on the
    host, as a CUDA graph capture needs."""
    hp = load_config(**dict(NARROW, **keys))
    tr = Trainer(TorchDaNet(hp), hp, "cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    batch = _src_ri(5)
    tr.train_step(state, batch)
    src = tr.ingest(tr._put(tr._host_batch(batch)))
    with _HostReads() as reads:
        m, _ = tr.loss_and_grads(state["params"], src, state["generator"])
    assert reads.seen == []
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("encoder,jax_refuses", [("attn-v1", True),
                                                 ("moe-v1", False)])
def test_torch_moe_mesh_expert_check(fresh_hparams, encoder, jax_refuses):
    """MESH_EXPERT 2: attn-v1 gets JAX's ValueError word for word; moe-v1,
    which JAX builds, builds (expert parallelism, parallel/expert.py)."""
    keys = dict(NARROW, ENCODER_TYPE=encoder, MESH_EXPERT=2)
    fresh_hparams.load(keys)
    fresh_hparams.digest()
    if jax_refuses:
        with pytest.raises(ValueError) as want:
            JaxDaNet()
        with pytest.raises(ValueError) as got:
            TorchDaNet(load_config(**keys))
        assert str(got.value) == str(want.value)
    else:
        JaxDaNet()
        hp = load_config(**keys)
        assert TorchDaNet(hp).hp is hp
