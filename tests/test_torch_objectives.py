"""PyTorch port, estimators and objectives: the model half of
``configs/tpu.json`` (the kmeans inference estimator, ANCHOR_AUX_LOSS,
EVAL_SI_SNR) and the other training options, against the JAX package on
the CPU with the same weights and the same numpy inputs.

Covered: ``ops/loss.py``'s ``combinations_gather``, ``batch_cross_snr``,
``si_snr``, ``pit_si_snr_loss``, ``dc_loss``, ``bss_eval_sources`` and
``pit_mse_loss(method='dense')``; the ``truth``,
``truth-threshold`` and ``kmeans`` estimators; ``DaNet.train_loss`` under
each option (kmeans with ANCHOR_AUX_LOSS, DC_LOSS_WEIGHT with both weight
types, 'pit-si-snr' alone and with the auxiliary, REG_APPLY with L1 and
L2, MIX_SNR_DB with JAX's draw injected); ``valid_metrics`` with
EVAL_SI_SNR and EVAL_SDR; the Trainer's DC and SI_SNR columns; and
``configs/tpu.json``'s model keys through a Trainer step and the serve
CLI.

Narrow widths: attn-v1 at ATTN_DIM 32, 2 heads, 1 layer, MLP x2 on the
dense attention (one case on the flash path, JAX's Pallas kernel in
interpret mode, T=128), and bilstm-orig at 6 units x 2 layers (JAX's
Pallas LSTM in interpret mode).  Tolerances: 1e-6 (atol and rtol) on
forward outputs; 2e-5 atol + 1e-4 rtol on losses and gradients of
``train_loss`` (float32 sums in another order through the encoder),
but 1e-3 dB on the 'pit-si-snr' loss, alone and in ``train_loss``: its
pairwise <t, e> is a cancelling float32 sum over the waveform's samples,
which float32 sums in another order move by more than 1e-4 relative;
0.05 dB on BSS-eval (its float32 Gram is ill-conditioned and LAPACK's
solve rounds differently from XLA's; JAX's own test allows the same
against a float64 oracle); bfloat16 at 5e-2 + 2e-2 rtol.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import danet_tpu.models.encoders as jenc  # noqa: E402
from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
from danet_tpu.models import estimators as jest  # noqa: E402
from danet_tpu.ops import loss as jloss  # noqa: E402
import danet_tpu_torch.models.encoders as tenc  # noqa: E402
from danet_tpu_torch import serve, weights  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402
from danet_tpu_torch.models import estimators as test_  # noqa: E402
from danet_tpu_torch.ops import loss as tloss  # noqa: E402
from danet_tpu_torch.train import Trainer  # noqa: E402

TPU_JSON = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "tpu.json")
NARROW = dict(ENCODER_TYPE="attn-v1", ATTN_DIM=32, ATTN_HEADS=2,
              ATTN_LAYERS=1, ATTN_MLP_MULT=2, ATTN_BACKEND="xla")
# tpu.json's model half: the shipping estimators and objectives
SHIPPING = dict(INFER_ESTIMATOR_METHOD="kmeans", ANCHOR_AUX_LOSS=0.5,
                EVAL_SI_SNR=True)
# the trainer keys of tpu.json that the port still refuses, and the data
# and wire keys that go with them, at their default.json values
TRAINER_DEFAULTS = dict(TRAIN_STEPS_PER_CALL=1, WATCHDOG_SECS=0,
                        TRANSFER_DOMAIN="spectra", TRANSFER_DTYPE="float32",
                        WAVE_PCM_SCALE=1.0, DATASET_TYPE="toy",
                        METRICS_EVERY=1)
FWD = dict(atol=1e-6, rtol=1e-6)
GRAD = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=5e-2, rtol=2e-2)
DB = dict(atol=1e-3, rtol=0.0)     # the 'pit-si-snr' loss, in dB


def _close(a, b, atol, rtol):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), atol=atol,
                               rtol=rtol)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _src_ri(seed, b=2, n=2, t=32, f=129, pad_from=None):
    """Per-source ri spectra; row 1 zero from ``pad_from`` on."""
    rs = np.random.RandomState(seed)
    z = rs.randn(b, n, t, f) + 1j * rs.randn(b, n, t, f)
    if pad_from is not None:
        z[1, :, pad_from:] = 0.0
    return np.stack([z.real, z.imag], -1).astype(np.float32)


def _models(hp_jax, **keys):
    """(JAX model, its params, the port's model, the params as tensors)
    from default.json + NARROW + ``keys``; JAX reads the global hparams
    (restored by the fresh_hparams fixture)."""
    keys = dict(NARROW, **keys)
    hp_jax.load(keys)
    hp_jax.digest()
    jm = JaxDaNet()
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, TorchDaNet(load_config(**keys)), \
        weights.from_jax(jax.device_get(jp))


# ------------------------------------------------------------- ops/loss.py
@pytest.mark.parametrize("total,k", [(5, 2), (4, 3), (3, 1), (2, 3)])
def test_torch_combinations_gather_matches_jax(total, k):
    """(test_loss.py:135) Every k-subset of the rows, in
    itertools.combinations order, equal to JAX's (none when k > total)."""
    data = np.random.RandomState(total).randn(total, 2, 3).astype(np.float32)
    got = tloss.combinations_gather(_t(data), k).numpy()
    want = np.asarray(jloss.combinations_gather(jnp.asarray(data), k))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["real", "complex", "ri"])
def test_torch_batch_cross_snr_matches_jax(kind):
    """(test_loss.py:145) The pairwise SNR matrix [B, m, n] of real,
    complex and ri stacks against JAX's, 1e-6; its diagonal is
    ``batch_snr`` of each source."""
    rs = np.random.RandomState(6)
    shape = (3, 2, 8, 4, 2) if kind == "ri" else (3, 2, 8, 4)
    clear = rs.randn(*shape)
    noisy = clear + 0.2 * rs.randn(*shape)
    if kind == "complex":
        clear = clear + 1j * rs.randn(*shape)
        noisy = noisy + 1j * rs.randn(*shape)
    clear, noisy = (x.astype(np.complex64 if kind == "complex"
                             else np.float32) for x in (clear, noisy))
    ri = kind == "ri"
    got = tloss.batch_cross_snr(torch.from_numpy(clear),
                                torch.from_numpy(noisy), complex_ri=ri)
    want = jloss.batch_cross_snr(jnp.asarray(clear), jnp.asarray(noisy),
                                 complex_ri=ri)
    assert tuple(got.shape) == want.shape == (3, 2, 2)
    _close(got, want, **FWD)
    for i in range(2):
        diag = tloss.batch_snr(torch.from_numpy(clear[:, i]),
                               torch.from_numpy(noisy[:, i]), complex_ri=ri)
        _close(got[:, i, i], diag, **FWD)


def test_torch_si_snr_matches_jax(fresh_hparams):
    rs = np.random.RandomState(0)
    x = rs.randn(3, 2, 500).astype(np.float32)
    y = (0.7 * x + 0.3 * rs.randn(3, 2, 500)).astype(np.float32)
    ref = jloss.si_snr(jnp.asarray(x), jnp.asarray(y))
    out = tloss.si_snr(_t(x), _t(y))
    assert tuple(out.shape) == (3, 2)
    _close(out, ref, **FWD)


@pytest.mark.parametrize("n_src", [2, 3])
def test_torch_pit_si_snr_loss_matches_jax(fresh_hparams, n_src):
    """The loss, the chosen permutation and the gradient in the
    estimates; then the loss with one estimate a scaled copy of a target,
    where the Gram form's noise power cancels to a rounding residue and
    is held at 0 (the gradient there follows the residue's sign, which
    float32 sums in another order decide, so only the loss is compared)."""
    rs = np.random.RandomState(1)
    x = rs.randn(3, n_src, 400).astype(np.float32)
    y = (x[:, ::-1] + 0.5 * rs.randn(3, n_src, 400)).astype(np.float32)

    def jfn(yv):
        loss, _, idx = jloss.pit_si_snr_loss(jnp.asarray(x), yv)
        return loss, idx

    (jl, jidx), jg = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(y))
    ty = _t(y).requires_grad_(True)
    loss, perms, idx = tloss.pit_si_snr_loss(_t(x), ty)
    loss.backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(perms.numpy(),
                                  jloss.permutations_array(n_src))
    _close(loss.detach(), jl, **DB)
    _close(ty.grad, jg, **GRAD)
    y[0, 0] = 2.0 * x[0, -1]
    (jl, jidx), _ = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(y))
    loss, _, idx = tloss.pit_si_snr_loss(_t(x), _t(y))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert np.isfinite(float(loss))
    _close(loss, jl, **DB)


@pytest.mark.parametrize("weighted", [True, False])
def test_torch_dc_loss_matches_jax(fresh_hparams, weighted):
    """dc_loss with the mixture-magnitude ('mr') weights and uniform ones;
    row 1 zero-padded from frame 5 on (tied labels, zero weights); the
    loss and its gradient in the embeddings."""
    src = _src_ri(2, t=8, f=9, pad_from=5)
    src_pwr = np.sqrt((src ** 2).sum(-1))
    mix = src.sum(1)
    mix_pwr = np.sqrt((mix ** 2).sum(-1))
    embed = np.random.RandomState(3).randn(2, 8, 9, 5).astype(np.float32)
    w = mix_pwr if weighted else None

    def jfn(e):
        return jloss.dc_loss(e, jnp.asarray(src_pwr),
                             None if w is None else jnp.asarray(w))

    jl, jg = jax.value_and_grad(jfn)(jnp.asarray(embed))
    te = _t(embed).requires_grad_(True)
    loss = tloss.dc_loss(te, _t(src_pwr), None if w is None else _t(w))
    loss.backward()
    _close(loss.detach(), jl, **FWD)
    _close(te.grad, jg, **GRAD)


def _bss_oracle(ref, est, ell):
    """float64 least squares on explicit delay matrices: the BSS Eval v3
    decomposition with no FFT, Toeplitz or ridge."""
    n, t = ref.shape
    a = np.zeros((t + ell - 1, n * ell))
    for j in range(n):
        for d in range(ell):
            a[d:d + t, j * ell + d] = ref[j]
    out = {"sdr": [], "sir": [], "sar": []}
    for i in range(n):
        e = np.zeros(t + ell - 1)
        e[:t] = est[i]
        p_all = a @ np.linalg.lstsq(a, e, rcond=None)[0]
        own = a[:, i * ell:(i + 1) * ell]
        s_target = own @ np.linalg.lstsq(own, e, rcond=None)[0]
        e_interf, e_artif = p_all - s_target, e - p_all

        def db(x, y):
            return 10 * np.log10(np.sum(x ** 2) / np.sum(y ** 2))
        out["sdr"].append(db(s_target, e_interf + e_artif))
        out["sir"].append(db(s_target, e_interf))
        out["sar"].append(db(s_target + e_interf, e_artif))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("filt_len", [8, 32])
def test_torch_bss_eval_matches_jax_and_oracle(fresh_hparams, filt_len):
    """bss_eval_sources on two batch rows of filtered, mixed and noisy
    estimates, one call for the batch: each row against JAX's (one call
    per row, as jax.vmap maps it) and the float64 oracle, 0.05 dB."""
    rs = np.random.RandomState(7)
    n, t = 2, 400
    refs, ests = [], []
    for _ in range(2):
        ref = rs.randn(n, t)
        ests.append(np.stack([
            np.convolve(ref[0], [0.9, 0.2, -0.1])[:t] + 0.3 * ref[1]
            + 0.1 * rs.randn(t),
            0.8 * ref[1] + 0.2 * np.roll(ref[0], 3) + 0.05 * rs.randn(t)]))
        refs.append(ref)
    refs = np.asarray(refs, np.float32)
    ests = np.asarray(ests, np.float32)
    out = tloss.bss_eval_sources(_t(refs), _t(ests), filt_len=filt_len)
    for row in range(2):
        jax_out = jloss.bss_eval_sources(jnp.asarray(refs[row]),
                                         jnp.asarray(ests[row]),
                                         filt_len=filt_len)
        oracle = _bss_oracle(refs[row].astype(np.float64),
                             ests[row].astype(np.float64), filt_len)
        one = tloss.bss_eval_sources(_t(refs[row]), _t(ests[row]),
                                     filt_len=filt_len)
        for k in ("sdr", "sir", "sar"):
            assert tuple(out[k].shape) == (2, n)
            _close(one[k], out[k][row], atol=1e-5, rtol=0.0)
            _close(out[k][row], jax_out[k], atol=0.05, rtol=0.0)
            _close(out[k][row], oracle[k], atol=0.05, rtol=0.0)


@pytest.mark.parametrize("n_src", [2, 3])
@pytest.mark.parametrize("complex_ri", [False, True])
def test_torch_pit_mse_dense_matches_jax_and_gemm(fresh_hparams, n_src,
                                                  complex_ri):
    """pit_mse_loss(method='dense') against JAX's 'dense' (loss, choice,
    gradient) and against the port's own 'gemm'."""
    rs = np.random.RandomState(3)
    shape = (3, n_src, 4, 6) + ((2,) if complex_ri else ())
    x = rs.randn(*shape).astype(np.float32)
    y = rs.randn(*shape).astype(np.float32)

    def jfn(yv):
        loss, _, idx = jloss.pit_mse_loss(jnp.asarray(x), yv,
                                          complex_ri=complex_ri,
                                          method="dense")
        return loss, idx

    (jl, jidx), jg = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(y))
    ty = _t(y).requires_grad_(True)
    loss, _, idx = tloss.pit_mse_loss(_t(x), ty, complex_ri=complex_ri,
                                      method="dense")
    loss.backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(loss.detach(), jl, **FWD)
    _close(ty.grad, jg, **GRAD)
    gemm, _, gidx = tloss.pit_mse_loss(_t(x), _t(y), complex_ri=complex_ri)
    np.testing.assert_array_equal(gidx.numpy(), idx.numpy())
    _close(gemm, loss.detach(), **FWD)


# -------------------------------------------------------------- estimators
def _estimator_inputs(seed, n_src, dtype=np.float32):
    src = _src_ri(seed, b=2, n=n_src, t=6, f=9)
    src_pwr = np.sqrt((src ** 2).sum(-1)) * 3.0   # some bins above 5
    mix_pwr = np.sqrt((src.sum(1) ** 2).sum(-1)) * 3.0
    embed = np.random.RandomState(seed + 1).randn(2, 6, 9, 5)
    return embed.astype(dtype), src_pwr, mix_pwr


def _estimators(hp_jax, method, **keys):
    hp_jax.load(dict(keys, NUM_ANCHOR=4, EMBED_SIZE=5))
    hp_jax.digest()
    jcls = hp_jax.get_estimator(method)
    thp = load_config(NUM_ANCHOR=4, EMBED_SIZE=5, **keys)
    return jcls(hp_jax, "est"), thp.get_estimator(method)(thp, "est")


@pytest.mark.parametrize("method", ["truth", "truth-threshold"])
def test_torch_truth_estimators_match_jax(fresh_hparams, method):
    je, te = _estimators(fresh_hparams, method)
    embed, src_pwr, mix_pwr = _estimator_inputs(4, 2)
    assert 0 < int((mix_pwr > 5).sum()) < mix_pwr.size
    ref = je.apply({}, jnp.asarray(embed), src_pwr=jnp.asarray(src_pwr),
                   mix_pwr=jnp.asarray(mix_pwr))
    out = te.apply({}, _t(embed), src_pwr=_t(src_pwr), mix_pwr=_t(mix_pwr))
    assert te.USE_TRUTH and tuple(out.shape) == (2, 2, 5)
    _close(out, ref, **FWD)


@pytest.mark.parametrize("n_src", [2, 3])
@pytest.mark.parametrize("n_iter", [0, 1, 5])
def test_torch_kmeans_estimator_matches_jax(fresh_hparams, n_src, n_iter):
    """kmeans (the anchor's attractors refined KMEANS_ITER times) with the
    mixture magnitude, and without it (uniform weights, as in
    separation's estimator call under no mix_pwr); the anchors drawn by
    JAX's init."""
    je, te = _estimators(fresh_hparams, "kmeans", MAX_N_SIGNAL=n_src,
                         KMEANS_ITER=n_iter)
    assert isinstance(te, test_.AnchoredEstimator) and not te.USE_TRUTH
    params = je.init(jax.random.PRNGKey(3))
    tp = weights.from_jax(jax.device_get(params))
    embed, _, mix_pwr = _estimator_inputs(5, n_src)
    for mp in (mix_pwr, None):
        ref = je.apply(params, jnp.asarray(embed),
                       mix_pwr=None if mp is None else jnp.asarray(mp))
        out = te.apply(tp, _t(embed), mix_pwr=None if mp is None else _t(mp))
        assert tuple(out.shape) == (2, n_src, 5)
        _close(out, ref, **FWD)
    if n_iter == 0:   # no refinement: the anchor estimator's attractors
        anchor = jest.AnchoredEstimator(fresh_hparams, "a")
        _close(out, anchor.apply(params, jnp.asarray(embed)), **FWD)


def test_torch_kmeans_estimator_bf16_matches_jax(fresh_hparams):
    """The N=2 path in bfloat16 (its float32 weight sums rounded to the
    compute dtype as JAX rounds them), KMEANS_ITER 5, at bf16 tolerance."""
    je, te = _estimators(fresh_hparams, "kmeans", KMEANS_ITER=5)
    params = je.init(jax.random.PRNGKey(3))
    tp = weights.from_jax(jax.device_get(params))
    embed, _, mix_pwr = _estimator_inputs(6, 2)
    ref = je.apply(params, jnp.asarray(embed, jnp.bfloat16),
                   mix_pwr=jnp.asarray(mix_pwr))
    out = te.apply(tp, _t(embed).to(torch.bfloat16), mix_pwr=_t(mix_pwr))
    assert out.dtype == torch.bfloat16
    _close(out.float(), np.asarray(ref.astype(jnp.float32)), **BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_attractor_sets_pairs_match_jax(fresh_hparams, dtype):
    """The N=2 attractor sets (kmeans' init and ANCHOR_AUX_LOSS) and their
    gradients by the embedding and the anchors, over K = 32 x 129 bins:
    the port sums slot 1 directly, JAX as the totals minus slot 0; the
    objectives' tolerances (bfloat16 at its own)."""
    rs = np.random.RandomState(11)
    embed = rs.randn(2, 32, 129, 20).astype(np.float32)
    anchors = rs.randn(6, 20).astype(np.float32)
    combs = np.asarray([(i, j) for i in range(6) for j in range(i + 1, 6)])
    w = rs.randn(2, len(combs), 2, 20).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def jax_sets(e, a):
        return jest.AnchoredEstimator._attractor_sets_pairs(
            e.astype(jdt), a.astype(jdt), combs).astype(jnp.float32)

    ref = jax_sets(jnp.asarray(embed), jnp.asarray(anchors))
    jg = jax.grad(lambda e, a: jnp.sum(jax_sets(e, a) * w), (0, 1))(
        jnp.asarray(embed), jnp.asarray(anchors))
    te, ta = _t(embed).requires_grad_(), _t(anchors).requires_grad_()
    tdt = getattr(torch, dtype)
    out = test_.AnchoredEstimator._attractor_sets_pairs(
        te.to(tdt), ta.to(tdt), torch.from_numpy(combs)).float()
    tg = torch.autograd.grad(torch.sum(out * _t(w)), (te, ta))
    assert tuple(out.shape) == (2, len(combs), 2, 20)
    fwd, grad = (FWD, GRAD) if dtype == "float32" else (BF16, BF16)
    _close(out.detach(), ref, **fwd)
    for a, b in zip(tg, jg):
        _close(a, b, **grad)


# --------------------------------------------------------------- train_loss
def _train_loss_case(jm, jp, tm, tp, batch, rng=None, generator=None):
    """train_loss and every gradient, port vs JAX; -> the port's aux."""
    loss_tol = DB if tm.hp.TRAIN_LOSS_TYPE == "pit-si-snr" else GRAD
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(jp, jnp.asarray(batch), rng)
    for p in weights.leaves(tp):
        p.requires_grad_(True)
    loss, aux = tm.train_loss(tp, _t(batch), generator)
    grads = torch.autograd.grad(loss, weights.leaves(tp), allow_unused=True)
    ref = weights.leaves(weights.from_jax(jax.device_get(jg)))
    assert len(grads) == len(ref)
    _close(loss.detach(), jl, **loss_tol)
    _close(aux["snr"].detach(), jaux["snr"], **GRAD)
    np.testing.assert_array_equal(aux["perm_idx"].numpy(),
                                  np.asarray(jaux["perm_idx"]))
    assert set(aux) == set(jaux)
    if "dc" in aux:
        _close(aux["dc"].detach(), jaux["dc"], **GRAD)
    for g, r in zip(grads, ref):
        _close(torch.zeros_like(r) if g is None else g, r, **GRAD)
    return aux


TRAIN_OPTIONS = {
    "kmeans-aux": dict(INFER_ESTIMATOR_METHOD="kmeans", ANCHOR_AUX_LOSS=0.5),
    "dc-mr": dict(DC_LOSS_WEIGHT=0.3, DC_WEIGHT_TYPE="mr"),
    "dc-none": dict(DC_LOSS_WEIGHT=0.3, DC_WEIGHT_TYPE="none"),
    "si-snr": dict(TRAIN_LOSS_TYPE="pit-si-snr"),
    "si-snr-aux": dict(TRAIN_LOSS_TYPE="pit-si-snr",
                       INFER_ESTIMATOR_METHOD="kmeans", ANCHOR_AUX_LOSS=0.5),
    "reg-l1": dict(REG_APPLY=True, REG_TYPE="L1", REG_SCALE=1e-3),
    "reg-l2": dict(REG_APPLY=True, REG_TYPE="L2", REG_SCALE=1e-2),
}


@pytest.mark.parametrize("option", sorted(TRAIN_OPTIONS))
def test_torch_train_loss_options_match_jax(fresh_hparams, option):
    """train_loss of the narrow attn-v1 under each training option: the
    loss, SNR, chosen permutations, DC term and every gradient against
    JAX's value_and_grad(train_loss); row 1 zero-padded from frame 20."""
    jm, jp, tm, tp = _models(fresh_hparams, **TRAIN_OPTIONS[option])
    _train_loss_case(jm, jp, tm, tp, _src_ri(10, pad_from=20))


def test_torch_train_loss_mix_snr_db_matches_jax(fresh_hparams,
                                                 monkeypatch):
    """MIX_SNR_DB: the port's draw replaced by JAX's (fold_in(rng, 0x5e2),
    uniform in +/- 3 dB), the rest against JAX; without a generator, as
    JAX without an rng, no gains are drawn."""
    jm, jp, tm, tp = _models(fresh_hparams, MIX_SNR_DB=6.0)
    rng = jax.random.PRNGKey(5)
    batch = _src_ri(11)
    db = np.asarray(jax.random.uniform(
        jax.random.fold_in(rng, 0x5e2), (2, 2, 1, 1, 1), minval=-3.0,
        maxval=3.0))
    draw = tm.mix_gain_db((2, 2, 1, 1, 1), 6.0, torch.Generator())
    assert tuple(draw.shape) == db.shape and float(draw.abs().max()) <= 3.0
    monkeypatch.setattr(tm, "mix_gain_db", lambda *a: _t(db))
    _train_loss_case(jm, jp, tm, tp, batch, rng, torch.Generator())
    tp = weights.from_jax(jax.device_get(jp))
    _train_loss_case(jm, jp, tm, tp, batch)


def test_torch_train_loss_bilstm_kmeans_dc_matches_jax(fresh_hparams,
                                                       monkeypatch):
    """bilstm-orig (6 units x 2 layers; JAX's Pallas LSTM in interpret
    mode) with kmeans, ANCHOR_AUX_LOSS and the DC auxiliary."""
    for cls in (jenc.BiLstmEncoder, tenc.BiLstmEncoder):
        monkeypatch.setattr(cls, "HDIM", 6)
        monkeypatch.setattr(cls, "N_LAYERS", 2)
    keys = dict(ENCODER_TYPE="bilstm-orig", INFER_ESTIMATOR_METHOD="kmeans",
                ANCHOR_AUX_LOSS=0.5, DC_LOSS_WEIGHT=0.1)
    fresh_hparams.load(dict(keys, LSTM_BACKEND="pallas-interpret"))
    fresh_hparams.digest()
    jm = JaxDaNet()
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TorchDaNet(load_config(**keys))
    _train_loss_case(jm, jp, tm, weights.from_jax(jax.device_get(jp)),
                     _src_ri(12, b=3, t=9))


def test_torch_shipping_flash_path_matches_jax(fresh_hparams):
    """tpu.json's model half on attn-v1's flash path (JAX's Pallas flash
    kernel in interpret mode, T=128): train_loss with its gradients, and
    valid_metrics with SI_SNR; the kmeans parameters travel through
    to_jax / from_jax under infer_estimator/anchors."""
    jm, jp, tm, tp = _models(fresh_hparams, ATTN_BACKEND="flash", **SHIPPING)
    assert tuple(tp["infer_estimator"]["anchors"].shape) == (6, 20)
    back = weights.to_jax(tp)
    np.testing.assert_array_equal(back["infer_estimator"]["anchors"],
                                  np.asarray(jp["infer_estimator"]["anchors"]))
    batch = _src_ri(13, t=128, pad_from=100)
    with pltpu.force_tpu_interpret_mode():
        _train_loss_case(jm, jp, tm, tp, batch)
        ref = jax.jit(jm.valid_metrics)(jp, jnp.asarray(batch))
    out = tm.valid_metrics(weights.from_jax(jax.device_get(jp)), _t(batch))
    assert set(out) == set(ref) == {"loss", "SNR", "SI_SNR", "separated_ri"}
    for k in out:
        _close(out[k], ref[k], **FWD)


# ------------------------------------------------------------ valid_metrics
def test_torch_valid_metrics_si_snr_sdr_match_jax(fresh_hparams):
    """valid_metrics with EVAL_SI_SNR and EVAL_SDR (BSS_FILT_LEN 32) through
    kmeans: loss, SNR, SI_SNR and the separated spectra at 1e-6, SDR, SIR
    and SAR at 0.05 dB."""
    jm, jp, tm, tp = _models(fresh_hparams, INFER_ESTIMATOR_METHOD="kmeans",
                             EVAL_SI_SNR=True, EVAL_SDR=True,
                             BSS_FILT_LEN=32)
    batch = _src_ri(14, t=16)
    ref = jm.valid_metrics(jp, jnp.asarray(batch))
    out = tm.valid_metrics(tp, _t(batch))
    assert set(out) == set(ref)
    for k in ("loss", "SNR", "SI_SNR", "separated_ri"):
        _close(out[k], ref[k], **FWD)
    for k in ("SDR", "SIR", "SAR"):
        _close(out[k], ref[k], atol=0.05, rtol=0.0)


# ----------------------------------------------------------------- Trainer
def test_torch_trainer_reports_dc_and_si_snr(fresh_hparams):
    """train_step returns DC (the raw deep-clustering term, JAX's
    diagnostic column) with DC_LOSS_WEIGHT > 0; valid_step returns every
    metric but the separated spectra, as JAX's does."""
    jm, jp, tm, _ = _models(fresh_hparams, DC_LOSS_WEIGHT=0.2, **SHIPPING)
    batch = _src_ri(15)
    (jl, jaux) = jm.train_loss(jp, jnp.asarray(batch))
    trainer = Trainer(tm, tm.hp, "cpu")
    state = trainer.init_state(params=jax.device_get(jp))
    m = trainer.train_step(state, batch)
    assert set(m) == {"loss", "SNR", "DC"}
    _close(m["loss"], jl, **GRAD)
    _close(m["DC"], jaux["dc"], **GRAD)
    v = trainer.valid_step(state, batch)
    assert set(v) == {"loss", "SNR", "SI_SNR"}
    assert all(np.isfinite(float(x)) for x in v.values())


def test_torch_tpu_json_model_keys(fresh_hparams, tmp_path):
    """configs/tpu.json builds under the port, and a Trainer takes its
    trainer keys (the int16 wave wire at WAVE_PCM_SCALE 32768,
    TRAIN_STEPS_PER_CALL 8, WATCHDOG_SECS), all and one at a time
    (TRANSFER_DTYPE int16 alone, on the spectra wire, raises JAX's
    ValueError); with them at default.json's values a Trainer takes a
    step on the CPU (narrow widths, bfloat16 as the config says)."""
    hp = load_config(TPU_JSON)
    model = TorchDaNet(hp)
    assert type(model.infer_estimator).__name__ == "KMeansEstimator"
    trainer = Trainer(model, hp, "cpu")
    assert (trainer._wave_mode, trainer._wire_dtype, trainer._pcm_scale,
            trainer._steps_per_call) == (True, "int16", 32768.0, 8)
    for key in ("TRAIN_STEPS_PER_CALL", "WATCHDOG_SECS", "TRANSFER_DOMAIN",
                "TRANSFER_DTYPE"):
        one = dict(TRAINER_DEFAULTS)
        del one[key]
        hp = load_config(TPU_JSON, **one)
        if key == "TRANSFER_DTYPE":
            with pytest.raises(ValueError, match="int16"):
                Trainer(TorchDaNet(hp), hp, "cpu")
        else:
            Trainer(TorchDaNet(hp), hp, "cpu")
    keys = dict(TRAINER_DEFAULTS, ATTN_DIM=32, ATTN_HEADS=2, ATTN_LAYERS=1,
                ATTN_MLP_MULT=2, BATCH_SIZE=2)
    hp = load_config(TPU_JSON, **keys)
    assert hp.COMPUTE_DTYPE == "bfloat16" and hp.DROPOUT_KEEP_PROB == 0.9
    trainer = Trainer(TorchDaNet(hp), hp, "cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    m = trainer.train_step(state, _src_ri(16))
    v = trainer.valid_step(state, _src_ri(17))
    assert set(v) == {"loss", "SNR", "SI_SNR"}
    assert all(np.isfinite(float(x)) for x in list(m.values())
               + list(v.values()))


def test_torch_serve_cli_tpu_json_kmeans(fresh_hparams, tmp_path):
    """The serve CLI answers with tpu.json's kmeans estimator (narrow
    widths layered over it), the same as the in-process Separator; and the
    port's separate_wav with kmeans matches JAX's in float32, 1e-4."""
    narrow = dict(ATTN_DIM=32, ATTN_HEADS=2, ATTN_LAYERS=1, ATTN_MLP_MULT=2)
    jm, jp, tm, tp = _models(fresh_hparams, **SHIPPING)
    wav = (np.random.RandomState(18).randn(2, 3000) * 0.3).astype(np.float32)
    ref = np.asarray(jm.separate_wav(jp, jnp.asarray(wav)))
    out = tm.separate_wav(tp, _t(wav)).numpy()
    assert out.shape == ref.shape
    _close(out, ref, atol=1e-4, rtol=0.0)

    from danet_tpu_torch.data import audio
    w_path, cfg = str(tmp_path / "w.npz"), str(tmp_path / "narrow.json")
    weights.save_npz(w_path, jax.device_get(jp))
    with open(cfg, "w") as f:
        json.dump(narrow, f)
    wav_path = str(tmp_path / "mix.wav")
    audio.save_wav_raw(wav_path, wav[0], 8000)
    prefix = str(tmp_path / "out")
    serve._main(["run", "-c", TPU_JSON, "-c", cfg, "-w", w_path, "-if",
                 wav_path, "-o", prefix, "--device", "cpu"])
    sep = serve.load_separator(w_path, [TPU_JSON, cfg], "cpu")
    assert sep.hp.INFER_ESTIMATOR_METHOD == "kmeans"
    want = sep.separate(audio.load_wav_raw(wav_path, 8000))
    assert want.shape == (2, 3000) and np.all(np.isfinite(want))
    for i in range(2):
        got = audio.load_wav_raw("%s_%d.wav" % (prefix, i), 8000)
        np.testing.assert_allclose(got, want[i], atol=2.0 / 32767)
