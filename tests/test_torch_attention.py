"""PyTorch port, attention: the flash-attention kernels' plain versions,
``FlashAttention``, ``resolve_attn_fn``, layer norm and GELU, and the
``attn-v1`` encoder (encoder, train loss and gradients, a Trainer step,
``separate_wav``) against the JAX package on the CPU.

The JAX side runs its real Pallas flash kernel (the stock TPU kernel that
``danet_tpu/ops/pallas/attention.py`` wraps) inside
``pltpu.force_tpu_interpret_mode()``; those runs are module-scoped
fixtures, computed once.  Inputs come from numpy seeds; one batch row is
zero-padded, so the segment rule (padded queries see only padded keys) is
compared on every row, padded ones included.  Narrow widths: ATTN_DIM 32,
2 heads (head dim 16), 2 layers, MLP x2, T = 128 (the flash path needs a
multiple of 128).

Tolerances: 1e-6 on the flash forward, the encoder's embeddings, layer
norm and GELU; 2e-5 atol / 1e-4 rtol on gradients and on the train loss;
1e-4 on ``separate_wav``.  The JAX package's own flash and dense paths
are held to each other at 1e-5 on real frames: two algorithms, float32
sums in other orders.
"""
import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from danet_tpu import optim as joptim  # noqa: E402
from danet_tpu.hparams import hparams as jax_hparams  # noqa: E402
from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
from danet_tpu.ops import nn as jnn  # noqa: E402
from danet_tpu.ops.pallas import attention as jattn  # noqa: E402
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402
from danet_tpu_torch.ops import nn as tnn  # noqa: E402
from danet_tpu_torch.ops.cuda import attention as tattn  # noqa: E402
from danet_tpu_torch.train import Trainer  # noqa: E402

DEFAULT_JSON = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "default.json")
NARROW = dict(ENCODER_TYPE="attn-v1", ATTN_DIM=32, ATTN_HEADS=2,
              ATTN_LAYERS=2, ATTN_MLP_MULT=2, ATTN_BACKEND="flash")
PAD_FROM = 100  # batch row 1 is zero from this frame on
PAD_FROM_256 = 200  # the same at T=256, in the second 128-key block


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def _qkv_case(seed, b=2, t=128, h=2, d=16):
    """q, k, v [B, T, H, D], a key mask with row 1 padded, a cotangent."""
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(b, t, h, d).astype(np.float32) for _ in range(4))
    key_mask = np.ones((b, t), bool)
    key_mask[1, PAD_FROM:] = False
    return q, k, v, key_mask, do


def _src_ri(seed, b=2, n=2, t=128, f=129):
    """Per-source ri spectra; row 1 is zero from PAD_FROM on."""
    rs = np.random.RandomState(seed)
    z = rs.randn(b, n, t, f) + 1j * rs.randn(b, n, t, f)
    z[1, :, PAD_FROM:] = 0.0
    return np.stack([z.real, z.imag], -1).astype(np.float32)


def _log_spectra(seed, b=2, t=128, f=129):
    x = np.abs(np.random.RandomState(seed).randn(b, t, f)).astype(np.float32)
    x[1, PAD_FROM:] = 0.0
    return x


@pytest.fixture(scope="module")
def flash_ref():
    """JAX's flash_attention_masked in interpret mode: its output and the
    gradients of sum(o * do) in q, k and v."""
    q, k, v, key_mask, do = _qkv_case(0)
    args = [jnp.asarray(a) for a in (q, k, v)]
    km = jnp.asarray(key_mask)
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention_masked(
            a, b, c, km), *args)
        grads = vjp(jnp.asarray(do))
    return {"o": np.asarray(o), "grads": [np.asarray(g) for g in grads]}


@pytest.fixture(scope="module")
def flash_ref_bf16():
    """JAX's flash_attention_masked in bfloat16 at T=256 (two of the stock
    kernel's 128-key blocks), interpret mode, jitted; row 1 padded from
    PAD_FROM_256 on.  -> (inputs, key mask, output as float32)."""
    q, k, v, _, _ = _qkv_case(5, t=256)
    key_mask = np.ones((2, 256), bool)
    key_mask[1, PAD_FROM_256:] = False
    args = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        o = jax.jit(lambda a, b, c: jattn.flash_attention_masked(
            a, b, c, jnp.asarray(key_mask)))(*args)
    return (q, k, v), key_mask, np.asarray(o.astype(jnp.float32))


@pytest.fixture(scope="module")
def model_ref():
    """The narrow attn-v1 DaNet of the JAX package with ATTN_BACKEND
    'flash', its flash kernel in interpret mode: parameters, the
    encoder's output on both backends, train_loss with its gradients and
    one optimizer step, and separate_wav (L = 8128, T = 128)."""
    saved = copy.copy(jax_hparams.__dict__)
    jax_hparams.load_json(DEFAULT_JSON)
    jax_hparams.load(NARROW)
    jax_hparams.digest()
    try:
        jm = JaxDaNet()
        jp = jm.init(jax.random.PRNGKey(0))
        x = jnp.asarray(_log_spectra(1))
        batch = jnp.asarray(_src_ri(2))
        wav = jnp.asarray((np.random.RandomState(3).randn(2, 8128) * 0.5)
                          .astype(np.float32))
        out = {"params": jax.device_get(jp)}
        # jitted: the interpret-mode kernel runs about twice as fast
        with pltpu.force_tpu_interpret_mode():
            out["embed_flash"] = np.asarray(jax.jit(jm.encoder.apply)(
                jp["encoder"], x))
            (loss, aux), g = jax.jit(jax.value_and_grad(
                jm.train_loss, has_aux=True))(jp, batch)
            out["wav"] = np.asarray(jax.jit(jm.separate_wav)(jp, wav))
        jax_hparams.ATTN_BACKEND = "xla"
        out["embed_xla"] = np.asarray(jm.encoder.apply(jp["encoder"], x))
        opt = joptim.make_optimizer(jax_hparams)
        upd, _ = opt.update(g, opt.init(jp), jp)
        out.update(loss=float(loss), snr=float(aux["snr"]),
                   grads=jax.device_get(g),
                   stepped=jax.device_get(optax.apply_updates(jp, upd)))
    finally:
        jax_hparams.__dict__.clear()
        jax_hparams.__dict__.update(saved)
    return out


def _port(**keys):
    """The narrow attn-v1 DaNet of the port (``keys`` over NARROW)."""
    return TorchDaNet(load_config(**dict(NARROW, **keys)))


# ---------------------------------------------------------------- flash op
def test_torch_flash_attention_matches_jax_interpret(fresh_hparams,
                                                     flash_ref):
    """flash_attention_masked on CPU tensors (the plain versions) against
    JAX's Pallas kernel: the output on every row, padded query rows
    included, at 1e-6; dq, dk, dv at 2e-5 / 1e-4.  Nothing is launched."""
    q, k, v, key_mask, do = _qkv_case(0)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    before = [f.launches for f in (tattn.flash_attn, tattn.flash_attn_bwd_dkv,
                                   tattn.flash_attn_bwd_dq)]
    o = tattn.flash_attention_masked(tq, tk, tv, torch.from_numpy(key_mask))
    _close(o.detach(), flash_ref["o"], 1e-6)
    # the padded queries of row 1 see only the padded keys
    assert not np.allclose(o.detach().numpy()[1, PAD_FROM:],
                           tattn.flash_attention_masked(
                               tq, tk, tv, None).detach().numpy()[1, PAD_FROM:])
    (o * torch.from_numpy(do)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), flash_ref["grads"]):
        _close(got, want, 2e-5, 1e-4)
    assert before == [f.launches for f in (
        tattn.flash_attn, tattn.flash_attn_bwd_dkv, tattn.flash_attn_bwd_dq)]


@pytest.mark.parametrize("padded", [True, False])
def test_torch_flash_plain_kernels_compose_to_autograd(fresh_hparams, padded):
    """FlashAttention's backward (the plain dK/dV and dQ kernels, with di
    outside) against torch autograd of the plain forward, 2e-5 / 1e-4;
    the forward's l and m are the row sum and maximum of the logits."""
    q, k, v, key_mask, do = _qkv_case(1, t=128, h=2, d=32)
    seg = torch.from_numpy((~key_mask).astype(np.int32)) if padded else None
    scale = 1.0 / np.sqrt(32.0)
    grads = []
    for custom in (True, False):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        o = (tattn.FlashAttention.apply(*ts, seg, scale) if custom
             else tattn.flash_attn_plain(*ts, seg, scale)[0])
        (o * torch.from_numpy(do)).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        _close(a, b, 2e-5, 1e-4)
    _, l, m = tattn.flash_attn_plain(*map(torch.from_numpy, (q, k, v)), seg,
                                     scale)
    s = tattn._logits(*map(torch.from_numpy, (q, k)), seg, scale)
    _close(m, s.amax(-1), 0.0)
    _close(l, torch.exp(s - s.amax(-1, keepdim=True)).sum(-1), 1e-5)


def test_torch_flash_bf16_rounds_probabilities(fresh_hparams):
    """In bfloat16 the plain forward rounds p before p . v, as the stock
    kernel does, and stays within two bf16 ulps of the float32 result."""
    q, k, v, key_mask, _ = _qkv_case(2)
    seg = torch.from_numpy((~key_mask).astype(np.int32))
    t32 = [torch.from_numpy(a) for a in (q, k, v)]
    t16 = [a.to(torch.bfloat16) for a in t32]
    o16, l16, _ = tattn.flash_attn_plain(*t16, seg, 0.25)
    assert o16.dtype == torch.bfloat16 and l16.dtype == torch.float32
    o32 = tattn.flash_attn_plain(*[a.float() for a in t16], seg, 0.25)[0]
    _close(o16.float(), o32, 2 * 2 ** -8 * float(o32.abs().max()))


def test_torch_flash_bf16_matches_jax_interpret(fresh_hparams,
                                                flash_ref_bf16):
    """The plain flash_attention_masked in bfloat16 against JAX's stock
    kernel in bfloat16 (interpret mode) at T=256, every row, the padded
    one included.  Tolerance: one bf16 ulp of the output's peak,
    2^(floor(log2 peak) - 7): the two round p to bfloat16 against
    different maxima (the plain version the row's final one, the stock
    kernel the running one over 128-key blocks)."""
    (q, k, v), key_mask, want = flash_ref_bf16
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    o = tattn.flash_attention_masked(*ts, torch.from_numpy(key_mask))
    assert o.dtype == torch.bfloat16 and tuple(o.shape) == want.shape
    peak = float(np.abs(want).max())
    _close(o.float(), want, 2.0 ** (np.floor(np.log2(peak)) - 7))


def test_torch_flash_splits_rule(fresh_hparams):
    """The forward's key split: S > 1 where the query tiles leave SMs idle
    (attn-v1 serving, B=1, T=1280, H=4: 80 tiles on 132 SMs), 1 where they
    do not (training, B=32, T=128: 256); always a power of two that the
    kernel's 64 query rows and T / 64 key tiles take, at most 8 (one
    portable cluster), so that every block of the cluster axis (T / 64 x S
    blocks) has a key tile."""
    assert tattn.flash_splits(1, 1280, 4) == 4
    assert tattn.flash_splits(32, 128, 4) == 1
    assert tattn.flash_splits(1, 384, 4) == 4         # 6 tiles: uneven
    assert tattn.flash_splits(1, 1280, 4, n_sm=80) == 1
    for b in (1, 2, 4, 32):
        for t in (64, 128, 384, 512, 1280, 4096):
            for h in (1, 4, 8):
                for n_sm in (78, 132):
                    s = tattn.flash_splits(b, t, h, n_sm)
                    tiles, blocks = t // tattn.TILE, t // tattn.TILE * h * b
                    assert s in (1, 2, 4, 8) and s <= tiles
                    assert tattn.TILE % s == 0 and (tiles * s) % s == 0
                    assert (s == 1) == (blocks >= n_sm or tiles == 1)


def _split_combine(q, k, v, seg, scale, splits):
    """A model of the forward kernel's key split in float64: rank r takes
    key tiles [r n / S, (r + 1) n / S) and leaves (m_r, l_r, acc_r); the
    combination is m = max m_r, l = sum exp(m_r - m) l_r, o = sum exp(m_r -
    m) acc_r / l."""
    s = tattn._logits(q.double(), k.double(), seg, scale).double()
    n = s.shape[-1] // tattn.TILE
    parts = []
    for r in range(splits):
        keys = slice(r * n // splits * tattn.TILE,
                     (r + 1) * n // splits * tattn.TILE)
        sr = s[..., keys]
        m = sr.amax(-1)
        p = torch.exp(sr - m[..., None])
        acc = torch.einsum("bhqk,bkhd->bqhd", p, v.double()[:, keys])
        parts.append((m, p.sum(-1), acc))
    m = torch.stack([pm for pm, _, _ in parts]).amax(0)
    w = [torch.exp(pm - m) for pm, _, _ in parts]
    l = sum(wr * pl for wr, (_, pl, _) in zip(w, parts))
    o = sum(wr.transpose(1, 2)[..., None] * acc
            for wr, (_, _, acc) in zip(w, parts))
    return o / l.transpose(1, 2)[..., None], l, m


@pytest.fixture(scope="module")
def flash_ref_256(flash_ref_bf16):
    """JAX's flash_attention_masked in float32 on flash_ref_bf16's inputs
    (T=256, row 1 padded), interpret mode, jitted."""
    (q, k, v), key_mask, _ = flash_ref_bf16
    with pltpu.force_tpu_interpret_mode():
        o = jax.jit(lambda a, b, c: jattn.flash_attention_masked(
            a, b, c, jnp.asarray(key_mask)))(*map(jnp.asarray, (q, k, v)))
    return np.asarray(o)


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_torch_flash_split_combine_matches_jax_interpret(fresh_hparams,
                                                         flash_ref_bf16,
                                                         flash_ref_256,
                                                         splits):
    """The key split's combination (a float64 model of the kernel's
    distributed-shared-memory merge) against JAX's stock kernel in
    interpret mode at T=256 (4 key tiles, split evenly) and, on 3 tiles of
    T=192 taken from it, against the plain version (uneven: 1 + 2 at S=2):
    the output at 1e-6 on every row, the padded row included, and l, m at
    1e-6 of the plain version's."""
    (q, k, v), key_mask, _ = flash_ref_bf16
    seg = torch.from_numpy((~key_mask).astype(np.int32))
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    want = flash_ref_256
    o, l, m = _split_combine(*ts, seg, 0.25, splits)
    _close(o.float(), want, 1e-6)
    ref_o, ref_l, ref_m = tattn.flash_attn_plain(*ts, seg, 0.25)
    _close(l.float(), ref_l, 0.0, 1e-6)
    _close(m.float(), ref_m, 1e-6)
    if splits == 2:                        # uneven: 3 key tiles over 2
        cut = [a[:, :192] for a in ts]
        o, l, m = _split_combine(*cut, seg[:, :192], 0.25, 2)
        ref_o, ref_l, ref_m = tattn.flash_attn_plain(*cut, seg[:, :192], 0.25)
        _close(o.float(), ref_o, 1e-6)
        _close(l.float(), ref_l, 0.0, 1e-6)


def test_torch_flash_alignment_check(fresh_hparams):
    """The forward stages tiles with 16-byte copies: views whose data or
    strides are not 16-byte aligned are copied by the wrapper first."""
    qkv = torch.zeros(2, 128, 3, 4, 16)
    q = qkv[:, :, 0]
    assert tattn._aligned16(q, q.stride()[:3])
    odd = torch.zeros(2 * 128 * 4 * 16 + 1)[1:].view(2, 128, 4, 16)
    assert not tattn._aligned16(odd, odd.stride()[:3])
    bf = torch.zeros(2, 128, 3, 4, 16, dtype=torch.bfloat16)[:, :, 1]
    assert tattn._aligned16(bf, bf.stride()[:3])
    assert not tattn._aligned16(bf, (bf.stride(0), 12, 4))


@pytest.mark.parametrize("kernel", ["flash_attn", "flash_attn_bwd_dkv",
                                    "flash_attn_bwd_dq"])
def test_torch_flash_wrappers_align_staged_inputs(fresh_hparams,
                                                  monkeypatch, kernel):
    """Every flash kernel stages its inputs with 16-byte copies: handed
    misaligned q, k, v, segment ids, l, m, do and di, the wrapper launches
    with 16-byte aligned pointers and strides, and the same values.
    Recorded on the CPU with the launch replaced."""
    calls = []
    monkeypatch.setattr(tattn, "_on_cuda", lambda x, what: True)
    monkeypatch.setattr(tattn, "_launch_flash",
                        lambda *a: calls.append(a))

    def odd(*shape, dtype=torch.float32):
        n = int(np.prod(shape))
        x = torch.zeros(n + 1, dtype=dtype)[1:].view(*shape)
        x.copy_(torch.arange(n, dtype=torch.float32).view(*shape) % 7)
        return x

    b, t, h, d = 2, 128, 4, 16
    q, k, v = (odd(b, t, h, d) for _ in range(3))
    seg = odd(b, t, dtype=torch.int32)
    rows = (odd(b, h, t), odd(b, h, t), odd(b, t, h, d), odd(b, h, t))
    if kernel == "flash_attn":
        tattn.flash_attn(q, k, v, seg, 0.25, splits=1)
        staged = (q, k, v, seg)
    else:
        getattr(tattn, kernel)(q, k, v, seg, *rows, 0.25)
        staged = (q, k, v, seg) + rows
    (entry, qkv, seg_in, outs, _, strides, _), = calls
    assert entry == "danet_" + kernel
    given = tuple(qkv) + (seg_in,) + tuple(outs[:4] if len(staged) > 4
                                           else ())
    for x, want in zip(given, staged):
        assert x.data_ptr() % 16 == 0 and torch.equal(x, want)
    assert all(s % 4 == 0 for s in strides)


@pytest.mark.parametrize("t", [40, 200])
def test_torch_flash_needs_t_multiple_of_128(fresh_hparams, t):
    """Both packages raise ValueError for T not a multiple of 128."""
    q = np.zeros((1, t, 2, 16), np.float32)
    km = np.ones((1, t), bool)
    with pytest.raises(ValueError):
        jattn.flash_attention_masked(*(jnp.asarray(q),) * 3, jnp.asarray(km))
    with pytest.raises(ValueError):
        tattn.flash_attention_masked(*(torch.from_numpy(q),) * 3,
                                     torch.from_numpy(km))


def test_torch_resolve_attn_fn_matches_jax(fresh_hparams):
    """ATTN_BACKEND: 'flash' picks the flash wrapper, 'auto' and 'xla' (and
    an unset key) the dense function, anything else raises ValueError --
    in both packages."""
    def dense(*a):
        return None

    for be, flash in (("flash", True), ("auto", False), ("xla", False),
                      (None, False)):
        hp = load_config(ATTN_BACKEND=be)
        fresh_hparams.ATTN_BACKEND = be
        assert (tattn.resolve_attn_fn(hp, 1024, dense)
                is tattn.flash_attention_masked) == flash
        assert (jattn.resolve_attn_fn(fresh_hparams, 1024, dense)
                is jattn.flash_attention_masked) == flash
    assert tattn.attn_backend_default(4096) == jattn.attn_backend_default(
        4096) == "xla"
    fresh_hparams.ATTN_BACKEND = "cudnn"
    with pytest.raises(ValueError):
        jattn.resolve_attn_fn(fresh_hparams, 128, dense)
    with pytest.raises(ValueError):
        tattn.resolve_attn_fn(load_config(ATTN_BACKEND="cudnn"), 128, dense)


def test_torch_flash_kernel_input_checks(fresh_hparams):
    """What the CUDA wrappers refuse before a launch: a head dimension the
    kernels are not built for, T not a multiple of the 64-row tile, other
    dtypes, mismatched shapes; views that share strides pass as they
    are, others are made contiguous."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    for bad in ((z(1, 128, 2, 24),) * 3, (z(1, 96, 2, 16),) * 3,
                (z(1, 128, 2, 16, dtype=torch.float16),) * 3,
                (z(1, 128, 2, 16), z(1, 128, 2, 16), z(1, 128, 1, 16))):
        with pytest.raises(ValueError):
            tattn._qkv_strides(*bad, None)
    qkv = z(2, 128, 3, 4, 16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = tattn._qkv_strides(q, k, v, z(2, 128, dtype=torch.int32))
    assert out[0] is q and out[5] == (128 * 3 * 64, 3 * 64, 16)
    out = tattn._qkv_strides(q, k.contiguous(), v, None)
    assert out[0].is_contiguous() and out[5] == (128 * 64, 64, 16)
    with pytest.raises(ValueError):
        tattn._qkv_strides(q, k, v, z(2, 128))       # float segment ids


def test_torch_flash_wrappers_refuse_other_devices(fresh_hparams):
    """A wrapper takes its plain version only for CPU tensors: on any other
    device than CPU or CUDA it raises (on CUDA it launches its kernel)."""
    x = torch.zeros(1, 128, 2, 16, device="meta")
    st = torch.zeros(1, 2, 128, device="meta")
    with pytest.raises(ValueError):
        tattn.flash_attn(x, x, x, None, 0.25)
    with pytest.raises(ValueError):
        tattn.flash_attn_bwd_dkv(x, x, x, None, st, st, x, st, 0.25)
    with pytest.raises(ValueError):
        tattn.flash_attn_bwd_dq(x, x, x, None, st, st, x, st, 0.25)


# ------------------------------------------------------------ layer pieces
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_layer_norm_and_gelu_match_jax(fresh_hparams, dtype):
    """layer_norm (population variance, eps 1e-6) and the tanh GELU,
    float32 at 1e-6.  bfloat16 to one bf16 ulp of the largest outputs
    (|y| < 8: 2^-5): XLA's CPU backend computes some of the elementwise
    steps in float32 inside a fusion where PyTorch rounds each step to
    bfloat16, so a small output may differ by an ulp of an intermediate."""
    rs = np.random.RandomState(4)
    x = (rs.randn(3, 5, 32) * 2 + 0.5).astype(np.float32)
    g = rs.randn(32).astype(np.float32)
    b = rs.randn(32).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = (1e-6, 0.0) if dtype == "float32" else (2 ** -5, 0.0)
    ln_ref = jnn.layer_norm({"g": jnp.asarray(g), "b": jnp.asarray(b)}, jx)
    ln = tnn.layer_norm({"g": torch.from_numpy(g), "b": torch.from_numpy(b)},
                        tx)
    assert ln.dtype == tx.dtype
    _close(ln.float(), np.asarray(ln_ref.astype(jnp.float32)), *tol)
    _close(tnn.gelu(tx).float(),
           np.asarray(jax.nn.gelu(jx).astype(jnp.float32)), *tol)


# ----------------------------------------------------------------- encoder
@pytest.mark.parametrize("backend", ["flash", "xla", "auto"])
def test_torch_attention_encoder_matches_jax(fresh_hparams, model_ref,
                                             backend):
    """AttentionEncoder.apply with weights carried by weights.from_jax, on
    the flash path and the dense path, against the JAX encoder (flash in
    interpret mode); every row, the padded one included, 1e-6."""
    tm = _port(ATTN_BACKEND=backend)
    tp = weights.from_jax(model_ref["params"])
    out = tm.encoder.apply(tp["encoder"], torch.from_numpy(_log_spectra(1)))
    assert tuple(out.shape) == (2, 128, 129, 20)
    want = model_ref["embed_flash" if backend == "flash" else "embed_xla"]
    _close(out, want, 1e-6)


def test_torch_attention_encoder_paths_differ_only_on_padding(
        fresh_hparams, model_ref):
    """The flash and dense paths agree on real frames; on padded frames
    they differ (padded queries see padded keys under flash, real keys
    under the dense path), in the port as in JAX."""
    flash, dense = model_ref["embed_flash"], model_ref["embed_xla"]
    _close(flash[0], dense[0], 1e-5, 1e-5)
    _close(flash[1, :PAD_FROM], dense[1, :PAD_FROM], 1e-5, 1e-5)
    assert not np.allclose(flash[1, PAD_FROM:], dense[1, PAD_FROM:],
                           atol=1e-3)


def test_torch_attention_weights_round_trip(fresh_hparams, model_ref,
                                            tmp_path):
    """The embed / output / block{i}/{qkv, proj, ln1, ln2, mlp_in,
    mlp_out} tree crosses the bridge key for key (from_jax / to_jax and
    save_npz / load_npz), and the port's own init has the same keys and
    shapes."""
    tree = model_ref["params"]

    def flat(t, prefix=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, prefix + k + "/") if isinstance(v, dict)
                       else {prefix + k: np.asarray(v)})
        return out

    want = flat(tree)
    assert want["encoder/block1/qkv/w"].shape == (32, 96)
    assert "encoder/output/b" not in want
    path = str(tmp_path / "w.npz")
    weights.save_npz(path, tree)
    for back in (weights.to_jax(weights.from_jax(tree)),
                 weights.to_jax(weights.load_npz(path))):
        got = flat(back)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    mine = flat(weights.to_jax(_port().init(torch.Generator().manual_seed(0))))
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in want.items()}


def test_torch_attention_encoder_refuses_unported(fresh_hparams):
    """ATTN_CAUSAL (at apply) and MESH_SEQ > 1 (when the model is built)
    raise NotImplementedError; _dims keeps JAX's two ValueErrors."""
    x = torch.zeros(1, 128, 129)
    for keys in ({"ATTN_CAUSAL": True}, {"MESH_SEQ": 2}):
        with pytest.raises(NotImplementedError):
            tm = _port(**keys)
            tm.encoder.apply(tm.encoder.init(torch.Generator()), x)
    for keys in ({"ATTN_DIM": 33, "ATTN_HEADS": 1},
                 {"ATTN_DIM": 32, "ATTN_HEADS": 3}):
        with pytest.raises(ValueError):
            _port(**keys).encoder.init(torch.Generator())


# ---------------------------------------------------------------- training
def test_torch_attention_train_loss_and_grads_match_jax(fresh_hparams,
                                                        model_ref):
    """train_loss of attn-v1 on the flash path and its gradient for every
    parameter against JAX's value_and_grad(train_loss) through the Pallas
    flash kernel, 2e-5 / 1e-4.  Padded frames included."""
    tm = _port()
    trainer = Trainer(tm, tm.hp, "cpu")
    state = trainer.init_state(params=model_ref["params"])
    m, grads = trainer.loss_and_grads(
        state["params"], torch.from_numpy(_src_ri(2)))
    _close(m["loss"], model_ref["loss"], 2e-5, 1e-4)
    _close(m["SNR"], model_ref["snr"], 2e-5, 1e-4)
    ref = weights.leaves(weights.from_jax(model_ref["grads"]))
    assert len(grads) == len(ref)
    for a, b in zip(grads, ref):
        _close(a, b, 2e-5, 1e-4)


def test_torch_attention_trainer_step_matches_jax(fresh_hparams, model_ref):
    """One Trainer step on the CPU (Adam with the value clip) against
    value_and_grad + danet_tpu.optim: its loss, and every parameter after
    the update, 2e-5 / 1e-4."""
    tm = _port()
    trainer = Trainer(tm, tm.hp, "cpu")
    state = trainer.init_state(params=model_ref["params"])
    m = trainer.train_step(state, _src_ri(2))
    assert state["step"] == 1
    _close(m["loss"], model_ref["loss"], 2e-5, 1e-4)
    for a, b in zip(weights.leaves(weights.to_jax(state["params"])),
                    weights.leaves(model_ref["stepped"])):
        _close(a, b, 2e-5, 1e-4)


def test_torch_attention_dropout(fresh_hparams, model_ref):
    """DROPOUT_KEEP_PROB 1: the train forward is the eval forward.  Below
    1: the drop is reproducible from the generator, differs between
    seeds, and never reaches the eval forward."""
    tp = weights.from_jax(model_ref["params"])["encoder"]
    x = torch.from_numpy(_log_spectra(5))
    tm = _port(ATTN_BACKEND="xla")
    enc = tm.encoder
    plain = enc.apply(tp, x)
    torch.testing.assert_close(
        enc.apply(tp, x, train=True, generator=torch.Generator()), plain,
        rtol=0, atol=0)
    tm.hp.DROPOUT_KEEP_PROB = 0.5
    a = enc.apply(tp, x, train=True, generator=torch.Generator().manual_seed(1))
    b = enc.apply(tp, x, train=True, generator=torch.Generator().manual_seed(1))
    c = enc.apply(tp, x, train=True, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(a).all() and not torch.equal(a, c)
    assert not torch.allclose(a, plain)
    torch.testing.assert_close(enc.apply(tp, x), plain, rtol=0, atol=0)


# ----------------------------------------------------------------- serving
def test_torch_attention_separate_wav_matches_jax(fresh_hparams, model_ref):
    """The serving slice with attn-v1 on the flash path: wave -> STFT ->
    2 transformer blocks -> anchor -> sigmoid masks -> iSTFT, L = 8128
    (T = 128 frames), against JAX with its flash kernel in interpret
    mode, 1e-4."""
    tm = _port()
    tp = weights.from_jax(model_ref["params"])
    wav = (np.random.RandomState(3).randn(2, 8128) * 0.5).astype(np.float32)
    out = tm.separate_wav(tp, torch.from_numpy(wav)).numpy()
    assert out.shape == model_ref["wav"].shape == (2, 2, 128 * 64)
    assert np.all(np.isfinite(out))
    _close(out, model_ref["wav"], 1e-4)
