"""Flash attention with segment masking: the three kernels, their plain
versions and the autograd Function, behind the attention encoder's
``attn_fn(q, k, v, key_mask)`` contract.

Replaces ``danet_tpu/ops/pallas/attention.py::flash_attention_masked``
and the stock TPU kernel it wraps
(``jax/experimental/pallas/ops/tpu/flash_attention.py``), whose three
``pallas_call``s become three CUDA kernels:

  * ``flash_attn``: the forward (``_flash_attention_impl``): o, and the
    row statistics l (sum of exponentials) and m (row maximum) that the
    backward needs; ``flash_splits`` picks how many blocks (a thread-block
    cluster) split the keys of one query tile;
  * ``flash_attn_bwd_dkv``: dK and dV (``_flash_attention_bwd_dkv``);
  * ``flash_attn_bwd_dq``: dQ (``_flash_attention_bwd_dq``; its ``ds``
    output serves only an attention bias, which this repo never passes);
  * ``FlashAttention``: the ``torch.autograd.Function`` that ties them
    together as ``_flash_attention``'s ``jax.custom_vjp`` does, with
    ``di = rowsum(o * do)`` in float32 outside the kernels.

The CUDA sources are ``danet_tpu_torch/csrc/flash_attn.cu`` and
``csrc/flash_attn_bwd.cu``; their headers say what bounds them on an H100
and how they tile.

Layout: q, k, v, o are [B, T, H, D] (views of the [B, T, 3, H, D] qkv
projection are read through their strides); l, m and di are float32
[B, H, T]; segment ids are int32 [B, T].  Query i sees key j iff their
segment ids are equal; a masked logit gets ``DEFAULT_MASK_VALUE`` added,
a finite value, so that a tile whose keys are all masked gives no NaN.
The logits are ``(q . k) * sm_scale`` in float32; the probabilities are
rounded to the input dtype before their product with v (forward) or do
(dV), and ds before its products with q (dK) and k (dQ), where the stock
kernel rounds them.

Each wrapper launches its kernel for CUDA tensors and uses its plain
version (``*_plain``: the same float32 math on whole [T, T] logits) for
CPU tensors; on any other device it raises.  ``<wrapper>.launches``
counts the kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from danet_tpu_torch.ops.cuda.lstm import _DTYPE_CODES, _launch, _on_cuda

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
# the stock kernel's block size: the sequence length must be a multiple
BLOCK = 128
# head dimensions the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 128)
# the kernels' own tile: query and key tiles of 64 rows
TILE = 64
# the forward's key split: at most this many blocks (one thread-block
# cluster, the portable size) share a query tile
MAX_SPLITS = 8
# streaming multiprocessors of an H100 SXM, where no card is at hand
H100_SMS = 132


def _logits(q, k, seg, sm_scale: float) -> torch.Tensor:
    """[B, H, Tq, Tk] float32: (q . k) * sm_scale, plus the mask value
    where the segment ids differ."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if seg is not None:
        same = seg[:, None, :, None] == seg[:, None, None, :]
        s = s + torch.where(same, 0.0, DEFAULT_MASK_VALUE)
    return s


def flash_attn_plain(q, k, v, seg, sm_scale: float):
    """Plain version of the forward: q, k, v [B, T, H, D], seg int32
    [B, T] or None -> (o [B, T, H, D] in q's dtype, l, m float32
    [B, H, T])."""
    s = _logits(q, k, seg, sm_scale)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    o = o / l.transpose(1, 2)[..., None]
    return o.to(q.dtype), l, m


def _probs(q, k, seg, l, m, sm_scale: float) -> torch.Tensor:
    """p = exp(s - m) * (1 / l), recomputed from the saved statistics."""
    s = _logits(q, k, seg, sm_scale)
    return torch.exp(s - m[..., None]) * (1.0 / l)[..., None]


def _dscores(q, k, v, seg, l, m, do, di, sm_scale: float):
    """(p, ds): ds = (do . v - di) * p * sm_scale, float32 [B, H, Tq, Tk]."""
    p = _probs(q, k, seg, l, m, sm_scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, (dp - di[..., None]) * p * sm_scale


def flash_attn_bwd_dkv_plain(q, k, v, seg, l, m, do, di, sm_scale: float):
    """Plain version of the dK/dV kernel -> (dk, dv) [B, T, H, D] in q's
    dtype: dv = p^T . do, dk = ds^T . q."""
    p, ds = _dscores(q, k, v, seg, l, m, do, di, sm_scale)
    dt = q.dtype
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(dt).float(), q.float())
    return dk.to(dt), dv.to(dt)


def flash_attn_bwd_dq_plain(q, k, v, seg, l, m, do, di, sm_scale: float):
    """Plain version of the dQ kernel -> dq [B, T, H, D] in q's dtype:
    dq = ds . k."""
    _, ds = _dscores(q, k, v, seg, l, m, do, di, sm_scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).float(), k.float())
    return dq.to(q.dtype)


def _qkv_strides(q, k, v, seg):
    """Check the kernels' inputs; -> (q, k, v, seg, (B, T, H, D), strides)
    with q, k and v sharing one set of (batch, time, head) strides."""
    if q.dim() != 4:
        raise ValueError("q must be [B, T, H, D], got %s" % (tuple(q.shape),))
    b, t, h, d = q.shape
    for name, x in (("k", k), ("v", v)):
        if tuple(x.shape) != tuple(q.shape):
            raise ValueError("%s must be %s, got %s"
                             % (name, tuple(q.shape), tuple(x.shape)))
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError("%s is %s on %s, q is %s on %s" % (
                name, x.dtype, x.device, q.dtype, q.device))
    if q.dtype not in _DTYPE_CODES:
        raise ValueError("the flash kernels take float32 or bfloat16, got %s"
                         % (q.dtype,))
    if d not in HEAD_DIMS:
        raise ValueError("the flash kernels take a head dimension in %s, "
                         "got %d" % (HEAD_DIMS, d))
    if t % TILE:
        raise ValueError("the flash kernels take T a multiple of %d, got %d"
                         % (TILE, t))
    if not (q.stride() == k.stride() == v.stride()) or q.stride(-1) != 1:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if seg is not None:
        if tuple(seg.shape) != (b, t) or seg.dtype != torch.int32 \
                or seg.device != q.device:
            raise ValueError("segment ids must be int32 [B, T] on %s, got "
                             "%s %s on %s" % (q.device, seg.dtype,
                                              tuple(seg.shape), seg.device))
        seg = seg.contiguous()
    return q, k, v, seg, (b, t, h, d), tuple(q.stride()[:3])


def flash_splits(b: int, t: int, h: int, n_sm: int = H100_SMS) -> int:
    """Blocks per query tile of the forward kernel (its key split, one
    thread-block cluster): 1 where the (T / 64) * H * B query tiles already
    give every one of the card's ``n_sm`` SMs a block; else the smallest
    power of two that gives two blocks per SM, at most ``MAX_SPLITS`` and
    the T / 64 key tiles (so every block has a key tile)."""
    tiles = t // TILE
    blocks = tiles * h * b
    if blocks >= n_sm:
        return 1
    s = 1
    while 2 * s <= min(MAX_SPLITS, tiles) and blocks * s < 2 * n_sm:
        s *= 2
    return s


def _aligned16(x: torch.Tensor, strides) -> bool:
    """16-byte aligned data and (b, t, h) strides: every flash kernel
    stages its tiles with 16-byte asynchronous copies."""
    vec = 16 // x.element_size()
    return x.data_ptr() % 16 == 0 and all(s % vec == 0 for s in strides)


def _staged(q, k, v, seg, strides, *rows):
    """The inputs of a kernel that stages them with 16-byte copies: q, k
    and v (with their strides) copied where their data or strides are not
    16-byte aligned, seg and the contiguous ``rows`` where their data is
    not.  -> (q, k, v, seg, strides, *rows)."""
    if not all(_aligned16(x, strides) for x in (q, k, v)):
        q, k, v = (x.clone(memory_format=torch.contiguous_format)
                   for x in (q, k, v))
        strides = tuple(q.stride()[:3])
    seg, *rows = (x if x is None or x.data_ptr() % 16 == 0 else x.clone()
                  for x in (seg,) + rows)
    return (q, k, v, seg, strides, *rows)


def flash_attn(q, k, v, seg, sm_scale: float, splits: int | None = None):
    """The forward kernel (signature of the plain version); ``splits``
    overrides ``flash_splits``'s key split (1, 2, 4 or 8)."""
    if not _on_cuda(q, "flash_attn"):
        return flash_attn_plain(q, k, v, seg, sm_scale)
    q, k, v, seg, (b, t, h, d), strides = _qkv_strides(q, k, v, seg)
    q, k, v, seg, strides = _staged(q, k, v, seg, strides)
    if splits is None:
        splits = flash_splits(b, t, h, torch.cuda.get_device_properties(
            q.device).multi_processor_count)
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    l = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    _launch_flash("danet_flash_attn", (q, k, v), seg, (o, l, m),
                  (b, h, t, d, splits), strides, sm_scale)
    flash_attn.launches += 1
    return o, l, m


def _launch_flash(entry: str, qkv, seg, outs, dims, strides,
                  sm_scale: float) -> None:
    """Launch one flash kernel: pointers of q, k, v, the segment ids (NULL
    for none) and ``outs``, then ``dims`` (B, H, T, D, and the forward's
    key split), the dtype code, the qkv strides and sm_scale."""
    q = qkv[0]
    ptrs = [x.data_ptr() for x in qkv] \
        + [seg.data_ptr() if seg is not None else None] \
        + [x.data_ptr() for x in outs]
    _launch(entry, entry[len("danet_"):] + " kernel", q.device, (),
            (*ptrs, *dims, _DTYPE_CODES[q.dtype], *strides,
             float(sm_scale)))


def _bwd_inputs(q, k, v, seg, l, m, do, di):
    """_qkv_strides, and l, m, di float32 [B, H, T] and do [B, T, H, D] in
    q's dtype, contiguous on q's device."""
    q, k, v, seg, (b, t, h, d), strides = _qkv_strides(q, k, v, seg)
    for name, x, shape, dtype in (
            ("l", l, (b, h, t), torch.float32),
            ("m", m, (b, h, t), torch.float32),
            ("di", di, (b, h, t), torch.float32),
            ("do", do, (b, t, h, d), q.dtype)):
        if tuple(x.shape) != shape or x.dtype != dtype \
                or x.device != q.device or not x.is_contiguous():
            raise ValueError("%s must be contiguous %s %s on %s, got %s %s "
                             "on %s" % (name, dtype, shape, q.device,
                                        x.dtype, tuple(x.shape), x.device))
    return q, k, v, seg, (b, t, h, d), strides


def flash_attn_bwd_dkv(q, k, v, seg, l, m, do, di, sm_scale: float):
    """The dK/dV kernel (signature of the plain version)."""
    if not _on_cuda(q, "flash_attn_bwd_dkv"):
        return flash_attn_bwd_dkv_plain(q, k, v, seg, l, m, do, di, sm_scale)
    q, k, v, seg, (b, t, h, d), strides = _bwd_inputs(q, k, v, seg, l, m,
                                                      do, di)
    q, k, v, seg, strides, l, m, do, di = _staged(q, k, v, seg, strides, l,
                                                  m, do, di)
    dk = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _launch_flash("danet_flash_attn_bwd_dkv", (q, k, v), seg,
                  (l, m, do, di, dk, dv), (b, h, t, d), strides, sm_scale)
    flash_attn_bwd_dkv.launches += 1
    return dk, dv


def flash_attn_bwd_dq(q, k, v, seg, l, m, do, di, sm_scale: float):
    """The dQ kernel (signature of the plain version)."""
    if not _on_cuda(q, "flash_attn_bwd_dq"):
        return flash_attn_bwd_dq_plain(q, k, v, seg, l, m, do, di, sm_scale)
    q, k, v, seg, (b, t, h, d), strides = _bwd_inputs(q, k, v, seg, l, m,
                                                      do, di)
    q, k, v, seg, strides, l, m, do, di = _staged(q, k, v, seg, strides, l,
                                                  m, do, di)
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    _launch_flash("danet_flash_attn_bwd_dq", (q, k, v), seg,
                  (l, m, do, di, dq), (b, h, t, d), strides, sm_scale)
    flash_attn_bwd_dq.launches += 1
    return dq


for _fn in (flash_attn, flash_attn_bwd_dkv, flash_attn_bwd_dq):
    _fn.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the counterpart of the stock
    kernel's ``_flash_attention`` with its custom VJP.

    ``FlashAttention.apply(q, k, v, seg, sm_scale) -> o``.  The forward
    runs ``flash_attn`` and keeps o, l and m; the backward computes
    ``di = sum(o * do, -1)`` in float32 and runs ``flash_attn_bwd_dkv``
    and ``flash_attn_bwd_dq`` (each its kernel on the card, its plain
    version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, sm_scale: float):
        o, l, m = flash_attn(q, k, v, seg, sm_scale)
        ctx.save_for_backward(q, k, v, seg, o, l, m)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, d_o):
        q, k, v, seg, o, l, m = ctx.saved_tensors
        do = d_o.contiguous()
        di = torch.sum(o.float() * do.float(), dim=-1).transpose(
            1, 2).contiguous()                                  # [B, H, T]
        dk, dv = flash_attn_bwd_dkv(q, k, v, seg, l, m, do, di, ctx.sm_scale)
        dq = flash_attn_bwd_dq(q, k, v, seg, l, m, do, di, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention_masked(q, k, v, key_mask):
    """attn_fn-contract wrapper: q, k, v [B, T, H, D], key_mask [B, T]
    bool -> [B, T, H, D].

    Real frames are segment 0 and padded frames segment 1, so padded keys
    are excluded from real queries, and padded queries attend only to
    padded keys.  T must be a multiple of 128, as the stock kernel's
    block size demands."""
    t = q.shape[1]
    if t < BLOCK or t % BLOCK:
        raise ValueError("flash attention needs T a multiple of %d (the "
                         "stock kernel's block size), got T=%d" % (BLOCK, t))
    seg = None
    if key_mask is not None and key_mask.dtype == torch.bool:
        seg = (~key_mask).to(torch.int32)          # 0 = real, 1 = padding
    sm_scale = 1.0 / float(q.shape[-1]) ** 0.5
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, seg, sm_scale)
    return flash_attn(q, k, v, seg, sm_scale)[0]


def attn_backend_default(t: int, hp=None) -> str:
    """'xla' (dense attention) at every size, as in the JAX package: 'auto'
    never switches to the flash kernels."""
    del t, hp
    return "xla"


def resolve_attn_fn(hp, t: int, dense_fn):
    """Pick the attention implementation for sequence length t by
    ATTN_BACKEND: 'flash' -> ``flash_attention_masked``; 'auto' and 'xla'
    -> ``dense_fn``."""
    be = getattr(hp, "ATTN_BACKEND", "auto") or "auto"
    if be not in ("auto", "flash", "xla"):
        raise ValueError("Unknown ATTN_BACKEND %r" % (be,))
    if be == "auto":
        be = attn_backend_default(t, hp)
    return flash_attention_masked if be == "flash" else dense_fn
