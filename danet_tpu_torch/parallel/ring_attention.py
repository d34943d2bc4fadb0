"""Ring attention: exact sequence-parallel attention over a 'seq' axis.

Counterpart of ``danet_tpu/parallel/ring_attention.py:23-127``.  The
queries stay on their rank (T split over the 'seq' group); the key/value
blocks rotate around the ring (``collectives.rotate``, i -> i + 1 mod S,
whose adjoint is the reverse rotation), and each rank folds every block
into an online-softmax accumulator (running max, denominator), so that the
result is full attention with O(T / S) of it on each rank.  No TPU kernel
runs here in JAX either: einsum products in float32 and an online softmax,
which plain torch (cuBLAS products) ports as they are.
"""
from __future__ import annotations

import torch

from danet_tpu_torch.ops import nn
from danet_tpu_torch.parallel import collectives
from danet_tpu_torch.parallel.seq_parallel import _mesh_data_axis


def _fold_block(acc, m, denom, q, k, v, scale, kmask, band=None):
    """Fold one K/V block into the online-softmax state (JAX
    ``_fold_block``): q [B, Tq, H, D]; k, v [B, Tk, H, D]; kmask [B, Tk]
    (True: a valid key); band [Tq, Tk] bool or None; acc [B, Tq, H, D]
    (unnormalised), m and denom [B, Tq, H]."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = kmask[:, None, None, :]
    if band is not None:
        mask = mask & band[None, None]
    logits = torch.where(mask, logits, torch.full((), -1e9, dtype=logits
                                                  .dtype, device=q.device))
    blk_max = torch.amax(logits, dim=-1)                  # [B, H, Tq]
    m_new = torch.maximum(m, blk_max.movedim(1, 2))       # [B, Tq, H]
    correction = torch.exp(m - m_new)
    p = torch.exp(logits - m_new.movedim(1, 2)[..., None])  # [B, H, Tq, Tk]
    p_sum = torch.sum(p, dim=-1).movedim(1, 2)            # [B, Tq, H]
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)
    acc = acc * correction[..., None] + pv
    denom = denom * correction + p_sum
    return acc, m_new, denom


def enter_blocks(mesh, tensors, seq_axis: str, d_axis):
    """Each of ``tensors`` (whole on every rank of the group) -> this rank's
    (rows, chunk) block."""
    out = []
    for x in tensors:
        if d_axis is not None:
            x = collectives.enter_sharded(mesh, x, d_axis, 0)
        out.append(collectives.enter_sharded(mesh, x, seq_axis, 1))
    return out


def leave_blocks(mesh, y, seq_axis: str, d_axis):
    """This rank's block of the output -> the whole, on every rank."""
    y = collectives.leave_gather(mesh, y, seq_axis, 1)
    if d_axis is not None:
        y = collectives.leave_gather(mesh, y, d_axis, 0)
    return y


def mask_block(mesh, key_mask, seq_axis: str, d_axis):
    """This rank's (rows, chunk) block of a boolean [B, T] mask."""
    if d_axis is not None:
        key_mask = collectives._own_slice(mesh, key_mask, d_axis, 0)
    return collectives._own_slice(mesh, key_mask, seq_axis, 1).contiguous()


def ring_attention(q, k, v, mesh, seq_axis: str = "seq", key_mask=None,
                   data_axis: str = "data", causal_window: int = 0):
    """Exact multi-head attention with T split over ``seq_axis``.

    q, k, v: [B, T, H, D], the same on every rank of the 'seq' group (T a
    multiple of the axis size); ``key_mask`` [B, T] bool (False: not a
    key); ``data_axis``: the mesh axis the rows split over as well, when it
    divides B (``_mesh_data_axis``; None: every rank of a 'seq' group runs
    all of them); ``causal_window`` > 0: the ATTN_CAUSAL band in global
    frame positions, query t sees keys (t - window, t], rebuilt per fold
    from the global offsets of both blocks.  -> [B, T, H, D] on every
    rank (float32 accumulation, q's dtype out).  Collective over the
    group."""
    s = mesh.shape[seq_axis]
    b, t, _, hd = q.shape
    assert t % s == 0
    chunk = t // s
    scale = 1.0 / float(hd) ** 0.5
    if key_mask is None:
        key_mask = torch.ones((b, t), dtype=torch.bool, device=q.device)
    d_axis = _mesh_data_axis(mesh, b, data_axis)
    q_loc, k_loc, v_loc = enter_blocks(mesh, (q, k, v), seq_axis, d_axis)
    mask_blk = mask_block(mesh, key_mask, seq_axis, d_axis)
    r = mesh.coords[seq_axis]
    qf = q_loc.float()
    acc = torch.zeros(q_loc.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q_loc.shape[:3], float("-inf"), dtype=torch.float32,
                   device=q.device)
    denom = torch.zeros(q_loc.shape[:3], dtype=torch.float32,
                        device=q.device)
    kv = torch.stack([k_loc, v_loc])             # rotates as one message
    for i in range(s):
        band = None
        if causal_window:
            # the block held at fold i started on ring position r - i
            src = (r - i) % s
            qpos = r * chunk + torch.arange(chunk, device=q.device)[:, None]
            kpos = src * chunk + torch.arange(chunk, device=q.device)[None]
            band = nn.causal_band(qpos, kpos, causal_window)
        acc, m, denom = _fold_block(acc, m, denom, qf, kv[0].float(),
                                    kv[1].float(), scale, mask_blk, band)
        if i < s - 1:       # the last fold's rotation would be dead traffic
            kv = collectives.rotate(mesh, kv, seq_axis)
            mask_blk = collectives.rotate(
                mesh, mask_blk.to(torch.uint8), seq_axis).bool()
    out = (acc / denom[..., None]).to(q.dtype)
    return leave_blocks(mesh, out, seq_axis, d_axis)
