"""Ulysses sequence parallelism: head-sharded attention between two
all-to-alls.

Counterpart of ``danet_tpu/parallel/ulysses.py:31-96``.  One all-to-all
turns this rank's T-chunk of every head into the whole sequence of its
H / S heads, each rank runs dense attention over the whole sequence for
them, and a second all-to-all restores the T split
(``collectives.all_to_all``, whose adjoint is the all-to-all back).  Two
collectives against ring attention's S - 1 rotations, full-T logits for
H / S heads; it needs H % S == 0.  No TPU kernel runs here in JAX either:
einsum products in float32 and a softmax, ported as plain torch (cuBLAS
products).
"""
from __future__ import annotations

import torch

from danet_tpu_torch.ops import nn
from danet_tpu_torch.parallel import collectives
from danet_tpu_torch.parallel.ring_attention import (enter_blocks,
                                                     leave_blocks,
                                                     mask_block)
from danet_tpu_torch.parallel.seq_parallel import _mesh_data_axis


def ulysses_attention(q, k, v, mesh, seq_axis: str = "seq", key_mask=None,
                      data_axis: str = "data", causal_window: int = 0):
    """Exact multi-head attention with T split over ``seq_axis``, computed
    head-sharded after an all-to-all: ``ring_attention``'s contract (T and
    H multiples of the axis size).  The ATTN_CAUSAL band applies to the
    gathered whole sequence.  -> [B, T, H, D] on every rank."""
    s = mesh.shape[seq_axis]
    b, t, heads, hd = q.shape
    assert t % s == 0, (t, s)
    assert heads % s == 0, ("Ulysses shards heads over the seq axis; "
                            "use ring_attention when H %% S != 0", heads, s)
    scale = 1.0 / float(hd) ** 0.5
    if key_mask is None:
        key_mask = torch.ones((b, t), dtype=torch.bool, device=q.device)
    d_axis = _mesh_data_axis(mesh, b, data_axis)
    q_loc, k_loc, v_loc = enter_blocks(mesh, (q, k, v), seq_axis, d_axis)
    mask_loc = mask_block(mesh, key_mask, seq_axis, d_axis)

    def heads_to_seq(x):          # [B, T/S, H, D] -> [B, T, H/S, D]
        return collectives.all_to_all(mesh, x, seq_axis, 2, 1)

    qh = heads_to_seq(q_loc).float()
    kh = heads_to_seq(k_loc).float()
    vh = heads_to_seq(v_loc).float()
    mask = collectives._tiled_gather(mesh, mask_loc.to(torch.uint8),
                                     seq_axis, 1).bool()      # [B, T]
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    full = mask[:, None, None, :]
    if causal_window:
        pos = torch.arange(t, device=q.device)
        band = nn.causal_band(pos[:, None], pos[None, :], causal_window)
        full = full & band[None, None]
    logits = torch.where(full, logits, torch.full(
        (), -1e9, dtype=logits.dtype, device=q.device))
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, vh)
    # [B, T, H/S, D] -> [B, T/S, H, D]
    out = collectives.all_to_all(mesh, out.to(q.dtype), seq_axis, 1, 2)
    return leave_blocks(mesh, out, seq_axis, d_axis)
