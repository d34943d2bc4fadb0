"""The collectives of the mesh: the weights' gather, the gradients'
reduction, and the all-reduces of metrics and flags.

GSPMD inserts these in the JAX package; here the trainer calls them.
Every function is collective over the groups it names: every rank of the
mesh calls it, in the same order.  A card tensor rides NCCL when the mesh's
groups carry it (``Mesh.nccl``: the process group was made with
``cpu:gloo,cuda:nccl``, ``multihost.initialize``'s choice on a card), and
then every call here can be captured in a CUDA graph.  A group made with
gloo alone (two ranks sharing one card: NCCL refuses a device twice) carries
card tensors staged through the host: copied off the card, reduced by gloo,
copied back, which no graph can capture.  Nothing switches between the two
on its own; a CPU tensor always rides gloo.

The gradient reduction: each rank's gradients are those of its rows'
mean loss with the full weights; the global batch's mean is their sum over
the mesh over its size (each rank's slice holds as many rows; a 'model'
group that shares its rows contributes its data shard once per rank).  The
'model'-sharded leaves are reduce-scattered over the 'model' group, so that
each rank receives only its slice, and then all-reduced over 'data'; the
replicated leaves are all-reduced over the mesh.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def _staged(mesh, t: torch.Tensor) -> bool:
    return t.is_cuda and not mesh.nccl


def _group(mesh, axis: Optional[str]):
    return mesh.groups["mesh" if axis is None else axis]


def all_reduce(mesh, t: torch.Tensor, axis: Optional[str] = None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over the ``axis`` group (None: the whole
    mesh); -> t."""
    group = _group(mesh, axis)
    if _staged(mesh, t):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=op, group=group)
    return t


def mean(mesh, t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the mesh's ranks: a per-rank batch mean
    becomes the global batch's."""
    t = all_reduce(mesh, t.clone())
    return t / mesh.size if mesh.size > 1 else t


def all_gather(mesh, flat: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """[k] from every rank of the ``axis`` group -> [n, k] in coordinate
    order."""
    group = _group(mesh, axis)
    n = mesh.shape[axis]
    if flat.is_cuda and mesh.nccl:
        out = torch.empty((n,) + tuple(flat.shape), dtype=flat.dtype,
                          device=flat.device)
        dist.all_gather_into_tensor(out, flat.contiguous(), group=group)
        return out
    host = flat.detach().cpu()   # gloo: staged when on the card
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=group)
    return torch.stack(parts).to(flat.device)


def reduce_scatter(mesh, buf: torch.Tensor, axis: str = "model"
                   ) -> torch.Tensor:
    """[n, k], summed over the ``axis`` group -> this rank's row [k]."""
    group = _group(mesh, axis)
    if buf.is_cuda and mesh.nccl:
        out = torch.empty(buf.shape[1:], dtype=buf.dtype, device=buf.device)
        dist.reduce_scatter_tensor(out, buf.contiguous(), group=group)
        return out
    # gloo: an all-reduce of the whole buffer, then this rank's row
    return all_reduce(mesh, buf.contiguous(), axis)[mesh.coords[axis]]


def host_any(mesh, flag: bool) -> bool:
    """Whether ``flag`` is set on any rank of the mesh (a host value, over
    gloo: no card is synchronized)."""
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.groups["mesh"])
    return bool(t.item())


def barrier(mesh) -> None:
    """Wait for every rank of the mesh (a host all-reduce over gloo, so
    that it never needs a card)."""
    host_any(mesh, False)


def _moved(x: torch.Tensor, axis: int) -> torch.Tensor:
    return x.movedim(axis, 0)


def gather_leaves(mesh, shards: List[torch.Tensor],
                  axes: List[Optional[int]]) -> List[torch.Tensor]:
    """The full leaves of this rank's ``shards``: each leaf with a
    'model' axis (``axes[i]`` not None) all-gathered along it over the
    'model' group, in one collective per dtype; replicated leaves as they
    are (the same tensors).  Collective over 'model'."""
    out = list(shards)
    n = mesh.shape.get("model", 1)
    by_dtype: dict = {}
    for i, a in enumerate(axes):
        if a is not None:
            by_dtype.setdefault(shards[i].dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([_moved(shards[i].detach(), axes[i]).reshape(-1)
                          for i in idx])
        full = all_gather(mesh, flat)                     # [n, k]
        at = 0
        for i in idx:
            s = shards[i]
            k = s.numel()
            moved = _moved(s, axes[i]).shape              # (size, rest...)
            x = full[:, at:at + k].reshape(
                (n * moved[0],) + tuple(moved[1:]))
            out[i] = x.movedim(0, axes[i]).contiguous()
            at += k
    return out


def reduce_grads(mesh, grads: List[torch.Tensor],
                 axes: List[Optional[int]]) -> List[torch.Tensor]:
    """The global batch's gradients from each rank's full-shape
    ``grads``: the sum over the mesh over its size, each 'model'-sharded
    leaf reduce-scattered to this rank's slice along ``axes[i]`` (then
    all-reduced over 'data'), each replicated leaf all-reduced over the
    mesh, one collective per kind and dtype.  -> per leaf, the slice this
    rank holds."""
    out = list(grads)
    n = mesh.shape.get("model", 1)
    scale = 1.0 / mesh.size
    groups: dict = {}
    for i, (g, a) in enumerate(zip(grads, axes)):
        groups.setdefault((a is not None, g.dtype), []).append(i)
    for (sharded, _), idx in groups.items():
        if not sharded:
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            all_reduce(mesh, flat)
            at = 0
            for i in idx:
                k = grads[i].numel()
                out[i] = flat[at:at + k].reshape(grads[i].shape)
                at += k
        else:
            buf = torch.cat([_moved(grads[i], axes[i]).reshape(n, -1)
                             for i in idx], dim=1)        # [n, k]
            mine = reduce_scatter(mesh, buf)
            if mesh.shape.get("data", 1) > 1:
                all_reduce(mesh, mine, "data")
            at = 0
            for i in idx:
                moved = _moved(grads[i], axes[i]).shape
                shard = (moved[0] // n,) + tuple(moved[1:])
                k = grads[i].numel() // n
                out[i] = mine[at:at + k].reshape(shard).movedim(
                    0, axes[i]).contiguous()
                at += k
    if mesh.size > 1:
        out = [g * scale for g in out]
    return out
