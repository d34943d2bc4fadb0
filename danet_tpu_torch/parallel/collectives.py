"""The collectives of the mesh: the weights' gather, the gradients'
reduction, the all-reduces of metrics and flags, and the collectives that
pipeline and expert parallelism run inside the model.

GSPMD and ``shard_map`` insert these in the JAX package; here the trainer
and the model call them.  Every function is collective over the groups it
names: every rank of that group calls it, in the same order.  A card tensor
rides NCCL when the mesh's groups carry it (``Mesh.nccl``: the process
group was made with ``cpu:gloo,cuda:nccl``, ``multihost.initialize``'s
choice on a card), and then every call here can be captured in a CUDA
graph.  A group made with gloo alone (two ranks sharing one card: NCCL
refuses a device twice) carries card tensors staged through the host:
copied off the card, moved by gloo, copied back, which no graph can
capture.  Nothing switches between the two on its own; a CPU tensor always
rides gloo.

The gradient reduction: each rank's gradients are those of its rows' mean
loss with the full weights; the global batch's mean is their sum over the
mesh over its size (each rank's slice holds as many rows; ranks that share
their rows contribute their data shard once per rank).  A leaf sharded at
rest (``sharding.shard_axes``: a dimension on 'model' and / or on
'expert') is reduce-scattered over each of those axes' groups, so that each
rank receives only its slice, and then all-reduced over the mesh's other
axes; a replicated leaf is all-reduced over the mesh.  A leaf whose
gradient only some ranks of one axis compute (its ``owner``: a pipeline
stage's layers over 'pipe', an expert group's weights over 'expert'; the
others hold zeros) is the sum of its owners' parts, so its sum over the
mesh counts each row slice that axis' size fewer times: its scale is
n_owner / size.

Inside the model (``parallel/pipeline.py``, ``parallel/expert.py``) a
tensor is either the same on every rank of an axis group ("replicated":
every rank computes it alike, and its cotangent is the whole one on every
rank) or the rank's own part.  ``enter`` (replicated in; the backward sums
the parts' cotangents), ``leave_sum`` (parts summed out, replicated) and
``leave_gather`` (parts concatenated out, replicated) cross between the
two, ``all_gather_parts`` and ``all_to_all`` move parts, and ``send`` /
``recv`` / ``broadcast`` carry a pipeline's activations between its
stages; each of the first five is an autograd Function with its adjoint
as the backward.  Sequence parallelism (``parallel/seq_parallel.py``,
``ring_attention.py``, ``ulysses.py``) adds ``enter_sharded`` (a
replicated tensor in, this rank's slice of it out: ``leave_gather``'s
adjoint), ``sum_parts`` (the parts summed, the total used by each rank in
its own part: a statistic over the whole sequence, such as a centring
mean, whose backward sums the ranks' cotangents of the total, because each
rank's differs, where ``leave_sum``'s hands each part its own), the
neighbour shifts ``shift_from_left`` / ``shift_from_right``
(JAX's ``ppermute`` over 'seq' without wrap: the edge rank receives
zeros; each the other's adjoint) and the ring ``rotate`` (i -> i + 1 mod
S; the reverse rotation its adjoint), and ``exchange``, the point-to-
point-to-point batch under all three and the relay: every rank of the
group exchanges with its neighbours at the same points of the program,
each rank's sends and receives as one batch, so that two ranks that send
to each other do not wait on each other's receive, in an order fixed by
the program, so that a K-step CUDA graph captures it.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from danet_tpu_torch.parallel.sharding import axes_of


def _staged(mesh, t: torch.Tensor) -> bool:
    return t.is_cuda and not mesh.nccl


def _group(mesh, axis: Optional[str]):
    return mesh.groups["mesh" if axis is None else axis]


def _size(mesh, axis: Optional[str]) -> int:
    return mesh.size if axis is None else mesh.shape[axis]


def all_reduce(mesh, t: torch.Tensor, axis: Optional[str] = None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over the ``axis`` group (None: the whole
    mesh); -> t.  On gloo a bfloat16 tensor is summed in float32 (gloo's
    own bfloat16 arithmetic is not every build's)."""
    group = _group(mesh, axis)
    if _staged(mesh, t) or (not t.is_cuda and t.dtype == torch.bfloat16):
        host = t.detach().cpu()
        if host.dtype == torch.bfloat16:
            host = host.float()
        dist.all_reduce(host, op=op, group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=op, group=group)
    return t


def mean(mesh, t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the mesh's ranks: a per-rank batch mean
    becomes the global batch's."""
    t = all_reduce(mesh, t.clone())
    return t / mesh.size if mesh.size > 1 else t


def all_gather(mesh, flat: torch.Tensor, axis: Optional[str] = "model"
               ) -> torch.Tensor:
    """[k...] from every rank of the ``axis`` group (None: the whole mesh)
    -> [n, k...] in coordinate (rank) order."""
    group = _group(mesh, axis)
    n = _size(mesh, axis)
    if flat.is_cuda and mesh.nccl:
        out = torch.empty((n,) + tuple(flat.shape), dtype=flat.dtype,
                          device=flat.device)
        dist.all_gather_into_tensor(out, flat.contiguous(), group=group)
        return out
    host = flat.detach().cpu().contiguous()   # gloo: staged when on the card
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


# ---------------------------------------------------------------------------
# point to point and broadcast along one axis (a pipeline's stages)
# ---------------------------------------------------------------------------

def send(mesh, t: torch.Tensor, axis: str, to: int) -> None:
    """Send ``t`` to the rank of this rank's ``axis`` group at coordinate
    ``to``; the receiver calls ``recv`` with this rank's coordinate."""
    dst = mesh.rank_at(**{axis: to})
    if _staged(mesh, t):
        dist.send(t.detach().cpu().contiguous(), dst=dst,
                  group=_group(mesh, axis))
        return
    dist.send(t.detach().contiguous(), dst=dst, group=_group(mesh, axis))


def recv(mesh, shape, dtype, device, axis: str, frm: int) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on ``device`` from the rank of
    this rank's ``axis`` group at coordinate ``frm`` (its ``send``)."""
    src = mesh.rank_at(**{axis: frm})
    device = torch.device(device)
    if device.type == "cuda" and not mesh.nccl:
        host = torch.empty(shape, dtype=dtype)
        dist.recv(host, src=src, group=_group(mesh, axis))
        return host.to(device)
    out = torch.empty(shape, dtype=dtype, device=device)
    dist.recv(out, src=src, group=_group(mesh, axis))
    return out


def broadcast(mesh, t: torch.Tensor, axis: str, frm: int) -> torch.Tensor:
    """``t`` of the rank at coordinate ``frm`` of this rank's ``axis``
    group, on every rank of it (the others pass a tensor of the same shape
    and dtype, which is written); -> t."""
    src = mesh.rank_at(**{axis: frm})
    if _staged(mesh, t):
        host = t.detach().cpu().contiguous()
        dist.broadcast(host, src=src, group=_group(mesh, axis))
        return t.copy_(host)
    dist.broadcast(t, src=src, group=_group(mesh, axis))
    return t


# ---------------------------------------------------------------------------
# the collectives of the model's parts, with their adjoints
# ---------------------------------------------------------------------------

def _tiled_gather(mesh, t: torch.Tensor, axis: str, dim: int):
    """The ``axis`` group's ``t`` concatenated along ``dim`` in coordinate
    order."""
    parts = all_gather(mesh, t.movedim(dim, 0).contiguous(), axis)
    n = parts.shape[0]
    whole = parts.reshape((n * parts.shape[1],) + tuple(parts.shape[2:]))
    return whole.movedim(0, dim)


def _own_slice(mesh, t: torch.Tensor, axis: str, dim: int):
    n = mesh.shape[axis]
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.coords[axis] * size, size)


def _a2a(mesh, t: torch.Tensor, axis: str, split: int, concat: int):
    """JAX's tiled ``all_to_all``: ``t`` cut into n chunks along ``split``,
    chunk j to the group's rank j; the n chunks received concatenated
    along ``concat`` in the senders' order."""
    n = mesh.shape[axis]
    group = _group(mesh, axis)
    x = t.movedim(split, 0)
    shape = x.shape
    x = x.reshape((n, shape[0] // n) + tuple(shape[1:])).contiguous()
    if x.is_cuda and mesh.nccl:
        got = torch.empty_like(x)
        dist.all_to_all_single(got, x, group=group)
    else:
        host = x.detach().cpu()
        wide = host.dtype == torch.bfloat16
        if wide:
            host = host.float()
        out = torch.empty_like(host)
        dist.all_to_all_single(out, host, group=group)
        got = out.to(device=x.device, dtype=x.dtype)
    # got[j]: the chunk from rank j, shaped as this rank's chunk of x
    got = got.movedim(1, split + 1)          # [n, ...t with split/n...]
    got = got.movedim(0, concat)             # n next to the concat dim
    shape = list(got.shape)
    shape[concat:concat + 2] = [shape[concat] * shape[concat + 1]]
    return got.reshape(shape)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, g.contiguous().clone(), ctx.axis), \
            None, None


class _LeaveSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(mesh, x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(mesh, x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, g.contiguous().clone(), ctx.axis), \
            None, None


class _LeaveGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _tiled_gather(mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_own_slice(ctx.mesh, g, ctx.axis, ctx.dim).contiguous(),
                None, None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _tiled_gather(mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        n = mesh.shape[axis]
        moved = g.movedim(dim, 0)
        buf = moved.reshape(n, -1)
        mine = reduce_scatter(mesh, buf.contiguous(), axis)
        shape = (moved.shape[0] // n,) + tuple(moved.shape[1:])
        return mine.reshape(shape).movedim(0, dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split, concat):
        ctx.mesh, ctx.axis, ctx.split, ctx.concat = mesh, axis, split, concat
        return _a2a(mesh, x, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_a2a(ctx.mesh, g, ctx.axis, ctx.concat, ctx.split),
                None, None, None, None)


class _EnterSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _own_slice(mesh, x, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_tiled_gather(ctx.mesh, g.contiguous(), ctx.axis, ctx.dim),
                None, None, None)


def exchange(mesh, axis: str, sends: list, recvs: list) -> list:
    """Point-to-point along ``axis`` as one batch (``batch_isend_irecv``:
    NCCL's group, in which two ranks that send to each other do not wait
    on each other's receive): ``sends`` [(tensor, coordinate)], ``recvs``
    [(like, coordinate)], each receive a tensor of its ``like``'s shape,
    dtype and device.  -> the received tensors, in ``recvs``' order.  The
    group's first exchange is preceded by ``_prime``; every rank of the
    group reaches its first exchange without waiting on another's."""
    group = _group(mesh, axis)
    like = [t for t, _ in sends] + [t for t, _ in recvs]
    if not like:
        return []
    device = like[0].device
    staged = device.type == "cuda" and not mesh.nccl
    if axis not in mesh.primed:
        _prime(mesh, axis, device)
    ops, got = [], []
    for t, to in sends:
        buf = t.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, buf.cpu() if staged else buf,
                              peer=mesh.rank_at(**{axis: to}), group=group))
    for t, frm in recvs:
        got.append(torch.empty(t.shape, dtype=t.dtype,
                               device="cpu" if staged else device))
        ops.append(dist.P2POp(dist.irecv, got[-1],
                              peer=mesh.rank_at(**{axis: frm}), group=group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [g.to(device) for g in got] if staged else got


def _prime(mesh, axis: str, device) -> None:
    """Set up the ``axis`` group's point-to-point before its first
    exchange: an all-reduce over it (NCCL's batched point-to-point wants
    the group's communicator made by a collective of all its ranks), then
    one batch on every rank that sends to and receives from each ring
    neighbour, so that NCCL, which connects a pair when an operation first
    needs it, makes every neighbour connection while all the ranks take
    part."""
    all_reduce(mesh, torch.zeros(1, device=device), axis)
    n, c = mesh.shape[axis], mesh.coords[axis]
    peers = sorted({mesh.rank_at(**{axis: (c + d) % n}) for d in (-1, 1)}
                   - {mesh.rank})
    staged = torch.device(device).type == "cuda" and not mesh.nccl
    dev = "cpu" if staged else device
    ops = []
    for peer in peers:
        ops.append(dist.P2POp(dist.isend, torch.zeros(1, device=dev),
                              peer=peer, group=_group(mesh, axis)))
        ops.append(dist.P2POp(dist.irecv, torch.empty(1, device=dev),
                              peer=peer, group=_group(mesh, axis)))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    mesh.primed.add(axis)


def _hop(mesh, t: torch.Tensor, axis: str, step: int, wrap: bool):
    """``t`` moved ``step`` (+1 or -1) coordinates along ``axis``: each
    rank receives that of coordinate c - step; with ``wrap`` around the
    ring, else the edge receives zeros."""
    n, c = mesh.shape[axis], mesh.coords[axis]
    to, frm = c + step, c - step
    if wrap:
        to, frm = to % n, frm % n
    got = exchange(mesh, axis, [(t, to)] if 0 <= to < n else [],
                   [(t, frm)] if 0 <= frm < n else [])
    return got[0] if got else torch.zeros_like(t)


class _Hop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, step, wrap):
        ctx.mesh, ctx.axis, ctx.step, ctx.wrap = mesh, axis, step, wrap
        return _hop(mesh, x.contiguous(), axis, step, wrap)

    @staticmethod
    def backward(ctx, g):
        return (_hop(ctx.mesh, g.contiguous(), ctx.axis, -ctx.step,
                     ctx.wrap), None, None, None, None)


def enter_sharded(mesh, x: torch.Tensor, axis: str, dim: int
                  ) -> torch.Tensor:
    """This rank's slice along ``dim`` (its coordinate's of the ``axis``
    group's equal parts) of ``x``, the same on every rank of the group (a
    ``shard_map`` input sharded on ``dim``); its backward gathers the
    slices' cotangents, so that every rank holds the whole one."""
    return _EnterSharded.apply(x, mesh, axis, dim)


def shift_from_left(mesh, x: torch.Tensor, axis: str = "seq"
                    ) -> torch.Tensor:
    """Every rank receives its left neighbour's ``x`` along ``axis``
    (coordinate 0 receives zeros): JAX's ``_shift_from_left``."""
    return _Hop.apply(x, mesh, axis, 1, False)


def shift_from_right(mesh, x: torch.Tensor, axis: str = "seq"
                     ) -> torch.Tensor:
    """Every rank receives its right neighbour's ``x`` along ``axis``
    (the last coordinate receives zeros): JAX's ``_shift_from_right``."""
    return _Hop.apply(x, mesh, axis, -1, False)


def rotate(mesh, x: torch.Tensor, axis: str = "seq") -> torch.Tensor:
    """The ring rotation along ``axis``: every rank receives the ``x`` of
    coordinate c - 1 mod S (JAX's ``ppermute`` with perm i -> i + 1 mod
    S)."""
    return _Hop.apply(x, mesh, axis, 1, True)


def enter(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x``, the same on every rank of the ``axis`` group, as the input of
    each rank's part: the identity, whose backward sums the parts'
    cotangents over the group (JAX's ``shard_map`` entry with a
    replicated ``in_spec``)."""
    return _Enter.apply(x, mesh, axis)


def leave_sum(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of the parts ``x`` over the ``axis`` group, the same on
    every rank (``psum`` to a replicated output); its backward hands each
    part the whole cotangent."""
    return _LeaveSum.apply(x, mesh, axis)


def sum_parts(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of the parts ``x`` over the ``axis`` group, which each rank
    then uses in its own part (JAX's ``psum`` inside a ``shard_map`` whose
    output stays sharded): each rank's cotangent of the sum differs, so
    the backward sums them over the group too."""
    return _SumParts.apply(x, mesh, axis)


def leave_gather(mesh, x: torch.Tensor, axis: str, dim: int
                 ) -> torch.Tensor:
    """The parts ``x`` concatenated along ``dim`` over the ``axis`` group,
    the same on every rank (a ``shard_map`` output sharded on ``dim``,
    read whole); its backward hands each part its slice of the
    cotangent."""
    return _LeaveGather.apply(x, mesh, axis, dim)


def all_gather_parts(mesh, x: torch.Tensor, axis: str, dim: int
                     ) -> torch.Tensor:
    """JAX's tiled ``all_gather`` of the parts ``x`` along ``dim``; each
    rank goes on with the whole in its own way, so the backward is the
    reduce-scatter of the cotangents (``psum_scatter``)."""
    return _AllGather.apply(x, mesh, axis, dim)


def all_to_all(mesh, x: torch.Tensor, axis: str, split: int, concat: int
               ) -> torch.Tensor:
    """JAX's tiled ``all_to_all`` over the ``axis`` group (``_a2a``); the
    backward is the all-to-all back, ``split`` and ``concat`` swapped."""
    return _AllToAll.apply(x, mesh, axis, split, concat)


# ---------------------------------------------------------------------------
# the weights' gather and the gradients' reduction
# ---------------------------------------------------------------------------

def _moved(x: torch.Tensor, axis: int) -> torch.Tensor:
    return x.movedim(axis, 0)


def _gather_axis(mesh, tensors: list, dims: list, axis: str) -> list:
    """Each of ``tensors`` all-gathered along its ``dims[i]`` over the
    ``axis`` group, in one collective per dtype."""
    out = list(tensors)
    n = mesh.shape[axis]
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([_moved(tensors[i].detach(), dims[i]).reshape(-1)
                          for i in idx])
        full = all_gather(mesh, flat, axis)                # [n, k]
        at = 0
        for i in idx:
            s = tensors[i]
            k = s.numel()
            moved = _moved(s, dims[i]).shape               # (size, rest...)
            x = full[:, at:at + k].reshape(
                (n * moved[0],) + tuple(moved[1:]))
            out[i] = x.movedim(0, dims[i]).contiguous()
            at += k
    return out


def gather_leaves(mesh, shards: List[torch.Tensor], axes: list
                  ) -> List[torch.Tensor]:
    """The full leaves of this rank's ``shards``: each leaf sharded on an
    axis (``axes[i]``: None, a 'model' dimension, or {axis: dim}) all-
    gathered along it over that axis' group, one collective per axis and
    dtype; replicated leaves as they are (the same tensors).  Collective
    over the sharding axes' groups."""
    out = list(shards)
    specs = [axes_of(a) for a in axes]
    for axis in ("expert", "model"):
        idx = [i for i, s in enumerate(specs) if axis in s]
        if not idx:
            continue
        got = _gather_axis(mesh, [out[i] for i in idx],
                           [specs[i][axis] for i in idx], axis)
        for i, t in zip(idx, got):
            out[i] = t
    return out


def _scatter_axis(mesh, grads: list, dims: list, axis: str) -> list:
    """Each of ``grads`` reduce-scattered along its ``dims[i]`` over the
    ``axis`` group (one collective per dtype): this rank's slice of the
    group's sum."""
    out = list(grads)
    n = mesh.shape[axis]
    by_dtype: dict = {}
    for i, g in enumerate(grads):
        by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        buf = torch.cat([_moved(grads[i], dims[i]).reshape(n, -1)
                         for i in idx], dim=1)             # [n, k]
        mine = reduce_scatter(mesh, buf, axis)
        at = 0
        for i in idx:
            moved = _moved(grads[i], dims[i]).shape
            shard = (moved[0] // n,) + tuple(moved[1:])
            k = grads[i].numel() // n
            out[i] = mine[at:at + k].reshape(shard).movedim(
                0, dims[i]).contiguous()
            at += k
    return out


def _all_reduce_over(mesh, flat: torch.Tensor, axes: list) -> None:
    """``flat`` summed in place over the product of ``axes`` (one
    all-reduce over the mesh when they are all of its axes wider than 1,
    else one per axis)."""
    wide = [a for a in mesh.axis_names if mesh.shape[a] > 1]
    axes = [a for a in axes if mesh.shape[a] > 1]
    if not axes:
        return
    if sorted(axes) == sorted(wide):
        all_reduce(mesh, flat)
        return
    for a in axes:
        all_reduce(mesh, flat, a)


def reduce_grads(mesh, grads: List[torch.Tensor], axes: list,
                 owners: Optional[list] = None) -> List[torch.Tensor]:
    """The global batch's gradients from each rank's full-shape ``grads``
    (the module's docstring): each sharded leaf reduce-scattered to this
    rank's slice over each of its axes (``axes[i]`` as in
    ``gather_leaves``), then every leaf all-reduced over the mesh's other
    axes, one collective per kind and dtype; each leaf times n_owner /
    size, n_owner the size of its ``owners[i]`` axis (1 for None).  -> per
    leaf, the slice this rank holds."""
    specs = [axes_of(a) for a in axes]
    owners = owners or [None] * len(grads)
    out = list(grads)
    buckets: dict = {}
    for i, s in enumerate(specs):
        buckets.setdefault(tuple(sorted(s)), []).append(i)
    for sharded, idx in buckets.items():
        for axis in sharded:
            got = _scatter_axis(mesh, [out[i] for i in idx],
                                [specs[i][axis] for i in idx], axis)
            for i, t in zip(idx, got):
                out[i] = t
        rest = [a for a in mesh.axis_names if a not in sharded]
        by_dtype: dict = {}
        for i in idx:
            by_dtype.setdefault(out[i].dtype, []).append(i)
        for group in by_dtype.values():
            flat = torch.cat([out[i].reshape(-1) for i in group])
            _all_reduce_over(mesh, flat, rest)
            at = 0
            for i in group:
                k = out[i].numel()
                out[i] = flat[at:at + k].reshape(out[i].shape)
                at += k
    if mesh.size > 1 or any(owners):
        out = [g * ((mesh.shape[o] if o else 1) / mesh.size)
               for g, o in zip(out, owners)]
    return out
