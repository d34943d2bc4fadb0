"""The process mesh and the sharding rules of data, tensor, pipeline and
expert parallelism.

Counterpart of ``danet_tpu/parallel/sharding.py``.  In JAX one process
drives a mesh of devices and GSPMD (or ``shard_map``) inserts the
collectives.  Here every card is a process of one ``torch.distributed``
group, the mesh is a grid of those processes' ranks, and the trainer and
the model call the collectives themselves (``parallel/collectives.py``).
Rank r sits at ``np.arange(world).reshape(shape)[coords]``, the order of
JAX's ``make_mesh`` over ('data', 'model'[, 'pipe'][, 'expert'][,
'seq']), so that the ranks of the last axis are neighbours.

The layout is JAX's:

  * the batch axis of every input -> split over the mesh
    (``batch_rows``): over ('data', 'model') when the batch divides by
    n_data * n_model, else over 'data' alone, the ranks of one 'model'
    group then sharing their data shard's rows; the ranks of one 'pipe',
    'expert' or 'seq' group always share their rows;
  * LSTM / GRU gate weights [in, G, h] -> h on 'model';
  * gate biases [G, h] -> h on 'model';
  * output-head / MLP weights [in, out] -> out on 'model';
  * the MoE router [d, E] -> E on 'expert', its experts' ``w_in`` [E, d,
    ff] and ``w_out`` [E, ff, d] -> E on 'expert';
  * convolutions, anchors, small biases, every dimension that its axis
    does not divide, and a pipeline's layers (JAX has no 'pipe' rule: its
    ``shard_map`` hands each stage its layers inside the step) ->
    replicated.

A rank holds only its slice of each sharded leaf (``shard_params``), and so
do that leaf's Adam moments and EMA; the trainer gathers the full weights
once per step (``gather_params``), the model runs on them (a pipeline stage
on its own layers, an expert group on its own experts), and the gradients
are reduced back to the slices, each leaf by the axis that owns it
(``leaf_owners``).
"""
from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from danet_tpu_torch.weights import leaf_names, leaves


class MeshUnavailableError(RuntimeError):
    """The configured mesh factors do not fit the available processes.

    The ONE mesh failure model code may fall back densely on (a MESH_*
    training config serving on one card); any other error escaping mesh
    construction is a bug and propagates (``encoders._route_mesh``)."""


class Mesh:
    """A grid of process ranks over named axes.

    ``devices`` the ranks, shaped by the axes' sizes; ``shape`` {axis:
    size} in axis order; ``rank`` this process's rank (0 without a process
    group); ``coords`` {axis: index} of this rank, None for a rank outside
    the grid (explicit factors may leave ranks idle).  ``connect`` makes
    the ``torch.distributed`` groups: ``groups[axis]`` holds the ranks that
    differ only in that axis' coordinate, ``groups["mesh"]`` every rank of
    the grid.  ``nccl``: the groups carry card tensors over NCCL (else
    over gloo, staged through the host by ``collectives``).  ``row_axes``:
    the axes a batch's rows split over (the Trainer sets it from
    BATCH_SIZE: ('data',), or ('data', 'model') when the rows split over
    both), which the routed MoE's global capacity and the pipeline's
    global batch read."""

    def __init__(self, devices: np.ndarray, axis_names: tuple, rank: int = 0):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.rank = int(rank)
        where = np.argwhere(self.devices == self.rank)
        self.coords = (dict(zip(self.axis_names, (int(i) for i in where[0])))
                       if len(where) else None)
        self.groups: dict = {}
        self.nccl = False
        self.row_axes = ("data",)
        self.primed: set = set()   # axes whose point-to-point is set up

    def rank_at(self, **coords) -> int:
        """The rank at this rank's coordinates with ``coords`` replacing
        some of them (``rank_at(pipe=0)``: the first stage of this rank's
        pipeline)."""
        c = dict(self.coords, **coords)
        return int(self.devices[tuple(c[a] for a in self.axis_names)])

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def connect(self) -> "Mesh":
        """Make the mesh's process groups.  Collective: every rank of the
        default group calls it, in the same order as every other mesh's
        ``connect``, ranks outside the grid included (``new_group`` needs
        them all).  -> self."""
        if not dist.is_initialized():
            raise RuntimeError(
                "Mesh.connect needs a torch.distributed process group "
                "(parallel/multihost.py::initialize)")
        world = dist.get_world_size()
        for i, axis in enumerate(self.axis_names):
            lines = np.moveaxis(self.devices, i, -1).reshape(
                -1, self.devices.shape[i])
            mine, _ = dist.new_subgroups_by_enumeration(
                [[int(r) for r in line] for line in lines])
            self.groups[axis] = mine
        ranks = sorted(int(r) for r in self.devices.flat)
        self.groups["mesh"] = (dist.group.WORLD if ranks == list(range(world))
                               else dist.new_group(ranks))
        if self.coords is None:
            self.groups = {k: None for k in self.groups}
        else:
            self.nccl = "nccl" in str(
                dist.get_backend(self.groups["mesh"])).lower()
        return self


def _world_ranks() -> list:
    return list(range(dist.get_world_size() if dist.is_initialized() else 1))


def _own_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(n_data: Optional[int] = None, n_model: Optional[int] = None,
              devices=None, n_pipe: int = 1, n_expert: int = 1,
              n_seq: int = 1) -> Mesh:
    """A mesh over ``devices`` (the ranks of the process group by
    default), JAX's factor logic: a None factor takes what the others
    leave; fully explicit factors that need fewer ranks than there are use
    a prefix of them; a product that does not fit raises
    MeshUnavailableError.  Axes: always ('data', 'model'); 'pipe',
    'expert' and 'seq' are appended only when their size exceeds 1 ('seq'
    last).  The mesh is not connected (``Mesh.connect``)."""
    devices = list(devices) if devices is not None else _world_ranks()
    n_dev = len(devices)
    n_pipe = int(n_pipe or 1)
    n_expert = int(n_expert or 1)
    n_seq = int(n_seq or 1)
    rest = n_pipe * n_expert * n_seq
    if n_data is None and n_model is None:
        n_data, n_model = n_dev // rest, 1
    elif n_data is None:
        n_data = n_dev // (n_model * rest)
    elif n_model is None:
        n_model = n_dev // (n_data * rest)
    elif n_data * n_model * rest < n_dev:
        devices = devices[: n_data * n_model * rest]
        n_dev = len(devices)
    if n_data * n_model * rest != n_dev:
        raise MeshUnavailableError(
            "mesh %dx%dx%dx%dx%d != %d devices"
            % (n_data, n_model, n_pipe, n_expert, n_seq, n_dev))
    shape = [n_data, n_model]
    names = ["data", "model"]
    for name, n in (("pipe", n_pipe), ("expert", n_expert), ("seq", n_seq)):
        if n > 1:
            shape.append(n)
            names.append(name)
    return Mesh(np.asarray(devices).reshape(shape), tuple(names),
                _own_rank())


def mesh_factors(hp) -> int:
    """The product of the MESH_* keys (an unset or 0 key counts 1)."""
    n = 1
    for key in ("MESH_DATA", "MESH_MODEL", "MESH_PIPE", "MESH_EXPERT",
                "MESH_SEQ"):
        n *= int(getattr(hp, key, 1) or 1)
    return n


def mesh_from_hparams(hp, devices=None) -> Mesh:
    """The mesh of MESH_DATA / MESH_MODEL / MESH_PIPE / MESH_EXPERT /
    MESH_SEQ; the default (all keys 1) data-parallelizes over the largest
    rank count that divides BATCH_SIZE, leaving the other ranks idle."""
    n_data = getattr(hp, "MESH_DATA", None) or None
    n_model = getattr(hp, "MESH_MODEL", None) or None
    n_pipe = int(getattr(hp, "MESH_PIPE", 1) or 1)
    n_expert = int(getattr(hp, "MESH_EXPERT", 1) or 1)
    n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
    devices = list(devices) if devices is not None else _world_ranks()
    if mesh_factors(hp) > 1:
        return make_mesh(n_data, n_model, devices,
                         n_pipe=n_pipe, n_expert=n_expert, n_seq=n_seq)
    batch = getattr(hp, "BATCH_SIZE", len(devices))
    # largest rank count that divides the batch (gcd would under-use: 8
    # ranks, batch 12 -> 6, not 4)
    n_data = max(k for k in range(1, len(devices) + 1) if batch % k == 0)
    return make_mesh(n_data, 1, devices=devices[:n_data])


# ---------------------------------------------------------------------------
# the active mesh: model code reaches the trainer's mesh through it
# ---------------------------------------------------------------------------

_ACTIVE_MESH: Optional[Mesh] = None


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    """Register the mesh model code should route on (the Trainer calls
    this with its mesh at construction)."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def registered_mesh() -> Optional[Mesh]:
    """The mesh the Trainer registered, or None."""
    return _ACTIVE_MESH


def active_mesh(hp=None) -> Mesh:
    """The registered mesh, or one derived from ``hp`` (the port's
    hparams by default), not connected."""
    if _ACTIVE_MESH is not None:
        return _ACTIVE_MESH
    if hp is None:
        from danet_tpu_torch.hparams import hparams as hp
    return mesh_from_hparams(hp)


# ---------------------------------------------------------------------------
# parameter partition rules
# ---------------------------------------------------------------------------

def _leaf_spec(path: str, leaf, n_model: int = 1, n_expert: int = 1) -> tuple:
    """The partition spec of one parameter leaf, by name and rank, as a
    tuple (JAX's ``PartitionSpec`` entries): a dimension is sharded only
    when the axis size divides it, else the leaf is replicated (hdim=300 on
    an 8-way 'model' axis).  On a mesh with an 'expert' axis the MoE
    expert weights shard one group per rank along their expert dim."""
    ndim = len(getattr(leaf, "shape", ()))
    shape = tuple(getattr(leaf, "shape", ()))
    last = path.split("/")[-1]

    def ok(dim_idx):
        return n_model <= 1 or shape[dim_idx] % n_model == 0

    def ok_e(dim_idx):
        return n_expert > 1 and shape[dim_idx] % n_expert == 0

    if last in ("wx", "wh", "wgx", "wgh") and ndim == 3 and ok(2):
        return (None, None, "model")              # gates [in, G, h]
    if last in ("b", "bg") and ndim == 2 and ok(1):
        return (None, "model")                    # gate bias [G, h]
    if last == "router" and ndim == 2 and ok_e(1):
        return (None, "expert")                   # MoE router [d, E]
    if last in ("w", "wcx", "wch") and ndim == 2 and ok(1):
        return (None, "model")                    # linear [in, out]
    if last == "w_in" and ndim == 3:
        if ok_e(0):
            return ("expert", None, "model" if ok(2) else None)
        if ok(2):
            return (None, None, "model")          # col-par fallback
    if last == "w_out" and ndim == 3:
        if ok_e(0):
            return ("expert", "model" if ok(1) else None, None)
        if ok(1):
            return (None, "model", None)          # row-par fallback
    if last in ("b", "bc") and ndim == 1 and ok(0):
        return ("model",)                         # linear bias [out]
    return ()  # replicated


def nest(names: list, values: list) -> dict:
    """The tree of '/'-joined leaf ``names`` and their ``values``."""
    out: dict = {}
    for name, v in zip(names, values):
        node = out
        *parents, last = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def param_pspecs(params, mesh: Optional[Mesh] = None) -> dict:
    """The spec tree of a parameter tree; with a mesh, dims its 'model'
    axis does not divide are replicated."""
    n_model = mesh.shape.get("model", 1) if mesh is not None else 1
    n_expert = mesh.shape.get("expert", 1) if mesh is not None else 1
    names = leaf_names(params)
    return nest(names, [_leaf_spec(n, leaf, n_model, n_expert)
                         for n, leaf in zip(names, leaves(params))])


def model_axes(params, mesh: Mesh) -> list:
    """Per leaf of ``leaves(params)`` (full shapes): the dimension sharded
    on 'model', or None (replicated; always None on a 1-wide 'model'
    axis)."""
    return [a.get("model") for a in shard_axes(params, mesh)]


def shard_axes(params, mesh: Mesh) -> list:
    """Per leaf of ``leaves(params)`` (full shapes): {axis: dimension} of
    the mesh axes wider than 1 that shard it ('model' and / or 'expert';
    {} for a replicated leaf)."""
    return [{a: d for d, a in enumerate(spec)
             if a is not None and mesh.shape.get(a, 1) > 1}
            for spec in leaves(param_pspecs(params, mesh))]


# the leaves of a pipeline's stages: bilstm-orig's layers, which JAX hands
# to the pipelined stack (danet_tpu/models/encoders.py::_apply_pipelined)
_PIPE_LEAF = re.compile(r"^encoder/lstm\d+/")


def leaf_owners(params, mesh: Mesh, model) -> list:
    """Per leaf of ``leaves(params)``: the axis whose ranks each compute a
    disjoint part of its gradient ('expert' for a leaf sharded on it,
    whose expert group only its owner runs; 'pipe' for a pipeline stage's
    layers, replicated at rest, which only their stage runs; 'seq' for a
    leaf that a sequence-parallel ``model`` differentiates from each
    rank's T-chunk alone, ``model.seq_leaves()``: a pattern of the names,
    the recurrent stacks' layers, tcn-v1's and dprnn-v1's bottleneck and
    blocks, all of conv-bilstm-v1's encoder, all of tasnet-v1), or None
    (every rank that shares the rows computes it alike: the rest of a
    sequence-parallel model runs whole on every rank of its 'seq' group).
    A wrong owner scales the leaf's gradient by the axis' size.
    ``collectives.reduce_grads`` scales by it."""
    pipe = mesh.shape.get("pipe", 1) > 1
    pattern = model.seq_leaves() if mesh.shape.get("seq", 1) > 1 else None
    seq_leaf = None if pattern is None else re.compile(pattern)
    return ["expert" if "expert" in spec
            else "pipe" if pipe and _PIPE_LEAF.match(name)
            else "seq" if seq_leaf is not None and seq_leaf.match(name)
            else None
            for name, spec in zip(leaf_names(params),
                                  shard_axes(params, mesh))]


def axes_of(axes) -> dict:
    """{axis: dimension} of a leaf's sharding given as None (replicated),
    an int (a 'model' dimension: ``model_axes``) or such a dict
    (``shard_axes``)."""
    if axes is None:
        return {}
    if isinstance(axes, int):
        return {"model": axes}
    return dict(axes)


def shard_leaf(x, axes, mesh: Mesh):
    """This rank's slice of a full leaf (a tensor or an array): ``axes``
    None (the leaf itself), a 'model' dimension, or {axis: dimension}."""
    for axis, dim in axes_of(axes).items():
        n = mesh.shape[axis]
        size = x.shape[dim] // n
        m = mesh.coords[axis]
        if isinstance(x, torch.Tensor):
            x = x.narrow(dim, m * size, size).contiguous()
        else:
            x = np.ascontiguousarray(np.take(
                x, np.arange(m * size, (m + 1) * size), axis=dim))
    return x


def shard_params(mesh: Mesh, params: dict) -> dict:
    """This rank's slices of a full parameter tree (clones of the sharded
    leaves, the replicated leaves as they are)."""
    axes = shard_axes(params, mesh)
    return nest(leaf_names(params),
                [shard_leaf(x, a, mesh) for x, a in zip(leaves(params),
                                                        axes)])


def gather_params(mesh: Mesh, shards: dict, axes: list) -> dict:
    """The inverse of ``shard_params``: the full tree, its sharded leaves
    all-gathered over their axes' groups (``axes`` from ``shard_axes``
    or ``model_axes`` of the full tree).  Collective: every rank of the
    mesh calls it."""
    from danet_tpu_torch.parallel import collectives
    full = collectives.gather_leaves(mesh, leaves(shards), axes)
    return nest(leaf_names(shards), full)


# ---------------------------------------------------------------------------
# the batch's rows
# ---------------------------------------------------------------------------

def batch_slices(mesh: Mesh, batch: int) -> int:
    """How many row slices a batch of ``batch`` rows splits into:
    n_data * n_model when it divides the batch (each rank its own rows,
    the kernels per rank), else n_data (a 'model' group shares its data
    shard's rows)."""
    n_data = mesh.shape.get("data", 1)
    n_all = n_data * mesh.shape.get("model", 1)
    if batch % n_all == 0:
        return n_all
    if batch % n_data == 0:
        return n_data
    raise ValueError("batch %d must divide over MESH_DATA=%d ranks"
                     % (batch, n_data))


def row_index(mesh: Mesh, batch: int) -> int:
    """The index of this rank's row slice of a batch of ``batch`` rows."""
    c = mesh.coords
    if batch_slices(mesh, batch) == mesh.shape.get("data", 1):
        return c["data"]
    return c["data"] * mesh.shape.get("model", 1) + c["model"]


def row_slices(mesh: Mesh) -> int:
    """How many row slices the trainer's batches split into
    (``Mesh.row_axes``, which the Trainer sets from BATCH_SIZE)."""
    n = 1
    for a in mesh.row_axes:
        n *= mesh.shape.get(a, 1)
    return n


def row_slice_of(mesh: Mesh, rank: int) -> int:
    """The row slice of ``rank`` of the mesh (over ``Mesh.row_axes``, in
    ``row_index``'s order)."""
    where = np.argwhere(mesh.devices == rank)[0]
    c = dict(zip(mesh.axis_names, (int(i) for i in where)))
    g = 0
    for a in mesh.row_axes:
        g = g * mesh.shape.get(a, 1) + c.get(a, 0)
    return g


def batch_rows(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a global batch of ``batch`` rows."""
    per = batch // batch_slices(mesh, batch)
    g = row_index(mesh, batch)
    return slice(g * per, (g + 1) * per)
