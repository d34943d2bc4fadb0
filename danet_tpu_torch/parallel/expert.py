"""The mixture-of-experts MLP of ``moe-v1``: its single-device forms and
expert parallelism.

Counterpart of ``danet_tpu/parallel/expert.py``:

* ``moe_mlp`` (soft mixture, MOE_TOP_K 0): every token goes through every
  expert, and a softmax over the router's logits weights the sum;
* ``moe_mlp_topk`` (MOE_TOP_K >= 1, training): GShard's dispatch with a
  capacity of C = ceil(k N / E x MOE_CAPACITY_FACTOR) slots per expert
  (``_capacity``) over the N = B T tokens in b-major order;
  ``_topk_dispatch`` builds the [N, E, C] dispatch and combine tensors,
  ``_routed_ffn`` runs the experts on their packed [E, C, d] inputs;
* ``moe_mlp_topk_dropless`` (MOE_TOP_K >= 1, inference): every token
  reaches its k experts, gated as in ``_topk_dispatch``, so that where
  nothing drops the two agree;
* ``moe_mlp_ep`` (MESH_EXPERT > 1, soft): each rank of an 'expert' group
  runs its E/n experts on every token of its rows; the softmax's
  normalizer comes from the logits gathered over the group, each rank's
  partial mixture is summed in float32, cast to the compute dtype, and the
  partials are summed over the group (JAX's order: in bfloat16 it is not
  ``moe_mlp``'s);
* ``moe_mlp_ep_routed`` (MESH_EXPERT > 1, top-k training): the frames
  split over the group (T must divide), each rank routes its rows' tokens
  of its T / n frames, one all-to-all sends each expert group's [E/n, C,
  d] packets to its owner, the experts run there, and a second all-to-all
  brings the outputs back.

Capacity is a count over the global batch.  JAX's ``shard_map`` of the
routed form does not name 'data', so each T-shard routes the global
batch's rows (C from B_global T / n tokens), and under GSPMD
``moe_mlp_topk`` on a data x model mesh routes the global batch.  The
port's rows are split over the row slices of the mesh
(``sharding.row_slices``): each rank all-gathers the [k, E] counts of its
tokens' top-k choices over the mesh (``_global_counts``), so that its slot
positions start after the tokens of the row slices before it, slot by
slot, and the capacity each slot leaves counts every slice's tokens.  The
tokens themselves do not move across row slices: each rank runs the
experts on its packets, zero rows elsewhere (an expert maps a zero row to
a zero row), and combines its own tokens.

On a mesh the trainer gathers the full weights once per step (JAX's
functions take the global parameters too): the EP forms take each rank's
expert group out of them, and the gradients of the other groups are zero
there, which the trainer's reduction over 'expert' completes
(``sharding.leaf_owners``).  The collectives are ``parallel/
collectives.py``'s autograd forms: the input ``enter``s the group, the
soft form's logits are ``all_gather_parts``ed, the packets
``all_to_all``ed, and the output leaves by ``leave_sum`` or
``leave_gather``.

Routing is in float32 (float64 for float64 inputs): gate logits, softmax,
top-k, renormalised gates.  The top k are taken by a stable descending
sort (``_top_k``), so that ties go to the lower expert index, as
``jax.lax.top_k`` breaks them, on every device (``torch.topk`` leaves
their order unspecified on CUDA).  The one-hots of the dispatch are
comparisons with an index range, which give a zero row for a slot at or
past the capacity as ``jax.nn.one_hot`` does (``torch.nn.functional.
one_hot`` raises there, and reads its labels on the host).  The dispatch
and the one-hot factor of the combine carry no gradient; the gates do.
The expert FFN is the tanh GELU between two ``nn.ee`` products in the
compute dtype; every product is a cuBLAS call, as XLA's are in the JAX
package (no Pallas kernel).  Nothing here has a shape that depends on the
data, and nothing reads a value on the host, so a train step through it
is captured in a CUDA graph.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from danet_tpu_torch.ops import nn
from danet_tpu_torch.parallel import collectives, sharding


def _ee_acc(subscripts: str, a: torch.Tensor, b: torch.Tensor):
    """Einsum with float32 accumulation (float64 for float64 operands),
    the result left in that dtype (JAX's ``preferred_element_type``)."""
    dt = nn.acc_dtype(a, b)
    return torch.einsum(subscripts, a.to(dt), b.to(dt))


def _experts(params, x):
    """Every expert on every token: x [B, T, d] -> [E, B, T, d]."""
    hid = nn.gelu(nn.ee("btd,edh->ebth", x, params["w_in"].to(x.dtype)))
    return nn.ee("ebth,ehd->ebtd", hid, params["w_out"].to(x.dtype))


def _gate_probs(params, x):
    """The router's softmax over experts, [..., E], in the routing dtype."""
    return torch.softmax(_ee_acc("...d,de->...e", x,
                                 params["router"].to(x.dtype)), dim=-1)


def _top_k(probs, k: int):
    """The k largest of the last axis, largest first, ties to the lower
    index: (values, indices)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx, n: int, dtype):
    """[..., n]: 1 where the last axis equals ``idx``; a zero row where
    ``idx`` is outside [0, n)."""
    return (idx[..., None] == torch.arange(
        n, device=idx.device, dtype=idx.dtype)).to(dtype)


def moe_mlp(params, x):
    """Soft mixture: params router [d, E], w_in [E, d, ff], w_out [E, ff,
    d]; x [B, T, d] -> [B, T, d].  The gated sum in float32, cast back."""
    gate = _gate_probs(params, x)
    y = _experts(params, x)
    return _ee_acc("ebtd,bte->btd", y, gate.to(y.dtype)).to(x.dtype)


def moe_mlp_topk_dropless(params, x, k: int = 2):
    """Top-k routing without capacity (inference): each token's k experts
    weighted by their softmax probabilities renormalised to sum 1; x [B,
    T, d] -> [B, T, d]."""
    probs = _gate_probs(params, x)
    gvals, gidx = _top_k(probs, k)                          # [B, T, k]
    gvals = gvals / (torch.sum(gvals, dim=-1, keepdim=True) + 1e-9)
    n_exp = params["w_in"].shape[0]
    gates = torch.sum(_one_hot(gidx, n_exp, gvals.dtype)
                      * gvals[..., None], dim=2)            # [B, T, E]
    y = _experts(params, x)
    return _ee_acc("ebtd,bte->btd", y, gates.to(y.dtype)).to(x.dtype)


def _capacity(n_tokens: int, n_experts: int, k: int,
              capacity_factor: float) -> int:
    """Slots per expert: ceil(k N / E x factor), at least 1 and at most N
    (slots past N could never be taken)."""
    cap = max(1, int(math.ceil(k * n_tokens / n_experts
                               * capacity_factor)))
    return min(cap, n_tokens)


def _topk_dispatch(logits, k: int, cap: int, counts=None):
    """GShard's dispatch and combine tensors from router logits [N, E]:
    (dispatch [N, E, C] of 0/1, combine [N, E, C] gated).  Token n takes
    slot c of expert e when it is among the first C tokens routed to e,
    claimed in token order, earlier top-k slots first; the gates are the
    kept top-k probabilities renormalised to sum 1 (before the drops).
    ``counts``: a function of this rank's [k, E] choice counts -> (the
    counts of the tokens before these, the counts of all tokens), both
    [k, E], when these N tokens are one slice of the routed set
    (``_global_counts``)."""
    n, e = logits.shape
    probs = torch.softmax(logits.to(nn.acc_dtype(logits)), dim=-1)
    gvals, gidx = _top_k(probs, k)                          # [N, k]
    gvals = gvals / (torch.sum(gvals, dim=-1, keepdim=True) + 1e-9)
    dispatch = torch.zeros((n, e, cap), dtype=probs.dtype,
                           device=logits.device)
    combine = torch.zeros_like(dispatch)
    taken = torch.zeros((e,), dtype=probs.dtype, device=logits.device)
    slots = torch.arange(cap, device=logits.device, dtype=probs.dtype)
    ohs = [_one_hot(gidx[:, s], e, probs.dtype) for s in range(k)]
    if counts is not None:
        before, total = counts(torch.stack([torch.sum(oh, dim=0)
                                            for oh in ohs]))
    for s, oh in enumerate(ohs):                            # oh [N, E]
        pos = torch.cumsum(oh, dim=0) - oh + taken[None, :]
        if counts is not None:
            pos = pos + before[s][None, :]
        keep = (pos < cap).to(probs.dtype) * oh
        slot = (pos[..., None] == slots).to(probs.dtype)    # [N, E, C]
        d_s = keep[..., None] * slot
        dispatch = dispatch + d_s
        combine = combine + d_s.detach() * gvals[:, s][:, None, None]
        if counts is None:
            taken = taken + torch.sum(keep, dim=0)
        else:       # the slot's kept tokens over every slice
            taken = taken + torch.minimum(
                torch.clamp(cap - taken, min=0.0), total[s])
    return dispatch.detach(), combine


def _count_weights(mesh, axis) -> np.ndarray:
    """[2, size]: per rank of the mesh (its group's order), whether its
    counts are of a row slice before this rank's (row 0) and of any row
    slice (row 1), among the ranks at this rank's ``axis`` coordinate (all
    ranks for None), one rank per row slice."""
    ranks = sorted(int(r) for r in mesh.devices.flat)
    mine = sharding.row_slice_of(mesh, mesh.rank)
    w = np.zeros((2, len(ranks)), np.float32)
    seen = set()
    for j, r in enumerate(ranks):
        if axis is not None:
            where = np.argwhere(mesh.devices == r)[0]
            if int(where[mesh.axis_names.index(axis)]) != \
                    mesh.coords[axis]:
                continue
        g = sharding.row_slice_of(mesh, r)
        if g in seen:
            continue
        seen.add(g)
        w[1, j] = 1.0
        w[0, j] = float(g < mine)
    return w


def _global_counts(mesh, axis=None):
    """The ``counts`` of ``_topk_dispatch`` for a rank whose tokens are
    its row slice of a set routed together (the ranks at its ``axis``
    coordinate; all ranks for None): the [k, E] counts all-gathered over
    the mesh and summed over the row slices before this rank's, and over
    all of them."""
    def counts(local):
        w = nn.device_constant(
            ("moe-count-weights", mesh.rank, mesh.devices.tobytes(),
             mesh.devices.shape, mesh.row_axes, axis),
            lambda: _count_weights(mesh, axis), local.device, local.dtype)
        every = collectives.all_gather(mesh, local, None)    # [size, k, E]
        both = torch.einsum("wr,rke->wke", w, every)
        return both[0], both[1]
    return counts


def _routed_ffn(p_in, p_out, expert_in, dtype):
    """The experts on packed inputs [E, C, d] -> [E, C, d] in ``dtype``."""
    hid = nn.gelu(nn.ee("ecd,edh->ech", expert_in.to(dtype),
                        p_in.to(dtype)))
    return nn.ee("ech,ehd->ecd", hid, p_out.to(dtype))


def moe_mlp_topk(params, x, k: int = 2, capacity_factor: float = 1.25,
                 mesh=None):
    """Top-k routing with capacity (training): x [B, T, d] -> [B, T, d].
    Tokens past an expert's capacity get nothing from it.  ``mesh``: x is
    this rank's row slice of the global batch (``sharding.row_slices``),
    whose tokens are routed together (the capacity and the slot order of
    the global batch, ``_global_counts``)."""
    b, t, d = x.shape
    n_exp = params["w_in"].shape[0]
    xf = x.reshape(b * t, d)                # b-major token order
    logits = _ee_acc("nd,de->ne", xf, params["router"].to(x.dtype))
    slices = sharding.row_slices(mesh) if mesh is not None else 1
    cap = _capacity(b * slices * t, n_exp, k, capacity_factor)
    extra = {"counts": _global_counts(mesh)} if slices > 1 else {}
    dispatch, combine = _topk_dispatch(logits, k, cap, **extra)
    acc = nn.acc_dtype(x)
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(acc), xf.to(acc))
    y = _routed_ffn(params["w_in"], params["w_out"], expert_in, x.dtype)
    out = _ee_acc("nec,ecd->nd", combine, y.to(acc))
    return out.to(x.dtype).reshape(b, t, d)


def _group(params, mesh, axis: str) -> slice:
    """This rank's slice of the experts of ``params``."""
    n_dev = mesh.shape[axis]
    n_exp = params["w_in"].shape[0]
    if n_exp % n_dev:
        raise AssertionError("experts must divide across the axis")
    per = n_exp // n_dev
    e = mesh.coords[axis]
    return slice(e * per, (e + 1) * per)


def moe_mlp_ep(params, x, mesh, expert_axis: str = "expert"):
    """The soft mixture with the experts split over ``expert_axis``
    (module docstring): params the full weights (router [d, E], w_in [E,
    d, ff], w_out [E, ff, d]), x [B, T, d] this rank's rows, the same on
    every rank of its group -> [B, T, d], the same there.  Collective over
    the group."""
    sl = _group(params, mesh, expert_axis)
    x = collectives.enter(mesh, x, expert_axis)
    dt = x.dtype
    logits_local = _ee_acc("btd,de->bte", x, params["router"][:, sl].to(dt))
    logits = collectives.all_gather_parts(mesh, logits_local, expert_axis, 2)
    gate_local = torch.softmax(logits, dim=-1)[..., sl]
    hid = nn.gelu(nn.ee("btd,edh->ebth", x, params["w_in"][sl].to(dt)))
    y = nn.ee("ebth,ehd->ebtd", hid, params["w_out"][sl].to(dt))
    part = _ee_acc("ebtd,bte->btd", y, gate_local.to(y.dtype)).to(dt)
    return collectives.leave_sum(mesh, part, expert_axis)


def moe_mlp_ep_routed(params, x, mesh, k: int = 2,
                      capacity_factor: float = 1.25,
                      expert_axis: str = "expert"):
    """Top-k routing with capacity, the frames and the experts split over
    ``expert_axis`` (module docstring): params the full weights, x [B, T,
    d] this rank's rows, the same on every rank of its group (T divisible
    by the group's size) -> [B, T, d], the same there.  Each T-shard
    routes the global batch's rows of its frames (``_global_counts`` over
    the row slices).  Collective over the mesh."""
    n_dev = mesh.shape[expert_axis]
    sl = _group(params, mesh, expert_axis)
    b, t, d = x.shape
    if t % n_dev:
        raise AssertionError("T must divide across the expert axis")
    n_exp = params["w_in"].shape[0]
    t_loc = t // n_dev
    e = mesh.coords[expert_axis]
    x = collectives.enter(mesh, x, expert_axis)
    xf = x[:, e * t_loc:(e + 1) * t_loc].reshape(b * t_loc, d)
    logits = _ee_acc("nd,de->ne", xf, params["router"].to(x.dtype))
    slices = sharding.row_slices(mesh)
    cap = _capacity(b * slices * t_loc, n_exp, k, capacity_factor)
    extra = ({"counts": _global_counts(mesh, expert_axis)} if slices > 1
             else {})
    dispatch, combine = _topk_dispatch(logits, k, cap, **extra)
    acc = nn.acc_dtype(x)
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(acc), xf.to(acc))
    # [E, C, d] -> this rank's experts with every shard's C slots
    recv = collectives.all_to_all(mesh, expert_in, expert_axis, 0, 1)
    y = _routed_ffn(params["w_in"][sl], params["w_out"][sl], recv, x.dtype)
    # [per, n C, d] -> [E, C, d] in the dispatching shard's layout
    y = collectives.all_to_all(mesh, y.to(acc), expert_axis, 1, 0)
    out = _ee_acc("nec,ecd->nd", combine, y)
    out = out.to(x.dtype).reshape(b, t_loc, d)
    return collectives.leave_gather(mesh, out, expert_axis, 1)
