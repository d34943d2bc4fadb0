"""Sequence parallelism of the recurrent stacks: the exact boundary-state
relay and the halo warm-up, over the mesh's 'seq' axis.

Counterpart of ``danet_tpu/parallel/seq_parallel.py:48-245,352-441``
(``bilstm_stack_sp``, ``gru_stack_sp`` and their layers).  The T axis of
a rank's rows splits into S chunks, one per rank of its 'seq' group (the
ranks share the rows); a stack takes the rows' whole input, enters this
rank's chunk (``collectives.enter_sharded``: the backward gathers the
input's cotangent) and returns this rank's chunk of the output, [B, T / S,
.], which the caller gathers (``collectives.leave_gather``).  SP_RNN_SCHEME
picks the scheme:

* ``relay`` (the default, exact): a direction's state flows through the
  ring one hop at a time.  Rank r waits for the final (c, h) of rank r - 1
  (r + 1 for the reversed direction), scans its chunk from it, and sends
  its own final state on; rank 0 (S - 1) starts from zeros.  The outputs
  are the dense scan's.  As in JAX, a layer runs in S rounds, and after
  each round but the last every rank swaps states with both its
  neighbours, the same exchange on every rank (``_Plan.swap``: one batch
  of point-to-point sends and receives, zeros where a rank has no state
  to pass).  JAX scans every rank's chunk in every round and keeps, per
  rank, the round whose incoming state is true (its ``where(idx ==
  round)``), the only form ``shard_map`` can express; here each rank
  scans only in that round, so the S - 1 rounds JAX discards are never
  computed, as the pipeline (``pipeline.py``) runs no bubble tick.  In
  round k rank k scans the forward direction and rank S - 1 - k the
  reversed one, so that both rings are busy and a layer takes S chunk
  scans of serial depth, the dense scan's T steps.  ``_Relay`` is one autograd Function
  per layer: its backward runs the same rounds in reverse, each rank
  seeding its chunk's backward with the cotangent of its final state,
  received from where that state went, and passing back the cotangent of
  its initial state.  Every chunk scan runs on the hand kernels: the
  saving forward's state entry and kernel 3 seeded with the final cell
  state's cotangent (``ops/cuda/lstm.py``), one launch of each per
  direction, layer and step on every rank (kernel 4f / 4b for the GRU, its
  carry a row of cs).  The relay buys memory: each rank holds 1 / S of the
  stack's activations, at the dense scan's serial depth.
* ``halo`` (approximate): every rank warms its state up on the last
  ``halo`` frames of its left neighbour's chunk (the first of its right
  neighbour's, for the reversed direction; ``collectives.shift_from_left``
  / ``shift_from_right``), starting from zeros, then scans its own chunk
  from that state.  The ring's edge ranks zero the warmed state (their
  true initial state is zero), multiplying it by zero as JAX does, so that
  their warm-up stays in the graph and the shifts' adjoints run on every
  rank.  Exact at S = 2 with halo = T / 2; elsewhere the error decays with
  the halo.

``data_axis``: when the mesh has that axis wider than 1 and it divides the
batch (``_mesh_data_axis``), the stack takes this rank's rows of ``x`` as
well (JAX's batch co-sharding); the encoders pass None, because the
trainer has already split the batch.  Dropout (``dropout_rng``,
``keep_prob``): after every layer, its mask drawn whole, [B, T, .], from
the generator the ranks of a 'seq' group share, and this rank's chunk
kept: the dense stack's masks, where JAX folds the device's coordinates
into its keys.  ``remat``: the relay keeps only each direction's input and
incoming state and recomputes the chunk scan in the backward (the lean
state entry forward, then the saving one); the halo scheme runs each
layer under ``torch.utils.checkpoint``, whose recompute replays its
shifts on every rank in the same order.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from danet_tpu_torch.ops import nn, rnn
from danet_tpu_torch.ops.nn import acc_dtype
from danet_tpu_torch.parallel import collectives
from danet_tpu_torch.parallel.sharding import nest
from danet_tpu_torch.weights import leaf_names, leaves


def _mesh_data_axis(mesh, batch: int, data_axis):
    """``data_axis`` when the mesh carries it wider than 1 and the batch
    divides over it, else None."""
    if data_axis and mesh.shape.get(data_axis, 1) > 1 \
            and batch % mesh.shape[data_axis] == 0:
        return data_axis
    return None


def _maybe_ckpt(fn, remat: bool):
    """``fn`` under a non-reentrant ``torch.utils.checkpoint`` with REMAT
    while autograd records (its collectives replay in the recompute)."""
    if not remat:
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return run


def _check(x, mesh, seq_axis: str, halo: int, scheme: str) -> None:
    """JAX's checks of a stack's arguments, in its words."""
    s = mesh.shape[seq_axis]
    assert x.shape[1] % s == 0, "T must divide across the seq axis"
    if scheme == "halo":
        assert halo >= 1, "halo must be >= 1 (x[:, -halo:] with halo=0 " \
            "would select the whole chunk, not an empty one)"
        assert x.shape[1] // s >= halo, "chunk must be >= halo"
    elif scheme != "relay":
        raise ValueError("unknown SP_RNN_SCHEME %r" % (scheme,))


def _enter(mesh, x, seq_axis: str, d_axis):
    """This rank's (rows, chunk) block of ``x``."""
    if d_axis is not None:
        x = collectives.enter_sharded(mesh, x, d_axis, 0)
    return collectives.enter_sharded(mesh, x, seq_axis, 1)


# ---------------------------------------------------------------------------
# the relay
# ---------------------------------------------------------------------------

class _Direction:
    """One scan direction of a relay layer: its parameters' leaf names
    and count, whether its state flows right to left (``reverse``), and
    ``run(params, x, state) -> (y, final state)``."""

    def __init__(self, names, count, reverse, run):
        self.names, self.count = names, count
        self.reverse, self.run = reverse, run


def _lstm_direction(p: dict, act: str, reverse: bool) -> _Direction:
    def run(pp, x, state):
        y, (c, h) = rnn.lstm_apply(pp, x, act, reverse=reverse, c0=state[0],
                                   h0=state[1], return_state=True)
        return y, (c, h)
    return _Direction(leaf_names(p), len(leaves(p)), reverse, run)


def _gru_direction(p: dict) -> _Direction:
    def run(pp, x, state):
        y, c = rnn.gru_apply(pp, x, c0=state[0], return_state=True)
        return y, (c,)
    return _Direction(leaf_names(p), len(leaves(p)), False, run)


class _Plan:
    """One relay layer on one rank: the mesh, the axis, the directions,
    the state's shapes and dtypes, REMAT."""

    def __init__(self, mesh, axis, dirs, state_like, remat):
        self.mesh, self.axis, self.dirs = mesh, axis, dirs
        self.state_like = state_like      # [(shape, dtype)] of the state
        self.remat = remat
        self.n, self.c = mesh.shape[axis], mesh.coords[axis]

    def round_of(self, i: int, backward: bool = False) -> int:
        """The round in which this rank scans direction i: the one in which
        the state reaches it (forward), or the cotangent of its final state
        (backward, the hops reversed)."""
        k = self.n - 1 - self.c if self.dirs[i].reverse else self.c
        return self.n - 1 - k if backward else k

    def prev(self, i: int):
        """The coordinate direction i's state comes from (None: the edge,
        which starts from zeros)."""
        p = self.c + (1 if self.dirs[i].reverse else -1)
        return p if 0 <= p < self.n else None

    def next(self, i: int):
        """The coordinate direction i's final state goes to (None: the
        edge)."""
        q = self.c + (-1 if self.dirs[i].reverse else 1)
        return q if 0 <= q < self.n else None

    # a state travels as one message in the carry's dtype
    def pack(self, state) -> torch.Tensor:
        wide = self.state_like[0][1]
        return torch.cat([v.detach().to(wide) for v in state], dim=-1)

    def unpack(self, msg: torch.Tensor) -> tuple:
        out, at = [], 0
        for shape, dtype in self.state_like:
            out.append(msg[..., at:at + shape[-1]].to(dtype).contiguous())
            at += shape[-1]
        return tuple(out)

    def zeros(self, device) -> tuple:
        return tuple(torch.zeros(s, dtype=d, device=device)
                     for s, d in self.state_like)

    def swap(self, payloads: list, backward: bool, device) -> list:
        """One round's exchange, the same on every rank of the group: per
        direction, ``payloads[i]`` (a state, or None: zeros) sent on along
        the direction's flow (against it when ``backward``) and the
        neighbour's received from the other side.  -> per direction the
        received state (zeros at the edge)."""
        sends, recvs, which = [], [], []
        for i in range(len(self.dirs)):
            to, frm = self.next(i), self.prev(i)
            if backward:
                to, frm = frm, to
            payload = payloads[i] if payloads[i] is not None \
                else self.zeros(device)
            if to is not None:
                sends.append((self.pack(payload), to))
            if frm is not None:
                recvs.append((self.pack(self.zeros(device)), frm))
                which.append(i)
        got = collectives.exchange(self.mesh, self.axis, sends, recvs)
        out = [self.zeros(device) for _ in self.dirs]
        for i, msg in zip(which, got):
            out[i] = self.unpack(msg)
        return out


def _split(params: list, dirs: list) -> list:
    """The flat leaves of the directions, one tree per direction."""
    out, at = [], 0
    for d in dirs:
        out.append(nest(d.names, params[at:at + d.count]))
        at += d.count
    return out


def _relay_forward(plan: _Plan, trees: list, x, grad: bool):
    """The relay's S rounds: in round k this rank scans the directions
    whose state reached it in round k - 1 (its ``round_of``), and every
    rank then exchanges with its neighbours (no exchange after the last
    round).  -> (outputs, per direction (incoming state, (y, final
    state))), the scans recorded under autograd when ``grad``."""
    n_dirs = len(plan.dirs)
    outs, record = [None] * n_dirs, [None] * n_dirs
    states = [plan.zeros(x.device) for _ in range(n_dirs)]
    for k in range(plan.n):
        ends = [None] * n_dirs
        for i in range(n_dirs):
            if plan.round_of(i) != k:
                continue
            state = states[i]
            if grad and plan.prev(i) is not None:
                state = tuple(v.requires_grad_(True) for v in state)
            with torch.set_grad_enabled(grad):
                y, end = plan.dirs[i].run(trees[i], x, state)
            record[i] = (state, (y, end))
            outs[i], ends[i] = y, end
        if k < plan.n - 1:
            got = plan.swap(ends, False, x.device)
            for i in range(n_dirs):
                if plan.round_of(i) == k + 1:
                    states[i] = got[i]
    return outs, record


class _Relay(torch.autograd.Function):
    """One relay layer under autograd (the module's docstring): inputs the
    plan, this rank's chunk x, then every direction's leaves in order;
    output the directions' outputs concatenated on the last axis."""

    @staticmethod
    def forward(ctx, plan, x, *ps):
        params = [p.detach().requires_grad_(p.requires_grad) for p in ps]
        trees = _split(params, plan.dirs)
        xin = x.detach().requires_grad_(x.requires_grad)
        outs, record = _relay_forward(plan, trees, xin, not plan.remat)
        if plan.remat:             # keep each direction's incoming state
            record = [(state, None) for state, _ in record]
        ctx.plan, ctx.params, ctx.trees, ctx.xin = plan, params, trees, xin
        ctx.record = record
        return torch.cat([y.detach() for y in outs], dim=-1)

    @staticmethod
    def backward(ctx, dy):
        plan, params, trees, xin = ctx.plan, ctx.params, ctx.trees, ctx.xin
        n_dirs = len(plan.dirs)
        offs = [0]
        for d in plan.dirs:
            offs.append(offs[-1] + d.count)
        record = list(ctx.record)
        for i, (state, kept) in enumerate(record):
            if kept is None:                 # REMAT: the chunk scan again
                if plan.prev(i) is not None:
                    state = tuple(v.requires_grad_(True) for v in state)
                with torch.enable_grad():
                    record[i] = (state, plan.dirs[i].run(trees[i], xin,
                                                         state))
        dys = torch.split(dy, [kept[0].shape[-1] for _, kept in record],
                          dim=-1)
        grads = [None] * len(params)
        dx = None
        # the cotangent of a final state, from where the state was sent
        d_ends = [plan.zeros(dy.device) for _ in range(n_dirs)]
        for k in range(plan.n):
            d_states = [None] * n_dirs
            for i in range(n_dirs):
                if plan.round_of(i, backward=True) != k:
                    continue
                state, (y, end) = record[i]
                has_next = plan.next(i) is not None
                has_prev = plan.prev(i) is not None
                live = [j for j in range(offs[i], offs[i + 1])
                        if params[j].requires_grad]
                want = ([xin] if xin.requires_grad else []) \
                    + (list(state) if has_prev else []) \
                    + [params[j] for j in live]
                got = list(torch.autograd.grad(
                    [y] + (list(end) if has_next else []), want,
                    [dys[i]] + (list(d_ends[i]) if has_next else []),
                    allow_unused=True))
                if xin.requires_grad:
                    g = got.pop(0)
                    if g is not None:
                        dx = g if dx is None else dx + g
                if has_prev:
                    d_states[i] = [torch.zeros_like(v) if g is None else g
                                   for v, g in zip(state, got[:len(state)])]
                    got = got[len(state):]
                for j, g in zip(live, got):
                    if g is not None:
                        grads[j] = g if grads[j] is None else grads[j] + g
            if k < plan.n - 1:
                got = plan.swap(d_states, True, dy.device)
                for i in range(n_dirs):
                    if plan.round_of(i, backward=True) == k + 1:
                        d_ends[i] = got[i]
        ctx.record = ctx.params = ctx.trees = ctx.xin = None
        return (None, dx) + tuple(grads)


def _relay_layer(mesh, axis, dirs, state_like, x, ps, remat):
    plan = _Plan(mesh, axis, dirs, state_like, remat)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in ps)):
        return _Relay.apply(plan, x, *ps)
    outs, _ = _relay_forward(plan, _split(list(ps), dirs), x, False)
    return torch.cat(outs, dim=-1)


def _bilstm_layer_relay(p: dict, x_loc, mesh, seq_axis: str, act: str,
                        remat: bool = False):
    """One exact sequence-parallel BiLSTM layer on this rank's chunk [B,
    C, F] -> [B, C, 2H] (JAX ``_bilstm_layer_relay``)."""
    hdim = p["fwd"]["wh"].shape[0]
    b, dt = x_loc.shape[0], x_loc.dtype
    like = [((b, hdim), acc_dtype(x_loc)), ((b, hdim), dt)]
    dirs = [_lstm_direction(p["fwd"], act, False),
            _lstm_direction(p["bwd"], act, True)]
    ps = leaves(p["fwd"]) + leaves(p["bwd"])
    return _relay_layer(mesh, seq_axis, dirs, like, x_loc, ps, remat)


def _gru_layer_relay(p: dict, x_loc, mesh, seq_axis: str,
                     remat: bool = False):
    """One exact sequence-parallel GRU layer (JAX ``_gru_layer_relay``)."""
    hdim = p["wch"].shape[0]
    like = [((x_loc.shape[0], hdim), x_loc.dtype)]
    return _relay_layer(mesh, seq_axis, [_gru_direction(p)], like, x_loc,
                        leaves(p), remat)


# ---------------------------------------------------------------------------
# the halo warm-up
# ---------------------------------------------------------------------------

def _edge_keep(mesh, seq_axis: str, edge: int, like: torch.Tensor):
    """0 on the ring's ``edge`` coordinate, else 1, in ``like``'s dtype."""
    keep = 0.0 if mesh.coords[seq_axis] == edge else 1.0
    return torch.full((), keep, dtype=like.dtype, device=like.device)


def _bilstm_layer_local(p: dict, x_loc, halo: int, mesh, seq_axis: str,
                        act: str, backend: str):
    """One BiLSTM layer on this rank's chunk with the halo warm-up (JAX
    ``_bilstm_layer_local``)."""
    left = collectives.shift_from_left(mesh, x_loc[:, -halo:], seq_axis)
    right = collectives.shift_from_right(mesh, x_loc[:, :halo], seq_axis)
    hdim = p["fwd"]["wh"].shape[0]
    zero = torch.zeros((x_loc.shape[0], hdim), dtype=x_loc.dtype,
                       device=x_loc.device)
    s = mesh.shape[seq_axis]

    def boundary_state(params, x_halo, reverse, edge):
        _, (c_w, h_w) = rnn.lstm_apply(params, x_halo, act, reverse=reverse,
                                       c0=zero, h0=zero, return_state=True)
        return (c_w * _edge_keep(mesh, seq_axis, edge, c_w),
                h_w * _edge_keep(mesh, seq_axis, edge, h_w))

    c0f, h0f = boundary_state(p["fwd"], left, False, 0)
    h_f = rnn.lstm_apply(p["fwd"], x_loc, act, backend=backend, c0=c0f,
                         h0=h0f)
    c0b, h0b = boundary_state(p["bwd"], right, True, s - 1)
    h_b = rnn.lstm_apply(p["bwd"], x_loc, act, reverse=True, backend=backend,
                         c0=c0b, h0=h0b)
    return torch.cat([h_f, h_b], dim=-1)


def _gru_layer_local(p: dict, x_loc, halo: int, mesh, seq_axis: str,
                     backend: str):
    """One GRU layer on this rank's chunk with the halo warm-up (JAX
    ``_gru_layer_local``)."""
    left = collectives.shift_from_left(mesh, x_loc[:, -halo:], seq_axis)
    hdim = p["wch"].shape[0]
    zero = torch.zeros((x_loc.shape[0], hdim), dtype=x_loc.dtype,
                       device=x_loc.device)
    _, c_w = rnn.gru_apply(p, left, c0=zero, return_state=True)
    c_w = c_w * _edge_keep(mesh, seq_axis, 0, c_w)
    return rnn.gru_apply(p, x_loc, c0=c_w, backend=backend)


# ---------------------------------------------------------------------------
# the stacks
# ---------------------------------------------------------------------------

def _stack(layer_fn, params_list, x, mesh, seq_axis, data_axis,
           dropout_rng, keep_prob):
    """The layers over this rank's block of ``x``, dropout after each
    (its mask drawn whole from ``dropout_rng``, this rank's block kept)."""
    b, t = x.shape[0], x.shape[1]
    d_axis = _mesh_data_axis(mesh, b, data_axis)
    y = _enter(mesh, x, seq_axis, d_axis)
    drop = dropout_rng is not None and keep_prob < 1.0
    for p in params_list:
        y = layer_fn(p, y)
        if drop:
            mask = nn.dropout_mask(dropout_rng, (b, t, y.shape[-1]),
                                   keep_prob, y.device)
            if d_axis is not None:
                mask = collectives._own_slice(mesh, mask, d_axis, 0)
            mask = collectives._own_slice(mesh, mask, seq_axis, 1)
            y = nn.dropout(None, y, keep_prob, mask=mask)
    return y


def bilstm_stack_sp(params_list: list, x: torch.Tensor, mesh,
                    halo: int = 32, seq_axis: str = "seq",
                    candidate_activation: str = "tanh",
                    backend: str = "auto", data_axis: str = "data",
                    dropout_rng=None, keep_prob: float = 1.0,
                    remat: bool = False, scheme: str = "relay"
                    ) -> torch.Tensor:
    """A stack of BiLSTM layers sequence-parallel over ``seq_axis`` (JAX
    ``bilstm_stack_sp``; the module's docstring).

    ``params_list``: one BiLSTM layer tree per layer; ``x``: the rows'
    whole input [B, T, F], the same on every rank of the 'seq' group (T a
    multiple of the axis size; with ``scheme`` 'halo' each chunk at least
    ``halo`` frames); -> this rank's block [B', T / S, 2H] (B' the rank's
    rows under ``data_axis``).  Collective over the 'seq' group."""
    _check(x, mesh, seq_axis, halo, scheme)
    if scheme == "relay":
        layer = lambda p, v: _bilstm_layer_relay(     # noqa: E731
            p, v, mesh, seq_axis, candidate_activation, remat)
    else:
        layer = _maybe_ckpt(lambda p, v: _bilstm_layer_local(
            p, v, halo, mesh, seq_axis, candidate_activation, backend),
            remat)
    return _stack(layer, params_list, x, mesh, seq_axis, data_axis,
                  dropout_rng, keep_prob)


def gru_stack_sp(params_list: list, x: torch.Tensor, mesh, halo: int = 32,
                 seq_axis: str = "seq", backend: str = "auto",
                 data_axis: str = "data", dropout_rng=None,
                 keep_prob: float = 1.0, remat: bool = False,
                 scheme: str = "relay") -> torch.Tensor:
    """A stack of GRU layers sequence-parallel over ``seq_axis`` (JAX
    ``gru_stack_sp``): ``bilstm_stack_sp``'s contract, -> [B', T / S,
    H]."""
    _check(x, mesh, seq_axis, halo, scheme)
    if scheme == "relay":
        layer = lambda p, v: _gru_layer_relay(        # noqa: E731
            p, v, mesh, seq_axis, remat)
    else:
        layer = _maybe_ckpt(lambda p, v: _gru_layer_local(
            p, v, halo, mesh, seq_axis, backend), remat)
    return _stack(layer, params_list, x, mesh, seq_axis, data_axis,
                  dropout_rng, keep_prob)
