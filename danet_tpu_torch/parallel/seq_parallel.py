"""Sequence parallelism over the mesh's 'seq' axis: the recurrent stacks'
exact boundary-state relay and halo warm-up, the convolutional stacks'
exact halos and the dual-path stack's all-to-all.

Counterpart of ``danet_tpu/parallel/seq_parallel.py`` (``bilstm_stack_sp``,
``gru_stack_sp`` and their layers; ``tcn_stack_sp``, ``conv_bilstm_sp``
and ``dprnn_stack_sp``, the last section here).  The T axis of
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
kept (``_chunk_mask``): the dense stack's masks, where JAX folds the
device's coordinates into its keys.  ``remat``: the relay keeps only
each direction's input and incoming state and recomputes the chunk scan
in the backward (the lean state entry forward, then the saving one); the
halo scheme runs each layer under ``torch.utils.checkpoint``, whose
recompute replays its shifts on every rank in the same order.

The convolutional and dual-path stacks are exact with no relay.
``tcn_stack_sp`` (tcn-v1, and tasnet-v1 through ``tcn_chunk_sp``): each
block's dilated depthwise convolution needs (K - 1) dilation frames of
context, which ``with_halos`` fetches from the neighbours (the edge ranks
receive zeros, the dense convolution's zero padding), and then runs VALID.
``conv_bilstm_sp`` (conv-bilstm-v1): every 2-D convolution takes k // 2
halo frames in T, the pools stay on the rank, the two centrings sum their
partial sums over 'seq' (``collectives.sum_parts``) and the BiLSTMs are
the relay.  ``dprnn_stack_sp`` (dprnn-v1 with DPRNN_HOP == DPRNN_CHUNK):
whole segments shard over 'seq' for the intra path, and two all-to-alls
per block move the inter path to a split of the positions and back.  Each
raises JAX's ValueErrors, in its words, where JAX asserts or raises, and
runs every scan on the hand kernels on a card.
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

def _chunk_mask(mesh, generator, shape, keep_prob: float, seq_axis: str,
                d_axis, device, seq_dim: int = 1) -> torch.Tensor:
    """The dropout mask of this rank's block of ``shape``: drawn whole
    from ``generator`` (the dense path's draw, rows times the 'data' axis
    under ``d_axis``, ``seq_dim`` times the 'seq' axis), this rank's block
    kept."""
    whole = list(shape)
    whole[seq_dim] *= mesh.shape[seq_axis]
    if d_axis is not None:
        whole[0] *= mesh.shape[d_axis]
    mask = nn.dropout_mask(generator, tuple(whole), keep_prob, device)
    if d_axis is not None:
        mask = collectives._own_slice(mesh, mask, d_axis, 0)
    return collectives._own_slice(mesh, mask, seq_axis, seq_dim)


def _stack(layer_fn, params_list, x, mesh, seq_axis, data_axis,
           dropout_rng, keep_prob):
    """The layers over this rank's block of ``x``, dropout after each
    (its mask drawn whole from ``dropout_rng``, this rank's block kept)."""
    d_axis = _mesh_data_axis(mesh, x.shape[0], data_axis)
    y = _enter(mesh, x, seq_axis, d_axis)
    drop = dropout_rng is not None and keep_prob < 1.0
    for p in params_list:
        y = layer_fn(p, y)
        if drop:
            mask = _chunk_mask(mesh, dropout_rng, y.shape, keep_prob,
                               seq_axis, d_axis, y.device)
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


# ---------------------------------------------------------------------------
# the convolutional and dual-path stacks
# ---------------------------------------------------------------------------

def with_halos(mesh, v: torch.Tensor, seq_axis: str, dim: int, left: int,
          right: int) -> torch.Tensor:
    """``v`` extended along ``dim`` by the last ``left`` frames of the
    left neighbour's ``v`` and the first ``right`` of the right
    neighbour's; the ring's edge ranks receive zeros, the zero padding of
    the whole sequence.  Both shifts run on every rank."""
    n = v.shape[dim]
    parts = []
    if left:
        parts.append(collectives.shift_from_left(
            mesh, v.narrow(dim, n - left, left), seq_axis))
    parts.append(v)
    if right:
        parts.append(collectives.shift_from_right(
            mesh, v.narrow(dim, 0, right), seq_axis))
    return torch.cat(parts, dim) if len(parts) > 1 else v


def _tcn_block(blk: dict, h, mesh, seq_axis: str, dilation: int,
               kernel: int, causal: bool, alpha: float):
    """One TCN block on this rank's chunk [B, C, D]: its depthwise
    convolution VALID (float32) over the convolution's input extended by
    the neighbours' halos, (K - 1) dilation frames from the left (causal)
    or span // 2 from the left and the rest from the right."""
    y = nn.tcn_block_in(blk, h, alpha)
    span = (kernel - 1) * dilation
    left, right = (span, 0) if causal else (span // 2, span - span // 2)
    y = nn.conv1d_depthwise_apply(
        blk["dconv"], with_halos(mesh, y, seq_axis, 1, left, right),
        dilation=dilation, valid=True)
    return nn.tcn_block_out(blk, h, y, alpha)


def tcn_chunk_sp(params: dict, x_loc: torch.Tensor, mesh, dilations,
                 kernel: int, causal: bool, alpha: float,
                 seq_axis: str = "seq", d_axis=None, dropout_rng=None,
                 keep_prob: float = 1.0, remat: bool = False
                 ) -> torch.Tensor:
    """``tcn_stack_sp`` on this rank's chunk ``x_loc`` [B', C, F] (the
    rank's rows under ``d_axis``), already entered: the bottleneck and
    the blocks, dropout after each block (its mask drawn whole, this
    rank's block kept) -> [B', C, D].  The chunk must cover the largest
    (K - 1) dilation span (JAX's words in a ValueError)."""
    chunk = x_loc.shape[1]
    max_span = max((kernel - 1) * d for d in dilations)
    if chunk < max_span:
        raise ValueError(
            "chunk %d < largest conv span %d — lower MESH_SEQ or the "
            "TCN_BLOCKS dilation ceiling" % (chunk, max_span))
    h = nn.linear_apply(params["bottleneck"], x_loc)
    drop = dropout_rng is not None and keep_prob < 1.0
    for i, dil in enumerate(dilations):
        block = _maybe_ckpt(
            lambda blk, v, d=dil: _tcn_block(blk, v, mesh, seq_axis, d,
                                             kernel, causal, alpha), remat)
        h = block(params["block%d" % i], h)
        if drop:
            h = nn.dropout(None, h, keep_prob, mask=_chunk_mask(
                mesh, dropout_rng, h.shape, keep_prob, seq_axis, d_axis,
                h.device))
    return h


def tcn_stack_sp(params: dict, x: torch.Tensor, mesh, dilations,
                 kernel: int, causal: bool, alpha: float,
                 seq_axis: str = "seq", data_axis: str = "data",
                 dropout_rng=None, keep_prob: float = 1.0,
                 remat: bool = False) -> torch.Tensor:
    """The exact sequence-parallel TCN stack (JAX ``tcn_stack_sp``): a
    dilated convolution needs only (K - 1) dilation frames of context, so
    each block exchanges exactly that halo of its convolution's input with
    the neighbours, and the edge ranks' zeros are the dense convolution's
    zero padding.

    ``params``: the bottleneck and the ``block<i>`` trees (TcnEncoder's
    without its head); ``x``: the rows' whole centred input [B, T, F], the
    same on every rank of the 'seq' group, T a multiple of the axis size
    and each chunk at least the largest span; ``dilations`` per block.
    -> this rank's block [B', T / S, D].  Collective over the 'seq'
    group."""
    s = mesh.shape[seq_axis]
    t = x.shape[1]
    if t % s:
        raise ValueError("T must divide across the seq axis")
    d_axis = _mesh_data_axis(mesh, x.shape[0], data_axis)
    return tcn_chunk_sp(params, _enter(mesh, x, seq_axis, d_axis), mesh,
                        dilations, kernel, causal, alpha, seq_axis, d_axis,
                        dropout_rng, keep_prob, remat)


def _dprnn_block(blk: dict, chunks, mesh, seq_axis: str, inter_causal: bool,
                 backend: str, masks, keep: float):
    """One dual-path block on this rank's segments [B', S / n, P, D]: the
    intra path on its own segments; the inter path after an all-to-all
    to a split of the positions with every segment ([B', S, P / n, D]),
    and back."""
    b, s_loc, p, d = chunks.shape
    y = rnn.bilstm_apply(blk["intra"], chunks.reshape(b * s_loc, p, d),
                         "tanh", backend=backend)
    y = nn.linear_apply(blk["intra_proj"], y).reshape(b, s_loc, p, d)
    y = nn.layer_norm(blk["intra_ln"], y)
    if masks is not None:
        y = nn.dropout(None, y, keep, masks[0])
    chunks = chunks + y
    yp = collectives.all_to_all(mesh, chunks, seq_axis, 2, 1)
    s_glob, p_loc = yp.shape[1], yp.shape[2]
    yq = yp.transpose(1, 2).reshape(b * p_loc, s_glob, d)
    if inter_causal:
        yq = rnn.lstm_apply(blk["inter"], yq, "tanh", backend=backend)
    else:
        yq = rnn.bilstm_apply(blk["inter"], yq, "tanh", backend=backend)
    yq = nn.linear_apply(blk["inter_proj"], yq)
    yq = yq.reshape(b, p_loc, s_glob, d).transpose(1, 2)
    yq = collectives.all_to_all(mesh, yq, seq_axis, 1, 2)
    y = nn.layer_norm(blk["inter_ln"], yq)
    if masks is not None:
        y = nn.dropout(None, y, keep, masks[1])
    return chunks + y


def dprnn_stack_sp(params: dict, x: torch.Tensor, mesh, p: int,
                   n_blocks: int, inter_causal: bool, backend: str = "auto",
                   seq_axis: str = "seq", data_axis: str = "data",
                   dropout_rng=None, keep_prob: float = 1.0,
                   remat: bool = False) -> torch.Tensor:
    """The exact sequence-parallel dual-path stack (JAX
    ``dprnn_stack_sp``; DPRNN_HOP == DPRNN_CHUNK = ``p``): the intra path
    touches only the frames of one segment, so whole segments shard over
    'seq'; the inter path is independent across positions, so an
    all-to-all re-shards the segments into a split of the positions, the
    inter scan runs over every segment on 1 / S of the positions, and a
    second all-to-all restores the segment split.  Each scan is one
    ``ops/rnn.py`` call, on the hand kernels on a card.

    ``params``: the bottleneck and the ``block<i>`` trees (DprnnEncoder's
    without its head); ``x``: the rows' whole centred input [B, T, F].
    Dropout (``dropout_rng``, ``keep_prob``): each block's two masks
    drawn whole before it, intra then inter, this rank's segments kept.
    -> this rank's block [B', T / S, D].  Collective over the 'seq'
    group."""
    s = mesh.shape[seq_axis]
    b, t = x.shape[0], x.shape[1]
    if t % (p * s):
        raise ValueError(
            "T=%d must split into whole %d-frame segments per seq-axis "
            "device (s=%d): pick MAX_TRAIN_LEN / TIME_BUCKET so that "
            "T %% (DPRNN_CHUNK * MESH_SEQ) == 0" % (t, p, s))
    if p % s:
        raise ValueError(
            "DPRNN_CHUNK=%d must divide by MESH_SEQ=%d (the inter-chunk "
            "all_to_all splits the position axis)" % (p, s))
    d_axis = _mesh_data_axis(mesh, b, data_axis)
    h = nn.linear_apply(params["bottleneck"], _enter(mesh, x, seq_axis,
                                                     d_axis))
    bl, d = h.shape[0], h.shape[-1]
    s_loc = h.shape[1] // p
    chunks = h.reshape(bl, s_loc, p, d)
    drop = dropout_rng is not None and keep_prob < 1.0
    block = _maybe_ckpt(lambda blk, c, masks: _dprnn_block(
        blk, c, mesh, seq_axis, inter_causal, backend, masks, keep_prob),
        remat)
    for i in range(n_blocks):
        masks = tuple(_chunk_mask(mesh, dropout_rng, chunks.shape,
                                  keep_prob, seq_axis, d_axis,
                                  chunks.device) for _ in range(2)) \
            if drop else None
        chunks = block(params["block%d" % i], chunks, masks)
    return chunks.reshape(bl, s_loc * p, d)


def conv_bilstm_sp(params: dict, x: torch.Tensor, mesh, nfft: int,
                   feature_size: int, embed_size: int, alpha: float,
                   act: str, seq_axis: str = "seq", data_axis: str = "data",
                   dropout_rng=None, keep_prob: float = 1.0,
                   remat: bool = False) -> torch.Tensor:
    """The exact sequence-parallel conv-bilstm-v1 encoder (JAX
    ``conv_bilstm_sp``): every 2-D convolution exchanges its k // 2
    frames of halo in T with the neighbours and runs VALID in T and SAME
    in F (the edge ranks' zeros are the dense convolution's padding); the
    2x2 pools stay on the rank, each chunk's frame count even; both
    centrings sum their per-example partial sums over 'seq'
    (``collectives.sum_parts``); the two BiLSTMs are the exact relay
    (``_bilstm_layer_relay``, kernel 1's state forms on a card), dropout
    after each (its mask drawn whole, this rank's block kept); the pixel
    shuffle and the head are local.

    ``x``: the rows' whole log spectra [B, T, F], T a multiple of 4 S and
    at least 8 S.  -> this rank's block of the embeddings [B', T / S, F,
    E].  Collective over the 'seq' group."""
    s = mesh.shape[seq_axis]
    t = x.shape[1]
    if t % (4 * s):
        raise ValueError(
            "T=%d must divide by 4*MESH_SEQ=%d (the conv-bilstm pools twice "
            "and every chunk boundary must land on the pooled grid)"
            % (t, 4 * s))
    if t // (4 * s) < 2:
        raise ValueError(
            "chunk too short for the k=3 conv halos after double pooling — "
            "raise MAX_TRAIN_LEN/TIME_BUCKET or lower MESH_SEQ")
    d_axis = _mesh_data_axis(mesh, x.shape[0], data_axis)
    x_loc = _enter(mesh, x, seq_axis, d_axis)
    b = x_loc.shape[0]

    def conv(name, v):
        k = params[name]["w"].shape[2]
        v = with_halos(mesh, v, seq_axis, 2, k // 2, k // 2)
        return nn.leaky_relu(nn.conv2d_apply(params[name], v, valid_h=True),
                             alpha)

    def centred(v):
        part = torch.sum(v.to(acc_dtype(v)), dim=(1, 2, 3), keepdim=True)
        total = collectives.sum_parts(mesh, part, seq_axis)
        count = v.shape[1] * v.shape[2] * v.shape[3] * s
        return v - (total / count).to(v.dtype)

    v = conv("down0b", conv("down0a", x_loc[:, None]))
    v = nn.max_pool_2x2(v)
    v = nn.max_pool_2x2(conv("down1b", conv("down1a", v)))
    v = centred(v)                                 # [B', 16, C / 4, F / 8]
    skip = v
    seq = v.transpose(1, 2).reshape(b, v.shape[2], nfft * 2)
    drop = dropout_rng is not None and keep_prob < 1.0
    for name in ("lstm0", "lstm1"):
        seq = _bilstm_layer_relay(params[name], seq, mesh, seq_axis, act,
                                  remat)
        if drop:
            seq = nn.dropout(None, seq, keep_prob, mask=_chunk_mask(
                mesh, dropout_rng, seq.shape, keep_prob, seq_axis, d_axis,
                seq.device))
    v = centred(seq.reshape(b, -1, 16, nfft // 8).transpose(1, 2) + skip)
    v = conv("up0b", conv("up0a", v))
    t4 = v.shape[2]
    v = v.reshape(b, 16, 2, 2, t4, nfft // 8).permute(0, 1, 4, 2, 5, 3) \
        .reshape(b, 16, t4 * 2, nfft // 4)         # pixel shuffle x2
    v = conv("up1b", conv("up1a", v))
    v = v.transpose(1, 2).reshape(b, -1, nfft)
    out = nn.linear_apply(params["output"], v)
    return out.reshape(b, -1, feature_size, embed_size)
