"""Pipeline parallelism: GPipe microbatches of the BiLSTM stack over the
mesh's 'pipe' axis.

Counterpart of ``danet_tpu/parallel/pipeline.py``.  Consecutive layers of
the stack group into S stages, one per rank of a 'pipe' group; the rank's
rows (its data shard's, which the ranks of one 'pipe' group share) split
into microbatches, and each microbatch's activations flow from stage to
stage (``collectives.send`` / ``recv``).  The last stage's output reaches
every rank of the group (``collectives.broadcast``), so that the head, the
estimator and the loss run on it replicated over 'pipe', as they run on
JAX's ``out[-1]``.

The parameters stay replicated at rest, as in JAX (whose partition rules
have no 'pipe' rule: its ``shard_map`` hands each stage its layers inside
the step); a stage runs only its own layers, so only it computes their
gradient, and the trainer's reduction scales those leaves by S
(``sharding.leaf_owners``).  ``_stage_stack`` and
``stack_pipeline_params`` are JAX's layout of the stages, [S, L, ...]
leaves with layer 0's input rows zero-padded to the inter-stage width 2H;
``bilstm_stack_pipelined`` runs on them when given ``stacked`` (the input
then zero-padded too, whose rows carry no gradient back), and otherwise on
the stage's layers of ``params_list`` as they are: the padding only made
JAX's stages one program, and each rank here runs its own.

The schedule: the forward runs microbatches 0..M-1 through the stage in
order (receive, the stage's layers, send); the backward, one autograd
Function around the whole stack (``_Pipelined``) that keeps each
microbatch's stage graph, runs them in reverse, M-1..0 (receive the
output's cotangent from the next stage, or take the last stage's rows of
the head's, backpropagate, send the input's cotangent to the previous
stage).  The ranks' sends and receives pair in this fixed order, which the
autograd engine does not choose.  Bubble ticks compute nothing: each rank
runs its L layers on M microbatches per step, so kernel 2 and kernel 3 (or
kernel B without a gradient) launch L x M times per stage rank, where JAX
computes masked garbage in the (S-1) bubble ticks.  With a data axis each
rank pipelines its own rows of every microbatch; where M does not divide
them (JAX then replicates the rows over 'data'), the rank runs the largest
divisor of its rows below M: the rows are independent, so the values are
JAX's either way.  Dropout draws every layer's mask of each microbatch in
(microbatch, layer) order on every rank, each stage keeping its own
layers', so that the masks differ across layers and microbatches and the
ranks of a 'pipe' group, which share one generator, stay in step.  REMAT
recomputes each layer of a stage in the backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from danet_tpu_torch.ops import nn, rnn
from danet_tpu_torch.parallel import collectives
from danet_tpu_torch.parallel.sharding import nest
from danet_tpu_torch.weights import leaf_names, leaves


def _pad_layer_params(p: dict, in_dim: int) -> dict:
    """A BiLSTM layer with its input rows (wx's first dimension)
    zero-padded up to ``in_dim``."""
    def pad_dir(d):
        wx = d["wx"]
        pad = in_dim - wx.shape[0]
        if pad:
            wx = F.pad(wx, (0, 0, 0, 0, 0, pad))
        return {"wx": wx, "wh": d["wh"], "b": d["b"]}
    return {"fwd": pad_dir(p["fwd"]), "bwd": pad_dir(p["bwd"])}


def _stage_stack(params_list: list, n_stages: int):
    """(stacked, width): the layers padded to the inter-stage width 2H and
    stacked into [S, L, ...] leaves (S stages of L consecutive layers)."""
    hdim = params_list[0]["fwd"]["wh"].shape[0]
    width = 2 * hdim
    padded = [_pad_layer_params(p, width) for p in params_list]
    per_stage = len(padded) // n_stages
    names = leaf_names(padded[0])
    cols = zip(*(leaves(p) for p in padded))
    stacked = [torch.stack(col).reshape((n_stages, per_stage)
                                        + tuple(col[0].shape))
               for col in cols]
    return nest(names, stacked), width


def stack_pipeline_params(params_list: list, mesh,
                          pipe_axis: str = "pipe") -> dict:
    """This rank's stage of ``_stage_stack``: [L, ...] leaves, its shard
    of the [S, L, ...] stack (JAX places the stack sharded over the axis,
    each device holding its stage).  Reuse it across calls through
    ``bilstm_stack_pipelined``'s ``stacked``."""
    stacked, _ = _stage_stack(params_list, mesh.shape[pipe_axis])
    s = mesh.coords[pipe_axis]
    return nest(leaf_names(stacked), [v[s] for v in leaves(stacked)])


def _unstack(stage: dict) -> list:
    """[L, ...] leaves -> a list of L layer trees."""
    names = leaf_names(stage)
    vals = leaves(stage)
    return [nest(names, [v[i] for v in vals])
            for i in range(vals[0].shape[0])]


def _local_micro(rows: int, n_micro: int) -> int:
    """The microbatches of a rank's ``rows``: ``n_micro`` when it divides
    them, else its largest divisor below ``n_micro``."""
    m = max(1, min(n_micro, rows))
    while rows % m:
        m -= 1
    return m


class _Schedule:
    """One call's stage: the rank's place in the pipeline and what its
    layers run with."""

    def __init__(self, mesh, axis, n_layers, n_micro, width, act, backend,
                 generator, keep_prob, remat):
        self.mesh, self.axis = mesh, axis
        self.n_stages = mesh.shape[axis]
        self.stage = mesh.coords[axis]
        self.per = n_layers // self.n_stages
        self.n_layers = n_layers
        self.n_micro = n_micro
        self.width = width
        self.act, self.backend = act, backend
        self.generator = generator
        self.keep = keep_prob if generator is not None else 1.0
        self.remat = remat

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.n_stages - 1

    def _layer(self, layer, z):
        def run(p, v):
            return rnn.bilstm_apply(p, v, self.act, backend=self.backend)
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                run, layer, z, use_reentrant=False, preserve_rng_state=False)
        return run(layer, z)

    def _masks(self, shape, device) -> list:
        """Every layer's mask of one microbatch, drawn in layer order; the
        stage's own, or an empty list without dropout."""
        if self.keep >= 1.0:
            return []
        drawn = [nn.dropout_mask(self.generator, shape, self.keep, device)
                 for _ in range(self.n_layers)]
        lo = self.stage * self.per
        return drawn[lo:lo + self.per]

    def stage_apply(self, layers, z, masks):
        for li, layer in enumerate(layers):
            z = self._layer(layer, z)
            if masks:
                z = nn.dropout(None, z, self.keep, mask=masks[li])
        return z

    def forward(self, layers, x, record=None, x_grad=False):
        """The forward schedule; ``record`` (a list) receives each
        microbatch's (input, output) with the input a leaf of its stage
        graph (requiring a gradient past stage 0, and there with
        ``x_grad``).  -> the stack's output [B, T, 2H], the same on every
        rank of the group."""
        b, t = x.shape[0], x.shape[1]
        mb = b // self.n_micro
        shape = (mb, t, self.width)
        outs = []
        for i in range(self.n_micro):
            if self.first:
                inp = x[i * mb:(i + 1) * mb]
            else:
                inp = collectives.recv(self.mesh, shape, x.dtype, x.device,
                                       self.axis, self.stage - 1)
            if record is not None:
                inp = inp.detach().requires_grad_(
                    not self.first or x_grad)
            out = self.stage_apply(layers, inp, self._masks(shape, x.device))
            if record is not None:
                record.append((inp, out))
            if self.last:
                outs.append(out.detach())
            else:
                collectives.send(self.mesh, out, self.axis, self.stage + 1)
        y = torch.cat(outs) if self.last else torch.empty(
            (b, t, self.width), dtype=x.dtype, device=x.device)
        return collectives.broadcast(self.mesh, y, self.axis,
                                     self.n_stages - 1)


class _Pipelined(torch.autograd.Function):
    """The pipelined stack under autograd: the forward schedule with each
    microbatch's stage graph kept, the backward schedule in reverse
    (module docstring).  Inputs: the schedule, the layers' leaf names, x,
    then the stage's leaves."""

    @staticmethod
    def forward(ctx, sched, names, x, *ps):
        params = [p.detach().requires_grad_(p.requires_grad) for p in ps]
        per = len(params) // sched.per
        layers = [nest(names, params[i * per:(i + 1) * per])
                  for i in range(sched.per)]
        record = []
        with torch.enable_grad():
            y = sched.forward(layers, x.detach(), record, x.requires_grad)
        ctx.sched, ctx.params, ctx.record = sched, params, record
        ctx.x_grad = x.requires_grad
        ctx.x_meta = (tuple(x.shape), x.dtype, x.device)
        return y

    @staticmethod
    def backward(ctx, dy):
        sched, params, record = ctx.sched, ctx.params, ctx.record
        mesh, axis = sched.mesh, sched.axis
        grads = [None] * len(params)
        live = [i for i, p in enumerate(params) if p.requires_grad]
        dxs = [None] * len(record)
        mb = dy.shape[0] // len(record)
        for i in reversed(range(len(record))):
            inp, out = record[i]
            if sched.last:
                g = dy[i * mb:(i + 1) * mb]
            else:
                g = collectives.recv(mesh, out.shape, out.dtype, out.device,
                                     axis, sched.stage + 1)
            want = ([inp] if inp.requires_grad else []) \
                + [params[j] for j in live]
            got = list(torch.autograd.grad(out, want, g, allow_unused=True))
            d_inp = got.pop(0) if inp.requires_grad else None
            for j, gj in zip(live, got):
                if gj is not None:
                    grads[j] = gj if grads[j] is None else grads[j] + gj
            if not sched.first:
                collectives.send(mesh, d_inp, axis, sched.stage - 1)
            else:
                dxs[i] = d_inp
            record[i] = None
        dx = None
        if ctx.x_grad:
            shape, dtype, device = ctx.x_meta
            dx = torch.cat(dxs) if sched.first else torch.empty(
                shape, dtype=dtype, device=device)
            dx = collectives.broadcast(mesh, dx, axis, 0)
        ctx.record = ctx.params = None
        return (None, None, dx) + tuple(grads)


def bilstm_stack_pipelined(params_list: list, x: torch.Tensor, mesh,
                           n_micro: int = 4, pipe_axis: str = "pipe",
                           candidate_activation: str = "tanh",
                           backend: str = "auto", stacked=None,
                           dropout_rng=None, keep_prob: float = 1.0,
                           remat: bool = False) -> torch.Tensor:
    """The BiLSTM stack pipelined over ``pipe_axis`` (module docstring).

    ``params_list``: one BiLSTM layer tree per layer, the full stack
    (replicated over the axis); its length a multiple of the axis size.
    ``x``: this rank's rows [B, T, F] (the same on every rank of its
    'pipe' group).  ``stacked``: this rank's stage from
    ``stack_pipeline_params`` (then its layers run on x zero-padded to
    2H).  ``dropout_rng`` / ``keep_prob``: dropout after every layer.
    -> [B, T, 2H] on every rank of the group.  Collective over the
    group."""
    s = mesh.shape[pipe_axis]
    n_layers = len(params_list)
    if n_layers % s:
        raise AssertionError("%d layers must group evenly over %d pipeline "
                             "stages" % (n_layers, s))
    b, t, f = x.shape
    hdim = params_list[0]["fwd"]["wh"].shape[0]
    width = 2 * hdim
    if width < f:
        raise AssertionError("inter-stage width must cover the input "
                             "features")
    sched = _Schedule(mesh, pipe_axis, n_layers, _local_micro(b, n_micro),
                      width, candidate_activation, backend, dropout_rng,
                      keep_prob, remat)
    if stacked is not None:
        layers = _unstack(stacked)
        x = F.pad(x, (0, width - f))
    else:
        lo = sched.stage * sched.per
        layers = params_list[lo:lo + sched.per]
    ps = [p for layer in layers for p in leaves(layer)]
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in ps)):
        return _Pipelined.apply(sched, leaf_names(layers[0]), x, *ps)
    return sched.forward(layers, x)
