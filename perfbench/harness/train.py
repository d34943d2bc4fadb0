"""Training cells: the program's ``Trainer.train_steps`` at K =
TRAIN_STEPS_PER_CALL (on the card one CUDA graph of K steps), fed as
``Trainer._epochs`` feeds it: a thread casts each stack of K batches into
pinned buffers (``Trainer._host_batch``) and ``prefetch_to_device``
copies it (``Trainer._put``); the metrics are fetched every METRICS_EVERY
steps.  The traffic's ``stacks`` stacks are drawn in set-up and fed in
turn.  On a mesh (MESH_DATA > 1) every rank runs this loop on its rows of
the same global batches, and rank 0 decides over gloo when the window
ends.

Set-up builds the trainer and its state from the seed's weights and runs
its first calls; the first call's K steps are the ones the reference
follows.  The window then repeats calls for ``--seconds``: the rate is
every mixture of every call started in the window over the time to the
last call's metrics on the host.
"""
from __future__ import annotations

import gc
import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.harness import cell as cell_mod
from perfbench.harness import traffic as traffic_mod
from perfbench.harness import weights as weights_mod
from perfbench.harness.trace import profiled
from perfbench.reference import danet as ref

WARM_CALLS = 2      # calls after the first, so that the pinned pool fills


def model(cell):
    """(hp, the program's model) of the cell's configuration; bilstm-orig's
    widths, class attributes of the program, checked against the
    configuration's."""
    from danet_tpu_torch.hparams import load_config
    hp = load_config(**cell.keys)
    enc = hp.get_encoder()
    if cell.widths and cell.keys["ENCODER_TYPE"] == "bilstm-orig":
        want = (cell.widths["BILSTM_LAYERS"], cell.widths["BILSTM_HIDDEN"])
        if (enc.N_LAYERS, enc.HDIM) != tuple(want):
            raise ValueError("the program's bilstm-orig is %d x %d, the "
                             "configuration states %d x %d"
                             % ((enc.N_LAYERS, enc.HDIM) + want))
    return hp, hp.get_model()(hp)


def build(cell, device):
    """(hp, trainer) of the cell's configuration."""
    from danet_tpu_torch.train.trainer import Trainer
    hp, m = model(cell)
    return hp, Trainer(m, hp, device, name=cell.name)


class Loop:
    """The program's training loop on one rank."""

    def __init__(self, cell, device):
        from danet_tpu_torch.train.trainer import prefetch_to_device
        self.cell, self.device = cell, torch.device(device)
        self.hp, self.trainer = build(cell, device)
        tr = self.trainer
        self.k = int(self.hp.TRAIN_STEPS_PER_CALL)
        self.every = int(getattr(self.hp, "METRICS_EVERY", 1) or 1)
        params = weights_mod.make(cell.keys, cell.widths, cell.seed,
                                  self.device)
        self.state = tr.init_state(params=params)
        del params
        self.traffic = traffic_mod.make(cell.traffic, cell.keys, cell.seed)
        self.rows_global = self.traffic.batch
        rows = slice(None)
        if tr.mesh is not None:
            from danet_tpu_torch.parallel import sharding
            rows = sharding.batch_rows(tr.mesh, self.rows_global)

        # the traffic's stacks, drawn once: the feeding thread then does
        # only the program's own host work (the wire cast into pinned
        # buffers), whatever the host's speed
        stacks = [self.traffic.batches(j * self.k, self.k, rows)
                  for j in range(int(cell.traffic["stacks"]))]

        def feed():
            i = 0
            while True:
                yield self.k, tr._host_batch(stacks[i % len(stacks)],
                                             stacked=True)
                i += 1

        self.batches = prefetch_to_device(
            feed(), lambda kb: (kb[0], tr._put(kb[1])))
        self.pending, self.pending_steps = [], 0
        self.steps = 0
        self.values = []           # every fetched (loss, ...) row

    def call(self) -> None:
        k, src = next(self.batches)
        m = self.trainer.train_steps(self.state, src)
        self.pending.append(m)
        self.pending_steps += k
        self.steps += k
        if self.pending_steps >= self.every:
            self.flush()

    def flush(self) -> None:
        """One fetch of the pending metrics, as the program's loop does."""
        if not self.pending:
            return
        names = list(self.pending[0])
        host = torch.stack([torch.stack([m[n] for n in names], -1)
                            for m in self.pending]).reshape(
            -1, len(names)).cpu().numpy()
        self.values.extend(host[:, names.index("loss")].tolist())
        self.pending, self.pending_steps = [], 0

    def snapshot(self) -> dict:
        """The state after the calls so far, on the host: the weights and
        Adam's first moments, by leaf."""
        from danet_tpu_torch.weights import leaves
        opt = self.state["opt"]
        return {"params": [p.detach().float().cpu().clone()
                           for p in leaves(self.state["params"])],
                "m": [m.detach().float().cpu().clone() for m in opt.mu]}

    def close(self) -> None:
        self.batches.close()
        self.state = self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def compare(cell, traffic, loop_first: dict, device) -> dict:
    """The reference's first K steps from the seed's weights on the first
    stack's global batches against the program's: each step's loss
    (relative gap, the largest), and by leaf the gap between the norms of
    the two sides' first moments and of their weight changes, over the
    larger of the reference leaf's norm and the median leaf's (the
    largest).  Leaves whose reference moment is under a thousandth of the
    median leaf's (no gradient but round-off) are left out."""
    ref.exact_float32()
    keys = dict(cell.keys)
    params = weights_mod.make(keys, cell.widths, cell.seed, device)
    k = len(loop_first["loss"])
    stack = torch.from_numpy(traffic.batches(0, k)).to(device)
    out = ref.train_steps(keys, params, list(stack))
    return gaps(out, loop_first, ref.leaves(params))


def gaps(out: dict, prog: dict, start: list) -> dict:
    """{'loss_gap', 'moment_gap', 'change_gap'} of a program run against a
    reference run (``ref.train_steps``' dict); ``start`` the initial
    weights by leaf."""
    lp = np.asarray(prog["loss"], np.float64)
    lr = np.asarray(out["loss"], np.float64)
    loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr)))
    m_ref = np.array([float(m.norm()) for m in out["m"]])
    keep = m_ref >= 1e-3 * np.median(m_ref)
    m_prog = np.array([float(m.norm()) for m in prog["m"]])
    d_ref = np.array([float(d.norm()) for d in out["change"]])
    d_prog = np.array([float((p.to(s.device) - s).norm())
                       for p, s in zip(prog["params"], start)])

    def worst(a, b):
        a, b = a[keep], b[keep]
        return float(np.max(np.abs(a - b) / np.maximum(b, np.median(b))))

    return {"loss_gap": loss_gap, "moment_gap": worst(m_prog, m_ref),
            "change_gap": worst(d_prog, d_ref)}


def start(cell, device, t_start: float = 0.0):
    """Set-up: the loop, its first call (whose state, losses and first
    moments are kept for the comparison) and the warm calls.  -> (loop,
    the first call's readings)."""
    loop = Loop(cell, device)
    cell_mod.stage("trainer, weights, traffic", t_start)
    loop.call()
    loop.flush()
    cell_mod.stage("first call (capture)", t_start)
    first = dict(loop.snapshot(), loss=list(loop.values))
    for _ in range(WARM_CALLS):
        loop.call()
    loop.flush()
    cell_mod.sync(device)
    cell_mod.stage("warm calls", t_start)
    return loop, first


def run(cell, t_start: float, device="cuda") -> cell_mod.Result:
    """One run of a one-chip training cell."""
    cell_mod.reset_peak(device)
    loop, first = start(cell, device, t_start)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    slices = []
    done = loop.steps
    if cell.trace:
        with profiled(slices):
            for _ in range(int(cell.traffic["trace_calls"])):
                loop.call()
            loop.flush()
    else:
        while time.perf_counter() - t0 < cell.seconds:
            loop.call()
        loop.flush()
        cell_mod.sync(device)
    window_s = time.perf_counter() - t0
    steps = loop.steps - done
    lost = sum(1 for v in loop.values[-steps:] if not math.isfinite(v))
    peak = cell_mod.peak_bytes(device)
    loop.close()
    got = compare(cell, loop.traffic, first, device)
    rate = steps * loop.rows_global / window_s
    metrics = {"setup_s": (setup_s, "s"), "train_mix_per_s": (rate, "mix/s")}
    ctx = SimpleNamespace(keys=cell.keys, widths=cell.widths,
                          traffic=cell.traffic, steps=steps,
                          rows=loop.rows_global,
                          frames=int(cell.traffic["frames"]), chips=1,
                          slice=slices[0] if slices else None)
    return finish(cell, metrics, ctx, got, steps, lost, peak, device)


def finish(cell, metrics, ctx, got, attempted, failed, peak, device,
           busy=None) -> cell_mod.Result:
    """The result: the cell's end-to-end metrics (untraced) or its
    per-layer metrics (traced), the device, the checks."""
    dev = {"platform": "gpu", "kind": cell_mod.device_name(device),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = {}
    if cell.trace:
        out = {}
        for name, mod in cell_mod.metric_readers(cell.end_to_end).items():
            v = mod.read(ctx)
            if v is not None:
                out[name] = (v, mod.UNIT)
        dev["busy_s"] = ctx.slice.busy_s if busy is None else busy
        dev["window_s"] = ctx.slice.window_s
        breakdown = ctx.slice.breakdown()
    else:
        out = {k: v for k, v in metrics.items() if k in cell.end_to_end}
    checks = {k: (float(v), float(cell.limits[k])) for k, v in got.items()}
    return cell_mod.Result(correct=cell_mod.judge(checks),
                           attempted=attempted, failed=failed, metrics=out,
                           device=dev, checks=checks, breakdown=breakdown)


def run_mesh(cell, t_start: float, rank: int, world: int, port: int,
             device="cuda"):
    """One rank of a data-parallel training cell; rank 0 returns the
    result, the others None.  Every rank profiles the same calls of a
    traced run; the busy time is their mean, the per-layer metrics rank
    0's."""
    import os
    import torch.distributed as dist
    from danet_tpu_torch.parallel import multihost
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    multihost.initialize(device)
    dev = torch.device(device, rank) if device == "cuda" else \
        torch.device(device)
    cell_mod.reset_peak(dev)
    loop, first = start(cell, dev, t_start)
    dist.barrier()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    slices, done = [], loop.steps
    stop = torch.zeros(1)
    if cell.trace:
        with profiled(slices):
            for _ in range(int(cell.traffic["trace_calls"])):
                loop.call()
            loop.flush()
    else:
        while True:
            loop.call()
            stop[0] = float(time.perf_counter() - t0 >= cell.seconds)
            dist.broadcast(stop, 0)
            if stop[0]:
                break
        loop.flush()
        cell_mod.sync(dev)
    window_s = time.perf_counter() - t0
    steps = loop.steps - done
    lost = sum(1 for v in loop.values[-steps:] if not math.isfinite(v))
    mine = [cell_mod.peak_bytes(dev),
            slices[0].busy_s if slices else 0.0]
    every = [None] * world
    dist.all_gather_object(every, mine)
    loop.close()
    dist.barrier()
    dist.destroy_process_group()
    if rank != 0:
        return None
    got = compare(cell, loop.traffic, first, dev)
    rate = steps * loop.rows_global / window_s
    metrics = {"setup_s": (setup_s, "s"),
               "mesh_train_mix_per_s": (rate, "mix/s")}
    ctx = SimpleNamespace(keys=cell.keys, widths=cell.widths,
                          traffic=cell.traffic, steps=steps,
                          rows=loop.rows_global,
                          frames=int(cell.traffic["frames"]), chips=world,
                          slice=slices[0] if slices else None)
    return finish(cell, metrics, ctx, got, steps, lost,
                  max(p for p, _ in every), dev,
                  busy=sum(b for _, b in every) / world)
