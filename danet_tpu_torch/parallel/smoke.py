"""The mesh's multi-process driver: start N ranks, run cases on the mesh,
write each rank's results for the caller to compare.

    python -m danet_tpu_torch.parallel.smoke run --spec SPEC.json \\
        --out DIR --nproc N [--device cpu|cuda] [--backend gloo] \\
        [--shared-card] [--timeout SECONDS]
    python -m danet_tpu_torch.parallel.smoke multichip --out DIR \\
        [--config configs/pipeline.json] [--mesh 2x2 --mesh 4x1] \\
        [--steps 8]

``run`` starts N processes of this module on ``localhost`` (a free port;
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT as
``torch.distributed.run`` sets them) in the spec's directory (its
relative paths), each of which joins the group
(``multihost.initialize``: gloo on the CPU, ``cpu:gloo,cuda:nccl`` on
cards, or ``--backend gloo`` with ``--shared-card``: every rank on cuda:0,
the card tensors staged through the host) and runs the spec's cases in
order.  Rank r writes ``DIR/rank<r>.npz`` (keys ``<case>/<item>``) and its
output to ``DIR/rank<r>.log``; a rank that fails, or a run past
``--timeout``, fails the command (every rank is stopped; 20 s before the
timeout a rank still running writes its threads' stacks to its log).

A spec is JSON: ``{"threads": 1, "cases": [{"name": ..., "kind": ...,
...}, ...]}``; each case builds its config from default.json, its
``configs`` files and its ``keys`` (``dims`` [HDIM, N_LAYERS] narrows a
recurrent encoder), its mesh from MESH_DATA / MESH_MODEL
(``mesh_from_hparams``; a rank outside it skips the case), and a Trainer on
that mesh.  Kinds:

  * ``step``: ``params`` (an .npz tree, ``weights.save_npz``; seeded
    otherwise) and ``batch`` (an .npz with ``src``, the global batch):
    with ``init`` a checkpoint loaded first (-> ``loaded/<leaf>``,
    whole), then the mesh's ``loss_and_grads`` -> ``loss``, ``SNR``,
    ``grads/<leaf>`` (whole), ``rows`` (this rank's), ``bytes`` (params
    and moments at rest); with ``adam`` one ``train_step`` after it ->
    ``params/<leaf>`` and ``mu/<leaf>`` (whole), ``step_loss``, and the
    LSTM kernels' ``launches/<kernel>`` of that step (and of a
    ``valid_step`` after it, with ``valid``); with ``save`` the state
    saved to ``DIR/saves/<name>``;
  * ``pipeline``: ``params`` (an .npz tree of ``lstm<i>`` BiLSTM layers)
    and ``x`` (an .npz with ``x`` [B, T, F]): ``pipeline.
    bilstm_stack_pipelined`` on the rank's rows with ``n_micro``
    microbatches (``stacked``: on ``stack_pipeline_params``' stage) ->
    ``y``, ``y_nograd``, ``rows``, ``loss`` (sum(sin(y)) over the
    batch), ``grads/<leaf>`` (whole, the batch's), ``launches/<kernel>``;
  * ``moe``: ``params`` (router, w_in, w_out) and ``x`` [B, T, d]:
    ``expert.moe_mlp_ep`` (``k`` 0), ``moe_mlp_ep_routed`` (``k``,
    ``cf``), or without an 'expert' axis ``moe_mlp_topk`` with the global
    count, on the rank's rows -> ``y``, ``rows``, ``grads/<leaf>`` of
    sum(y^2) (whole, the batch's);
  * ``bilstm_tp``: ``params`` (one BiLSTM layer) and ``x`` (an .npz with
    ``x`` [B, T, I]): the layer's slices gathered, ``rnn.bilstm_apply_tp``
    on the rank's rows, the gradients of sum(sin(y)) reduced -> ``y``,
    ``rows``, ``grads/<leaf>`` (whole, summed over the ranks),
    ``gathered_exact``;
  * ``train``: ``epochs`` of ``Trainer.train`` on the config's dataset
    (``init``: a checkpoint to resume first, its load -> ``loaded/<leaf>``;
    ``signal_at`` [rank, step]: that rank sends itself SIGTERM after that
    step) with checkpoints in ``DIR/saves`` -> ``train_loss`` (every
    step's row), ``valid_loss``, ``lr``, ``step``, ``epoch``,
    ``checksum``, ``params/<leaf>`` (whole);
  * ``dropout``: the rank's dropout generator -> ``seed`` and ``mask`` (64
    draws at keep 0.5);
  * ``sp_stack``: ``params`` (an .npz tree of ``lstm<i>`` BiLSTM or
    ``gru<i>`` GRU layers, by ``rnn`` 'bilstm' or 'gru') and ``x`` (an
    .npz with ``x`` [B, T, F], the global batch):
    ``seq_parallel.bilstm_stack_sp`` / ``gru_stack_sp`` with ``scheme``,
    ``halo``, ``remat``, the batch co-sharded over 'data' when it divides
    (``dtype``, ``keep`` with a generator of ``seed``) -> ``y`` (this
    rank's block), ``rows``, ``cols`` (its T range), ``y_nograd``,
    ``grads/<leaf>`` of sum(y^2) over the mesh (the global batch's),
    ``dx`` (whole), the kernels' ``launches/<kernel>`` of the forward and
    backward;
  * ``sp_attention``: ``x`` (an .npz with q, k, v [B, T, H, D] and
    ``mask`` [B, T]): ``ring_attention`` or ``ulysses_attention``
    (``pattern``) with ``window`` -> ``y`` (whole), ``grads/{q,k,v}`` of
    sum(sin(y)) (whole);
  * ``separate_sp``: ``params`` and ``mix`` (an .npz with ``mix`` [B, T,
    F, 2]): ``DaNet.separate_sp`` with ``sp_attn`` and ``halo`` -> ``y``;
  * ``sp_conv``: the case's model (its ``keys``: ENCODER_TYPE or
    MODEL_TYPE and the widths), ``params`` (an .npz of the model's tree;
    a DaNet's encoder subtree is taken) and ``x`` (an .npz with ``x``, the
    global batch: [B, T, F], or [B, L] padded waveforms for tasnet-v1):
    ``stack`` 'tcn', 'dprnn' or 'conv_bilstm' runs ``seq_parallel.
    tcn_stack_sp`` / ``dprnn_stack_sp`` / ``conv_bilstm_sp`` with the
    encoder's dims (``remat``, ``keep`` with a generator of ``seed``, the
    batch co-sharded over 'data' when it divides), 'tasnet' ``TasNet.
    _forward_sp`` -> ``y`` (this rank's block; tasnet-v1's whole output),
    ``y_nograd``, ``rows``, ``cols``, ``grads/<leaf>`` of sum(y^2) summed
    over the ranks that split it (whole), ``dx`` (whole), the kernels'
    ``launches/<kernel>`` of the forward and backward ('sum_parts' and
    'leave_sum', no ``params``: x's chunk times that collective of its
    rows' partial sums, ``collectives.sum_parts``' check); with
    ``separate_wav`` (a model case), ``model.separate_wav`` of ``x`` under
    the mesh instead -> ``y`` (whole) and the launches;
  * ``kernels`` (a card): kernels B, 2 and 3 on a rank's rows, ``T``,
    ``rows``, ``H`` (300 by default), ``dtype`` (float32 by default),
    against their plain versions at ``tol``
    ({kernel: [atol, rtol]}) -> ``err/<kernel>`` (the max abs error) and
    ``ratio/<kernel>`` (the max of |error| / (atol + rtol |plain|): at
    most 1 within the tolerance).

``multichip`` (``--device cpu --set KEY=VALUE --dims H,L``: a narrow
rehearsal over gloo on the CPU) runs ``--config`` (configs/multichip.json
by default) as written, with the ``--set`` keys over it, on a 4-card mesh
per ``--mesh`` AxB: MESH_DATA A times B on the other axis the config or
its ``--set`` keys set above 1 (MESH_MODEL, MESH_PIPE, MESH_EXPERT or
MESH_SEQ, ``strategy_key``; e.g. ``--config configs/dprnn.json --set
DPRNN_HOP=64 --set MESH_SEQ=4`` meshes over 'seq'); a config on WSJ0,
which the repository does not hold, takes the synth-speech corpus. Each
rank (``kind: multichip``) reports its bytes of params and moments at
rest, its LSTM kernels' launches in one eager step and that step's peak
device memory above the state (on a card), the ms per step of eager
steps and of a K=8 CUDA graph (a capture that fails is recorded, and the
eager numbers stand), NCCL's share of the device time of one traced
graph replay, the first ``--steps`` losses, a digest of its parameter
slices and a checkpoint of the mesh; then this process takes the same
steps on one card from the same weights and batches, times that card's
eager and K=8 steps at the same global batch, loads the mesh's
checkpoint, and prints one JSON line per mesh (a mesh that fails prints
its error, and the next runs).
"""
from __future__ import annotations

import argparse
import faulthandler
import hashlib
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

from danet_tpu_torch import weights
from danet_tpu_torch.hparams import load_config
from danet_tpu_torch.ops import rnn
from danet_tpu_torch.ops.cuda import gru as cuda_gru
from danet_tpu_torch.ops.cuda import lstm as cuda_lstm
from danet_tpu_torch.parallel import collectives, multihost, sharding
from danet_tpu_torch.weights import leaf_names, leaves

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LSTM_KERNELS = {"bilstm_scan": cuda_lstm.bilstm_scan,
                "bilstm_scan_train": cuda_lstm.bilstm_scan_train,
                "bilstm_scan_bwd": cuda_lstm.bilstm_scan_bwd,
                "lstm_scan": cuda_lstm.lstm_scan,
                "lstm_scan_train": cuda_lstm.lstm_scan_train,
                "lstm_scan_bwd": cuda_lstm.lstm_scan_bwd,
                "lstm_scan_train_state": cuda_lstm.lstm_scan_train_state,
                "lstm_scan_bwd_seeded": cuda_lstm.lstm_scan_bwd_seeded,
                "gru_scan": cuda_gru.gru_scan,
                "gru_scan_train": cuda_gru.gru_scan_train,
                "gru_scan_bwd": cuda_gru.gru_scan_bwd}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(spec_path: str, out: str, nproc: int, device: str = "cpu",
           backend=None, shared_card: bool = False,
           timeout: float = 600.0) -> None:
    """Run the spec on ``nproc`` ranks (see the module's docstring);
    raises RuntimeError with the failing ranks' last lines."""
    os.makedirs(out, exist_ok=True)
    port = str(_free_port())
    procs = []
    for r in range(nproc):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(nproc),
                   LOCAL_RANK=str(0 if shared_card else r),
                   LOCAL_WORLD_SIZE=str(nproc), MASTER_ADDR="localhost",
                   MASTER_PORT=port,
                   DANET_SMOKE_STACKS_AFTER=str(max(timeout - 20.0, 1.0)))
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [sys.executable, "-m", "danet_tpu_torch.parallel.smoke",
               "worker", "--spec", os.path.abspath(spec_path),
               "--out", os.path.abspath(out), "--device", device]
        if backend:
            cmd += ["--backend", backend]
        log = open(os.path.join(out, "rank%d.log" % r), "w")
        procs.append((subprocess.Popen(
            cmd, env=env, cwd=os.path.dirname(os.path.abspath(spec_path)),
            stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for r in bad:
            with open(os.path.join(out, "rank%d.log" % r)) as f:
                tails.append("rank %d (exit %s):\n%s" % (
                    r, procs[r][0].returncode, f.read()[-3000:]))
        raise RuntimeError("smoke ranks failed:\n" + "\n".join(tails))


def load_results(out: str, nproc: int) -> list:
    """Each rank's results: a list of {key: array}."""
    res = []
    for r in range(nproc):
        with np.load(os.path.join(out, "rank%d.npz" % r)) as d:
            res.append({k: d[k] for k in d.files})
    return res


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def build(case: dict):
    """(hp, model) of a case: default.json, its ``configs`` and ``keys``;
    ``dims`` narrows the recurrent encoder's HDIM and N_LAYERS."""
    hp = load_config(*[os.path.join(REPO, c) for c in case.get("configs",
                                                               ())],
                     **case.get("keys", {}))
    if case.get("dims"):
        enc = hp.get_encoder()
        enc.HDIM, enc.N_LAYERS = case["dims"]
    return hp, hp.get_model()(hp)


def _trainer(case: dict, device: str, out: str):
    """(hp, trainer) on the case's connected mesh; None for a rank outside
    it (which still takes part in the groups' construction)."""
    from danet_tpu_torch.train.trainer import Trainer
    hp, model = build(case)
    mesh = sharding.mesh_from_hparams(hp).connect()
    if mesh.coords is None:
        return hp, None
    return hp, Trainer(model, hp, device, name=case["name"],
                       save_dir=os.path.join(out, "saves"), mesh=mesh)


def _init(tr, case: dict):
    params = weights.load_npz(case["params"]) if case.get("params") \
        else None
    return tr.init_state(torch.Generator().manual_seed(case.get("seed", 0)),
                         params=params)


def _whole(tr, tensors) -> dict:
    """{leaf name: whole array} of a list aligned with the params."""
    full = tr.full_params(sharding.nest(tr.leaf_names, list(tensors)))
    return {n: t.detach().float().cpu().numpy().copy()
            for n, t in zip(tr.leaf_names, leaves(full))}


def _bytes(state: dict) -> int:
    opt = state["opt"]
    ts = leaves(state["params"]) + list(opt.mu or []) + list(opt.nu or [])
    if state.get("ema") is not None:
        ts += leaves(state["ema"])
    return int(sum(t.numel() * t.element_size() for t in ts))


def _zero_launches() -> None:
    for fn in LSTM_KERNELS.values():
        fn.launches = 0


def _launches() -> dict:
    return {n: fn.launches for n, fn in LSTM_KERNELS.items()}


def case_step(case: dict, device: str, out: str) -> dict:
    _, tr = _trainer(case, device, out)
    if tr is None:
        return {}
    state = _init(tr, case)
    res = {}
    if case.get("init"):
        state = tr.load_params(state, case["init"])
        res.update({"loaded/" + k: v for k, v in _whole(
            tr, leaves(state["params"])).items()})
    with np.load(case["batch"]) as d:
        src = d["src"]
    rows = sharding.batch_rows(tr.mesh, src.shape[0])
    m, g = tr.loss_and_grads(state["params"], tr.ingest(src), None)
    res.update({"loss": float(m["loss"]), "SNR": float(m["SNR"]),
                "rows": [rows.start, rows.stop], "bytes": _bytes(state)})
    res.update({"grads/" + k: v for k, v in _whole(tr, g).items()})
    if case.get("adam"):
        _zero_launches()
        step = tr.train_step(state, src)
        if case.get("valid"):
            tr.valid_step(state, src)
        res["step_loss"] = float(step["loss"])
        res.update({"launches/" + k: v for k, v in _launches().items()})
        res.update({"params/" + k: v for k, v in _whole(
            tr, leaves(state["params"])).items()})
        if state["opt"].mu is not None:
            res.update({"mu/" + k: v for k, v in _whole(
                tr, state["opt"].mu).items()})
    if case.get("save"):
        tr.save_params(state, os.path.join(out, "saves", case["name"]))
    return res


def case_bilstm_tp(case: dict, device: str, out: str) -> dict:
    hp, _ = build(case)
    mesh = sharding.mesh_from_hparams(hp).connect()
    if mesh.coords is None:
        return {}
    layer = weights.load_npz(case["params"], device)
    axes = sharding.model_axes(layer, mesh)
    shards = sharding.shard_params(mesh, layer)
    full = sharding.gather_params(mesh, shards, axes)
    exact = all(torch.equal(a, b) for a, b in zip(leaves(full),
                                                  leaves(layer)))
    ps = [p.detach().clone().requires_grad_(True) for p in leaves(full)]
    full = sharding.nest(leaf_names(layer), ps)
    with np.load(case["x"]) as d:
        x_all = d["x"]
    rows = sharding.batch_rows(mesh, x_all.shape[0])
    x = torch.from_numpy(x_all[rows]).to(device)
    y = rnn.bilstm_apply_tp(full, x, mesh, "tanh",
                            backend=case.get("backend", "pallas"))
    grads = torch.autograd.grad(torch.sum(torch.sin(y)), ps)
    grads = collectives.reduce_grads(mesh, list(grads), axes)
    grads = [g * mesh.size for g in grads]       # the sum over the ranks
    whole = collectives.gather_leaves(mesh, grads, axes)
    res = {"y": y.detach().cpu().numpy(), "rows": [rows.start, rows.stop],
           "gathered_exact": exact}
    res.update({"grads/" + n: g.cpu().numpy()
                for n, g in zip(leaf_names(layer), whole)})
    return res


class _Recorder:
    """A metrics writer that keeps the rows in memory."""

    run_dir = None

    def __init__(self):
        self.rows = {"train": [], "valid": []}

    def scalars(self, prefix: str, values: dict, step: int) -> None:
        self.rows[prefix].append(float(values["loss"]))

    def close(self) -> None:
        pass


def case_train(case: dict, device: str, out: str) -> dict:
    hp, tr = _trainer(case, device, out)
    if tr is None:
        return {}
    state = _init(tr, case)
    res = {}
    if case.get("init"):
        state = tr.load_params(state, case["init"])
        res.update({"loaded/" + k: v for k, v in _whole(
            tr, leaves(state["params"])).items()})
    ds = hp.get_dataset()(hp, seed=0)
    ds.install_and_load()
    rec = _Recorder()
    if case.get("signal_at"):
        # SIGTERM to this process after the given step on the given rank
        rank, at = case["signal_at"]
        step = tr.train_step

        def train_step(state, batch):
            out = step(state, batch)
            if dist.get_rank() == rank and state["step"] == at:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        tr.train_step = train_step
    state = tr.train(case.get("epochs", 2), ds, save_on_epoch=True,
                     valid_on_epoch=True, state=state, seed=0, writer=rec)
    whole = _whole(tr, leaves(state["params"]))
    res.update({"train_loss": rec.rows["train"],
                "valid_loss": rec.rows["valid"],
                "lr": tr.get_learn_rate(state), "step": state["step"],
                "epoch": state["epoch"],
                "checksum": float(sum(np.sum(np.abs(v.astype(np.float64)))
                                      for v in whole.values()))})
    res.update({"params/" + k: v for k, v in whole.items()})
    return res


def case_dropout(case: dict, device: str, out: str) -> dict:
    from danet_tpu_torch.ops.nn import dropout_mask
    _, tr = _trainer(case, device, out)
    if tr is None:
        return {}
    gen = _init(tr, case)["generator"]
    seed = gen.initial_seed()
    mask = dropout_mask(gen, (64,), 0.5, device)
    return {"seed": np.uint64(seed), "mask": mask.cpu().numpy()}


def case_kernels(case: dict, device: str, out: str) -> dict:
    """Kernels B, 2 and 3 at a rank's layer shapes (``T``, ``rows`` and
    ``H``, bilstm-orig's 300 by default) against their plain versions
    (``dtype``, float32 by default; tanh candidate, layer-shaped
    inputs)."""
    t, b, h = case.get("T", 128), case.get("rows", 16), case.get("H", 300)
    dt = getattr(torch, case.get("dtype", "float32"))
    rs = np.random.RandomState(1000 + dist.get_rank())
    scale = 0.75 / np.sqrt(h)
    x = rs.randn(t, 2, b, 2 * h).astype(np.float32) * 0.5
    wx = rs.uniform(-scale, scale, (2, 2 * h, 4 * h)).astype(np.float32)
    bias = np.repeat(np.array([0.0, 1.5, -1.0, 1.0], np.float32), h)
    xp = np.einsum("tdbi,dig->tdbg", x, wx) + bias
    wh = rs.uniform(-scale, scale, (2, h, 4 * h)).astype(np.float32)
    z = np.zeros((2, b, h), np.float32)
    d_hs = rs.randn(t, 2, b, h).astype(np.float32) * 0.1
    xp, wh, z, d_hs = (torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dt) for a in (xp, wh, z, d_hs))

    res = {}

    def check(name, got, want):
        atol, rtol = case["tol"][name]
        diff = [torch.abs(u.float() - v.float()) for u, v in zip(got, want)]
        res["err/" + name] = max(float(torch.max(d)) for d in diff)
        res["ratio/" + name] = max(float(torch.max(
            d / (atol + rtol * torch.abs(v.float()))))
            for d, v in zip(diff, want))

    check("bilstm_scan", [cuda_lstm.bilstm_scan(xp, wh, z, z, True)],
          [cuda_lstm.bilstm_scan_plain(xp, wh, z, z, True)])
    ref = cuda_lstm.bilstm_scan_train_plain(xp, wh, z, z, True)
    check("bilstm_scan_train", cuda_lstm.bilstm_scan_train(
        xp, wh, z, z, True), ref)
    hs, cs, acts = ref
    c_prev = torch.cat([z[None], cs[:-1]])
    check("bilstm_scan_bwd", cuda_lstm.bilstm_scan_bwd(
        d_hs, acts, cs, c_prev, wh, True), cuda_lstm.bilstm_scan_bwd_plain(
        d_hs, acts, cs, c_prev, wh, True))
    return res


def _epoch_batches(tr, hp, ds, n: int) -> list:
    """The first ``n`` train batches of epochs 0, 1, ... (seed 0) as the
    loop draws them, whole."""
    out = []
    for epoch in range(n):
        key = zlib.crc32(b"danet-epoch-%d-retry-%d-seed-%d" % (epoch, 0, 0))
        rng, rand = np.random.RandomState(key), random.Random(key)
        for data_pt in tr._epoch_fn(ds)(
                "train", hp.BATCH_SIZE * hp.MAX_N_SIGNAL, shuffle=True,
                rng=rng, rand=rand):
            out.append(tr._prepare(data_pt[0], hp.MAX_TRAIN_LEN, rng))
            if len(out) == n:
                return out
    raise ValueError("the dataset has fewer than %d batches" % n)


def _digest(arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:12]


def _device_ms_by_kind(prof) -> tuple:
    """(all, NCCL's) device ms of a profile's CUDA kernels."""
    total = nccl = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) is None or \
                "CUDA" not in str(e.device_type):
            continue
        ms = e.self_device_time_total / 1e3
        total += ms
        if "nccl" in e.key.lower():
            nccl += ms
    return total, nccl


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, reps: int, device: str) -> float:
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3 / reps


class _PeakStep:
    """The peak device memory of what runs inside it above what was
    allocated when it began (the step's activations and transients), on a
    card; -1 on the CPU."""

    def __init__(self, device: str):
        self.card = torch.device(device).type == "cuda"
        self.bytes = -1

    def __enter__(self):
        if self.card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.base = torch.cuda.memory_allocated()
        return self

    def __exit__(self, *exc):
        if self.card:
            torch.cuda.synchronize()
            self.bytes = torch.cuda.max_memory_allocated() - self.base


def case_multichip(case: dict, device: str, out: str) -> dict:
    hp, tr = _trainer(case, device, out)
    if tr is None:
        return {}
    n = case.get("steps", 8)
    state = tr.init_state(torch.Generator().manual_seed(0))
    ds = hp.get_dataset()(hp, seed=0)
    ds.install_and_load()
    batches = _epoch_batches(tr, hp, ds, n + 8)
    losses = [tr.train_step(state, b)["loss"] for b in batches[:n]]
    losses = torch.stack(losses).float().cpu().numpy()
    _zero_launches()
    with _PeakStep(device) as peak:
        tr.train_step(state, batches[n])
    counts = _launches()
    k1 = _timed(lambda: tr.train_step(state, batches[n]), 4, device)
    stack = tr._put(tr._host_batch(np.stack(batches[n:n + 8]),
                                   stacked=True))
    graph_error = None
    try:
        tr.train_steps(state, stack)                   # the capture
        k8 = _timed(lambda: tr.train_steps(state, stack), 3, device) / 8
    except RuntimeError as e:      # recorded: the eager numbers still count
        graph_error, k8 = str(e)[-1500:], float("nan")
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        if graph_error is None:
            tr.train_steps(state, stack)
        else:
            tr.train_step(state, batches[n])
        _sync(device)
    total, nccl = _device_ms_by_kind(prof)
    tr.save_params(state, os.path.join(out, "mesh_ckpt"))
    whole = _whole(tr, leaves(state["params"]))
    shards = [t.detach().cpu().numpy() for t in leaves(state["params"])]
    res = {"losses": losses, "ms_k1": k1, "ms_k8": k8,
           "device_ms": total, "nccl_ms": nccl, "bytes": _bytes(state),
           "peak_step_bytes": peak.bytes,
           "coords": [tr.mesh.coords[a] for a in tr.mesh.axis_names],
           "digest": _digest(shards),
           "whole_digest": _digest(whole[k] for k in sorted(whole)),
           "step": state["step"], "graph_error": graph_error or ""}
    res.update({"launches/" + k: v for k, v in counts.items()})
    return res


def _mesh(case: dict):
    """(hp, the connected mesh) of the case's keys (no model built)."""
    hp = load_config(**case.get("keys", {}))
    return hp, sharding.mesh_from_hparams(hp).connect()


def _rows(mesh, batch: int) -> slice:
    """This rank's rows of a batch of ``batch`` rows, with the mesh's row
    axes set as a Trainer sets them."""
    slices = sharding.batch_slices(mesh, batch)
    mesh.row_axes = (("data",) if slices == mesh.shape.get("data", 1)
                     else ("data", "model"))
    return sharding.batch_rows(mesh, batch)


def _summed(mesh, grads: list, owner: str) -> list:
    """Full-shape gradients of a loss summed over the rows, each rank's
    its rows' part of ``owner``'s share -> the whole batch's, on every
    rank."""
    n = len(grads)
    got = collectives.reduce_grads(mesh, list(grads), [None] * n,
                                   [owner] * n)
    return [g * sharding.row_slices(mesh) for g in got]


def case_pipeline(case: dict, device: str, out: str) -> dict:
    """``pipeline.bilstm_stack_pipelined`` on the rank's rows of ``x``
    (the npz's ``x`` [B, T, F]) with the layers of ``params`` (an npz
    tree of ``lstm<i>`` layers), ``n_micro`` microbatches (``stacked``:
    through ``stack_pipeline_params``), and the gradients of sum(sin(y))
    -> ``y``, ``y_nograd`` (the forward without autograd), ``rows``,
    ``loss`` (over the whole batch), ``grads/<leaf>`` (whole), ``dx``
    (the rows' gradient), the LSTM kernels' ``launches/<kernel>`` of the
    forward and backward."""
    from danet_tpu_torch.parallel import pipeline
    _, mesh = _mesh(case)
    if mesh.coords is None:
        return {}
    tree = weights.load_npz(case["params"], device)
    names = leaf_names(tree)
    ps = [p.detach().clone().requires_grad_(True) for p in leaves(tree)]
    tree = sharding.nest(names, ps)
    layers = [tree["lstm%d" % i] for i in range(len(tree))]
    with np.load(case["x"]) as d:
        x_all = d["x"]
    rows = _rows(mesh, x_all.shape[0])
    x = torch.from_numpy(x_all[rows]).to(device)
    dt = getattr(torch, case.get("dtype", "float32"))
    x = x.to(dt)
    run = dict(n_micro=case.get("n_micro", 4),
               backend=case.get("backend", "auto"))
    stacked = (pipeline.stack_pipeline_params(layers, mesh)
               if case.get("stacked") else None)
    with torch.no_grad():
        y0 = pipeline.bilstm_stack_pipelined(layers, x, mesh,
                                             stacked=stacked, **run)
    _zero_launches()
    x.requires_grad_(True)
    y = pipeline.bilstm_stack_pipelined(layers, x, mesh, stacked=stacked,
                                        **run)
    loss = torch.sum(torch.sin(y.float()))
    dx, *grads = torch.autograd.grad(loss, [x] + ps, allow_unused=True)
    counts = _launches()
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    grads = _summed(mesh, grads, "pipe")
    total = collectives.all_reduce(mesh, loss.detach().reshape(1), "data")
    res = {"y": y.detach().float().cpu().numpy(),
           "y_nograd": y0.float().cpu().numpy(),
           "dx": dx.float().cpu().numpy(),
           "rows": [rows.start, rows.stop], "loss": float(total[0])}
    res.update({"grads/" + n: g.float().cpu().numpy()
                for n, g in zip(names, grads)})
    res.update({"launches/" + k: v for k, v in counts.items()})
    return res


def case_moe(case: dict, device: str, out: str) -> dict:
    """``expert.moe_mlp_ep`` (``k`` 0) or ``moe_mlp_ep_routed`` (``k`` >=
    1, ``cf``), or on a mesh without an 'expert' axis ``moe_mlp_topk``
    with the global count, on the rank's rows of ``x`` (npz ``x`` [B, T,
    d]) with ``params`` (router, w_in, w_out), and the gradients of
    sum(y^2) -> ``y``, ``rows``, ``grads/<leaf>`` (whole)."""
    from danet_tpu_torch.parallel import expert
    _, mesh = _mesh(case)
    if mesh.coords is None:
        return {}
    tree = weights.load_npz(case["params"], device)
    names = leaf_names(tree)
    ps = [p.detach().clone().requires_grad_(True) for p in leaves(tree)]
    params = sharding.nest(names, ps)
    with np.load(case["x"]) as d:
        x_all = d["x"]
    rows = _rows(mesh, x_all.shape[0])
    x = torch.from_numpy(x_all[rows]).to(device)
    k, cf = case.get("k", 0), case.get("cf", 1.25)
    if "expert" not in mesh.shape:
        y = expert.moe_mlp_topk(params, x, k=k, capacity_factor=cf,
                                mesh=mesh)
        owner = None
    elif k:
        y = expert.moe_mlp_ep_routed(params, x, mesh, k=k,
                                     capacity_factor=cf)
        owner = "expert"
    else:
        y = expert.moe_mlp_ep(params, x, mesh)
        owner = "expert"
    grads = torch.autograd.grad(torch.sum(y.float() ** 2), ps)
    grads = _summed(mesh, grads, owner)
    res = {"y": y.detach().float().cpu().numpy(),
           "rows": [rows.start, rows.stop]}
    res.update({"grads/" + n: g.float().cpu().numpy()
                for n, g in zip(names, grads)})
    return res


def case_sp_stack(case: dict, device: str, out: str) -> dict:
    """The sequence-parallel recurrent stack on the mesh of the case's
    keys (the module's docstring)."""
    from danet_tpu_torch.parallel import seq_parallel
    _, mesh = _mesh(case)
    if mesh.coords is None:
        return {}
    dt = getattr(torch, case.get("dtype", "float32"))
    tree = weights.load_npz(case["params"], device)
    names = leaf_names(tree)
    ps = [p.detach().to(dt).requires_grad_(True) for p in leaves(tree)]
    tree = sharding.nest(names, ps)
    kind = case.get("rnn", "bilstm")
    pre = "lstm" if kind == "bilstm" else "gru"
    layers = [tree["%s%d" % (pre, i)] for i in range(len(tree))]
    with np.load(case["x"]) as d:
        x = torch.from_numpy(d["x"]).to(device=device, dtype=dt)
    gen = None
    if case.get("keep", 1.0) < 1.0:
        gen = torch.Generator(device).manual_seed(case.get("seed", 0))
    run = dict(halo=case.get("halo", 32), scheme=case.get("scheme", "relay"),
               remat=case.get("remat", False),
               backend=case.get("backend", "auto"), dropout_rng=gen,
               keep_prob=case.get("keep", 1.0))
    fn = (seq_parallel.bilstm_stack_sp if kind == "bilstm"
          else seq_parallel.gru_stack_sp)
    with torch.no_grad():
        y0 = fn(layers, x, mesh, **dict(run, dropout_rng=None,
                                         keep_prob=1.0))
    _zero_launches()
    x.requires_grad_(True)
    y = fn(layers, x, mesh, **run)
    dx, *grads = torch.autograd.grad(torch.sum(y.float() ** 2), [x] + ps,
                                     allow_unused=True)
    counts = _launches()
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    flat = torch.cat([g.float().reshape(-1) for g in grads])
    flat = collectives.all_reduce(mesh, flat)
    at, whole = 0, []
    for p in ps:
        whole.append(flat[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    d_axis = seq_parallel._mesh_data_axis(mesh, x.shape[0], "data")
    per = x.shape[0] // (mesh.shape["data"] if d_axis else 1)
    r0 = mesh.coords["data"] * per if d_axis else 0
    c = x.shape[1] // mesh.shape["seq"]
    t0 = mesh.coords["seq"] * c
    res = {"y": y.detach().float().cpu().numpy(),
           "y_nograd": y0.float().cpu().numpy(),
           "dx": dx.float().cpu().numpy(), "rows": [r0, r0 + per],
           "cols": [t0, t0 + c]}
    res.update({"grads/" + n: g.cpu().numpy() for n, g in zip(names, whole)})
    res.update({"launches/" + k: v for k, v in counts.items()})
    return res


def _sp_conv_run(case: dict, hp, model, mesh, tree: dict, x):
    """The ``sp_conv`` case's function of ``tree`` and ``x`` (the module's
    docstring) -> (y, the axes its gradients sum over)."""
    from danet_tpu_torch.parallel import seq_parallel
    stack = case["stack"]
    if stack == "tasnet":
        y = model._forward_sp(tree, x, mesh)
        return y, ["seq"]
    if stack in ("sum_parts", "leave_sum"):
        x_loc = collectives.enter_sharded(mesh, x, "seq", 1)
        total = getattr(collectives, stack)(
            mesh, torch.sum(x_loc, dim=(1, 2), keepdim=True), "seq")
        return x_loc * total, ["seq"]
    enc = model.encoder
    gen = None
    if case.get("keep", 1.0) < 1.0:
        gen = torch.Generator(x.device).manual_seed(case.get("seed", 0))
    run = dict(dropout_rng=gen, keep_prob=case.get("keep", 1.0),
               remat=case.get("remat", False))
    if stack == "tcn":
        _, _, k, _, _, causal = enc._dims()
        y = seq_parallel.tcn_stack_sp(
            tree, x, mesh, [enc._dilation(i) for i in range(enc._n_blocks())],
            k, causal, hp.RELU_LEAKAGE, **run)
    elif stack == "dprnn":
        _, _, p, _, n_blocks, inter_causal = enc._dims()
        y = seq_parallel.dprnn_stack_sp(
            tree, x, mesh, p, n_blocks, inter_causal,
            backend=case.get("backend", "auto"), **run)
    else:
        y = seq_parallel.conv_bilstm_sp(
            tree, x, mesh, hp.FFT_SIZE, hp.FEATURE_SIZE, hp.EMBED_SIZE,
            hp.RELU_LEAKAGE, "tanh", **run)
    d_axis = seq_parallel._mesh_data_axis(mesh, x.shape[0], "data")
    return y, ["seq"] + ([d_axis] if d_axis else [])


def case_sp_conv(case: dict, device: str, out: str) -> dict:
    """The convolutional and dual-path sequence-parallel stacks and
    tasnet-v1's forward on the case's mesh (the module's docstring)."""
    hp, model = build(case)
    mesh = sharding.mesh_from_hparams(hp).connect()
    if mesh.coords is None:
        return {}
    dt = getattr(torch, case.get("dtype", "float32"))
    tree = weights.load_npz(case["params"], device) \
        if case.get("params") else {}
    if case["stack"] != "tasnet":
        tree = tree.get("encoder", tree)
    names = leaf_names(tree)
    ps = [p.detach().to(dt).requires_grad_(True) for p in leaves(tree)]
    tree = sharding.nest(names, ps)
    with np.load(case["x"]) as d:
        x = torch.from_numpy(d["x"]).to(device=device, dtype=dt)
    if case.get("separate_wav"):
        sharding.set_active_mesh(mesh)
        _zero_launches()
        try:
            with torch.no_grad():
                y = model.separate_wav(tree, x)
        finally:
            sharding.set_active_mesh(None)
        return {"y": y.float().cpu().numpy(),
                **{"launches/" + k: v for k, v in _launches().items()}}
    with torch.no_grad():
        y0, _ = _sp_conv_run(dict(case, keep=1.0), hp, model, mesh, tree, x)
    _zero_launches()
    x.requires_grad_(True)
    y, axes = _sp_conv_run(case, hp, model, mesh, tree, x)
    dx, *grads = torch.autograd.grad(torch.sum(y.float() ** 2), [x] + ps,
                                     allow_unused=True)
    counts = _launches()
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    flat = torch.cat([g.float().reshape(-1) for g in grads] + [
        torch.zeros(0, device=x.device)])
    for axis in axes:
        flat = collectives.all_reduce(mesh, flat, axis)
    at, whole = 0, []
    for p in ps:
        whole.append(flat[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    whole_out = case["stack"] == "tasnet"
    per = x.shape[0] // (mesh.shape["data"] if "data" in axes else 1)
    r0 = mesh.coords["data"] * per if "data" in axes else 0
    c = x.shape[1] // (1 if whole_out else mesh.shape["seq"])
    t0 = 0 if whole_out else mesh.coords["seq"] * c
    res = {"y": y.detach().float().cpu().numpy(),
           "y_nograd": y0.float().cpu().numpy(),
           "dx": dx.float().cpu().numpy(), "rows": [r0, r0 + per],
           "cols": [t0, t0 + c]}
    res.update({"grads/" + n: g.cpu().numpy() for n, g in zip(names, whole)})
    res.update({"launches/" + k: v for k, v in counts.items()})
    return res


def case_sp_attention(case: dict, device: str, out: str) -> dict:
    """Ring or Ulysses attention on the case's mesh (the module's
    docstring)."""
    from danet_tpu_torch.parallel import ring_attention, ulysses
    _, mesh = _mesh(case)
    if mesh.coords is None:
        return {}
    with np.load(case["x"]) as d:
        qkv = [torch.from_numpy(d[n]).to(device).requires_grad_(True)
               for n in ("q", "k", "v")]
        mask = torch.from_numpy(d["mask"]).to(device)
    fn = (ring_attention.ring_attention if case["pattern"] == "ring"
          else ulysses.ulysses_attention)
    y = fn(*qkv, mesh, key_mask=mask, causal_window=case.get("window", 0))
    grads = torch.autograd.grad(torch.sum(torch.sin(y)), qkv)
    res = {"y": y.detach().cpu().numpy()}
    res.update({"grads/" + n: g.cpu().numpy()
                for n, g in zip("qkv", grads)})
    return res


def case_separate_sp(case: dict, device: str, out: str) -> dict:
    """``DaNet.separate_sp`` of the case's model on its mesh."""
    hp, model = build(case)
    mesh = sharding.mesh_from_hparams(hp).connect()
    if mesh.coords is None:
        return {}
    params = weights.load_npz(case["params"], device)
    with np.load(case["mix"]) as d:
        mix = torch.from_numpy(d["mix"]).to(device)
    with torch.no_grad():
        y = model.separate_sp(params, mix, mesh, halo=case.get("halo", 32),
                              sp_attn=case.get("sp_attn", "ring"))
    return {"y": y.cpu().numpy()}


CASES = {"step": case_step, "bilstm_tp": case_bilstm_tp,
         "train": case_train, "dropout": case_dropout,
         "kernels": case_kernels, "multichip": case_multichip,
         "pipeline": case_pipeline, "moe": case_moe,
         "sp_stack": case_sp_stack, "sp_attention": case_sp_attention,
         "separate_sp": case_separate_sp, "sp_conv": case_sp_conv}


def worker(spec_path: str, out: str, device: str, backend=None) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    # a rank still running near the launcher's timeout writes every
    # thread's stack to its log, so that a hang shows where it waits
    faulthandler.dump_traceback_later(
        float(os.environ.get("DANET_SMOKE_STACKS_AFTER", 600.0)))
    if device == "cpu":
        torch.set_num_threads(int(spec.get("threads", 1)))
    if not multihost.initialize(device, backend):
        raise RuntimeError("smoke worker: no process group in the "
                           "environment (start it with 'run')")
    rank = dist.get_rank()
    results = {}
    try:
        for case in spec["cases"]:
            for k, v in CASES[case["kind"]](case, device, out).items():
                results["%s/%s" % (case["name"], k)] = np.asarray(v)
            print("rank %d: %s done" % (rank, case["name"]), flush=True)
        np.savez(os.path.join(out, "rank%d.npz" % rank), **results)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# configs/multichip.json on four cards
# ---------------------------------------------------------------------------

MULTICHIP_KEYS = {"DATASET_TYPE": "synth-speech", "WAVE_PCM_SCALE": 4.0}


def _one_card(case: dict, out: str, n: int, device: str) -> dict:
    """The mesh case's steps on one card (no mesh) from the same weights
    and batches (padded to the mesh's time bucket: a sequence-parallel
    mesh's ``effective_bucket`` rounds T up to whole chunks), and the
    mesh's checkpoint loaded on one card."""
    from danet_tpu_torch.train.trainer import Trainer, effective_bucket
    mesh_hp = load_config(*[os.path.join(REPO, c) for c in case.get(
        "configs", ())], **case["keys"])
    keys = dict(case["keys"], MESH_DATA=1, MESH_MODEL=1, MESH_PIPE=1,
                MESH_EXPERT=1, MESH_SEQ=1,
                TIME_BUCKET=effective_bucket(mesh_hp))
    hp, model = build(dict(case, keys=keys))
    tr = Trainer(model, hp, device, name="one-card",
                 save_dir=os.path.join(out, "saves"))
    state = tr.init_state(torch.Generator().manual_seed(0))
    ds = hp.get_dataset()(hp, seed=0)
    ds.install_and_load()
    batches = _epoch_batches(tr, hp, ds, n + 8)
    losses = torch.stack([tr.train_step(state, b)["loss"]
                          for b in batches[:n]]).float().cpu().numpy()
    with _PeakStep(device) as peak:
        tr.train_step(state, batches[n])
    k1 = _timed(lambda: tr.train_step(state, batches[n]), 4, device)
    stack = tr._put(tr._host_batch(np.stack(batches[n:n + 8]),
                                   stacked=True))
    tr.train_steps(state, stack)                       # the capture
    k8 = _timed(lambda: tr.train_steps(state, stack), 3, device) / 8
    fresh = tr.init_state(torch.Generator().manual_seed(1))
    fresh = tr.load_params(fresh, os.path.join(out, "mesh_ckpt"))
    loaded = {k: v.detach().float().cpu().numpy() for k, v in zip(
        leaf_names(fresh["params"]), leaves(fresh["params"]))}
    return {"losses": losses, "ms_k1": k1, "ms_k8": k8,
            "peak_step_bytes": peak.bytes,
            "loaded_digest": _digest(loaded[k] for k in sorted(loaded)),
            "loaded_step": fresh["step"]}


def strategy_key(config: str, keys=None) -> str:
    """The MESH_* key besides MESH_DATA that a config, with ``keys`` (the
    ``--set`` pairs) laid over it, sets above 1 (MESH_MODEL when none):
    the second factor of ``--mesh``."""
    with open(os.path.join(REPO, config)) as f:
        cfg = dict(json.load(f), **(keys or {}))
    for key in ("MESH_MODEL", "MESH_PIPE", "MESH_EXPERT", "MESH_SEQ"):
        if int(cfg.get(key, 1) or 1) > 1:
            return key
    return "MESH_MODEL"


def multichip(out: str, meshes: list, steps: int, timeout: float,
              device: str = "cuda", keys=None, dims=None,
              config: str = "configs/multichip.json") -> None:
    """``config`` per mesh (the module's docstring): a mesh AxB is
    MESH_DATA A times B on the config's other axis (``strategy_key``);
    ``keys`` and ``dims`` narrow it, and ``device`` 'cpu' runs it over
    gloo, for a rehearsal of the four-card run on the CPU."""
    smi = "the CPU" if device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    axis_key = strategy_key(config, keys)
    with open(os.path.join(REPO, config)) as f:
        wsj0 = json.load(f).get("DATASET_TYPE") == "wsj0"
    failed = []
    for mesh in meshes:
        try:
            _multichip_mesh(out, mesh, steps, timeout, device, keys, dims,
                            config, axis_key, wsj0, smi)
        except (RuntimeError, AssertionError) as e:
            # the next meshes still run; the command fails at the end
            failed.append(mesh)
            print(json.dumps({"config": config, "mesh": mesh,
                              "error": str(e)[-4000:]}), flush=True)
    if failed:
        raise SystemExit("multichip: meshes %s failed" % failed)


def _multichip_mesh(out, mesh, steps, timeout, device, keys, dims, config,
                    axis_key, wsj0, smi) -> None:
    """One mesh of ``multichip``: its ranks, the one-card reference, the
    checks, one JSON line."""
    n_data, n_axis = (int(v) for v in mesh.split("x"))
    nproc = n_data * n_axis
    sub = os.path.join(out, "mesh_%s" % mesh)
    os.makedirs(sub, exist_ok=True)
    case = {"name": "multichip", "kind": "multichip", "steps": steps,
            "configs": [config], "dims": dims,
            "keys": dict(MULTICHIP_KEYS if wsj0 else {}, **dict(
                keys or {}, MESH_DATA=n_data, **{axis_key: n_axis}))}
    spec = os.path.join(sub, "spec.json")
    with open(spec, "w") as f:
        json.dump({"cases": [case]}, f)
    t0 = time.perf_counter()
    launch(spec, sub, nproc, device=device, timeout=timeout)
    mesh_s = time.perf_counter() - t0
    ranks = [{k.split("/", 1)[1]: v for k, v in r.items()}
             for r in load_results(sub, nproc)]
    ref = _one_card(case, sub, steps, device)
    replicas = {}
    for r in ranks:
        replicas.setdefault(tuple(int(c) for c in r["coords"][1:]),
                            set()).add(str(r["digest"]))
    if any(len(d) != 1 for d in replicas.values()):
        raise AssertionError("%s: the data replicas' parameters differ: "
                             "%s" % (mesh, replicas))
    if any(str(r["whole_digest"]) != str(ranks[0]["whole_digest"])
           for r in ranks):
        raise AssertionError("%s: the ranks gather different weights"
                             % mesh)
    if str(ref["loaded_digest"]) != str(ranks[0]["whole_digest"]):
        raise AssertionError("%s: the mesh's checkpoint loads on one "
                             "card as other weights" % mesh)
    rel = np.abs(ranks[0]["losses"] - ref["losses"]) / np.abs(
        ref["losses"])
    # a routed MoE's expert mesh routes each T-shard with its own capacity
    # (JAX's moe_mlp_ep_routed), one card the whole batch: other values
    routed = "MESH_EXPERT" == axis_key and int(
        case["keys"].get("MOE_TOP_K", 0) or 0) > 0
    if not np.all(np.isfinite(ranks[0]["losses"])) or (
            rel[0] > 1e-2 and not routed):
        raise AssertionError("%s: step-1 loss %r vs one card %r"
                             % (mesh, ranks[0]["losses"][0],
                                ref["losses"][0]))
    print(json.dumps({
        "config": config, "mesh": mesh, "axes": "MESH_DATA x %s"
        % axis_key, "card": smi, "world": nproc,
        "bytes_at_rest": [int(r["bytes"]) for r in ranks],
        "ms_per_step_k1": [float(r["ms_k1"]) for r in ranks],
        "ms_per_step_k8_graph": [float(r["ms_k8"]) for r in ranks],
        "nccl_share": [float(r["nccl_ms"]) / max(float(r["device_ms"]),
                                                 1e-9) for r in ranks],
        "launches_per_step": [
            {k.split("/", 1)[1]: int(v) for k, v in r.items()
             if k.startswith("launches/") and int(v)} for r in ranks],
        "graph_errors": sorted({str(r["graph_error"]) for r in ranks
                                if str(r["graph_error"])}),
        "peak_step_bytes": [int(r["peak_step_bytes"]) for r in ranks],
        "one_card_peak_step_bytes": int(ref["peak_step_bytes"]),
        "one_card_ms_per_step_k1": float(ref["ms_k1"]),
        "one_card_ms_per_step_k8_graph": float(ref["ms_k8"]),
        "losses_mesh": [float(v) for v in ranks[0]["losses"]],
        "losses_one_card": [float(v) for v in ref["losses"]],
        "loss_rel_diff": [float(v) for v in rel],
        "replica_digests": {"x".join(map(str, k)): sorted(v)
                            for k, v in replicas.items()},
        "checkpoint": "written on the mesh at step %d, loaded on one "
                      "card: digest %s" % (int(ref["loaded_step"]),
                                           ref["loaded_digest"]),
        "mesh_seconds": mesh_s}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m danet_tpu_torch.parallel."
                                      "smoke")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("run", "worker"):
        p = sub.add_parser(name)
        p.add_argument("--spec", required=True)
        p.add_argument("--out", required=True)
        p.add_argument("--device", default="cpu")
        p.add_argument("--backend", default=None)
        if name == "run":
            p.add_argument("--nproc", type=int, required=True)
            p.add_argument("--shared-card", action="store_true")
            p.add_argument("--timeout", type=float, default=600.0)
    mc = sub.add_parser("multichip")
    mc.add_argument("--out", required=True)
    mc.add_argument("--config", default="configs/multichip.json",
                    help="the config file, relative to the repository")
    mc.add_argument("--mesh", action="append", default=[])
    mc.add_argument("--steps", type=int, default=8)
    mc.add_argument("--timeout", type=float, default=900.0)
    mc.add_argument("--device", default="cuda")
    mc.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="a config key (a JSON value, else a string)")
    mc.add_argument("--dims", default=None,
                    help="HDIM,N_LAYERS of the recurrent encoder")
    args = ap.parse_args(argv)
    if args.cmd == "worker":
        worker(args.spec, args.out, args.device, args.backend)
    elif args.cmd == "run":
        launch(args.spec, args.out, args.nproc, args.device, args.backend,
               args.shared_card, args.timeout)
    else:
        keys = {}
        for pair in args.set:
            k, v = pair.split("=", 1)
            try:
                keys[k] = json.loads(v)
            except ValueError:
                keys[k] = v           # a bare string, as the CLI's --set
        multichip(args.out, args.mesh or ["2x2", "4x1"], args.steps,
                  args.timeout, args.device, keys,
                  [int(v) for v in args.dims.split(",")] if args.dims
                  else None, args.config)


if __name__ == "__main__":
    main()
