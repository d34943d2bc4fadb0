"""Training loop: batch preparation, the wire, the train and valid steps,
K steps per call, and the epoch loop.

Counterpart of ``danet_tpu/train/trainer.py``: ``prefetch_to_device``
(:68-118), ``prepare_batch`` (:143-169), ``prepare_batch_wave``
(:172-220), ``Trainer`` with its wire and steps (:223-582), the learning
rate (:584-588), the hang watchdog (:661-710), ``train`` (:738-1103) and
the valid sweep (:1106-1144).  The JAX trainer jits one fused step; here a
step runs eagerly on ``device``: ingest, forward, backward (autograd,
through the kernels' autograd Functions), clip, update in place.

The wire (TRANSFER_DOMAIN, TRANSFER_DTYPE, WAVE_PCM_SCALE): a prepared
batch is either ri spectra [B, N, T, F, 2] or, on the wave wire, waveforms
[B, N, S] whose STFT runs on the device (kernel A, ``ops/cuda/stft.py``,
under STFT_BACKEND 'auto' or 'pallas'; the plain framing and matmul under
'xla').  The host casts a train batch to bfloat16 (round to nearest even)
or, on the wave wire, to int16 PCM (``clip(round(x * 32768 / scale))``);
eval sweeps ship float32.  On the device the batch is upcast, int16
dequantised by ``scale / 32768``, then transformed.

The loop: a daemon thread prepares the batches (crop, pad, stack, wire
cast) into pinned host buffers, and the main thread copies each without
blocking (``prefetch_to_device``, ``PinnedStaging``).
TRAIN_STEPS_PER_CALL = K > 1 stacks K batches of one shape into one
transfer and one call, which on the card replays a CUDA graph of K whole
steps (captured once per input shape and K; ``train_steps``); a group
whose shape changes and the epoch's remainder run as single steps.  The
per-step metrics stay on the device and are fetched once every
METRICS_EVERY steps; every row goes to the epoch report and to the metric
files (``train/metrics.py``).  WATCHDOG_SECS > 0 exits the process with
WATCHDOG_EXIT_CODE when no step, valid batch or metric fetch has finished
for that long.  PROFILE_STEPS = N > 0 traces N train steps with
``torch.profiler`` (``ProfileWindow``): from the first call at or after
the train call's starting step + 3, whole K-step calls, CPU activity and,
on the card, CUDA activity, into ``<run dir>/profile/trace.json``; a call
that captures a new K-step graph stays out of the window.  The trace names
the loop's stages with the spans of ``danet_tpu_torch/spans.py``: the
main thread's wait for a batch, its copy, each call, replay or eager step
(the model's stages inside an eager step) and each metrics fetch, and the
prefetch thread's wire casts.

The step options: GRAD_ACCUM = A splits a batch into A microbatches and
takes one update on their summed gradient times 1/A; EMA_DECAY keeps an
exponential average of the parameters (``state["ema"]``), which the valid
sweep, ``test`` and ``separate`` run on; both run in the eager step and in
the K-step graph.  NAN_CHECKS raises FloatingPointError at the first step
whose loss or gradient is not finite (and runs single steps).  REMAT
recomputes the encoder's layers in the backward (``models/encoders.py``).

The mesh (MESH_DATA, MESH_MODEL, MESH_PIPE, MESH_EXPERT, MESH_SEQ;
``parallel/``): one process per card, in a ``torch.distributed`` group
(``python -m torch.distributed.run``; a mesh of more than one process
without a group raises).  Each rank stages only its rows of every batch
(``sharding.batch_rows``: the ranks of one 'pipe', 'expert' or 'seq'
group share theirs), holds only its slice of each sharded leaf ('model',
and the MoE experts on 'expert') with that leaf's moments and EMA,
gathers the full weights once per step, runs the model on its rows (a
pipeline stage its layers, an expert group its experts, a 'seq' rank its
T-chunk of the encoder's stack or attention, ``parallel/pipeline.py``,
``expert.py``, ``seq_parallel.py``; the kernels as on one card), and
reduces the gradients to
the global batch's mean at its slices, each leaf by the axis that owns
its gradient (``parallel/collectives.py``, ``sharding.leaf_owners``).
Every metric is the global batch's, so that every rank prints the same
numbers and takes the same decisions (the LR policy, the rollbacks,
NAN_CHECKS); a signal on any rank stops every rank at the same step
boundary.  Only rank 0 writes metric
files, traces and checkpoints, which hold every leaf whole: a checkpoint
of one mesh resumes on any other, or on one process.  The K-step CUDA
graph captures the NCCL collectives; ranks on several hosts run single
steps, as the JAX trainer does, and a group that carries card tensors over
gloo runs the K steps eagerly.

Checkpoints (``train/checkpoint.py``): ``save_on_epoch`` writes
``saves/<name>_e<k>`` after epoch k, ``save_best`` keeps
``saves/<name>_best`` on the valid loss.  A NaN epoch rolls back to the
previous epoch's checkpoint and retries with perturbed data and dropout
streams (or exits with -1 without one); VALID_CRASH_FACTOR > 0 rolls a
valid-loss spike back to the best or the previous checkpoint, at most 3
times a run; SIGTERM or SIGINT saves ``saves/<name>_preempt`` at the next
step (or K-step call) and returns.  A load copies into the state's
tensors, so that the captured graphs, which hold their addresses, stay
valid.

The data stream is reproducible: every epoch draws its batches and crops
from ``np.random.RandomState(crc32(...))``, and the random zero-pad splits
from ``random.Random(crc32(...))``, of the same (epoch, seed) key that
the JAX trainer seeds numpy's global generator with.
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
import queue
import random
import shutil
import signal
import sys
import threading
import time
import zlib
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from danet_tpu_torch import optim as optim_lib
from danet_tpu_torch import weights
from danet_tpu_torch.data import audio
from danet_tpu_torch.models.danet import STFT_BACKENDS
from danet_tpu_torch.ops import dsp
from danet_tpu_torch.ops.cuda import library
from danet_tpu_torch.parallel import collectives, multihost, sharding
from danet_tpu_torch.spans import span
from danet_tpu_torch.train import checkpoint as ckpt_lib
from danet_tpu_torch.train.metrics import MetricsWriter, NullWriter, StepTimer
from danet_tpu_torch.weights import leaf_names, leaves

# exit code of the hang watchdog (WATCHDOG_SECS), as the JAX trainer's: a
# supervisor tells "hung, relaunch" from a crash by it
WATCHDOG_EXIT_CODE = 114
WIRE_DTYPES = ("float32", "bfloat16", "int16")


def prefetch_to_device(batch_iter, put_fn, depth: int = 2):
    """Pipelined input: a daemon thread runs ``batch_iter`` (the host-side
    batch preparation) while the main thread calls ``put_fn`` on each item
    (the copy to the device) and yields its result.  Puts are bounded and
    watch a stop flag, so that a consumer that abandons the generator
    releases the worker; an exception in the worker is raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err = []
    stop = threading.Event()

    def worker():
        try:
            for item in batch_iter:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # raised on the consumer's side
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(sentinel, timeout=0.5)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            with span("danet.train.feed_wait"):
                item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield put_fn(item)
    finally:
        stop.set()


class PinnedStaging:
    """Pinned host buffers for the batch copies, by shape and dtype.  A
    buffer lent to a non-blocking copy goes back to the pool only once the
    CUDA event recorded after that copy has completed, so that the next
    batch is never written into bytes still in flight.  The pool keeps at
    most ``max_free`` idle buffers, the most recently returned (a corpus of
    variable lengths brings many shapes)."""

    def __init__(self, max_free: int = 8):
        self._free: list = []
        self._lent: list = []
        self._lock = threading.Lock()
        self.max_free = max_free

    def take(self, shape, dtype) -> torch.Tensor:
        shape = tuple(shape)
        with self._lock:
            lent = []
            for event, buf in self._lent:
                if event.query():
                    self._free.append(buf)
                else:
                    lent.append((event, buf))
            self._lent = lent
            del self._free[:-self.max_free]
            for i, buf in enumerate(self._free):
                if tuple(buf.shape) == shape and buf.dtype == dtype:
                    return self._free.pop(i)
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def to_device(self, buf: torch.Tensor, device) -> torch.Tensor:
        """A non-blocking copy of ``buf`` on the device's current stream;
        ``buf`` is lent until the copy has run."""
        out = buf.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        with self._lock:
            self._lent.append((event, buf))
        return out


def effective_bucket(hp):
    """TIME_BUCKET under sequence parallelism (JAX ``effective_bucket``,
    ``danet_tpu/train/trainer.py:121-141``): with MESH_SEQ > 1 every
    padded T must split into MESH_SEQ chunks of the encoder's
    ``sp_granularity`` frames, so the bucket rounds up to lcm(TIME_BUCKET,
    granularity x MESH_SEQ), or to that unit when unbucketed.  Both wires
    count it in frames (the wave wire's ``prepare_batch_wave`` pads the
    frame count), and the STFT of the wave wire runs before any T split.
    An encoder the registry cannot build counts granularity 1 here and
    fails where the model is built."""
    bucket = getattr(hp, "TIME_BUCKET", None)
    n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
    if n_seq > 1:
        try:
            g = int(hp.get_encoder()(hp, "bucket_probe").sp_granularity())
        except (KeyError, ValueError):
            g = 1
        unit = max(g, 1) * n_seq
        b = int(bucket or 1)
        bucket = b * unit // math.gcd(b, unit)
    return bucket


def prepare_batch(flat_spectra: np.ndarray, batch_size: int, n_signal: int,
                  max_len: Optional[int] = None,
                  bucket: Optional[int] = None,
                  rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Host-side batch prep: flat [B*N, T, F] -> ri [B, N, T', F, 2].

    Consecutive utterances form the N sources of a mixture; then a random
    crop to ``max_len`` frames (drawn from ``rng``) and zero padding up to
    a multiple of ``bucket``."""
    if flat_spectra.shape[0] != batch_size * n_signal:
        raise ValueError("got %d utterances for batch %d x %d sources"
                         % (flat_spectra.shape[0], batch_size, n_signal))
    spectra = flat_spectra.reshape(
        batch_size, n_signal, -1, flat_spectra.shape[-1])
    t = spectra.shape[2]
    if max_len is not None and t > max_len:
        if rng is None:
            raise ValueError("cropping to MAX_TRAIN_LEN needs an explicit "
                             "np.random.RandomState")
        beg = rng.randint(0, t - max_len)
        spectra = spectra[:, :, beg:beg + max_len]
        t = max_len
    if bucket:
        pad = (-t) % bucket
        if pad:
            spectra = np.pad(spectra, [(0, 0), (0, 0), (0, pad), (0, 0)])
    return audio.to_ri(spectra)


def prepare_batch_wave(flat_wave: np.ndarray, batch_size: int, n_signal: int,
                       fft_size: int, stride: int,
                       max_len: Optional[int] = None,
                       bucket: Optional[int] = None,
                       rng: Optional[np.random.RandomState] = None
                       ) -> np.ndarray:
    """Host-side prep for the wave wire: flat [B*N, S] -> [B, N, S']
    float32, the crop and the bucket counted in STFT frames, so that the
    device's STFT lands on the frame grid the spectra wire would ship.

    A crop of ``max_len`` frames (its start drawn from ``rng``) spans
    (max_len - 1) * stride samples; the bucket pads the frame count up to
    its multiple; the length snaps up to (t - 1) * stride, the shortest
    of the lengths that give t frames.  Frames padded here are the STFT of
    the zero tail, not zero frames, and a crop's edge frames see zeros,
    not the neighbouring samples: the two wires agree frame for frame only
    uncropped and unbucketed."""
    if flat_wave.shape[0] != batch_size * n_signal:
        raise ValueError("got %d utterances for batch %d x %d sources"
                         % (flat_wave.shape[0], batch_size, n_signal))
    wave = flat_wave.reshape(batch_size, n_signal, -1)
    t = dsp.stft_frame_count(wave.shape[-1], fft_size, stride)
    if max_len is not None and t > max_len:
        if rng is None:
            raise ValueError("cropping to MAX_TRAIN_LEN needs an explicit "
                             "np.random.RandomState")
        beg = rng.randint(0, t - max_len)
        span = (max_len - 1) * stride
        wave = wave[:, :, beg * stride:beg * stride + span]
        t = max_len
    if bucket:
        t = t + ((-t) % bucket)
    target = (t - 1) * stride
    if wave.shape[-1] < target:
        wave = np.pad(wave, [(0, 0), (0, 0), (0, target - wave.shape[-1])])
    return wave.astype(np.float32)


def _dict_format(di) -> str:
    return " ".join("%s=%s" % (k, v) for k, v in di.items())


def _tree_detach(tree: dict) -> dict:
    """A copy of a tree of tensors, detached, on the same device."""
    return {k: _tree_detach(v) if isinstance(v, dict)
            else v.detach().clone() for k, v in tree.items()}


def _tree_clone(tree: dict) -> dict:
    return {k: _tree_clone(v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_(v.requires_grad)
            for k, v in tree.items()}


class StepGraph:
    """A CUDA graph of K train steps and its static tensors: the wire
    batches it reads (``inp``, [K, ...]), the optimizer scalars
    (``scalars``, [K, 3]) and the per-step metrics it writes (``out``,
    [K, len(names)]).  ``StepGraph.captures`` and ``StepGraph.replays``
    count the graphs captured and the replays run, by every Trainer (as
    the kernel wrappers' ``launches`` count launches: a wrapper counts its
    launches in a graph once, at the capture)."""
    captures = 0
    replays = 0

    def __init__(self, graph, inp, scalars, out, names):
        self.graph, self.inp, self.scalars = graph, inp, scalars
        self.out, self.names = out, names


def _all_threads() -> dict:
    """``torch.profiler.profile``'s keyword that records every thread of
    the process (the prefetch thread's spans too), where this PyTorch has
    it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return {"experimental_config": _ExperimentalConfig(
            profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


class ProfileWindow:
    """PROFILE_STEPS = N > 0: one ``torch.profiler`` trace of about N train
    steps of a ``Trainer.train`` call.  It starts before the first call
    whose step is at least ``start_step`` + 3 (the first steps warm up),
    and stops after the call that takes the step count N past the step it
    started at: with K-step calls, it covers whole calls.  A call that
    captures a new K-step CUDA graph is kept out of it: the trace starts
    after such a call, or stops before one, so that no capture runs under
    the profiler.  CPU activity of every thread (where this PyTorch can
    record them all) with the port's spans (``danet_tpu_torch/spans.py``),
    and CUDA activity on the card (only there).  ``stop`` synchronizes the
    card, so that the trace holds every kernel of the window, and writes
    ``<out_dir>/trace.json`` (Chrome trace format: Perfetto,
    chrome://tracing, TensorBoard's profiler plugin)."""

    def __init__(self, steps: int, start_step: int, out_dir: str, device):
        self.steps, self.at = steps, start_step + 3
        self.dir, self.device = out_dir, torch.device(device)
        self.prof, self.started, self.path = None, None, None

    def before(self, step: int, captures: bool) -> None:
        """Called before each train call at ``step``; ``captures``: the
        call captures a new K-step graph."""
        if self.prof is not None and captures:
            self.stop(step)
        elif (self.prof is None and self.path is None and step >= self.at
              and not captures):
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts, **_all_threads())
            self.prof.start()
            self.started = step

    def after(self, step: int) -> None:
        """Called after each train call, at the step it reached."""
        if self.prof is not None and step >= self.started + self.steps:
            self.stop(step)

    def stop(self, step: int) -> None:
        """Close the trace (if one is open) and write it."""
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self.prof = self.prof, None
        prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "trace.json")
        prof.export_chrome_trace(self.path)
        sys.stdout.write("\n[profile: steps %d to %d traced into %s]\n"
                         % (self.started + 1, step, self.path))
        sys.stdout.flush()


class Trainer:
    """Owns the steps and the loop for one model on one ``device`` (the
    card unless the caller asks for the CPU).  The state is {params, opt,
    step, epoch, generator}, with ``ema`` under EMA_DECAY > 0 and, once a
    K-step call has run on the card, ``graphs``: ``opt`` holds the
    optimizer's moments and learning rate, ``generator`` draws dropout,
    ``graphs`` the captured K-step graphs, which update the state's
    tensors in place.  Checkpoints go to ``save_dir``, named after
    ``name``.

    ``mesh``: a connected ``sharding.Mesh``; by default, in a process of a
    ``torch.distributed`` group, ``mesh_from_hparams`` connected here
    (collective), and without a group no mesh (one process).  On a mesh
    the state's params, moments and EMA are this rank's slices, and the
    dropout generator is the rank's own: its row slice's (ranks that share
    their rows share their masks)."""

    def __init__(self, model, hp=None, device="cuda",
                 name: str = "UnnamedExperiment", save_dir: str = "saves",
                 mesh: Optional[sharding.Mesh] = None):
        self.hp = hp if hp is not None else model.hp
        self.model = model
        self.device = torch.device(device)
        self.name = name
        self.save_dir = save_dir
        self._check_config()
        self._setup_mesh(mesh)
        model.check_train_config()
        hp = self.hp
        domain = str(getattr(hp, "TRANSFER_DOMAIN", "spectra"))
        if domain not in ("spectra", "wave"):
            raise ValueError(
                "TRANSFER_DOMAIN=%r: expected 'spectra' or 'wave'" % domain)
        self._wave_mode = domain == "wave"
        wire_dtype = str(getattr(hp, "TRANSFER_DTYPE", "float32"))
        if wire_dtype not in WIRE_DTYPES:
            raise ValueError(
                "TRANSFER_DTYPE=%r: expected 'float32', 'bfloat16' or "
                "'int16'" % wire_dtype)
        if wire_dtype == "int16" and not self._wave_mode:
            raise ValueError(
                "TRANSFER_DTYPE='int16' is PCM quantization of the wave "
                "wire: it requires TRANSFER_DOMAIN='wave'")
        stft_backend = getattr(hp, "STFT_BACKEND", "auto") or "auto"
        if self._wave_mode and stft_backend not in STFT_BACKENDS:
            raise ValueError("Unknown STFT_BACKEND %r" % (stft_backend,))
        # frozen here, so that the host cast and the device's
        # dequantisation cannot disagree after a change of hp
        self._wire_dtype = wire_dtype
        self._pcm_scale = float(getattr(hp, "WAVE_PCM_SCALE", 1.0) or 1.0)
        self._dequant = self._pcm_scale / 32768.0
        self._stft_backend = stft_backend
        self._staging = PinnedStaging()
        self._heartbeat = time.monotonic()
        self._watchdog_on = False
        self._preempt = False

    def _check_config(self) -> None:
        """The step options, with the JAX trainer's refusals and notes:
        EMA_DECAY in [0, 1), GRAD_ACCUM dividing BATCH_SIZE, NAN_CHECKS
        forcing single steps.  REMAT is the encoders' (``_maybe_remat``):
        it takes effect in every step, the K-step graph's included."""
        hp = self.hp
        self.ema_decay = float(getattr(hp, "EMA_DECAY", 0.0) or 0.0)
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(
                "EMA_DECAY=%r must be in [0, 1)" % (self.ema_decay,))
        accum = int(getattr(hp, "GRAD_ACCUM", 1) or 1)
        if accum > 1 and hp.BATCH_SIZE % accum != 0:
            raise ValueError("GRAD_ACCUM=%d must divide BATCH_SIZE=%d"
                             % (accum, hp.BATCH_SIZE))
        if accum > 1 and float(getattr(hp, "DC_LOSS_WEIGHT", 0) or 0):
            print("[note] the raw-DC diagnostic column is unavailable under "
                  "GRAD_ACCUM>1 (fixed scan-carry structure); DC still "
                  "contributes to the loss")
        self._accum = accum
        self._nan_checks = bool(getattr(hp, "NAN_CHECKS", False))
        k = int(getattr(hp, "TRAIN_STEPS_PER_CALL", 1) or 1)
        if k > 1 and self._nan_checks:
            print("[TRAIN_STEPS_PER_CALL disabled under NAN_CHECKS — "
                  "checkify locates NaNs per single step]")
            k = 1
        self._steps_per_call = k

    def _setup_mesh(self, mesh) -> None:
        """The mesh, with the JAX trainer's check that every configured
        strategy has its axis; its collectives on the model (the DC
        share's global means) and the optimizer (the clip's global norm);
        its K-step rule."""
        hp = self.hp
        self.mesh = mesh
        if mesh is None and dist.is_initialized():
            mesh = self.mesh = sharding.mesh_from_hparams(hp).connect()
        if mesh is None:
            sharding.set_active_mesh(None)
            n = sharding.mesh_factors(hp)
            if n > 1:
                raise RuntimeError(
                    "MESH_* asks for a mesh of %d processes, but this "
                    "process is in no torch.distributed group: launch one "
                    "process per card, e.g. python -m torch.distributed.run "
                    "--nproc-per-node %d -m danet_tpu_torch -m train ... "
                    "(the port never runs a mesh on one device)" % (n, n))
            self._chief = True
            self._graphs = True
            return
        for key, axis in (("MESH_MODEL", "model"), ("MESH_PIPE", "pipe"),
                          ("MESH_EXPERT", "expert"), ("MESH_SEQ", "seq")):
            n = int(getattr(hp, key, 1) or 1)
            if n > 1 and mesh.shape.get(axis, 1) != n:
                raise ValueError(
                    "%s=%d but the trainer mesh has no matching %r axis "
                    "(%r) — build it via mesh_from_hparams or pass a "
                    "mesh carrying the configured axes"
                    % (key, n, axis, dict(mesh.shape)))
        if mesh.coords is None:
            raise RuntimeError(
                "rank %d is outside the %s mesh: it holds no part of it"
                % (mesh.rank, dict(mesh.shape)))
        slices = sharding.batch_slices(mesh, hp.BATCH_SIZE)
        rows = hp.BATCH_SIZE // slices
        # the axes the batch's rows split over (the routed MoE's global
        # capacity, the pipeline's global batch)
        mesh.row_axes = (("data",) if slices == mesh.shape.get("data", 1)
                         else ("data", "model"))
        if rows % self._accum:
            raise ValueError(
                "GRAD_ACCUM=%d must divide the %d rows of a rank (BATCH_SIZE"
                " %d over the mesh %s)" % (self._accum, rows, hp.BATCH_SIZE,
                                           dict(mesh.shape)))
        sharding.set_active_mesh(mesh)
        self.model.batch_mean = functools.partial(collectives.mean, mesh)
        self._chief = mesh.rank == 0
        # a graph captures NCCL's collectives, not gloo's staged copies
        self._graphs = self.device.type != "cuda" or mesh.nccl
        if self._steps_per_call > 1 and multihost.spans_hosts():
            print("[TRAIN_STEPS_PER_CALL disabled on multi-host — "
                  "per-host batch slicing is per-step]")
            self._steps_per_call = 1
        elif self._steps_per_call > 1 and not self._graphs:
            print("[TRAIN_STEPS_PER_CALL: K eager steps, no CUDA graph — the "
                  "group carries card tensors over gloo, staged through the "
                  "host]")

    def _rank_seed(self, seed: int) -> int:
        """The dropout seed of this rank: ``seed`` for the first row slice
        (and off a mesh), one of (seed, row slice) for the others."""
        if self.mesh is None:
            return seed
        g = sharding.row_index(self.mesh, self.hp.BATCH_SIZE)
        return seed if g == 0 else zlib.crc32(
            b"danet-dropout-%d-rows-%d" % (seed, g))

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None,
                   params: Optional[dict] = None) -> dict:
        """Fresh state: parameters drawn from ``generator`` (or a copy of
        ``params``, a tree of tensors or numpy arrays), a fresh optimizer
        at LR, a dropout generator on the device seeded from
        ``generator``, and under EMA_DECAY > 0 the EMA, a copy of the
        parameters."""
        generator = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        if params is None:
            params = self.model.init(generator, self.device)
        else:
            params = weights.from_jax(weights.to_jax(params), self.device)
        self.leaf_names = leaf_names(params)
        self._full = [(tuple(p.shape), p.dtype) for p in leaves(params)]
        self._axes = [None] * len(self._full)
        self._owners = None
        # REG_APPLY's term is whole on every rank: an owned leaf's
        # gradient sums over its owning axis, so each keeps 1 / n (none
        # without a mesh, also for a model an earlier Trainer had on one)
        self.model.reg_shares = None
        if self.mesh is not None:
            self._axes = sharding.shard_axes(params, self.mesh)
            self._owners = sharding.leaf_owners(params, self.mesh,
                                                 self.model)
            if any(self._owners):
                self.model.reg_shares = [
                    1.0 / self.mesh.shape[o] if o else 1.0
                    for o in self._owners]
            params = sharding.shard_params(self.mesh, params)
        for p in leaves(params):
            p.requires_grad_(True)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        opt = optim_lib.make_optimizer(self.hp, params)
        if any(self._axes):
            opt.norm_reduce = self._norm_reduce
        state = {"params": params, "opt": opt, "step": 0, "epoch": 0,
                 "generator": torch.Generator(self.device).manual_seed(
                     self._rank_seed(seed))}
        self._ensure_ema(state)
        return state

    def _norm_reduce(self, sq: list) -> list:
        """The clip's per-leaf sums of squares with each sharded leaf's
        summed over its axes' groups (its whole leaf's)."""
        by_axes: dict = {}
        for i, a in enumerate(self._axes):
            if a:
                by_axes.setdefault(tuple(sorted(a)), []).append(i)
        out = list(sq)
        for axes, idx in by_axes.items():
            v = torch.stack([sq[i] for i in idx])
            for axis in axes:
                v = collectives.all_reduce(self.mesh, v, axis)
            for j, i in enumerate(idx):
                out[i] = v[j]
        return out

    def full_params(self, params: dict) -> dict:
        """The full weights of a tree of this rank's slices (``params`` or
        the EMA): on a mesh its sharded leaves gathered over their axes'
        groups (collective: every rank calls it); else ``params``."""
        if self.mesh is None or not any(self._axes):
            return params
        return sharding.gather_params(self.mesh, params, self._axes)

    def _ensure_ema(self, state: dict) -> None:
        """Under EMA_DECAY > 0, a state without an EMA gets a copy of its
        parameters (the EMA starts there)."""
        if self.ema_decay and state.get("ema") is None:
            state["ema"] = _tree_detach(state["params"])

    def eval_params(self, state: dict) -> dict:
        """The weights that evaluation and inference run on: the EMA when
        the state has one, else the parameters; whole (``full_params``:
        collective on a mesh)."""
        ema = state.get("ema")
        with torch.no_grad():
            return self.full_params(ema if ema is not None
                                    else state["params"])

    # ------------------------------------------------------------------
    # the wire
    def wire_cast(self, batch_np: np.ndarray,
                  for_eval: bool = False) -> torch.Tensor:
        """The host side of the wire: a prepared float32 batch as a CPU
        tensor in the wire dtype.  bfloat16 rounds to nearest even; int16
        is ``clip(round(x * 32768 / WAVE_PCM_SCALE))``; ``for_eval``
        (valid and test sweeps) ships float32 whatever the wire."""
        batch_np = np.ascontiguousarray(batch_np, dtype=np.float32)
        if not for_eval and self._wire_dtype == "int16":
            return torch.from_numpy(np.clip(
                np.round(batch_np * (32768.0 / self._pcm_scale)),
                -32768, 32767).astype(np.int16))
        out = torch.from_numpy(batch_np)
        if not for_eval and self._wire_dtype == "bfloat16":
            out = out.to(torch.bfloat16)
        return out

    def _host_batch(self, batch_np: np.ndarray, for_eval: bool = False,
                    stacked: bool = False) -> torch.Tensor:
        """This rank's rows of a batch (of each batch of a [K, ...]
        ``stacked`` stack) through ``wire_cast``, into a pinned buffer when
        the device is a card."""
        with span("danet.train.wire_cast"):
            if self.mesh is not None:
                axis = 1 if stacked else 0
                rows = sharding.batch_rows(self.mesh, batch_np.shape[axis])
                batch_np = batch_np[:, rows] if stacked else batch_np[rows]
            out = self.wire_cast(batch_np, for_eval)
            if self.device.type != "cuda":
                return out
            buf = self._staging.take(out.shape, out.dtype)
            return buf.copy_(out)

    def _put(self, host: torch.Tensor) -> torch.Tensor:
        """A host batch of ``_host_batch`` onto the device."""
        with span("danet.train.put"):
            if self.device.type != "cuda":
                return host.to(self.device)
            return self._staging.to_device(host, self.device)

    def ingest(self, batch, for_eval: bool = False) -> torch.Tensor:
        """A batch as the model's input, ri spectra [B, N, T, F, 2]
        float32 on the device: a prepared numpy batch crosses the wire
        first (``for_eval``: in float32; on a mesh only this rank's rows);
        a tensor is one on the device that crossed it (this rank's
        rows).  Then the upcast, int16's dequantisation and, on
        the wave wire, the STFT (STFT_BACKEND 'auto' and 'pallas': kernel
        A on the card as the op ``danet::stft_ri``, its plain version on
        the CPU; 'xla': the plain framing and matmul).  No gradient flows
        into the wire."""
        if not torch.is_tensor(batch):
            batch = self._put(self._host_batch(batch, for_eval))
        x = batch.float()
        if batch.dtype == torch.int16:
            x = x * self._dequant
        if not self._wave_mode:
            return x
        hp = self.hp
        b, n, s = x.shape
        flat = x.reshape(b * n, s)
        if self._stft_backend == "xla":
            spec = dsp.stft_ri(flat, hp.FFT_SIZE, hp.FFT_STRIDE,
                               hp.FFT_WND_ARRAY)
        else:
            spec = library.stft_ri(flat, hp.FFT_SIZE, hp.FFT_STRIDE,
                                   hp.FFT_WND_ARRAY)
        return spec.reshape((b, n) + tuple(spec.shape[1:]))

    # ------------------------------------------------------------------
    # the steps
    def _rows_loss_and_grads(self, params: dict, src_ri: torch.Tensor,
                             generator: Optional[torch.Generator]):
        loss, aux = self.model.train_loss(params, src_ri, generator)
        ps = leaves(params)
        with span("danet.backward"):
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(ps, grads)]
        metrics = {"loss": loss.detach(), "SNR": aux["snr"].detach()}
        if "dc" in aux:
            metrics["DC"] = aux["dc"].detach()
        return metrics, grads

    def loss_and_grads(self, params: dict, src_ri: torch.Tensor,
                       generator: Optional[torch.Generator] = None):
        """(metrics, grads): {"loss", "SNR"} and "DC" (the raw
        deep-clustering term, with DC_LOSS_WEIGHT > 0) as detached 0-d
        tensors, and the train loss's gradient aligned with
        ``leaves(params)`` (zeros where the loss does not reach).

        On a mesh (collective): ``params`` are this rank's slices and
        ``src_ri`` its rows; the full weights are gathered, the rows' loss
        differentiated, and the results reduced (``parallel/
        collectives.py``): the global batch's metrics and, per leaf, this
        rank's slice of the global batch's gradient."""
        if self.mesh is None:
            return self._local_loss_and_grads(params, src_ri, generator)
        full = self.full_params(params)
        if full is not params:
            for p, a in zip(leaves(full), self._axes):
                if a:
                    p.requires_grad_(True)
        metrics, grads = self._local_loss_and_grads(full, src_ri, generator)
        grads = collectives.reduce_grads(self.mesh, grads, self._axes,
                                         self._owners)
        names = list(metrics)
        v = collectives.mean(self.mesh, torch.stack(
            [metrics[n] for n in names]))
        return {n: v[j] for j, n in enumerate(names)}, grads

    def _local_loss_and_grads(self, params: dict, src_ri: torch.Tensor,
                              generator: Optional[torch.Generator]):
        """``loss_and_grads`` of these rows and these (full) weights.

        GRAD_ACCUM = A > 1: the batch's rows split into A microbatches in
        order, each a forward and backward (dropout drawn from
        ``generator`` in that order); the gradients and the loss and SNR
        summed, then times 1/A, as the JAX trainer's scan; no DC column."""
        a = self._accum
        if a == 1:
            return self._rows_loss_and_grads(params, src_ri, generator)
        micro = src_ri.reshape((a, src_ri.shape[0] // a)
                               + tuple(src_ri.shape[1:]))
        grads = loss = snr = None
        for mb in micro:
            m, g = self._rows_loss_and_grads(params, mb, generator)
            if grads is None:
                grads, loss, snr = g, m["loss"], m["SNR"]
            else:
                grads = [x + y for x, y in zip(grads, g)]
                loss, snr = loss + m["loss"], snr + m["SNR"]
        inv = 1.0 / a
        return ({"loss": loss * inv, "SNR": snr * inv},
                [g * inv for g in grads])

    @torch.no_grad()
    def _ema_update(self, ema: list, params: list) -> None:
        """EMA_DECAY = d: e * d + p * (1 - d) over the parameter list, in
        ``torch._foreach_*`` passes (one kernel per pass on the card)."""
        d = self.ema_decay
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - d))

    def _check_finite(self, state: dict, metrics: dict, grads) -> None:
        """NAN_CHECKS: FloatingPointError when the loss or a gradient is
        not finite, naming the first parameter whose gradient is not (one
        fetch of the flags per step; on a mesh the flags of every rank's
        slices)."""
        flags = torch.stack([torch.isfinite(metrics["loss"])]
                            + [torch.isfinite(g).all() for g in grads])
        if self.mesh is not None:
            flags = collectives.all_reduce(
                self.mesh, flags.to(torch.int32), op=dist.ReduceOp.MIN)
        flags = [bool(f) for f in flags.cpu().tolist()]
        if all(flags):
            return
        bad = [n for n, ok in zip(leaf_names(state["params"]), flags[1:])
               if not ok]
        raise FloatingPointError(
            "NAN_CHECKS: step %d: non-finite %s (loss %s)"
            % (state["step"] + 1,
               "gradient of %s, the first of %d parameter leaves" % (
                   bad[0], len(bad)) if bad else "loss",
               float(metrics["loss"])))

    def train_step(self, state: dict, batch) -> dict:
        """One step on a batch (see ``ingest``): forward, backward
        (GRAD_ACCUM microbatches), the NAN_CHECKS check, clip, update and
        the EMA.  -> {"loss", "SNR"} (and "DC") as 0-d tensors on the
        device."""
        with span("danet.train.step"):
            self._ensure_ema(state)
            metrics, grads = self.loss_and_grads(
                state["params"], self.ingest(batch), state["generator"])
            if self._nan_checks:
                self._check_finite(state, metrics, grads)
            with span("danet.optimizer"):
                state["opt"].step(grads)
            if self.ema_decay:
                self._ema_update(leaves(state["ema"]),
                                 leaves(state["params"]))
            state["step"] += 1
            return metrics

    def train_steps(self, state: dict, stack) -> dict:
        """K steps on a stack of K batches of one shape, [K, ...] (a numpy
        stack, or its wire tensor on the device), as K ``train_step``s.
        -> the metrics as [K] tensors on the device.

        On the card (a mesh's collectives over NCCL) the K steps are one
        CUDA graph, captured at the first
        call per (shape, dtype) of the stack and replayed: it holds K
        forward, backward, clip, update and EMA steps, reads the stack and
        the optimizer's scalars from static buffers filled before each
        replay, and draws dropout from the state's generator (registered
        with the graph).  A capture or replay that fails raises.  On the
        CPU the K steps run eagerly."""
        with span("danet.train.call"):
            if not torch.is_tensor(stack):
                stack = self._put(self._host_batch(stack, stacked=True))
            k = stack.shape[0]
            if self.device.type != "cuda" or not self._graphs:
                rows = [self.train_step(state, stack[i]) for i in range(k)]
                return {n: torch.stack([r[n] for r in rows]) for n in rows[0]}
            self._ensure_ema(state)
            graphs = state.setdefault("graphs", {})
            key = (tuple(stack.shape), stack.dtype)
            g = graphs.get(key)
            if g is None:
                g = graphs[key] = self._capture(state, stack)
            opt = state["opt"]
            g.inp.copy_(stack)
            g.scalars.copy_(torch.from_numpy(
                opt.host_scalars(opt.count + 1, k)).pin_memory(),
                non_blocking=True)
            with span("danet.train.replay"):
                g.graph.replay()
            StepGraph.replays += 1
            opt.count += k
            state["step"] += k
            out = g.out.clone()
            return {n: out[:, j] for j, n in enumerate(g.names)}

    def _captures(self, state: dict, k: int, stack) -> bool:
        """Whether ``train_steps`` on this [K, ...] device stack captures a
        new CUDA graph."""
        return (k > 1 and self.device.type == "cuda" and self._graphs
                and (tuple(stack.shape), stack.dtype)
                not in state.get("graphs", {}))

    def _warm_up(self, state: dict, batch: torch.Tensor,
                 scalars: torch.Tensor) -> None:
        """One step on copies of the parameters, moments and EMA, on a
        side stream (as PyTorch asks before a capture): lazy
        initialisations (the kernel library, cuBLAS, the cached constants)
        must not happen under capture, and the state must not move."""
        dev = self.device
        opt = state["opt"]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            params = _tree_clone(state["params"])
            _, grads = self.loss_and_grads(
                params, self.ingest(batch),
                torch.Generator(dev).manual_seed(0))
            moments = [None if m is None else [t.clone() for t in m]
                       for m in (opt.mu, opt.nu)]
            with torch.no_grad():
                opt.update(leaves(params), *moments, opt.clip(grads),
                           scalars)
            if self.ema_decay:
                self._ema_update([t.clone() for t in leaves(state["ema"])],
                                 leaves(params))
        torch.cuda.current_stream(dev).wait_stream(side)

    def _capture(self, state: dict, stack: torch.Tensor) -> StepGraph:
        """Capture K steps of ``state`` into a CUDA graph, after a
        warm-up step (``_warm_up``)."""
        with span("danet.train.capture"):
            dev = self.device
            k = stack.shape[0]
            opt = state["opt"]
            inp = stack.clone()
            scalars = torch.ones((k, 3), dtype=torch.float32, device=dev)
            self._warm_up(state, inp[0], scalars[0])
            graph = torch.cuda.CUDAGraph()
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    "this PyTorch cannot register the dropout generator "
                    "with a CUDA graph (CUDAGraph.register_generator_state)")
            graph.register_generator_state(state["generator"])
            count = opt.count
            params = leaves(state["params"])
            ema = leaves(state["ema"]) if self.ema_decay else None
            # thread_local: the prefetch thread's pinned allocations and
            # event queries go on during the capture
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                rows, names = [], None
                for i in range(k):
                    metrics, grads = self.loss_and_grads(
                        state["params"], self.ingest(inp[i]),
                        state["generator"])
                    with span("danet.optimizer"):
                        opt.step(grads, scalars[i])
                    if ema is not None:
                        self._ema_update(ema, params)
                    names = list(metrics)
                    rows.append(torch.stack([metrics[n] for n in names]))
                out = torch.stack(rows)
            opt.count = count
            StepGraph.captures += 1
            return StepGraph(graph, inp, scalars, out, names)

    @torch.no_grad()
    def valid_step(self, state: dict, batch) -> dict:
        """Validation metrics of one batch, shipped in float32 (see
        ``ingest``), on ``eval_params``: every metric of ``valid_metrics``
        but the separated spectra, as 0-d tensors on the device (on a mesh
        the global batch's: collective)."""
        return self._valid(self.eval_params(state), batch)

    @torch.no_grad()
    def _valid(self, params: dict, batch) -> dict:
        m = self.model.valid_metrics(params, self.ingest(batch, for_eval=True))
        m = {k: v for k, v in m.items() if k != "separated_ri"}
        if self.mesh is None:
            return m
        names = sorted(m)
        v = collectives.mean(self.mesh, torch.stack([m[n] for n in names]))
        return {n: v[j] for j, n in enumerate(names)}

    def set_learn_rate(self, state: dict, lr: float) -> None:
        optim_lib.set_learn_rate(state["opt"], lr)

    def get_learn_rate(self, state: dict) -> float:
        return optim_lib.get_learn_rate(state["opt"])

    # ------------------------------------------------------------------
    # checkpoints
    def save_path(self, epoch: int) -> str:
        return os.path.join(self.save_dir, "%s_e%d" % (self.name, epoch))

    def save_params(self, state: dict, path: str) -> None:
        """Save ``state`` to the checkpoint directory ``path``; on a mesh
        (collective) rank 0 writes every leaf whole while the others wait
        at a barrier."""
        if self.mesh is None:
            ckpt_lib.save_checkpoint(path, state)
            return
        tree = self.host_state(state)
        if self._chief:
            ckpt_lib.save_checkpoint(path, tree)
        collectives.barrier(self.mesh)

    def _nest(self, values: list) -> dict:
        return sharding.nest(self.leaf_names, values)

    @torch.no_grad()
    def host_state(self, state: dict) -> dict:
        """The host tree of ``state`` (``train/checkpoint.py``'s layout),
        every leaf whole: on a mesh the parameters, moments and EMA are
        gathered (collective), and the generator is this rank's."""
        opt = state["opt"]

        def whole(ts):
            full = collectives.gather_leaves(self.mesh, list(ts), self._axes)
            return self._nest([t.detach().cpu().numpy() for t in full])

        tree = {"params": whole(leaves(state["params"])),
                "opt": {"mu": None if opt.mu is None else whole(opt.mu),
                        "nu": None if opt.nu is None else whole(opt.nu),
                        "count": opt.count, "lr": opt.lr},
                "step": state["step"], "epoch": state["epoch"],
                "generator": state["generator"]}
        if state.get("ema") is not None:
            tree["ema"] = whole(leaves(state["ema"]))
        return tree

    def _template(self, state: dict) -> dict:
        """What a checkpoint of ``state`` holds, in full shapes (meta
        tensors on a mesh, where the state holds slices)."""
        if self.mesh is None:
            return state
        meta = self._nest([torch.empty(s, dtype=d, device="meta")
                           for s, d in self._full])
        opt = state["opt"]
        tree = {"params": meta,
                "opt": {"mu": None if opt.mu is None else meta,
                        "nu": None if opt.nu is None else meta,
                        "count": 0, "lr": 0.0},
                "step": 0, "epoch": 0, "generator": state["generator"]}
        if state.get("ema") is not None or self.ema_decay:
            tree["ema"] = meta
        return tree

    def load_params(self, state: dict, path: str) -> dict:
        """The checkpoint at ``path`` restored into ``state`` in place
        (``restore``); -> ``state``."""
        return self.restore(state, ckpt_lib.load_checkpoint(
            path, self._template(state)))

    @torch.no_grad()
    def restore(self, state: dict, tree: dict) -> dict:
        """Copy a host tree (``checkpoint.load_checkpoint``,
        ``weights.from_jax_state``) into ``state``: the parameters, the
        moments and the EMA with ``copy_`` into the tensors the state
        already has, because the optimizer and the captured K-step graphs
        hold their addresses (a rebound tensor would leave a graph
        updating the old one); then the step count, learning rate,
        counters and, when the tree has one, the dropout generator (from a
        generator of another device type only its seed).  On a mesh each
        leaf of the tree is whole and the rank copies its slice; a
        generator state goes to the first row slice's rank, and the others
        reseed from its seed (``_rank_seed``).  -> ``state``."""
        flat = dict(zip(leaf_names(tree), leaves(tree)))
        names = leaf_names(state["params"])

        axes = self._axes if self.mesh is not None else [None] * len(names)

        def copy(prefix, dsts):
            for name, dst, axis in zip(names, dsts, axes):
                src = flat[prefix + name]
                if self.mesh is not None:
                    src = sharding.shard_leaf(np.asarray(src), axis,
                                              self.mesh)
                src = np.require(src, requirements="W")
                dst.copy_(torch.from_numpy(src))

        copy("params/", leaves(state["params"]))
        opt = state["opt"]
        if opt.mu is not None:
            copy("opt/mu/", opt.mu)
            copy("opt/nu/", opt.nu)
        opt.count = int(tree["opt"]["count"])
        opt.lr = float(tree["opt"]["lr"])
        state["step"], state["epoch"] = int(tree["step"]), int(tree["epoch"])
        if self.ema_decay:
            self._ensure_ema(state)
            copy("ema/" if "ema" in tree else "params/",
                 leaves(state["ema"]))
        else:
            state.pop("ema", None)
        gen = tree.get("generator")
        if gen is not None:
            mine = state["generator"]
            seed = int(gen["seed"])
            if self._rank_seed(seed) != seed:
                mine.manual_seed(self._rank_seed(seed))
            elif str(gen["device"]) == mine.device.type:
                mine.set_state(torch.from_numpy(np.array(gen["state"])))
            else:
                mine.manual_seed(seed)
        return state

    def _reseed_dropout(self, state: dict, seed: int) -> None:
        """The dropout generator reseeded; on the card at the Philox
        offset it has reached, so that a return to the run's own seed
        continues the stream where a run without the retry would be (the
        CPU's generator has no offset: it restarts the seed's stream)."""
        gen = state["generator"]
        if gen.device.type == "cuda":
            offset = gen.get_offset()
            gen.manual_seed(seed)
            gen.set_offset(offset)
        else:
            gen.manual_seed(seed)

    # ------------------------------------------------------------------
    # the data
    def _epoch_fn(self, dataset, for_eval: bool = False):
        """The dataset's epoch generator for the configured wire: the
        wave wire needs ``epoch_wave`` and, for int16 train batches, a
        WAVE_PCM_SCALE equal to the dataset's WAVE_SCALE (eval sweeps ship
        float32 and skip that check)."""
        if not self._wave_mode:
            return dataset.epoch
        fn = getattr(dataset, "epoch_wave", None)
        if fn is None:
            raise ValueError(
                "TRANSFER_DOMAIN='wave' needs a wave-capable dataset "
                "(synth, synth-speech, wsj0, wav-dir and timit expose "
                "epoch_wave); %s stores spectra only: use the default "
                "spectra wire"
                % type(dataset).__name__)
        if self._wire_dtype == "int16" and not for_eval:
            want = float(getattr(dataset, "WAVE_SCALE", 1.0))
            if self._pcm_scale != want:
                raise ValueError(
                    "TRANSFER_DTYPE='int16' with WAVE_PCM_SCALE=%g but %s "
                    "declares WAVE_SCALE=%g: set WAVE_PCM_SCALE=%g in the "
                    "config" % (self._pcm_scale, type(dataset).__name__,
                                want, want))
        return fn

    def _prepare(self, flat: np.ndarray, max_len, rng) -> np.ndarray:
        hp = self.hp
        bucket = effective_bucket(hp)
        if self._wave_mode:
            return prepare_batch_wave(
                flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL, hp.FFT_SIZE,
                hp.FFT_STRIDE, max_len=max_len, bucket=bucket, rng=rng)
        return prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL,
                             max_len=max_len, bucket=bucket, rng=rng)

    def _train_batches(self, epoch_fn, rng, rand):
        """The epoch's host batches, pinned, in the wire dtype, as (k,
        batch): single batches (k = 1) and, with TRAIN_STEPS_PER_CALL = K
        > 1, stacks of K batches of one shape (k = K); a group whose shape
        changes is flushed as single batches, and so is the epoch's
        remainder."""
        hp = self.hp
        k = self._steps_per_call
        buf = []
        for data_pt in epoch_fn("train", hp.BATCH_SIZE * hp.MAX_N_SIGNAL,
                                shuffle=True, rng=rng, rand=rand):
            b = self._prepare(data_pt[0], hp.MAX_TRAIN_LEN, rng)
            if k == 1:
                yield 1, self._host_batch(b)
                continue
            if buf and b.shape != buf[0].shape:
                for x in buf:
                    yield 1, self._host_batch(x)
                buf = []
            buf.append(b)
            if len(buf) == k:
                yield k, self._host_batch(np.stack(buf), stacked=True)
                buf = []
        for x in buf:
            yield 1, self._host_batch(x)

    # ------------------------------------------------------------------
    # the loop
    @contextlib.contextmanager
    def _hang_watchdog(self):
        """WATCHDOG_SECS > 0: a daemon thread watches the heartbeat that
        every step, valid batch and metric fetch refreshes, and when it is
        older than the limit prints a diagnosis and ends the process with
        ``os._exit(WATCHDOG_EXIT_CODE)`` (a hung device call never returns,
        so nothing else would end it; an orderly shutdown could hang as
        well).  Nested use is a no-op."""
        secs = float(getattr(self.hp, "WATCHDOG_SECS", 0) or 0)
        if secs <= 0 or self._watchdog_on:
            yield
            return
        self._heartbeat = time.monotonic()
        self._watchdog_on = True
        stop = threading.Event()

        def watch():
            while not stop.wait(min(15.0, secs / 4)):
                stale = time.monotonic() - self._heartbeat
                if stale > secs:
                    msg = ("\n[watchdog] no step/batch completed in %.0f s "
                           "(WATCHDOG_SECS=%.0f): device presumed hung; "
                           "exiting %d for a supervised relaunch\n"
                           % (stale, secs, WATCHDOG_EXIT_CODE))
                    for stream in (sys.stderr, sys.stdout):
                        try:
                            stream.write(msg)
                            stream.flush()
                        except Exception:
                            pass
                    os._exit(WATCHDOG_EXIT_CODE)

        thread = threading.Thread(target=watch, daemon=True,
                                  name="hang-watchdog")
        thread.start()
        try:
            yield
        finally:
            stop.set()
            self._watchdog_on = False

    def _metrics_sweep(self, state, dataset, subset, rng,
                       rand) -> OrderedDict:
        """One metrics pass, float32 on the wire; the per-batch metrics
        are summed on the device and fetched once."""
        hp = self.hp
        acc, n = None, 0
        params = self.eval_params(state)
        for data_pt in self._epoch_fn(dataset, for_eval=True)(
                subset, hp.BATCH_SIZE * hp.MAX_N_SIGNAL, shuffle=False,
                rng=rng, rand=rand):
            m = self._valid(params, self._prepare(data_pt[0], None, rng))
            acc = m if acc is None else {k: acc[k] + v for k, v in m.items()}
            n += 1
            self._heartbeat = time.monotonic()
            sys.stdout.write(".")
            sys.stdout.flush()
        if acc is None:
            return OrderedDict()
        names = sorted(acc)
        fetched = torch.stack([acc[k] for k in names]).cpu().tolist()
        return OrderedDict((k, v / n) for k, v in zip(names, fetched))

    def train(self, n_epoch: int, dataset, save_on_epoch: bool = True,
              valid_on_epoch: bool = True, state: Optional[dict] = None,
              seed: int = 0, lr: Optional[float] = None,
              writer: Optional[MetricsWriter] = None,
              save_best: bool = False) -> dict:
        """The epoch loop: per-epoch mean loss, SNR and LR on stdout (':'
        per step), the LR_DECAY_TYPE policy, a checkpoint after each epoch
        when ``save_on_epoch`` ('S'), a validation sweep ('.' per batch)
        after each epoch when ``valid_on_epoch`` with the keep-best
        checkpoint when ``save_best`` ('B'), the NaN and valid-crash
        rollbacks; every step's row and every sweep go to ``writer`` (by
        default a new ``MetricsWriter`` in SUMMARY_DIR, closed on return).
        Under the hang watchdog (WATCHDOG_SECS) and the preemption
        signals: SIGTERM or SIGINT saves ``<name>_preempt`` at the next
        step boundary and returns the state (a resume from it restarts the
        interrupted epoch with the mid-epoch state); a second signal
        restores the default handlers, so that a third ends the process."""
        own = writer is None
        if own:
            writer = (MetricsWriter(self.hp.SUMMARY_DIR,
                                    self.hp.SUMMARY_TITLE)
                      if self._chief else NullWriter())
        try:
            with self._preempt_signals(), self._hang_watchdog():
                return self._train_impl(n_epoch, dataset, save_on_epoch,
                                        valid_on_epoch, state, seed, lr,
                                        writer, save_best)
        finally:
            if own:
                writer.close()

    @contextlib.contextmanager
    def _preempt_signals(self):
        """SIGTERM and SIGINT set the preemption flag (in the main thread
        only, where Python delivers signals)."""
        self._preempt = False
        installed = {}

        def handler(signum, frame):
            if self._preempt:  # a second signal: the next one ends it
                for sig, h in installed.items():
                    signal.signal(sig, h)
            self._preempt = True
            sys.stdout.write(
                "\n[signal %d: checkpointing at the next step boundary]\n"
                % signum)
            sys.stdout.flush()

        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                installed[sig] = signal.signal(sig, handler)
        try:
            yield
        finally:
            for sig, h in installed.items():
                signal.signal(sig, h)

    def _train_impl(self, n_epoch, dataset, save_on_epoch, valid_on_epoch,
                    state, seed, lr, writer, save_best) -> dict:
        hp = self.hp
        if state is None:
            state = self.init_state(torch.Generator().manual_seed(seed))
        self._ensure_ema(state)
        if lr is not None:
            self.set_learn_rate(state, lr)
            print("Set learning rate to %f" % lr)
        else:
            print("Learning rate: %f" % self.get_learn_rate(state))
        n_profile = int(getattr(hp, "PROFILE_STEPS", 0) or 0)
        window = ProfileWindow(n_profile, int(state["step"]), os.path.join(
            writer.run_dir, "profile"), self.device) \
            if n_profile > 0 and self._chief else None
        try:
            return self._epochs(state, n_epoch, dataset, save_on_epoch,
                                valid_on_epoch, seed, writer, save_best,
                                window)
        finally:
            # a preemption, a rollback or an error inside the window still
            # leaves a closed trace
            if window is not None:
                window.stop(int(state["step"]))

    def _epochs(self, state, n_epoch, dataset, save_on_epoch,
                valid_on_epoch, seed, writer, save_best, window) -> dict:
        """The epoch loop: each epoch's calls fed by ``prefetch_to_device``,
        their metrics fetched every METRICS_EVERY steps (and at the
        epoch's end) into rows of ``writer``, whose ``step_time`` is the
        wall time from the end of the previous fetch (or the epoch's
        start) to the end of this one over the steps it fetched
        (``StepTimer``: the fetch waits for the device); then the LR
        policy, the NaN rollback, the checkpoint, the valid sweep and the
        valid-crash rollback."""
        hp = self.hp
        base_lr = self.get_learn_rate(state)
        metrics_every = int(getattr(hp, "METRICS_EVERY", 1) or 1)
        crash_factor = float(getattr(hp, "VALID_CRASH_FACTOR", 0.0) or 0.0)
        epoch_fn = self._epoch_fn(dataset)
        best_loss, best_loss_time = float("inf"), 0
        best_valid_loss = float("inf")
        epoch0 = int(state["epoch"])
        epoch, n_total = epoch0, epoch0 + n_epoch
        # NaN-rollback retries: they perturb the data and dropout streams
        # of the retried epoch; valid-crash rollbacks this invocation
        nan_retries = crash_retries = 0
        own_seed = None  # the dropout generator's seed while perturbed
        while epoch < n_total:
            key = zlib.crc32(b"danet-epoch-%d-retry-%d-seed-%d"
                             % (epoch, nan_retries, seed))
            rng, rand = np.random.RandomState(key), random.Random(key)
            report = OrderedDict()
            # (first step, {name: 0-d or [k] metrics on the device}, k) of
            # the steps not fetched yet
            pending, pending_steps = [], 0
            # each row's step_time: the wall time since the previous fetch
            # ended over the steps this fetch brings, which waits for them
            timer = StepTimer()

            def flush():
                nonlocal pending_steps
                if not pending:
                    return
                with span("danet.train.metrics_fetch"):
                    parts = [v.reshape(-1) for _, m, _ in pending
                             for v in m.values()]
                    host = torch.cat(parts).cpu().tolist()   # one fetch
                st = timer.lap(pending_steps)
                lr_now = self.get_learn_rate(state)
                at = 0
                for step0, m, k in pending:
                    cols = {}
                    for name in m:
                        cols[name] = host[at:at + k]
                        at += k
                    for j in range(k):
                        row = {name: cols[name][j] for name in m}
                        row["LR"] = lr_now
                        writer.scalars("train", dict(row, step_time=st),
                                       step0 + j)
                        for name, v in row.items():
                            report[name] = report.get(name, 0.0) + v
                pending.clear()
                pending_steps = 0
                self._heartbeat = time.monotonic()

            n_steps = 0
            batches = prefetch_to_device(
                self._train_batches(epoch_fn, rng, rand),
                lambda kb: (kb[0], self._put(kb[1])))
            timer.start()
            try:
                for k, src in batches:
                    step0 = state["step"]
                    if window is not None:
                        window.before(step0, self._captures(state, k, src))
                    if k > 1:
                        metrics = self.train_steps(state, src)
                    else:
                        metrics = self.train_step(state, src)
                    pending.append((step0, metrics, k))
                    pending_steps += k
                    n_steps += k
                    self._heartbeat = time.monotonic()
                    if pending_steps >= metrics_every:
                        flush()
                    if window is not None:
                        window.after(state["step"])
                    sys.stdout.write(":" * k)
                    sys.stdout.flush()
                    if self._preempted():
                        break
            finally:
                batches.close()
            flush()
            if self._preempted():
                path = os.path.join(self.save_dir, "%s_preempt" % self.name)
                self.save_params(state, path)
                sys.stdout.write(
                    "\n[preempted: saved %s at step %d (epoch %d "
                    "incomplete); resume with -i to continue]\n"
                    % (path, state["step"], epoch + 1))
                sys.stdout.flush()
                return state
            if n_steps == 0:
                raise RuntimeError(
                    "dataset yielded no training batches for batch size %d"
                    % (hp.BATCH_SIZE * hp.MAX_N_SIGNAL))
            for k in report:
                report[k] /= n_steps

            decay = hp.LR_DECAY_TYPE
            if decay == "adaptive":
                if report["loss"] < best_loss:
                    best_loss, best_loss_time = report["loss"], 0
                else:
                    best_loss_time += 1
            elif decay == "fixed":
                best_loss_time += 1
            elif decay == "cosine":
                frac = (epoch - epoch0 + 1) / max(n_epoch, 1)
                floor_lr = base_lr * hp.LR_DECAY
                self.set_learn_rate(state, floor_lr + 0.5 * (
                    base_lr - floor_lr) * (1.0 + math.cos(
                        math.pi * min(frac, 1.0))))
            elif decay is not None:
                raise ValueError('Unknown LR_DECAY_TYPE "%s"' % decay)
            if best_loss_time == hp.NUM_EPOCH_PER_LR_DECAY:
                best_loss_time = 0
                old_lr = self.get_learn_rate(state)
                self.set_learn_rate(state, old_lr * hp.LR_DECAY)
                sys.stdout.write("[LR %f -> %f]" % (
                    old_lr, self.get_learn_rate(state)))
                sys.stdout.flush()

            # the NaN rollback: to the previous epoch's checkpoint (also
            # the one a previous invocation wrote, for a resumed run)
            if any(math.isnan(v) for v in report.values()):
                rollback = self.save_path(epoch)
                if save_on_epoch and ckpt_lib.exists(rollback):
                    sys.stdout.write(
                        "\nEpoch %d/%d got NaN values, restoring last "
                        "checkpoint ... " % (epoch + 1, n_total))
                    state = self.load_params(state, rollback)
                    nan_retries += 1
                    own_seed = self._perturb_dropout(state, nan_retries)
                    sys.stdout.write("done\n")
                    continue
                sys.stdout.write(
                    "\nRun into NaN during epoch %d with no checkpoint to "
                    "roll back to, exiting ...\n" % (epoch + 1))
                sys.stdout.flush()
                sys.exit(-1)
            # a clean epoch returns to the canonical streams
            if own_seed is not None:
                self._reseed_dropout(state, own_seed)
                own_seed = None
            nan_retries = 0
            # incremented before the save, so that <name>_e<k> holds epoch
            # k and a resume from it continues at epoch k
            epoch += 1
            state["epoch"] = epoch
            if save_on_epoch:
                self.save_params(state, self.save_path(epoch))
                sys.stdout.write("S")
            sys.stdout.write("\nEpoch %d/%d %s (%.3fs/step)\n" % (
                epoch, n_total, _dict_format(report), timer.mean))
            sys.stdout.flush()
            if not valid_on_epoch:
                continue
            report = self._metrics_sweep(state, dataset, "valid", rng, rand)
            writer.scalars("valid", report, state["step"])
            sys.stdout.write("\nValid  %d/%d %s\n" % (
                epoch, n_total, _dict_format(report)))
            sys.stdout.flush()
            # the valid-crash rollback: a finite spike of the valid loss
            # past VALID_CRASH_FACTOR x the best of this invocation goes
            # back to the best (or the previous epoch's) checkpoint, at
            # most 3 times an invocation
            if (crash_factor > 0.0 and crash_retries < 3
                    and best_valid_loss < float("inf")
                    and report.get("loss", 0.0)
                    > best_valid_loss * crash_factor):
                target = os.path.join(self.save_dir, "%s_best" % self.name)
                if not (save_best and ckpt_lib.exists(target)):
                    target = self.save_path(epoch - 1)
                if ckpt_lib.exists(target):
                    sys.stdout.write(
                        "\n[valid loss %.6g > %.2fx best %.6g: crash "
                        "rollback to %s]\n" % (
                            report["loss"], crash_factor, best_valid_loss,
                            target))
                    sys.stdout.flush()
                    # the spiked epoch's checkpoint was written before the
                    # sweep saw the spike: a preemption during the replay
                    # must not resume from it
                    spiked = self.save_path(epoch)
                    if (self._chief and save_on_epoch
                            and os.path.exists(spiked)
                            and os.path.abspath(spiked)
                            != os.path.abspath(target)):
                        shutil.rmtree(spiked, ignore_errors=True)
                    state = self.load_params(state, target)
                    epoch = int(state["epoch"])
                    crash_retries += 1
                    nan_retries = crash_retries
                    own_seed = self._perturb_dropout(state, nan_retries)
                    continue
                sys.stdout.write(
                    "\n[valid loss spiked but no checkpoint to roll back "
                    "to; continuing]\n")
                sys.stdout.flush()
            # keep-best on the valid loss (tracked without save_best too:
            # the crash rollback compares against it)
            if report.get("loss", float("inf")) < best_valid_loss:
                best_valid_loss = report["loss"]
                if save_best:
                    self.save_params(state, os.path.join(
                        self.save_dir, "%s_best" % self.name))
                    sys.stdout.write("B")
                    sys.stdout.flush()
        return state

    def _preempted(self) -> bool:
        """The preemption flag, on a mesh set when any rank's is (a host
        all-reduce at every step boundary)."""
        if self.mesh is not None:
            self._preempt = collectives.host_any(self.mesh, self._preempt)
        return self._preempt

    def _perturb_dropout(self, state: dict, retry: int) -> int:
        """After a rollback: the dropout generator reseeded from its
        restored seed and ``retry``.  -> the restored seed, which the loop
        returns to after a clean epoch."""
        own = state["generator"].initial_seed()
        self._reseed_dropout(state, zlib.crc32(
            b"danet-dropout-%d-retry-%d" % (own, retry)))
        return own

    def test(self, state: dict, dataset, subset: str = "test",
             name: str = "Test", seed: int = 0) -> dict:
        """One metrics sweep over ``subset`` on ``eval_params`` (the mean
        over batches), printed as '<name>: ...'; its data drawn from a
        stream of (subset, seed)."""
        key = zlib.crc32(b"danet-%s-seed-%d" % (subset.encode(), seed))
        with self._hang_watchdog():
            report = self._metrics_sweep(state, dataset, subset,
                                         np.random.RandomState(key),
                                         random.Random(key))
        sys.stdout.write("\n%s: %s\n" % (name, _dict_format(report)))
        return report

    @torch.no_grad()
    def separate(self, state: dict, mix_ri: np.ndarray) -> np.ndarray:
        """Inference on a mixture batch, ri spectra [B, T, F, 2] ->
        [B, N, T, F, 2] float32, on ``eval_params``."""
        x = torch.as_tensor(np.asarray(mix_ri, dtype=np.float32))
        out = self.model.separate(self.eval_params(state), x.to(self.device))
        return out.cpu().numpy()
