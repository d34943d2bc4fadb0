"""Where the port's device time goes, on one NVIDIA GPU.

    python -m danet_tpu_torch.perf_probe profile [--encoder gru-v1]
        [--dtype float32|bfloat16] [--attn-backend flash|xla|auto]
        [-c CONFIG.json ...] [--key KEY=VALUE ...]
    python -m danet_tpu_torch.perf_probe scan-bwd [--reps 20]
        [--set NAME=VALUE ...] [--cut fma|staging ...]
    python -m danet_tpu_torch.perf_probe gru-fwd [--reps 10]
        [--set NAME=VALUE ...] [--cut staging|barrier|fma|gates ...]
        [--source CSRC_DIR]
    python -m danet_tpu_torch.perf_probe lstm-fwd [--reps 10]
        [--set NAME=VALUE ...] [--cut staging|barrier|fma|gates ...]
        [--source CSRC_DIR]
    python -m danet_tpu_torch.perf_probe gru-bwd [--reps 10]
        [--set NAME=VALUE ...] [--cut staging|barrier|fma ...]
        [--source CSRC_DIR]
    python -m danet_tpu_torch.perf_probe lstm-train [--dirs 1|2]
        [--reps 10] [--set NAME=VALUE ...]
        [--cut staging|barrier|fma|gates ...] [--source CSRC_DIR]
    python -m danet_tpu_torch.perf_probe flash-fwd [--reps 50]
    python -m danet_tpu_torch.perf_probe flash-bwd [--reps 20]
        [--cut products|staging ...] [--source CSRC_DIR]
    python -m danet_tpu_torch.perf_probe device-ms [--reps 20]
    python -m danet_tpu_torch.perf_probe row-groups [--reps 20]
        [--only lean|save|bwd ...]

``profile``: for one encoder at full width with random weights from seed
0, in COMPUTE_DTYPE ``--dtype``, ``torch.profiler`` over 5 train steps
(BATCH_SIZE, default.json's 32, T=128, the toy data; after 3 warm-ups)
and over 5 10-s requests at
B=1 (after 2 warm-ups; attn-v1's flash path takes T a multiple of 128,
so its request is L=81,856, T=1280).  ``--attn-backend`` sets
ATTN_BACKEND for attn-v1: 'flash' (the default here) profiles the flash
kernels, 'xla' or 'auto' the dense attention.  ``-c`` lays config files
over default.json and ``--key`` single keys over them (a JSON value, else
a string): ``--key MODEL_TYPE=tasnet-v1`` profiles tasnet-v1 (its
step, and a 10 s request through ``separate_wav``); configs/tpu.json's
model half is ``--encoder attn-v1 -c
configs/tpu.json --key TRAIN_STEPS_PER_CALL=1 --key WATCHDOG_SECS=0 --key
TRANSFER_DOMAIN=spectra --key TRANSFER_DTYPE=float32`` (the trainer keys
the port refuses, at default.json's values).  Prints, per step or
request, the unprofiled wall time, the port's spans (the ``danet.*``
rows of ``key_averages``, ``danet_tpu_torch/spans.py``: calls and host
ms, a stage's launches and the Python between them) and the device time
by kernel (the CUDA rows).  How much of the wall the card idles is the
benchmark's to say (``perfbench/``, a traced slice's union of device
intervals); a sum of kernel times over another window's wall is not
it.

``scan-bwd``: kernel 3 alone, both entry points (``lstm_scan_bwd`` at
H=600, lstm-orig's layers, and ``bilstm_scan_bwd`` at H=300,
bilstm-orig's), float32 and bfloat16, tanh candidate, at the training
shape (T=128, B=32) and a ragged one (T=64, B=33): layer-shaped residuals
from the plain training forward, each output checked against the plain
backward at ``chip_smoke.py`` phase 6's tolerances (float32 atol 2e-5 +
rtol 1e-4, bfloat16 5e-2 + 2e-2), then the kernel's time (CUDA events,
``--reps`` launches after a warm-up) in ms and µs per step, and at
(T=128, B=32) float32 that of cuDNN's backward to the input
(``torch.nn.LSTM``) beside it.  ``--set`` builds a variant of kernel 3
with ``constexpr int NAME`` of ``csrc/bilstm_scan_bwd.cu`` set to VALUE
(e.g. ``KC=128``, ``RING_BYTES=8192``); ``--cut`` removes the FMAs or the
staging of the row from it, to time the rest (its outputs are then wrong
and not checked).  A variant builds into its own library under
``_build/`` and prints its registers and spills.

``gru-fwd``: kernel 4f alone, ``gru_scan`` at gru-v1's serving shape
(T=1251, B=1) and ``gru_scan_train`` at its training shape (T=128,
B=32), H=600, float32 and bfloat16, chip_smoke.py phase 9's inputs and
tolerances (float32 atol 1e-5, bfloat16 5e-2 + rtol 2e-2): max abs
error, ms and µs per step; then ``gru_scan``'s µs per step at T=501 (a
4 s request) for B = 1, 2, 4, 8, 16 and 32, float32, unchecked.  ``--cut staging`` (no row exchange at all),
``--cut barrier`` (the row read once, no wait for the step's tag or the
blocks' flags; in the earlier design, no grid barriers), ``--cut fma`` and ``--cut gates`` (no
gx / cx loads) time a variant without that part, outputs not checked;
``--set NAME=VALUE`` a constant; ``--source DIR`` builds the gru_scan.cu
(and headers) of another csrc directory, e.g. the parent commit's under
``trees/parent/``, whose cuts have their own text in ``GRU_FWD_CUTS``.

``lstm-fwd``: kernel B alone, the lean LSTM forward in both of its forms,
``bilstm_scan`` at bilstm-orig's H=300 and ``lstm_scan`` at lstm-orig's
H=600, tanh candidate, layer-shaped inputs with nonzero c0 and h0, at
(T=1251, B=1) (a 10 s request), (T=1251, B=4) and (T=128, B=32) (the
validation batch), float32 and bfloat16: max abs error against the plain
version at ``chip_smoke.py`` phase 4's tolerances (float32 atol 1e-5,
bfloat16 5e-2), a digest of the output's bytes (equal digests from two
builds: bit-identical outputs), ms and µs per step, ``lstm_scan``'s state
entry (``return_state``: float32 c0 and final carry) timed beside its lean
one where the library has it, and in float32 the time of
``torch.nn.LSTM`` (cuDNN, with the input projection) at the same (T, B)
beside it; then both kernels' µs per step at T=501 (a 4 s request) for B
= 1, 2, 4, 8, 16 and 32, float32, unchecked.  ``--cut``, ``--set`` and
``--source`` as for ``gru-fwd``, on ``csrc/lstm_scan_lean.cu``; a
``--source`` directory without that file holds the earlier design, whose
lean forward is ``bilstm_scan.cu``'s (grid barriers, no scratch
argument), with its own cut texts in ``LSTM_FWD_CUTS``.

``gru-bwd``: kernel 4b alone (``gru_scan_bwd``, H=600) at the training
shape (T=128, B=32), phase 6's ragged one (T=64, B=33) and a 10 s
request's length at B=1 (T=1251), float32 and bfloat16, on phase 9's
inputs (residuals from the plain training forward): each output's max
abs error against the plain version at ``chip_smoke.py`` phase 9's
tolerances (float32 atol 2e-5 + rtol 1e-4, bfloat16 5e-2 + 2e-2), a
digest of the outputs' bytes (equal digests: bit-identical outputs), ms
and µs per step; then its float32 µs per step at T=128 for B = 32, 64
and 128, each checked as above (a batch the kernel refuses prints why).  ``--cut
staging`` (no exchange: neither the wait for the flags nor the row
copies), ``--cut barrier`` (no wait for the flags; in the earlier design,
no grid barriers) and ``--cut fma`` time a variant without that part,
outputs not checked; ``--set`` and ``--source`` as for ``gru-fwd``, on
``csrc/gru_scan_bwd.cu``; a ``--source`` whose ``gru_scan_bwd.cu``
includes ``row_contract.cuh`` holds the earlier design (grid barriers, no
scratch argument), with its own cut texts in ``GRU_BWD_CUTS``.

``lstm-train``: the one-direction saving LSTM forward alone
(``lstm_scan_train``, H=600, tanh candidate, nonzero c0 and h0) at the
same shapes and dtypes, ``lstm-fwd``'s inputs: hs, cs and acts against
the plain version at ``chip_smoke.py`` phase 8's tolerances (float32 atol
1e-5, bfloat16 5e-2 + rtol 2e-2), the digest, ms and µs per step, and in
float32 the time of ``torch.nn.LSTM(600, 600)``'s training forward (cuDNN,
with the input projection) beside it; then the B = 32, 64, 128 sweep.
``--dirs 2``: the same for kernel 2 (``bilstm_scan_train``, H=300, phase
6's tolerances, which are phase 8's) beside ``torch.nn.LSTM(600, 300,
bidirectional=True)``'s training forward.  ``--cut``, ``--set`` and
``--source`` as for ``lstm-fwd``; a ``--source`` holding the earlier
design (a ``lstm_scan_lean.cu`` without ``danet_lstm_scan_train`` for one
direction, a ``bilstm_scan.cu`` for two) builds that design's
``bilstm_scan.cu`` (grid barriers, no scratch argument).

``flash-fwd``: kernel 5f (``flash_attn``) alone at attn-v1's widths
(H=4, D=64), float32 and bfloat16, at the serving shape (B=1, T=1280)
and the training shape (B=32, T=128), q, k and v as views of one qkv
projection with the last row's final 37 frames padded: each output
checked against the plain version at ``chip_smoke.py`` phase 13's
tolerances, then the kernel's time (CUDA events, ``--reps`` launches after
a warm-up) with the key split S that ``flash_splits`` picks, and, where
that S is not 1, with S=1 beside it; in float32, SDPA's time (with the
boolean segment-equality mask) on the same inputs.

``flash-bwd``: kernels 5dkv (``flash_attn_bwd_dkv``) and 5dq
(``flash_attn_bwd_dq``) alone at ``chip_smoke.py`` phase 13's inputs and
shapes ((T=1280, B=1), (T=128, B=32), (T=384, B=1); H=4, D=64), float32
and bfloat16: each output's max abs error against the plain version at
phase 13's gradient tolerances (float32 atol 2e-5 + rtol 1e-4, bfloat16
5e-2 + 2e-2), the digest of the outputs' bytes, and in float32 the time
of ``--reps`` back-to-back wrapper calls between CUDA events (``ms``, as
``chip_smoke.py`` times them: host-paced below about 0.1 ms) beside the
kernel's own device time (``device ms``: the ``torch.profiler`` CUDA row
of the kernel over ``--reps`` launches after a warm-up), and, at (T=128,
B=32), SDPA's backward (dq, dk and dv in one call, with the boolean
segment mask) both ways.  ``--source DIR`` builds the flash_attn_bwd.cu
(and headers) of another csrc directory, e.g. the parent commit's, and
prints its registers and spills; ``--cut products|staging`` times both
kernels without their tile products (5dkv's four, 5dq's three) or
without their per-tile copies (5dkv: Q and dO; 5dq: K and V; outputs not
checked); ``--set DQ_ROWS=8`` builds 5dq with 8 query rows per thread
(128 threads) in place of 4.

``stft``: kernels A and 6 (``stft_ri``, ``stft_logmag``) at
``STFT_SHAPES``: ``chip_smoke.py`` phase 3's and 16's shapes (fft 256,
stride 64) and strides that do not divide the fft ((256, 100) and (512,
128) at B=3, odd L): each output's max abs error against the plain
version (atol 2e-5) and its digest, and at (L=80000, B=1) and (L=32000,
B=4) the event-timed ``ms``, the profiler's ``device ms``, the plain
version's ms and torch.stft's device ms.  ``--source DIR`` builds another
csrc directory's stft.cu (a tree without the kernel basis layout is fed
the plain basis), ``--cut`` (repeatable) times kernel A without a part
(``STFT_CUTS``: its products, its copies of the frames and the basis, the
whole staging of its frames, its basis copies, its stores; outputs not
checked) or with 32 or 24 frames per block forced (``frames32``,
``frames24``; outputs checked).

``device-ms``: the kernels whose ``chip_smoke.py`` time is under 0.1 ms,
each at the shape its summary entry is timed at (``TIMED_AT``), float32:
kernel A (``stft_ri``, L=80000, B=1), kernel 6 (``stft_logmag``, the
same), 5f (``flash_attn``, T=1280, B=1), 5dkv and 5dq (T=128, B=32; H=4,
D=64): the event-timed ``ms`` and the profiler's ``device ms`` as for
``flash-bwd``.

``row-groups``: kernels B, 2 and 3 (lean, saving and backward LSTM scans)
at ``ROW_GROUP_SHAPES``: dprnn-v1's (H=128; intra T=64, B=96; inter T=3,
B=2048 and 4096, with two directions and, causal, one), conv-bilstm-v1's
(H=256, T=32, B=32) and the main path's training shapes (bilstm-orig,
H=300; lstm-orig, H=600; T=128, B=32), float32 and bfloat16, tanh
candidate, layer-shaped inputs from zero states.  Each planned launch
(``launch_plan``: its rows and row groups G printed) is checked bit for
bit against the G = 1 launch (``groups=1``) and against the plain version
at ``chip_smoke.py`` phase 6's tolerances; then each kernel is timed
(``--reps`` calls) as planned and at each G of ``ROW_GROUP_SWEEP`` up to
one pass per group (a G the card cannot hold at once prints the kernel's
refusal), beside ``torch.nn.LSTM`` in the same dtype (cuDNN's inference
forward, training forward and backward to the input, each with the input
projection).  ``--only`` checks and times only those kernels.

It prints the card's name and power limit first.  There is no CPU
fallback: without a GPU it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def _on_device(e) -> bool:
    return "cuda" in str(getattr(e, "device_type", "")).lower()


def _device_rows(prof, per: int) -> list:
    """(name, ms per step) of the CUDA rows, largest first; the spans'
    device-side copies (a span's extent on the card) left out."""
    rows = []
    for e in prof.key_averages():
        if not _on_device(e) or e.key.startswith("danet."):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((e.key, us / 1e3 / per))
    return sorted(rows, key=lambda r: -r[1])


def _span_rows(prof, per: int) -> list:
    """(name, calls, host ms) per step of the port's spans, largest
    first."""
    rows = [(e.key, e.count / per, e.cpu_time_total / 1e3 / per)
            for e in prof.key_averages()
            if e.key.startswith("danet.") and not _on_device(e)]
    return sorted(rows, key=lambda r: -r[2])


def _report(what: str, prof, per: int, wall_ms: float) -> None:
    unit = "step" if "train" in what else "request"
    rows = _device_rows(prof, per)
    total = sum(ms for _, ms in rows)
    print("profile %s: unprofiled wall %.3f ms per %s; per %s:"
          % (what, wall_ms, unit, unit))
    for name, calls, ms in _span_rows(prof, per):
        print("profile %s   span %-28s %6.2f calls %8.3f host ms"
              % (what, name, calls, ms))
    print("profile %s   kernels %.3f ms of device time" % (what, total))
    for name, ms in rows[:15]:
        print("profile %s   %8.3f ms  %5.1f %%  %s"
              % (what, ms, 100.0 * ms / total, name[:110]))


def _wall_ms(fn, reps: int) -> float:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def profile(encoder: str, dtype: str, attn_backend: str = "flash",
            configs=(), keys=None) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from danet_tpu_torch.data.dataset import WhiteNoiseData
    from danet_tpu_torch.hparams import load_config
    from danet_tpu_torch.serve import Separator
    from danet_tpu_torch.train import Trainer, prepare_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    hp = load_config(*configs, **dict(keys or {}, ENCODER_TYPE=encoder,
                                      COMPUTE_DTYPE=dtype,
                                      ATTN_BACKEND=attn_backend))
    model = hp.get_model()(hp)
    # the model's name: the encoder for DaNet, else MODEL_TYPE (tasnet-v1)
    if getattr(hp, "MODEL_TYPE", "danet") not in ("danet", None):
        encoder = hp.MODEL_TYPE
    ds = WhiteNoiseData(hp, seed=3)
    ds.install_and_load()
    rng = np.random.RandomState(3)
    (flat,) = next(iter(ds.epoch("train", hp.BATCH_SIZE * hp.MAX_N_SIGNAL,
                                 rng=rng)))
    batch = prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL,
                          max_len=hp.MAX_TRAIN_LEN, bucket=hp.TIME_BUCKET,
                          rng=rng)
    tr = Trainer(model, hp, "cuda")
    st = tr.init_state(torch.Generator().manual_seed(0))
    for _ in range(3):
        tr.train_step(st, batch)
    wall = _wall_ms(lambda: tr.train_step(st, batch), 5)
    with torch_profile(activities=acts) as prof:
        for _ in range(5):
            tr.train_step(st, batch)
        torch.cuda.synchronize()
    _report("%s train B=%d T=%d %s" % (encoder, hp.BATCH_SIZE,
                                        batch.shape[2], dtype), prof, 5, wall)

    sep = Separator(model, model.init(torch.Generator().manual_seed(0)),
                    "cuda")
    n = 81856 if encoder == "attn-v1" else 80000
    wav = (np.random.RandomState(4).randn(1, n) * 0.1).astype(np.float32)
    for _ in range(2):
        sep.separate(wav)
    wall = _wall_ms(lambda: sep.separate(wav), 5)
    with torch_profile(activities=acts) as prof:
        for _ in range(5):
            sep.separate(wav)
        torch.cuda.synchronize()
    _report("%s serve 10 s B=1 %s" % (encoder, dtype), prof, 5, wall)


def _key_value(arg: str) -> tuple:
    """'KEY=VALUE' -> (KEY, the value as JSON, else as a string)."""
    key, value = arg.split("=", 1)
    try:
        return key, json.loads(value)
    except json.JSONDecodeError:
        return key, value


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back runs, after
    one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# kernel 3's entry points: (wrapper, plain version, plain training forward,
# directions, H); tolerances (atol, rtol) by dtype, as chip_smoke phase 6
SCAN_BWD_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (5e-2, 2e-2)}


# text cut from kernel 3's source by --cut, to time what is left
SCAN_BWD_CUTS = {
    "fma": [("fma_cols<true>(acc, d, w0, w1, lane, kn);", ";"),
            ("fma_cols<false>(acc, d, w0, w1, lane, kn);", ";")],
    "staging": [("if (j >= n_w) return;", "return;")],
}


def use_variant(kernel: str, sets: dict, cut_table: dict, cuts,
                source: str = "") -> None:
    """Build ``kernel`` (a .cu file of ``source``, by default the package's
    csrc, with the .cuh headers beside it) with constants ``sets`` and the
    parts ``cuts`` of ``cut_table`` changed, into its own library, and
    make the wrappers launch from it.  A cut is a list of (text, its
    replacement), applied wherever the text occurs; it must occur at least
    once."""
    import ctypes
    import glob
    import hashlib
    import os
    import re

    from danet_tpu_torch.ops.cuda import _build

    source = source or _build.CSRC
    files = {os.path.basename(f): open(f).read()
             for f in glob.glob(os.path.join(source, "*.cuh"))
             + [os.path.join(source, kernel)]}
    for name, value in sets.items():
        files[kernel], n = re.subn(r"constexpr int %s = \d+;" % name,
                                   "constexpr int %s = %d;" % (name, value),
                                   files[kernel])
        if n != 1:
            raise ValueError("no constexpr int %s in %s" % (name, kernel))
    for cut in cuts:
        hits = 0
        for old, new in cut_table[cut]:
            for f, text in files.items():
                hits += text.count(old)
                files[f] = text.replace(old, new)
        if not hits:
            raise ValueError("cut %r: none of its text is in %s" % (cut,
                                                                    source))
    out = os.path.join(_build.BUILD_DIR, "variant_%s" % hashlib.sha256(
        repr(sorted(files.items())).encode()).hexdigest()[:16])
    os.makedirs(out, exist_ok=True)
    for f, text in files.items():
        with open(os.path.join(out, f), "w") as fh:
            fh.write(text)
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS + ["-I", out]
    objs = []
    for path in (os.path.join(out, kernel),
                 os.path.join(_build.CSRC, "errors.cu")):
        objs.append(os.path.join(out, os.path.basename(path) + ".o"))
        proc = subprocess.run([nvcc] + flags + ["-Xptxas", "-v", "-c", "-o",
                                                objs[-1], path],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on %s:\n%s" % (path, proc.stderr))
        if path.endswith(kernel):
            print("variant of %s from %s, %s, cut %s: registers %s, spill "
                  "stores %s" % (
                      kernel, source, sets, list(cuts),
                      sorted(set(re.findall(r"Used (\d+) registers",
                                            proc.stderr))),
                      sorted(set(re.findall(r"(\d+) bytes spill stores",
                                            proc.stderr)))))
    lib_path = os.path.join(out, "lib.so")
    subprocess.run([nvcc] + flags + ["-shared", "-o", lib_path] + objs,
                   check=True)
    lib = ctypes.CDLL(lib_path)
    for name, restype, argtypes in _build._SIGNATURES:
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
    _build._lib = lib
    if not any(hasattr(lib, name) for name in (
            "danet_lstm_scan_max_rows", "danet_lstm_scan_bwd_max_rows")):
        # a source without the LSTM kernels' row ceilings (or without an
        # LSTM kernel): the probes' batches, 64 rows at most, launch whole
        from danet_tpu_torch.ops.cuda import lstm as cuda_lstm

        cuda_lstm.max_rows = lambda device, hdim, dtype, kind: 0


def scan_bwd(reps: int, checked: bool = True) -> None:
    from danet_tpu_torch.ops.cuda import lstm as cuda_lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entries = (
        ("lstm_scan_bwd", cuda_lstm.lstm_scan_bwd,
         cuda_lstm.lstm_scan_bwd_plain, cuda_lstm.lstm_scan_train_plain, 1,
         600),
        ("bilstm_scan_bwd", cuda_lstm.bilstm_scan_bwd,
         cuda_lstm.bilstm_scan_bwd_plain,
         cuda_lstm.bilstm_scan_train_plain, 2, 300))
    rs = np.random.RandomState(6)
    failed = []
    for name, kernel, plain, fwd, d, h in entries:
        for dt in (torch.float32, torch.bfloat16):
            for t, b in ((128, 32), (64, 33)):
                lead = (t, b) if d == 1 else (t, d, b)
                scale = (1.15 if d == 1 else 0.75) / np.sqrt(h)
                bias = np.repeat(np.array([0.0, 1.5, -1.0, 1.0]), h)
                arrays = (rs.randn(*lead, 4 * h) * 0.5 + bias,
                          rs.uniform(-scale, scale, (d, h, 4 * h)[2 - d:]),
                          rs.randn(*lead[1:], h) * 0.5,
                          rs.uniform(-0.5, 0.5, lead[1:] + (h,)),
                          rs.randn(*lead, h))
                xp, wh, c0, h0, d_hs = (
                    torch.from_numpy(a.astype(np.float32)).cuda().to(dt)
                    for a in arrays)
                _, cs, acts = fwd(xp, wh, c0, h0, True)
                args = (d_hs, acts, cs, torch.cat([c0[None], cs[:-1]]), wh,
                        True)
                out, ref = kernel(*args), plain(*args)
                torch.cuda.synchronize()
                atol, rtol = SCAN_BWD_TOL[dt]
                errs = []
                for o, r in zip(out, ref):
                    diff = (o.float() - r.float()).abs()
                    errs.append(float(diff.max()))
                    if not torch.isfinite(o.float()).all() or not bool(
                            (diff <= atol + rtol * r.float().abs()).all()):
                        failed.append((name, str(dt), t, b))
                ms = cuda_ms(lambda: kernel(*args), reps)
                print("scan-bwd %s %s T=%d B=%d H=%d: dxp/dc0/dh0 max abs "
                      "err %.3g/%.3g/%.3g (atol %g rtol %g); kernel %.4f ms, "
                      "%.3f us/step" % (name, str(dt).replace("torch.", ""),
                                        t, b, h, *errs, atol, rtol, ms,
                                        1e3 * ms / t))
        lstm = torch.nn.LSTM(600, h, bidirectional=d == 2).cuda()
        x = torch.randn(128, 32, 600, device="cuda", requires_grad=True)
        y, _ = lstm(x)
        g = torch.randn_like(y)
        lib = cuda_ms(lambda: torch.autograd.grad(y, x, g, retain_graph=True),
                      reps)
        print("scan-bwd %s library torch.nn.LSTM(600, %d%s) backward to the "
              "input, float32 T=128 B=32: %.4f ms"
              % (name, h, ", bidirectional" if d == 2 else "", lib))
    if failed and checked:
        sys.exit("scan-bwd: beyond tolerance: %s" % failed)


# text cut from kernel 4f's source by gru-fwd --cut, to time what is left;
# the first entries of each cut serve gru_scan.cu's exchange of tagged words
# or flagged values, the others the earlier design with grid barriers and
# row_contract.cuh's chunked staging (gru-fwd --source)
GRU_FWD_CUTS = {
    "staging": [("stage_tagged(d_s, row.words + off, row.step, rows * hdim);",
                 ";"),
                ("stage_values(d_s, row.values + off, rows * hdim);", ";"),
                ("wait_flags(row.flags, row.step);", ";"),
                ("for (int e0 = tid; e0 < n; e0 += THREADS * LOADS) {",
                 "for (int e0 = n; e0 < n; e0 += THREADS * LOADS) {")],
    "barrier": [("static_cast<int>(w[j] >> 32) != tag;",
                 "static_cast<int>(w[j] >> 32) != tag && false;"),
                ("wait_flags(row.flags, row.step);", ";"),
                ("grid.sync();  // c * r of every unit complete", ";//"),
                ("grid.sync();  // c_t complete", ";//")],
    "fma": [("fma_rows<true>(acc, w, d, hdim, kw * LK + kl, kw_n * LK, "
             "mine);", ";"),
            ("fma_rows<false>(acc, w, d, hdim, kw * LK + kl, kw_n * LK, "
             "mine);", ";"),
            ("tile_fma<C, KS, true>(acc, w_s, d_s, k0, kn, ks, cg, bg, "
             "mine);", ";"),
            ("tile_fma<C, KS, false>(acc, w_s, d_s, k0, kn, ks, cg, bg, "
             "mine);", ";")],
    "gates": [("if (own0) {", "if (false) {"),
              ("if (e != tid) {", "if (false) {"),
              ("if (e != tid) gc =", "if (false) gc ="),
              ("to_f32(g[0])", "0.f"), ("to_f32(g[hdim])", "0.f"),
              ("to_f32(cx[h_off + ix])", "0.f")],
}


def _gru_arrays(rs, t: int, b: int, h: int = 600) -> tuple:
    """gru-v1-shaped inputs at ten times its init scale (chip_smoke.py
    phase 9): gx [T, B, 2H], cx [T, B, H], wgh, wch, c0, float32 numpy."""
    scale = 1.0 / np.sqrt(h)
    x = rs.randn(t * b, h).astype(np.float32) * 0.5
    gx = x @ rs.uniform(-scale, scale, (h, 2 * h)).astype(np.float32)
    cx = x @ rs.uniform(-scale, scale, (h, h)).astype(np.float32) + 1.0
    return (gx.reshape(t, b, 2 * h), cx.reshape(t, b, h),
            rs.uniform(-scale, scale, (h, 2 * h)),
            rs.uniform(-scale, scale, (h, h)), rs.randn(b, h) * 0.5)


def gru_fwd(reps: int, checked: bool = True) -> None:
    from danet_tpu_torch.ops.cuda import gru as cuda_gru

    rs = np.random.RandomState(9)
    failed = []
    for name, t, b in (("gru_scan", 1251, 1), ("gru_scan_train", 128, 32)):
        kernel = getattr(cuda_gru, name)
        plain = getattr(cuda_gru, name + "_plain")
        arrays = _gru_arrays(rs, t, b)
        for dt in (torch.float32, torch.bfloat16):
            args = [torch.from_numpy(np.asarray(a, np.float32)).cuda().to(dt)
                    for a in arrays]
            out, ref = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            out = out if isinstance(out, tuple) else (out,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            atol, rtol = (1e-5, 0.0) if dt == torch.float32 else (5e-2, 2e-2)
            errs = []
            for o, r in zip(out, ref):
                diff = (o.float() - r.float()).abs()
                errs.append(float(diff.max()))
                if not torch.isfinite(o.float()).all() or not bool(
                        (diff <= atol + rtol * r.float().abs()).all()):
                    failed.append((name, str(dt)))
            ms = cuda_ms(lambda: kernel(*args), reps)
            print("gru-fwd %s %s T=%d B=%d H=600: max abs err %s (atol %g "
                  "rtol %g); kernel %.4f ms, %.3f us/step"
                  % (name, str(dt).replace("torch.", ""), t, b,
                     "/".join("%.3g" % e for e in errs), atol, rtol, ms,
                     1e3 * ms / t))
    sweep = []
    for b in (1, 2, 4, 8, 16, 32):
        args = [torch.from_numpy(np.asarray(a, np.float32)).cuda()
                for a in _gru_arrays(rs, 501, b)]
        ms = cuda_ms(lambda: cuda_gru.gru_scan(*args), reps)
        sweep.append("B=%d %.3f" % (b, 1e3 * ms / 501))
    print("gru-fwd gru_scan float32 T=501 H=600 us/step by batch: %s"
          % ", ".join(sweep))
    if failed and checked:
        sys.exit("gru-fwd: beyond tolerance: %s" % failed)


# text cut from kernel B's source by lstm-fwd --cut, to time what is left;
# the first entries of each cut serve lstm_scan_lean.cu's exchange of
# tagged words or flagged values, the last the earlier design in
# bilstm_scan.cu (grid barriers and element-wise h_s staging)
LSTM_FWD_CUTS = {
    "staging": [("stage_tagged(d, w_in, t - 1, batch * hdim);", ";"),
                ("stage_values(d_s, h_in + static_cast<size_t>(p0) * hdim, "
                 "rows * hdim);", ";"),
                ("wait_flags(flags, t - 1);", ";"),
                ("for (size_t e = tid; e < bh; e += THREADS) h_s[e] = "
                 "load_cg(hprev + e);", ";")],
    "barrier": [("static_cast<int>(w[j] >> 32) != tag;",
                 "static_cast<int>(w[j] >> 32) != tag && false;"),
                ("wait_flags(flags, t - 1);", ";"),
                ("grid.sync();  // h_t complete", ";//")],
    "fma": [("if (live) {", "if (false) {"),
            ("fma_live(mine, acc, w, d, hdim, kw * LK + kl, kw_n * LK);",
             ";"),
            ("acc[bb] = fmaf(h_s[(b0 + bb) * hdim + k], w, acc[bb]);", ";")],
    "gates": [("if (owner) gate_inputs(", "if (false) gate_inputs("),
              ("if (own0) gate_inputs(", "if (false) gate_inputs("),
              ("if (p0 > 0 || e != tid) gate_inputs(",
               "if (false) gate_inputs("),
              ("to_f32(xp_t[static_cast<size_t>(b) * g4 + g * hdim + unit])",
               "0.f")],
}
# chip_smoke.py phase 4's tolerances of the lean kernels (atol)
LEAN_ATOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


def _lean_kernels(legacy: bool) -> dict:
    """bilstm_scan and lstm_scan by name; for the earlier design (legacy),
    callers of its entry points, which take no exchange scratch."""
    from danet_tpu_torch.ops.cuda import lstm as cuda_lstm

    if not legacy:
        return {"bilstm_scan": cuda_lstm.bilstm_scan,
                "lstm_scan": cuda_lstm.lstm_scan}
    out = {}
    for name, d in (("bilstm_scan", 2), ("lstm_scan", 1)):
        def call(xp, wh, c0, h0, tanh_cand,
                 launch=_legacy_call("danet_" + name, 5), d=d):
            t, b, h = cuda_lstm._fwd_shapes(xp, wh, c0, h0, d)
            hs = torch.empty((t,) + cuda_lstm._dirs(d, b, h),
                             dtype=xp.dtype, device=xp.device)
            launch((xp, wh, c0, h0, hs),
                   (t, b, h, cuda_lstm._DTYPE_CODES[xp.dtype],
                    int(bool(tanh_cand))))
            return hs
        out[name] = call
    return out


def _lstm_arrays(rs, t: int, b: int, d: int, h: int) -> tuple:
    """Layer-shaped inputs of bilstm-orig (d=2, H=300) or lstm-orig (d=1,
    H=600), input width 600: xp = x @ Wx + gate bias, Wx and Wh at the
    encoder's init scale, nonzero c0 and h0; float32 numpy."""
    scale = (0.75 if d == 2 else 1.15) / np.sqrt(h)
    bias = np.repeat(np.array([0.0, 1.5, -1.0, 1.0], np.float32), h)
    x = rs.randn(d, t * b, 600).astype(np.float32) * 0.5
    wx = rs.uniform(-scale, scale, (d, 600, 4 * h)).astype(np.float32)
    xp = (np.matmul(x, wx) + bias).reshape(d, t, b, 4 * h).transpose(
        1, 0, 2, 3)
    lead = (d,) if d == 2 else ()
    return (xp if d == 2 else xp[:, 0],
            rs.uniform(-scale, scale, lead + (h, 4 * h)),
            rs.randn(*lead, b, h) * 0.5, rs.uniform(-0.5, 0.5, lead + (b, h)))


def lstm_fwd(reps: int, legacy: bool, checked: bool = True) -> None:
    from danet_tpu_torch.ops.cuda import _build
    from danet_tpu_torch.ops.cuda import lstm as cuda_lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rs = np.random.RandomState(10)
    kernels = _lean_kernels(legacy)
    failed = []
    for name, d, h in (("bilstm_scan", 2, 300), ("lstm_scan", 1, 600)):
        kernel, plain = kernels[name], getattr(cuda_lstm, name + "_plain")
        lstm = torch.nn.LSTM(600, h, bidirectional=d == 2).cuda()
        for t, b in ((1251, 1), (1251, 4), (128, 32)):
            arrays = _lstm_arrays(rs, t, b, d, h)
            xs = torch.from_numpy(rs.randn(t, b, 600).astype(
                np.float32)).cuda()
            with torch.no_grad():
                lib = cuda_ms(lambda: lstm(xs), reps)
            for dt in (torch.float32, torch.bfloat16):
                args = [torch.from_numpy(np.ascontiguousarray(
                    a, np.float32)).cuda().to(dt) for a in arrays] + [True]
                out, ref = kernel(*args), plain(*args)
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                ok = out.dtype == dt and bool(torch.isfinite(
                    out.float()).all()) and err <= LEAN_ATOL[dt]
                if not ok:
                    failed.append((name, str(dt), t, b))
                ms = cuda_ms(lambda: kernel(*args), reps)
                state = ""
                if name == "lstm_scan" and hasattr(_build.library(),
                                                   "danet_lstm_scan_state"):
                    # the state entry (return_state): float32 c0 and c_T
                    sargs = args[:2] + [args[2].float()] + args[3:]
                    state = "; state entry %.4f ms" % cuda_ms(
                        lambda: kernel(*sargs, return_state=True), reps)
                print("lstm-fwd %s %s T=%d B=%d H=%d: max abs err %.3g (atol "
                      "%g)%s, digest %s; kernel %.4f ms, %.3f us/step%s%s"
                      % (name, str(dt).replace("torch.", ""), t, b, h, err,
                         LEAN_ATOL[dt], "" if ok else " FAIL",
                         _digest([out]), ms, 1e3 * ms / t, state,
                         "; torch.nn.LSTM(600, %d%s) %.4f ms" % (
                             h, ", bidirectional" if d == 2 else "", lib)
                         if dt == torch.float32 else ""))
        sweep = []
        for b in (1, 2, 4, 8, 16, 32):
            args = [torch.from_numpy(np.ascontiguousarray(a, np.float32))
                    .cuda() for a in _lstm_arrays(rs, 501, b, d, h)] + [True]
            ms = cuda_ms(lambda: kernel(*args), reps)
            sweep.append("B=%d %.3f" % (b, 1e3 * ms / 501))
        print("lstm-fwd %s float32 T=501 H=%d us/step by batch: %s"
              % (name, h, ", ".join(sweep)))
    if failed and checked:
        sys.exit("lstm-fwd: beyond tolerance: %s" % failed)


# chip_smoke.py phase 6's (atol, rtol) of the training forwards and of the
# backwards, by dtype (phases 8 and 9 hold the one-direction LSTM and the
# GRU to them)
TRAIN_FWD_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (5e-2, 2e-2)}
# the shapes gru-bwd and lstm-train check: the training batch, phase 6's
# ragged one, a 10 s request's length at B=1; then the batches they time
TRAIN_SHAPES = ((128, 32), (64, 33), (1251, 1))
TRAIN_SWEEP = (32, 64, 128)


# (what, T, B, H, input width, directions) of row-groups
ROW_GROUP_SHAPES = (
    ("dprnn-v1 intra", 64, 96, 128, 128, 2),
    ("dprnn-v1 inter", 3, 2048, 128, 128, 2),
    ("dprnn-v1 inter", 3, 4096, 128, 128, 2),
    ("dprnn-v1 inter causal", 3, 2048, 128, 128, 1),
    ("dprnn-v1 inter causal", 3, 4096, 128, 128, 1),
    ("conv-bilstm-v1", 32, 32, 256, 512, 2),
    ("bilstm-orig", 128, 32, 300, 600, 2),
    ("lstm-orig", 128, 32, 600, 600, 1),
)
ROW_GROUP_SWEEP = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


def _layer(rs, t: int, b: int, h: int, i_dim: int, d: int, dt) -> tuple:
    """Layer-shaped inputs on the card in ``dt``: xp = x @ Wx + gate bias,
    Wx and Wh ~ U(-1/sqrt(H), 1/sqrt(H)), zero c0 and h0, a cotangent d_hs;
    without the direction axis for one direction."""
    scale = 1.0 / np.sqrt(h)
    x = rs.randn(d, t * b, i_dim).astype(np.float32) * 0.5
    wx = rs.uniform(-scale, scale, (d, i_dim, 4 * h)).astype(np.float32)
    xp = (np.matmul(x, wx) + np.repeat(np.float32([0.0, 1.0, -1.0, 1.0]), h)
          ).reshape(d, t, b, 4 * h).transpose(1, 0, 2, 3)
    wh = rs.uniform(-scale, scale, (d, h, 4 * h))
    z = np.zeros((d, b, h))
    d_hs = rs.randn(t, d, b, h)
    out = (xp, wh, z, z, d_hs) if d == 2 else (xp[:, 0], wh[0], z[0], z[0],
                                               d_hs[:, 0])
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 .cuda().to(dt) for a in out)


def _nn_lstm(rs, t: int, b: int, h: int, i_dim: int, d: int, dt,
             reps: int) -> tuple:
    """torch.nn.LSTM (cuDNN) in ``dt`` at this shape, ms: the inference
    forward, the training forward and the backward to the input."""
    lstm = torch.nn.LSTM(i_dim, h, bidirectional=d == 2).cuda().to(dt)
    lstm.flatten_parameters()   # one weight buffer, as cuDNN wants it
    x = torch.from_numpy(rs.randn(t, b, i_dim).astype(np.float32)).cuda() \
        .to(dt)
    with torch.no_grad():
        lean = cuda_ms(lambda: lstm(x), reps)
    xt = x.clone().requires_grad_(True)
    fwd = cuda_ms(lambda: lstm(xt), reps)
    y, _ = lstm(xt)
    g = torch.randn_like(y)
    bwd = cuda_ms(lambda: torch.autograd.grad(y, xt, g, retain_graph=True),
                  reps)
    return lean, fwd, bwd


def row_groups(reps: int, only) -> None:
    from danet_tpu_torch.ops.cuda import lstm as cuda_lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rs = np.random.RandomState(24)
    kinds = ("lean", "save", "bwd")
    failed = []
    for what, t, b, h, i_dim, d in ROW_GROUP_SHAPES:
        pre = "bi" if d == 2 else ""
        names = [pre + n for n in ("lstm_scan", "lstm_scan_train",
                                   "lstm_scan_bwd")]
        kern = [getattr(cuda_lstm, n) for n in names]
        plain = [getattr(cuda_lstm, n + "_plain") for n in names]
        for dt in (torch.float32, torch.bfloat16):
            xp, wh, c0, h0, d_hs = _layer(rs, t, b, h, i_dim, d, dt)
            args = (xp, wh, c0, h0, True)
            _, cs, acts = plain[1](*args)
            bargs = (d_hs, acts, cs, torch.cat([c0[None], cs[:-1]]), wh,
                     True)
            tag = "%s %s T=%d B=%d H=%d" % (
                what, str(dt).replace("torch.", ""), t, b, h)
            lib = _nn_lstm(rs, t, b, h, i_dim, d, dt, reps)
            for kind, name, k, p, a, tol, lib_ms in zip(
                    kinds, names, kern, plain, (args, args, bargs),
                    (TRAIN_FWD_TOL[dt], TRAIN_FWD_TOL[dt], SCAN_BWD_TOL[dt]),
                    lib):
                if only and kind not in only:
                    continue
                plan = cuda_lstm.launch_plan(xp.device, b, h, d, dt, kind)
                got, one, ref = k(*a), k(*a, groups=1), p(*a)
                got = got if isinstance(got, tuple) else (got,)
                one = one if isinstance(one, tuple) else (one,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(got, one))
                errs = [float((x.float() - y.float()).abs().max())
                        for x, y in zip(got, ref)]
                ok = same and all(
                    bool(torch.isfinite(x.float()).all()) and bool(
                        ((x.float() - y.float()).abs()
                         <= tol[0] + tol[1] * y.float().abs()).all())
                    for x, y in zip(got, ref))
                if not ok:
                    failed.append((tag, name))
                times = []
                for g in ROW_GROUP_SWEEP:
                    if g > -(-b // cuda_lstm.PASS):
                        continue
                    try:
                        times.append("G=%d %.4f" % (g, cuda_ms(
                            lambda: k(*a, groups=g), reps)))
                    except RuntimeError as e:
                        times.append("G=%d refused (%s)" % (
                            g, str(e).split(":")[-1].strip()))
                print("row-groups %s %s: launches (rows, G) %s; bit for bit "
                      "with G=1 %s; max abs err %s (atol %g rtol %g)%s; "
                      "digest %s; planned %.4f ms; ms %s; nn.LSTM %.4f ms"
                      % (tag, name, plan, same,
                         ", ".join("%.3g" % e for e in errs), *tol,
                         "" if ok else " FAIL", _digest(got),
                         cuda_ms(lambda: k(*a), reps), ", ".join(times),
                         lib_ms))
    if failed:
        sys.exit("row-groups: failed: %s" % failed)


def _digest(outs) -> str:
    """The first 12 hex digits of a SHA-1 of the outputs' bytes: equal
    digests from two builds mean bit-identical outputs."""
    import hashlib

    h = hashlib.sha1()
    for o in outs:
        h.update(o.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:12]


def _check_train(what: str, name: str, names, out, ref, dt, tol, t: int,
                 b: int, ms: float, extra: str = "", h: int = 600) -> bool:
    """Print one checked line (max abs errors, digest, time); True if every
    output is finite, of its reference's dtype and within atol + rtol."""
    atol, rtol = tol
    errs, ok = [], True
    for o, r in zip(out, ref):
        diff = (o.float() - r.float()).abs()
        errs.append("%s %.6g" % (names[len(errs)], float(diff.max())))
        ok &= o.dtype == r.dtype and bool(torch.isfinite(o.float()).all()) \
            and bool((diff <= atol + rtol * r.float().abs()).all())
    print("%s %s %s T=%d B=%d H=%d: max abs err %s (atol %g rtol %g)%s; "
          "digest %s; kernel %.4f ms, %.3f us/step%s"
          % (what, name, str(dt).replace("torch.", ""), t, b, h,
             ", ".join(errs), atol, rtol, "" if ok else " FAIL", _digest(out),
             ms, 1e3 * ms / t, extra))
    return ok


def _sweep(what: str, name: str, make, run, plain, tol, h: int = 600) -> list:
    """float32 us per step at T=128 for each batch of TRAIN_SWEEP, each
    output held to the plain version at tol (the worst error printed); a
    batch the kernel refuses prints its error.  Returns the batches beyond
    tolerance."""
    parts, failed = [], []
    atol, rtol = tol
    for b in TRAIN_SWEEP:
        args = make(b)
        try:
            out, ref = run(*args), plain(*args)
        except RuntimeError as e:
            parts.append("B=%d refused (%s)" % (b, str(e).split(": ", 1)[-1]))
            continue
        diffs = [(o.float() - r.float()).abs() for o, r in zip(out, ref)]
        if not all(bool((d <= atol + rtol * r.float().abs()).all())
                   for d, r in zip(diffs, ref)):
            failed.append(b)
        parts.append("B=%d %.3f (max abs err %.3g%s)" % (
            b, 1e3 * cuda_ms(lambda: run(*args), 10) / 128,
            max(float(d.max()) for d in diffs), "" if b not in failed
            else " FAIL"))
    print("%s %s float32 T=128 H=%d us/step by batch: %s"
          % (what, name, h, ", ".join(parts)))
    return failed


# text cut from kernel 4b's source by gru-bwd --cut, to time what is left;
# the first entries of each cut serve gru_scan_bwd.cu's flags and cp.async
# rows, the others the earlier design with grid barriers and
# row_contract.cuh's chunked staging (gru-bwd --source)
GRU_BWD_CUTS = {
    "staging": [("for (int r = threadIdx.x / 32; r < rows; "
                 "r += THREADS / 32) {",
                 "for (int r = rows; r < rows; r += THREADS / 32) {"),
                ("wait_flags(flag_x, step);", ";"),
                ("wait_flags(flag_g, step);", ";"),
                ("for (int e0 = tid; e0 < n; e0 += THREADS * LOADS) {",
                 "for (int e0 = n; e0 < n; e0 += THREADS * LOADS) {")],
    "barrier": [("wait_flags(flag_x, step);", ";"),
                ("wait_flags(flag_g, step);", ";"),
                ("grid.sync();  // dcx[t] complete", ";//"),
                ("grid.sync();  // dgx[t] complete", ";//")],
    "fma": [("for (int k = k0; k < n; k += step) {",
             "for (int k = n; k < n; k += step) {"),
            ("tile_fma<C, KS, true>(acc, w_s, d_s, k0, kn, ks, cg, bg, "
             "mine);", ";"),
            ("tile_fma<C, KS, false>(acc, w_s, d_s, k0, kn, ks, cg, bg, "
             "mine);", ";")],
}


def _legacy_call(entry: str, n_ptrs: int):
    """A caller of the earlier design's C entry ``entry``, which takes no
    exchange scratch: n_ptrs tensors, then the ints and the stream."""
    import ctypes

    from danet_tpu_torch.ops.cuda import _build
    from danet_tpu_torch.ops.cuda import lstm as cuda_lstm

    getattr(_build.library(), entry).argtypes = [ctypes.c_void_p] * n_ptrs \
        + [ctypes.c_int] * (5 if "lstm" in entry else 4) + [ctypes.c_void_p]

    def call(tensors, ints):
        cuda_lstm._launch(entry, entry, tensors[0].device, tensors, ints)
    return call


def gru_bwd(reps: int, legacy: bool, checked: bool = True) -> None:
    from danet_tpu_torch.ops.cuda import gru as cuda_gru
    from danet_tpu_torch.ops.cuda import lstm as cuda_lstm

    kernel = cuda_gru.gru_scan_bwd
    if legacy:
        launch = _legacy_call("danet_gru_scan_bwd", 8)

        def kernel(d_cs, acts, c_prev, wgh, wch):
            t, b, h = d_cs.shape
            outs = (d_cs.new_empty((t, b, 2 * h)), torch.empty_like(d_cs),
                    d_cs.new_empty((b, h)))
            launch((d_cs, acts, c_prev, wgh, wch) + outs,
                   (t, b, h, cuda_lstm._DTYPE_CODES[d_cs.dtype]))
            return outs

    rs = np.random.RandomState(14)

    def inputs(t, b, dt):
        """phase 9's: _gru_arrays and a cotangent, residuals from the
        plain training forward"""
        arrays = _gru_arrays(rs, t, b) + (rs.randn(t, b, 600),)
        gx, cx, wgh, wch, c0, d_cs = (
            torch.from_numpy(np.asarray(a, np.float32)).cuda().to(dt)
            for a in arrays)
        cs, acts = cuda_gru.gru_scan_train_plain(gx, cx, wgh, wch, c0)
        return d_cs, acts, torch.cat([c0[None], cs[:-1]]), wgh, wch

    failed = []
    for t, b in TRAIN_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            args = inputs(t, b, dt)
            out, ref = kernel(*args), cuda_gru.gru_scan_bwd_plain(*args)
            torch.cuda.synchronize()
            if not _check_train("gru-bwd", "gru_scan_bwd",
                                ("dgx", "dcx", "dc0"), out, ref, dt,
                                SCAN_BWD_TOL[dt], t, b,
                                cuda_ms(lambda: kernel(*args), reps)):
                failed.append((str(dt), t, b))
    failed += _sweep("gru-bwd", "gru_scan_bwd",
                     lambda b: inputs(128, b, torch.float32), kernel,
                     cuda_gru.gru_scan_bwd_plain, SCAN_BWD_TOL[torch.float32])
    if failed and checked:
        sys.exit("gru-bwd: beyond tolerance: %s" % failed)


def lstm_train(reps: int, legacy: bool, checked: bool = True,
               dirs: int = 1) -> None:
    from danet_tpu_torch.ops.cuda import lstm as cuda_lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prefix, h = ("lstm", 600) if dirs == 1 else ("bilstm", 300)
    name = prefix + "_scan_train"
    kernel = getattr(cuda_lstm, name)
    plain = getattr(cuda_lstm, name + "_plain")
    if legacy:
        launch = _legacy_call("danet_" + name, 7)

        def kernel(xp, wh, c0, h0, tanh_cand):
            t, b, hdim = cuda_lstm._fwd_shapes(xp, wh, c0, h0, dirs)
            hs = xp.new_empty((t,) + cuda_lstm._dirs(dirs, b, hdim))
            outs = (hs, torch.empty_like(hs), torch.empty_like(xp))
            launch((xp, wh, c0, h0) + outs,
                   (t, b, hdim, cuda_lstm._DTYPE_CODES[xp.dtype],
                    int(bool(tanh_cand))))
            return outs

    rs = np.random.RandomState(15)

    def inputs(t, b, dt):
        return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
                .to(dt) for a in _lstm_arrays(rs, t, b, dirs, h)] + [True]

    lstm = torch.nn.LSTM(600, h, bidirectional=dirs == 2).cuda()
    lib_name = "torch.nn.LSTM(600, %d%s)" % (
        h, ", bidirectional" if dirs == 2 else "")
    failed = []
    for t, b in TRAIN_SHAPES:
        xs = torch.from_numpy(rs.randn(t, b, 600).astype(
            np.float32)).cuda().requires_grad_(True)
        lib = cuda_ms(lambda: lstm(xs), reps)
        for dt in (torch.float32, torch.bfloat16):
            args = inputs(t, b, dt)
            out, ref = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            if not _check_train(
                    "lstm-train", name, ("hs", "cs", "acts"),
                    out, ref, dt, TRAIN_FWD_TOL[dt], t, b,
                    cuda_ms(lambda: kernel(*args), reps),
                    "; %s training forward %.4f ms" % (lib_name, lib)
                    if dt == torch.float32 else "", h):
                failed.append((str(dt), t, b))
    failed += _sweep("lstm-train", name,
                     lambda b: inputs(128, b, torch.float32), kernel, plain,
                     TRAIN_FWD_TOL[torch.float32], h)
    if failed and checked:
        sys.exit("lstm-train: beyond tolerance: %s" % failed)


def flash_fwd(reps: int) -> None:
    from danet_tpu_torch.ops.cuda import attention as cuda_attn

    rs = np.random.RandomState(13)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    sdpa = torch.nn.functional.scaled_dot_product_attention
    failed = []
    for dt in (torch.float32, torch.bfloat16):
        for b, t in ((1, 1280), (32, 128)):
            qkv = torch.from_numpy(rs.randn(b, t, 3, 4, 64).astype(
                np.float32)).cuda().to(dt)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            seg = torch.zeros(b, t, dtype=torch.int32)
            seg[-1, t - 37:] = 1
            seg = seg.cuda()
            args = (q, k, v, seg, 0.125)
            splits = cuda_attn.flash_splits(b, t, 4, n_sm)
            out, ref = cuda_attn.flash_attn(*args), \
                cuda_attn.flash_attn_plain(*args)
            torch.cuda.synchronize()
            atol, rtol = (1e-5, 0.0) if dt == torch.float32 else (5e-2, 2e-2)
            diff = (out[0].float() - ref[0].float()).abs()
            ok = bool((diff <= atol + rtol * ref[0].float().abs()).all()) \
                and bool(((out[1] - ref[1]).abs() <= 1e-5 * ref[1]).all()) \
                and bool(((out[2] - ref[2]).abs() <= 1e-5).all())
            if not ok:
                failed.append((str(dt), b, t))
            line = "flash-fwd %s B=%d T=%d H=4 D=64: o max abs err %.3g%s; " \
                "S=%d %.4f ms" % (str(dt).replace("torch.", ""), b, t,
                                  float(diff.max()), "" if ok else " FAIL",
                                  splits,
                                  cuda_ms(lambda: cuda_attn.flash_attn(
                                      *args), reps))
            if splits != 1:
                line += ", S=1 %.4f ms" % cuda_ms(
                    lambda: cuda_attn.flash_attn(*args, splits=1), reps)
            if dt == torch.float32:
                qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
                mask = seg[:, None, :, None] == seg[:, None, None, :]
                with torch.no_grad():
                    line += ", SDPA %.4f ms" % cuda_ms(
                        lambda: sdpa(qs, ks, vs, attn_mask=mask), reps)
            print(line)
    if failed:
        sys.exit("flash-fwd: beyond tolerance: %s" % failed)


def device_ms(fn, reps: int, key: str):
    """Device time of one run of ``fn``: the ``torch.profiler`` CUDA rows
    whose kernel name holds ``key`` (every row for ""), summed over
    ``reps`` runs after a warm-up, per run; None if no row matches."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [ms for name, ms in _device_rows(prof, reps) if key in name]
    return sum(rows) if rows else None


def _ms(v) -> str:
    return "none" if v is None else "%.4f" % v


# text cut from the backward kernels' source by flash-bwd --cut, to time
# what is left: the tile products (5dkv's four, 5dq's three), the per-tile
# copies (5dkv: Q and dO; 5dq: K and V)
FLASH_BWD_CUTS = {
    "products": [("flash::tile_abt16<T, D>(ds, do_s, v_s, tx, ty);", ";"),
                 ("flash::tile_abt16<T, D>(p, q_s, k_s, tx, ty);", ";"),
                 ("flash::tile_pb16<T, D>(dv_acc, pt_s, do_s, tx, ty);",
                  ";"),
                 ("flash::tile_pb16<T, D>(dk_acc, dst_s, q_s, tx, ty);",
                  ";"),
                 ("flash::tile_abt16<T, D, DQ_ROWS>(ds, do_s, v_s, tx, ty);",
                  ";"),
                 ("flash::tile_abt16<T, D, DQ_ROWS>(p, q_s, k_s, tx, ty);",
                  ";"),
                 ("flash::tile_pb16<T, D, DQ_ROWS>(dq_acc, ds_s, k_s, tx, "
                  "ty);", ";")],
    "staging": [("stage_tile<T, D>(do_s, dout, sd, b, q0, h);", ";"),
                ("stage_tile<T, D>(q_s, q, st, b, q0, h);", ";"),
                ("stage_tile<T, D, DQ_THREADS>(v_s, v, st, b, kt, h);", ";"),
                ("stage_tile<T, D, DQ_THREADS>(k_s, k, st, b, kt, h);",
                 ";")],
}
# chip_smoke.py phase 13's shapes (T, B) and the flash kernels' widths
FLASH_SHAPES = ((1280, 1), (128, 32), (384, 1))
FLASH_H, FLASH_D = 4, 64


def _flash_bwd_args(rs, t: int, b: int, dt) -> tuple:
    """phase 13's backward inputs: q, k, v views of one [B, T, 3, H, D]
    projection, the last row's final 37 frames padded, a cotangent do, l
    and m from the plain forward, di = rowsum(o do)."""
    from danet_tpu_torch.ops.cuda import attention as cuda_attn

    qkv, do = (torch.from_numpy(a.astype(np.float32)).cuda().to(dt) for a in
               (rs.randn(b, t, 3, FLASH_H, FLASH_D),
                rs.randn(b, t, FLASH_H, FLASH_D)))
    seg = torch.zeros(b, t, dtype=torch.int32)
    seg[-1, t - 37:] = 1
    args = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], seg.cuda(),
            1.0 / FLASH_D ** 0.5)
    o, l, m = cuda_attn.flash_attn_plain(*args)
    di = torch.sum(o.float() * do.float(), dim=-1).transpose(1, 2)
    return args[:4] + (l, m, do, di.contiguous(), args[4])


def _sdpa_bwd(rs, t: int, b: int):
    """SDPA's backward (dq, dk, dv in one call) at (T, B), float32, with
    the boolean segment-equality mask: a function to time."""
    q, k, v = (torch.from_numpy(rs.randn(b, FLASH_H, t, FLASH_D).astype(
        np.float32)).cuda().requires_grad_(True) for _ in range(3))
    seg = torch.zeros(b, t, dtype=torch.int32)
    seg[-1, t - 37:] = 1
    mask = (seg[:, None, :, None] == seg[:, None, None, :]).cuda()
    y = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                         attn_mask=mask)
    g = torch.randn_like(y)
    return lambda: torch.autograd.grad(y, (q, k, v), g, retain_graph=True)


def flash_bwd(reps: int, checked: bool = True) -> None:
    from danet_tpu_torch.ops.cuda import attention as cuda_attn

    rs = np.random.RandomState(13)
    failed = []
    for dt in (torch.float32, torch.bfloat16):
        atol, rtol = (2e-5, 1e-4) if dt == torch.float32 else (5e-2, 2e-2)
        for t, b in FLASH_SHAPES:
            bargs = _flash_bwd_args(rs, t, b, dt)
            for name, key, names in (
                    ("flash_attn_bwd_dkv", "flash_bwd_dkv_kernel",
                     ("dk", "dv")),
                    ("flash_attn_bwd_dq", "flash_bwd_dq_kernel", ("dq",))):
                kernel = getattr(cuda_attn, name)
                out, ref = kernel(*bargs), getattr(cuda_attn,
                                                   name + "_plain")(*bargs)
                out, ref = ((out,), (ref,)) if len(names) == 1 else (out,
                                                                     ref)
                torch.cuda.synchronize()
                errs, ok = [], True
                for n, o, r in zip(names, out, ref):
                    diff = (o.float() - r.float()).abs()
                    errs.append("%s %.6g" % (n, float(diff.max())))
                    ok &= bool(torch.isfinite(o.float()).all()) and bool(
                        (diff <= atol + rtol * r.float().abs()).all())
                if not ok:
                    failed.append((name, str(dt), t, b))
                line = ("flash-bwd %s %s T=%d B=%d H=%d D=%d: max abs err %s "
                        "(atol %g rtol %g)%s; digest %s" % (
                            name, str(dt).replace("torch.", ""), t, b,
                            FLASH_H, FLASH_D, ", ".join(errs), atol, rtol,
                            "" if ok else " FAIL", _digest(out)))
                if dt == torch.float32:
                    run = lambda: kernel(*bargs)  # noqa: E731
                    line += "; ms %.4f, device ms %s" % (
                        cuda_ms(run, reps), _ms(device_ms(run, reps, key)))
                print(line)
            if dt == torch.float32 and b > 1:
                sdpa = _sdpa_bwd(rs, t, b)
                print("flash-bwd SDPA backward (dq, dk, dv) float32 T=%d "
                      "B=%d: ms %.4f, device ms %s" % (
                          t, b, cuda_ms(sdpa, reps),
                          _ms(device_ms(sdpa, reps, ""))))
    if failed and checked:
        sys.exit("flash-bwd: beyond tolerance: %s" % failed)


# text cut from kernel A's source by stft --cut, to time what is left: the
# products (main tile and folded pair), the copies of the frames and the
# basis ("staging"), the whole staging of the frames, the basis copies, the
# output stores; "frames32" / "frames24" force 32 or 24 frames per block
STFT_CUTS = {
    "products": [("contract<TM>(acc, a_s + ty * pitch + r0, pitch, bc + 4 * "
                  "cq, rows);", ";"),
                 ("contract_pair(acc2, a_s + lane * pitch + r0, bc + BN, "
                  "rows);", ";")],
    "staging": [("cp_async_ca<16>(dst + q, xb + s0 + q);", ";"),
                ("cp_async_ca<4>(dst + n, xb + s);", ";"),
                ("cp_async16(dst + 4 * e, src + 4 * e);", ";")],
    "frames": [("stage_frames<BM>(a_s, x + static_cast<size_t>(b) * length, "
                "length, m0,", "if (0) stage_frames<BM>(a_s, x + "
                "static_cast<size_t>(b) * length, length, m0,")],
    "basis": [("cp_async16(dst + 4 * e, src + 4 * e);", ";")],
    "stores": [("if (col + j < n_cols) store_pair", "if (0) store_pair"),
               ("store_pair<LOGMAG>(\n        ob +",
                "if (0) store_pair<LOGMAG>(\n        ob +")],
    "frames32": [("const int tm : {4, 3, 1}", "const int tm : {4, 1}")],
    "frames24": [("const int tm : {4, 3, 1}", "const int tm : {3, 1}")],
}
STFT_ATOL = 2e-5
# (B, L, fft, stride): chip_smoke.py phase 3's and 16's shapes, then the
# strides that do not divide the fft; the first two are timed
STFT_SHAPES = ((1, 80000, 256, 64), (4, 32000, 256, 64), (4, 80000, 256, 64),
               (4, 80037, 256, 64), (1, 32000, 256, 64), (1, 8000, 256, 64),
               (3, 12345, 256, 64), (1, 81856, 256, 64), (4, 32704, 256, 64),
               (3, 12345, 256, 100), (3, 24691, 512, 128))


def stft(reps: int, checked: bool = True) -> None:
    """Kernels A and 6 (``stft_ri``, ``stft_logmag``) at STFT_SHAPES: max
    abs error against the plain version (atol 2e-5), digest, and at the
    first two shapes the event-timed ms, the profiler's device ms, the
    plain version's ms and torch.stft's device ms."""
    from danet_tpu_torch.hparams import WINDOW_REGISTRY
    from danet_tpu_torch.ops.cuda import stft as cuda_stft

    rs = np.random.RandomState(3)
    failed = []
    for i, (b, n, fft, stride) in enumerate(STFT_SHAPES):
        w = WINDOW_REGISTRY["sqrt-hann"](fft).astype(np.float32)
        x = torch.from_numpy((rs.randn(b, n) * 0.3).astype(np.float32)).cuda()
        for logmag in (False, True):
            name = "stft_logmag" if logmag else "stft_ri"
            run = lambda: cuda_stft.stft_ri(x, fft, stride, w,  # noqa: E731
                                            logmag)
            out = run()
            ref = cuda_stft.stft_ri_plain(x, fft, stride, w, logmag)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            ok = tuple(out.shape) == tuple(ref.shape) and bool(
                torch.isfinite(out).all()) and err <= STFT_ATOL
            if not ok:
                failed.append((name, b, n, fft, stride))
            line = ("stft %s B=%d L=%d fft=%d stride=%d T=%d: max abs err "
                    "%.6g (atol %g)%s; digest %s" % (
                        name, b, n, fft, stride, out.shape[1], err,
                        STFT_ATOL, "" if ok else " FAIL", _digest([out])))
            if i < 2:
                wt = torch.from_numpy(w).cuda()
                scale = 1.0 / float(wt.sum())

                def library():
                    z = torch.stft(x, fft, stride, window=wt, center=True,
                                   pad_mode="constant",
                                   return_complex=True) * scale
                    return torch.log1p(torch.abs(z)) if logmag else z

                line += ("; ms %.4f, device ms %s; plain ms %.4f; torch.stft"
                         "%s device ms %s" % (
                             cuda_ms(run, reps),
                             _ms(device_ms(run, reps, "stft_ri_kernel")),
                             cuda_ms(lambda: cuda_stft.stft_ri_plain(
                                 x, fft, stride, w, logmag), reps),
                             " + abs, log1p" if logmag else "",
                             _ms(device_ms(library, reps, ""))))
            print(line)
    if failed and checked:
        sys.exit("stft: beyond tolerance: %s" % failed)


def device_rows(reps: int) -> None:
    """The device-ms reading of the kernels under 0.1 ms (docstring)."""
    from danet_tpu_torch.hparams import load_config
    from danet_tpu_torch.ops.cuda import attention as cuda_attn
    from danet_tpu_torch.ops.cuda import stft as cuda_stft

    rs = np.random.RandomState(12)
    window = load_config().FFT_WND_ARRAY
    x = torch.from_numpy((rs.randn(1, 80000) * 0.3).astype(np.float32)).cuda()
    qkv = torch.from_numpy(rs.randn(1, 1280, 3, FLASH_H, FLASH_D).astype(
        np.float32)).cuda()
    seg = torch.zeros(1, 1280, dtype=torch.int32)
    seg[-1, 1280 - 37:] = 1
    fwd = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], seg.cuda(), 0.125)
    bargs = _flash_bwd_args(rs, 128, 32, torch.float32)
    rows = (
        ("A", "stft_ri L=80000 B=1", "stft_ri_kernel",
         lambda: cuda_stft.stft_ri(x, 256, 64, window)),
        ("6", "stft_logmag L=80000 B=1", "stft_ri_kernel",
         lambda: cuda_stft.stft_logmag(x, 256, 64, window)),
        ("5f", "flash_attn T=1280 B=1", "flash_fwd_kernel",
         lambda: cuda_attn.flash_attn(*fwd)),
        ("5dkv", "flash_attn_bwd_dkv T=128 B=32", "flash_bwd_dkv_kernel",
         lambda: cuda_attn.flash_attn_bwd_dkv(*bargs)),
        ("5dq", "flash_attn_bwd_dq T=128 B=32", "flash_bwd_dq_kernel",
         lambda: cuda_attn.flash_attn_bwd_dq(*bargs)))
    for row, what, key, run in rows:
        print("device-ms %s %s float32: ms %.4f, device ms %s" % (
            row, what, cuda_ms(run, reps), _ms(device_ms(run, reps, key))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m danet_tpu_torch.perf_probe")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("profile", help="device time by kernel")
    p.add_argument("--encoder", default="gru-v1")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--attn-backend", default="flash",
                   choices=("flash", "xla", "auto"),
                   help="ATTN_BACKEND of attn-v1 (other encoders ignore it)")
    p.add_argument("-c", "--config", action="append", default=[],
                   help="config JSON layered over default.json (repeatable)")
    p.add_argument("--key", action="append", default=[],
                   help="KEY=VALUE laid over the configs (repeatable)")
    p = sub.add_parser("scan-bwd", help="kernel 3 alone: check and time")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--set", action="append", default=[],
                   metavar="NAME=VALUE",
                   help="a constexpr int of kernel 3 in a variant build")
    p.add_argument("--cut", action="append", default=[],
                   choices=sorted(SCAN_BWD_CUTS),
                   help="time kernel 3 without this part (outputs wrong)")
    p = sub.add_parser("gru-fwd", help="kernel 4f alone: check and time")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--set", action="append", default=[],
                   metavar="NAME=VALUE",
                   help="a constexpr int of kernel 4f in a variant build")
    p.add_argument("--cut", action="append", default=[],
                   choices=sorted(GRU_FWD_CUTS),
                   help="time kernel 4f without this part (outputs wrong)")
    p.add_argument("--source", default="",
                   help="a csrc directory whose gru_scan.cu to build (e.g. "
                   "an unpacked parent commit's)")
    p = sub.add_parser("lstm-fwd", help="kernel B alone: check and time")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--set", action="append", default=[],
                   metavar="NAME=VALUE",
                   help="a constexpr int of kernel B in a variant build")
    p.add_argument("--cut", action="append", default=[],
                   choices=sorted(LSTM_FWD_CUTS),
                   help="time kernel B without this part (outputs wrong)")
    p.add_argument("--source", default="",
                   help="a csrc directory whose kernel B to build (e.g. an "
                   "unpacked parent commit's)")
    for name, what, table in (("gru-bwd", "kernel 4b", GRU_BWD_CUTS),
                              ("lstm-train", "the saving LSTM forward",
                               LSTM_FWD_CUTS)):
        p = sub.add_parser(name, help="%s alone: check and time" % what)
        p.add_argument("--reps", type=int, default=10)
        p.add_argument("--set", action="append", default=[],
                       metavar="NAME=VALUE",
                       help="a constexpr int of %s in a variant build" % what)
        p.add_argument("--cut", action="append", default=[],
                       choices=sorted(table),
                       help="time %s without this part (outputs wrong)"
                       % what)
        p.add_argument("--source", default="",
                       help="a csrc directory whose %s to build (e.g. an "
                       "unpacked parent commit's)" % what)
        if name == "lstm-train":
            p.add_argument("--dirs", type=int, default=1, choices=(1, 2),
                           help="2: kernel 2 (bilstm_scan_train, H=300)")
    p = sub.add_parser("flash-fwd", help="kernel 5f alone: check and time")
    p.add_argument("--reps", type=int, default=50)
    p = sub.add_parser("flash-bwd",
                       help="kernels 5dkv and 5dq alone: check and time")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--source", default="",
                   help="a csrc directory whose flash_attn_bwd.cu to build "
                   "(e.g. an unpacked parent commit's), printing its "
                   "registers and spills")
    p.add_argument("--set", action="append", default=[],
                   metavar="NAME=VALUE",
                   help="a constexpr int of flash_attn_bwd.cu in a variant "
                   "build (DQ_ROWS=8: 5dq's 8 x 4 tile)")
    p.add_argument("--cut", action="append", default=[],
                   choices=sorted(FLASH_BWD_CUTS),
                   help="time 5dkv and 5dq without this part (outputs "
                   "wrong)")
    p = sub.add_parser("stft", help="kernels A and 6 alone: check and time")
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--source", default="",
                   help="a csrc directory whose stft.cu to build (e.g. an "
                   "unpacked parent commit's), printing its registers and "
                   "spills")
    p.add_argument("--cut", action="append", default=[],
                   choices=sorted(STFT_CUTS),
                   help="time kernel A without this part (outputs wrong), "
                   "or with its frames per block forced")
    p = sub.add_parser("device-ms", help="device time of the kernels under "
                       "0.1 ms")
    p.add_argument("--reps", type=int, default=20)
    p = sub.add_parser("row-groups", help="kernels B, 2 and 3 by row "
                       "groups: check and time")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--only", action="append", default=[],
                   choices=("lean", "save", "bwd"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("perf_probe: no GPU (torch.cuda.is_available() is false)")
    print("card: %s" % _card())
    if args.cmd == "scan-bwd":
        if args.set or args.cut:
            use_variant(
                "bilstm_scan_bwd.cu",
                {k: int(v) for k, v in (a.split("=") for a in args.set)},
                SCAN_BWD_CUTS, args.cut)
        scan_bwd(args.reps, checked=not args.cut)
    elif args.cmd == "gru-fwd":
        if args.set or args.cut or args.source:
            use_variant(
                "gru_scan.cu",
                {k: int(v) for k, v in (a.split("=") for a in args.set)},
                GRU_FWD_CUTS, args.cut, args.source)
        gru_fwd(args.reps, checked=not args.cut)
    elif args.cmd == "lstm-fwd":
        kernel = "lstm_scan_lean.cu"
        legacy = bool(args.source) and not os.path.exists(
            os.path.join(args.source, kernel))
        if args.set or args.cut or args.source:
            use_variant(
                "bilstm_scan.cu" if legacy else kernel,
                {k: int(v) for k, v in (a.split("=") for a in args.set)},
                LSTM_FWD_CUTS, args.cut, args.source)
        lstm_fwd(args.reps, legacy, checked=not args.cut)
    elif args.cmd in ("gru-bwd", "lstm-train"):
        from danet_tpu_torch.ops.cuda import _build

        source = args.source or _build.CSRC
        if args.cmd == "gru-bwd":
            kernel, table = "gru_scan_bwd.cu", GRU_BWD_CUTS
            legacy = '#include "row_contract.cuh"' in open(
                os.path.join(source, kernel)).read()
        elif args.dirs == 1:
            kernel, table = "lstm_scan_lean.cu", LSTM_FWD_CUTS
            legacy = "danet_lstm_scan_train" not in open(os.path.join(
                source, kernel)).read()
            kernel = "bilstm_scan.cu" if legacy else kernel
        else:
            table = LSTM_FWD_CUTS
            legacy = os.path.exists(os.path.join(source, "bilstm_scan.cu"))
            kernel = "bilstm_scan.cu" if legacy else "lstm_scan_lean.cu"
        if args.set or args.cut or args.source:
            use_variant(
                kernel,
                {k: int(v) for k, v in (a.split("=") for a in args.set)},
                table, args.cut, args.source)
        if args.cmd == "gru-bwd":
            gru_bwd(args.reps, legacy, checked=not args.cut)
        else:
            lstm_train(args.reps, legacy, not args.cut, args.dirs)
    elif args.cmd == "flash-fwd":
        flash_fwd(args.reps)
    elif args.cmd == "flash-bwd":
        if args.source or args.cut or args.set:
            use_variant(
                "flash_attn_bwd.cu",
                {k: int(v) for k, v in (a.split("=") for a in args.set)},
                FLASH_BWD_CUTS, args.cut, args.source)
        flash_bwd(args.reps, checked=not args.cut)
    elif args.cmd == "stft":
        if args.source or args.cut:
            use_variant("stft.cu", {}, STFT_CUTS, args.cut, args.source)
        if args.source and "col_blocks" not in open(
                os.path.join(args.source, "stft.cu")).read():
            # the earlier design reads the plain [fft, 2F] basis
            from danet_tpu_torch.ops.cuda import stft as cuda_stft

            plain = cuda_stft._basis
            cuda_stft._basis = lambda fft, stride, w, dev, kernel=False: \
                plain(fft, stride, w, dev)
        stft(args.reps, checked=not set(args.cut) - {"frames32",
                                                       "frames24"})
    elif args.cmd == "device-ms":
        device_rows(args.reps)
    elif args.cmd == "row-groups":
        row_groups(args.reps, args.only)
    else:
        profile(args.encoder, args.dtype, args.attn_backend, args.config,
                dict(_key_value(a) for a in args.key))


if __name__ == "__main__":
    main()
