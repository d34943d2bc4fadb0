"""Where the port's device time goes, on one NVIDIA GPU.

    python -m danet_tpu_torch.perf_probe profile [--encoder gru-v1]
        [--dtype float32|bfloat16] [--attn-backend flash|xla|auto]
    python -m danet_tpu_torch.perf_probe scan-bwd [--reps 20]
        [--set NAME=VALUE ...] [--cut fma|staging ...]

``profile``: for one encoder at full width with random weights from seed
0, in COMPUTE_DTYPE ``--dtype``, ``torch.profiler`` over 5 train steps
(B=32, T=128, the toy data; after 3 warm-ups) and over 5 10-s requests at
B=1 (after 2 warm-ups; attn-v1's flash path takes T a multiple of 128,
so its request is L=81,856, T=1280).  ``--attn-backend`` sets
ATTN_BACKEND for attn-v1: 'flash' (the default here) profiles the flash
kernels, 'xla' or 'auto' the dense attention.  Prints the device time per
step or request by
kernel (the CUDA rows of ``key_averages``), the unprofiled wall time per
step or request, and the device's busy share of that wall time.

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

It prints the card's name and power limit first.  There is no CPU
fallback: without a GPU it exits non-zero.
"""
from __future__ import annotations

import argparse
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


def _device_rows(prof, per: int) -> list:
    """(name, ms per step) of the CUDA rows, largest first."""
    rows = []
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((e.key, us / 1e3 / per))
    return sorted(rows, key=lambda r: -r[1])


def _report(what: str, prof, per: int, wall_ms: float) -> None:
    rows = _device_rows(prof, per)
    total = sum(ms for _, ms in rows)
    print("profile %s: device time %.3f ms per %s, unprofiled wall %.3f ms "
          "per %s, device busy %.1f %% of it"
          % (what, total, "step" if "train" in what else "request", wall_ms,
             "step" if "train" in what else "request",
             100.0 * total / wall_ms))
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


def profile(encoder: str, dtype: str, attn_backend: str = "flash") -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from danet_tpu_torch.data.dataset import WhiteNoiseData
    from danet_tpu_torch.hparams import load_config
    from danet_tpu_torch.serve import Separator
    from danet_tpu_torch.train import Trainer, prepare_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    hp = load_config(ENCODER_TYPE=encoder, COMPUTE_DTYPE=dtype,
                     ATTN_BACKEND=attn_backend)
    model = hp.get_model()(hp)
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
    _report("%s train B=32 T=128 %s" % (encoder, dtype), prof, 5, wall)

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


def use_scan_bwd_variant(sets: dict, cuts) -> None:
    """Build kernel 3 with constants ``sets`` and parts ``cuts`` changed,
    into its own library, and make the wrappers launch from it."""
    import ctypes
    import hashlib
    import os
    import re

    from danet_tpu_torch.ops.cuda import _build

    src = open(os.path.join(_build.CSRC, "bilstm_scan_bwd.cu")).read()
    for name, value in sets.items():
        src, n = re.subn(r"constexpr int %s = \d+;" % name,
                         "constexpr int %s = %d;" % (name, value), src)
        if n != 1:
            raise ValueError("no constexpr int %s in kernel 3" % name)
    for cut in cuts:
        for old, new in SCAN_BWD_CUTS[cut]:
            if old not in src:
                raise ValueError("cut %r: %r not in kernel 3" % (cut, old))
            src = src.replace(old, new)
    out = os.path.join(_build.BUILD_DIR, "variant_%s" % hashlib.sha256(
        src.encode()).hexdigest()[:16])
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "bilstm_scan_bwd.cu"), "w") as f:
        f.write(src)
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS + ["-I", _build.CSRC]
    objs = []
    for path in (os.path.join(out, "bilstm_scan_bwd.cu"),
                 os.path.join(_build.CSRC, "errors.cu")):
        objs.append(os.path.join(out, os.path.basename(path) + ".o"))
        proc = subprocess.run([nvcc] + flags + ["-Xptxas", "-v", "-c", "-o",
                                                objs[-1], path],
                              capture_output=True, text=True, check=True)
        if path.endswith("bilstm_scan_bwd.cu"):
            print("variant %s, cut %s: registers %s, spill stores %s" % (
                sets, list(cuts),
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
    p = sub.add_parser("scan-bwd", help="kernel 3 alone: check and time")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--set", action="append", default=[],
                   metavar="NAME=VALUE",
                   help="a constexpr int of kernel 3 in a variant build")
    p.add_argument("--cut", action="append", default=[],
                   choices=sorted(SCAN_BWD_CUTS),
                   help="time kernel 3 without this part (outputs wrong)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("perf_probe: no GPU (torch.cuda.is_available() is false)")
    print("card: %s" % _card())
    if args.cmd == "scan-bwd":
        if args.set or args.cut:
            use_scan_bwd_variant(
                {k: int(v) for k, v in (a.split("=") for a in args.set)},
                args.cut)
        scan_bwd(args.reps, checked=not args.cut)
    else:
        profile(args.encoder, args.dtype, args.attn_backend)


if __name__ == "__main__":
    main()
