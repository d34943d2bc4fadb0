"""Where the port's device time goes, on one NVIDIA GPU.

    python -m danet_tpu_torch.perf_probe profile [--encoder gru-v1]
        [--dtype float32|bfloat16] [--attn-backend flash|xla|auto]

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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("perf_probe: no GPU (torch.cuda.is_available() is false)")
    print("card: %s" % _card())
    profile(args.encoder, args.dtype, args.attn_backend)


if __name__ == "__main__":
    main()
