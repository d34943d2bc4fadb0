#!/usr/bin/env python3
"""Smoke run of the PyTorch port (danet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises (non-zero exit):

1. environment: torch / CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN.  No GPU -> exit non-zero.
2. build: nvcc compiles danet_tpu_torch/csrc/*.cu for sm_90a.
3. kernel A (fused STFT) vs its plain version on the card, atol 2e-5.
4. kernel B (fused BiLSTM scan) vs its plain version on the card: H=300,
   T=1251, B=1 and 4, tanh and identity candidates; float32 at atol 1e-5,
   bfloat16 at atol 5e-2 (one-ulp bf16 roundings of h, 2^-8 near 1, that
   fall differently under another f32 summation order feed every later
   step, so they compound over T).
5. serving: DaNet at full bilstm-orig width (default.json +
   ENCODER_TYPE=bilstm-orig: 4 BiLSTM layers x 300 units per direction,
   F=129, E=20, NUM_ANCHOR=6, N=2, float32) with seeded random weights,
   loaded into serve.Separator on the card; answers 1 s, 4 s and 10 s
   requests at B=1 and one 4 x 4 s batch, with launch counters showing
   both kernels ran (A once, B once per layer, per request).  Each
   answer, and the encoder's embeddings for it, are checked against the
   same model and weights on the CPU (plain path) to 1e-4 of the
   reference's peak (float32 sums in other orders through 4 x 2 x T
   recurrent steps).

The last two lines are the kernel summary JSON and
{"ok": true, "device": {...}}; the line before them is nvidia-smi's
name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from danet_tpu_torch.hparams import load_config
from danet_tpu_torch.ops.dsp import stft_frame_count
from danet_tpu_torch.ops.cuda import _build
from danet_tpu_torch.ops.cuda import lstm as cuda_lstm
from danet_tpu_torch.ops.cuda import stft as cuda_stft
from danet_tpu_torch.serve import Separator

STFT_ATOL = 2e-5
LSTM_ATOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
SERVE_RTOL = 1e-4
SMPRATE = 8000


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


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


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase 1 environment: python %s, torch %s, CUDA %s, device %s"
          % (sys.version.split()[0], torch.__version__, torch.version.cuda,
             torch.cuda.get_device_name(0)))
    print("phase 1 nvidia-smi: %s" % nvidia_smi())
    print("phase 1 TF32 off: matmul.allow_tf32=%s cudnn.allow_tf32=%s"
          % (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32))


def phase_build():
    t0 = time.perf_counter()
    path = _build.library_path()
    _build.library()
    print("phase 2 build: %s in %.3f s" % (path, time.perf_counter() - t0))


def phase_stft(window) -> dict:
    rs = np.random.RandomState(0)
    worst = 0.0
    times = {}
    for b, n in ((4, 80000), (4, 80037), (1, 80000), (4, 32000),
                 (1, 32000), (1, 8000), (3, 12345)):
        x = torch.from_numpy(
            (rs.randn(b, n) * 0.3).astype(np.float32)).cuda()
        out = cuda_stft.stft_ri(x, 256, 64, window)
        ref = cuda_stft.stft_ri_plain(x, 256, 64, window)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        if tuple(out.shape) != tuple(ref.shape) or not err <= STFT_ATOL:
            raise AssertionError("stft_ri B=%d L=%d: shape %s vs %s, max "
                                 "abs err %.3g > %g" % (
                                     b, n, tuple(out.shape),
                                     tuple(ref.shape), err, STFT_ATOL))
        worst = max(worst, err)
        ms = cuda_ms(lambda: cuda_stft.stft_ri(x, 256, 64, window), 50)
        plain = cuda_ms(
            lambda: cuda_stft.stft_ri_plain(x, 256, 64, window), 50)
        times[(b, n)] = (ms, plain)
        print("phase 3 stft_ri B=%d L=%d T=%d: max_abs_err %.3g (atol %g); "
              "kernel %.4f ms, plain %.4f ms"
              % (b, n, out.shape[1], err, STFT_ATOL, ms, plain))
    return {"max_abs_err": worst, "times": times}


def _scan_inputs(rs, t, b, dtype):
    """Layer-shaped inputs: xp = x @ Wx + gate bias with x ~ a layer's
    activations, Wx and Wh at bilstm-orig's init scale."""
    h, i_dim = 300, 600
    scale = 0.75 / np.sqrt(h)
    x = rs.randn(t, 2, b, i_dim).astype(np.float32) * 0.5
    wx = rs.uniform(-scale, scale, (2, i_dim, 4 * h)).astype(np.float32)
    bias = np.repeat(np.array([0.0, 1.5, -1.0, 1.0], np.float32), h)
    xp = np.einsum("tdbi,dig->tdbg", x, wx) + bias
    wh = rs.uniform(-scale, scale, (2, h, 4 * h)).astype(np.float32)
    z = np.zeros((2, b, h), np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda().to(dtype)
            for a in (xp, wh, z, z)]


def phase_bilstm() -> dict:
    rs = np.random.RandomState(1)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    times = {}
    cases = [(dt, tanh, t, b) for dt in (torch.float32, torch.bfloat16)
             for tanh in (True, False) for t, b in ((1251, 1), (1251, 4))]
    cases += [(torch.float32, True, 501, 4), (torch.float32, True, 126, 1)]
    for dt, tanh, t, b in cases:
        args = _scan_inputs(rs, t, b, dt)
        out = cuda_lstm.bilstm_scan(*args, tanh)
        ref = cuda_lstm.bilstm_scan_plain(*args, tanh)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        tag = "bilstm_scan %s %s T=%d B=%d" % (
            str(dt).replace("torch.", ""), "tanh" if tanh else "identity",
            t, b)
        if out.dtype != dt or not torch.isfinite(out.float()).all() \
                or not err <= LSTM_ATOL[dt]:
            raise AssertionError("%s: max abs err %.3g > %g"
                                 % (tag, err, LSTM_ATOL[dt]))
        worst[dt] = max(worst[dt], err)
        line = "phase 4 %s: max_abs_err %.3g (atol %g)" % (
            tag, err, LSTM_ATOL[dt])
        if dt == torch.float32 and tanh:
            ms = cuda_ms(lambda: cuda_lstm.bilstm_scan(*args, tanh), 10)
            plain = cuda_ms(
                lambda: cuda_lstm.bilstm_scan_plain(*args, tanh), 2)
            times[(t, b)] = (ms, plain)
            line += "; kernel %.4f ms (%.3f us/step), plain %.4f ms" % (
                ms, 1e3 * ms / t, plain)
        print(line)
    return {"max_abs_err": worst, "times": times}


def _mixture(rs, b, n):
    """Two harmonic 'talkers' with gliding pitch plus a little noise."""
    t = np.arange(n) / SMPRATE
    out = np.zeros((b, n))
    for row in range(b):
        for _ in range(2):
            f0 = rs.uniform(90, 250) * (1 + 0.1 * np.sin(
                2 * np.pi * rs.uniform(0.2, 1.0) * t))
            phase = 2 * np.pi * np.cumsum(f0) / SMPRATE
            for k in range(1, 8):
                out[row] += rs.uniform(0.02, 0.1) / k * np.sin(k * phase)
        out[row] += 0.01 * rs.randn(n)
    return out.astype(np.float32)


def phase_serving() -> dict:
    hp = load_config(ENCODER_TYPE="bilstm-orig")
    model = hp.get_model()(hp)
    enc = model.encoder
    print("phase 5 model: %s, %d BiLSTM layers x %d units/dir, F=%d, E=%d, "
          "NUM_ANCHOR=%d, N=%d, FFT %d/%d @ %d Hz, %s, estimator %s, "
          "separator %s" % (hp.ENCODER_TYPE, enc.N_LAYERS, enc.HDIM,
                            hp.FEATURE_SIZE, hp.EMBED_SIZE, hp.NUM_ANCHOR,
                            hp.MAX_N_SIGNAL, hp.FFT_SIZE, hp.FFT_STRIDE,
                            hp.SMPRATE, hp.COMPUTE_DTYPE,
                            hp.INFER_ESTIMATOR_METHOD, hp.SEPARATOR_TYPE))
    params = model.init(torch.Generator().manual_seed(0))
    gpu = Separator(model, params, "cuda")
    cpu = Separator(model, params, "cpu")
    rs = np.random.RandomState(2)
    requests = [(1, SMPRATE), (1, 4 * SMPRATE), (1, 10 * SMPRATE),
                (4, 4 * SMPRATE)]
    waves = [_mixture(rs, b, n) for b, n in requests]
    outs, latencies = [], {}

    # the main path: only these requests count kernel launches
    cuda_stft.stft_ri.launches = 0
    cuda_lstm.bilstm_scan.launches = 0
    calls = 0
    for (b, n), wav in zip(requests, waves):
        for _ in range(2):          # warm-up, then the timed request
            a0 = cuda_stft.stft_ri.launches
            b0 = cuda_lstm.bilstm_scan.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gpu.separate(wav)  # numpy result: includes the sync
            dt = time.perf_counter() - t0
            calls += 1
            da = cuda_stft.stft_ri.launches - a0
            db = cuda_lstm.bilstm_scan.launches - b0
            if da != 1 or db != enc.N_LAYERS:
                raise AssertionError(
                    "request B=%d L=%d: stft_ri launched %d times (want 1), "
                    "bilstm_scan %d (want %d)" % (b, n, da, db,
                                                  enc.N_LAYERS))
        outs.append(out)
        latencies[(b, n)] = dt * 1e3
    launches = {"stft_ri": cuda_stft.stft_ri.launches,
                "bilstm_scan": cuda_lstm.bilstm_scan.launches}
    if launches["stft_ri"] != calls or \
            launches["bilstm_scan"] != calls * enc.N_LAYERS:
        raise AssertionError("launch counts %s over %d requests"
                             % (launches, calls))
    print("phase 5 launches over %d requests: %s" % (calls, launches))

    # correctness against the same model and weights on the CPU
    worst = 0.0
    for (b, n), wav, out in zip(requests, waves, outs):
        ref = cpu.separate(wav)
        want = (b, 2, stft_frame_count(n, 256, 64) * 64)
        peak = float(np.max(np.abs(ref)))
        err = float(np.max(np.abs(out - ref)))
        e_gpu, e_cpu = _embeddings(gpu, wav), _embeddings(cpu, wav)
        e_peak = float(e_cpu.abs().max())
        e_err = max_err(e_gpu.cpu(), e_cpu)
        if out.shape != want or not np.all(np.isfinite(out)) \
                or not err <= SERVE_RTOL * peak \
                or not e_err <= SERVE_RTOL * e_peak:
            raise AssertionError(
                "request B=%d L=%d: shape %s (want %s); vs CPU: wave max abs "
                "err %.3g (peak %.3g), embedding max abs err %.3g (peak "
                "%.3g); rtol %g of the peak" % (b, n, out.shape, want, err,
                                                peak, e_err, e_peak,
                                                SERVE_RTOL))
        worst = max(worst, err / peak, e_err / e_peak)
        print("phase 5 request B=%d %.1f s: out %s, latency %.3f ms; vs CPU: "
              "wave max_abs_err %.3g (peak %.3g), embedding max_abs_err %.3g "
              "(peak %.3g), rtol %g of the peak"
              % (b, n / SMPRATE, out.shape, latencies[(b, n)], err, peak,
                 e_err, e_peak, SERVE_RTOL))
    return {"launches": launches, "latency_ms": latencies,
            "max_rel_err": worst}


def _embeddings(sep, wav) -> torch.Tensor:
    """The encoder's embeddings [B, T, F, E] for one request, through the
    model's own front end (the separated waves alone hardly see the
    encoder under random weights: the masks all sit near 0.5)."""
    model = sep.model
    with torch.inference_mode():
        x = torch.from_numpy(wav).to(sep.device)
        mix_ri = cuda_stft.stft_ri(x, model.hp.FFT_SIZE, model.hp.FFT_STRIDE,
                                   model.hp.FFT_WND_ARRAY)
        _, logmag, _ = model._mix_features(mix_ri)
        return model._embed(sep.params, logmag)


def main():
    phase_environment()
    phase_build()
    window = load_config().FFT_WND_ARRAY
    stft = phase_stft(window)
    scan = phase_bilstm()
    serving = phase_serving()
    print("summary: bilstm_scan bfloat16 max_abs_err %.3g (atol %g); "
          "serving worst error vs CPU %.3g of the peak (rtol %g)"
          % (scan["max_abs_err"][torch.bfloat16], LSTM_ATOL[torch.bfloat16],
             serving["max_rel_err"], SERVE_RTOL))
    a_ms, a_plain = stft["times"][(1, 80000)]
    b_ms, b_plain = scan["times"][(1251, 1)]
    kernels = [
        {"name": "stft_ri", "route": "cuda",
         "source": "danet_tpu_torch/csrc/stft.cu",
         "replaces": "danet_tpu/ops/pallas/stft.py:95",
         "launches": serving["launches"]["stft_ri"],
         "max_abs_err": stft["max_abs_err"], "ms": a_ms,
         "plain_ms": a_plain},
        {"name": "bilstm_scan", "route": "cuda",
         "source": "danet_tpu_torch/csrc/bilstm_scan.cu",
         "replaces": "danet_tpu/ops/pallas/lstm.py:242",
         "launches": serving["launches"]["bilstm_scan"],
         "max_abs_err": scan["max_abs_err"][torch.float32], "ms": b_ms,
         "plain_ms": b_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
