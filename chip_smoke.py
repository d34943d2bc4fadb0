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
6. kernels 2 (BiLSTM forward that saves residuals) and 3 (BiLSTM
   backward) vs their plain versions on the card: H=300, (T=128, B=32) the
   train shape and (T=1251, B=1), tanh and identity candidates, layer-shaped
   inputs with a nonzero d_hs.  float32: atol 1e-5 on hs, cs and acts;
   atol 2e-5 + rtol 1e-4 on dxp, dc0 and dh0.  bfloat16: atol 5e-2 + rtol
   2e-2 on every output, for the reason given at phase 4 (one-ulp roundings
   of the stored values, 2^-8 relative, compound over the recurrence in
   both directions of time); the cell state and the gradients are not
   bounded by 1, hence the relative term.
7. training: Trainer at full bilstm-orig width (4 x 300, B=32, N=2,
   T=128, F=129, E=20; truth-weighted, dot-sigmoid-orig, pit-mse, Adam with
   the +/-100 value clip) with seeded weights and the toy dataset from a
   fixed seed; 3 train steps and a valid step on the card and the same on
   the CPU (plain path), float32 and bfloat16.  Launch counters show
   N_LAYERS launches of kernels 2 and 3 per train step and of kernel B only
   in valid_step.  float32: each step's loss and SNR agree with the CPU to
   1e-4 relative, and so do the step-1 gradients, per tensor, to 1e-4 of
   that tensor's peak.  After step 3 every parameter element agrees to
   1e-3 of its tensor's peak change from init, plus one float32 ulp of the
   parameter per step (each step rounds p + update once: at a bias of 1.5
   one ulp, 1.2e-7, is already 1.3e-4 of a peak change of 9e-4).  The
   bound is 1e-3, not 1e-4, because Adam's update m / (sqrt(v) + eps) of a
   gradient element near zero turns that element's f32 rounding noise
   (1e-5 of the tensor's peak gradient between the card and the CPU) into
   an update difference of up to about 5e-4 of the change: on an H100 a
   handful of LSTM-bias elements of 7.2 million land between 1e-4 and
   5e-4, and the line of each tensor prints how many exceed 1e-4.
   bfloat16: finite, and each loss within 1e-2 relative of the CPU's
   (bf16 unit roundoff is 2^-8 = 3.9e-3; the loss averages many
   independently rounded terms, and the 1e-2 bound leaves room for a shift
   of about 2.5 bf16 ulps).  Then the median step time on the card of the
   kernel path and of the plain path (LSTM_BACKEND=xla), both dtypes.

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

from danet_tpu_torch import weights
from danet_tpu_torch.data.dataset import WhiteNoiseData
from danet_tpu_torch.hparams import load_config
from danet_tpu_torch.ops.dsp import stft_frame_count
from danet_tpu_torch.ops.cuda import _build
from danet_tpu_torch.ops.cuda import lstm as cuda_lstm
from danet_tpu_torch.ops.cuda import stft as cuda_stft
from danet_tpu_torch.serve import Separator
from danet_tpu_torch.train import Trainer, prepare_batch

STFT_ATOL = 2e-5
LSTM_ATOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
SERVE_RTOL = 1e-4
SMPRATE = 8000
# phase 6: (atol, rtol) of kernels 2 and 3 against their plain versions
TRAIN_FWD_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (5e-2, 2e-2)}
TRAIN_BWD_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (5e-2, 2e-2)}
# phase 7: card vs CPU
STEP_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
TRAIN_STEPS = 3
PARAM_RTOL = 1e-3  # of each tensor's peak change; why: phase 7 docstring


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


def _allclose_err(out: torch.Tensor, ref: torch.Tensor, atol: float,
                  rtol: float):
    """(max abs err, worst err / (atol + rtol |ref|)): the second is <= 1
    where every element passes."""
    d = (out.float() - ref.float()).abs()
    return float(d.max()), float((d / (atol + rtol * ref.float().abs()))
                                 .max())


def phase_train_kernels() -> dict:
    rs = np.random.RandomState(4)
    worst = {name: {torch.float32: 0.0, torch.bfloat16: 0.0}
             for name in ("bilstm_scan_train", "bilstm_scan_bwd")}
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        for tanh in (True, False):
            for t, b in ((128, 32), (1251, 1)):
                xp, wh, c0, h0 = _scan_inputs(rs, t, b, dt)
                d_hs = torch.from_numpy(rs.randn(t, 2, b, 300).astype(
                    np.float32)).cuda().to(dt)
                fwd = cuda_lstm.bilstm_scan_train(xp, wh, c0, h0, tanh)
                fwd_ref = cuda_lstm.bilstm_scan_train_plain(xp, wh, c0, h0,
                                                            tanh)
                _, cs, acts = fwd_ref
                c_prev = torch.cat([c0[None], cs[:-1]])
                bwd = cuda_lstm.bilstm_scan_bwd(d_hs, acts, cs, c_prev, wh,
                                                tanh)
                bwd_ref = cuda_lstm.bilstm_scan_bwd_plain(d_hs, acts, cs,
                                                          c_prev, wh, tanh)
                torch.cuda.synchronize()
                tag = "%s %s T=%d B=%d" % (
                    str(dt).replace("torch.", ""),
                    "tanh" if tanh else "identity", t, b)
                parts = []
                for kernel, names, outs, refs, tol in (
                        ("bilstm_scan_train", ("hs", "cs", "acts"), fwd,
                         fwd_ref, TRAIN_FWD_TOL[dt]),
                        ("bilstm_scan_bwd", ("dxp", "dc0", "dh0"), bwd,
                         bwd_ref, TRAIN_BWD_TOL[dt])):
                    for name, o, r in zip(names, outs, refs):
                        err, ratio = _allclose_err(o, r, *tol)
                        parts.append("%s %.3g" % (name, err))
                        if o.dtype != dt or tuple(o.shape) != tuple(r.shape) \
                                or not torch.isfinite(o.float()).all() \
                                or not ratio <= 1.0:
                            raise AssertionError(
                                "phase 6 %s %s: max abs err %.3g beyond "
                                "atol %g + rtol %g" % (tag, name, err, *tol))
                        worst[kernel][dt] = max(worst[kernel][dt], err)
                line = "phase 6 %s max_abs_err: %s (fwd atol %g rtol %g, " \
                    "bwd atol %g rtol %g)" % (tag, ", ".join(parts),
                                             *TRAIN_FWD_TOL[dt],
                                             *TRAIN_BWD_TOL[dt])
                if dt == torch.float32 and tanh and (t, b) == (128, 32):
                    args = (xp, wh, c0, h0, tanh)
                    bargs = (d_hs, acts, cs, c_prev, wh, tanh)
                    times["bilstm_scan_train"] = (
                        cuda_ms(lambda: cuda_lstm.bilstm_scan_train(*args),
                                10),
                        cuda_ms(lambda: cuda_lstm.bilstm_scan_train_plain(
                            *args), 2))
                    times["bilstm_scan_bwd"] = (
                        cuda_ms(lambda: cuda_lstm.bilstm_scan_bwd(*bargs), 10),
                        cuda_ms(lambda: cuda_lstm.bilstm_scan_bwd_plain(
                            *bargs), 2))
                    for name in ("bilstm_scan_train", "bilstm_scan_bwd"):
                        ms, plain = times[name]
                        line += "; %s kernel %.4f ms (%.3f us/step), plain " \
                            "%.4f ms" % (name, ms, 1e3 * ms / t, plain)
                print(line)
    return {"max_abs_err": worst, "times": times}


def _toy_batches(hp, n: int):
    """n prepared [B, N, T, F, 2] batches of the toy dataset (seed 3)."""
    ds = WhiteNoiseData(hp, seed=3)
    ds.install_and_load()
    rng = np.random.RandomState(3)
    out = []
    for (flat,) in ds.epoch("train", hp.BATCH_SIZE * hp.MAX_N_SIGNAL,
                            rng=rng):
        out.append(prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL,
                                 max_len=hp.MAX_TRAIN_LEN,
                                 bucket=hp.TIME_BUCKET, rng=rng))
        if len(out) == n:
            return out
    raise AssertionError("toy dataset gave %d batches" % len(out))


def _launch_counts() -> dict:
    return {"bilstm_scan": cuda_lstm.bilstm_scan.launches,
            "bilstm_scan_train": cuda_lstm.bilstm_scan_train.launches,
            "bilstm_scan_bwd": cuda_lstm.bilstm_scan_bwd.launches}


def _counted(fn, want: dict, what: str):
    """Run fn() and check how often each BiLSTM kernel launched in it."""
    before = _launch_counts()
    out = fn()
    got = {k: v - before[k] for k, v in _launch_counts().items()}
    if got != want:
        raise AssertionError("%s launched %s, want %s" % (what, got, want))
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _train_dtype(dtype: str) -> dict:
    """Phase 7 for one COMPUTE_DTYPE: card vs CPU, launch counts."""
    hp = load_config(ENCODER_TYPE="bilstm-orig", COMPUTE_DTYPE=dtype)
    model = hp.get_model()(hp)
    n_layers = model.encoder.N_LAYERS
    batches = _toy_batches(hp, TRAIN_STEPS + 1)
    p0 = weights.to_jax(model.init(torch.Generator().manual_seed(0)))
    gpu, cpu = Trainer(model, hp, "cuda"), Trainer(model, hp, "cpu")
    sg, sc = gpu.init_state(params=p0), cpu.init_state(params=p0)
    step_want = {"bilstm_scan": 0, "bilstm_scan_train": n_layers,
                 "bilstm_scan_bwd": n_layers}
    valid_want = {"bilstm_scan": n_layers, "bilstm_scan_train": 0,
                  "bilstm_scan_bwd": 0}
    rtol = STEP_RTOL[dtype]
    worst = 0.0
    for i, batch in enumerate(batches[:TRAIN_STEPS]):
        mg = _counted(lambda: gpu.train_step(sg, batch), step_want,
                      "train step %d (%s)" % (i + 1, dtype))
        mg = {k: float(v) for k, v in mg.items()}
        mc = {k: float(v) for k, v in cpu.train_step(sc, batch).items()}
        keys = ("loss", "SNR") if dtype == "float32" else ("loss",)
        errs = {k: _rel(mg[k], mc[k]) for k in keys}
        print("phase 7 %s step %d: card loss %.9g SNR %.6g, CPU loss %.9g "
              "SNR %.6g; relative err %s (rtol %g)"
              % (dtype, i + 1, mg["loss"], mg["SNR"], mc["loss"], mc["SNR"],
                 " ".join("%s %.3g" % kv for kv in errs.items()), rtol))
        if not all(np.isfinite(v) for v in mg.values()) \
                or not max(errs.values()) <= rtol:
            raise AssertionError("phase 7 %s step %d: card %s vs CPU %s"
                                 % (dtype, i + 1, mg, mc))
        worst = max(worst, *errs.values())
    vg = _counted(lambda: gpu.valid_step(sg, batches[-1]), valid_want,
                  "valid step (%s)" % dtype)
    vg = {k: float(v) for k, v in vg.items()}
    vc = {k: float(v) for k, v in cpu.valid_step(sc, batches[-1]).items()}
    print("phase 7 %s valid step: card %s, CPU %s" % (dtype, vg, vc))
    if not all(np.isfinite(v) for v in vg.values()) \
            or not _rel(vg["loss"], vc["loss"]) <= rtol:
        raise AssertionError("phase 7 %s valid step: card %s vs CPU %s"
                             % (dtype, vg, vc))
    return {"model": model, "p0": p0, "batches": batches, "gpu": sg,
            "cpu": sc, "worst_step_rel": worst}


def _check_params_f32(run: dict) -> float:
    """Step-1 gradients, card vs CPU, per tensor to 1e-4 of the tensor's
    peak; then the parameters after the last step, to 1e-4 of the
    tensor's peak change from init plus one float32 ulp per step."""
    model, p0, batch = run["model"], run["p0"], run["batches"][0]
    names = ["/".join(k) for k in _paths(p0)]
    grads = []
    for dev in ("cuda", "cpu"):
        tr = Trainer(model, model.hp, dev)
        st = tr.init_state(params=p0)
        grads.append([g.cpu() for g in tr.loss_and_grads(
            st["params"], tr.ingest(batch))[2]])
    worst = 0.0
    for name, g, r in zip(names, *grads):
        peak = float(r.abs().max())
        err = float((g - r).abs().max())
        if not err <= 1e-4 * peak:
            raise AssertionError("phase 7 step-1 gradient %s: max abs err "
                                 "%.3g > 1e-4 x peak %.3g" % (name, err,
                                                              peak))
        worst = max(worst, err / peak if peak else 0.0)
    print("phase 7 float32 step-1 gradients: worst max abs err %.3g of the "
          "tensor's peak (bound 1e-4), %d tensors" % (worst, len(names)))
    init = weights.leaves(weights.from_jax(p0))
    bad = []
    for name, g, c, p, g1 in zip(names, weights.leaves(run["gpu"]["params"]),
                                 weights.leaves(run["cpu"]["params"]), init,
                                 grads[1]):
        g, c = g.detach().cpu(), c.detach()
        change = float((c - p).abs().max())
        ulp = torch.nextafter(c.abs(), torch.tensor(float("inf"))) - c.abs()
        d = (g - c).abs()
        beyond = d > 1e-4 * change + TRAIN_STEPS * ulp
        line = ("phase 7 float32 after step %d: %s max |card - CPU| %.3g, "
                "peak change %.3g; beyond 1e-4 of it + %d ulp: %d of %d"
                % (TRAIN_STEPS, name, float(d.max()), change, TRAIN_STEPS,
                   int(beyond.sum()), d.numel()))
        if beyond.any():
            # Adam's m/(sqrt(v) + eps) amplifies the f32 noise of a
            # gradient element that sits near zero
            worst_at = int(torch.argmax(d))
            line += ("; the worst element's step-1 gradient is %.3g of the "
                     "tensor's peak" % (float(g1.flatten()[worst_at].abs())
                                        / float(g1.abs().max())))
        print(line)
        if (d > PARAM_RTOL * change + TRAIN_STEPS * ulp).any():
            bad.append(name)
    if bad:
        raise AssertionError("phase 7 parameters after step %d beyond %g of "
                             "the peak change + %d ulp: %s"
                             % (TRAIN_STEPS, PARAM_RTOL, TRAIN_STEPS, bad))
    return worst


def _paths(tree, prefix=()):
    out = []
    for k, v in tree.items():
        out.extend(_paths(v, prefix + (k,)) if isinstance(v, dict)
                   else [prefix + (k,)])
    return out


def _step_ms(dtype: str, backend: str, reps: int) -> float:
    """Median wall time of a synchronized train step on the card."""
    hp = load_config(ENCODER_TYPE="bilstm-orig", COMPUTE_DTYPE=dtype,
                     LSTM_BACKEND=backend)
    model = hp.get_model()(hp)
    batch = _toy_batches(hp, 1)[0]
    tr = Trainer(model, hp, "cuda")
    st = tr.init_state(torch.Generator().manual_seed(0))
    out = []
    for _ in range(reps + 1):          # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(st, batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(float(m["loss"])):
            raise AssertionError("phase 7 timing %s %s: loss %s"
                                 % (dtype, backend, m["loss"]))
    return float(np.median(out[1:]))


def phase_training() -> dict:
    # the main path of this phase: the counts start at 0 here
    cuda_lstm.bilstm_scan.launches = 0
    cuda_lstm.bilstm_scan_train.launches = 0
    cuda_lstm.bilstm_scan_bwd.launches = 0
    runs = {dt: _train_dtype(dt) for dt in ("float32", "bfloat16")}
    launches = _launch_counts()
    print("phase 7 launches over 2 x (%d train steps + 1 valid step): %s"
          % (TRAIN_STEPS, launches))
    grad_rel = _check_params_f32(runs["float32"])
    times = {}
    for dt in ("float32", "bfloat16"):
        kernel = _step_ms(dt, "auto", 5)
        plain = _step_ms(dt, "xla", 3)
        times[dt] = (kernel, plain)
        print("phase 7 %s train step (B=32, T=128, 4 x 300): kernel path "
              "%.3f ms, plain path %.3f ms (medians)" % (dt, kernel, plain))
    return {"launches": launches, "times": times, "grad_rel": grad_rel,
            "step_rel": {dt: r["worst_step_rel"] for dt, r in runs.items()}}


def main():
    phase_environment()
    phase_build()
    window = load_config().FFT_WND_ARRAY
    stft = phase_stft(window)
    scan = phase_bilstm()
    serving = phase_serving()
    train_kernels = phase_train_kernels()
    training = phase_training()
    print("summary: bilstm_scan bfloat16 max_abs_err %.3g (atol %g); "
          "serving worst error vs CPU %.3g of the peak (rtol %g); "
          "training kernels bfloat16 max_abs_err %.3g; train steps vs CPU: "
          "worst relative loss/SNR err %s, step-1 gradients %.3g of the peak"
          % (scan["max_abs_err"][torch.bfloat16], LSTM_ATOL[torch.bfloat16],
             serving["max_rel_err"], SERVE_RTOL,
             max(w[torch.bfloat16]
                 for w in train_kernels["max_abs_err"].values()),
             training["step_rel"], training["grad_rel"]))
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
         "launches": serving["launches"]["bilstm_scan"]
         + training["launches"]["bilstm_scan"],
         "max_abs_err": scan["max_abs_err"][torch.float32], "ms": b_ms,
         "plain_ms": b_plain},
    ]
    for name, source, replaces in (
            ("bilstm_scan_train", "danet_tpu_torch/csrc/bilstm_scan.cu",
             "danet_tpu/ops/pallas/lstm.py:242 (save=True)"),
            ("bilstm_scan_bwd", "danet_tpu_torch/csrc/bilstm_scan_bwd.cu",
             "danet_tpu/ops/pallas/lstm.py:275")):
        ms, plain = train_kernels["times"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": training["launches"][name],
            "max_abs_err": train_kernels["max_abs_err"][name][torch.float32],
            "ms": ms, "plain_ms": plain})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
