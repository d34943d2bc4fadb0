#!/usr/bin/env python3
"""Smoke run of the PyTorch port (danet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises (non-zero exit):

1. environment: torch / CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN.  No GPU -> exit non-zero.
2. build: nvcc compiles danet_tpu_torch/csrc/*.cu for sm_90a.
3. kernel A (fused STFT) vs its plain version on the card, atol 2e-5, at
   fft 256, stride 64 (the serving shapes), and at strides that do not
   divide the fft, (fft 256, stride 100) and (fft 512, stride 128), B=3,
   odd L; each line prints the digest of the output's bytes (equal
   digests from two trees: bit-identical outputs).
4. kernel B (fused BiLSTM scan, lean) vs its plain version on the card:
   H=300, T=1251, B=1 and 4, tanh and identity candidates, and (T=128,
   B=32), the validation batch, tanh; float32 at atol 1e-5, bfloat16 at
   atol 5e-2 (one-ulp bf16 roundings of h, 2^-8 near 1, that fall
   differently under another f32 summation order feed every later step,
   so they compound over T).  Kernel B exchanges h as tagged words at B=1
   and behind per-block flags above it: both protocols are held here.
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
   train shape and (T=1251, B=1), tanh and identity candidates, and the
   ragged (T=64, B=33), whose second pass of 32 rows in kernel 3 has one
   live row (tanh candidate, both dtypes); layer-shaped
   inputs with a nonzero d_hs.  Kernel 2 also alone at (T=128, B=70),
   three passes of 32 rows with a ragged last one, and (T=128, B=128),
   float32, tanh, each with its time.  float32: atol 1e-5 on hs, cs and acts;
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
8. the one-direction LSTM kernels (lstm_scan and lstm_scan_train: kernel
   B with one direction, lean and saving; lstm_scan_bwd: kernel 3 with
   one direction) vs their plain
   versions on the card: H=600 (lstm-orig), (T=1251, B=1) and (T=128,
   B=32), tanh and identity candidates, float32 and bfloat16, and phase
   6's ragged (T=64, B=33), layer-shaped
   inputs with nonzero c0, h0 and d_hs; phase 4's tolerance on the lean
   kernel and phase 6's on the other two.  The lean kernel also at the
   4 x 4 s serving batch (T=501, B=4), both dtypes, and its time at (T=501,
   B=4) and (T=128, B=32) beside the one at (T=1251, B=1); lstm_scan_train
   timed at (T=128, B=32) in both dtypes.
9. the GRU kernels (gru_scan, gru_scan_train, gru_scan_bwd) vs their plain
   versions on the card, the same shapes, dtypes and tolerances, at
   gru-v1's H=600 (75 blocks) and at H=300 (38 blocks, the last with 4
   live units of 8) at (T=1251, B=1) and the ragged (T=64, B=33);
   gru_scan_bwd timed at (T=128, B=32) in both dtypes.  The
   weights are at 10x gru-v1's init scale (1/sqrt(H) instead of
   0.1/sqrt(H)), so that the recurrent products move the state.
10. serving with lstm-orig and with gru-v1 at full width (4 one-direction
   layers x 600 units, F=129, E=20, N=2, float32, anchor): one 10 s
   request at B=1 and one 4 x 4 s batch each, checked against the CPU as
   in phase 5 (waves and embeddings to 1e-4 of the peak); launch counters
   show kernel A once and the encoder's lean kernel N_LAYERS times per
   request, and no BiLSTM kernel.
11. training with lstm-orig and with gru-v1 at full width (B=32, T=128,
   N=2; truth-weighted, dot-sigmoid-orig, pit-mse, Adam), float32 and
   bfloat16, card vs CPU: 3 train steps and a valid step under phase 7's
   bounds on each loss (and float32 SNR), but each step taken from one
   state: before each step the CPU takes over the card's parameters and
   Adam moments.  At every step, not only the first, the float32
   gradients agree per tensor to 1e-4 of that tensor's peak (phase 7's
   bound).  The parameters are held to the optimizer step rather than to a
   trajectory: after each step, in both dtypes, the card's parameters
   agree to one float32 ulp + 1e-6 x LR with the CPU's Adam step from the
   same state applied to the card's gradients.  Phase 7's check of the
   parameters after 3 independent steps does not hold for these encoders
   on an H100: lstm-orig had one bias element at 1.07e-3 of its tensor's
   peak change (its step-1 gradient 3.5e-5 of the tensor's peak), and
   gru-v1's trajectory is ill-conditioned: one Adam step at LR 3e-4 takes
   its SNR from 8.9 to 0.18 dB, a card-vs-CPU loss difference of 1e-6
   relative at step 1 became 1.3e-5 at step 2 when the two ran apart, and
   after one step thousands of elements, whose gradients sit near Adam's
   eps or change sign within the float32 noise, differ by more than 1e-3
   of the peak change.  The SNR (dB) is compared as the relative error of
   the power ratio behind it, |dSNR| / max(|SNR|, 10 / ln 10): for |SNR|
   >= 4.34 dB that is its relative error, and near 0 dB, where gru-v1 sits
   after one step and a relative error of the dB value means nothing, it
   is the ratio's.  Launch counters show N_LAYERS training forwards and
   backwards of the encoder's kernels per train step and only its lean
   kernel in valid_step.  Then the median step time of the kernel path and
   of the plain path.
12. library yardsticks (below), timed on the card; then each kernel 3
   entry's time and us per step at (T=128, B=32) beside its library call.
13. the three flash-attention kernels (flash_attn, flash_attn_bwd_dkv,
   flash_attn_bwd_dq) vs their plain versions on the card at attn-v1's
   widths (H=4, D=64) and both of its shapes, (T=1280, B=1) serving and
   (T=128, B=32) training, float32 and bfloat16, q, k and v as views of
   one [B, T, 3, H, D] projection, and the last row's final 37 frames
   padded (segment 1), so that padded queries attend only to padded keys;
   also (T=384, B=1), whose 6 key tiles split unevenly over the forward's
   cluster of 4 blocks.  Each line prints the forward's key split S
   (ops/cuda/attention.py::flash_splits: 4 at T=1280 and T=384, B=1; 1 at
   B=32).  o at phase 6's forward tolerance (float32 atol 1e-5; bfloat16 5e-2 +
   rtol 2e-2), the gradients at its backward tolerance, l (a float32 sum of up to T terms near 1) at
   rtol 1e-5 and m at atol 1e-5; the digests of the backward kernels'
   outputs; the kernels' and plain versions' times.
14. serving with attn-v1 on its flash path (default.json + ENCODER_TYPE=
   attn-v1, ATTN_BACKEND=flash: 4 pre-LN blocks of width 256, 4 heads of
   64, MLP x4, F=129, E=20, N=2, float32, anchor): a 10.2 s request at B=1
   (L=81,856, T=1280) and a batch of 4 at L=32,704 (T=512), checked
   against the CPU as in phase 5; launch counters show kernel A once and
   flash_attn 4 times per request.  Each request's latency on the card is
   printed beside the dense attention's (ATTN_BACKEND=xla).
15. training with attn-v1 on its flash path (B=32, T=128: every batch is
   checked to have 128 frames, as the flash path needs a multiple of 128),
   float32 and bfloat16, under phase 11's protocol (each step from one
   state, every step's float32 gradients to 1e-4 of each tensor's peak,
   the card's Adam step equal to the CPU's on the card's gradients); the
   counters show flash_attn, flash_attn_bwd_dkv and flash_attn_bwd_dq 4
   times each per train step and flash_attn 4 times in valid_step; the
   median step time beside the dense attention's.
16. kernel 6 (kernel A's (|Z|, log1p|Z|) epilogue, stft_ri with
   logmag=True) vs its plain version, atol 2e-5, with each output's
   digest, and its time.  No main
   path of the port (or of the JAX package) calls it, so its summary
   entry counts this phase's comparison launches and says so.
17. training with configs/tpu.json's model half (the JAX package's
   shipping config: attn-v1 on its flash path at phase 15's widths,
   INFER_ESTIMATOR_METHOD kmeans with KMEANS_ITER 5, ANCHOR_AUX_LOSS 0.5,
   EVAL_SI_SNR, B=64), loaded from the file with its trainer keys (the
   trainer's TRAIN_STEPS_PER_CALL and WATCHDOG_SECS, the wave wire's
   TRANSFER_DOMAIN, TRANSFER_DTYPE and WAVE_PCM_SCALE, DATASET_TYPE: toy
   data in its place, METRICS_EVERY; phase 19 holds them) reset to
   default.json's values and printed: float32 and bfloat16 under
   phase 11's protocol and bounds, the float32 valid step's SI_SNR held
   like the SNR (bfloat16, as in phase 11, holds the losses); the
   comparisons at DROPOUT_KEEP_PROB 1 (the card's and the CPU's
   generators draw other masks), the median step times at the config's
   0.9, beside the dense attention's.  Then one valid batch with EVAL_SDR
   (BSS_FILT_LEN 512) at B=4, float32, card vs CPU: SDR, SIR and SAR
   within 0.05 dB (BSS-eval's float32 Gram is ill-conditioned and
   cuSOLVER's solve rounds otherwise than LAPACK's; the JAX package's own
   test allows 0.05 dB against a float64 oracle).
18. serving with configs/tpu.json's model half (the kmeans inference
   estimator), float32, as phase 14: a 10.2 s request at B=1 and a batch
   of 4 at L=32,704, against the CPU, kernel A once and flash_attn 4
   times per request, each latency beside the dense attention's.
19. configs/tpu.json whole: the file with its trainer keys in force (the
   int16 wave wire, TRAIN_STEPS_PER_CALL 8, METRICS_EVERY 30,
   WATCHDOG_SECS 900; B=64, bfloat16), cut as printed (TPU_CUTS: the
   synth-speech corpus at WAVE_PCM_SCALE 4 in place of WSJ0, which the
   repository does not hold; the flash path, with TIME_BUCKET 128 so that
   the uncropped valid utterances fit it; 20 batches an epoch, two 8-step
   graph calls and 4 single steps).  (a) kernel A on the wire's ingest
   against the plain dsp.stft_ri of the dequantised batch, atol 2e-5, and
   the int16 round trip exact; (b) from one state, float32 at
   DROPOUT_KEEP_PROB 1, one 8-step CUDA graph call against 8 eager train
   steps: every parameter, Adam moment and per-step metric bit for bit;
   at the config's 0.9 the dropout generator's offset grows with every
   replay (two replays draw other masks); (c) the same 8 steps, card
   (eager, equal to the graph by (b)) against the CPU under phase 11's
   protocol and bounds; (d) two epochs through the CLI's path
   (``python -m danet_tpu_torch -m train -c configs/tpu.json -c <cuts>
   --no-save-on-epoch``):
   finite Epoch and Valid lines, the watchdog silent, metrics.jsonl with a
   row per step; its launches are this phase's main path, a graph's
   counted as its captured launches times its replays (the counters
   count at capture); (e) bilstm-orig (B=32, float32, the int16 wave wire,
   K=8): graph against eager bit for bit, kernels 2 and 3 (cooperative
   launches) under capture.  Then, printed for the record beside the
   card's name and power limit, the loop's ms per step (one epoch) and the
   device busy share (torch.profiler over 8 steps) of tpu.json's step with
   the f32 spectra wire at K=1 and METRICS_EVERY=1 (as phase 17), with the
   int16 wave wire and the prefetch only, and with every key, on the flash
   and the dense attention.
20. checkpoints, rollbacks, the preemption save, the step options and the
   CLI's modes on the paper model: bilstm-orig at full width, B=32,
   float32, the int16 wave wire, K=8, DROPOUT_KEEP_PROB 0.9, synth-speech
   (10 batches an epoch: one 8-step call, 2 single steps), through
   ``python -m danet_tpu_torch`` in a temporary directory.  (a) 2 epochs straight against 1 epoch, ``-i
   saves/<n>_e1`` and 1 more: parameters, Adam moments, the dropout
   generator's state (seed and Philox offset) and the 20 per-step losses
   bit for bit, CUDA graphs included; the resumed process's first 8-step
   call (it captures its graph) beside a replay's.  (b) EMA_DECAY 0.999
   and GRAD_ACCUM 2: one 8-step graph call against 8 eager steps bit for
   bit (the EMA included), then 2 eager steps card vs CPU under phase 11's
   protocol and bounds, the EMA within one ulp + 1e-6 x LR.  (c) on the
   float32 wave wire (int16 holds no NaN), epoch 2's first attempt meets a
   NaN utterance: the loop restores saves/nan_e1 into the tensors the
   graph holds, retries and ends finite with one capture.  (d) SIGTERM to
   a CLI subprocess after its first 8-step call: it writes
   saves/<n>_preempt and exits 0; a resume from it finishes the epoch.
   (e) ``-m test`` and ``-m demo`` from (a)'s checkpoint on the card; the
   demo's separated spectra against the CPU's from the same checkpoint
   within 1e-4 of their peak.  Then, beside the card's name and power
   limit, the save and load times of the state with its EMA, the first
   8-step call after a resume (a new Trainer captures its graph; a load in
   place keeps it), and the ms per step of the K=8 graph with each step
   option and of eager steps with and without NAN_CHECKS.

21. the single-device encoders tcn-v1, dprnn-v1 and conv-bilstm-v1.  (a)
   the LSTM kernels at their shapes against the plain versions, phase 4's
   and 6's tolerances, float32 and bfloat16, tanh candidate, layer-shaped
   inputs: kernels B, 2 and 3 at dprnn-v1's inter-chunk shape (T=3, B=2048
   and 4096 = 32 and 64 x DPRNN_CHUNK, H=128) and intra-chunk shape (T=64,
   B=96, H=128), the one-direction forms (DPRNN_INTER_CAUSAL) at the
   inter-chunk shapes, and conv-bilstm-v1's (T=32, B=32 and T=312, B=1,
   H=256 over 512 inputs); each line prints the launches a call made (a
   batch above a kernel's row ceiling is split across launches), and in
   float32 each kernel's time beside its plain version's, torch.nn.LSTM's
   and its bound.  Then, with cuDNN at PyTorch's defaults from here to
   the phase's end (TF32 allowed: the port's convolutions turn it off,
   and on deterministic algorithms, themselves), the port's conv2d and
   depthwise conv1d forward and backward against float64 to CONV_RTOL
   (2e-5) of the peak.  (b) serving configs/tcn.json and
   configs/dprnn.json (their model keys as written, the card held to the
   CPU in float32 as in phase 18, each request also timed in the files'
   bfloat16) and conv-bilstm-v1 at default.json's widths: about 10 s at
   B=1 and 4 x 4 s (conv-bilstm-v1 at 1248 and 504 frames, multiples of
   4), against the CPU at phase 5's bounds, kernel A once and each
   BiLSTM's lean kernel once per request (more where a batch is split).
   (c) training the same three at B=32, T=128 under phase 11's protocol
   and bounds, the comparisons at DROPOUT_KEEP_PROB 1 and RELU_LEAKAGE 1,
   the timed steps at the files' keys; the counters show kernels 2 and 3
   per step.  (b) and (c) compare from a well-conditioned state: tcn-v1
   and dprnn-v1 with their LSTM head's weight scaled by HEAD_SCALE (0.02),
   and (c) without the leaky ReLUs' kinks (see HEAD_SCALE).  Then
   conv-bilstm-v1 on the int16 wave wire through one 8-step CUDA graph
   call against 8 eager steps bit for bit (as phase 19 (e)).  (d)
   REMAT on bilstm-orig at full width (B=32, T=128, float32,
   DROPOUT_KEEP_PROB 0.9): an eager step and an 8-step graph call against
   no REMAT bit for bit, the REMAT step launching kernel 2 twice per layer
   (the checkpoint's forward and its recompute) and kernel 3 once; then,
   beside the card's name and power limit, the peak device memory of a
   step and its time with REMAT and without, B=8 at T=128 and T=512.
22. tasnet-v1 (MODEL_TYPE, default.json's TASNET_* widths: 512 filters
   of 16 samples at hop 8, bottleneck 128, hidden 512, kernel 3, 8 x 3
   blocks, RELU_LEAKAGE 0.3, sigmoid masks; seed 0), the wav-dir and
   timit datasets through the CLI, and PROFILE_STEPS.  (a) serve.Separator
   on the card: a 10 s request at B=1 and a 4 x 4 s batch against the CPU
   at SERVE_RTOL (1e-4) of the peak, each timed in float32 and bfloat16;
   TASNET_CAUSAL on the 10 s request; serving launches no kernel (no
   STFT).  (b) training: phase 11's protocol (each step from one state,
   float32 gradients to 1e-4 of each tensor's peak, the card's Adam step
   equal to the CPU's on the card's gradients; bfloat16 losses at 1e-2)
   at B=4 on toy spectra, at RELU_LEAKAGE 1 (COMPARE_LEAKAGE: at the
   config's 0.3 a rounding that moves one element across a leaky ReLU's
   kink moves the CPU's own float32 gradients by 2e-2 of their peak);
   then at the config's 0.3 one step's loss and gradients of the card in
   float64 against the CPU in float64 (the port's plain path with
   COMPUTE_DTYPE and FLOATX float64) at the same bounds, and the card's
   and the CPU's float32 against that float64 step, printed (the loss
   held to 1e-4); the train step's time at B=32, T=128 in float32 and
   bfloat16; one 8-step CUDA graph call on the int16 wave wire (kernel A
   in the step) against 8 eager steps bit for bit; the cost of
   PROFILE_STEPS' window over one replay (its start, the traced replay,
   its stop), whose trace must hold kernel A's rows (of 8, printed with
   the row count).  (c) 200 int16 WAVs of 2 s (synth-speech) in a flat
   folder: ``-m train -ds wav-dir -ne 1 -bs 4`` with the int16 wave wire,
   TRAIN_STEPS_PER_CALL 8 and PROFILE_STEPS 2 (one capture, the window on
   the second call, a replay: its trace holds kernel A's rows), ``-m
   test``, ``-m demo -if`` one WAV (TasNet.separate: kernel A) against
   the CPU from the same checkpoint and ``serve run`` on it, the card's
   Separator against the CPU's at SERVE_RTOL.  (d) TIMIT pickles in the
   reference's layout: ``-m train -ds timit -ne 1 -tl 64 -bs 8`` with
   configs/reference-parity.json (bilstm-orig), ``-m debug`` and ``-m
   test``: kernels B, 2 and 3 on this dataset's batches.

The kernel summary lists all fourteen kernels; its launches count the
main paths of phases 5, 7, 10, 11, 14, 15, 17, 18, 19, 20 (20: (a),
(c), (d)'s resume and (e)), 21 ((b) and (c)'s card-vs-CPU part) and 22
((a), (c) and (d)).
bound_ms is the least time the card could take for the work of the timed
call: the larger of its bytes (each input read once, each output written
once) over 3.35 TB/s and
its products' FLOPs (for kernel A, a real FFT's per frame; for the flash
kernels the T x T x D products: two in the forward, four in dK/dV, three
in dQ) over 67 TFLOP/s, the H100 SXM's float32 rate outside the tensor
cores (the kernels compute in float32; elementwise work is not counted,
so the bound stays a lower bound).  library_ms is one
PyTorch call that computes the same function, timed here and never called
by the port: torch.stft for kernel A (and, with abs and log1p, kernel 6);
torch.nn.LSTM (cuDNN) for the
tanh-candidate LSTM kernels, which also computes the input projection
(and, in its backward, the input projection's backward; no weight
gradients are asked for); none for the GRU, because cuDNN's GRU applies r
after the recurrent product and this repo's GRU before it;
torch.nn.functional.scaled_dot_product_attention with the boolean
segment-equality mask for the flash kernels (its backward computes dq, dk
and dv in one call, timed against each backward kernel).

The last two lines are the kernel summary JSON and
{"ok": true, "device": {...}}; the line before them is nvidia-smi's
name and power limit.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from danet_tpu_torch import weights
from danet_tpu_torch.data.dataset import WhiteNoiseData
from danet_tpu_torch.hparams import DEFAULT_JSON, WINDOW_REGISTRY, load_config
from danet_tpu_torch.models import encoders
from danet_tpu_torch.ops import loss as loss_ops
from danet_tpu_torch.ops import dsp
from danet_tpu_torch.ops import nn as nn_ops
from danet_tpu_torch.ops.dsp import stft_frame_count
from danet_tpu_torch.ops.cuda import _build
from danet_tpu_torch.ops.cuda import attention as cuda_attn
from danet_tpu_torch.ops.cuda import gru as cuda_gru
from danet_tpu_torch.ops.cuda import lstm as cuda_lstm
from danet_tpu_torch.ops.cuda import stft as cuda_stft
from danet_tpu_torch.perf_probe import _digest, cuda_ms
from danet_tpu_torch.serve import Separator
from danet_tpu_torch.train import Trainer, prepare_batch
from danet_tpu_torch.train.trainer import StepGraph

STFT_ATOL = 2e-5
LSTM_ATOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
SERVE_RTOL = 1e-4
SMPRATE = 8000
# phase 6: (atol, rtol) of kernels 2 and 3 against their plain versions
TRAIN_FWD_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (5e-2, 2e-2)}
TRAIN_BWD_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (5e-2, 2e-2)}
# phase 13: the flash forward's l (a float32 sum of up to T terms near 1)
STATS_TOL = (0.0, 1e-5)
# phase 7: card vs CPU
STEP_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
TRAIN_STEPS = 3
TRAIN_T = 128  # frames of every training batch (toy data, MAX_TRAIN_LEN)
PARAM_RTOL = 1e-3  # of each tensor's peak change; why: phase 7 docstring
# H100 SXM published peaks: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# every kernel wrapper, by the name it has in the summary
KERNELS = {
    "stft_ri": cuda_stft.stft_ri,
    "bilstm_scan": cuda_lstm.bilstm_scan,
    "bilstm_scan_train": cuda_lstm.bilstm_scan_train,
    "bilstm_scan_bwd": cuda_lstm.bilstm_scan_bwd,
    "lstm_scan": cuda_lstm.lstm_scan,
    "lstm_scan_train": cuda_lstm.lstm_scan_train,
    "lstm_scan_bwd": cuda_lstm.lstm_scan_bwd,
    "gru_scan": cuda_gru.gru_scan,
    "gru_scan_train": cuda_gru.gru_scan_train,
    "gru_scan_bwd": cuda_gru.gru_scan_bwd,
    "flash_attn": cuda_attn.flash_attn,
    "flash_attn_bwd_dkv": cuda_attn.flash_attn_bwd_dkv,
    "flash_attn_bwd_dq": cuda_attn.flash_attn_bwd_dq,
    "stft_logmag": cuda_stft.stft_logmag,
}
# the kernels gru-v1 and attn-v1 launch once per layer: (in serving and in
# valid_step, in a train step); the LSTM encoders' by ``_scan_launches``
ENCODER_KERNELS = {
    "gru-v1": (("gru_scan",), ("gru_scan_train", "gru_scan_bwd")),
    "attn-v1": (("flash_attn",), ("flash_attn", "flash_attn_bwd_dkv",
                                  "flash_attn_bwd_dq")),
}
# attn-v1 on its flash path: ATTN_BACKEND 'flash' (the default 'auto' runs
# the dense attention, as in the JAX package)
FLASH = {"ATTN_BACKEND": "flash"}
DENSE = {"ATTN_BACKEND": "xla"}
# the attention encoder's head count and width at default.json's widths
ATTN_H, ATTN_D = 4, 64
# configs/tpu.json, the JAX package's shipping config (phases 17, 18)
TPU_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "tpu.json")
# its trainer keys (the wave wire, the K-step calls, which phase 19 holds)
# and the wsj0 data set (toy data in its place), reset to default.json's
# values in phases 17 and 18
TPU_RESET = ("TRAIN_STEPS_PER_CALL", "WATCHDOG_SECS", "TRANSFER_DOMAIN",
             "TRANSFER_DTYPE", "WAVE_PCM_SCALE", "DATASET_TYPE",
             "METRICS_EVERY")
# phase 17: BSS-eval (float32 Gram solves, cuSOLVER vs LAPACK), card vs CPU
SDR_ATOL = 0.05
# phase 17: two PIT permutations whose float64 costs differ by at most this
# share of the cost tie within float32 rounding (see _PitTies)
TIE_RTOL = 1e-5


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


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


# phase 3's shapes at other strides: (B, L, fft, stride)
OTHER_STRIDES = ((3, 12345, 256, 100), (3, 24691, 512, 128))


def phase_stft(window) -> dict:
    rs = np.random.RandomState(0)
    worst = 0.0
    times = {}
    shapes = [(b, n, 256, 64) for b, n in (
        (4, 80000), (4, 80037), (1, 80000), (4, 32000), (1, 32000),
        (1, 8000), (3, 12345))] + list(OTHER_STRIDES)
    for b, n, fft, stride in shapes:
        w = window if fft == 256 else WINDOW_REGISTRY["sqrt-hann"](
            fft).astype(np.float32)
        x = torch.from_numpy(
            (rs.randn(b, n) * 0.3).astype(np.float32)).cuda()
        out = cuda_stft.stft_ri(x, fft, stride, w)
        ref = cuda_stft.stft_ri_plain(x, fft, stride, w)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        if tuple(out.shape) != tuple(ref.shape) or not err <= STFT_ATOL:
            raise AssertionError("stft_ri B=%d L=%d fft=%d stride=%d: shape "
                                 "%s vs %s, max abs err %.3g > %g" % (
                                     b, n, fft, stride, tuple(out.shape),
                                     tuple(ref.shape), err, STFT_ATOL))
        worst = max(worst, err)
        line = ("phase 3 stft_ri B=%d L=%d T=%d fft=%d stride=%d: max_abs_err "
                "%.3g (atol %g), digest %s" % (b, n, out.shape[1], fft,
                                               stride, err, STFT_ATOL,
                                               _digest([out])))
        if (fft, stride) == (256, 64):
            ms = cuda_ms(lambda: cuda_stft.stft_ri(x, 256, 64, w), 50)
            plain = cuda_ms(
                lambda: cuda_stft.stft_ri_plain(x, 256, 64, w), 50)
            times[(b, n)] = (ms, plain)
            line += "; kernel %.4f ms, plain %.4f ms" % (ms, plain)
        print(line)
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
    cases += [(dt, True, 128, 32) for dt in (torch.float32, torch.bfloat16)]
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


def _zero_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def _depth(enc) -> int:
    """The number of layers (recurrent) or blocks (attention, tcn-v1,
    dprnn-v1); conv-bilstm-v1's two BiLSTMs."""
    if isinstance(enc, encoders.TcnEncoder):
        return enc._n_blocks()
    if isinstance(enc, encoders.DprnnEncoder):
        return enc._dims()[4]
    if isinstance(enc, encoders.ConvBiLstmEncoder):
        return 2
    return enc._dims()[2] if hasattr(enc, "_dims") else enc.N_LAYERS


def _describe(hp, enc) -> str:
    if isinstance(enc, encoders.TcnEncoder):
        d, h, k, x_blocks, repeats, causal = enc._dims()
        return "%d x %d blocks, dim %d, hidden %d, kernel %d%s" % (
            repeats, x_blocks, d, h, k, ", causal" if causal else "")
    if isinstance(enc, encoders.DprnnEncoder):
        d, h, p, hop, blocks, causal = enc._dims()
        return "%d blocks, dim %d, %d units per direction, chunk %d, hop " \
            "%d%s" % (blocks, d, h, p, hop,
                      ", one-direction inter path" if causal else "")
    if isinstance(enc, encoders.ConvBiLstmEncoder):
        return "convolutions, 2 BiLSTMs x %d units per direction" \
            % hp.FFT_SIZE
    if hasattr(enc, "_dims"):
        d, heads, layers, mlp = enc._dims()
        return "%d blocks x dim %d, %d heads of %d, MLP x%d, ATTN_BACKEND " \
            "%s" % (layers, d, heads, d // heads, mlp, hp.ATTN_BACKEND)
    return "%d layers x %d units" % (enc.N_LAYERS, enc.HDIM)


def _lstm_launches(rows: int, hdim: int, dt, train: bool,
                   n_dirs: int) -> dict:
    """The launches of one (Bi)LSTM layer over ``rows`` batch rows: a
    batch above a kernel's row ceiling is split across launches."""
    pre, dev = "bi" if n_dirs == 2 else "", torch.device("cuda")

    def n(kind):
        return -(-rows // max(cuda_lstm.max_rows(dev, hdim, dt, kind), 1))
    if not train:
        return {pre + "lstm_scan": n("lean")}
    return {pre + "lstm_scan_train": n("save"),
            pre + "lstm_scan_bwd": n("bwd")}


def _scan_launches(model, b: int, t: int, train: bool) -> dict:
    """The launches of the encoder's kernels in one forward over [B, T]
    frames (serving, valid_step) or one train step, by summary name."""
    enc, hp = getattr(model, "encoder", None), model.hp
    want = {name: 0 for name in KERNELS}
    if enc is None:            # tasnet-v1: no scan, cuDNN's convolutions
        return want

    def add(counts):
        for name, v in counts.items():
            want[name] += v
    dt = getattr(torch, hp.COMPUTE_DTYPE)
    if isinstance(enc, encoders.TcnEncoder):
        pass                                       # no scan: convolutions
    elif isinstance(enc, encoders.DprnnEncoder):
        _, h, p, hop, blocks, causal = enc._dims()
        p_eff = min(p, t)
        hop = hop if p_eff == p else max(p_eff // 2, 1)
        s = max(-(-(t - p_eff) // hop), 0) + 1     # chunks
        for _ in range(blocks):
            add(_lstm_launches(b * s, h, dt, train, 2))          # intra
            add(_lstm_launches(b * p_eff, h, dt, train, 1 if causal else 2))
    elif isinstance(enc, encoders.ConvBiLstmEncoder):
        for _ in range(2):
            add(_lstm_launches(b, hp.FFT_SIZE, dt, train, 2))
    elif isinstance(enc, (encoders.BiLstmEncoder, encoders.LstmEncoder)):
        for _ in range(enc.N_LAYERS):
            add(_lstm_launches(b, enc.HDIM, dt, train, 2 if isinstance(
                enc, encoders.BiLstmEncoder) else 1))
    else:
        lean, trained = ENCODER_KERNELS[hp.ENCODER_TYPE]
        add({name: _depth(enc) for name in (trained if train else lean)})
    return want


def _init(model) -> dict:
    """The seeded weights (seed 0) that the card-vs-CPU comparisons start
    from; an encoder in HEAD_SCALE with its LSTM head's weight scaled."""
    params = model.init(torch.Generator().manual_seed(0))
    scale = HEAD_SCALE.get(model.hp.ENCODER_TYPE)
    if scale is not None:
        params["encoder"]["output"]["w"] = \
            params["encoder"]["output"]["w"] * scale
    return params


def _serve(phase: int, encoder: str, requests, seed: int, keys=None,
           other_keys=None) -> dict:
    """Serve ``requests`` [(B, samples)] at full width of ``encoder`` (with
    config ``keys``) on the card (a warm-up, then the timed request), with
    launch counts per request; then check each answer against the CPU.
    With ``other_keys``, also time each request on the card under that
    config (attn-v1: the dense attention) for comparison."""
    keys = keys or {}
    hp = load_config(ENCODER_TYPE=encoder, **keys)
    model = hp.get_model()(hp)
    enc = model.encoder
    print("phase %d model: %s, %s, F=%d, E=%d, NUM_ANCHOR=%d, N=%d, FFT "
          "%d/%d @ %d Hz, %s, estimator %s, separator %s" % (
              phase, hp.ENCODER_TYPE, _describe(hp, enc), hp.FEATURE_SIZE,
              hp.EMBED_SIZE, hp.NUM_ANCHOR, hp.MAX_N_SIGNAL, hp.FFT_SIZE,
              hp.FFT_STRIDE, hp.SMPRATE, hp.COMPUTE_DTYPE,
              hp.INFER_ESTIMATOR_METHOD, hp.SEPARATOR_TYPE))
    params = _init(model)
    gpu = Separator(model, params, "cuda")
    cpu = Separator(model, params, "cpu")
    rs = np.random.RandomState(seed)
    waves = [_mixture(rs, b, n) for b, n in requests]
    outs, latencies = [], {}
    total = {name: 0 for name in KERNELS}

    # the main path: only these requests count kernel launches
    _zero_counts()
    calls = 0
    for (b, n), wav in zip(requests, waves):
        per_request = _scan_launches(
            model, b, stft_frame_count(n, hp.FFT_SIZE, hp.FFT_STRIDE), False)
        per_request["stft_ri"] += 1
        for _ in range(2):          # warm-up, then the timed request
            before = _counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gpu.separate(wav)  # numpy result: includes the sync
            dt = time.perf_counter() - t0
            calls += 1
            got = {k: v - before[k] for k, v in _counts().items()}
            if got != per_request:
                raise AssertionError("phase %d request B=%d L=%d launched %s, "
                                     "want %s" % (phase, b, n, got,
                                                  per_request))
            for k, v in per_request.items():
                total[k] += v
        outs.append(out)
        latencies[(b, n)] = dt * 1e3
    launches = _counts()
    if launches != total:
        raise AssertionError("launch counts %s over %d requests"
                             % (launches, calls))
    print("phase %d launches over %d requests: %s (no other kernel)"
          % (phase, calls, ", ".join("%s %d" % (k, v)
                                     for k, v in launches.items() if v)))
    other = {}
    if other_keys:
        ohp = load_config(ENCODER_TYPE=encoder, **other_keys)
        osep = Separator(ohp.get_model()(ohp), params, "cuda")
        for (b, n), wav in zip(requests, waves):
            osep.separate(wav)       # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            osep.separate(wav)
            other[(b, n)] = (time.perf_counter() - t0) * 1e3

    # correctness against the same model and weights on the CPU
    worst = 0.0
    for (b, n), wav, out in zip(requests, waves, outs):
        ref = cpu.separate(wav)
        want = (b, 2, n)             # trimmed to the request length
        peak = float(np.max(np.abs(ref)))
        err = float(np.max(np.abs(out - ref)))
        e_gpu, e_cpu = _embeddings(gpu, wav), _embeddings(cpu, wav)
        e_peak = float(e_cpu.abs().max())
        e_err = max_err(e_gpu.cpu(), e_cpu)
        if out.shape != want or not np.all(np.isfinite(out)) \
                or not err <= SERVE_RTOL * peak \
                or not e_err <= SERVE_RTOL * e_peak:
            raise AssertionError(
                "phase %d request B=%d L=%d: shape %s (want %s); vs CPU: wave "
                "max abs err %.3g (peak %.3g), embedding max abs err %.3g "
                "(peak %.3g); rtol %g of the peak" % (
                    phase, b, n, out.shape, want, err, peak, e_err, e_peak,
                    SERVE_RTOL))
        worst = max(worst, err / peak, e_err / e_peak)
        line = ("phase %d %s request B=%d %.2f s: out %s, latency %.3f ms"
                % (phase, encoder, b, n / SMPRATE, out.shape,
                   latencies[(b, n)]))
        if other:
            line += " (%s: %.3f ms)" % (
                ", ".join("%s=%s" % kv for kv in other_keys.items()
                          if keys.get(kv[0]) != kv[1]), other[(b, n)])
        print(line + "; vs CPU: wave max_abs_err %.3g (peak %.3g), embedding "
              "max_abs_err %.3g (peak %.3g), rtol %g of the peak"
              % (err, peak, e_err, e_peak, SERVE_RTOL))
    return {"launches": launches, "latency_ms": latencies,
            "other_latency_ms": other, "max_rel_err": worst}


def phase_serving() -> dict:
    return _serve(5, "bilstm-orig", [(1, SMPRATE), (1, 4 * SMPRATE),
                                     (1, 10 * SMPRATE), (4, 4 * SMPRATE)], 2)


def phase_serving_unidirectional() -> dict:
    return {enc: _serve(10, enc, [(1, 10 * SMPRATE), (4, 4 * SMPRATE)],
                        seed)
            for enc, seed in (("lstm-orig", 10), ("gru-v1", 11))}


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


def _check_kernels(phase: int, tag: str, dt, checks, worst: dict) -> list:
    """checks: [(kernel, output names, outputs, plain outputs, (atol,
    rtol))].  Raises where an output is not finite, not of its plain
    output's dtype and shape or not within atol + rtol |plain|; returns
    "name err" parts for the phase's line and keeps each kernel's worst
    error per storage dtype ``dt``."""
    parts = []
    for kernel, names, outs, refs, tol in checks:
        for name, o, r in zip(names, outs, refs):
            err, ratio = _allclose_err(o, r, *tol)
            parts.append("%s %.3g" % (name, err))
            if o.dtype != r.dtype or tuple(o.shape) != tuple(r.shape) \
                    or not torch.isfinite(o.float()).all() \
                    or not ratio <= 1.0:
                raise AssertionError(
                    "phase %d %s %s %s: max abs err %.3g beyond atol %g + "
                    "rtol %g" % (phase, kernel, tag, name, err, *tol))
            worst.setdefault(kernel, {torch.float32: 0.0,
                                      torch.bfloat16: 0.0})
            worst[kernel][dt] = max(worst[kernel][dt], err)
    return parts


def _tag(dt, tanh, t, b) -> str:
    return "%s%s T=%d B=%d" % (str(dt).replace("torch.", ""),
                               "" if tanh is None
                               else " tanh" if tanh else " identity", t, b)


def _per_step(kernel, t: int) -> tuple:
    """(ms, us per step) of a kernel's call over T steps, 10 launches."""
    ms = cuda_ms(kernel, 10)
    return ms, 1e3 * ms / t


def _time_pair(times: dict, name: str, kernel, plain, t: int) -> str:
    """Kernel (10 launches) and plain (2 runs) times of one call."""
    times[name] = (cuda_ms(kernel, 10), cuda_ms(plain, 2))
    ms, plain_ms = times[name]
    return "; %s kernel %.4f ms (%.3f us/step), plain %.4f ms" % (
        name, ms, 1e3 * ms / t, plain_ms)


# phases 6 and 8: the ragged shape that leaves one live row in kernel 3's
# second pass of 32 rows, tanh candidate, both dtypes, after the others
RAGGED = [(dt, True, 64, 33) for dt in (torch.float32, torch.bfloat16)]


def phase_train_kernels() -> dict:
    rs = np.random.RandomState(4)
    worst, times = {}, {}
    cases = [(dt, tanh, t, b) for dt in (torch.float32, torch.bfloat16)
             for tanh in (True, False) for t, b in ((128, 32), (1251, 1))]
    for dt, tanh, t, b in cases + RAGGED:
        xp, wh, c0, h0 = _scan_inputs(rs, t, b, dt)
        d_hs = torch.from_numpy(rs.randn(t, 2, b, 300).astype(
            np.float32)).cuda().to(dt)
        args = (xp, wh, c0, h0, tanh)
        fwd = cuda_lstm.bilstm_scan_train(*args)
        fwd_ref = cuda_lstm.bilstm_scan_train_plain(*args)
        _, cs, acts = fwd_ref
        c_prev = torch.cat([c0[None], cs[:-1]])
        bargs = (d_hs, acts, cs, c_prev, wh, tanh)
        bwd = cuda_lstm.bilstm_scan_bwd(*bargs)
        bwd_ref = cuda_lstm.bilstm_scan_bwd_plain(*bargs)
        torch.cuda.synchronize()
        tag = _tag(dt, tanh, t, b)
        parts = _check_kernels(6, tag, dt, (
            ("bilstm_scan_train", ("hs", "cs", "acts"), fwd,
             fwd_ref, TRAIN_FWD_TOL[dt]),
            ("bilstm_scan_bwd", ("dxp", "dc0", "dh0"), bwd,
             bwd_ref, TRAIN_BWD_TOL[dt])), worst)
        line = "phase 6 %s max_abs_err: %s (fwd atol %g rtol %g, " \
            "bwd atol %g rtol %g)" % (tag, ", ".join(parts),
                                     *TRAIN_FWD_TOL[dt],
                                     *TRAIN_BWD_TOL[dt])
        if dt == torch.float32 and tanh and (t, b) == (128, 32):
            line += _time_pair(
                times, "bilstm_scan_train",
                lambda: cuda_lstm.bilstm_scan_train(*args),
                lambda: cuda_lstm.bilstm_scan_train_plain(*args), t)
            line += _time_pair(
                times, "bilstm_scan_bwd",
                lambda: cuda_lstm.bilstm_scan_bwd(*bargs),
                lambda: cuda_lstm.bilstm_scan_bwd_plain(*bargs), t)
        elif dt == torch.float32 and (t, b) == (64, 33):
            line += "; kernel 3 %.4f ms (%.3f us/step)" % _per_step(
                lambda: cuda_lstm.bilstm_scan_bwd(*bargs), t)
        print(line)
    # kernel 2 alone at larger batches: several passes of 32 rows
    for t, b in ((TRAIN_T, 70), (TRAIN_T, 128)):
        args = tuple(_scan_inputs(rs, t, b, torch.float32)) + (True,)
        fwd = cuda_lstm.bilstm_scan_train(*args)
        fwd_ref = cuda_lstm.bilstm_scan_train_plain(*args)
        torch.cuda.synchronize()
        tag = _tag(torch.float32, True, t, b)
        parts = _check_kernels(6, tag, torch.float32, (
            ("bilstm_scan_train", ("hs", "cs", "acts"), fwd, fwd_ref,
             TRAIN_FWD_TOL[torch.float32]),), worst)
        print("phase 6 %s max_abs_err: %s (fwd atol %g rtol %g); "
              "bilstm_scan_train kernel %.4f ms (%.3f us/step)"
              % (tag, ", ".join(parts), *TRAIN_FWD_TOL[torch.float32],
                 *_per_step(lambda: cuda_lstm.bilstm_scan_train(*args), t)))
    return {"max_abs_err": worst, "times": times}


def _cuda(rs_arrays, dtype) -> list:
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
            .to(dtype) for a in rs_arrays]


def _lstm_inputs(rs, t, b, dtype):
    """Layer-shaped inputs of lstm-orig's layers 1-3 (H = I = 600):
    xp = x @ Wx + gate bias with x ~ a layer's activations, Wx and Wh at
    lstm-orig's init scale; nonzero c0 and h0, and a cotangent d_hs."""
    h = 600
    scale = 1.15 / np.sqrt(h)
    x = rs.randn(t * b, h).astype(np.float32) * 0.5
    wx = rs.uniform(-scale, scale, (h, 4 * h)).astype(np.float32)
    bias = np.repeat(np.array([0.0, 1.5, -1.0, 1.0], np.float32), h)
    xp = (x @ wx + bias).reshape(t, b, 4 * h)
    wh = rs.uniform(-scale, scale, (h, 4 * h))
    c0 = rs.randn(b, h) * 0.5
    h0 = rs.uniform(-0.5, 0.5, (b, h))
    return _cuda((xp, wh, c0, h0, rs.randn(t, b, h)), dtype)


def phase_lstm_unidirectional() -> dict:
    rs = np.random.RandomState(8)
    worst, times = {}, {}
    cases = [(dt, tanh, t, b) for dt in (torch.float32, torch.bfloat16)
             for tanh in (True, False) for t, b in ((1251, 1), (128, 32))]
    for dt, tanh, t, b in cases + RAGGED:
        xp, wh, c0, h0, d_hs = _lstm_inputs(rs, t, b, dt)
        args = (xp, wh, c0, h0, tanh)
        lean = cuda_lstm.lstm_scan(*args)
        lean_ref = cuda_lstm.lstm_scan_plain(*args)
        fwd = cuda_lstm.lstm_scan_train(*args)
        fwd_ref = cuda_lstm.lstm_scan_train_plain(*args)
        _, cs, acts = fwd_ref
        c_prev = torch.cat([c0[None], cs[:-1]])
        bargs = (d_hs, acts, cs, c_prev, wh, tanh)
        bwd = cuda_lstm.lstm_scan_bwd(*bargs)
        bwd_ref = cuda_lstm.lstm_scan_bwd_plain(*bargs)
        torch.cuda.synchronize()
        tag = _tag(dt, tanh, t, b)
        parts = _check_kernels(8, tag, dt, (
            ("lstm_scan", ("hs",), (lean,), (lean_ref,),
             (LSTM_ATOL[dt], 0.0)),
            ("lstm_scan_train", ("hs", "cs", "acts"), fwd, fwd_ref,
             TRAIN_FWD_TOL[dt]),
            ("lstm_scan_bwd", ("dxp", "dc0", "dh0"), bwd, bwd_ref,
             TRAIN_BWD_TOL[dt])), worst)
        line = "phase 8 %s max_abs_err: %s" % (tag, ", ".join(parts))
        if dt == torch.float32 and tanh and (t, b) == (1251, 1):
            line += _time_pair(
                times, "lstm_scan",
                lambda: cuda_lstm.lstm_scan(*args),
                lambda: cuda_lstm.lstm_scan_plain(*args), t)
        if dt == torch.float32 and tanh and (t, b) == (128, 32):
            line += _time_pair(
                times, "lstm_scan_train",
                lambda: cuda_lstm.lstm_scan_train(*args),
                lambda: cuda_lstm.lstm_scan_train_plain(*args), t)
            line += _time_pair(
                times, "lstm_scan_bwd",
                lambda: cuda_lstm.lstm_scan_bwd(*bargs),
                lambda: cuda_lstm.lstm_scan_bwd_plain(*bargs), t)
            line += "; lstm_scan kernel %.4f ms (%.3f us/step)" % _per_step(
                lambda: cuda_lstm.lstm_scan(*args), t)
        elif dt == torch.float32 and (t, b) == (64, 33):
            line += "; kernel 3 %.4f ms (%.3f us/step)" % _per_step(
                lambda: cuda_lstm.lstm_scan_bwd(*bargs), t)
        elif dt == torch.bfloat16 and tanh and (t, b) == (128, 32):
            line += "; lstm_scan_train kernel %.4f ms (%.3f us/step)" \
                % _per_step(lambda: cuda_lstm.lstm_scan_train(*args), t)
        print(line)
    # the lean kernel alone at the 4 x 4 s serving batch
    t, b = 501, 4
    for dt in (torch.float32, torch.bfloat16):
        xp, wh, c0, h0, _ = _lstm_inputs(rs, t, b, dt)
        args = (xp, wh, c0, h0, True)
        lean = cuda_lstm.lstm_scan(*args)
        lean_ref = cuda_lstm.lstm_scan_plain(*args)
        torch.cuda.synchronize()
        tag = _tag(dt, True, t, b)
        parts = _check_kernels(8, tag, dt, (
            ("lstm_scan", ("hs",), (lean,), (lean_ref,),
             (LSTM_ATOL[dt], 0.0)),), worst)
        line = "phase 8 %s max_abs_err: %s" % (tag, ", ".join(parts))
        if dt == torch.float32:
            line += "; lstm_scan kernel %.4f ms (%.3f us/step)" % _per_step(
                lambda: cuda_lstm.lstm_scan(*args), t)
        print(line)
    return {"max_abs_err": worst, "times": times}


def _gru_inputs(rs, t, b, dtype, h=600):
    """Layer-shaped GRU inputs (H = I, gru-v1's 600 by default): gx = x @
    Wgx, cx = x @ Wcx + 1 (gru-v1's biases), all weights U(-1/sqrt(H),
    1/sqrt(H)), ten times gru-v1's init scale, so that the recurrent
    products move the state; a nonzero c0 and a cotangent d_cs."""
    scale = 1.0 / np.sqrt(h)
    x = rs.randn(t * b, h).astype(np.float32) * 0.5
    gx = x @ rs.uniform(-scale, scale, (h, 2 * h)).astype(np.float32)
    cx = x @ rs.uniform(-scale, scale, (h, h)).astype(np.float32) + 1.0
    wgh = rs.uniform(-scale, scale, (h, 2 * h))
    wch = rs.uniform(-scale, scale, (h, h))
    c0 = rs.randn(b, h) * 0.5
    return _cuda((gx.reshape(t, b, 2 * h), cx.reshape(t, b, h), wgh, wch, c0,
                  rs.randn(t, b, h)), dtype)


def phase_gru() -> dict:
    rs = np.random.RandomState(9)
    worst, times = {}, {}
    cases = [(dt, t, b, 600) for dt in (torch.float32, torch.bfloat16)
             for t, b in ((1251, 1), (128, 32), (64, 33))]
    cases += [(dt, t, b, 300) for dt in (torch.float32, torch.bfloat16)
              for t, b in ((1251, 1), (64, 33))]
    for dt, t, b, h in cases:
        gx, cx, wgh, wch, c0, d_cs = _gru_inputs(rs, t, b, dt, h)
        args = (gx, cx, wgh, wch, c0)
        lean = cuda_gru.gru_scan(*args)
        lean_ref = cuda_gru.gru_scan_plain(*args)
        fwd = cuda_gru.gru_scan_train(*args)
        fwd_ref = cuda_gru.gru_scan_train_plain(*args)
        cs, acts = fwd_ref
        c_prev = torch.cat([c0[None], cs[:-1]])
        bargs = (d_cs, acts, c_prev, wgh, wch)
        bwd = cuda_gru.gru_scan_bwd(*bargs)
        bwd_ref = cuda_gru.gru_scan_bwd_plain(*bargs)
        torch.cuda.synchronize()
        tag = _tag(dt, None, t, b) + " H=%d" % h
        parts = _check_kernels(9, tag, dt, (
            ("gru_scan", ("cs",), (lean,), (lean_ref,),
             (LSTM_ATOL[dt], 0.0)),
            ("gru_scan_train", ("cs", "acts"), fwd, fwd_ref,
             TRAIN_FWD_TOL[dt]),
            ("gru_scan_bwd", ("dgx", "dcx", "dc0"), bwd, bwd_ref,
             TRAIN_BWD_TOL[dt])), worst)
        line = "phase 9 %s max_abs_err: %s" % (tag, ", ".join(parts))
        if dt == torch.float32 and (t, b, h) == (1251, 1, 600):
            line += _time_pair(times, "gru_scan",
                               lambda: cuda_gru.gru_scan(*args),
                               lambda: cuda_gru.gru_scan_plain(*args), t)
        if dt == torch.float32 and (t, b) == (128, 32):
            line += _time_pair(
                times, "gru_scan_train",
                lambda: cuda_gru.gru_scan_train(*args),
                lambda: cuda_gru.gru_scan_train_plain(*args), t)
            line += _time_pair(
                times, "gru_scan_bwd",
                lambda: cuda_gru.gru_scan_bwd(*bargs),
                lambda: cuda_gru.gru_scan_bwd_plain(*bargs), t)
        elif dt == torch.bfloat16 and (t, b) == (128, 32):
            line += "; gru_scan_bwd kernel %.4f ms (%.3f us/step)" \
                % _per_step(lambda: cuda_gru.gru_scan_bwd(*bargs), t)
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


def _counted(fn, want: dict, what: str):
    """Run fn() and check how often each kernel launched in it."""
    before = _counts()
    out = fn()
    got = {k: v - before[k] for k, v in _counts().items()}
    if got != want:
        raise AssertionError("%s launched %s, want %s" % (what, got, want))
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _errs(card: dict, cpu: dict, keys, snr_ratio: bool) -> dict:
    """Relative errors of the loss and the SNR (and SI_SNR); with
    ``snr_ratio`` that of the power ratio behind the SNR (phase 11, see
    the module docstring)."""
    return {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 10.0 / np.log(10))
            if k in ("SNR", "SI_SNR") and snr_ratio else _rel(card[k], cpu[k])
            for k in keys}


def _sync(dst: dict, src: dict) -> None:
    """The CPU trainer's state takes over the card's parameters, Adam
    moments and EMA."""
    with torch.no_grad():
        pairs = list(zip(weights.leaves(dst["params"]),
                         weights.leaves(src["params"])))
        pairs += list(zip(dst["opt"].mu, src["opt"].mu))
        pairs += list(zip(dst["opt"].nu, src["opt"].nu))
        if src.get("ema") is not None:
            pairs += list(zip(weights.leaves(dst["ema"]),
                              weights.leaves(src["ema"])))
        for d, s in pairs:
            d.copy_(s.cpu())
    dst["opt"].count = src["opt"].count
    dst["step"] = src["step"]


def _record_grads(opt, apply=None) -> None:
    """Make ``opt.step`` keep the gradients it is handed, moved to the CPU,
    in ``opt.recorded``; with ``apply`` (a callable that returns
    gradients) it applies those instead of the ones it was handed."""
    step = opt.step

    def recording_step(grads):
        opt.recorded = [g.detach().cpu().clone() for g in grads]
        step(apply() if apply is not None else grads)
    opt.step = recording_step


def _check_synced_step(tag: str, dtype: str, names: list, sg: dict,
                       sc: dict) -> float:
    """After one step of phase 11 taken from one state: float32 gradients
    card vs CPU per tensor to 1e-4 of the tensor's peak; then the card's
    parameters against the CPU's (the CPU's Adam step applied to the
    card's gradients) to one float32 ulp + 1e-6 x LR.  -> the worst
    gradient error as a share of its tensor's peak (0 in bfloat16)."""
    worst, worst_name = 0.0, names[0]
    if dtype == "float32":
        for name, g, r in zip(names, sg["opt"].recorded, sc["opt"].recorded):
            peak = float(r.abs().max())
            err = float((g - r).abs().max())
            if not err <= 1e-4 * peak:
                raise AssertionError("%s gradient %s: max abs err %.3g > "
                                     "1e-4 x peak %.3g" % (tag, name, err,
                                                          peak))
            if peak and err / peak > worst:
                worst, worst_name = err / peak, name
    lr = sg["opt"].lr
    d_max, share = 0.0, 0.0
    for name, g, c in zip(names, weights.leaves(sg["params"]),
                          weights.leaves(sc["params"])):
        g, c = g.detach().cpu(), c.detach()
        ulp = torch.nextafter(c.abs(), torch.tensor(float("inf"))) - c.abs()
        d = (g - c).abs()
        ratio = float((d / (ulp + 1e-6 * lr)).max())
        if not ratio <= 1.0:
            raise AssertionError(
                "%s parameters %s: max |card - CPU's Adam step on the card's "
                "gradients| %.3g beyond 1 ulp + 1e-6 x LR" % (
                    tag, name, float(d.max())))
        d_max = max(d_max, float(d.max()))
        share = max(share, ratio)
    print("%s: %sparameters vs the CPU's Adam step on the card's gradients: "
          "max abs diff %.3g, worst element at %.3g of its bound (1 ulp + "
          "1e-6 x LR)"
          % (tag, "" if dtype != "float32" else
             "gradients worst max abs err %.3g of the tensor's peak (%s; "
             "bound 1e-4); " % (worst, worst_name), d_max, share))
    return worst


class _PitTies:
    """Phase 11's protocol takes each step from one state; in float32,
    whose gradients it compares, this carries it over to the permutation
    that ``pit_mse_loss`` picks (in phase 17, the ANCHOR_AUX_LOSS term
    through kmeans).  Under random weights kmeans can give both sources
    nearly the same mask, so that both permutations cost the same to
    within float32 rounding, and the card and the CPU, summing in other
    orders, may pick different ones: the same loss, but the gradient of
    the other permutation.  While installed, the card's calls record their
    choice; a CPU call that picked otherwise takes the card's choice (and
    that permutation's loss) where the float64 costs of the two tie within
    TIE_RTOL, and prints so; anything else fails."""

    def __init__(self, tag: str):
        self.tag, self.real, self.card, self.side = tag, None, [], None

    def __enter__(self):
        self.real = loss_ops.pit_mse_loss
        loss_ops.pit_mse_loss = self
        return self

    def __exit__(self, *exc):
        loss_ops.pit_mse_loss = self.real

    def __call__(self, x, y, complex_ri=False, method="gemm"):
        loss, perms, idx = self.real(x, y, complex_ri, method)
        if self.side == "card":
            self.card.append(idx.cpu())
        elif self.side == "cpu":
            want = self.card.pop(0).to(idx.device)
            rows = torch.nonzero(idx != want).flatten().tolist()
            if rows:
                def cost(x, y, sel):   # [B]: the sum over sources of MSEs
                    d2 = torch.square(x - loss_ops.unpermute(y, perms, sel))
                    if complex_ri:
                        d2 = torch.sum(d2, dim=-1)
                    return torch.sum(torch.mean(d2, dim=tuple(
                        range(2, d2.dim()))), dim=1)
                with torch.no_grad():
                    own = cost(x.double(), y.double(), idx)
                    card = cost(x.double(), y.double(), want)
                    gap = ((card - own).abs() / own.abs())[rows].tolist()
                line = ("%s: the CPU's PIT permutation differs from the "
                        "card's at rows %s, float64 cost gap %s of the cost "
                        "(TIE_RTOL %g)" % (self.tag, rows, ", ".join(
                            "%.3g" % g for g in gap), TIE_RTOL))
                if not max(gap) <= TIE_RTOL:
                    raise AssertionError(line)
                print(line + ": a tie, the CPU takes the card's")
                return torch.mean(cost(x, y, want)), perms, want
        return loss, perms, idx


def _step_vs_cpu(phase: int, encoder: str, dtype: str, i: int, gpu, cpu,
                 sg: dict, sc: dict, batch, synced: bool, names: list,
                 step_want: dict) -> tuple:
    """Train step i + 1 on the card and on the CPU; ``synced``: from one
    state, with the gradients and the optimizer step checked (phase 11).
    -> (worst relative loss/SNR error, worst gradient error)."""
    rtol = STEP_RTOL[dtype]
    grad_err = 0.0
    if synced:
        _sync(sc, sg)
    # only float32 compares gradients, which a tie makes jump; the
    # losses that bfloat16 compares are continuous across one
    aligned = synced and dtype == "float32"
    with _PitTies("phase %d %s %s step %d" % (phase, encoder, dtype,
                                              i + 1)) as ties:
        ties.side = "card" if aligned else None
        mg = _counted(lambda: gpu.train_step(sg, batch), step_want,
                      "phase %d %s train step %d (%s)"
                      % (phase, encoder, i + 1, dtype))
        ties.side = "cpu" if aligned else None
        mc = cpu.train_step(sc, batch)
    mg = {k: float(v) for k, v in mg.items()}
    mc = {k: float(v) for k, v in mc.items()}
    if synced:
        grad_err = _check_synced_step(
            "phase %d %s %s step %d" % (phase, encoder, dtype, i + 1),
            dtype, names, sg, sc)
    keys = ("loss", "SNR") if dtype == "float32" else ("loss",)
    errs = _errs(mg, mc, keys, synced)
    print("phase %d %s %s step %d: card loss %.9g SNR %.6g, CPU loss "
          "%.9g SNR %.6g; relative err %s (rtol %g)"
          % (phase, encoder, dtype, i + 1, mg["loss"], mg["SNR"],
             mc["loss"], mc["SNR"],
             " ".join("%s %.3g" % kv for kv in errs.items()), rtol))
    if not all(np.isfinite(v) for v in mg.values()) \
            or not max(errs.values()) <= rtol:
        raise AssertionError("phase %d %s %s step %d: card %s vs CPU %s"
                             % (phase, encoder, dtype, i + 1, mg, mc))
    return max(errs.values()), grad_err


def _train_dtype(phase: int, encoder: str, dtype: str, synced: bool,
                 keys: dict) -> dict:
    """One COMPUTE_DTYPE of a training phase: card vs CPU, launch counts;
    ``synced``: the CPU starts each step from the card's state, and each
    step's gradients and optimizer step are checked (phase 11)."""
    hp = load_config(ENCODER_TYPE=encoder, COMPUTE_DTYPE=dtype, **keys)
    model = hp.get_model()(hp)
    batches = _toy_batches(hp, TRAIN_STEPS + 1)
    frames = sorted({b.shape[2] for b in batches})
    if frames != [TRAIN_T]:        # the flash path takes T % 128 == 0 only
        raise AssertionError("phase %d batches of %s frames, want %d"
                             % (phase, frames, TRAIN_T))
    p0 = weights.to_jax(_init(model))
    gpu, cpu = Trainer(model, hp, "cuda"), Trainer(model, hp, "cpu")
    sg, sc = gpu.init_state(params=p0), cpu.init_state(params=p0)
    if synced:
        _record_grads(sg["opt"])
        _record_grads(sc["opt"], apply=lambda: sg["opt"].recorded)
    names = ["/".join(k) for k in _paths(p0)]
    step_want = _scan_launches(model, hp.BATCH_SIZE, TRAIN_T, True)
    valid_want = _scan_launches(model, hp.BATCH_SIZE, TRAIN_T, False)
    rtol = STEP_RTOL[dtype]
    worst = grad_worst = 0.0
    for i, batch in enumerate(batches[:TRAIN_STEPS]):
        err, grad_err = _step_vs_cpu(phase, encoder, dtype, i, gpu, cpu, sg,
                                     sc, batch, synced, names, step_want)
        worst, grad_worst = max(worst, err), max(grad_worst, grad_err)
    if synced:
        _sync(sc, sg)
    vg = _counted(lambda: gpu.valid_step(sg, batches[-1]), valid_want,
                  "phase %d %s valid step (%s)" % (phase, encoder, dtype))
    vg = {k: float(v) for k, v in vg.items()}
    vc = {k: float(v) for k, v in cpu.valid_step(sc, batches[-1]).items()}
    print("phase %d %s %s valid step: card %s, CPU %s"
          % (phase, encoder, dtype, vg, vc))
    # float32 also holds SI_SNR (dB, EVAL_SI_SNR) as phase 11 holds the SNR
    valid_errs = _errs(vg, vc, [k for k in ("loss", "SI_SNR") if k in vg
                                and (k == "loss" or dtype == "float32")],
                       True)
    if not all(np.isfinite(v) for v in vg.values()) \
            or not max(valid_errs.values()) <= rtol:
        raise AssertionError("phase %d %s %s valid step: card %s vs CPU %s"
                             % (phase, encoder, dtype, vg, vc))
    return {"model": model, "p0": p0, "batches": batches, "gpu": sg,
            "cpu": sc, "worst_step_rel": worst, "grad_rel": grad_worst}


def _check_params_f32(phase: int, run: dict) -> float:
    """Step-1 gradients, card vs CPU, per tensor to 1e-4 of the tensor's
    peak; then the parameters after TRAIN_STEPS steps to PARAM_RTOL of the
    tensor's peak change from init plus one float32 ulp per step."""
    model, p0, batch = run["model"], run["p0"], run["batches"][0]
    tag = "phase %d %s" % (phase, model.hp.ENCODER_TYPE)
    names = ["/".join(k) for k in _paths(p0)]
    grads = []
    for dev in ("cuda", "cpu"):
        tr = Trainer(model, model.hp, dev)
        st = tr.init_state(params=p0)
        grads.append([g.cpu() for g in tr.loss_and_grads(
            st["params"], tr.ingest(batch))[1]])
    worst = 0.0
    for name, g, r in zip(names, *grads):
        peak = float(r.abs().max())
        err = float((g - r).abs().max())
        if not err <= 1e-4 * peak:
            raise AssertionError("%s step-1 gradient %s: max abs err %.3g > "
                                 "1e-4 x peak %.3g" % (tag, name, err, peak))
        worst = max(worst, err / peak if peak else 0.0)
    print("%s float32 step-1 gradients: worst max abs err %.3g of the "
          "tensor's peak (bound 1e-4), %d tensors" % (tag, worst, len(names)))
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
        line = ("%s float32 after step %d: %s max |card - CPU| %.3g, peak "
                "change %.3g; beyond 1e-4 of it + %d ulp: %d of %d"
                % (tag, TRAIN_STEPS, name, float(d.max()), change,
                   TRAIN_STEPS, int(beyond.sum()), d.numel()))
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
        raise AssertionError("%s parameters after step %d beyond %g of the "
                             "peak change + %d ulp: %s"
                             % (tag, TRAIN_STEPS, PARAM_RTOL, TRAIN_STEPS,
                                bad))
    return worst


def _paths(tree, prefix=()):
    out = []
    for k, v in tree.items():
        out.extend(_paths(v, prefix + (k,)) if isinstance(v, dict)
                   else [prefix + (k,)])
    return out


def _step_ms(encoder: str, dtype: str, keys: dict, reps: int) -> float:
    """Median wall time of a synchronized train step on the card."""
    hp = load_config(ENCODER_TYPE=encoder, COMPUTE_DTYPE=dtype, **keys)
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
            raise AssertionError("timing %s %s %s: loss %s"
                                 % (encoder, dtype, keys, m["loss"]))
    return float(np.median(out[1:]))


def _train(phase: int, encoder: str, reps: int, plain_reps: int,
           synced: bool, keys=None, plain_keys=None, time_keys=None) -> dict:
    """A training phase for one encoder: both dtypes card vs CPU with the
    launch counts, the float32 gradients and parameters, step times;
    ``synced`` selects phase 11's protocol (see the module docstring).
    ``keys`` configure the kernel path, ``plain_keys`` the path timed
    beside it (recurrent encoders: LSTM_BACKEND 'auto' and 'xla');
    ``time_keys`` are laid over both in the timed steps only.
    ``plain_reps`` 0: no plain path is timed (an encoder without scan
    kernels)."""
    keys = keys if keys is not None else {"LSTM_BACKEND": "auto"}
    plain_keys = plain_keys if plain_keys is not None \
        else {"LSTM_BACKEND": "xla"}
    time_keys = time_keys or {}
    _zero_counts()  # the main path of this phase: the counts start at 0
    runs = {dt: _train_dtype(phase, encoder, dt, synced, keys)
            for dt in ("float32", "bfloat16")}
    launches = _counts()
    print("phase %d %s launches over 2 x (%d train steps + 1 valid step): "
          "%s" % (phase, encoder, TRAIN_STEPS,
                  {k: v for k, v in launches.items() if v}))
    grad_rel = runs["float32"]["grad_rel"] if synced \
        else _check_params_f32(phase, runs["float32"])
    model = runs["float32"]["model"]
    times = {}
    for dt in ("float32", "bfloat16"):
        kernel = _step_ms(encoder, dt, dict(keys, **time_keys), reps)
        plain = _step_ms(encoder, dt, dict(plain_keys, **time_keys),
                         plain_reps) if plain_reps else None
        times[dt] = (kernel, plain)
        print("phase %d %s %s train step (B=%d, T=%d, %s%s): kernel path "
              "%.3f ms, %s (medians)"
              % (phase, encoder, dt, model.hp.BATCH_SIZE, TRAIN_T,
                 _describe(model.hp, model.encoder), "".join(
                     ", %s=%s" % kv for kv in time_keys.items()),
                 kernel, "%s path %.3f ms" % (", ".join(
                     "%s=%s" % kv for kv in plain_keys.items()
                     if keys.get(kv[0]) != kv[1]), plain)
                 if plain is not None else "no scan kernel, no plain path"))
    return {"launches": launches, "times": times, "grad_rel": grad_rel,
            "step_rel": {dt: r["worst_step_rel"] for dt, r in runs.items()}}


def phase_training() -> dict:
    return _train(7, "bilstm-orig", 5, 3, False)


def phase_training_unidirectional() -> dict:
    return {enc: _train(11, enc, 5, 2, True)
            for enc in ("lstm-orig", "gru-v1")}


def _flash_inputs(rs, b: int, t: int, dtype):
    """attn-v1-shaped inputs: q, k, v as views of one [B, T, 3, H, D]
    projection (as the encoder hands them over), segment ids with the
    last row's final 37 frames padded, and a cotangent do."""
    qkv, do = _cuda((rs.randn(b, t, 3, ATTN_H, ATTN_D),
                     rs.randn(b, t, ATTN_H, ATTN_D)), dtype)
    seg = torch.zeros(b, t, dtype=torch.int32)
    seg[-1, t - 37:] = 1                        # 0 = real, 1 = padding
    seg = seg.cuda()
    return (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], seg,
            1.0 / ATTN_D ** 0.5), do


def phase_flash_kernels() -> dict:
    """Phase 13: the three flash kernels vs their plain versions."""
    rs = np.random.RandomState(13)
    worst, times = {}, {}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for dt in (torch.float32, torch.bfloat16):
        for t, b in ((1280, 1), (TRAIN_T, 32), (384, 1)):
            args, do = _flash_inputs(rs, b, t, dt)
            fwd = cuda_attn.flash_attn(*args)
            fwd_ref = cuda_attn.flash_attn_plain(*args)
            o, l, m = fwd_ref
            di = torch.sum(o.float() * do.float(), dim=-1).transpose(
                1, 2).contiguous()
            bargs = args[:4] + (l, m, do, di, args[4])
            dkv = cuda_attn.flash_attn_bwd_dkv(*bargs)
            dkv_ref = cuda_attn.flash_attn_bwd_dkv_plain(*bargs)
            dq = cuda_attn.flash_attn_bwd_dq(*bargs)
            dq_ref = cuda_attn.flash_attn_bwd_dq_plain(*bargs)
            torch.cuda.synchronize()
            tag = _tag(dt, None, t, b)
            fwd_tol, bwd_tol = TRAIN_FWD_TOL[dt], TRAIN_BWD_TOL[dt]
            parts = _check_kernels(13, tag, dt, (
                ("flash_attn", ("o",), fwd[:1], fwd_ref[:1], fwd_tol),
                ("flash_attn stats", ("l",), fwd[1:2], fwd_ref[1:2],
                 STATS_TOL),
                ("flash_attn stats", ("m",), fwd[2:], fwd_ref[2:],
                 (1e-5, 0.0)),
                ("flash_attn_bwd_dkv", ("dk", "dv"), dkv, dkv_ref, bwd_tol),
                ("flash_attn_bwd_dq", ("dq",), (dq,), (dq_ref,), bwd_tol)),
                worst)
            line = ("phase 13 %s H=%d D=%d S=%d max_abs_err: %s (o atol %g "
                    "rtol %g, l rtol %g, m atol 1e-5, grads atol %g rtol %g);"
                    " digests dk, dv %s, dq %s"
                    % (tag, ATTN_H, ATTN_D,
                       cuda_attn.flash_splits(b, t, ATTN_H, n_sm),
                       ", ".join(parts), *fwd_tol, STATS_TOL[1], *bwd_tol,
                       _digest(dkv), _digest([dq])))
            if dt == torch.float32:
                timed = [("flash_attn", cuda_attn.flash_attn,
                          cuda_attn.flash_attn_plain, args)]
                if b > 1:
                    timed += [("flash_attn_bwd_dkv",
                               cuda_attn.flash_attn_bwd_dkv,
                               cuda_attn.flash_attn_bwd_dkv_plain, bargs),
                              ("flash_attn_bwd_dq",
                               cuda_attn.flash_attn_bwd_dq,
                               cuda_attn.flash_attn_bwd_dq_plain, bargs)]
                for name, kernel, plain, a in timed:
                    pair = (cuda_ms(lambda: kernel(*a), 20),
                            cuda_ms(lambda: plain(*a), 5))
                    times[(name, t, b)] = pair
                    line += "; %s kernel %.4f ms, plain %.4f ms" % (
                        name, *pair)
            print(line)
    return {"max_abs_err": worst, "times": times}


def phase_serving_attention() -> dict:
    """Phase 14: attn-v1 serving on its flash path (T = L / 64 + 1: 1280
    frames for the 10.2 s request, 512 for the batch of 4)."""
    return _serve(14, "attn-v1", [(1, 81856), (4, 32704)], 14, FLASH, DENSE)


def phase_training_attention() -> dict:
    """Phase 15: attn-v1 training on its flash path, phase 11's protocol."""
    return _train(15, "attn-v1", 5, 3, True, FLASH, DENSE)


def phase_stft_logmag(window) -> dict:
    """Phase 16: kernel 6 (kernel A's (|Z|, log1p|Z|) epilogue) vs its
    plain version.  No main path of the port (or of the JAX package) calls
    it, so its launch count is this phase's comparison launches."""
    rs = np.random.RandomState(16)
    cuda_stft.stft_logmag.launches = 0
    worst = 0.0
    for b, n in ((4, 80037), (1, 80000), (1, 81856), (4, 32704)):
        x = torch.from_numpy((rs.randn(b, n) * 0.3).astype(np.float32)).cuda()
        out = cuda_stft.stft_logmag(x, 256, 64, window)
        ref = cuda_stft.stft_ri_plain(x, 256, 64, window, logmag=True)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        if tuple(out.shape) != tuple(ref.shape) \
                or not torch.isfinite(out).all() or not err <= STFT_ATOL:
            raise AssertionError("stft_logmag B=%d L=%d: max abs err %.3g > "
                                 "%g" % (b, n, err, STFT_ATOL))
        worst = max(worst, err)
        print("phase 16 stft_logmag B=%d L=%d T=%d: max_abs_err %.3g (atol "
              "%g), digest %s" % (b, n, out.shape[1], err, STFT_ATOL,
                                  _digest([out])))
    launches = cuda_stft.stft_logmag.launches
    x = torch.from_numpy((rs.randn(1, 80000) * 0.3).astype(np.float32)).cuda()
    times = (cuda_ms(lambda: cuda_stft.stft_logmag(x, 256, 64, window), 50),
             cuda_ms(lambda: cuda_stft.stft_ri_plain(x, 256, 64, window,
                                                     logmag=True), 50))
    print("phase 16 stft_logmag B=1 L=80000: kernel %.4f ms, plain %.4f ms; "
          "%d comparison launches" % (*times, launches))
    return {"max_abs_err": worst, "times": times, "launches": launches}


def tpu_keys(phase: int) -> dict:
    """configs/tpu.json as config keys, with TPU_RESET at default.json's
    values (printed), without ENCODER_TYPE and COMPUTE_DTYPE (each phase
    sets them), and DROPOUT_KEEP_PROB at 1: the card's and the CPU's
    generators draw other masks, so the comparisons run without dropout
    and only the timed steps take the config's own."""
    with open(TPU_JSON) as f:
        keys = json.load(f)
    with open(DEFAULT_JSON) as f:
        default = json.load(f)
    reset = {k: default[k] for k in TPU_RESET}
    print("phase %d configs/tpu.json: reset to default.json's values: %s"
          % (phase, ", ".join("%s %r -> %r" % (k, keys[k], v)
                              for k, v in reset.items())))
    keys.update(reset, DROPOUT_KEEP_PROB=1.0)
    for k in ("ENCODER_TYPE", "COMPUTE_DTYPE"):
        del keys[k]
    return keys


def _valid_sdr(keys: dict) -> dict:
    """Phase 17: one valid batch with EVAL_SDR (BSS_FILT_LEN 512) at B=4,
    float32, card vs CPU from the same weights: SDR, SIR and SAR within
    SDR_ATOL dB, the loss within phase 7's rtol.  -> its launches."""
    hp = load_config(ENCODER_TYPE="attn-v1", **dict(
        keys, BATCH_SIZE=4, EVAL_SDR=True, BSS_FILT_LEN=512))
    model = hp.get_model()(hp)
    batch = _toy_batches(hp, 1)[0]
    p0 = weights.to_jax(model.init(torch.Generator().manual_seed(0)))
    want = {name: 0 for name in KERNELS}
    want["flash_attn"] = _depth(model.encoder)
    _zero_counts()  # the main path of this check: the counts start at 0
    out = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(model, hp, dev)
        st = tr.init_state(params=p0)
        run = (lambda: tr.valid_step(st, batch)) if dev == "cpu" else \
            (lambda: _counted(lambda: tr.valid_step(st, batch), want,
                              "phase 17 EVAL_SDR valid step"))
        out[dev] = {k: float(v) for k, v in run().items()}
    launches = _counts()
    card, cpu = out["cuda"], out["cpu"]
    errs = {k: abs(card[k] - cpu[k])
            for k in ("SDR", "SIR", "SAR", "SI_SNR")}
    print("phase 17 attn-v1 float32 valid step B=4 with EVAL_SDR (BSS_FILT_LEN "
          "512): card %s, CPU %s; abs err (dB) %s (atol %g dB), loss relative "
          "err %.3g (rtol %g)" % (card, cpu, " ".join(
              "%s %.3g" % kv for kv in errs.items()), SDR_ATOL,
              _rel(card["loss"], cpu["loss"]), STEP_RTOL["float32"]))
    if not all(np.isfinite(v) for v in card.values()) \
            or not max(errs.values()) <= SDR_ATOL \
            or not _rel(card["loss"], cpu["loss"]) <= STEP_RTOL["float32"]:
        raise AssertionError("phase 17 EVAL_SDR valid step: card %s vs CPU %s"
                             % (card, cpu))
    return launches


def phase_training_tpu() -> dict:
    """Phase 17: configs/tpu.json's model half in training on attn-v1's
    flash path (kmeans, ANCHOR_AUX_LOSS, EVAL_SI_SNR, B=64), phase 11's
    protocol; the steps timed at the config's DROPOUT_KEEP_PROB 0.9 beside
    the dense attention's; then one EVAL_SDR valid batch."""
    keys = tpu_keys(17)
    with open(TPU_JSON) as f:
        keep = json.load(f)["DROPOUT_KEEP_PROB"]
    run = _train(17, "attn-v1", 5, 3, True, dict(keys, **FLASH),
                 dict(keys, **DENSE), {"DROPOUT_KEEP_PROB": keep})
    sdr = _valid_sdr(dict(keys, **FLASH))
    run["launches"] = {k: v + sdr[k] for k, v in run["launches"].items()}
    return run


def phase_serving_tpu() -> dict:
    """Phase 18: configs/tpu.json's model half serving on the flash path
    (the kmeans inference estimator), float32, as phase 14."""
    keys = dict(tpu_keys(18), **FLASH)
    return _serve(18, "attn-v1", [(1, 81856), (4, 32704)], 18, keys,
                  dict(keys, **DENSE))


# phase 19: configs/tpu.json whole, its trainer keys in force; the cuts
TPU_CUTS = {"DATASET_TYPE": "synth-speech", "WAVE_PCM_SCALE": 4.0,
            "ATTN_BACKEND": "flash", "TIME_BUCKET": 128, "SYNTH_BATCHES": 20}
TPU_CUT_WHY = ("the WSJ0 corpus is not in the repository: synth-speech in its "
               "place, at its WAVE_SCALE; the flash path as in phase 17, "
               "which takes T a multiple of 128: the uncropped valid "
               "utterances (189 frames) bucket to 256; 20 batches an epoch: "
               "two 8-step graph calls and 4 single steps")


def tpu_whole_keys() -> dict:
    """configs/tpu.json with its trainer keys and the cuts of TPU_CUTS,
    printed."""
    with open(TPU_JSON) as f:
        keys = json.load(f)
    print("phase 19 configs/tpu.json whole: %s; cut: %s (%s)"
          % (", ".join("%s=%r" % kv for kv in sorted(keys.items())),
             ", ".join("%s %r -> %r" % (k, keys.get(k), v)
                       for k, v in TPU_CUTS.items()), TPU_CUT_WHY))
    keys.update(TPU_CUTS)
    return keys


_SPEECH: dict = {}


def _speech_batches(hp, n: int, seed: int = 0) -> list:
    """n prepared wave batches of synth-speech (train subset) as the loop
    prepares them: crops of MAX_TRAIN_LEN frames, the TIME_BUCKET (made
    once per shape)."""
    from danet_tpu_torch.data.synth_speech import SyntheticSpeechData
    from danet_tpu_torch.train.trainer import prepare_batch_wave
    key = (n, seed, hp.BATCH_SIZE, hp.MAX_N_SIGNAL, hp.SMPRATE, hp.FFT_SIZE,
           hp.FFT_STRIDE, hp.MAX_TRAIN_LEN, hp.TIME_BUCKET)
    if key in _SPEECH:
        return _SPEECH[key]
    ds = SyntheticSpeechData(hp, seed=seed)
    ds.install_and_load()
    rng = np.random.RandomState(seed)
    out = []
    for (flat,) in ds.epoch_wave("train", hp.BATCH_SIZE * hp.MAX_N_SIGNAL):
        out.append(prepare_batch_wave(
            flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL, hp.FFT_SIZE,
            hp.FFT_STRIDE, max_len=hp.MAX_TRAIN_LEN, bucket=hp.TIME_BUCKET,
            rng=rng))
        if len(out) == n:
            _SPEECH[key] = out
            return out
    raise AssertionError("synth-speech gave %d batches" % len(out))


def _ingest_check(keys: dict) -> float:
    """(a): kernel A on the wire's ingest (int16, WAVE_PCM_SCALE 4) against
    the plain dsp.stft_ri of the dequantised batch, float32 atol 2e-5; the
    int16 round trip exact."""
    hp = load_config(**dict(keys, COMPUTE_DTYPE="float32"))
    tr = Trainer(hp.get_model()(hp), hp, "cuda")
    batch = _speech_batches(hp, 1)[0]
    wire = tr.wire_cast(batch)
    dev = wire.cuda()
    deq = dev.float() * tr._dequant
    host = wire.numpy().astype(np.float32) * np.float32(tr._dequant)
    back = np.round(host * np.float32(32768.0 / tr._pcm_scale))
    if not (np.array_equal(deq.cpu().numpy(), host)
            and np.array_equal(back, wire.numpy())):
        raise AssertionError("phase 19 int16 round trip not exact")
    want = {name: 0 for name in KERNELS}
    want["stft_ri"] = 1
    spec = _counted(lambda: tr.ingest(dev), want, "phase 19 ingest")
    b, n, s = deq.shape
    ref = dsp.stft_ri(deq.reshape(b * n, s), hp.FFT_SIZE, hp.FFT_STRIDE,
                      hp.FFT_WND_ARRAY).reshape(spec.shape)
    torch.cuda.synchronize()
    err = max_err(spec, ref)
    print("phase 19 (a) ingest: int16 wire [%d, %d, %d] (WAVE_PCM_SCALE %g) "
          "round trip exact; kernel A spectra %s vs the plain dsp.stft_ri "
          "of the dequantised batch: max_abs_err %.3g (atol %g)"
          % (b, n, s, tr._pcm_scale, tuple(spec.shape), err, STFT_ATOL))
    if not torch.isfinite(spec).all() or not err <= STFT_ATOL:
        raise AssertionError("phase 19 ingest: max abs err %.3g" % err)
    return err


def _state_tensors(state: dict) -> list:
    opt = state["opt"]
    return [("param " + n, p) for n, p in zip(
        ["/".join(k) for k in _paths(weights.to_jax(state["params"]))],
        weights.leaves(state["params"]))] + \
        [("mu %d" % i, t) for i, t in enumerate(opt.mu)] + \
        [("nu %d" % i, t) for i, t in enumerate(opt.nu)] + \
        [("ema %d" % i, t) for i, t in enumerate(
            weights.leaves(state.get("ema") or {}))]


def _graph_vs_eager(tag: str, keys: dict, k: int, phase: int = 19) -> dict:
    """One K-step graph call against K eager train steps on the card from
    one state (DROPOUT_KEEP_PROB 1, float32): every parameter, Adam moment
    and per-step metric bit for bit.  Also checks the launches the first
    call counted: the eager warm-up step's and the capture's, K steps'
    worth (one replay's)."""
    hp = load_config(**dict(keys, COMPUTE_DTYPE="float32",
                            DROPOUT_KEEP_PROB=1.0))
    model = hp.get_model()(hp)
    p0 = weights.to_jax(model.init(torch.Generator().manual_seed(0)))
    batches = _speech_batches(hp, k)
    tr = Trainer(model, hp, "cuda")
    sg, se = tr.init_state(params=p0), tr.init_state(params=p0)
    stack = np.stack(batches)
    _zero_counts()
    mg = tr.train_steps(sg, stack)
    first = _counts()
    _zero_counts()
    me = [tr.train_step(se, b) for b in batches]
    eager = _counts()
    captured = {n: v - eager[n] // k for n, v in first.items()}
    torch.cuda.synchronize()
    diffs = []
    for (name, a), (_, b) in zip(_state_tensors(sg), _state_tensors(se)):
        if not torch.equal(a.detach(), b.detach()):
            diffs.append((name, float((a - b).abs().max())))
    for name in mg:
        got = mg[name].cpu()
        ref = torch.stack([m[name] for m in me]).cpu()
        if not torch.equal(got, ref):
            diffs.append((name, float((got - ref).abs().max())))
    print("phase %d %s: one %d-step CUDA graph call vs %d eager train steps "
          "(float32, DROPOUT_KEEP_PROB 1): %d state tensors and %s per step, "
          "%s; losses graph %s eager %s; the capture counted %s (one "
          "replay's launches; the eager warm-up step before it %s)"
          % (phase, tag, k, k, len(_state_tensors(sg)), sorted(mg),
             "bit for bit" if not diffs else "DIFFER: %s" % diffs[:6],
             ["%.9g" % v for v in mg["loss"].tolist()],
             ["%.9g" % float(m["loss"]) for m in me],
             {n: v for n, v in captured.items() if v},
             {n: v // k for n, v in eager.items() if v}))
    if diffs or any(first[n] * k != eager[n] * (k + 1) for n in first):
        raise AssertionError("phase %d %s: graph vs eager %s, launches %s vs "
                             "%s" % (phase, tag, diffs, captured, eager))


def _replays_draw_new_masks(keys: dict, k: int) -> None:
    """At tpu.json's DROPOUT_KEEP_PROB 0.9: the dropout generator moves on
    with every replay (its Philox offset grows), so two replays draw
    different masks; printed beside, the graph's parameters against K
    eager steps from the same generator seed."""
    hp = load_config(**dict(keys, COMPUTE_DTYPE="float32"))
    model = hp.get_model()(hp)
    p0 = weights.to_jax(model.init(torch.Generator().manual_seed(0)))
    batches = _speech_batches(hp, k)
    tr = Trainer(model, hp, "cuda")
    sg = tr.init_state(torch.Generator().manual_seed(5), params=p0)
    se = tr.init_state(torch.Generator().manual_seed(5), params=p0)
    stack = np.stack(batches)
    offsets = [sg["generator"].get_offset()]
    for _ in range(2):
        tr.train_steps(sg, stack)
        offsets.append(sg["generator"].get_offset())
    for _ in range(2):
        for b in batches:
            tr.train_step(se, b)
    torch.cuda.synchronize()
    d = max(float((a - b).detach().abs().max()) for (_, a), (_, b)
            in zip(_state_tensors(sg), _state_tensors(se)))
    print("phase 19 (b) DROPOUT_KEEP_PROB %g: the dropout generator's Philox "
          "offset %s over two replays; after them, max |graph - eager| over "
          "the state %.3g (the same seed)" % (hp.DROPOUT_KEEP_PROB, offsets,
                                              d))
    if not offsets[0] < offsets[1] < offsets[2]:
        raise AssertionError("phase 19: replays do not move the dropout "
                             "generator: %s" % offsets)


def _step_launches(model) -> dict:
    """The launches of one attn-v1 train step on the flash path and the
    wave wire: each flash kernel once per block, kernel A once."""
    want = {name: 0 for name in KERNELS}
    want.update({name: _depth(model.encoder) for name in
                 ENCODER_KERNELS["attn-v1"][1]}, stft_ri=1)
    return want


def _tpu_vs_cpu(keys: dict, k: int) -> tuple:
    """(c): the same K steps (float32, DROPOUT_KEEP_PROB 1) on the card and
    on the CPU under phase 11's protocol and bounds; the card's steps are
    eager, which (b) showed equal to the graph's."""
    hp = load_config(**dict(keys, COMPUTE_DTYPE="float32",
                            DROPOUT_KEEP_PROB=1.0))
    model = hp.get_model()(hp)
    p0 = weights.to_jax(model.init(torch.Generator().manual_seed(0)))
    batches = _speech_batches(hp, k)
    gpu, cpu = Trainer(model, hp, "cuda"), Trainer(model, hp, "cpu")
    sg, sc = gpu.init_state(params=p0), cpu.init_state(params=p0)
    _record_grads(sg["opt"])
    _record_grads(sc["opt"], apply=lambda: sg["opt"].recorded)
    names = ["/".join(p) for p in _paths(p0)]
    step_want = _step_launches(model)
    worst = grad = 0.0
    for i, b in enumerate(batches):
        err, g = _step_vs_cpu(19, "attn-v1 (c)", "float32", i, gpu, cpu, sg,
                              sc, b, True, names, step_want)
        worst, grad = max(worst, err), max(grad, g)
    return worst, grad


def _loop_through_cli(keys: dict, tmp: str) -> dict:
    """(d): two epochs of Trainer.train through the CLI's path at B=64,
    bfloat16, every key of tpu.json (the cuts aside): finite epoch lines,
    the watchdog silent, metrics.jsonl with a row per step.  -> the
    launches of this main path: the wrappers count a graph's launches
    once, at its capture, so each further replay adds K steps'."""
    cut = os.path.join(tmp, "tpu-cuts.json")
    with open(cut, "w") as f:
        json.dump(dict(TPU_CUTS, SUMMARY_DIR=os.path.join(tmp, "logs")), f)
    _zero_counts()  # the main path of phase 19: the counts start at 0
    StepGraph.captures = StepGraph.replays = 0
    t0 = time.perf_counter()
    text = _port_cli(["-m", "train", "-c", TPU_JSON, "-c", cut, "-ne", "2",
                      "--no-save-on-epoch"], os.getcwd())
    seconds = time.perf_counter() - t0
    hp = load_config(**keys)
    k = int(hp.TRAIN_STEPS_PER_CALL)
    extra = (StepGraph.replays - StepGraph.captures) * k
    launches = {name: n + extra * _step_launches(hp.get_model()(hp))[name]
                for name, n in _counts().items()}
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("Epoch ", "Valid ", "done ("))]
    for ln in lines:
        print("phase 19 (d) %s" % ln)
    epochs = [ln for ln in lines if ln.startswith("Epoch ")]
    valids = [ln for ln in lines if ln.startswith("Valid ")]
    values = [float(p.split("=", 1)[1]) for ln in epochs + valids
              for p in ln.split() if "=" in p]
    (run_dir,) = os.listdir(os.path.join(tmp, "logs"))
    with open(os.path.join(tmp, "logs", run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    steps = [r["step"] for r in rows if "train/loss" in r]
    print("phase 19 (d) CLI, 2 epochs in %.1f s: %d graph(s) captured, "
          "%d replays; metrics.jsonl %d train rows (steps %d-%d), %d valid; "
          "launches (graph launches = captured x replays) %s"
          % (seconds, StepGraph.captures, StepGraph.replays,
             len(steps), min(steps), max(steps), len(rows) - len(steps),
             {k: v for k, v in launches.items() if v}))
    if len(epochs) != 2 or len(valids) != 2 or "[watchdog]" in text \
            or not all(np.isfinite(v) for v in values) \
            or steps != list(range(40)) or StepGraph.captures != 1:
        raise AssertionError("phase 19 (d): %s" % text[-2000:])
    return launches


class _NullWriter:
    def scalars(self, *a):
        pass


def _quiet_epoch(tr, st: dict, ds) -> float:
    """One epoch of the loop (no valid sweep, its stdout dropped), between
    synchronizes.  -> ms per step."""
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train(1, ds, save_on_epoch=False, valid_on_epoch=False, state=st,
                 writer=_NullWriter())
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / ds.N_BATCHES


class _FirstBatches:
    """The first ``n`` batches of each epoch of ``ds`` (its cache shared)."""

    def __init__(self, ds, n: int):
        self.ds, self.N_BATCHES, self.WAVE_SCALE = ds, n, ds.WAVE_SCALE

    def epoch(self, *args, **kw):
        return itertools.islice(self.ds.epoch(*args, **kw), self.N_BATCHES)

    def epoch_wave(self, *args, **kw):
        return itertools.islice(self.ds.epoch_wave(*args, **kw),
                                self.N_BATCHES)


def _loop_times(keys: dict) -> dict:
    """The loop's ms per step and device busy share of tpu.json's step
    (B=64, bfloat16, DROPOUT_KEEP_PROB 0.9) in three setups, on the flash
    and the dense attention, printed beside the card's name and power
    limit.  The synthetic batches of both wires are made first (set-up:
    the dataset caches them).  Per setup: a short epoch of warm-up (and
    capture: the first 8 batches, one 8-step call), one timed epoch, then
    the short epoch under torch.profiler (CUDA activity only), whose device
    time per step over the timed epoch's wall time per step is the busy
    share.  Every wall time is taken before the first profiler session,
    which slows the host's launches after it."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from danet_tpu_torch.data.synth_speech import SyntheticSpeechData
    from danet_tpu_torch.perf_probe import _device_rows
    hp = load_config(**keys)
    ds = SyntheticSpeechData(hp)
    ds.install_and_load()
    t0 = time.perf_counter()
    for epoch in (ds.epoch, ds.epoch_wave):
        for _ in epoch("train", hp.BATCH_SIZE * hp.MAX_N_SIGNAL):
            pass
    made = time.perf_counter() - t0
    short = _FirstBatches(ds, int(hp.TRAIN_STEPS_PER_CALL))
    setups = [
        ("f32 spectra wire, K=1, METRICS_EVERY=1 (as phase 17)",
         dict(TRANSFER_DOMAIN="spectra", TRANSFER_DTYPE="float32",
              TRAIN_STEPS_PER_CALL=1, METRICS_EVERY=1)),
        ("int16 wave wire, K=1, METRICS_EVERY=1",
         dict(TRAIN_STEPS_PER_CALL=1, METRICS_EVERY=1)),
        ("every key of tpu.json (int16 wave wire, K=8, METRICS_EVERY=30)",
         {})]
    card = nvidia_smi()
    runs = []
    t0 = time.perf_counter()
    for attn in ("flash", "xla"):
        for label, over in setups:
            hp = load_config(**dict(keys, ATTN_BACKEND=attn, **over))
            tr = Trainer(hp.get_model()(hp), hp, "cuda")
            st = tr.init_state(torch.Generator().manual_seed(0))
            _quiet_epoch(tr, st, short)
            runs.append((attn, label, tr, st, _quiet_epoch(tr, st, ds)))
    out = {}
    t1 = time.perf_counter()
    for attn, label, tr, st, wall in runs:
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            _quiet_epoch(tr, st, short)
        device = sum(ms for _, ms in _device_rows(prof, short.N_BATCHES))
        out[(attn, label)] = (wall, device / wall)
        print("phase 19 timing ATTN_BACKEND=%s, %s: %.3f ms per step (the "
              "loop, an epoch of %d steps), device %.3f ms per step (%d "
              "steps profiled), busy %.1f %% (%s)"
              % (attn, label, wall, ds.N_BATCHES, device, short.N_BATCHES,
                 100 * device / wall, card))
    print("phase 19 timing: making the batches %.1f s, warm-up and timed "
          "epochs %.1f s, profiled %.1f s"
          % (made, t1 - t0, time.perf_counter() - t1))
    return out


def phase_tpu_whole() -> dict:
    """Phase 19: configs/tpu.json whole (module docstring)."""
    import shutil
    import tempfile
    keys = tpu_whole_keys()
    k = int(keys["TRAIN_STEPS_PER_CALL"])
    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print("phase 19 %s took %.1f s" % (what, now - clock[0]))
        clock[0] = now

    ingest_err = _ingest_check(keys)
    _graph_vs_eager("(b) tpu.json attn-v1 flash", keys, k)
    _replays_draw_new_masks(keys, k)
    lap("(a), (b)")
    step_rel, grad_rel = _tpu_vs_cpu(keys, k)
    lap("(c)")
    tmp = tempfile.mkdtemp(prefix="danet-phase19-")
    try:
        launches = _loop_through_cli(keys, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lap("(d)")
    bilstm = dict(TRANSFER_DOMAIN="wave", TRANSFER_DTYPE="int16",
                  WAVE_PCM_SCALE=4.0, TRAIN_STEPS_PER_CALL=k,
                  ENCODER_TYPE="bilstm-orig", BATCH_SIZE=32)
    _graph_vs_eager("(e) bilstm-orig B=32", bilstm, k)
    lap("(e)")
    times = _loop_times(keys)
    lap("timing")
    return {"launches": launches, "ingest_err": ingest_err,
            "step_rel": step_rel, "grad_rel": grad_rel, "times": times}


# ---------------------------------------------------------------- phase 20
# the paper model through the trainer's whole path: bilstm-orig at full
# width, B=32, float32 with the int16 wave wire and K=8 (phase 19 (e)'s
# step), dropout at 0.9, on synth-speech at its WAVE_SCALE with 10 batches
# an epoch (one 8-step graph call and 2 single steps)
CKPT_KEYS = {"ENCODER_TYPE": "bilstm-orig", "BATCH_SIZE": 32,
             "TRANSFER_DOMAIN": "wave", "TRANSFER_DTYPE": "int16",
             "WAVE_PCM_SCALE": 4.0, "TRAIN_STEPS_PER_CALL": 8,
             "DATASET_TYPE": "synth-speech", "SYNTH_BATCHES": 10,
             "DROPOUT_KEEP_PROB": 0.9}
# (b): the step options in the K-step graph
STEP_OPTIONS = {"EMA_DECAY": 0.999, "GRAD_ACCUM": 2}
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def _port_cli(argv: list, cwd: str) -> str:
    """python -m danet_tpu_torch's main(argv) in this process, in ``cwd``,
    its stdout captured."""
    import contextlib
    import io
    from danet_tpu_torch import __main__ as port_cli
    out = io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out):
            port_cli.main(argv)
    finally:
        os.chdir(here)
    return out.getvalue()


def _bilstm_step(accum: int = 1) -> dict:
    """One bilstm-orig train step's launches on the wave wire: kernel A
    once, kernels 2 and 3 once per layer and microbatch."""
    hp = load_config(**CKPT_KEYS)
    n = _depth(hp.get_model()(hp).encoder) * accum
    return {"stft_ri": 1, "bilstm_scan_train": n, "bilstm_scan_bwd": n}


def _main_path(fn, k: int = 8, per_step=None):
    """fn() as a main path of phase 20 or 22: the counts zeroed before it
    and read after it, each graph replay beyond the captures counted as K
    steps of ``per_step`` launches (by default a bilstm-orig step's; the
    wrappers count a graph's launches once, at capture).  -> (fn's result,
    launches, graphs captured)."""
    _zero_counts()
    StepGraph.captures = StepGraph.replays = 0
    out = fn()
    extra = (StepGraph.replays - StepGraph.captures) * k
    step = _bilstm_step() if per_step is None else per_step
    return out, {n: v + extra * step.get(n, 0)
                 for n, v in _counts().items()}, StepGraph.captures


def _jsonl_losses(logs: str) -> list:
    rows = []
    for run in sorted(os.listdir(logs)):
        with open(os.path.join(logs, run, "metrics.jsonl")) as f:
            rows += [json.loads(line) for line in f]
    return [(r["step"], r["train/loss"], r["train/step_time"])
            for r in rows if "train/loss" in r]


def _same_state(tag: str, a: dict, b: dict) -> None:
    diffs = [name for (name, x), (_, y) in zip(_state_tensors(a),
                                               _state_tensors(b))
             if not torch.equal(x.detach(), y.detach())]
    ga, gb = a["generator"].get_state(), b["generator"].get_state()
    if diffs or not torch.equal(ga, gb) or a["step"] != b["step"] \
            or a["opt"].count != b["opt"].count or a["opt"].lr != b["opt"].lr:
        raise AssertionError("phase 20 %s: states differ: %s, generator %s "
                             "vs %s" % (tag, diffs[:6], ga.tolist(),
                                        gb.tolist()))


def _resume_vs_straight(tmp: str, cfg: str) -> tuple:
    """(a): through the CLI, 2 epochs straight against 1 epoch, then ``-i
    saves/<n>_e1`` and 1 more: the parameters, Adam moments, dropout
    generator (seed and Philox offset) and every step's loss bit for bit,
    graphs included.  -> (launches, the resumed run's first call's ms per
    step (its capture included) and the straight run's second one's (a
    replay), the captures of the resumed run)."""
    from danet_tpu_torch import __main__ as port_cli

    def run(tag, args):
        text = _port_cli(["-m", "train", "-c", cfg, "--set",
                          'SUMMARY_DIR="%s"' % os.path.join(tmp, tag)]
                         + args, tmp)
        for ln in text.splitlines():
            if ln.startswith(("Epoch ", "Valid ", "Loading ")):
                print("phase 20 (a) %s: %s" % (tag, ln))
        return port_cli.g_state, StepGraph.captures

    def runs():
        straight, _ = run("straight", ["-n", "straight", "-ne", "2"])
        run("first", ["-n", "resumed", "-ne", "1"])
        c0 = StepGraph.captures
        resumed, c1 = run("resumed", ["-n", "resumed", "-ne", "1", "-i",
                                      "saves/resumed_e1"])
        return straight, resumed, c1 - c0

    (straight, resumed, recaptures), launches, _ = _main_path(runs)
    _same_state("(a) 2 epochs vs 1 + -i + 1", straight, resumed)
    a = _jsonl_losses(os.path.join(tmp, "straight"))
    b = _jsonl_losses(os.path.join(tmp, "first")) + _jsonl_losses(
        os.path.join(tmp, "resumed"))
    if [r[:2] for r in a] != [r[:2] for r in b] \
            or [r[0] for r in a] != list(range(20)):
        raise AssertionError("phase 20 (a): per-step losses differ: %s vs "
                             "%s" % (a[:4], b[:4]))
    first, later = b[10][2] * 1e3, a[10][2] * 1e3
    print("phase 20 (a) 2 epochs vs 1 epoch + -i saves/resumed_e1 + 1: %d "
          "state tensors, the generator (seed, offset) and 20 per-step "
          "losses bit for bit; the loop's step_time (host, not synchronized) "
          "of the resumed process's first 8-step call %.2f ms per step (it "
          "captured %d graph), of the straight run's second (a replay) %.2f"
          % (len(_state_tensors(straight)), first, recaptures, later))
    return launches, first, later, recaptures


def _options_vs_cpu(keys: dict, n: int) -> tuple:
    """(b), after the graph: n eager steps with EMA_DECAY and GRAD_ACCUM,
    card against CPU under phase 11's protocol and bounds (float32,
    DROPOUT_KEEP_PROB 1, each step from the card's state, EMA included);
    the EMAs after each step within one float32 ulp + 1e-6 x LR."""
    hp = load_config(**dict(keys, COMPUTE_DTYPE="float32",
                            DROPOUT_KEEP_PROB=1.0))
    model = hp.get_model()(hp)
    p0 = weights.to_jax(model.init(torch.Generator().manual_seed(0)))
    batches = _speech_batches(hp, n)
    gpu, cpu = Trainer(model, hp, "cuda"), Trainer(model, hp, "cpu")
    sg, sc = gpu.init_state(params=p0), cpu.init_state(params=p0)
    _record_grads(sg["opt"])
    _record_grads(sc["opt"], apply=lambda: sg["opt"].recorded)
    names = ["/".join(p) for p in _paths(p0)]
    accum = int(hp.GRAD_ACCUM)
    want = dict({name: 0 for name in KERNELS}, **_bilstm_step(accum))
    worst = grad = ema_share = 0.0
    for i, b in enumerate(batches):
        err, g = _step_vs_cpu(20, "bilstm-orig (b)", "float32", i, gpu, cpu,
                              sg, sc, b, True, names, want)
        worst, grad = max(worst, err), max(grad, g)
        for e, c in zip(weights.leaves(sg["ema"]), weights.leaves(sc["ema"])):
            e = e.cpu()
            ulp = torch.nextafter(c.abs(), torch.tensor(float("inf"))) \
                - c.abs()
            ema_share = max(ema_share, float(
                ((e - c).abs() / (ulp + 1e-6 * sg["opt"].lr)).max()))
    print("phase 20 (b) EMA_DECAY %g, GRAD_ACCUM %d, %d eager steps card vs "
          "CPU: worst relative loss/SNR err %.3g, gradients %.3g of the "
          "peak; EMA worst element at %.3g of its bound (1 ulp + 1e-6 x LR)"
          % (hp.EMA_DECAY, accum, n, worst, grad, ema_share))
    if not ema_share <= 1.0:
        raise AssertionError("phase 20 (b): EMA card vs CPU beyond bound")
    return worst, grad


class _PoisonEpoch:
    """A wave dataset whose ``epoch``-th train epoch (1-based calls of
    epoch_wave('train')) has a first batch whose first utterance is NaN
    (all of it: the loop crops at random)."""

    def __init__(self, ds, epoch: int):
        self.ds, self.epoch, self.calls = ds, epoch, 0
        self.WAVE_SCALE = ds.WAVE_SCALE

    def epoch_wave(self, subset, *args, **kw):
        if subset == "train":
            self.calls += 1
        for i, (batch,) in enumerate(self.ds.epoch_wave(subset, *args,
                                                        **kw)):
            if subset == "train" and self.calls == self.epoch and i == 0:
                batch = batch.copy()
                batch[0] = np.nan
            yield (batch,)


def _nan_rollback(tmp: str) -> tuple:
    """(c): the float32 wave wire (int16 holds no NaN), 8 batches an epoch
    (one 8-step graph call), 2 epochs with epoch checkpoints; epoch 2's
    first attempt carries a NaN: the loop restores saves/nan_e1 into the
    state's tensors, retries on the retry-1 streams and ends finite, with
    the graph captured once (the restore copies into the tensors it
    holds)."""
    import contextlib
    import io
    from danet_tpu_torch.data.synth_speech import SyntheticSpeechData
    hp = load_config(**dict(CKPT_KEYS, TRANSFER_DTYPE="float32",
                            SYNTH_BATCHES=8))
    tr = Trainer(hp.get_model()(hp), hp, "cuda", name="nan",
                 save_dir=os.path.join(tmp, "saves"))
    ds = SyntheticSpeechData(hp)
    ds.install_and_load()
    data = _PoisonEpoch(ds, 2)
    out = io.StringIO()

    def run():
        with contextlib.redirect_stdout(out):
            return tr.train(2, data, save_on_epoch=True,
                            valid_on_epoch=False, writer=_NullWriter())

    state, launches, captures = _main_path(run)
    text = out.getvalue()
    said = [ln.strip(":S") for ln in text.splitlines() if "NaN" in ln]
    last = [ln for ln in text.splitlines()
            if ln.startswith("Epoch 2/2 ") and "NaN" not in ln]
    finite = all(bool(torch.isfinite(p).all())
                 for p in weights.leaves(state["params"]))
    print("phase 20 (c) NaN epoch: %s; then %s; %d train epochs drawn, "
          "graphs captured %d, parameters finite %s"
          % (said, last, data.calls, captures, finite))
    if said != ["Epoch 2/2 got NaN values, restoring last checkpoint ... "
                "done"] or len(last) != 1 or "nan" in last[0] \
            or data.calls != 3 or captures != 1 or not finite \
            or state["step"] != 16:
        raise AssertionError("phase 20 (c): %s" % text[-2000:])
    return launches


def _preempt_subprocess(tmp: str, cfg: str) -> tuple:
    """(d): SIGTERM to ``python -m danet_tpu_torch -m train`` after its
    first 8-step call: it writes saves/pre_preempt and exits 0; a resume
    from it finishes the interrupted epoch (in this process).  -> the
    resume's launches."""
    import signal
    import threading
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "danet_tpu_torch", "-m", "train", "-c", cfg,
         "-ne", "50", "-n", "pre", "--no-valid-on-epoch", "--set",
         'SUMMARY_DIR="%s"' % os.path.join(tmp, "pre")],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    got = []
    reader = threading.Thread(target=lambda: got.extend(
        iter(lambda: proc.stdout.read(1), "")), daemon=True)
    reader.start()
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < 240 and proc.poll() is None \
                and "".join(got).count(":") < 8:
            time.sleep(0.05)
        steps = "".join(got).count(":")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    text = "".join(got)
    path = os.path.join(tmp, "saves", "pre_preempt")
    saved = [ln for ln in text.splitlines() if "preempted: saved" in ln]
    print("phase 20 (d) SIGTERM after %d steps (%.1f s after the start): "
          "exit %d, %s" % (steps, time.perf_counter() - t0, rc, saved))
    if rc != 0 or not saved or not os.path.isfile(
            os.path.join(path, "state.npz")):
        raise AssertionError("phase 20 (d): exit %s: %s" % (rc, text[-3000:]))

    def resume():
        return _port_cli(["-m", "train", "-c", cfg, "-ne", "1", "-n",
                          "pre2", "-i", path, "--no-valid-on-epoch",
                          "--no-save-on-epoch", "--set",
                          'SUMMARY_DIR="%s"' % os.path.join(tmp, "pre2")],
                         tmp)

    text, launches, _ = _main_path(resume)
    from danet_tpu_torch import __main__ as port_cli
    lines = [ln for ln in text.splitlines() if ln.startswith("Epoch ")]
    print("phase 20 (d) resumed from %s at step %s: %s" % (
        path, port_cli.g_state["step"] - 10, lines))
    if len(lines) != 1 or "nan" in lines[0]:
        raise AssertionError("phase 20 (d) resume: %s" % text[-2000:])
    return launches


def _test_and_demo(tmp: str, cfg: str) -> dict:
    """(e): -m test and -m demo from (a)'s checkpoint on the card (kernel
    A and kernel B in the test sweep, kernel B in the demo); the demo's
    separated spectra against the CPU's from the same checkpoint within
    1e-4 of their peak."""
    ckpt = os.path.join(tmp, "saves", "straight_e2")
    seen = []
    real = Trainer.separate

    def recording(self, state, mix_ri):
        out = real(self, state, mix_ri)
        seen.append((mix_ri, out))
        return out

    def run():
        text = _port_cli(["-m", "test", "-c", cfg, "-i", ckpt], tmp)
        Trainer.separate = recording
        try:
            text += _port_cli(["-m", "demo", "-c", cfg, "-i", ckpt], tmp)
        finally:
            Trainer.separate = real
        return text

    text, launches, _ = _main_path(run)
    test = [ln for ln in text.splitlines() if ln.startswith("Test: ")]
    wavs = sorted(f for f in os.listdir(tmp) if "_separated_" in f)
    hp = load_config(**CKPT_KEYS)
    cpu = Trainer(hp.get_model()(hp), hp, "cpu")
    st = cpu.load_params(cpu.init_state(), ckpt)
    (mix, out), = seen
    ref = cpu.separate(st, mix)
    err = float(np.abs(out - ref).max())
    peak = float(np.abs(ref).max())
    print("phase 20 (e) -m test: %s; -m demo: %s, separated spectra %s vs "
          "the CPU's from the same checkpoint: max abs err %.3g, %.3g of the "
          "peak (bound 1e-4); launches %s"
          % (test, wavs, out.shape, err, err / peak,
             {k: v for k, v in launches.items() if v}))
    vals = [float(p.split("=")[1]) for ln in test for p in ln.split()[1:]]
    if len(test) != 1 or not all(np.isfinite(vals)) or wavs != [
            "demo_separated_1.wav", "demo_separated_2.wav"] \
            or not err <= 1e-4 * peak or not launches["bilstm_scan"]:
        raise AssertionError("phase 20 (e): %s" % text[-2000:])
    return launches


def _checkpoint_times(tmp: str) -> dict:
    """Save and load of the full-width bilstm-orig train state with its
    EMA (params, two Adam moments, EMA: 4 x 9.07 M float32), on the card,
    each the median of 3 (synchronized; the load copies into the state's
    tensors).  Then the first 8-step call after a resume, between
    synchronizes: into a new Trainer (as a new process: it captures its
    graph) and, after a second load into the same state, in place (as a
    rollback: the graph replays), beside a plain replay."""
    hp = load_config(**dict(CKPT_KEYS, **STEP_OPTIONS))
    tr = Trainer(hp.get_model()(hp), hp, "cuda",
                 save_dir=os.path.join(tmp, "saves"))
    st = tr.init_state()
    n = sum(t.numel() for _, t in _state_tensors(st))
    path = os.path.join(tmp, "saves", "timed")
    saves, loads = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.save_params(st, path)
        t1 = time.perf_counter()
        tr.load_params(st, path)
        torch.cuda.synchronize()
        saves.append(t1 - t0)
        loads.append(time.perf_counter() - t1)
    size = os.path.getsize(os.path.join(path, "state.npz"))
    out = {"save": float(np.median(saves)) * 1e3,
           "load": float(np.median(loads)) * 1e3}
    stack = tr._put(tr._host_batch(np.stack(_speech_batches(hp, 8))))

    def call_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_steps(st, stack)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / 8

    captures = StepGraph.captures
    out["first"] = call_ms()
    out["replay"] = call_ms()
    tr.load_params(st, path)
    out["after_load"] = call_ms()
    captured = StepGraph.captures - captures
    print("phase 20 timing checkpoint: %d float32 values (%.1f MB on disk): "
          "save %.1f ms, load %.1f ms (median of 3); the first 8-step call "
          "after a resume into a new Trainer %.2f ms per step (warm-up and "
          "capture), a replay %.2f, the first call after a load in place "
          "%.2f (graphs captured in all: %d; EMA_DECAY 0.999, GRAD_ACCUM 2; "
          "%s)" % (n, size / 1e6, out["save"], out["load"], out["first"],
                   out["replay"], out["after_load"], captured, nvidia_smi()))
    if captured != 1:
        raise AssertionError("phase 20: a load in place recaptured")
    return out


def _option_costs() -> dict:
    """ms per step of the K=8 graph call with each step option, and of
    eager steps with and without NAN_CHECKS (which runs single steps),
    on one stack of 8 synth-speech batches, each after a warm-up."""
    hp0 = load_config(**CKPT_KEYS)
    stack = np.stack(_speech_batches(hp0, 8))
    out = {}
    for label, over in (("K=8 graph", {}),
                        ("K=8 graph, EMA_DECAY 0.999", {"EMA_DECAY": 0.999}),
                        ("K=8 graph, GRAD_ACCUM 2", {"GRAD_ACCUM": 2}),
                        ("K=8 graph, both", STEP_OPTIONS),
                        ("eager", {"TRAIN_STEPS_PER_CALL": 1}),
                        ("eager, NAN_CHECKS", {"NAN_CHECKS": True})):
        hp = load_config(**dict(CKPT_KEYS, **over))
        tr = Trainer(hp.get_model()(hp), hp, "cuda")
        st = tr.init_state()
        dev = tr._put(tr._host_batch(stack))
        if tr._steps_per_call > 1:
            tr.train_steps(st, dev)
            reps, run = 5, lambda: tr.train_steps(st, dev)
        else:
            tr.train_step(st, dev[0])
            reps = 1

            def run():
                for i in range(8):
                    tr.train_step(st, dev[i])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        out[label] = (time.perf_counter() - t0) * 1e3 / (8 * reps)
        del st, tr
    print("phase 20 timing step options (bilstm-orig, B=32, float32, int16 "
          "wave wire; %s): %s ms per step"
          % (nvidia_smi(), ", ".join("%s %.3f" % kv for kv in out.items())))
    return out


def phase_checkpoints() -> dict:
    """Phase 20: checkpoints, rollbacks, the preemption save, the step
    options and the CLI's modes on the paper model (module docstring)."""
    import shutil
    import tempfile
    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print("phase 20 %s took %.1f s" % (what, now - clock[0]))
        clock[0] = now

    print("phase 20 keys: %s" % ", ".join(
        "%s=%r" % kv for kv in sorted(CKPT_KEYS.items())))
    tmp = tempfile.mkdtemp(prefix="danet-phase20-")
    try:
        cfg = os.path.join(tmp, "phase20.json")
        with open(cfg, "w") as f:
            json.dump(CKPT_KEYS, f)
        paths = []
        a_launches, first_ms, later_ms, recaptures = _resume_vs_straight(
            tmp, cfg)
        paths.append(a_launches)
        lap("(a)")
        opts = dict(CKPT_KEYS, **STEP_OPTIONS)
        _graph_vs_eager("(b) bilstm-orig EMA_DECAY 0.999 GRAD_ACCUM 2", opts,
                        int(opts["TRAIN_STEPS_PER_CALL"]), phase=20)
        step_rel, grad_rel = _options_vs_cpu(opts, 2)
        lap("(b)")
        paths.append(_nan_rollback(tmp))
        lap("(c)")
        paths.append(_preempt_subprocess(tmp, cfg))
        lap("(d)")
        paths.append(_test_and_demo(tmp, cfg))
        lap("(e)")
        times = _checkpoint_times(tmp)
        costs = _option_costs()
        lap("timing")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {n: sum(p[n] for p in paths) for n in KERNELS}
    print("phase 20 launches over (a), (c), (d)'s resume and (e): %s"
          % {k: v for k, v in launches.items() if v})
    for name in ("stft_ri", "bilstm_scan", "bilstm_scan_train",
                 "bilstm_scan_bwd"):
        if not launches[name]:
            raise AssertionError("phase 20: %s not launched" % name)
    return {"launches": launches, "step_rel": step_rel, "grad_rel": grad_rel,
            "times": times, "first_ms": first_ms, "later_ms": later_ms,
            "recaptures": recaptures, "costs": costs}


# ---------------------------------------------------------------- phase 21
# the single-device encoders tcn-v1, dprnn-v1 and conv-bilstm-v1: the config
# files as written (conv-bilstm-v1: default.json's widths)
V2_CONFIGS = {"tcn-v1": "tcn.json", "dprnn-v1": "dprnn.json",
              "conv-bilstm-v1": None}
# (b): ~10 s at B=1 and a batch of 4 x 4 s; conv-bilstm-v1 at frame counts
# that are multiples of 4 (1248 and 504)
V2_REQUESTS = {"tcn-v1": [(1, 10 * SMPRATE), (4, 4 * SMPRATE)],
               "dprnn-v1": [(1, 10 * SMPRATE), (4, 4 * SMPRATE)],
               "conv-bilstm-v1": [(1, 79808), (4, 32192)]}
# (a): the LSTM kernels at the new encoders' shapes: (what, T, B, H, input
# width, directions, gate bias, Wx and Wh init scale)
DPRNN_LAYER = (128, 128, (0.0, 0.0, 1.0, 0.0), 1.0 / np.sqrt(128))
CONV_LAYER = (256, 512, (0.0, 1.0, -1.0, 1.0), 2.0 / np.sqrt(256))
NEW_SHAPES = (
    ("dprnn-v1 inter", 3, 2048) + DPRNN_LAYER[:2] + (2,) + DPRNN_LAYER[2:],
    ("dprnn-v1 inter", 3, 4096) + DPRNN_LAYER[:2] + (2,) + DPRNN_LAYER[2:],
    ("dprnn-v1 intra", 64, 96) + DPRNN_LAYER[:2] + (2,) + DPRNN_LAYER[2:],
    ("dprnn-v1 inter causal", 3, 2048) + DPRNN_LAYER[:2] + (1,)
    + DPRNN_LAYER[2:],
    ("dprnn-v1 inter causal", 3, 4096) + DPRNN_LAYER[:2] + (1,)
    + DPRNN_LAYER[2:],
    ("conv-bilstm-v1", 32, 32) + CONV_LAYER[:2] + (2,) + CONV_LAYER[2:],
    ("conv-bilstm-v1 10 s", 312, 1) + CONV_LAYER[:2] + (2,) + CONV_LAYER[2:],
)
# (c): conv-bilstm-v1 through one 8-step CUDA graph on the wave wire
CONV_GRAPH = dict(TRANSFER_DOMAIN="wave", TRANSFER_DTYPE="int16",
                  WAVE_PCM_SCALE=4.0, TRAIN_STEPS_PER_CALL=8,
                  ENCODER_TYPE="conv-bilstm-v1", BATCH_SIZE=32)
# (b), (c): the card against the CPU from a well-conditioned state.  The
# LSTM head's init (scaled for LSTM outputs, which its centering makes
# small) turns tcn-v1's and dprnn-v1's residual streams into embeddings of
# peak 140-250, over which kmeans' and the anchors' soft assignments are so
# sharp that one float32 rounding moves the CPU's own waves and gradients
# by up to 1e-1 of their peak; the comparisons start these two with the
# head's weight scaled by HEAD_SCALE (embeddings of peak about 3-5).  A
# leaky ReLU's gradient jumps where a rounding moves an element across 0:
# the training comparisons run at COMPARE_LEAKAGE (the identity; tcn-v1
# and conv-bilstm-v1 have leaky ReLUs).  At B=4 on the CPU the gradients
# then move by at most 7e-6 of their peak under a 1e-7 relative change of
# the input, against 1e-1 (tcn-v1) and 5e-3 (dprnn-v1) as the configs'
# inits stand, and 8e-4 (conv-bilstm-v1 at step 2) with its leaky ReLUs.
# Serving keeps the configs' leakage (a forward is continuous across the
# kink), and the timed steps keep every key and init as written.
HEAD_SCALE = {"tcn-v1": 0.02, "dprnn-v1": 0.02}
COMPARE_LEAKAGE = 1.0
# (a): the convolutions against float64; float32 sums land about 1e-6 of
# the peak from it, TF32's 10-bit mantissa about 1e-4 to 5e-4
CONV_RTOL = 2e-5
# (d): REMAT on bilstm-orig at full width
REMAT_KEEP = 0.9


def _layer_inputs(rs, t, b, h, i_dim, n_dirs, bias, scale, dtype):
    """Layer-shaped inputs of one (Bi)LSTM layer: xp = x @ Wx + gate bias
    with x ~ N(0, 0.25), Wx and Wh ~ U(-scale, scale), zero c0 and h0 (each
    layer of these encoders starts from zeros), and a cotangent d_hs;
    without the direction axis for one direction."""
    x = rs.randn(n_dirs, t * b, i_dim).astype(np.float32) * 0.5
    wx = rs.uniform(-scale, scale, (n_dirs, i_dim, 4 * h)).astype(np.float32)
    xp = (np.matmul(x, wx) + np.repeat(np.asarray(bias, np.float32), h))
    xp = xp.reshape(n_dirs, t, b, 4 * h).transpose(1, 0, 2, 3)
    wh = rs.uniform(-scale, scale, (n_dirs, h, 4 * h))
    z = np.zeros((n_dirs, b, h))
    d_hs = rs.randn(t, n_dirs, b, h)
    out = (xp, wh, z, z, d_hs)
    if n_dirs == 1:
        out = (xp[:, 0], wh[0], z[0], z[0], d_hs[:, 0])
    return _cuda(out, dtype)


def _nn_lstm_ms(rs, t: int, b: int, h: int, i_dim: int, n_dirs: int):
    """torch.nn.LSTM (cuDNN, tanh candidate) at this shape, float32, ms:
    the inference forward, the training forward and the backward to the
    input (each also computes the input projection)."""
    lstm = torch.nn.LSTM(i_dim, h, bidirectional=n_dirs == 2).cuda()
    x = torch.from_numpy(rs.randn(t, b, i_dim).astype(np.float32)).cuda()
    with torch.no_grad():
        lean = cuda_ms(lambda: lstm(x), 10)
    xt = x.clone().requires_grad_(True)
    fwd = cuda_ms(lambda: lstm(xt), 10)
    y, _ = lstm(xt)
    g = torch.randn_like(y)
    bwd = cuda_ms(lambda: torch.autograd.grad(y, xt, g, retain_graph=True),
                  10)
    return lean, fwd, bwd


def _new_shape_kernels() -> dict:
    """Phase 21 (a): the lean, saving and backward LSTM kernels at the new
    encoders' shapes against their plain versions, phase 4's and 6's
    tolerances, both dtypes; float32 timed beside the plain versions,
    nn.LSTM and each call's bound."""
    rs = np.random.RandomState(21)
    worst, times = {}, {}
    for what, t, b, h, i_dim, nd, bias, scale in NEW_SHAPES:
        pre = "bi" if nd == 2 else ""
        names = [pre + n for n in ("lstm_scan", "lstm_scan_train",
                                   "lstm_scan_bwd")]
        kern = [getattr(cuda_lstm, n) for n in names]
        plain = [getattr(cuda_lstm, n + "_plain") for n in names]
        for dt in (torch.float32, torch.bfloat16):
            xp, wh, c0, h0, d_hs = _layer_inputs(rs, t, b, h, i_dim, nd,
                                                 bias, scale, dt)
            args = (xp, wh, c0, h0, True)
            before = _counts()
            lean, fwd = kern[0](*args), kern[1](*args)
            lean_ref, fwd_ref = plain[0](*args), plain[1](*args)
            _, cs, acts = fwd_ref
            c_prev = torch.cat([c0[None], cs[:-1]])
            bargs = (d_hs, acts, cs, c_prev, wh, True)
            bwd, bwd_ref = kern[2](*bargs), plain[2](*bargs)
            torch.cuda.synchronize()
            calls = {n: v - before[n] for n, v in _counts().items()
                     if v - before[n]}
            tag = "%s %s H=%d" % (what, _tag(dt, True, t, b), h)
            parts = _check_kernels(21, tag, dt, (
                (names[0], ("hs",), (lean,), (lean_ref,),
                 (LSTM_ATOL[dt], 0.0)),
                (names[1], ("hs", "cs", "acts"), fwd, fwd_ref,
                 TRAIN_FWD_TOL[dt]),
                (names[2], ("dxp", "dc0", "dh0"), bwd, bwd_ref,
                 TRAIN_BWD_TOL[dt])), worst)
            line = "phase 21 (a) %s max_abs_err: %s; launches %s" % (
                tag, ", ".join(parts), calls)
            if dt == torch.float32:
                lib = _nn_lstm_ms(rs, t, b, h, i_dim, nd)
                for name, k, p, a, lib_ms in zip(
                        names, kern, plain, (args, args, bargs), lib):
                    ms, plain_ms = cuda_ms(lambda: k(*a), 10), \
                        cuda_ms(lambda: p(*a), 2)
                    bound_ms, by = _bound(*_cost(name, t, b, h))
                    times[(what, t, b, name)] = (ms, plain_ms, lib_ms,
                                                 bound_ms)
                    line += ("; %s %.4f ms (%.3f us/step), plain %.4f ms, "
                             "nn.LSTM %.4f ms, bound %.4f ms (%s)"
                             % (name, ms, 1e3 * ms / t, plain_ms, lib_ms,
                                bound_ms, by))
            print(line)
    print("phase 21 (a) nn.LSTM(%s): torch.nn.LSTM (cuDNN), float32, the "
          "inference forward beside the lean kernel, the training forward "
          "beside the saving one, the backward to the input beside kernel "
          "3; each also computes the input projection" % ", ".join(
              sorted({"%d, %d" % (s[4], s[3]) for s in NEW_SHAPES})))
    return {"max_abs_err": worst, "times": times}


def _v2_keys(encoder: str) -> dict:
    """The model keys of the encoder's config file as written (conv-bilstm-
    v1: none, default.json's), without ENCODER_TYPE and COMPUTE_DTYPE,
    which each part sets."""
    name = V2_CONFIGS[encoder]
    if name is None:
        return {}
    with open(os.path.join(REPO_ROOT, "configs", name)) as f:
        keys = json.load(f)
    if keys.pop("ENCODER_TYPE") != encoder:
        raise AssertionError("configs/%s names another encoder" % name)
    keys.pop("COMPUTE_DTYPE")
    return keys


def _remat_states(tag: str, keys: dict, run) -> None:
    """REMAT against no REMAT from one state and one dropout seed:
    ``run(trainer, state)`` on both, then every parameter, Adam moment and
    metric bit for bit."""
    out = []
    p0 = None
    for remat in (False, True):
        hp = load_config(**dict(keys, REMAT=remat))
        model = hp.get_model()(hp)
        if p0 is None:
            p0 = weights.to_jax(model.init(torch.Generator().manual_seed(0)))
        tr = Trainer(model, hp, "cuda")
        st = tr.init_state(torch.Generator().manual_seed(5), params=p0)
        metrics = run(tr, st)
        torch.cuda.synchronize()
        out.append((metrics, _state_tensors(st),
                    st["generator"].get_state()))
    (m0, s0, g0), (m1, s1, g1) = out
    diffs = [name for (name, a), (_, b) in zip(s0, s1)
             if not torch.equal(a.detach(), b.detach())]
    diffs += [k for k in m0 if not torch.equal(m0[k], m1[k])]
    print("phase 21 (d) %s: REMAT vs no REMAT at DROPOUT_KEEP_PROB %g: %d "
          "state tensors and %s %s; losses %s; the dropout generators' "
          "states %s" % (tag, keys["DROPOUT_KEEP_PROB"], len(s0),
                         sorted(m0), "bit for bit" if not diffs
                         else "DIFFER: %s" % diffs[:6],
                         m1["loss"].flatten().tolist(),
                         "equal" if torch.equal(g0, g1) else "DIFFER"))
    if diffs or not torch.equal(g0, g1):
        raise AssertionError("phase 21 (d) %s: REMAT differs: %s" % (tag,
                                                                     diffs))


def _remat_cost(t: int, b: int) -> dict:
    """Peak device memory of a bilstm-orig train step (float32, random
    spectra [B, 2, T, 129]) and its median time over 5 steps, with REMAT
    and without."""
    rs = np.random.RandomState(t)
    z = rs.randn(b, 2, t, 129) + 1j * rs.randn(b, 2, t, 129)
    batch = np.stack([z.real, z.imag], -1).astype(np.float32)
    out = {}
    for remat in (False, True):
        hp = load_config(ENCODER_TYPE="bilstm-orig", BATCH_SIZE=b,
                         DROPOUT_KEEP_PROB=REMAT_KEEP, REMAT=remat)
        tr = Trainer(hp.get_model()(hp), hp, "cuda")
        st = tr.init_state(torch.Generator().manual_seed(0))
        tr.train_step(st, batch)               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        tr.train_step(st, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            tr.train_step(st, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[remat] = (peak / 2 ** 20, (peak - held) / 2 ** 20,
                      float(np.median(ms)))
        del tr, st
        torch.cuda.empty_cache()
    print("phase 21 (d) bilstm-orig float32 B=%d T=%d: peak device memory "
          "of a step %.1f MiB (%.1f above the state) without REMAT, %.1f MiB "
          "(%.1f) with; step %.3f ms without, %.3f ms with (medians of 5)"
          % (b, t, out[False][0], out[False][1], out[True][0], out[True][1],
             out[False][2], out[True][2]))
    return out


def _remat_phase() -> dict:
    """Phase 21 (d): REMAT on bilstm-orig at full width, B=32, T=128,
    float32, DROPOUT_KEEP_PROB 0.9: one eager step and one 8-step graph
    call against no REMAT bit for bit (the REMAT step launching kernel 2
    twice per layer and kernel 3 once); then the memory and time at B=8,
    T=128 and T=512."""
    keys = dict(ENCODER_TYPE="bilstm-orig", DROPOUT_KEEP_PROB=REMAT_KEEP,
                COMPUTE_DTYPE="float32")
    hp = load_config(**keys)
    batches = _toy_batches(hp, 8)

    def step(tr, n=1):
        """n steps' launches; REMAT runs each saving forward twice."""
        want = _scan_launches(tr.model, hp.BATCH_SIZE, TRAIN_T, True)
        if tr.hp.REMAT:
            want["bilstm_scan_train"] *= 2
        return {k: v * n for k, v in want.items()}

    def eager(tr, st):
        return _counted(lambda: tr.train_step(st, batches[0]), step(tr),
                        "phase 21 (d) a step, REMAT %s" % tr.hp.REMAT)
    _remat_states("eager step", keys, eager)

    def graph(tr, st):
        # the first call: the eager warm-up step, then the 8 captured steps
        return _counted(lambda: tr.train_steps(st, np.stack(batches)),
                        step(tr, 9), "phase 21 (d) 8-step graph call, "
                        "REMAT %s" % tr.hp.REMAT)
    _remat_states("one 8-step CUDA graph call", keys, graph)
    return {t: _remat_cost(t, 8) for t in (TRAIN_T, 512)}


def _conv_ops_vs_float64() -> float:
    """Phase 21 (a): the port's convolutions at conv-bilstm-v1's and
    tcn-v1's shapes on the card, forward and the backward to input and
    weights, against torch.nn.functional's in float64 on the CPU to
    CONV_RTOL of each output's peak, run with cuDNN's TF32 at PyTorch's
    default (allowed): the ops turn it off themselves.  -> the worst error
    as a share of its peak."""
    functional = torch.nn.functional
    rs = np.random.RandomState(2101)

    def depthwise_ref(p, x):          # dilation 8, split padding 8 | 8
        y = functional.conv1d(functional.pad(x.transpose(1, 2), (8, 8)),
                              p["w"], dilation=8, groups=p["w"].shape[0])
        return (y + p["b"][None, :, None]).transpose(1, 2)

    cases = (("conv2d 16 -> 32, 5 x 5, [8, 16, 32, 32]", nn_ops.conv2d_apply,
              lambda p, x: functional.conv2d(x, p["w"], padding=2)
              + p["b"][None, :, None, None],
              {"w": rs.randn(32, 16, 5, 5) * 0.05, "b": rs.randn(32)},
              rs.randn(8, 16, 32, 32)),
             ("depthwise conv1d 512, K 3, dilation 8, [8, 128, 512]",
              lambda p, x: nn_ops.conv1d_depthwise_apply(p, x, dilation=8),
              depthwise_ref,
              {"w": rs.randn(512, 1, 3) * 0.5, "b": rs.randn(512)},
              rs.randn(8, 128, 512)))
    worst = 0.0
    for what, op, ref_op, params, x in cases:
        outs = []
        for fn, dev, dt in ((op, "cuda", torch.float32),
                            (ref_op, "cpu", torch.float64)):
            p = {k: torch.tensor(v, dtype=dt, device=dev, requires_grad=True)
                 for k, v in params.items()}
            xt = torch.tensor(x, dtype=dt, device=dev, requires_grad=True)
            y = fn(p, xt)
            y.backward(torch.from_numpy(np.random.RandomState(1).randn(
                *y.shape)).to(dev, dt))
            outs.append([v.detach().double().cpu()
                         for v in (y, xt.grad, p["w"].grad)])
        errs = []
        for name, got, ref in zip(("y", "dx", "dw"), *outs):
            rel = float((got - ref).abs().max() / ref.abs().max())
            errs.append("%s %.3g" % (name, rel))
            if not rel <= CONV_RTOL:
                raise AssertionError("phase 21 (a) %s %s: %.3g of the peak "
                                     "from float64 > %g (TF32?)"
                                     % (what, name, rel, CONV_RTOL))
            worst = max(worst, rel)
        print("phase 21 (a) %s, cudnn.allow_tf32=%s: float32 on the card "
              "vs float64, max abs err as a share of the peak: %s (bound %g)"
              % (what, torch.backends.cudnn.allow_tf32, ", ".join(errs),
                 CONV_RTOL))
    return worst


def phase_new_encoders() -> dict:
    """Phase 21: tcn-v1, dprnn-v1 and conv-bilstm-v1 (module docstring)."""
    t0 = time.perf_counter()
    kernels = _new_shape_kernels()
    # the rest of the phase runs with cuDNN at PyTorch's defaults (TF32
    # allowed, nondeterministic algorithms allowed): the port's convolutions
    # set what they need themselves
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = _new_encoders(t0)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    out["kernels"] = kernels
    return out


def _new_encoders(t0: float) -> dict:
    """Phase 21 (a)'s convolutions, (b), (c) and (d)."""
    if torch.backends.cudnn.deterministic or torch.backends.cudnn.benchmark:
        raise AssertionError("cuDNN flags off PyTorch's defaults")
    conv_rel = _conv_ops_vs_float64()
    serving, training = {}, {}
    for encoder, seed in (("tcn-v1", 21), ("dprnn-v1", 22),
                          ("conv-bilstm-v1", 23)):
        keys = _v2_keys(encoder)
        print("phase 21 %s: %s, keys %s" % (
            encoder, "configs/%s as written" % V2_CONFIGS[encoder]
            if V2_CONFIGS[encoder] else "default.json's widths", keys))
        serving[encoder] = _serve(
            21, encoder, V2_REQUESTS[encoder], seed,
            dict(keys, COMPUTE_DTYPE="float32"),
            dict(keys, COMPUTE_DTYPE="bfloat16"))
        hp = load_config(ENCODER_TYPE=encoder, **keys)
        train_keys = dict(keys, DROPOUT_KEEP_PROB=1.0,
                          RELU_LEAKAGE=COMPARE_LEAKAGE, LSTM_BACKEND="auto")
        training[encoder] = _train(
            21, encoder, 5, 0 if encoder == "tcn-v1" else 2, True,
            train_keys, dict(train_keys, LSTM_BACKEND="xla"),
            {"DROPOUT_KEEP_PROB": hp.DROPOUT_KEEP_PROB,
             "RELU_LEAKAGE": hp.RELU_LEAKAGE})
    print("phase 21 (b), (c) took %.1f s" % (time.perf_counter() - t0))
    _graph_vs_eager("(c) conv-bilstm-v1 B=32", CONV_GRAPH, 8, phase=21)
    remat = _remat_phase()
    launches = {name: sum(run["launches"][name] for run in
                          list(serving.values()) + list(training.values()))
                for name in KERNELS}
    print("phase 21 took %.1f s on %s; main-path launches %s"
          % (time.perf_counter() - t0, nvidia_smi(),
             {k: v for k, v in launches.items() if v}))
    return {"conv_rel": conv_rel, "serving": serving, "training": training,
            "remat": remat, "launches": launches}


# ---------------------------------------------------------------- phase 22
# tasnet-v1 at default.json's TASNET_* widths (512 filters of 16 samples at
# hop 8, bottleneck 128, hidden 512, kernel 3, 8 x 3 blocks, sigmoid masks)
TASNET = {"MODEL_TYPE": "tasnet-v1"}
# (a): ~10 s at B=1 and a batch of 4 x 4 s; TASNET_CAUSAL on the first
TASNET_REQUESTS = [(1, 10 * SMPRATE), (4, 4 * SMPRATE)]
# (b): the card against the CPU at this batch (a CPU step at B=32 takes tens
# of seconds); phase 11's protocol at RELU_LEAKAGE COMPARE_LEAKAGE, where a
# float32 rounding moves the CPU's own gradients by 7e-6 of their peak
# under a 1e-7 input change, against 2e-2 at the config's 0.3 (a rounding
# that moves an element across a leaky ReLU's kink); the config's 0.3 is
# held in float64 on both sides (see _tasnet_float64)
TASNET_CMP_B = 4
# (b): the 8-step CUDA graph on the int16 wave wire (kernel A in the step)
TASNET_GRAPH = dict(TASNET, TRANSFER_DOMAIN="wave", TRANSFER_DTYPE="int16",
                    WAVE_PCM_SCALE=4.0, TRAIN_STEPS_PER_CALL=8,
                    BATCH_SIZE=32)
# (c): the wav-dir corpus: int16 WAVs of synth-speech at SMPRATE, one
# length, so that every batch has one shape (one capture, then replays)
WAVDIR_FILES, WAVDIR_SAMPLES = 200, 2 * SMPRATE
# (d): the TIMIT pickles: utterances per split and their frame counts
TIMIT_UTTS = {"train": 64, "test": 16}
TIMIT_FRAMES = (70, 140)


def _tasnet_describe(model) -> str:
    d = model._dims()
    return ("tasnet-v1: %d basis filters of %d samples at hop %d, bottleneck "
            "%d, hidden %d, kernel %d, %d x %d blocks, RELU_LEAKAGE %g, "
            "TASNET_MASK %s%s, N=%d, %s" % (
                d["n_basis"], d["win"], d["stride"], d["bottleneck"],
                d["hidden"], d["kernel"], d["repeats"], d["x_blocks"],
                model.hp.RELU_LEAKAGE, d["mask"],
                ", TASNET_CAUSAL" if d["causal"] else "",
                model.hp.MAX_N_SIGNAL, model.hp.COMPUTE_DTYPE))


def _tasnet_serving() -> dict:
    """(a): serve.Separator on the card, float32, against the CPU at
    SERVE_RTOL of the peak, each request's latency in float32 and
    bfloat16; TASNET_CAUSAL on the 10 s request.  Serving runs no kernel
    of the port (no STFT: waveform in, waveform out)."""
    rs = np.random.RandomState(22)
    waves = [_mixture(rs, b, n) for b, n in TASNET_REQUESTS]
    params = None
    worst, latencies = 0.0, {}
    _zero_counts()
    for causal in (False, True):
        keys = dict(TASNET, TASNET_CAUSAL=causal)
        seps = {}
        for dt in ("float32", "bfloat16"):
            hp = load_config(**dict(keys, COMPUTE_DTYPE=dt))
            model = hp.get_model()(hp)
            if params is None:
                params = model.init(torch.Generator().manual_seed(0))
                print("phase 22 (a) model: %s, %d parameters"
                      % (_tasnet_describe(model),
                         model.parameter_count(params)))
            seps[dt] = Separator(model, params, "cuda")
        cpu = Separator(seps["float32"].model, params, "cpu")
        reqs = TASNET_REQUESTS[:1] if causal else TASNET_REQUESTS
        for (b, n), wav in zip(reqs, waves):
            outs, ms = {}, {}
            for dt, sep in seps.items():
                sep.separate(wav)                    # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[dt] = sep.separate(wav)         # numpy: synchronized
                ms[dt] = (time.perf_counter() - t0) * 1e3
            ref = cpu.separate(wav)
            peak = float(np.max(np.abs(ref)))
            err = float(np.max(np.abs(outs["float32"] - ref)))
            err16 = float(np.max(np.abs(outs["bfloat16"] - ref)))
            line = ("phase 22 (a) tasnet-v1%s request B=%d %.2f s: out %s, "
                    "latency float32 %.3f ms, bfloat16 %.3f ms; float32 vs "
                    "CPU max_abs_err %.3g (peak %.3g, rtol %g of the peak); "
                    "bfloat16 vs the CPU's float32 %.3g of the peak"
                    % (" TASNET_CAUSAL" if causal else "", b, n / SMPRATE,
                       outs["float32"].shape, ms["float32"], ms["bfloat16"],
                       err, peak, SERVE_RTOL, err16 / peak))
            print(line)
            if outs["float32"].shape != (b, 2, n) or not all(
                    np.all(np.isfinite(o)) for o in outs.values()) \
                    or not err <= SERVE_RTOL * peak:
                raise AssertionError(line)
            worst = max(worst, err / peak)
            latencies[(causal, b, n)] = ms
    launches = _counts()
    if any(launches.values()):
        raise AssertionError("phase 22 (a) serving launched %s" % launches)
    return {"max_rel_err": worst, "latency_ms": latencies,
            "launches": launches}


def _tasnet_float64() -> dict:
    """(b): at the config's keys (RELU_LEAKAGE 0.3), one train step's loss
    and gradients from one state on a toy batch of TASNET_CMP_B: the card
    in float64 against the CPU in float64 (the port's plain path with
    COMPUTE_DTYPE and FLOATX float64), the loss to STEP_RTOL's 1e-4 and
    each gradient to 1e-4 of its peak (phase 11's bounds); then the card's
    and the CPU's float32 against the same float64 step, printed (the loss
    held to 1e-4; the gradients are not held to a bound: a leaky ReLU's
    kink turns one rounding into a jump, in the CPU's own float32 too)."""
    batch = _toy_batches(load_config(BATCH_SIZE=TASNET_CMP_B), 1)[0]
    p0 = None
    res = {}
    for dev, dt in (("cpu", "float64"), ("cuda", "float64"),
                    ("cuda", "float32"), ("cpu", "float32")):
        hp = load_config(**dict(TASNET, BATCH_SIZE=TASNET_CMP_B,
                                COMPUTE_DTYPE=dt, FLOATX=dt))
        model = hp.get_model()(hp)
        if p0 is None:
            p0 = weights.to_jax(model.init(torch.Generator().manual_seed(0)))
        tdt = getattr(torch, dt)
        params = weights.from_jax(p0, dev)
        leaves = weights.leaves(params)
        for p in leaves:
            p.data = p.data.to(tdt)
            p.requires_grad_(True)
        loss, _ = model.train_loss(params, torch.from_numpy(batch).to(
            dev, tdt))
        grads = torch.autograd.grad(loss, leaves)
        res[(dev, dt)] = (float(loss.detach()), [g.detach().double().cpu()
                                        for g in grads])
    names = ["/".join(k) for k in _paths(p0)]
    ref_loss, ref_grads = res[("cpu", "float64")]
    out = {}
    for key in (("cuda", "float64"), ("cuda", "float32"), ("cpu", "float32")):
        loss, grads = res[key]
        rel = _rel(loss, ref_loss)
        shares = [(float((g - r).abs().max()) / float(r.abs().max()), n)
                  for g, r, n in zip(grads, ref_grads, names)]
        share, name = max(shares)
        over = sum(1 for v, _ in shares if v > 1e-4)
        out[key] = (rel, share)
        line = ("phase 22 (b) RELU_LEAKAGE 0.3, B=%d: the %s in %s vs the "
                "CPU in float64: loss %.12g vs %.12g, relative err %.3g "
                "(bound %g); gradients worst %.3g of the tensor's peak (%s), "
                "%d of %d tensors beyond 1e-4"
                % (TASNET_CMP_B, "card" if key[0] == "cuda" else "CPU",
                   key[1], loss, ref_loss, rel, STEP_RTOL["float32"], share,
                   name, over, len(names)))
        print(line)
        held = key == ("cuda", "float64")
        if not np.isfinite(loss) or not rel <= STEP_RTOL["float32"] \
                or (held and not share <= 1e-4):
            raise AssertionError(line)
    return out


def _tasnet_step_ms(dtype: str, reps: int = 5) -> float:
    """Median wall time of a synchronized train step at B=32, T=128 (toy
    spectra), on the card."""
    hp = load_config(**dict(TASNET, COMPUTE_DTYPE=dtype))
    tr = Trainer(hp.get_model()(hp), hp, "cuda")
    st = tr.init_state(torch.Generator().manual_seed(0))
    batch = _toy_batches(hp, 1)[0]
    ms = []
    for _ in range(reps + 1):                  # the first warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(st, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(float(m["loss"])):
            raise AssertionError("phase 22 timing %s: loss %s"
                                 % (dtype, m["loss"]))
    return float(np.median(ms[1:]))


def _trace_kernels(path: str) -> list:
    """The names of the CUDA kernel rows of a Chrome trace written by
    torch.profiler, in time order."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [name for _, name in sorted(
        (e.get("ts", 0), e.get("name", "")) for e in events
        if e.get("cat") == "kernel")]


def _profile_cost(tmp: str) -> dict:
    """(b): the cost of PROFILE_STEPS' trace over one 8-step graph replay
    (B=32, the int16 wave wire; Trainer.ProfileWindow, CPU and CUDA
    activity): the window's start, the replay's synchronized ms per step
    inside it against outside it, and the stop (synchronize, write the
    trace).  The trace must hold kernel A's rows (the replayed kernels are
    recorded); their row indices and the row count are printed (a replay
    of tasnet-v1's step launches 7,176 kernels a step)."""
    from danet_tpu_torch.train.trainer import ProfileWindow
    hp = load_config(**TASNET_GRAPH)
    tr = Trainer(hp.get_model()(hp), hp, "cuda")
    st = tr.init_state(torch.Generator().manual_seed(0))
    stack = tr._put(tr._host_batch(np.stack(_speech_batches(hp, 8))))
    tr.train_steps(st, stack)                  # the capture
    plain = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_steps(st, stack)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    window = ProfileWindow(8, 0, os.path.join(tmp, "profile-cost"), "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window.before(st["step"], tr._captures(st, 8, stack))
    t1 = time.perf_counter()
    tr.train_steps(st, stack)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    window.after(st["step"])
    t3 = time.perf_counter()
    kernels = _trace_kernels(window.path)
    rows_a = [i for i, k in enumerate(kernels) if "stft_ri_kernel" in k]
    out = {"plain_ms": float(np.median(plain)) / 8,
           "start_ms": (t1 - t0) * 1e3, "traced_ms": (t2 - t1) * 1e3 / 8,
           "stop_ms": (t3 - t2) * 1e3,
           "trace_mb": os.path.getsize(window.path) / 2 ** 20,
           "kernel_rows": len(kernels), "stft_rows": len(rows_a)}
    print("phase 22 (b) PROFILE_STEPS' cost over one 8-step graph replay "
          "(B=32, int16 wave wire): %.3f ms per step untraced (median of "
          "3), %.3f ms per step traced (CPU and CUDA activity); starting the "
          "window %.1f ms, closing it (synchronize, write) %.1f ms; a trace "
          "of %.1f MiB with %d CUDA kernel rows, kernel A's %d of 8 at rows "
          "%s (%s)"
          % (out["plain_ms"], out["traced_ms"], out["start_ms"],
             out["stop_ms"], out["trace_mb"], len(kernels), len(rows_a),
             rows_a, nvidia_smi()))
    if not rows_a:
        raise AssertionError("phase 22 (b): the traced replay shows no "
                             "kernel A row")
    return out


def _tasnet_training(tmp: str) -> dict:
    """(b): card vs CPU (phase 11's protocol at COMPARE_LEAKAGE, float32
    and bfloat16, B=TASNET_CMP_B; the config's leakage in float64), the
    timed steps at B=32, the 8-step graph bit for bit, the profiler's
    cost."""
    keys = dict(TASNET, BATCH_SIZE=TASNET_CMP_B, RELU_LEAKAGE=COMPARE_LEAKAGE)
    runs = {dt: _train_dtype(22, "tasnet-v1", dt, True, keys)
            for dt in ("float32", "bfloat16")}
    f64 = _tasnet_float64()
    times = {dt: _tasnet_step_ms(dt) for dt in ("float32", "bfloat16")}
    print("phase 22 (b) tasnet-v1 train step (B=32, T=128, toy spectra, "
          "Adam): float32 %.3f ms, bfloat16 %.3f ms (medians of 5; %s)"
          % (times["float32"], times["bfloat16"], nvidia_smi()))
    _graph_vs_eager("(b) tasnet-v1 B=32 int16 wave wire", TASNET_GRAPH, 8,
                    phase=22)
    return {"step_rel": {dt: r["worst_step_rel"] for dt, r in runs.items()},
            "grad_rel": runs["float32"]["grad_rel"], "float64": f64,
            "times": times, "profile": _profile_cost(tmp)}


def _write_wavdir(folder: str) -> list:
    """WAVDIR_FILES int16 WAVs of WAVDIR_SAMPLES samples at SMPRATE in a
    flat folder: synth-speech utterances (seed 22) at int16 scale (x 32768
    / WAVE_SCALE), each tiled to the one length."""
    from danet_tpu_torch.data.synth_speech import SyntheticSpeechData
    os.makedirs(folder)
    hp = load_config(SMPRATE=SMPRATE, SYNTH_BATCHES=WAVDIR_FILES // 10)
    ds = SyntheticSpeechData(hp, seed=22)
    ds.install_and_load()
    paths = []
    for (batch,) in ds.epoch_wave("train", 10):
        for wav in batch:
            pcm = np.clip(np.round(np.resize(wav, WAVDIR_SAMPLES) * (
                32768.0 / ds.WAVE_SCALE)), -32768, 32767).astype(np.int16)
            paths.append(os.path.join(folder, "u%03d.wav" % len(paths)))
            import scipy.io.wavfile
            scipy.io.wavfile.write(paths[-1], SMPRATE, pcm)
    return paths


def _tasnet_wavdir_cli(tmp: str) -> dict:
    """(c): the CLI from a wav-dir folder: -m train (int16 wave wire, K=8,
    PROFILE_STEPS 2, -bs 4: 8 files a batch), -m test, -m demo on one WAV
    and ``serve run`` on it (against the CPU from the same checkpoint)."""
    corpus = os.path.join(tmp, "wavs")
    paths = _write_wavdir(corpus)
    logs = os.path.join(tmp, "logs")
    keys = dict(TASNET, WAVDIR_PATH=corpus, TRANSFER_DOMAIN="wave",
                TRANSFER_DTYPE="int16", WAVE_PCM_SCALE=32768.0,
                TRAIN_STEPS_PER_CALL=8, PROFILE_STEPS=2, SUMMARY_DIR=logs)
    cfg = os.path.join(tmp, "wavdir.json")
    with open(cfg, "w") as f:
        json.dump(keys, f)
    ckpt = os.path.join(tmp, "wavdir-ckpt")
    t0 = time.perf_counter()
    text, train_launches, captures = _main_path(
        lambda: _port_cli(["-m", "train", "-ds", "wav-dir", "-ne", "1", "-bs",
                           "4", "-c", cfg, "-n", "wavdir", "-o", ckpt,
                           "--no-save-on-epoch"], tmp),
        per_step={"stft_ri": 1})
    replays = StepGraph.replays
    train_s = time.perf_counter() - t0
    (run_dir,) = os.listdir(logs)
    with open(os.path.join(logs, run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if "train/loss" in r]
    trace = os.path.join(logs, run_dir, "profile", "trace.json")
    kernels = _trace_kernels(trace) if os.path.exists(trace) else []
    stft = sum(1 for k in kernels if "stft_ri_kernel" in k)
    window = [ln for ln in text.splitlines() if ln.startswith("[profile:")]
    epoch = [ln for ln in text.splitlines() if ln.startswith(("Epoch",
                                                              "Valid"))]
    line = ("phase 22 (c) -m train -ds wav-dir (%d int16 WAVs of %.1f s, "
            "-bs 4, K=8, PROFILE_STEPS 2): %s; %d steps in %.1f s, %d "
            "capture(s), %d replay(s); %s; trace %s: %d CUDA kernel rows, %d "
            "of them kernel A's; launches %s"
            % (len(paths), WAVDIR_SAMPLES / SMPRATE, epoch, len(steps),
               train_s, captures, replays, window, trace, len(kernels), stft,
               {k: v for k, v in train_launches.items() if v}))
    print(line)
    if len(epoch) != 2 or "nan" in text.lower() or captures != 1 \
            or replays < 2 or not window or not stft \
            or not all(np.isfinite(r["train/loss"]) for r in steps):
        raise AssertionError(line + "\n" + text[-3000:])

    wav = paths[0]
    seen = []
    real = Trainer.separate

    def recording(self, state, mix_ri):
        out = real(self, state, mix_ri)
        seen.append((mix_ri, out))
        return out

    def evaluate():
        from danet_tpu_torch import serve
        out = _port_cli(["-m", "test", "-ds", "wav-dir", "-c", cfg, "-i",
                         ckpt], tmp)
        Trainer.separate = recording
        try:
            out += _port_cli(["-m", "demo", "-ds", "wav-dir", "-c", cfg,
                              "-i", ckpt, "-if", wav], tmp)
        finally:
            Trainer.separate = real
        here = os.getcwd()
        os.chdir(tmp)
        try:
            serve._main(["run", "-c", cfg, "-w", ckpt, "-if", wav, "-o",
                         os.path.join(tmp, "served")])
        finally:
            os.chdir(here)
        return out

    text, eval_launches, _ = _main_path(evaluate, per_step={})
    test = [ln for ln in text.splitlines() if ln.startswith("Test: ")]
    from danet_tpu_torch import serve
    from danet_tpu_torch.data import audio
    import scipy.io.wavfile
    served = [scipy.io.wavfile.read(os.path.join(tmp, "served_%d.wav" % i))[1]
              for i in range(2)]
    cpu_sep = serve.load_separator(ckpt, [cfg], "cpu")
    gpu_sep = serve.load_separator(ckpt, [cfg], "cuda")
    x = audio.load_wav_raw(wav, SMPRATE)
    ref, got = cpu_sep.separate(x), gpu_sep.separate(x)
    peak = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    hp = load_config(cfg)
    cpu_tr = Trainer(hp.get_model()(hp), hp, "cpu")
    st = cpu_tr.load_params(cpu_tr.init_state(), ckpt)
    (mix, demo_out), = seen
    demo_ref = cpu_tr.separate(st, mix)
    demo_err = float(np.abs(demo_out - demo_ref).max())
    demo_peak = float(np.abs(demo_ref).max())
    line = ("phase 22 (c) -m test: %s; -m demo -if %s: separated spectra %s "
            "vs the CPU's %.3g of the peak; serve run: %s, the card's "
            "Separator vs the CPU's from the checkpoint %.3g of the peak "
            "(rtol %g); launches %s"
            % (test, os.path.basename(wav), demo_out.shape,
               demo_err / demo_peak, [s.shape for s in served], err / peak,
               SERVE_RTOL, {k: v for k, v in eval_launches.items() if v}))
    print(line)
    vals = [float(p.split("=")[1]) for ln in test for p in ln.split()[1:]]
    if len(test) != 1 or not all(np.isfinite(vals)) \
            or [s.shape for s in served] != [(WAVDIR_SAMPLES,)] * 2 \
            or not err <= SERVE_RTOL * peak \
            or not demo_err <= SERVE_RTOL * demo_peak \
            or not eval_launches["stft_ri"]:
        raise AssertionError(line + "\n" + text[-2000:])
    return {n: train_launches[n] + eval_launches[n] for n in KERNELS}


def _write_timit(folder: str) -> None:
    """{train,test}_set.pkl in the reference's layout (three pickled lists:
    complex64 spectra [T, F], phoneme codes, text codes), as
    tests/test_data.py writes them, TIMIT_UTTS utterances of TIMIT_FRAMES
    frames."""
    import pickle
    rs = np.random.RandomState(22)
    os.makedirs(folder)
    for subset, n in TIMIT_UTTS.items():
        sigs = [(rs.randn(rs.randint(*TIMIT_FRAMES), 129)
                 + 1j * rs.randn(1, 129)).astype(np.complex64)
                for _ in range(n)]
        phonemes = [rs.randint(0, 60, size=(5,)).astype(np.int32)
                    for _ in range(n)]
        texts = [rs.randint(0, 27, size=(8,)).astype(np.int32)
                 for _ in range(n)]
        with open(os.path.join(folder, "%s_set.pkl" % subset), "wb") as f:
            for obj in (sigs, phonemes, texts):
                pickle.dump(obj, f, -1)


def _timit_cli(tmp: str) -> dict:
    """(d): the CLI from TIMIT pickles with bilstm-orig
    (configs/reference-parity.json; the recipe of experiments/timit_1.sh):
    -m train -ne 1 -tl 64 -bs 8, then -m debug and -m test; kernels B, 2
    and 3 on this dataset's batches."""
    folder = os.path.join(tmp, "timit")
    _write_timit(folder)
    base = ["-ds", "timit", "-c", os.path.join(REPO_ROOT, "configs",
                                               "reference-parity.json"),
            "--set", "TIMIT_DIR=%s" % folder,
            "--set", "SUMMARY_DIR=%s" % os.path.join(tmp, "timit-logs")]
    ckpt = os.path.join(tmp, "timit-ckpt")

    def run():
        out = _port_cli(base + ["-m", "train", "-ne", "1", "-tl", "64", "-bs",
                                "8", "-o", ckpt, "--no-save-on-epoch"], tmp)
        out += _port_cli(base + ["-m", "debug", "-i", ckpt], tmp)
        out += _port_cli(base + ["-m", "test", "-i", ckpt, "-bs", "8"], tmp)
        return out

    t0 = time.perf_counter()
    text, launches, _ = _main_path(run, per_step={})
    lines = [ln for ln in text.splitlines() if ln.startswith(
        ("Epoch", "Valid", "Test: ", "Debug data"))]
    line = ("phase 22 (d) -ds timit (%s utterances, %d-%d frames), "
            "reference-parity bilstm-orig, -tl 64 -bs 8: %s in %.1f s; "
            "launches %s" % (TIMIT_UTTS, TIMIT_FRAMES[0], TIMIT_FRAMES[1] - 1,
                             lines, time.perf_counter() - t0,
                             {k: v for k, v in launches.items() if v}))
    print(line)
    if len(lines) != 4 or "nan" in text.lower() or not all(
            "loss=" in ln for ln in lines if ln.startswith(
                ("Epoch", "Valid", "Test"))) or not os.path.exists(
            os.path.join(tmp, "debug", "debug_data.mat")) or not all(
            launches[n] for n in ("bilstm_scan", "bilstm_scan_train",
                                  "bilstm_scan_bwd")):
        raise AssertionError(line + "\n" + text[-2000:])
    return launches


def phase_tasnet() -> dict:
    """Phase 22: tasnet-v1, the wav-dir and timit datasets through the CLI,
    PROFILE_STEPS (module docstring)."""
    import shutil
    import tempfile
    t0 = clock = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="danet-phase22-")
    times = {}
    try:
        serving = _tasnet_serving()
        times["(a)"], clock = time.perf_counter() - clock, time.perf_counter()
        training = _tasnet_training(tmp)
        times["(b)"], clock = time.perf_counter() - clock, time.perf_counter()
        wavdir = _tasnet_wavdir_cli(tmp)
        times["(c)"], clock = time.perf_counter() - clock, time.perf_counter()
        timit = _timit_cli(tmp)
        times["(d)"] = time.perf_counter() - clock
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {n: serving["launches"][n] + wavdir[n] + timit[n]
                for n in KERNELS}
    print("phase 22 took %.1f s (%s) on %s; main-path launches %s"
          % (time.perf_counter() - t0, ", ".join(
              "%s %.1f s" % kv for kv in times.items()), nvidia_smi(),
             {k: v for k, v in launches.items() if v}))
    return {"serving": serving, "training": training, "launches": launches}


def _bound(flops: float, nbytes: float):
    """(ms, "operations" or "bytes"): the least time of the work on the
    card, the larger of its FLOPs at the float32 peak and its bytes at the
    memory rate."""
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    by_bytes = nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else \
        (by_bytes, "bytes")


def _cost(name: str, t: int, b: int, h=None) -> tuple:
    """(FLOPs, bytes) of one float32 call of kernel ``name`` at (T, B) (and
    for the LSTM kernels H = ``h``, by default bilstm-orig's 300 or
    lstm-orig's 600): the
    recurrent products, or for kernel A the windowing and a real FFT of
    each frame (5/2 N log2 N FLOPs at N = 256, what torch.stft needs; the
    kernel's matmul DFT does 2 x 256 x 258 per frame, which the function
    does not need); each input read once and each output written once
    (kernel A: the wave and the window in, the spectrum out)."""
    if name.startswith("flash"):       # attn-v1: H=4, D=64
        bthd, bt, bht = b * t * ATTN_H * ATTN_D, b * t, b * ATTN_H * t
        products = {"flash_attn": 2, "flash_attn_bwd_dkv": 4,
                    "flash_attn_bwd_dq": 3}[name]
        flops = 2.0 * products * b * ATTN_H * t * t * ATTN_D
        if name == "flash_attn":       # q, k, v, seg in; o, l, m out
            return flops, 4.0 * (4 * bthd + bt + 2 * bht)
        # q, k, v, seg, l, m, do, di in; dk and dv, or dq, out
        outs = 2 if name == "flash_attn_bwd_dkv" else 1
        return flops, 4.0 * ((4 + outs) * bthd + bt + 3 * bht)
    if name in ("stft_ri", "stft_logmag"):  # here t is the wave length
        n_frames = stft_frame_count(t, 256, 64)
        return (b * n_frames * (2.5 * 256 * 8 + 256),
                4.0 * (b * t + 256 + b * n_frames * 258))
    if name.startswith("gru"):
        h = 600
        flops = 2.0 * t * b * h * 3 * h
        if name == "gru_scan_bwd":     # d_cs, acts, c_prev, weights, outs
            return flops, 4.0 * (5 * t * b * h + 3 * h * h + 3 * t * b * h
                                 + b * h)
        out = t * b * h * (4 if name == "gru_scan_train" else 1)
        return flops, 4.0 * (3 * t * b * h + 3 * h * h + b * h + out)
    d = 2 if name.startswith("bilstm") else 1
    h = h or (300 if d == 2 else 600)
    flops = 2.0 * t * b * h * 4 * h * d
    if name.endswith("_bwd"):          # d_hs, cs, c_prev, acts, wh; outs
        return flops, 4.0 * d * (3 * t * b * h + 4 * t * b * h + 4 * h * h
                                 + 4 * t * b * h + 2 * b * h)
    out = t * b * h * (6 if name.endswith("_train") else 1)
    return flops, 4.0 * d * (4 * t * b * h + 4 * h * h + 2 * b * h + out)


# the shape each kernel is timed at: its main path's (T or samples, B)
TIMED_AT = {"stft_ri": (80000, 1), "bilstm_scan": (1251, 1),
            "lstm_scan": (1251, 1), "gru_scan": (1251, 1),
            "flash_attn": (1280, 1), "stft_logmag": (80000, 1)}
SDPA = ("torch.nn.functional.scaled_dot_product_attention with the boolean "
        "segment-equality mask [B, 1, T, T]")
GRU_NO_LIBRARY = ("none: cuDNN's GRU (torch.nn.GRU) computes "
                  "tanh(W_in x + r * (W_hn h + b_hn)), r after the recurrent "
                  "product; this repo's GRU computes tanh(cx + (c * r) @ Wch)")


def _library_attention(rs) -> dict:
    """SDPA with the segment mask, float32, H=4, D=64: forward at the
    serving and training shapes, forward + backward and the backward alone
    (dq, dk and dv together) at the training shape."""
    def inputs(b, t):
        q, k, v = (torch.from_numpy(rs.randn(b, ATTN_H, t, ATTN_D).astype(
            np.float32)).cuda().requires_grad_(True) for _ in range(3))
        seg = torch.zeros(b, t, dtype=torch.int32)
        seg[-1, t - 37:] = 1
        return q, k, v, (seg[:, None, :, None] == seg[:, None, None, :]).cuda()

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, mask = inputs(1, 1280)
    with torch.no_grad():
        serve_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask), 20)
    q, k, v, mask = inputs(32, TRAIN_T)
    with torch.no_grad():
        train_fwd = cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask), 20)
    g = torch.from_numpy(rs.randn(32, ATTN_H, TRAIN_T, ATTN_D).astype(
        np.float32)).cuda()
    both = cuda_ms(lambda: torch.autograd.grad(
        sdpa(q, k, v, attn_mask=mask), (q, k, v), g), 20)
    y = sdpa(q, k, v, attn_mask=mask)
    bwd = cuda_ms(lambda: torch.autograd.grad(y, (q, k, v), g,
                                              retain_graph=True), 20)
    print("phase 12 library %s: forward B=1 T=1280 %.4f ms, forward B=32 "
          "T=128 %.4f ms, forward + backward B=32 T=128 %.4f ms, backward "
          "%.4f ms" % (SDPA, serve_ms, train_fwd, both, bwd))
    note = SDPA + "; its backward computes dq, dk and dv together"
    return {"flash_attn": (serve_ms, SDPA + ", forward"),
            "flash_attn_bwd_dkv": (bwd, note),
            "flash_attn_bwd_dq": (bwd, note)}


def phase_library(window) -> dict:
    """One PyTorch call per kernel that computes the same function, timed
    at the kernel's shape, float32; the port never calls these."""
    rs = np.random.RandomState(12)
    out = {}
    x = torch.from_numpy((rs.randn(1, 80000) * 0.3).astype(np.float32)).cuda()
    w = torch.from_numpy(np.asarray(window, np.float32)).cuda()
    scale = 1.0 / float(w.sum())
    out["stft_ri"] = (cuda_ms(lambda: torch.stft(
        x, 256, 64, window=w, center=True, pad_mode="constant",
        return_complex=True) * scale, 50),
        "torch.stft, center=True, pad_mode='constant', times 1/sum(window)")
    for prefix, hidden, bidir in (("bilstm", 300, True),
                                  ("lstm", 600, False)):
        lstm = torch.nn.LSTM(600, hidden, bidirectional=bidir).cuda()
        note = ("torch.nn.LSTM(600, %d%s) (cuDNN), tanh candidate; it also "
                "computes the input projection" % (
                    hidden, ", bidirectional" if bidir else ""))
        xs = torch.from_numpy(rs.randn(1251, 1, 600).astype(
            np.float32)).cuda()
        with torch.no_grad():
            out[prefix + "_scan"] = (cuda_ms(lambda: lstm(xs), 10), note)
        xt = torch.from_numpy(rs.randn(128, 32, 600).astype(
            np.float32)).cuda().requires_grad_(True)
        out[prefix + "_scan_train"] = (
            cuda_ms(lambda: lstm(xt), 10), note + ", training forward")
        y, _ = lstm(xt)
        g = torch.randn_like(y)
        out[prefix + "_scan_bwd"] = (
            cuda_ms(lambda: torch.autograd.grad(y, xt, g, retain_graph=True),
                    10),
            note + "; its backward to the input only (no weight gradients), "
            "which includes the input projection's backward")
    for name in ("gru_scan", "gru_scan_train", "gru_scan_bwd"):
        out[name] = (None, GRU_NO_LIBRARY)
    out["stft_logmag"] = (cuda_ms(lambda: torch.log1p(torch.abs(torch.stft(
        x, 256, 64, window=w, center=True, pad_mode="constant",
        return_complex=True) * scale)), 50),
        "torch.stft as for stft_ri, then abs and log1p (one output)")
    out.update(_library_attention(rs))
    for name, (ms, note) in out.items():
        print("phase 12 library %s: %s (%s)" % (
            name, "%.4f ms" % ms if ms is not None else "null", note))
    return out


def main():
    phase_environment()
    phase_build()
    window = load_config().FFT_WND_ARRAY
    stft = phase_stft(window)
    scan = phase_bilstm()
    serving = phase_serving()
    train_kernels = phase_train_kernels()
    training = phase_training()
    uni_kernels = phase_lstm_unidirectional()
    gru_kernels = phase_gru()
    serving_uni = phase_serving_unidirectional()
    training_uni = phase_training_unidirectional()
    library = phase_library(window)
    for name, run in (("bilstm_scan_bwd", train_kernels),
                      ("lstm_scan_bwd", uni_kernels)):
        ms = run["times"][name][0]
        print("kernel 3 %s T=%d B=32 float32: %.4f ms, %.3f us/step; library "
              "%.4f ms (%s)" % (name, TRAIN_T, ms, 1e3 * ms / TRAIN_T,
                                *library[name]))
    flash_kernels = phase_flash_kernels()
    serving_attn = phase_serving_attention()
    training_attn = phase_training_attention()
    logmag = phase_stft_logmag(window)
    training_tpu = phase_training_tpu()
    serving_tpu = phase_serving_tpu()
    tpu_whole = phase_tpu_whole()
    checkpoints = phase_checkpoints()
    new_encoders = phase_new_encoders()
    tasnet = phase_tasnet()
    print("summary: bilstm_scan bfloat16 max_abs_err %.3g (atol %g); "
          "serving worst error vs CPU %.3g of the peak (rtol %g), lstm-orig "
          "%.3g, gru-v1 %.3g, attn-v1 %.3g; train steps vs CPU: worst "
          "relative loss/SNR err %s, step-1 gradients %.3g of the peak; "
          "lstm-orig %s, every step's gradients %.3g; gru-v1 %s, %.3g; "
          "attn-v1 %s, %.3g; configs/tpu.json serving %.3g, training %s, "
          "%.3g; configs/tpu.json whole: ingest %.3g, 8 steps %.3g, %.3g; "
          "checkpoints: resumed bit for bit, EMA and GRAD_ACCUM steps %.3g, "
          "%.3g; tasnet-v1: serving %.3g, training %s, %.3g, RELU_LEAKAGE "
          "0.3 in float64 %.3g"
          % (scan["max_abs_err"][torch.bfloat16], LSTM_ATOL[torch.bfloat16],
             serving["max_rel_err"], SERVE_RTOL,
             serving_uni["lstm-orig"]["max_rel_err"],
             serving_uni["gru-v1"]["max_rel_err"],
             serving_attn["max_rel_err"],
             training["step_rel"], training["grad_rel"],
             training_uni["lstm-orig"]["step_rel"],
             training_uni["lstm-orig"]["grad_rel"],
             training_uni["gru-v1"]["step_rel"],
             training_uni["gru-v1"]["grad_rel"],
             training_attn["step_rel"], training_attn["grad_rel"],
             serving_tpu["max_rel_err"], training_tpu["step_rel"],
             training_tpu["grad_rel"], tpu_whole["ingest_err"],
             tpu_whole["step_rel"], tpu_whole["grad_rel"],
             checkpoints["step_rel"], checkpoints["grad_rel"],
             tasnet["serving"]["max_rel_err"],
             tasnet["training"]["step_rel"], tasnet["training"]["grad_rel"],
             tasnet["training"]["float64"][("cuda", "float64")][1]))
    # launches: the counts of the main paths that run each kernel, each
    # zeroed just before its path and read just after it; kernel 6 has no
    # main path and counts its own phase's comparison launches
    paths = [serving["launches"], training["launches"],
             serving_attn["launches"], training_attn["launches"],
             serving_tpu["launches"], training_tpu["launches"],
             tpu_whole["launches"], checkpoints["launches"],
             new_encoders["launches"], tasnet["launches"]] + [
        run["launches"] for run in list(serving_uni.values())
        + list(training_uni.values())]
    launches = {name: sum(p[name] for p in paths) for name in KERNELS}
    launches["stft_logmag"] = logmag["launches"]
    ft = flash_kernels["times"]
    times = dict(stft=stft["times"][(1, 80000)],
                 bilstm_scan=scan["times"][(1251, 1)],
                 **train_kernels["times"], **uni_kernels["times"],
                 **gru_kernels["times"],
                 flash_attn=ft[("flash_attn", 1280, 1)],
                 flash_attn_bwd_dkv=ft[("flash_attn_bwd_dkv", TRAIN_T, 32)],
                 flash_attn_bwd_dq=ft[("flash_attn_bwd_dq", TRAIN_T, 32)],
                 stft_logmag=logmag["times"])
    times["stft_ri"] = times.pop("stft")
    errs = {"stft_ri": stft["max_abs_err"],
            "bilstm_scan": scan["max_abs_err"][torch.float32],
            "stft_logmag": logmag["max_abs_err"]}
    for phase in (train_kernels, uni_kernels, gru_kernels, flash_kernels):
        errs.update({k: v[torch.float32]
                     for k, v in phase["max_abs_err"].items()})
    flash_src = ("danet_tpu/ops/pallas/attention.py:28 (flash_attention_"
                 "masked) -> jax/experimental/pallas/ops/tpu/"
                 "flash_attention.py:%d (%s)")
    sources = {
        "stft_ri": ("danet_tpu_torch/csrc/stft.cu",
                    "danet_tpu/ops/pallas/stft.py:95"),
        "bilstm_scan": ("danet_tpu_torch/csrc/lstm_scan_lean.cu",
                        "danet_tpu/ops/pallas/lstm.py:242 (n_dirs=2)"),
        "bilstm_scan_train": ("danet_tpu_torch/csrc/lstm_scan_lean.cu",
                              "danet_tpu/ops/pallas/lstm.py:242 (n_dirs=2, "
                              "save=True)"),
        "bilstm_scan_bwd": ("danet_tpu_torch/csrc/bilstm_scan_bwd.cu",
                            "danet_tpu/ops/pallas/lstm.py:275 (n_dirs=2)"),
        "lstm_scan": ("danet_tpu_torch/csrc/lstm_scan_lean.cu",
                      "danet_tpu/ops/pallas/lstm.py:242 (n_dirs=1)"),
        "lstm_scan_train": ("danet_tpu_torch/csrc/lstm_scan_lean.cu",
                            "danet_tpu/ops/pallas/lstm.py:242 (n_dirs=1, "
                            "save=True)"),
        "lstm_scan_bwd": ("danet_tpu_torch/csrc/bilstm_scan_bwd.cu",
                          "danet_tpu/ops/pallas/lstm.py:275 (n_dirs=1)"),
        "gru_scan": ("danet_tpu_torch/csrc/gru_scan.cu",
                     "danet_tpu/ops/pallas/gru.py:145"),
        "gru_scan_train": ("danet_tpu_torch/csrc/gru_scan.cu",
                           "danet_tpu/ops/pallas/gru.py:145 (save=True)"),
        "gru_scan_bwd": ("danet_tpu_torch/csrc/gru_scan_bwd.cu",
                         "danet_tpu/ops/pallas/gru.py:169"),
        "flash_attn": ("danet_tpu_torch/csrc/flash_attn.cu",
                       flash_src % (758, "forward")),
        "flash_attn_bwd_dkv": ("danet_tpu_torch/csrc/flash_attn_bwd.cu",
                               flash_src % (1121, "dK/dV")),
        "flash_attn_bwd_dq": ("danet_tpu_torch/csrc/flash_attn_bwd.cu",
                              flash_src % (1456, "dQ")),
        "stft_logmag": ("danet_tpu_torch/csrc/stft.cu",
                        "danet_tpu/ops/pallas/stft.py:95 (logmag=True, "
                        "epilogue :72-75)"),
    }
    kernels = []
    for name in KERNELS:
        t, b = TIMED_AT.get(name, (TRAIN_T, 32))
        bound_ms, bound_by = _bound(*_cost(name, t, b))
        ms, plain_ms = times[name]
        lib_ms, lib_note = library[name]
        entry = {
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "library": lib_note,
            "timed_at": "%s=%d, B=%d, %sfloat32" % (
                "L" if name.startswith("stft") else "T", t, b,
                "H=%d, D=%d, " % (ATTN_H, ATTN_D)
                if name.startswith("flash") else "")}
        if name == "flash_attn":
            entry["splits"] = cuda_attn.flash_splits(
                b, t, ATTN_H,
                torch.cuda.get_device_properties(0).multi_processor_count)
        if name == "stft_logmag":
            entry["launches_of"] = ("its own comparison phase (16): no main "
                                    "path of the port or of the JAX package "
                                    "calls it")
        kernels.append(entry)
        if not launches[name]:
            raise AssertionError("%s was not launched on its main path"
                                 % name)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
