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
   digest, and its time.  Its caller, dsp.stft_mag_logmag, runs in phase
   25 (f), whose launches its summary entry counts.
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
   int16 wave wire and the prefetch only, and with every key, on
   tpu.json's flash attention (the dense attention's loop is not timed:
   the script's time limit).
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
   batch whose row groups would pass a kernel's row ceiling is split
   across launches) and each kernel's launches as (rows, row groups G),
   holds every output of a launch with G > 1 bit for bit to the G = 1
   launch of the same inputs (the wrappers' ``groups=1``), and prints in
   both dtypes each kernel's time beside torch.nn.LSTM's in the same dtype
   and its bound (float32 also beside its plain version's).  Then, with
   cuDNN at PyTorch's defaults from here to
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

23. causal attn-v1 and moe-v1.  (a) attn-v1 at configs/attn.json's widths
   (default.json's: 4 blocks of 256, 4 heads of 64, MLP x4) with
   ATTN_CAUSAL and ATTN_LOOKBACK 128, the band chunked by ATTN_LOCAL_CHUNK
   0 (ops/local_attention.py; no kernel: cuBLAS products): serving a 10 s
   request (T=1251, 9 chunks of 139) and 524,224 samples (T=8192, 64
   chunks of 128) at B=1 against the CPU at phase 5's bounds, each beside
   the dense band's latency (ATTN_LOCAL_CHUNK -1), and the 10 s request's
   chunked and dense-band answers on the card against each other at
   SERVE_RTOL of the peak; training under phase 11's protocol at B=4,
   T=1024 (8 chunks), float32, on white-noise spectra (the toy dataset's
   distribution at that length); the step time and peak device memory at
   B=4 in float32 and bfloat16, chunked at T = 2048, 4096 and 8192 and
   the dense band at 2048 and 4096 (benchmarks/long_context.py's
   shapes); one 8-step CUDA graph call against 8 eager steps bit for bit
   at T=2048.  (b) moe-v1 at configs/moe-ep.json's keys (8 experts,
   width 256, 4 blocks, B=16, toy data) with MESH_DATA and MESH_EXPERT
   reset to 1 (the expert-parallel forms are not ported): the soft
   mixture (MOE_TOP_K 0, the file's) and top-2 routing at capacity 1.25,
   each served (10 s and 4 x 4 s against the CPU in float32, timed in
   the file's bfloat16 too) and trained under phase 11's protocol in both
   dtypes with the step times; the routed step (its dispatch's cumsum and
   top-k sort) through one 8-step CUDA graph call against 8 eager steps
   bit for bit; with ATTN_BACKEND 'flash', a 10.23 s
   request and a 4 x 4.09 s batch (T=1280 and 512) served against the
   CPU, flash_attn once per block per request, and phase 11's protocol
   in float32 with the flash kernels once per block per step, timed
   beside the dense attention; then the CLI: ``-m train -ds toy -ne 1``
   with ``-c configs/moe-ep.json --set MESH_DATA=1 --set MESH_EXPERT=1``,
   ``-m test``, and ``serve run`` on one 4 s WAV on the card and on the
   CPU (float32, layered): the int16 WAVs within one step.  Phase 21 (c)
   also holds tcn-v1 and dprnn-v1 at their files' keys as written (leaky
   ReLUs, the head as initialised) for one step in float64, card against
   CPU, at phase 11's bounds, and prints the card's and the CPU's float32
   against that step; the step at the files' keys misses 1e-4 (their
   ANCHOR_AUX_LOSS term, kmeans attractors, makes the float64 gradients
   jump: see V2_F64_B), is printed beside the CPU's own float64 move
   under a 1e-13 input change and recorded, and the same step at
   ANCHOR_AUX_LOSS 0, the leaky ReLUs as written, is held.

24. causal streaming and long-form separation.  (a) kernel 1's state
   entry (lstm_scan with return_state: c0 in float32, and the final cell
   state c_T written in float32, the kernel's own carry) against its plain
   version at lstm-orig's H=600, T in 1, 64 and 1251 at B=1 and 4 and
   (T=128, B=32), and at dprnn-v1's inter shape H=128, (T=1, B=64) one
   stream chunk, (T=3, B=4096) and (T=3, B=8192), which crosses the row
   ceiling: its c_T comes from two launches; nonzero c0 and h0, tanh and
   identity candidates (H=128: tanh), float32 at LSTM_ATOL on hs and c_T,
   bfloat16 at phase 4's bound on hs and phase 6's on c_T; its hs bit for
   bit the lean entry's; the state entry's time beside the lean one's,
   the plain version's, nn.LSTM's and the bound; then kernel 4f's carry,
   cs[-1] from a nonzero c0 at H=600, T=1251, B=1.  (b) through
   serve.load_streamer at full width, float32, seeded random weights
   (_init): lstm-orig (4 x 600), gru-v1 (4 x 600), causal attn-v1 and
   causal moe-v1 (phase 23's keys, ATTN_LOOKBACK 128), tcn-v1
   (configs/tcn.json's keys with TCN_CAUSAL) and dprnn-v1 (configs/
   dprnn.json's with DPRNN_INTER_CAUSAL and DPRNN_HOP 64): a 16,384-sample
   warm-up, then 16 feeds of 4096 samples (64 frames) to 10.24 s at B=1,
   after one such stream as a warm-up; the stream against the CPU's at
   SERVE_RTOL of the peak and against the card's own with 1024-sample
   chunks (dprnn-v1: 8192) at JAX's chunk-invariance bound; each feed's
   launches (kernel 1 per lstm-orig layer, 4f per gru-v1 layer, kernels B
   and 1 per dprnn-v1 block; none for the others) and no plain scan; the
   median and p90 ms per feed and the real-time factor beside the card's
   name and power limit.  (c) separate_long with bilstm-orig at full
   width on a 60 s mixture, chunks of 256 frames overlapping by 32 (34
   chunks in one batch: kernel B once per layer) against the CPU at
   SERVE_RTOL of the peak, and its time.  (d) the CLI: -m train -ds toy
   -ne 1, then -m demo -if a 4 s int16 WAV with --stream (lstm-orig) and
   with --set DEMO_CHUNK_FRAMES=64 (bilstm-orig), on the card and with
   --device cpu from the same checkpoint: the WAVs within one int16 step.

25. the serving artifacts (torch.export bundles, the kernels as
   torch.library ops, ops/cuda/library.py).  (a) each op (danet::stft_ri
   with and without its logmag flag, bilstm_scan, lstm_scan,
   lstm_scan_state, gru_scan, flash_attn) on the card against its plain
   version on the same inputs at small shapes of its main paths (phase
   3's, 4's, 8's and 13's tolerances), one launch of its kernel per call,
   and torch.library.opcheck on the card.  (b) the paper model
   (default.json's bilstm-orig, 4 x 2 x 300, seed 0, float32) exported
   for the card at buckets 16000, 40000 and 80000: each bucket's graph
   holds danet.stft_ri once and danet.bilstm_scan once per layer; a 10 s
   and a 3 s request (padded to 40000) through the bundle, each raising
   kernel A's counter by 1 and kernel B's by 4 and running no plain scan,
   against the live Separator on the padded wave (1e-6 of the peak), the
   CPU bundle (SERVE_RTOL) and a fresh process that loads the artifact
   without model code (bit for bit); the export time, the artifact's size
   and the median ms per request, bundle beside live.  (c) attn-v1 on
   its flash path, one bucket of T = 1280: a 9.98 s request that the live
   Separator refuses (T = 1249), through kernel 5f once per block,
   against the live model on the padded wave.  (d) bfloat16 weights: the
   artifact under 0.75 of the float32 one, the 3 s request within 5e-2 of
   the float32 bundle's peak.  (e) stream bundles at default.json's
   widths, lstm-orig (kernel 1's state entry per layer and feed), gru-v1
   (4f) and causal tasnet-v1 (no kernel; depth cut to one repeat of its 8
   blocks): a 16,384-sample warm-up and 16
   feeds of 4096 against the live Streamer (1e-6 of the peak), median and
   p90 ms per feed beside the live Streamer's.  (f) dsp.stft_mag_logmag on
   the card (kernel 6) against its plain version, atol 2e-5.  (g) the
   serve CLI: export -> run -d (paper model) and export-stream ->
   run-stream (lstm-orig) from .npz weights, the WAVs within one int16
   step of (b)'s and (e)'s bundles fed by hand.

26. data and tensor parallelism (MESH_DATA, MESH_MODEL; danet_tpu_torch/
   parallel/) on the paper model at full width (bilstm-orig, 4 x 300,
   B=32, T=128, float32, seed 0, toy data).  (a) world 1 over NCCL: this
   process joins a real process group of one rank (cpu:gloo,cuda:nccl on
   a free localhost port), and a Trainer on its 1 x 1 mesh (the gather,
   the gradients' and metrics' all-reduces) takes an eager step and one
   8-step CUDA graph call (the NCCL collectives captured) bit for bit the
   plain Trainer's (parameters, Adam moments, every loss); kernels 2 and 3
   once per layer in the eager step, kernel B once per layer in a valid
   step.  (b) two ranks sharing the one card (parallel/smoke.py: NCCL
   refuses one device twice, so the group is gloo and the collectives
   stage the card tensors through the host), MESH 1 x 2 then 2 x 1: each
   rank runs kernels 2 and 3 (and B in a valid step) on its 16 rows, the
   updated parameters within 2e-5 + 1e-4 x |p| of the one-process step at
   B=32 and equal on both ranks bit for bit; in each rank kernels B, 2 and
   3 at (T=128, B=16) against their plain versions at phase 4's and 6's
   float32 tolerances.  The per-rank launches are printed.
27. pipeline and expert parallelism (MESH_PIPE, MESH_EXPERT;
   parallel/pipeline.py, parallel/expert.py) on one card, ranks sharing it
   over gloo as in 26 (b), seed 0, toy data.  (a) configs/pipeline.json's
   keys at 1 x 4 (bilstm-orig 4 x 300, B=16, T=128, PIPE_MICROBATCHES 8:
   four stages of one layer, microbatches of 2 rows): four ranks each take
   a train step and a valid step, in bfloat16 as written (the loss within
   1e-2 and each gradient within 2e-2 of its tensor's peak of the
   one-process step: the weight gradients are bfloat16 products summed
   per microbatch) and in float32 (the parameters after the step within
   26 (b)'s 2e-5 + 1e-4 x |p|); the ranks' parameters, all replicated
   over 'pipe', bit for bit; each stage rank launches kernels 2 and 3 once
   per (layer of its stage, microbatch) in the step and kernel B as often
   in the valid step (8 each: no bubble tick computes); kernels B, 2 and
   3 at a stage's (T=128, B=2) against their plain versions at phase 4's
   and 6's tolerances, float32 and bfloat16.  (b) configs/moe-ep.json's
   keys at 1 x 2 (moe-v1, 8 experts, ATTN_DIM 256, 4 blocks, B=16): two
   ranks, 4 experts each, a train and a valid step of the soft mixture and
   of MOE_TOP_K 2, bfloat16 as written and float32, held as in (a)
   against the one-process step (for MOE_TOP_K 2 one process routing each
   of the two T-shards with its own capacity, the semantics of JAX's
   moe_mlp_ep_routed); the ranks' gathered parameters bit for bit.
28. sequence parallelism (MESH_SEQ; parallel/seq_parallel.py,
   ring_attention.py, ulysses.py) on one card, ranks sharing it over gloo
   as in 26 (b), seed 0, toy data.  (a) the saving LSTM forward's state
   entry (lstm_scan_train_state: float32 c0 and final carry c_T) and
   kernel 3 seeded with the carry's cotangent (lstm_scan_bwd_seeded)
   and the lean state entry (phase 24's bounds) against their plain
   versions at the relay's chunk shape (H=300, T=32,
   B=4) and at (H=600, T=128, B=32), float32 (forward within 2e-6, the
   backward within 2e-6 + 1e-4 x |plain|) and bfloat16 (phase 6's
   bounds), layer-shaped inputs with nonzero c0, h0, d_hs and dc_T; each
   timed beside the lean state entry, the saving forward and kernel 3
   without the state.  (b) configs/seq-parallel.json's keys (bilstm-orig 4
   x 300, B=8, T=128, SP_HALO 16) at 1 x 4: four ranks each scan their
   32-frame chunk of every row, a train and a valid step, the relay in
   bfloat16 as written (held as in 27 (a) against the one-process step)
   and in float32 (the loss within 1e-4 and each gradient within 1e-4 of
   its tensor's peak, phase 7's bounds: the relay's one-direction chunk
   scans sum in another order than the dense step's kernel 2, and Adam
   turns that into up to 2 LR on a gradient element near zero, which 27
   (a)'s bound on the parameters would not hold), and SP_RNN_SCHEME halo
   in bfloat16 (its loss within
   5e-2 of the one-process loss: the halo warm-up approximates the state
   at each chunk's start, JAX's halo-decay bound); the launches per rank
   printed (the relay: one state-entry saving forward and one seeded
   backward per direction and layer, 8 and 8, each rank scanning only the
   round whose incoming state is true).  (c) attn-v1 and moe-v1 (default
   widths, B=8, T=128, float32) at 1 x 4 with SP_ATTN ring and ulysses:
   the loss and gradients of a step within (b)'s float32 bounds of the
   dense one-process step.  (d) DaNet.separate_sp on a 10 s request (T=1252
   frames, float32) for bilstm-orig (the relay) and attn-v1 (ring) on the
   four ranks against separate on one process, within 1e-4 of the
   answer's peak.
29. sequence parallelism of tcn-v1, dprnn-v1, conv-bilstm-v1 and tasnet-v1
   (parallel/seq_parallel.py's tcn_stack_sp, dprnn_stack_sp and
   conv_bilstm_sp, TasNet._forward_sp) on one card, four ranks sharing it
   over gloo as in 28, toy data.  (a) configs/tcn.json (12 blocks, 256 /
   512; T=128: 32-frame chunks at 1 x 4 against a largest span of 16),
   configs/dprnn.json with DPRNN_HOP 64 (4 blocks, 2 x 128; T=256, the
   mesh's effective_bucket), conv-bilstm-v1 at FFT_SIZE 256 (T=128) and
   tasnet-v1 at its default widths (T=128), B=8, each a train and a valid
   step at 1 x 4 and 2 x 2 (data x seq) against the same step on one
   process: float32 (phase 28's bounds) and each file's bfloat16 (phase
   27's), from phase 21 (b)'s well-conditioned start (ANCHOR_AUX_LOSS 0,
   whose term jumps even in float64 at the files' 0.5, RELU_LEAKAGE
   COMPARE_LEAKAGE, HEAD_SCALE's head); the ranks' parameters bit for bit;
   each rank's launches asserted: dprnn-v1 8 of kernels 2, 3 and B
   (intra and inter scans of 4 blocks), conv-bilstm-v1 4 state-entry
   saving forwards, 4 seeded backwards and 4 state-entry lean forwards
   (the relay), none for tcn-v1 and tasnet-v1.  tcn-v1 and dprnn-v1 at
   their files' own keys (bfloat16, ANCHOR_AUX_LOSS 0.5, kmeans, the head
   as initialised) at 1 x 4 are printed as a reading, not held, beside the
   one-process step's own move under a 1e-6 relative change of the input.  (b)
   tasnet-v1's separate_wav on a 10 s request on the four ranks at 1 x 4
   and 2 x 2 against one process, within 1e-4 of the answer's peak.  (c)
   the scan kernels at the shapes (a) gives them, against their plain
   versions: dprnn-v1's kernels B, 2 and 3 (H=128) at the intra scan's
   (T=64, 8 rows) and the inter scan's (T=4, 128 rows) on each of the
   four ranks (phase 4's and phase 6's bounds), and conv-bilstm-v1's
   relay (H=256) at a rank's chunk, (T=8, B=8) at 1 x 4 and (T=16, B=4)
   at 2 x 2: the state-form saving forward, the seeded kernel 3 and the
   lean state entry as in 28 (a), float32 and bfloat16 each.

Before the kernels line the script prints each phase function's wall
seconds.

The kernel summary lists all sixteen kernels; its launches count the
main paths of phases 5, 7, 10, 11, 14, 15, 17, 18, 19, 20 (20: (a),
(c), (d)'s resume and (e)), 21 ((b) and (c)'s card-vs-CPU part), 22
((a), (c) and (d)), 23 (every serving and card-vs-CPU training part,
the CLI), 24 ((b)'s timed streams, (c) and (d)'s demos on the card),
25 ((b)-(g): the bundles' checked requests and feeds, kernel 6's
caller, the CLI), 26 (a) (the mesh trainer's steps; (b)'s ranks count
in their own processes, printed per rank) and 27 (a) (the four stage
ranks' steps and valid steps, counted in their processes and summed) and
28 (b) (the four sequence-parallel ranks' steps and valid steps, counted
in their processes and summed) and 29 (a) (dprnn-v1's and conv-bilstm-v1's
held steps and valid steps on the four ranks, likewise).
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
PEAK_BF16_FLOPS = 989e12   # dense, on the tensor cores
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
    "lstm_scan_train_state": cuda_lstm.lstm_scan_train_state,
    "lstm_scan_bwd_seeded": cuda_lstm.lstm_scan_bwd_seeded,
    "gru_scan": cuda_gru.gru_scan,
    "gru_scan_train": cuda_gru.gru_scan_train,
    "gru_scan_bwd": cuda_gru.gru_scan_bwd,
    "flash_attn": cuda_attn.flash_attn,
    "flash_attn_bwd_dkv": cuda_attn.flash_attn_bwd_dkv,
    "flash_attn_bwd_dq": cuda_attn.flash_attn_bwd_dq,
    "stft_logmag": cuda_stft.stft_logmag,
}
# the kernels gru-v1 and attn-v1 (moe-v1: the same attention) launch once
# per layer: (in serving and in valid_step, in a train step), the attention
# only on its flash path; the LSTM encoders' by ``_scan_launches``
ENCODER_KERNELS = {
    "gru-v1": (("gru_scan",), ("gru_scan_train", "gru_scan_bwd")),
    "attn-v1": (("flash_attn",), ("flash_attn", "flash_attn_bwd_dkv",
                                  "flash_attn_bwd_dq")),
}
ENCODER_KERNELS["moe-v1"] = ENCODER_KERNELS["attn-v1"]
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
        out = "%d blocks x dim %d, %d heads of %d, MLP x%d, ATTN_BACKEND " \
            "%s" % (layers, d, heads, d // heads, mlp, hp.ATTN_BACKEND)
        if enc._causal_window():
            out += ", ATTN_CAUSAL (ATTN_LOOKBACK %d, ATTN_LOCAL_CHUNK %s)" \
                % (enc._causal_window(), hp.ATTN_LOCAL_CHUNK)
        if isinstance(enc, encoders.MoEAttentionEncoder):
            out += ", %d experts, MOE_TOP_K %s, MOE_CAPACITY_FACTOR %s" % (
                enc._n_experts(), hp.MOE_TOP_K, hp.MOE_CAPACITY_FACTOR)
        return out
    return "%d layers x %d units" % (enc.N_LAYERS, enc.HDIM)


def _lstm_launches(rows: int, hdim: int, dt, train: bool,
                   n_dirs: int) -> dict:
    """The launches of one (Bi)LSTM layer over ``rows`` batch rows: a
    batch whose row groups would pass a kernel's row ceiling is split
    across launches (``launch_plan``)."""
    pre, dev = "bi" if n_dirs == 2 else "", torch.device("cuda")

    def n(kind):
        return len(cuda_lstm.launch_plan(dev, rows, hdim, n_dirs, dt, kind))
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
    elif isinstance(enc, encoders.AttentionEncoder) and (
            enc._causal_window() or cuda_attn.resolve_attn_fn(hp, t, None)
            is not cuda_attn.flash_attention_masked):
        pass                         # the dense attention or the band
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
                 keys: dict, batches=None) -> dict:
    """One COMPUTE_DTYPE of a training phase: card vs CPU, launch counts;
    ``synced``: the CPU starts each step from the card's state, and each
    step's gradients and optimizer step are checked (phase 11).
    ``batches``: TRAIN_STEPS + 1 prepared batches of one frame count, by
    default the toy dataset's (TRAIN_T frames)."""
    hp = load_config(ENCODER_TYPE=encoder, COMPUTE_DTYPE=dtype, **keys)
    model = hp.get_model()(hp)
    want_t = TRAIN_T if batches is None else batches[0].shape[2]
    batches = _toy_batches(hp, TRAIN_STEPS + 1) if batches is None \
        else batches
    frames = sorted({b.shape[2] for b in batches})
    if frames != [want_t]:         # the flash path takes T % 128 == 0 only
        raise AssertionError("phase %d batches of %s frames, want %d"
                             % (phase, frames, want_t))
    p0 = weights.to_jax(_init(model))
    gpu, cpu = Trainer(model, hp, "cuda"), Trainer(model, hp, "cpu")
    sg, sc = gpu.init_state(params=p0), cpu.init_state(params=p0)
    if synced:
        _record_grads(sg["opt"])
        _record_grads(sc["opt"], apply=lambda: sg["opt"].recorded)
    names = ["/".join(k) for k in _paths(p0)]
    step_want = _scan_launches(model, hp.BATCH_SIZE, want_t, True)
    valid_want = _scan_launches(model, hp.BATCH_SIZE, want_t, False)
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
    plain version, and its time (its caller runs in phase 25 (f))."""
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


def _graph_vs_eager(tag: str, keys: dict, k: int, phase: int = 19,
                    batches=None) -> dict:
    """One K-step graph call against K eager train steps on the card from
    one state (DROPOUT_KEEP_PROB 1, float32): every parameter, Adam moment
    and per-step metric bit for bit.  Also checks the launches the first
    call counted: the eager warm-up step's and the capture's, K steps'
    worth (one replay's).  ``batches``: K prepared batches, by default
    synth-speech's."""
    hp = load_config(**dict(keys, COMPUTE_DTYPE="float32",
                            DROPOUT_KEEP_PROB=1.0))
    model = hp.get_model()(hp)
    p0 = weights.to_jax(model.init(torch.Generator().manual_seed(0)))
    batches = _speech_batches(hp, k) if batches is None else batches
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
    (B=64, bfloat16, DROPOUT_KEEP_PROB 0.9) in three setups, on tpu.json's
    flash attention, printed beside the card's name and power limit.  The synthetic batches of both wires are made first (set-up:
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
    for attn in ("flash",):
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
          "losses bit for bit; the loop's step_time (wall between fetches) "
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
# (c): tcn-v1 and dprnn-v1 at their files' keys as written (their leaky
# ReLUs, the head as initialised) in float64, card against CPU, at this
# batch (``_float64_step``); float64 runs the LSTMs' plain scan
# (LSTM_BACKEND 'xla'): the kernels take float32 and bfloat16.  At these
# inits the files' ANCHOR_AUX_LOSS term (kmeans attractors) makes even
# float64 gradients jump: on the CPU alone a 1e-13 relative change of the
# input moves tcn-v1's by 1.2e-4 of their peak and dprnn-v1's by 7.8e-5,
# against 1.3e-11 and 4.9e-12 at ANCHOR_AUX_LOSS 0.  So the step at the
# files' keys prints that move beside a miss and records it (ROADMAP queue
# 3) instead of failing, and the same step at ANCHOR_AUX_LOSS 0, all else
# as written (the leaky ReLUs included), is held
V2_F64_B = 4
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


def _nn_lstm_ms(rs, t: int, b: int, h: int, i_dim: int, n_dirs: int,
                dt=torch.float32):
    """torch.nn.LSTM (cuDNN, tanh candidate) at this shape in ``dt``, ms:
    the inference forward, the training forward and the backward to the
    input (each also computes the input projection)."""
    lstm = torch.nn.LSTM(i_dim, h, bidirectional=n_dirs == 2).cuda().to(dt)
    lstm.flatten_parameters()   # one weight buffer, as cuDNN wants it
    x = torch.from_numpy(rs.randn(t, b, i_dim).astype(np.float32)).cuda() \
        .to(dt)
    with torch.no_grad():
        lean = cuda_ms(lambda: lstm(x), 10)
    xt = x.clone().requires_grad_(True)
    fwd = cuda_ms(lambda: lstm(xt), 10)
    y, _ = lstm(xt)
    g = torch.randn_like(y)
    bwd = cuda_ms(lambda: torch.autograd.grad(y, xt, g, retain_graph=True),
                  10)
    return lean, fwd, bwd


def _as_tuple(v) -> tuple:
    return v if isinstance(v, tuple) else (v,)


def _new_shape_kernels() -> dict:
    """Phase 21 (a): the lean, saving and backward LSTM kernels at the new
    encoders' shapes against their plain versions, phase 4's and 6's
    tolerances, both dtypes; each launch's row groups G, and every output
    of a launch with G > 1 bit for bit against the G = 1 launch (the
    wrappers' ``groups=1``); both dtypes timed beside nn.LSTM in the same
    dtype and each call's bound, float32 also beside the plain versions."""
    rs = np.random.RandomState(21)
    worst, times = {}, {}
    kinds = ("lean", "save", "bwd")
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
            plans = [cuda_lstm.launch_plan(xp.device, b, h, nd, dt, kind)
                     for kind in kinds]
            groups = []
            for name, k, a, out, plan in zip(names, kern,
                                             (args, args, bargs),
                                             (lean, fwd, bwd), plans):
                same = ""
                if any(g > 1 for _, g in plan):
                    one = _as_tuple(k(*a, groups=1))
                    torch.cuda.synchronize()
                    if not all(torch.equal(x, y) for x, y in
                               zip(_as_tuple(out), one)):
                        raise AssertionError(
                            "phase 21 %s %s: the launch with row groups %s "
                            "differs from the G = 1 launch" % (name, tag,
                                                               plan))
                    same = ", bit for bit the G = 1 launch's"
                groups.append("%s (rows, G) %s%s" % (name, plan, same))
            line = "phase 21 (a) %s max_abs_err: %s; launches %s; %s" % (
                tag, ", ".join(parts), calls, "; ".join(groups))
            lib = _nn_lstm_ms(rs, t, b, h, i_dim, nd, dt)
            f32 = dt == torch.float32
            for name, k, p, a, lib_ms in zip(
                    names, kern, plain, (args, args, bargs), lib):
                ms = cuda_ms(lambda: k(*a), 10)
                plain_ms = cuda_ms(lambda: p(*a), 2) if f32 else None
                flops, nbytes = _cost(name, t, b, h)
                bound_ms, by = _bound(flops, nbytes) if f32 else _bound(
                    flops, nbytes / 2, PEAK_BF16_FLOPS)
                times[(what, t, b, name, dt)] = (ms, plain_ms, lib_ms,
                                                 bound_ms)
                line += ("; %s %.4f ms (%.3f us/step)%s, nn.LSTM %.4f ms, "
                         "bound %.4f ms (%s)"
                         % (name, ms, 1e3 * ms / t, ", plain %.4f ms"
                            % plain_ms if f32 else "", lib_ms, bound_ms,
                            by))
            print(line)
    print("phase 21 (a) nn.LSTM(%s): torch.nn.LSTM (cuDNN) in the line's "
          "dtype, the inference forward beside the lean kernel, the "
          "training forward beside the saving one, the backward to the "
          "input beside kernel 3; each also computes the input projection; "
          "bfloat16 bounds at the bfloat16 tensor-core peak and 2-byte "
          "elements" % ", ".join(
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
    float64 = {}
    for encoder in ("tcn-v1", "dprnn-v1"):
        keys = dict(_v2_keys(encoder), ENCODER_TYPE=encoder)
        tag = "phase 21 (c) %s at configs/%s's keys (RELU_LEAKAGE %g, the " \
            "head as initialised" % (encoder, V2_CONFIGS[encoder],
                                     load_config(**keys).RELU_LEAKAGE)
        float64[encoder] = _float64_step(tag + ")", keys, V2_F64_B,
                                         {"LSTM_BACKEND": "xla"}, hold=False)
        float64[encoder + " ANCHOR_AUX_LOSS 0"] = _float64_step(
            tag + ", ANCHOR_AUX_LOSS 0)", dict(keys, ANCHOR_AUX_LOSS=0.0),
            V2_F64_B, {"LSTM_BACKEND": "xla"})
    _graph_vs_eager("(c) conv-bilstm-v1 B=32", CONV_GRAPH, 8, phase=21)
    remat = _remat_phase()
    launches = {name: sum(run["launches"][name] for run in
                          list(serving.values()) + list(training.values()))
                for name in KERNELS}
    print("phase 21 took %.1f s on %s; main-path launches %s"
          % (time.perf_counter() - t0, nvidia_smi(),
             {k: v for k, v in launches.items() if v}))
    return {"conv_rel": conv_rel, "serving": serving, "training": training,
            "remat": remat, "launches": launches, "float64": float64}


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


def _float64_grads(keys: dict, b: int, dev: str, dt: str, p0, batch):
    """(loss, gradients as float64 on the CPU) of one train step from
    parameters ``p0`` on ``batch`` at ``keys``, in ``dt`` on ``dev``."""
    hp = load_config(**dict(keys, BATCH_SIZE=b, COMPUTE_DTYPE=dt, FLOATX=dt))
    model = hp.get_model()(hp)
    tdt = getattr(torch, dt)
    params = weights.from_jax(p0, dev)
    leaves = weights.leaves(params)
    for p in leaves:
        p.data = p.data.to(tdt)
        p.requires_grad_(True)
    loss, _ = model.train_loss(params, torch.from_numpy(batch).to(dev, tdt))
    # a parameter the loss does not reach (the inference estimator's
    # anchors at ANCHOR_AUX_LOSS 0) has a zero gradient
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [
        torch.zeros(p.shape, dtype=torch.float64) if g is None
        else g.detach().double().cpu() for p, g in zip(leaves, grads)]


def _float64_step(tag: str, keys: dict, b: int, f64_keys=None,
                  hold: bool = True) -> dict:
    """One train step's loss and gradients from one state (seed 0, no
    dropout: no generator) on a toy batch of ``b``, at ``keys``: the card
    in float64 against the CPU in float64 (the port's plain path with
    COMPUTE_DTYPE and FLOATX float64, and ``f64_keys``), the loss to
    STEP_RTOL's 1e-4 and each gradient to 1e-4 of its peak (phase 11's
    bounds); then the card's and the CPU's float32 against the same
    float64 step, printed (the loss held to 1e-4; the gradients are not
    held to a bound: a leaky ReLU's kink turns one rounding into a jump,
    in the CPU's own float32 too).  The line names the first tensor, in
    parameter order, beyond the bound.  ``hold`` False: a float64 gradient
    beyond the bound is printed as not held (a finding the caller records)
    beside the CPU's own float64 gradients' move under a 1e-13 relative
    change of the input, and does not fail.  -> {(device, dtype): (loss
    relative error, worst gradient share of its peak)}."""
    batch = _toy_batches(load_config(BATCH_SIZE=b), 1)[0]
    hp = load_config(**dict(keys, BATCH_SIZE=b))
    p0 = weights.to_jax(hp.get_model()(hp).init(
        torch.Generator().manual_seed(0)))
    res = {}
    for dev, dt in (("cpu", "float64"), ("cuda", "float64"),
                    ("cuda", "float32"), ("cpu", "float32")):
        extra = (f64_keys or {}) if dt == "float64" else {}
        res[(dev, dt)] = _float64_grads(dict(keys, **extra), b, dev, dt, p0,
                                        batch)
    names = ["/".join(k) for k in _paths(p0)]
    ref_loss, ref_grads = res[("cpu", "float64")]

    def shares(grads):
        return [(float((g - r).abs().max()) / max(float(r.abs().max()),
                                                  1e-300), n)
                for g, r, n in zip(grads, ref_grads, names)]
    out = {}
    for key in (("cuda", "float64"), ("cuda", "float32"), ("cpu", "float32")):
        loss, grads = res[key]
        rel = _rel(loss, ref_loss)
        per = shares(grads)
        share, name = max(per)
        over = [n for v, n in per if v > 1e-4]
        out[key] = (rel, share)
        line = ("%s, B=%d: the %s in %s vs the CPU in float64: loss %.12g vs "
                "%.12g, relative err %.3g (bound %g); gradients worst %.3g of "
                "the tensor's peak (%s), %d of %d tensors beyond 1e-4%s"
                % (tag, b, "card" if key[0] == "cuda" else "CPU", key[1],
                   loss, ref_loss, rel, STEP_RTOL["float32"], share, name,
                   len(over), len(names),
                   ", the first %s" % over[0] if over else ""))
        held = key == ("cuda", "float64")
        if held and over and not hold:
            moved = max(shares(_float64_grads(
                dict(keys, **(f64_keys or {})), b, "cpu", "float64", p0,
                batch.astype(np.float64) * (1 + 1e-13))[1]))
            line += ("; NOT HELD (recorded in ROADMAP queue 3): the CPU's own "
                     "float64 gradients move by %.3g of the peak (%s) under "
                     "a 1e-13 relative change of the input" % moved)
            held = False
        print(line)
        if not np.isfinite(loss) or not rel <= STEP_RTOL["float32"] \
                or (held and not share <= 1e-4):
            raise AssertionError(line)
    return out


def _tasnet_float64() -> dict:
    """(b): at the config's keys (RELU_LEAKAGE 0.3), ``_float64_step`` on a
    toy batch of TASNET_CMP_B."""
    return _float64_step("phase 22 (b) RELU_LEAKAGE 0.3", TASNET,
                         TASNET_CMP_B)


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


# ---------------------------------------------------------------- phase 23
# (a): causal attn-v1 at configs/attn.json's widths (default.json's: 4
# blocks of width 256, 4 heads of 64, MLP x4), ATTN_LOOKBACK 128, the rest
# of default.json (the anchor estimator, float32 unless stated)
CAUSAL = {"ATTN_CAUSAL": True, "ATTN_LOOKBACK": 128, "ATTN_LOCAL_CHUNK": 0}
CAUSAL_DENSE = dict(CAUSAL, ATTN_LOCAL_CHUNK=-1)
# (a): 10 s (T=1251 = 9 x 139: 9 chunks of 139) and 524,224 samples
# (T=8192: 64 chunks of 128), each at B=1
CAUSAL_REQUESTS = [(1, 10 * SMPRATE), (1, 524224)]
# (a): phase 11's protocol at (B, T), float32: 8 chunks of 128
CAUSAL_CMP = (4, 1024)
# (a): step time and peak memory at B=4, the shapes of
# benchmarks/long_context.py: (T, ATTN_LOCAL_CHUNK), chunked and dense
CAUSAL_COSTS = [(2048, 0), (4096, 0), (8192, 0), (2048, -1), (4096, -1)]
# (a): one 8-step CUDA graph call against 8 eager steps at this T
CAUSAL_GRAPH_T = 2048
# (b): configs/moe-ep.json with its expert-parallel mesh reset to one card
MOE_JSON = os.path.join(REPO_ROOT, "configs", "moe-ep.json")
MOE_ONE_CARD = {"MESH_DATA": 1, "MESH_EXPERT": 1}
ROUTED = {"MOE_TOP_K": 2, "MOE_CAPACITY_FACTOR": 1.25}


def _white_batches(hp, n: int, t: int, seed: int = 23) -> list:
    """n prepared [B, N, t, F, 2] batches of the toy dataset's white-noise
    spectra at t frames."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        flat = rng.rand(hp.BATCH_SIZE * hp.MAX_N_SIGNAL, t,
                        hp.FEATURE_SIZE).astype(np.float32)
        out.append(prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL,
                                 max_len=t, bucket=t, rng=rng))
    return out


def _chunks(t: int) -> str:
    from danet_tpu_torch.ops.local_attention import pick_chunk
    c = pick_chunk(t, CAUSAL["ATTN_LOOKBACK"])
    return "T=%d: %d chunks of %d" % (t, t // c, c)


def _causal_serving() -> dict:
    """(a) serving: CAUSAL_REQUESTS against the CPU (phase 5's bounds),
    each beside the dense band's latency; then the 10 s request's chunked
    and dense-band answers and embeddings on the card against each other
    at SERVE_RTOL of the peak (the same terms, summed in other orders)."""
    print("phase 23 (a) causal attn-v1 serving: %s" % "; ".join(
        _chunks(stft_frame_count(n, 256, 64)) for _, n in CAUSAL_REQUESTS))
    out = _serve(23, "attn-v1", CAUSAL_REQUESTS, 23, CAUSAL, CAUSAL_DENSE)
    wav = _mixture(np.random.RandomState(23), *CAUSAL_REQUESTS[0])
    seps = {}
    for name, keys in (("chunked", CAUSAL), ("dense", CAUSAL_DENSE)):
        hp = load_config(ENCODER_TYPE="attn-v1", **keys)
        model = hp.get_model()(hp)
        seps[name] = Separator(model, _init(model), "cuda")
    waves = {k: v.separate(wav) for k, v in seps.items()}
    embeds = {k: _embeddings(v, wav) for k, v in seps.items()}
    w_peak = float(np.abs(waves["dense"]).max())
    w_err = float(np.abs(waves["chunked"] - waves["dense"]).max())
    e_peak = float(embeds["dense"].abs().max())
    e_err = max_err(embeds["chunked"], embeds["dense"])
    line = ("phase 23 (a) 10 s request on the card, chunked vs dense band: "
            "wave max_abs_err %.3g (peak %.3g), embedding max_abs_err %.3g "
            "(peak %.3g), bound %g of the peak"
            % (w_err, w_peak, e_err, e_peak, SERVE_RTOL))
    print(line)
    if not w_err <= SERVE_RTOL * w_peak or not e_err <= SERVE_RTOL * e_peak:
        raise AssertionError(line)
    out["chunked_vs_dense"] = max(w_err / w_peak, e_err / e_peak)
    return out


def _causal_cost(t: int, chunk: int, dtype: str, reps: int = 3) -> tuple:
    """(ms, peak MiB, MiB above the state) of a causal attn-v1 train step
    at B=4, t frames of white noise on the card (median of ``reps`` after
    a warm-up)."""
    hp = load_config(ENCODER_TYPE="attn-v1", COMPUTE_DTYPE=dtype,
                     BATCH_SIZE=4, MAX_TRAIN_LEN=t, TIME_BUCKET=t,
                     **dict(CAUSAL, ATTN_LOCAL_CHUNK=chunk))
    tr = Trainer(hp.get_model()(hp), hp, "cuda")
    st = tr.init_state(torch.Generator().manual_seed(0))
    batch = tr._put(tr._host_batch(_white_batches(hp, 1, t)[0]))
    tr.train_step(st, batch)                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        m = tr.train_step(st, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(float(m["loss"])):
        raise AssertionError("phase 23 (a) T=%d chunk %d %s: loss %s"
                             % (t, chunk, dtype, m["loss"]))
    del tr, st, batch
    torch.cuda.empty_cache()
    return float(np.median(ms)), peak / 2 ** 20, (peak - held) / 2 ** 20


def _causal_training() -> dict:
    """(a) training: phase 11's protocol at CAUSAL_CMP, float32, chunked;
    the step costs of CAUSAL_COSTS; one 8-step graph call against 8 eager
    steps at CAUSAL_GRAPH_T."""
    b, t = CAUSAL_CMP
    keys = dict(CAUSAL, BATCH_SIZE=b, MAX_TRAIN_LEN=t, TIME_BUCKET=t)
    hp = load_config(ENCODER_TYPE="attn-v1", **keys)
    print("phase 23 (a) causal attn-v1 training, %s, B=%d"
          % (_chunks(t), b))
    _zero_counts()
    run = _train_dtype(23, "attn-v1", "float32", True, keys,
                       _white_batches(hp, TRAIN_STEPS + 1, t))
    launches = _counts()
    costs = {}
    for t_c, chunk in CAUSAL_COSTS:
        for dt in ("float32", "bfloat16"):
            costs[(t_c, chunk, dt)] = c = _causal_cost(t_c, chunk, dt)
            print("phase 23 (a) causal attn-v1 train step B=4 T=%d %s %s: "
                  "%.3f ms (median of 3), peak device memory %.1f MiB (%.1f "
                  "above the state); %s"
                  % (t_c, "chunked (%s)" % _chunks(t_c) if chunk == 0
                     else "dense band", dt, c[0], c[1], c[2], nvidia_smi()))
    tg = CAUSAL_GRAPH_T
    gkeys = dict(CAUSAL, ENCODER_TYPE="attn-v1", BATCH_SIZE=4,
                 MAX_TRAIN_LEN=tg, TIME_BUCKET=tg)
    _graph_vs_eager("(a) causal attn-v1 B=4 T=%d chunked" % tg, gkeys, 8,
                    phase=23, batches=_white_batches(load_config(**gkeys), 8,
                                                     tg))
    return {"step_rel": run["worst_step_rel"], "grad_rel": run["grad_rel"],
            "costs": costs, "launches": launches}


def _moe_keys(**extra) -> dict:
    """configs/moe-ep.json's keys as written but ENCODER_TYPE and
    COMPUTE_DTYPE (which each part sets), MOE_ONE_CARD over them, then
    ``extra``."""
    with open(MOE_JSON) as f:
        keys = json.load(f)
    if keys.pop("ENCODER_TYPE") != "moe-v1":
        raise AssertionError("configs/moe-ep.json names another encoder")
    keys.pop("COMPUTE_DTYPE")
    keys.update(MOE_ONE_CARD)
    keys.update(extra)
    return keys


def _moe_flash_training() -> dict:
    """(b) moe-v1 on the flash path: phase 11's protocol in float32 (3
    steps and a valid step, each counted: kernels 5f, 5dkv and 5dq once
    per block and step, 5f once per block in the valid step), then the
    step times beside the dense attention's."""
    keys = _moe_keys(DROPOUT_KEEP_PROB=1.0, **FLASH)
    _zero_counts()
    run = _train_dtype(23, "moe-v1", "float32", True, keys)
    launches = _counts()
    times = {}
    for dt in ("float32", "bfloat16"):
        times[dt] = (_step_ms("moe-v1", dt, keys, 5),
                     _step_ms("moe-v1", dt, _moe_keys(**DENSE), 3))
        print("phase 23 (b) moe-v1 %s train step (B=16, T=128) on the flash "
              "path %.3f ms, dense attention %.3f ms (medians; %s)"
              % ((dt,) + times[dt] + (nvidia_smi(),)))
    return {"step_rel": run["worst_step_rel"], "grad_rel": run["grad_rel"],
            "times": times, "launches": launches}


def _moe_cli(tmp: str) -> dict:
    """(b) the CLI: ``python -m danet_tpu_torch -c configs/moe-ep.json
    --set MESH_DATA=1 --set MESH_EXPERT=1 -m train -ds toy -ne 1`` (main
    in this process), ``-m test`` from its checkpoint, then ``serve run``
    on one WAV on the card and on the CPU (``--device cpu``) from the same
    checkpoint, in float32 (a layered file, as the comparison needs):
    the two int16 WAVs within one step of each other, and the card's
    Separator against the CPU's at SERVE_RTOL of the peak."""
    import scipy.io.wavfile
    from danet_tpu_torch import serve
    from danet_tpu_torch.data import audio
    sets = ["--set", "MESH_DATA=1", "--set", "MESH_EXPERT=1"]
    ckpt = os.path.join(tmp, "moe-ckpt")
    t0 = time.perf_counter()
    text, launches, _ = _main_path(
        lambda: _port_cli(["-m", "train", "-ds", "toy", "-ne", "1", "-c",
                           MOE_JSON] + sets + ["-n", "moe", "-o", ckpt,
                                               "--no-save-on-epoch"], tmp),
        per_step={})
    train_s = time.perf_counter() - t0
    text += _port_cli(["-m", "test", "-ds", "toy", "-c", MOE_JSON] + sets
                      + ["-i", ckpt], tmp)
    epoch = [ln for ln in text.splitlines()
             if ln.startswith(("Epoch", "Valid", "Test: "))]
    vals = [float(p.split("=")[1]) for ln in epoch for p in ln.split()
            if "=" in p]
    line = ("phase 23 (b) CLI -c configs/moe-ep.json %s -m train -ds toy -ne "
            "1 (%.1f s), then -m test: %s" % (" ".join(sets), train_s, epoch))
    print(line)
    if len(epoch) != 3 or "nan" in text.lower() \
            or not all(np.isfinite(vals)):
        raise AssertionError(line + "\n" + text[-3000:])
    f32 = os.path.join(tmp, "one-card-float32.json")
    with open(f32, "w") as f:
        json.dump(dict(MOE_ONE_CARD, COMPUTE_DTYPE="float32"), f)
    wav = os.path.join(tmp, "mix.wav")
    x = _mixture(np.random.RandomState(233), 1, 4 * SMPRATE)[0]
    scipy.io.wavfile.write(wav, SMPRATE, np.round(x * 16000).astype(
        np.int16))
    served = {}

    def run():
        for dev in ("cuda", "cpu"):
            serve._main(["run", "-c", MOE_JSON, "-c", f32, "-w", ckpt, "-if",
                         wav, "-o", os.path.join(tmp, "served-" + dev),
                         "--device", dev])
            served[dev] = [scipy.io.wavfile.read(os.path.join(
                tmp, "served-%s_%d.wav" % (dev, i)))[1] for i in range(2)]
    _, serve_launches, _ = _main_path(run, per_step={})
    lsb = max(int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
              for a, b in zip(served["cuda"], served["cpu"]))
    xs = audio.load_wav_raw(wav, SMPRATE)
    ref = serve.load_separator(ckpt, [MOE_JSON, f32], "cpu").separate(xs)
    got = serve.load_separator(ckpt, [MOE_JSON, f32], "cuda").separate(xs)
    peak = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    line = ("phase 23 (b) serve run -c configs/moe-ep.json -c <%s>: %s on "
            "the card, the CPU's %s, max |card - CPU| %d int16 steps (bound "
            "1); the card's Separator vs the CPU's from the checkpoint "
            "max_abs_err %.3g (peak %.3g, rtol %g); launches %s"
            % (json.dumps(dict(MOE_ONE_CARD, COMPUTE_DTYPE="float32")),
               [s.shape for s in served["cuda"]],
               [s.shape for s in served["cpu"]], lsb, err, peak, SERVE_RTOL,
               {k: v for k, v in serve_launches.items() if v}))
    print(line)
    if [s.shape for s in served["cuda"]] != [(4 * SMPRATE,)] * 2 \
            or lsb > 1 or not err <= SERVE_RTOL * peak \
            or serve_launches["stft_ri"] != 1:
        raise AssertionError(line)
    return {n: launches[n] + serve_launches[n] for n in KERNELS}


def _moe() -> dict:
    """(b) moe-v1 at configs/moe-ep.json's widths on one card."""
    print("phase 23 (b) moe-v1: configs/moe-ep.json with %s: %s"
          % (MOE_ONE_CARD, _moe_keys()))
    out = {"serving": {}, "training": {}}
    for name, extra, seed in (("soft", {}, 231), ("routed", ROUTED, 232)):
        keys = _moe_keys(**extra)
        out["serving"][name] = _serve(
            23, "moe-v1", [(1, 10 * SMPRATE), (4, 4 * SMPRATE)], seed,
            dict(keys, COMPUTE_DTYPE="float32"),
            dict(keys, COMPUTE_DTYPE="bfloat16"))
        out["training"][name] = _train(23, "moe-v1", 5, 0, True,
                                       dict(keys, DROPOUT_KEEP_PROB=1.0))
    gkeys = _moe_keys(ENCODER_TYPE="moe-v1", **ROUTED)
    _graph_vs_eager("(b) moe-v1 top-2 routed B=16", gkeys, 8, phase=23,
                    batches=_toy_batches(load_config(**gkeys), 8))
    out["serving"]["flash"] = _serve(
        23, "moe-v1", [(1, 81856), (4, 32704)], 233,
        _moe_keys(COMPUTE_DTYPE="float32", **FLASH),
        _moe_keys(COMPUTE_DTYPE="float32", **DENSE))
    out["training"]["flash"] = _moe_flash_training()
    return out


def phase_causal_moe() -> dict:
    """Phase 23: causal attn-v1 and moe-v1 (module docstring)."""
    import shutil
    import tempfile
    t0 = clock = time.perf_counter()
    times = {}
    tmp = tempfile.mkdtemp(prefix="danet-phase23-")
    try:
        serving = _causal_serving()
        training = _causal_training()
        times["(a)"], clock = time.perf_counter() - clock, time.perf_counter()
        moe = _moe()
        cli = _moe_cli(tmp)
        times["(b)"] = time.perf_counter() - clock
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs = [serving, training] + list(moe["serving"].values()) \
        + list(moe["training"].values())
    launches = {n: sum(r["launches"][n] for r in runs) + cli[n]
                for n in KERNELS}
    print("phase 23 took %.1f s (%s) on %s; main-path launches %s"
          % (time.perf_counter() - t0, ", ".join(
              "%s %.1f s" % kv for kv in times.items()), nvidia_smi(),
             {k: v for k, v in launches.items() if v}))
    if not launches["flash_attn"] or not launches["flash_attn_bwd_dq"] \
            or not launches["stft_ri"]:
        raise AssertionError("phase 23: kernels A, 5f, 5dkv and 5dq must "
                             "run on its main paths: %s" % launches)
    return {"causal": {"serving": serving, "training": training},
            "moe": moe, "launches": launches}


# ---------------------------------------------------------------- phase 24
# (a) kernel 1's state entry (lstm_scan with return_state): (T, B) at
# lstm-orig's H=600, then at dprnn-v1's inter shape H=128 (T=1: one stream
# chunk of 64 frames is one segment, B = DPRNN_CHUNK rows; T=3 at 4096 and
# 8192 rows, the second above the float32 row ceiling of 5968: its c_T
# comes from two launches)
CARRY_SHAPES = {600: ((1, 1), (64, 1), (1251, 1), (1, 4), (64, 4),
                      (1251, 4), (128, 32)),
                128: ((1, 64), (3, 4096), (3, 8192))}
# (b) streaming: a 16,384-sample warm-up (256 frames, whole 64-frame
# segments for dprnn-v1), then 16 chunks of 4096 samples (64 frames) to
# 10.24 s at B=1; the chunk-size check against chunks of 1024 samples (16
# frames; dprnn-v1: 8192, 128 frames)
STREAM_WARMUP = 16384
STREAM_CHUNK = 4096
STREAM_FEEDS = 16
STREAM_OTHER = {"dprnn-v1": 8192}
# JAX's chunk-invariance bound (tests/test_modules.py:676)
INVARIANCE_TOL = (2e-5, 1e-4)
# (c) separate_long with bilstm-orig: a 60 s mixture, demo's chunking
LONG_SECONDS = 60
LONG_CHUNK, LONG_OVERLAP = 256, 32


def _stream_keys() -> dict:
    """(b): each causal encoder's keys, float32: lstm-orig and gru-v1 at
    default.json's widths; attn-v1 and moe-v1 at phase 23's (CAUSAL,
    configs/moe-ep.json on one card); tcn-v1 and dprnn-v1 at their config
    files' keys with TCN_CAUSAL, and DPRNN_INTER_CAUSAL with DPRNN_HOP 64
    (= DPRNN_CHUNK: the online variant)."""
    keys = {"lstm-orig": {}, "gru-v1": {}, "attn-v1": dict(CAUSAL),
            "moe-v1": _moe_keys(**CAUSAL),
            "tcn-v1": dict(_v2_keys("tcn-v1"), TCN_CAUSAL=True),
            "dprnn-v1": dict(_v2_keys("dprnn-v1"), DPRNN_INTER_CAUSAL=True,
                             DPRNN_HOP=64)}
    return {enc: dict(k, ENCODER_TYPE=enc, COMPUTE_DTYPE="float32")
            for enc, k in keys.items()}


def _carry_inputs(rs, t, b, h, dtype):
    """Layer-shaped inputs of one one-direction layer (I = H, lstm-orig's
    init scale and gate bias), a nonzero c0 in float32 (the state entry's
    carry; values of the storage dtype, so that the lean entry takes the
    same c0) and a nonzero h0."""
    scale = 1.15 / np.sqrt(h)
    x = rs.randn(t * b, h).astype(np.float32) * 0.5
    wx = rs.uniform(-scale, scale, (h, 4 * h)).astype(np.float32)
    bias = np.repeat(np.array([0.0, 1.5, -1.0, 1.0], np.float32), h)
    xp, wh, h0 = _cuda(((x @ wx + bias).reshape(t, b, 4 * h),
                        rs.uniform(-scale, scale, (h, 4 * h)),
                        rs.uniform(-0.5, 0.5, (b, h))), dtype)
    c0 = torch.from_numpy((rs.randn(b, h) * 0.5).astype(np.float32)).cuda()
    return xp, wh, c0.to(dtype).float(), h0


def _carry_kernels() -> dict:
    """(a) kernel 1's state entry against its plain version: hs and the
    float32 c_T (float32 at LSTM_ATOL, bfloat16 at phase 4's bounds on hs
    and phase 6's forward bounds on c_T, an unbounded f32 carry), and its
    hs bit for bit the lean entry's from the same inputs; the launches of
    each call; in float32 the state entry's time beside the lean one's,
    nn.LSTM's and the bound.  Then kernel 4f's last row from a nonzero c0
    (gru-v1's carry) against its plain version."""
    rs = np.random.RandomState(24)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    times = {}
    for h, shapes in CARRY_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16):
            for tanh in (True, False):
                for t, b in shapes:
                    if h == 128 and not tanh:
                        continue            # dprnn-v1's cell: tanh only
                    xp, wh, c0, h0 = _carry_inputs(rs, t, b, h, dt)
                    before = cuda_lstm.lstm_scan.launches
                    hs, c_t = cuda_lstm.lstm_scan(xp, wh, c0, h0, tanh,
                                                  return_state=True)
                    n = cuda_lstm.lstm_scan.launches - before
                    lean = cuda_lstm.lstm_scan(xp, wh, c0.to(dt), h0, tanh)
                    ref_hs, ref_c = cuda_lstm.lstm_scan_plain(
                        xp, wh, c0, h0, tanh, return_state=True)
                    torch.cuda.synchronize()
                    tag = "H=%d %s" % (h, _tag(dt, tanh, t, b))
                    c_tol = (LSTM_ATOL[dt], 0.0) if dt == torch.float32 \
                        else TRAIN_FWD_TOL[dt]
                    parts = _check_kernels(24, tag, dt, (
                        ("lstm_scan", ("hs",), (hs,), (ref_hs,),
                         (LSTM_ATOL[dt], 0.0)),
                        ("lstm_scan", ("c_T",), (c_t,), (ref_c,), c_tol)),
                        {})
                    worst[dt] = max(worst[dt], max_err(hs, ref_hs),
                                    max_err(c_t, ref_c))
                    same = torch.equal(hs, lean)
                    line = ("phase 24 (a) lstm_scan state %s: max_abs_err %s "
                            "(c_T float32 %s); %d launch%s; hs %s the lean "
                            "entry's" % (tag, ", ".join(parts),
                                         tuple(c_t.shape), n,
                                         "es" if n > 1 else "",
                                         "bit for bit" if same else "NOT"))
                    if not same or c_t.dtype != torch.float32 or n != \
                            len(cuda_lstm.launch_plan(xp.device, b, h, 1, dt,
                                                      "lean")):
                        raise AssertionError(line)
                    if dt == torch.float32 and tanh and (
                            (t, b) in ((1251, 1), (64, 1), (1, 64))):
                        state_ms = cuda_ms(lambda: cuda_lstm.lstm_scan(
                            xp, wh, c0, h0, True, return_state=True), 20)
                        lean_ms = cuda_ms(lambda: cuda_lstm.lstm_scan(
                            xp, wh, c0.to(dt), h0, True), 20)
                        plain_ms = cuda_ms(lambda: cuda_lstm.lstm_scan_plain(
                            xp, wh, c0, h0, True, return_state=True), 2)
                        lib_ms = _nn_lstm_ms(rs, t, b, h, h, 1)[0]
                        bound = _bound(*_cost("lstm_scan", t, b, h))
                        times[(h, t, b)] = (state_ms, lean_ms, plain_ms,
                                            lib_ms, bound)
                        line += ("; state %.4f ms, lean %.4f ms, plain %.4f "
                                 "ms, nn.LSTM %.4f ms, bound %.5f ms (%s)"
                                 % (state_ms, lean_ms, plain_ms, lib_ms,
                                    *bound))
                    print(line)
    gx, cx, wgh, wch, c0, _ = _gru_inputs(rs, 1251, 1, torch.float32)
    cs = cuda_gru.gru_scan(gx, cx, wgh, wch, c0)
    ref = cuda_gru.gru_scan_plain(gx, cx, wgh, wch, c0)
    err = max_err(cs[-1], ref[-1])
    line = ("phase 24 (a) gru_scan H=600 float32 T=1251 B=1 from a nonzero "
            "c0: the carry cs[-1] max_abs_err %.3g (atol %g)"
            % (err, LSTM_ATOL[torch.float32]))
    print(line)
    if not err <= LSTM_ATOL[torch.float32]:
        raise AssertionError(line)
    return {"max_abs_err": worst, "times": times}


class _PlainScans:
    """Counts the plain LSTM and GRU scans run while it is entered (every
    plain forward of ops/cuda/lstm.py and gru.py goes through their
    ``_scan_plain``)."""

    def __enter__(self):
        self.calls = 0
        self.saved = [(m, m._scan_plain) for m in (cuda_lstm, cuda_gru)]
        for mod, fn in self.saved:
            def counted(*a, _fn=fn, **kw):
                self.calls += 1
                return _fn(*a, **kw)
            mod._scan_plain = counted
        return self

    def __exit__(self, *exc):
        for mod, fn in self.saved:
            mod._scan_plain = fn


def _stream_feed_launches(model, frames: int) -> dict:
    """The kernel launches of one feed of ``frames`` frames at B=1: kernel
    1 per lstm-orig layer, 4f per gru-v1 layer, kernels B (the segments'
    rows) and 1 (DPRNN_CHUNK rows) per dprnn-v1 block, each split where it
    exceeds its row ceiling; none for attn-v1, moe-v1 and tcn-v1 (GEMMs
    and convolutions: no TPU kernel on their paths)."""
    enc = model.encoder
    want = {name: 0 for name in KERNELS}
    dt = getattr(torch, model.hp.COMPUTE_DTYPE)

    def add(counts):
        for name, v in counts.items():
            want[name] += v
    if isinstance(enc, encoders.LstmEncoder):
        for _ in range(enc.N_LAYERS):
            add(_lstm_launches(1, enc.HDIM, dt, False, 1))
    elif isinstance(enc, encoders.GruEncoder):
        want["gru_scan"] = enc.N_LAYERS
    elif isinstance(enc, encoders.DprnnEncoder):
        _, h, p, _, blocks, _ = enc._dims()
        for _ in range(blocks):
            add(_lstm_launches(frames // p, h, dt, False, 2))
            add(_lstm_launches(p, h, dt, False, 1))
    return want


def _stream_run(streamer, wav, timed=False):
    """start on the warm-up, then feed every chunk: -> (the samples
    [N, L], ms per feed); with ``timed``, each feed's launches are checked
    against ``_stream_feed_launches``."""
    w, c = streamer.warmup_samples, streamer.chunk_samples
    outs = [streamer.start(wav[:w])[0]]
    want = _stream_feed_launches(streamer.model,
                                 c // streamer.hp.FFT_STRIDE)
    ms = []
    for lo in range(w, len(wav), c):
        before = _counts()
        t0 = time.perf_counter()
        outs.append(streamer.feed(wav[lo:lo + c])[0])   # numpy: synced
        ms.append((time.perf_counter() - t0) * 1e3)
        got = {k: v - before[k] for k, v in _counts().items()}
        if timed and got != want:
            raise AssertionError("phase 24 (b) a feed launched %s, want %s"
                                 % (got, want))
    return np.concatenate(outs, axis=-1), ms


def _stream_cells(tmp: str) -> dict:
    """(b) each causal encoder at full width through serve.load_streamer
    (seeded random weights, as _init, saved with weights.save_npz): the
    card's stream (after a warm-up stream) against the CPU's at SERVE_RTOL
    of the peak, against the card's own at another chunk size at
    INVARIANCE_TOL, each feed's launches counted and no plain scan run;
    the median and p90 ms per feed and the real-time factor."""
    from danet_tpu_torch import serve
    out = {}
    n = STREAM_WARMUP + STREAM_FEEDS * STREAM_CHUNK
    for enc, keys in _stream_keys().items():
        hp = load_config(**keys)
        model = hp.get_model()(hp)
        path = os.path.join(tmp, "stream-%s.npz" % enc)
        weights.save_npz(path, _init(model))
        cfg = os.path.join(tmp, "stream-%s.json" % enc)
        with open(cfg, "w") as f:
            json.dump(keys, f)
        wav = _mixture(np.random.RandomState(240), 1, n)[0]

        def load(device, chunk=STREAM_CHUNK):
            return serve.load_streamer(path, [cfg], chunk, STREAM_WARMUP,
                                       device)
        gpu = load("cuda")
        _stream_run(gpu, wav)                          # warm-up stream
        _zero_counts()
        with _PlainScans() as plain:
            got, ms = _stream_run(gpu, wav, timed=True)
        launches = _counts()
        other_chunk = STREAM_OTHER.get(enc, 1024)
        other, _ = _stream_run(load("cuda", other_chunk), wav)
        ref, _ = _stream_run(load("cpu"), wav)
        peak = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max())
        inv = float(np.abs(other - got).max())
        inv_ratio = float((np.abs(other - got) / (
            INVARIANCE_TOL[0] + INVARIANCE_TOL[1] * np.abs(got))).max())
        med, p90 = float(np.median(ms)), float(np.percentile(ms, 90))
        rtf = (1e3 * STREAM_CHUNK / SMPRATE) / med
        line = ("phase 24 (b) stream %s (%s, estimator %s): warm-up %d + "
                "%d x %d "
                "samples (%.2f s) at B=1, out %s; vs CPU max_abs_err %.3g "
                "(peak %.3g, rtol %g); %d-sample chunks vs %d: max_abs_err "
                "%.3g (atol %g + rtol %g: %.3g of the bound; %.3g of the "
                "peak, bound %g); launches %s, "
                "plain scans %d; per feed median %.3f ms, p90 %.3f ms, "
                "real-time factor %.1f (chunk %.1f ms / feed) on %s"
                % (enc, _describe(hp, model.encoder),
                   hp.INFER_ESTIMATOR_METHOD, STREAM_WARMUP, STREAM_FEEDS,
                   STREAM_CHUNK, n / SMPRATE, got.shape, err, peak,
                   SERVE_RTOL, other_chunk, STREAM_CHUNK, inv,
                   *INVARIANCE_TOL, inv_ratio, inv / peak, SERVE_RTOL,
                   {k: v for k, v in launches.items() if v}, plain.calls,
                   med, p90, rtf, 1e3 * STREAM_CHUNK / SMPRATE,
                   nvidia_smi()))
        print(line)
        if got.shape != (hp.MAX_N_SIGNAL, n) or not np.all(np.isfinite(got)) \
                or not err <= SERVE_RTOL * peak or not inv_ratio <= 1.0 \
                or not inv <= SERVE_RTOL * peak or plain.calls:
            raise AssertionError(line)
        out[enc] = {"launches": launches, "max_rel_err": err / peak,
                    "invariance": inv_ratio, "feed_ms": (med, p90),
                    "rtf": rtf}
    return out


def _separate_long() -> dict:
    """(c) bilstm-orig at full width, separate_long on a 60 s mixture
    (DEMO_CHUNK_FRAMES 256, DEMO_OVERLAP_FRAMES 32: 34 chunks in one
    batch, kernel B once per layer at B = 34) against the CPU at
    SERVE_RTOL of the peak, and its time on the card."""
    hp = load_config(ENCODER_TYPE="bilstm-orig")
    model = hp.get_model()(hp)
    params = _init(model)
    gpu = weights.from_jax(params, "cuda")
    wav = torch.from_numpy(_mixture(np.random.RandomState(241), 1,
                                    LONG_SECONDS * SMPRATE))
    mix_ri = dsp.stft_ri(wav, hp.FFT_SIZE, hp.FFT_STRIDE,
                         hp.FFT_WND_ARRAY)[0]                 # CPU, plain
    t = mix_ri.shape[0]
    n_chunks = max(1, -(-(t - LONG_OVERLAP) // (LONG_CHUNK - LONG_OVERLAP)))
    x = mix_ri.cuda()
    with torch.inference_mode():
        model.separate_long(gpu, x, LONG_CHUNK, LONG_OVERLAP)   # warm-up
        torch.cuda.synchronize()
        _zero_counts()
        with _PlainScans() as plain:
            t0 = time.perf_counter()
            out = model.separate_long(gpu, x, LONG_CHUNK, LONG_OVERLAP)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = _counts()
        ref = model.separate_long(params, mix_ri, LONG_CHUNK, LONG_OVERLAP)
    out = out.cpu()
    peak = float(ref.abs().max())
    err = max_err(out, ref)
    want = dict({k: 0 for k in KERNELS}, bilstm_scan=len(
        cuda_lstm.launch_plan(x.device, n_chunks, 300, 2, torch.float32,
                              "lean")) * model.encoder.N_LAYERS)
    line = ("phase 24 (c) separate_long bilstm-orig %s, %d s (T=%d): %d "
            "chunks of %d frames overlapping by %d in one batch, out %s, "
            "%.3f ms on %s; vs CPU max_abs_err %.3g (peak %.3g, rtol %g); "
            "launches %s, plain scans %d"
            % (_describe(hp, model.encoder), LONG_SECONDS, t, n_chunks,
               LONG_CHUNK, LONG_OVERLAP, tuple(out.shape), ms, nvidia_smi(),
               err, peak, SERVE_RTOL,
               {k: v for k, v in launches.items() if v}, plain.calls))
    print(line)
    if tuple(out.shape) != (hp.MAX_N_SIGNAL, t, hp.FEATURE_SIZE, 2) \
            or not torch.isfinite(out).all() or not err <= SERVE_RTOL * peak \
            or launches != want or plain.calls:
        raise AssertionError(line)
    return {"launches": launches, "max_rel_err": err / peak, "ms": ms,
            "chunks": n_chunks}


def _stream_cli(tmp: str) -> dict:
    """(d) the CLI: -m train -ds toy -ne 1 (lstm-orig, then bilstm-orig),
    then -m demo -if a 4 s int16 WAV with --stream (lstm-orig) and with
    --set DEMO_CHUNK_FRAMES=64 (bilstm-orig) on the card and on the CPU
    (--device cpu) from the same checkpoint: the separated WAVs (in the
    input's int16 scale) within one int16 step of each other."""
    import scipy.io.wavfile
    x = _mixture(np.random.RandomState(242), 1, 4 * SMPRATE)[0]
    pcm = np.round(x * 16000).astype(np.int16)
    total = {k: 0 for k in KERNELS}
    steps = {}
    for enc, extra in (("lstm-orig", ["--stream"]),
                       ("bilstm-orig", ["--set", "DEMO_CHUNK_FRAMES=64"])):
        cfg = os.path.join(tmp, "cli-%s.json" % enc)
        with open(cfg, "w") as f:
            json.dump({"ENCODER_TYPE": enc}, f)
        ckpt = os.path.join(tmp, "cli-%s-ckpt" % enc)
        _port_cli(["-m", "train", "-ds", "toy", "-ne", "1", "-c", cfg, "-o",
                   ckpt, "--no-save-on-epoch", "--no-valid-on-epoch"], tmp)
        wavs = {}
        for dev in ("cuda", "cpu"):
            name = os.path.join(tmp, "cli-%s-%s.wav" % (enc, dev))
            scipy.io.wavfile.write(name, SMPRATE, pcm)
            argv = ["-m", "demo", "-c", cfg, "-i", ckpt, "-if", name] \
                + extra + ["--device", dev]
            if dev == "cuda":
                text, launches, _ = _main_path(
                    lambda: _port_cli(argv, tmp), per_step={})
            else:
                text = _port_cli(argv, tmp)
            base = os.path.splitext(name)[0]
            wavs[dev] = [scipy.io.wavfile.read(
                "%s_separated_%d.wav" % (base, i))[1] for i in (1, 2)]
        steps[enc] = max(float(np.abs(a - b).max())
                         for a, b in zip(wavs["cuda"], wavs["cpu"]))
        peak = max(float(np.abs(b).max()) for b in wavs["cpu"])
        line = ("phase 24 (d) CLI %s: -m demo -if <4 s int16 WAV> %s, card "
                "vs --device cpu from one checkpoint: %s, max |card - CPU| "
                "%.3g int16 steps (bound 1; peak %.1f); launches %s"
                % (enc, " ".join(extra), [w.shape for w in wavs["cuda"]],
                   steps[enc], peak,
                   {k: v for k, v in launches.items() if v}))
        print(line)
        kernel = "lstm_scan" if enc == "lstm-orig" else "bilstm_scan"
        if [w.shape for w in wavs["cuda"]] != [w.shape for w in wavs["cpu"]] \
                or not steps[enc] <= 1.0 or not launches[kernel] \
                or not np.all(np.isfinite(wavs["cuda"])):
            raise AssertionError(line + "\n" + text[-2000:])
        for k in KERNELS:
            total[k] += launches[k]
    return {"launches": total, "int16_steps": steps}


def phase_streaming() -> dict:
    """Phase 24: kernel 1's final carry, causal streaming and long-form
    separation at full width, and the demo's two modes (module
    docstring)."""
    import shutil
    import tempfile
    t0 = clock = time.perf_counter()
    times = {}
    tmp = tempfile.mkdtemp(prefix="danet-phase24-")
    try:
        carry = _carry_kernels()
        times["(a)"], clock = time.perf_counter() - clock, time.perf_counter()
        print("phase 24 (b) keys: %s" % json.dumps(_stream_keys()))
        cells = _stream_cells(tmp)
        times["(b)"], clock = time.perf_counter() - clock, time.perf_counter()
        long_form = _separate_long()
        times["(c)"], clock = time.perf_counter() - clock, time.perf_counter()
        cli = _stream_cli(tmp)
        times["(d)"] = time.perf_counter() - clock
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs = [c["launches"] for c in cells.values()] + [
        long_form["launches"], cli["launches"]]
    launches = {n: sum(r[n] for r in runs) for n in KERNELS}
    print("phase 24 took %.1f s (%s) on %s; main-path launches %s"
          % (time.perf_counter() - t0, ", ".join(
              "%s %.1f s" % kv for kv in times.items()), nvidia_smi(),
             {k: v for k, v in launches.items() if v}))
    for name in ("lstm_scan", "gru_scan", "bilstm_scan"):
        if not launches[name]:
            raise AssertionError("phase 24: %s must run on its main paths: "
                                 "%s" % (name, launches))
    return {"carry": carry, "cells": cells, "long": long_form, "cli": cli,
            "launches": launches}


# phase 25: the serving artifacts.  (b) the paper model's buckets and its
# two requests (samples, the bucket that admits them): 10 s and 3 s
BUNDLE_LENGTHS = (16000, 40000, 80000)
BUNDLE_REQUESTS = ((10 * SMPRATE, 80000), (3 * SMPRATE, 40000))
BUNDLE_REPS = 10
# (c) attn-v1 on its flash path: the bucket of T = 1280 frames and a 9.98 s
# request (T = 1249, which the flash kernel refuses unpadded)
FLASH_BUCKET = 64 * (1280 - 1)
FLASH_REQUEST = 79840
# (d) bfloat16 weights: the output within this share of the float32
# bundle's peak (tests/test_serve.py:322's 5e-2), an artifact under this
# share of the float32 one
BF16_RTOL = 5e-2
BF16_SIZE = 0.75
# bundle against the live model on the same padded wave: the same eager
# ops, traced
BUNDLE_RTOL = 1e-6


def _op_cases(rs, window) -> list:
    """(a): (name, op, arguments on the card, plain version, the wrapper
    whose counter the op raises, [(output, atol, rtol)]) of every op at
    small shapes of its main paths."""
    from danet_tpu_torch.ops.cuda import library

    def r(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(
            np.float32)).cuda()
    t = 64
    x = r(2, 16000, scale=0.3)
    name, dt = library.window_key(window)
    stft_tol = [("ri", STFT_ATOL, 0.0)]
    scan_tol = [("hs", LSTM_ATOL[torch.float32], 0.0)]
    lstm1 = (r(t, 1, 2400, scale=0.5), r(600, 2400, scale=600 ** -0.5),
             r(1, 600, scale=0.5), r(1, 600, scale=0.5))
    qkv = r(1, 256, 3, ATTN_H, ATTN_D)
    seg = torch.zeros(1, 256, dtype=torch.int32)
    seg[0, 219:] = 1
    return [
        ("stft_ri", library.stft_ri_op, (x, 256, 64, name, dt, False),
         lambda *a: cuda_stft.stft_ri_plain(x, 256, 64, window), "stft_ri",
         stft_tol),
        ("stft_ri logmag", library.stft_ri_op, (x, 256, 64, name, dt, True),
         lambda *a: cuda_stft.stft_ri_plain(x, 256, 64, window, True),
         "stft_logmag", stft_tol),
        ("bilstm_scan", library.bilstm_scan,
         (r(t, 2, 1, 1200, scale=0.5), r(2, 300, 1200, scale=300 ** -0.5),
          torch.zeros(2, 1, 300).cuda(), torch.zeros(2, 1, 300).cuda(),
          True), cuda_lstm.bilstm_scan_plain, "bilstm_scan", scan_tol),
        ("lstm_scan", library.lstm_scan, lstm1 + (True,),
         cuda_lstm.lstm_scan_plain, "lstm_scan", scan_tol),
        ("lstm_scan_state", library.lstm_scan_state, lstm1 + (True,),
         lambda *a: cuda_lstm.lstm_scan_plain(*a, return_state=True),
         "lstm_scan", scan_tol + [("c_T", LSTM_ATOL[torch.float32], 0.0)]),
        ("gru_scan", library.gru_scan,
         (r(t, 1, 1200, scale=0.5), r(t, 1, 600, scale=0.5),
          r(600, 1200, scale=600 ** -0.5), r(600, 600, scale=600 ** -0.5),
          r(1, 600, scale=0.5)), cuda_gru.gru_scan_plain, "gru_scan",
         [("cs", LSTM_ATOL[torch.float32], 0.0)]),
        ("flash_attn", library.flash_attn,
         (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], seg.cuda(),
          1.0 / ATTN_D ** 0.5), cuda_attn.flash_attn_plain, "flash_attn",
         [("o",) + TRAIN_FWD_TOL[torch.float32], ("l",) + STATS_TOL,
          ("m", 1e-5, 0.0)]),
    ]


def _ops_on_card(window) -> dict:
    """(a) each op's CUDA implementation (the kernel's wrapper) against its
    plain version on the same inputs, one launch of its kernel per call,
    and ``torch.library.opcheck`` on the card."""
    worst = {}
    for name, op, args, plain, counter, tols in _op_cases(
            np.random.RandomState(250), window):
        before = _counts()
        got = op(*args)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _counts().items()
                    if v != before[k]}
        want = plain(*args)
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        parts, ok = [], launched == {counter: 1}
        for (what, atol, rtol), g, w in zip(tols, got, want):
            err = max_err(g, w)
            bound = atol + rtol * float(w.abs().max())
            parts.append("%s %.3g (bound %.3g)" % (what, err, bound))
            ok = ok and g.shape == w.shape and g.dtype == w.dtype \
                and bool(torch.isfinite(g).all()) and err <= bound
            worst[name] = max(worst.get(name, 0.0), err)
        torch.library.opcheck(op, args)
        line = ("phase 25 (a) danet::%s on the card: launched %s; vs plain "
                "%s; opcheck passed" % (name, launched, ", ".join(parts)))
        print(line)
        if not ok:
            raise AssertionError(line)
    return worst


def _graph_ops(path: str) -> dict:
    """The danet.* nodes of an exported program file, by op."""
    program = torch.export.load(path)
    out: dict = {}
    for n in program.graph.nodes:
        target = str(n.target)
        if n.op == "call_function" and target.startswith("danet."):
            out[target] = out.get(target, 0) + 1
    return out


def _dir_mb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path)) / 2 ** 20


def _launches_of(fn):
    """fn() with the counts zeroed before it and no plain scan in it: ->
    (result, launches)."""
    _zero_counts()
    with _PlainScans() as plain:
        out = fn()
    if plain.calls:
        raise AssertionError("phase 25: %d plain scans on the card"
                             % plain.calls)
    return out, _counts()


def _only(launches: dict, **want) -> bool:
    return launches == dict({k: 0 for k in KERNELS}, **want)


def _median_ms(fn, reps: int = BUNDLE_REPS) -> float:
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()                                       # numpy out: synced
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


_SUBPROCESS_SEPARATE = """
import sys
import numpy as np
from danet_tpu_torch.serve import load_separator
bundle = load_separator(sys.argv[1])
wavs = np.load(sys.argv[2])
np.savez(sys.argv[3], *[bundle.separate(wavs[k]) for k in wavs.files])
bad = [m for m in sys.modules if m.startswith("danet_tpu_torch.models")
       or m == "danet_tpu_torch.hparams"]
assert not bad, bad
"""


def _paper_bundle(tmp: str) -> dict:
    """(b) the paper model (default.json's bilstm-orig, 4 x 2 x 300) at
    seed 0, exported for the card at BUNDLE_LENGTHS: its graph's kernel
    ops, a 10 s and a 3 s request against the live Separator on the
    padded wave, the CPU bundle and a fresh process; launches and times."""
    from danet_tpu_torch import serve
    hp = load_config(ENCODER_TYPE="bilstm-orig")
    model = hp.get_model()(hp)
    params = _init(model)
    layers = model.encoder.N_LAYERS
    path = os.path.join(tmp, "paper")
    t0 = time.perf_counter()
    serve.export_separator(model, params, path, BUNDLE_LENGTHS)
    export_s = time.perf_counter() - t0
    for length in BUNDLE_LENGTHS:
        nodes = _graph_ops(os.path.join(path, "sep_%d.pt2" % length))
        if nodes != {"danet.stft_ri.default": 1,
                     "danet.bilstm_scan.default": layers}:
            raise AssertionError("phase 25 (b) bucket %d holds %s"
                                 % (length, nodes))
    print("phase 25 (b) paper model %s: exported buckets %s for the card in "
          "%.1f s (%.2f s per bucket), %.1f MiB; each bucket's graph holds "
          "danet.stft_ri x1, danet.bilstm_scan x%d"
          % (_describe(hp, model.encoder), list(BUNDLE_LENGTHS), export_s,
             export_s / len(BUNDLE_LENGTHS), _dir_mb(path), layers))
    bundle = serve.load_separator(path)
    live = serve.Separator(model, params, "cuda")
    rs = np.random.RandomState(251)
    wavs = [_mixture(rs, 1, n)[0] for n, _ in BUNDLE_REQUESTS]
    cpu_path = os.path.join(tmp, "paper-cpu")
    serve.export_separator(model, params, cpu_path,
                           sorted({b for _, b in BUNDLE_REQUESTS}),
                           device="cpu")
    cpu = serve.load_separator(cpu_path)
    np.savez(os.path.join(tmp, "wavs.npz"), *wavs)
    proc = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS_SEPARATE, path,
         os.path.join(tmp, "wavs.npz"), os.path.join(tmp, "fresh.npz")],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode:
        raise AssertionError("phase 25 (b) fresh process: " + proc.stderr)
    with np.load(os.path.join(tmp, "fresh.npz")) as f:
        fresh = [f[k] for k in f.files]
    total = {k: 0 for k in KERNELS}
    out = {"export_s": export_s, "mib": _dir_mb(path), "requests": {}}
    for wav, (n, bucket), other in zip(wavs, BUNDLE_REQUESTS, fresh):
        padded = np.zeros(bucket, np.float32)
        padded[:n] = wav
        bundle.separate(wav)                                   # warm-up
        got, launches = _launches_of(lambda: bundle.separate(wav))
        for k in KERNELS:
            total[k] += launches[k]
        ref = live.separate(padded)[:, :n]
        on_cpu = cpu.separate(wav)
        peak = float(np.abs(ref).max())
        err, cpu_err = (float(np.abs(got - ref).max()),
                        float(np.abs(got - on_cpu).max()))
        ms = (_median_ms(lambda: bundle.separate(wav)),
              _median_ms(lambda: live.separate(wav)))
        line = ("phase 25 (b) %.2f s request (bucket %d) at B=1: out %s; vs "
                "live Separator on the padded wave max_abs_err %.3g (%.3g "
                "of the peak %.3g, bound %g); vs the CPU bundle %.3g of the "
                "peak (bound %g); a fresh process bit for bit: %s (max "
                "|diff| %.3g); launches "
                "%s; median of %d: bundle %.3f ms, live %.3f ms per request "
                "on %s" % (n / SMPRATE, bucket, got.shape, err, err / peak,
                           peak, BUNDLE_RTOL, cpu_err / peak, SERVE_RTOL,
                           np.array_equal(got, other),
                           float(np.abs(got - other).max()),
                           {k: v for k, v in launches.items() if v},
                           BUNDLE_REPS, *ms, nvidia_smi()))
        print(line)
        if got.shape != (hp.MAX_N_SIGNAL, n) or not np.isfinite(got).all() \
                or not err <= BUNDLE_RTOL * peak \
                or not cpu_err <= SERVE_RTOL * peak \
                or not np.array_equal(got, other) \
                or not _only(launches, stft_ri=1, bilstm_scan=layers):
            raise AssertionError(line)
        out["requests"][n] = {"max_rel_err": err / peak,
                              "cpu_rel_err": cpu_err / peak,
                              "bundle_ms": ms[0], "live_ms": ms[1]}
    out["launches"] = total
    out["path"], out["model"], out["params"], out["wavs"] = \
        path, model, params, wavs
    return out


def _flash_bundle(tmp: str) -> dict:
    """(c) attn-v1 on its flash path at default.json's widths, one bucket
    of T = 1280 frames: a 9.98 s request, which the live Separator refuses
    (T = 1249), answered through kernel 5f once per block, against the
    live model on the padded wave."""
    from danet_tpu_torch import serve
    hp = load_config(ENCODER_TYPE="attn-v1", **FLASH)
    model = hp.get_model()(hp)
    params = _init(model)
    path = os.path.join(tmp, "flash")
    serve.export_separator(model, params, path, [FLASH_BUCKET])
    nodes = _graph_ops(os.path.join(path, "sep_%d.pt2" % FLASH_BUCKET))
    blocks = _depth(model.encoder)
    bundle = serve.load_separator(path)
    live = serve.Separator(model, params, "cuda")
    wav = _mixture(np.random.RandomState(252), 1, FLASH_REQUEST)[0]
    try:
        live.separate(wav)
        refused = None
    except ValueError as e:
        refused = str(e)
    bundle.separate(wav)                                       # warm-up
    got, launches = _launches_of(lambda: bundle.separate(wav))
    padded = np.zeros(FLASH_BUCKET, np.float32)
    padded[:FLASH_REQUEST] = wav
    ref = live.separate(padded)[:, :FLASH_REQUEST]
    peak = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    ms = _median_ms(lambda: bundle.separate(wav))
    line = ("phase 25 (c) attn-v1 %s: bucket %d (T=%d), graph %s; a %.2f s "
            "request (%d samples): live Separator refused (%s), bundle out "
            "%s, vs live on the padded wave %.3g of the peak (bound %g); "
            "launches %s; median %.3f ms on %s"
            % (_describe(hp, model.encoder), FLASH_BUCKET,
               stft_frame_count(FLASH_BUCKET, 256, 64), nodes,
               FLASH_REQUEST / SMPRATE, FLASH_REQUEST, refused, got.shape,
               err / peak, BUNDLE_RTOL, {k: v for k, v in launches.items()
                                         if v}, ms, nvidia_smi()))
    print(line)
    if refused is None or got.shape != (hp.MAX_N_SIGNAL, FLASH_REQUEST) \
            or not err <= BUNDLE_RTOL * peak \
            or nodes != {"danet.stft_ri.default": 1,
                         "danet.flash_attn.default": blocks} \
            or not _only(launches, stft_ri=1, flash_attn=blocks):
        raise AssertionError(line)
    return {"launches": launches, "max_rel_err": err / peak, "ms": ms}


def _bf16_bundle(tmp: str, paper: dict) -> dict:
    """(d) the paper model with bfloat16 weights at the 3 s request's
    bucket: the artifact's size against the float32 one, the output
    against the float32 bundle's."""
    from danet_tpu_torch import serve
    n, bucket = BUNDLE_REQUESTS[1]
    path = os.path.join(tmp, "paper-bf16")
    serve.export_separator(paper["model"], paper["params"], path, [bucket],
                           weights_dtype="bfloat16")
    name = "sep_%d.pt2" % bucket
    ratio = os.path.getsize(os.path.join(path, name)) / os.path.getsize(
        os.path.join(paper["path"], name))
    wav = paper["wavs"][1]
    got, launches = _launches_of(
        lambda: serve.load_separator(path).separate(wav))
    ref = serve.load_separator(paper["path"]).separate(wav)
    peak = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    line = ("phase 25 (d) bfloat16 weights, bucket %d: artifact %.3f of the "
            "float32 one (bound %g); the %.2f s request vs the float32 "
            "bundle %.3g of the peak (bound %g); launches %s"
            % (bucket, ratio, BF16_SIZE, n / SMPRATE, err / peak, BF16_RTOL,
               {k: v for k, v in launches.items() if v}))
    print(line)
    if not ratio < BF16_SIZE or not np.isfinite(got).all() \
            or not err <= BF16_RTOL * peak \
            or not _only(launches, stft_ri=1,
                         bilstm_scan=paper["model"].encoder.N_LAYERS):
        raise AssertionError(line)
    return {"launches": launches, "ratio": ratio, "max_rel_err": err / peak}


def _feed(streamer, wav):
    """start on the warm-up, then every chunk: -> (samples [N, L], ms per
    feed, each feed's launches)."""
    w, c = streamer.warmup_samples, streamer.chunk_samples
    outs = [streamer.start(wav[:w])[0]]
    ms, per_feed = [], []
    for lo in range(w, len(wav), c):
        before = _counts()
        t0 = time.perf_counter()
        outs.append(streamer.feed(wav[lo:lo + c])[0])   # numpy: synced
        ms.append((time.perf_counter() - t0) * 1e3)
        per_feed.append({k: v - before[k] for k, v in _counts().items()})
    return np.concatenate(outs, axis=-1), ms, per_feed


def _stream_bundles(tmp: str) -> dict:
    """(e) stream bundles at default.json's widths: lstm-orig (kernel 1's
    state entry), gru-v1 (4f) and causal tasnet-v1 (no kernel: GEMMs and
    convolutions; one repeat of its 8 blocks, dilations 1 to 128: the
    export's host time grows with the graph, 60 s for two programs of 24
    blocks on an H100's host); STREAM_WARMUP then STREAM_FEEDS feeds of
    STREAM_CHUNK
    against the live Streamer, 1e-6 of the peak, each feed's launches,
    ms per feed beside the live Streamer's."""
    from danet_tpu_torch import serve
    out, total = {}, {k: 0 for k in KERNELS}
    n = STREAM_WARMUP + STREAM_FEEDS * STREAM_CHUNK
    wav = _mixture(np.random.RandomState(253), 1, n)[0]
    for name, keys in (("lstm-orig", dict(ENCODER_TYPE="lstm-orig")),
                       ("gru-v1", dict(ENCODER_TYPE="gru-v1")),
                       ("tasnet-v1", dict(MODEL_TYPE="tasnet-v1",
                                          TASNET_CAUSAL=True,
                                          TASNET_REPEATS=1))):
        hp = load_config(**keys)
        model = hp.get_model()(hp)
        params = _init(model)
        path = os.path.join(tmp, "stream-" + name)
        t0 = time.perf_counter()
        man = serve.export_streamer(model, params, path, STREAM_CHUNK,
                                    STREAM_WARMUP)
        export_s = time.perf_counter() - t0
        nodes = _graph_ops(os.path.join(path, "stream_step.pt2"))
        bundle = serve.load_streamer(path)
        live = serve.Streamer(model, params, "cuda", STREAM_CHUNK,
                              STREAM_WARMUP)
        _feed(bundle, wav)                                     # warm-up
        _feed(live, wav)
        (got, ms, per_feed), launches = _launches_of(
            lambda: _feed(bundle, wav))
        ref, live_ms, _ = _feed(live, wav)
        if name == "tasnet-v1":
            want = {k: 0 for k in KERNELS}
        else:
            want = _stream_feed_launches(model, STREAM_CHUNK // hp.FFT_STRIDE)
        peak = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max())
        stats = (np.median(ms), np.percentile(ms, 90), np.median(live_ms),
                 np.percentile(live_ms, 90))
        line = ("phase 25 (e) stream bundle %s: exported in %.1f s, %.1f "
                "MiB, step graph %s, lag %d samples; warm-up %d + %d x %d "
                "samples at B=1, out %s; vs the live Streamer %.3g of the "
                "peak (bound %g); launches %s; per feed median %.3f ms, p90 "
                "%.3f ms (live Streamer %.3f, %.3f) on %s"
                % (name, export_s, _dir_mb(path), nodes,
                   man["latency_samples"], STREAM_WARMUP, STREAM_FEEDS,
                   STREAM_CHUNK, got.shape, err / peak, BUNDLE_RTOL,
                   {k: v for k, v in launches.items() if v}, *stats,
                   nvidia_smi()))
        print(line)
        if got.shape != (hp.MAX_N_SIGNAL, n) or not np.isfinite(got).all() \
                or not err <= BUNDLE_RTOL * peak \
                or any(f != want for f in per_feed):
            raise AssertionError(line + "; per feed %s, want %s"
                                 % (per_feed[0], want))
        for k in KERNELS:
            total[k] += launches[k]
        out[name] = {"feed_ms": stats, "max_rel_err": err / peak,
                     "bundle": bundle, "params": params, "model": model}
    for name, kernel in (("lstm-orig", "lstm_scan"), ("gru-v1", "gru_scan")):
        if not total[kernel]:
            raise AssertionError("phase 25 (e) %s ran no %s" % (name, kernel))
    out["launches"] = total
    return out


def _mag_logmag(window) -> dict:
    """(f) dsp.stft_mag_logmag on the card (kernel 6 through
    danet::stft_ri) against its plain version, one launch per call."""
    rs = np.random.RandomState(254)
    total, worst = {k: 0 for k in KERNELS}, 0.0
    for b, n in ((1, 80000), (4, 32000)):
        x = torch.from_numpy(_mixture(rs, b, n)).cuda()
        (mag, logmag), launches = _launches_of(
            lambda: dsp.stft_mag_logmag(x, 256, 64, window))
        ref = cuda_stft.stft_ri_plain(x, 256, 64, window, logmag=True)
        err = max(max_err(mag, ref[..., 0]), max_err(logmag, ref[..., 1]))
        worst = max(worst, err)
        line = ("phase 25 (f) dsp.stft_mag_logmag B=%d L=%d on the card: "
                "max_abs_err %.3g (atol %g); launches %s"
                % (b, n, err, STFT_ATOL,
                   {k: v for k, v in launches.items() if v}))
        print(line)
        if tuple(mag.shape) != tuple(ref.shape[:-1]) or not err <= STFT_ATOL \
                or not _only(launches, stft_logmag=1):
            raise AssertionError(line)
        for k in KERNELS:
            total[k] += launches[k]
    return {"launches": total, "max_abs_err": worst}


def _cli_quiet(argv: list) -> str:
    import contextlib
    import io
    from danet_tpu_torch import serve
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        serve._main(argv)
    return text.getvalue()


def _cli_bundles(tmp: str, paper: dict, streams: dict) -> dict:
    """(g) the serve CLI on the card: export -> run -d with the paper
    model, export-stream -> run-stream with lstm-orig, from .npz weights;
    the WAVs within one int16 step of (b)'s and (e)'s bundles fed by hand
    (run-stream: padded to whole chunks, trimmed to len(wav) + lag, one
    scale for all stems)."""
    import scipy.io.wavfile
    from danet_tpu_torch.data import audio
    wav_path = os.path.join(tmp, "cli.wav")
    x = _mixture(np.random.RandomState(255), 1, 3 * SMPRATE)[0]
    scipy.io.wavfile.write(wav_path, SMPRATE,
                           np.round(x * 16000).astype(np.int16))
    x = audio.load_wav_raw(wav_path, SMPRATE)
    total, steps = {k: 0 for k in KERNELS}, {}

    def int16(out):
        scale = max(float(np.max(np.abs(out))), 1.0)
        return (np.clip(out / scale, -1.0, 1.0) * 32767.0).astype(np.int16)

    stream = streams["lstm-orig"]["bundle"]
    w, c = stream.warmup_samples, stream.chunk_samples
    padded = np.zeros(w + max(0, -(-(len(x) - w) // c)) * c, np.float32)
    padded[:len(x)] = x
    parts = [stream.start(padded[:w])] + [
        stream.feed(padded[lo:lo + c]) for lo in range(w, len(padded), c)]
    from danet_tpu_torch import serve
    cases = (
        ("export", paper["params"], {"ENCODER_TYPE": "bilstm-orig"},
         ["--lengths", str(BUNDLE_REQUESTS[1][1])], "run",
         int16(serve.load_separator(paper["path"]).separate(x))),
        ("export-stream", streams["lstm-orig"]["params"],
         {"ENCODER_TYPE": "lstm-orig"},
         ["--chunk", str(c), "--warmup", str(w)], "run-stream",
         int16(np.concatenate(parts, -1)[0][:, :len(x)
                                            + stream.latency_samples])))
    for export, params, keys, extra, run, want in cases:
        npz = os.path.join(tmp, "cli-%s.npz" % export)
        weights.save_npz(npz, params)
        cfg = os.path.join(tmp, "cli-%s.json" % export)
        with open(cfg, "w") as f:
            json.dump(keys, f)
        out_dir = os.path.join(tmp, "cli-" + export)
        _cli_quiet([export, "-c", cfg, "-i", npz, "-o", out_dir] + extra)
        prefix = os.path.join(tmp, "cli-" + run)
        _, launches = _launches_of(lambda: _cli_quiet(
            [run, "-d", out_dir, "-if", wav_path, "-o", prefix]))
        got = [scipy.io.wavfile.read("%s_%d.wav" % (prefix, i))[1]
               for i in range(2)]
        steps[run] = max(float(np.abs(g.astype(np.int32) - v).max())
                         for g, v in zip(got, want))
        line = ("phase 25 (g) CLI %s -> %s -d on the card: WAVs %s, max "
                "|CLI - bundle fed by hand| %.3g int16 steps (bound 1); "
                "launches %s" % (export, run, [g.shape for g in got],
                                 steps[run],
                                 {k: v for k, v in launches.items() if v}))
        print(line)
        if [g.shape for g in got] != [v.shape for v in want] \
                or not steps[run] <= 1.0 \
                or not (launches["bilstm_scan"] if run == "run"
                        else launches["lstm_scan"]):
            raise AssertionError(line)
        for k in KERNELS:
            total[k] += launches[k]
    return {"launches": total, "int16_steps": steps}


def phase_bundles(window) -> dict:
    """Phase 25: the serving artifacts (module docstring)."""
    import shutil
    import tempfile
    t0 = clock = time.perf_counter()
    times = {}
    tmp = tempfile.mkdtemp(prefix="danet-phase25-")
    try:
        ops = _ops_on_card(window)
        times["(a)"], clock = time.perf_counter() - clock, time.perf_counter()
        paper = _paper_bundle(tmp)
        times["(b)"], clock = time.perf_counter() - clock, time.perf_counter()
        flash = _flash_bundle(tmp)
        times["(c)"], clock = time.perf_counter() - clock, time.perf_counter()
        bf16 = _bf16_bundle(tmp, paper)
        times["(d)"], clock = time.perf_counter() - clock, time.perf_counter()
        streams = _stream_bundles(tmp)
        times["(e)"], clock = time.perf_counter() - clock, time.perf_counter()
        mag = _mag_logmag(window)
        times["(f)"], clock = time.perf_counter() - clock, time.perf_counter()
        cli = _cli_bundles(tmp, paper, streams)
        times["(g)"] = time.perf_counter() - clock
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs = [paper["launches"], flash["launches"], bf16["launches"],
            streams["launches"], mag["launches"], cli["launches"]]
    launches = {n: sum(r[n] for r in runs) for n in KERNELS}
    print("phase 25 took %.1f s (%s) on %s; main-path launches %s"
          % (time.perf_counter() - t0, ", ".join(
              "%s %.1f s" % kv for kv in times.items()), nvidia_smi(),
             {k: v for k, v in launches.items() if v}))
    return {"ops": ops, "paper": paper["requests"],
            "paper_export_s": paper["export_s"], "flash": flash,
            "bf16": bf16, "streams": {k: v["max_rel_err"] for k, v in
                                      streams.items() if k != "launches"},
            "mag": mag, "cli": cli["int16_steps"], "launches": launches}


MESH_STEP = {"ENCODER_TYPE": "bilstm-orig", "BATCH_SIZE": 32}
MESH_RTOL = (2e-5, 1e-4)   # (atol, rtol) of (b)'s parameters after a step
MESH_SHAPES = ((1, 2), (2, 1))


def _mesh_state_diffs(a: dict, b: dict) -> list:
    return [name for (name, x), (_, y) in zip(_state_tensors(a),
                                              _state_tensors(b))
            if not torch.equal(x.detach(), y.detach())]


def _mesh_world_one(hp, batches) -> dict:
    """(a): one rank of a real NCCL process group (cpu:gloo,cuda:nccl)
    against the plain Trainer, eager and in a K=8 graph, bit for bit."""
    import socket

    import torch.distributed as dist

    from danet_tpu_torch.parallel import multihost, sharding
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    plain = Trainer(hp.get_model()(hp), hp, "cuda")
    st0 = plain.init_state(torch.Generator().manual_seed(0))
    multihost.initialize("cuda", coordinator_address="localhost:%d" % port,
                         num_processes=1, process_id=0)
    try:
        mesh = sharding.mesh_from_hparams(hp).connect()
        if not mesh.nccl or mesh.shape != {"data": 1, "model": 1}:
            raise AssertionError("phase 26 (a): mesh %s, NCCL %s"
                                 % (mesh.shape, mesh.nccl))
        tr = Trainer(hp.get_model()(hp), hp, "cuda", mesh=mesh)
        st1 = tr.init_state(torch.Generator().manual_seed(0))
        m0 = plain.train_step(st0, batches[0])
        _zero_counts()
        m1 = tr.train_step(st1, batches[0])
        eager = _counts()
        stack = np.stack(batches[1:9])
        g0 = plain.train_steps(st0, stack)
        graph = _main_path(lambda: tr.train_steps(st1, stack),
                           per_step=_bilstm_step_spectra())
        g1 = graph[0]
        _zero_counts()
        tr.valid_step(st1, batches[0])
        valid = _counts()
        torch.cuda.synchronize()
    finally:
        sharding.set_active_mesh(None)
        dist.destroy_process_group()
    diffs = _mesh_state_diffs(st0, st1)
    same = (float(m0["loss"]) == float(m1["loss"])
            and all(torch.equal(g0[k], g1[k]) for k in g0))
    if diffs or not same or not st0["step"] == st1["step"] == 9:
        raise AssertionError("phase 26 (a): the mesh differs from the plain "
                             "Trainer: %s, losses equal %s" % (diffs[:6],
                                                               same))
    n = _depth(tr.model.encoder)
    want = {"bilstm_scan_train": n, "bilstm_scan_bwd": n}
    if {k: v for k, v in eager.items() if v} != want or \
            {k: v for k, v in valid.items() if v} != {"bilstm_scan": n}:
        raise AssertionError("phase 26 (a): launches eager %s, valid %s"
                             % (eager, valid))
    launches = {k: eager[k] + graph[1][k] + valid[k] for k in KERNELS}
    print("phase 26 (a) world 1 over NCCL (bilstm-orig, B=32, T=%d, "
          "float32): an eager step and one 8-step CUDA graph call (%d "
          "captured) bit for bit the plain Trainer's (parameters, Adam "
          "moments, every loss); launches: eager step %s, valid step %s"
          % (TRAIN_T, graph[2], {k: v for k, v in eager.items() if v},
             {k: v for k, v in valid.items() if v}))
    return launches


def _bilstm_step_spectra() -> dict:
    """One bilstm-orig train step's launches on the spectra wire."""
    n = encoders.BiLstmEncoder.N_LAYERS
    return {"bilstm_scan_train": n, "bilstm_scan_bwd": n}


def _mesh_shared_card(hp, batch, tmp: str) -> dict:
    """(b): two ranks on the one card over gloo, MESH 1 x 2 and 2 x 1,
    against the one-process step at B=32."""
    from danet_tpu_torch.parallel import smoke
    model = hp.get_model()(hp)
    params = model.init(torch.Generator().manual_seed(0))
    weights.save_npz(os.path.join(tmp, "p.npz"), params)
    np.savez(os.path.join(tmp, "b.npz"), src=batch)
    rows = hp.BATCH_SIZE // 2
    cases = [{"name": "%dx%d" % s, "kind": "step", "adam": True,
              "valid": True, "params": "p.npz", "batch": "b.npz",
              "keys": dict(MESH_STEP, MESH_DATA=s[0], MESH_MODEL=s[1])}
             for s in MESH_SHAPES]
    cases.append({"name": "kernels", "kind": "kernels", "T": TRAIN_T,
                  "rows": rows, "tol": {
                      "bilstm_scan": (LSTM_ATOL[torch.float32], 0.0),
                      "bilstm_scan_train": TRAIN_FWD_TOL[torch.float32],
                      "bilstm_scan_bwd": TRAIN_BWD_TOL[torch.float32]}})
    spec = os.path.join(tmp, "spec.json")
    with open(spec, "w") as f:
        json.dump({"cases": cases}, f)
    t0 = time.perf_counter()
    smoke.launch(spec, os.path.join(tmp, "out"), 2, device="cuda",
                 backend="gloo", shared_card=True, timeout=300)
    ranks_s = time.perf_counter() - t0
    res = smoke.load_results(os.path.join(tmp, "out"), 2)
    one = Trainer(model, hp, "cuda")
    st = one.init_state(torch.Generator().manual_seed(0), params=params)
    one.train_step(st, batch)
    want = {n: p.detach().cpu().numpy() for n, p in zip(
        weights.leaf_names(st["params"]), weights.leaves(st["params"]))}
    n = _depth(model.encoder)
    per_rank = {}
    worst = 0.0
    for shape in MESH_SHAPES:
        tag = "%dx%d" % shape
        got = [{k.split("/", 2)[2]: v for k, v in r.items()
                if k.startswith(tag + "/params/")} for r in res]
        for name, ref in want.items():
            for g in got:
                err = np.abs(g[name] - ref)
                bound = MESH_RTOL[0] + MESH_RTOL[1] * np.abs(ref)
                if not np.all(err <= bound):
                    raise AssertionError(
                        "phase 26 (b) %s: %s differs from the one-process "
                        "step by %.3g" % (tag, name, float(np.max(err))))
                worst = max(worst, float(np.max(err)))
            if not np.array_equal(got[0][name], got[1][name]):
                raise AssertionError("phase 26 (b) %s: the ranks' %s differ"
                                     % (tag, name))
        for r, rank in enumerate(res):
            counts = {k.split("/", 2)[2]: int(v) for k, v in rank.items()
                      if k.startswith(tag + "/launches/") and int(v)}
            if counts != {"bilstm_scan_train": n, "bilstm_scan_bwd": n,
                          "bilstm_scan": n}:
                raise AssertionError("phase 26 (b) %s rank %d launched %s"
                                     % (tag, r, counts))
            per_rank["%s rank %d" % (tag, r)] = counts
            if list(rank[tag + "/rows"]) != (
                    [0, rows] if r == 0 else [rows, 2 * rows]):
                raise AssertionError("phase 26 (b) %s rank %d rows %s"
                                     % (tag, r, rank[tag + "/rows"]))
    errs = {}
    for r, rank in enumerate(res):
        for name in ("bilstm_scan", "bilstm_scan_train", "bilstm_scan_bwd"):
            if not float(rank["kernels/ratio/" + name]) <= 1.0:
                raise AssertionError(
                    "phase 26 (b) rank %d: %s off its plain version by "
                    "%.3g" % (r, name, float(rank["kernels/err/" + name])))
            errs[name] = max(errs.get(name, 0.0),
                             float(rank["kernels/err/" + name]))
    print("phase 26 (b) two ranks on one card over gloo (card tensors "
          "staged through the host), MESH 1x2 and 2x1, %d rows each: the "
          "updated parameters within %g + %g x |p| of the one-process step "
          "(worst %.3g), the ranks bit for bit; kernels B, 2 and 3 at "
          "(T=%d, B=%d) against their plain versions, max abs err %s; "
          "launches per rank (a step and a valid step) %s; the ranks took "
          "%.1f s" % (rows, MESH_RTOL[0], MESH_RTOL[1], worst, TRAIN_T,
                      rows, {k: "%.3g" % v for k, v in errs.items()},
                      per_rank, ranks_s))
    return {"params_err": worst, "kernel_err": errs, "per_rank": per_rank}


def phase_mesh() -> dict:
    """Phase 26: data and tensor parallelism on one card (module
    docstring)."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    hp = load_config(**MESH_STEP)
    batches = _toy_batches(hp, 9)
    launches = _mesh_world_one(hp, batches)
    tmp = tempfile.mkdtemp(prefix="danet-phase26-")
    try:
        shared = _mesh_shared_card(hp, batches[0], tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("phase 26 took %.1f s on %s; main-path launches %s"
          % (time.perf_counter() - t0, nvidia_smi(),
             {k: v for k, v in launches.items() if v}))
    return dict(shared, launches=launches)


PIPE_JSON = os.path.join(REPO_ROOT, "configs", "pipeline.json")
PIPE_MESH = {"MESH_DATA": 1, "MESH_PIPE": 4}
EP_MESH = {"MESH_DATA": 1, "MESH_EXPERT": 2}
ONE_PROCESS = {"MESH_DATA": 1, "MESH_PIPE": 1, "MESH_EXPERT": 1}
# bfloat16 steps: the weight gradients are bfloat16 products summed per
# microbatch (or per expert group) where one process rounds one product
# over the batch: each gradient within 2e-2 of its tensor's peak, the loss
# within 1e-2
BF16_GRAD_REL = 2e-2
BF16_LOSS_REL = 1e-2


def _one_process_step(hp, params, batch, patch=None) -> dict:
    """The one-process reference of a smoke ``step`` case on the card:
    the loss, the gradients and the parameters after one Adam step.
    ``patch``: a context manager around both (phase 27 (b)'s shard-wise
    routing)."""
    import contextlib
    tr = Trainer(hp.get_model()(hp), hp, "cuda")
    st = tr.init_state(torch.Generator().manual_seed(0), params=params)
    with patch() if patch else contextlib.nullcontext():
        m, g = tr.loss_and_grads(st["params"], tr.ingest(batch), None)
        tr.train_step(st, batch)
    names = weights.leaf_names(st["params"])
    return {"loss": float(m["loss"]),
            "grads": {n: t.float().cpu().numpy() for n, t in zip(names, g)},
            "params": {n: p.detach().float().cpu().numpy() for n, p in zip(
                names, weights.leaves(st["params"]))}}


def _held(tag: str, rank: dict, want: dict, bf16: bool,
          phase: int = 27) -> float:
    """A rank's step against the one-process one: float32 at phase 26
    (b)'s bound on the parameters after the step, bfloat16 the loss and
    each gradient relative to its peak (BF16_*).  -> the worst ratio of
    an error to its bound."""
    worst = 0.0
    loss_rel = abs(float(rank["loss"]) - want["loss"]) / abs(want["loss"])
    if bf16:
        worst = loss_rel / BF16_LOSS_REL
        for name, ref in want["grads"].items():
            got = rank["grads/" + name]
            peak = max(float(np.max(np.abs(ref))), 1e-30)
            worst = max(worst, float(np.max(np.abs(got - ref))) / peak
                        / BF16_GRAD_REL)
    else:
        for name, ref in want["params"].items():
            err = np.abs(rank["params/" + name] - ref)
            bound = MESH_RTOL[0] + MESH_RTOL[1] * np.abs(ref)
            worst = max(worst, float(np.max(err / bound)))
    if not worst <= 1.0:
        raise AssertionError("phase %d %s: off the one-process step (%.3g "
                             "of its bound; loss %.6g vs %.6g)"
                             % (phase, tag, worst, float(rank["loss"]),
                                want["loss"]))
    return worst


def _rank_results(res: list, case: str) -> list:
    pre = case + "/"
    return [{k[len(pre):]: v for k, v in r.items() if k.startswith(pre)}
            for r in res]


def _same_replicas(tag: str, ranks: list, names, phase: int = 27) -> None:
    """The ranks' copies of the leaves ``names`` bit for bit equal."""
    for name in names:
        for r in ranks[1:]:
            if not np.array_equal(r["params/" + name],
                                  ranks[0]["params/" + name]):
                raise AssertionError("phase %d %s: the ranks' %s differ"
                                     % (phase, tag, name))


def _scan_tols(dt: str) -> dict:
    """A ``kernels`` case's tolerances of kernels B, 2 and 3 in ``dt``:
    phase 4's on the lean forward, phase 6's on the saving forward and
    kernel 3."""
    dtype = getattr(torch, dt)
    return {"bilstm_scan": (LSTM_ATOL[dtype], 0.0),
            "bilstm_scan_train": TRAIN_FWD_TOL[dtype],
            "bilstm_scan_bwd": TRAIN_BWD_TOL[dtype]}


def _held_kernels(tag: str, ranks: list, errs: dict,
                  phase: int = 27) -> None:
    """Each rank's ``kernels`` case within its tolerances; keeps each
    kernel's worst error under "<kernel> <tag>"."""
    if not ranks or not all(ranks):
        raise AssertionError("phase %d %s: a rank returned no kernel check"
                             % (phase, tag))
    for r, rank in enumerate(ranks):
        for name in ("bilstm_scan", "bilstm_scan_train", "bilstm_scan_bwd"):
            if not float(rank["ratio/" + name]) <= 1.0:
                raise AssertionError(
                    "phase %d rank %d: %s %s off its plain version by %.3g"
                    % (phase, r, name, tag, float(rank["err/" + name])))
            key = "%s %s" % (name, tag)
            errs[key] = max(errs.get(key, 0.0), float(rank["err/" + name]))


def _pipe_cases(tmp: str) -> tuple:
    """(a)'s spec: configs/pipeline.json's keys at 1 x 4, a bfloat16 step
    as written and a float32 one, each with a valid step, and the kernels
    at a stage's shapes."""
    hp = load_config(PIPE_JSON, **ONE_PROCESS)
    batch = _toy_batches(hp, 1)[0]
    params = hp.get_model()(hp).init(torch.Generator().manual_seed(0))
    weights.save_npz(os.path.join(tmp, "pp.npz"), params)
    np.savez(os.path.join(tmp, "pb.npz"), src=batch)
    rows = hp.BATCH_SIZE // hp.PIPE_MICROBATCHES
    cases = [{"name": "pipe-%s" % dt, "kind": "step", "adam": True,
              "valid": True, "params": "pp.npz", "batch": "pb.npz",
              "configs": ["configs/pipeline.json"],
              "keys": dict(PIPE_MESH, COMPUTE_DTYPE=dt)}
             for dt in ("bfloat16", "float32")]
    for dt in ("float32", "bfloat16"):
        cases.append({"name": "kernels-%s" % dt, "kind": "kernels",
                      "T": TRAIN_T, "rows": rows, "dtype": dt,
                      "tol": _scan_tols(dt)})
    return hp, batch, params, cases


def _pipeline_phase(tmp: str) -> dict:
    """(a): the pipeline on 4 ranks sharing the card."""
    from danet_tpu_torch.parallel import smoke
    hp, batch, params, cases = _pipe_cases(tmp)
    spec = os.path.join(tmp, "pipe.json")
    with open(spec, "w") as f:
        json.dump({"cases": cases}, f)
    t0 = time.perf_counter()
    smoke.launch(spec, os.path.join(tmp, "pipe"), 4, device="cuda",
                 backend="gloo", shared_card=True, timeout=420)
    ranks_s = time.perf_counter() - t0
    res = smoke.load_results(os.path.join(tmp, "pipe"), 4)
    layers = encoders.BiLstmEncoder.N_LAYERS // PIPE_MESH["MESH_PIPE"]
    per = layers * hp.PIPE_MICROBATCHES
    want_counts = {"bilstm_scan_train": per, "bilstm_scan_bwd": per,
                   "bilstm_scan": per}
    worst, per_rank = {}, {}
    launches = {n: 0 for n in KERNELS}
    for dt in ("bfloat16", "float32"):
        tag = "pipe-" + dt
        ref = _one_process_step(load_config(
            PIPE_JSON, **dict(ONE_PROCESS, COMPUTE_DTYPE=dt)), params, batch)
        ranks = _rank_results(res, tag)
        worst[dt] = max(_held("(a) %s rank %d" % (dt, r), rank, ref,
                              dt == "bfloat16")
                        for r, rank in enumerate(ranks))
        _same_replicas("(a) " + dt, ranks, ref["params"])
        for r, rank in enumerate(ranks):
            counts = {k.split("/", 1)[1]: int(v) for k, v in rank.items()
                      if k.startswith("launches/") and int(v)}
            if counts != want_counts:
                raise AssertionError("phase 27 (a) %s rank %d launched %s, "
                                     "not %s" % (dt, r, counts, want_counts))
            per_rank["%s rank %d" % (dt, r)] = counts
            for k, v in counts.items():
                launches[k] += v
    errs = {}
    for dt in ("float32", "bfloat16"):
        _held_kernels(dt, _rank_results(res, "kernels-" + dt), errs)
    print("phase 27 (a) configs/pipeline.json at 1 x 4 (bilstm-orig 4 x "
          "300, B=16, T=%d, PIPE_MICROBATCHES %d: four stages of one layer, "
          "microbatches of %d rows), four ranks on one card over gloo: a "
          "train and a valid step, bfloat16 as written (loss and gradients "
          "vs the one-process step, worst %.3g of the bound: %g of each "
          "gradient's peak, %g of the loss) and float32 (parameters after "
          "the step, worst %.3g of %g + %g x |p|); the ranks' replicated "
          "leaves bit for bit; launches per stage rank (a step and a valid "
          "step, L x M = %d x %d, no bubble ticks) %s; kernels B, 2 and 3 "
          "at a stage's (T=%d, B=%d) vs their plain versions, max abs err "
          "%s; the ranks took %.1f s"
          % (TRAIN_T, hp.PIPE_MICROBATCHES,
             hp.BATCH_SIZE // hp.PIPE_MICROBATCHES, worst["bfloat16"],
             BF16_GRAD_REL, BF16_LOSS_REL, worst["float32"], MESH_RTOL[0],
             MESH_RTOL[1], layers, hp.PIPE_MICROBATCHES, want_counts,
             TRAIN_T, hp.BATCH_SIZE // hp.PIPE_MICROBATCHES,
             {k: "%.3g" % v for k, v in errs.items()}, ranks_s))
    return {"worst": worst, "kernel_err": errs, "per_rank": per_rank,
            "launches": launches}


class _ShardwiseRouting:
    """One process's routed MoE as the expert mesh routes it: each of the
    n T-shards with its own capacity (``moe_mlp_topk`` per shard, the
    oracle of JAX's test of ``moe_mlp_ep_routed``)."""

    def __init__(self, n: int):
        self.n = n

    def __call__(self):
        return self

    def __enter__(self):
        from danet_tpu_torch.parallel import expert
        self.orig = expert.moe_mlp_topk
        orig, n = self.orig, self.n

        def shardwise(params, x, k=2, capacity_factor=1.25, mesh=None):
            t = x.shape[1] // n
            return torch.cat([orig(params, x[:, i * t:(i + 1) * t], k=k,
                                   capacity_factor=capacity_factor)
                              for i in range(n)], dim=1)
        expert.moe_mlp_topk = shardwise
        return self

    def __exit__(self, *exc):
        from danet_tpu_torch.parallel import expert
        expert.moe_mlp_topk = self.orig


def _expert_phase(tmp: str) -> dict:
    """(b): configs/moe-ep.json's keys at 1 x 2 on 2 ranks sharing the
    card, the soft mixture and MOE_TOP_K 2, bfloat16 as written and
    float32."""
    from danet_tpu_torch.parallel import smoke
    hp = load_config(MOE_JSON, **ONE_PROCESS)
    batch = _toy_batches(hp, 1)[0]
    params = hp.get_model()(hp).init(torch.Generator().manual_seed(0))
    weights.save_npz(os.path.join(tmp, "mp.npz"), params)
    np.savez(os.path.join(tmp, "mb.npz"), src=batch)
    forms = {"soft": {}, "top2": dict(ROUTED)}
    cases = [{"name": "%s-%s" % (form, dt), "kind": "step", "adam": True,
              "valid": True, "params": "mp.npz", "batch": "mb.npz",
              "configs": ["configs/moe-ep.json"],
              "keys": dict(EP_MESH, COMPUTE_DTYPE=dt, **extra)}
             for form, extra in forms.items()
             for dt in ("bfloat16", "float32")]
    spec = os.path.join(tmp, "ep.json")
    with open(spec, "w") as f:
        json.dump({"cases": cases}, f)
    t0 = time.perf_counter()
    smoke.launch(spec, os.path.join(tmp, "ep"), 2, device="cuda",
                 backend="gloo", shared_card=True, timeout=420)
    ranks_s = time.perf_counter() - t0
    res = smoke.load_results(os.path.join(tmp, "ep"), 2)
    n = EP_MESH["MESH_EXPERT"]
    worst, rest = {}, {}
    for form, extra in forms.items():
        for dt in ("bfloat16", "float32"):
            tag = "%s-%s" % (form, dt)
            ref = _one_process_step(
                load_config(MOE_JSON, **dict(ONE_PROCESS, COMPUTE_DTYPE=dt,
                                             **extra)), params, batch,
                _ShardwiseRouting(n) if extra else None)
            ranks = _rank_results(res, tag)
            worst[tag] = max(_held("(b) %s rank %d" % (tag, r), rank, ref,
                                   dt == "bfloat16")
                             for r, rank in enumerate(ranks))
            _same_replicas("(b) " + tag, ranks, ref["params"])
            rest[tag] = [int(r["bytes"]) for r in ranks]
    print("phase 27 (b) configs/moe-ep.json at 1 x 2 (moe-v1, 8 experts, "
          "ATTN_DIM 256, 4 blocks, B=16, T=%d), two ranks on one card over "
          "gloo, each holding 4 experts (bytes at rest per rank %s): a "
          "train and a valid step of the soft mixture and of MOE_TOP_K 2 "
          "(held against one process routing each T-shard with its own "
          "capacity, as JAX's moe_mlp_ep_routed does), bfloat16 as written "
          "and float32, vs the one-process step (worst ratio to the bound "
          "%s); the ranks' whole parameters bit for bit; the ranks took "
          "%.1f s" % (TRAIN_T, rest, {k: "%.3g" % v for k, v in
                                      worst.items()}, ranks_s))
    return {"worst": worst, "bytes": rest}


def phase_pipe_expert() -> dict:
    """Phase 27: pipeline and expert parallelism on one card (module
    docstring)."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="danet-phase27-")
    try:
        pipe = _pipeline_phase(tmp)
        ep = _expert_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("phase 27 took %.1f s on %s; stage-rank launches %s"
          % (time.perf_counter() - t0, nvidia_smi(),
             {k: v for k, v in pipe["launches"].items() if v}))
    return {"pipe": pipe, "expert": ep, "launches": pipe["launches"]}


SEQ_JSON = os.path.join(REPO_ROOT, "configs", "seq-parallel.json")
SEQ_MESH = {"MESH_DATA": 1, "MESH_SEQ": 4}
SEQ_ONE = {"MESH_DATA": 1, "MESH_SEQ": 1}
# (a): (H, T, B) of the relay's chunk scans (configs/seq-parallel.json's
# rows per data shard and 32-frame chunks) and of a training layer
SEQ_KERNEL_SHAPES = ((300, 32, 4), (600, 128, 32))
# (a): float32 (atol, rtol) of the state forms against their plain
# versions; bfloat16 keeps phase 6's
SEQ_FWD_TOL = (2e-6, 0.0)
SEQ_BWD_TOL = (2e-6, 1e-4)
# (b): the halo scheme's loss against the exact one-process loss: the
# warm-up approximates each chunk's incoming state (JAX's halo-decay
# bound, 5 % of the scale)
HALO_LOSS_REL = 5e-2
# (d): a 10 s request whose frame count splits over four ranks
SP_REQUEST_FRAMES = 1252


def _seq_kernels(shapes=SEQ_KERNEL_SHAPES, phase: int = 28,
                 part: str = "(a)") -> dict:
    """(a): the state forms of the saving forward and of kernel 3 and the
    lean state entry against their plain versions at each (H, T, B) of
    ``shapes``, timed beside the saving forward and kernel 3 without the
    state.  The state entry's worst errors are kept as "lstm_scan
    (state)", apart from the kernels line's lstm_scan."""
    rs = np.random.RandomState(phase)
    worst, times = {}, {}
    for h, t, b in shapes:
        for dt in (torch.float32, torch.bfloat16):
            xp, wh, c0, h0 = _carry_inputs(rs, t, b, h, dt)
            d_hs = torch.from_numpy((rs.randn(t, b, h) * 0.1).astype(
                np.float32)).cuda().to(dt)
            dc_t = torch.from_numpy((rs.randn(b, h) * 0.1).astype(
                np.float32)).cuda()
            outs = cuda_lstm.lstm_scan_train_state(xp, wh, c0, h0, True)
            refs = cuda_lstm.lstm_scan_train_state_plain(xp, wh, c0, h0,
                                                         True)
            hs, cs, acts, _ = refs
            c_prev = torch.cat([c0[None].to(dt), cs[:-1]])
            bouts = cuda_lstm.lstm_scan_bwd_seeded(d_hs, acts, cs, c_prev,
                                                   wh, True, dc_t)
            brefs = cuda_lstm.lstm_scan_bwd_plain(d_hs, acts, cs, c_prev,
                                                  wh, True, dc_t)
            entry = cuda_lstm.lstm_scan(xp, wh, c0, h0, True,
                                        return_state=True)
            erefs = cuda_lstm.lstm_scan_plain(xp, wh, c0, h0, True,
                                              return_state=True)
            torch.cuda.synchronize()
            f32 = dt == torch.float32
            tag = "H=%d %s" % (h, _tag(dt, True, t, b))
            parts = _check_kernels(phase, tag, dt, (
                ("lstm_scan_train_state", ("hs", "cs", "acts", "c_T"), outs,
                 refs, SEQ_FWD_TOL if f32 else TRAIN_FWD_TOL[dt]),
                ("lstm_scan_bwd_seeded", ("dxp", "dc0", "dh0"), bouts, brefs,
                 SEQ_BWD_TOL if f32 else TRAIN_BWD_TOL[dt]),
                # phase 24's bounds: hs at phase 4's, c_T at LSTM_ATOL or
                # phase 6's forward bounds
                ("lstm_scan (state)", ("state hs",), entry[:1], erefs[:1],
                 (LSTM_ATOL[dt], 0.0)),
                ("lstm_scan (state)", ("state c_T",), entry[1:], erefs[1:],
                 (LSTM_ATOL[dt], 0.0) if f32 else TRAIN_FWD_TOL[dt])),
                worst)
            ms = {
                "state save": cuda_ms(lambda: cuda_lstm.lstm_scan_train_state(
                    xp, wh, c0, h0, True), 10),
                "lean state": cuda_ms(lambda: cuda_lstm.lstm_scan(
                    xp, wh, c0, h0, True, return_state=True), 10),
                "save": cuda_ms(lambda: cuda_lstm.lstm_scan_train(
                    xp, wh, c0.to(dt), h0, True), 10),
                "seeded bwd": cuda_ms(lambda: cuda_lstm.lstm_scan_bwd_seeded(
                    d_hs, acts, cs, c_prev, wh, True, dc_t), 10),
                "bwd": cuda_ms(lambda: cuda_lstm.lstm_scan_bwd(
                    d_hs, acts, cs, c_prev, wh, True), 10)}
            plain = {
                "lstm_scan_train_state": cuda_ms(
                    lambda: cuda_lstm.lstm_scan_train_state_plain(
                        xp, wh, c0, h0, True), 2),
                "lstm_scan_bwd_seeded": cuda_ms(
                    lambda: cuda_lstm.lstm_scan_bwd_plain(
                        d_hs, acts, cs, c_prev, wh, True, dc_t), 2)}
            times[(h, t, b, dt)] = (ms, plain)
            print("phase %d %s %s: max_abs_err %s; ms %s; plain ms %s"
                  % (phase, part, tag, ", ".join(parts),
                     {k: "%.4f" % v for k, v in ms.items()},
                     {k: "%.4f" % v for k, v in plain.items()}))
    return {"max_abs_err": worst, "times": times}


def _seq_cases(tmp: str) -> tuple:
    """The spec of (b)-(d) and what the one-process references need."""
    hp = load_config(SEQ_JSON, **SEQ_ONE)
    batch = _toy_batches(hp, 1)[0]
    np.savez(os.path.join(tmp, "sb.npz"), src=batch)
    params = {}
    for enc in ("bilstm-orig", "attn-v1", "moe-v1"):
        ehp = load_config(SEQ_JSON, **dict(SEQ_ONE, ENCODER_TYPE=enc))
        params[enc] = ehp.get_model()(ehp).init(
            torch.Generator().manual_seed(0))
        weights.save_npz(os.path.join(tmp, "%s.npz" % enc), params[enc])
    steps = {"relay-bfloat16": {},
             "relay-float32": {"COMPUTE_DTYPE": "float32"},
             "halo-bfloat16": {"SP_RNN_SCHEME": "halo"}}
    for enc in ("attn-v1", "moe-v1"):
        for pat in ("ring", "ulysses"):
            steps["%s-%s" % (enc, pat)] = {"ENCODER_TYPE": enc,
                                           "SP_ATTN": pat,
                                           "COMPUTE_DTYPE": "float32"}
    cases = [{"name": name, "kind": "step", "adam": True, "valid": True,
              "params": "%s.npz" % keys.get("ENCODER_TYPE", "bilstm-orig"),
              "batch": "sb.npz", "configs": ["configs/seq-parallel.json"],
              "keys": dict(SEQ_MESH, **keys)} for name, keys in steps.items()]
    wave = np.random.RandomState(28).randn(
        64 * (SP_REQUEST_FRAMES - 1)).astype(np.float32) * 0.3
    mix = dsp.stft_ri(torch.from_numpy(wave)[None], hp.FFT_SIZE,
                      hp.FFT_STRIDE, hp.FFT_WND_ARRAY).numpy()
    np.savez(os.path.join(tmp, "mix.npz"), mix=mix)
    for enc in ("bilstm-orig", "attn-v1"):
        cases.append({"name": "separate-" + enc, "kind": "separate_sp",
                      "params": "%s.npz" % enc, "mix": "mix.npz",
                      "configs": ["configs/seq-parallel.json"],
                      "keys": dict(SEQ_MESH, ENCODER_TYPE=enc,
                                   COMPUTE_DTYPE="float32")})
    return batch, params, steps, mix, cases


def _held_grads(tag: str, rank: dict, want: dict, phase: int = 28) -> float:
    """A float32 rank's step against the one-process one: the loss within
    1e-4 relative and each gradient within 1e-4 of its tensor's peak
    (phase 7's card-vs-CPU bounds: the sequence-parallel step sums in
    another order than the dense one, and Adam turns that into up to 2 LR
    on a gradient element near zero).  -> the worst ratio to a bound."""
    worst = abs(float(rank["loss"]) - want["loss"]) / abs(want["loss"]) \
        / STEP_RTOL["float32"]
    for name, ref in want["grads"].items():
        peak = max(float(np.max(np.abs(ref))), 1e-30)
        worst = max(worst, float(np.max(np.abs(rank["grads/" + name] - ref)))
                    / peak / STEP_RTOL["float32"])
    if not worst <= 1.0:
        raise AssertionError("phase %d %s: off the one-process step (%.3g "
                             "of its bound; loss %.6g vs %.6g)"
                             % (phase, tag, worst, float(rank["loss"]),
                                want["loss"]))
    return worst


def phase_seq_parallel() -> dict:
    """Phase 28: sequence parallelism on one card (module docstring)."""
    import shutil
    import tempfile
    from danet_tpu_torch.parallel import smoke
    from danet_tpu_torch.parallel.sharding import nest
    t0 = time.perf_counter()
    kern = _seq_kernels()
    tmp = tempfile.mkdtemp(prefix="danet-phase28-")
    try:
        batch, params, steps, mix, cases = _seq_cases(tmp)
        spec = os.path.join(tmp, "seq.json")
        with open(spec, "w") as f:
            json.dump({"cases": cases}, f)
        t1 = time.perf_counter()
        smoke.launch(spec, os.path.join(tmp, "seq"), 4, device="cuda",
                     backend="gloo", shared_card=True, timeout=420)
        ranks_s = time.perf_counter() - t1
        res = smoke.load_results(os.path.join(tmp, "seq"), 4)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    worst, per_rank = {}, {}
    launches = {n: 0 for n in KERNELS}
    layers = encoders.BiLstmEncoder.N_LAYERS
    want = {"relay": {"lstm_scan_train_state": 2 * layers,
                      "lstm_scan_bwd_seeded": 2 * layers,
                      "lstm_scan": 2 * layers},
            "halo": {"lstm_scan_train_state": 2 * layers,
                     "lstm_scan_bwd_seeded": 2 * layers,
                     "lstm_scan_train": 2 * layers,
                     "lstm_scan_bwd": 2 * layers,
                     "lstm_scan": 4 * layers}}
    for name, keys in steps.items():
        enc = keys.get("ENCODER_TYPE", "bilstm-orig")
        bf16 = keys.get("COMPUTE_DTYPE", "bfloat16") == "bfloat16"
        one = load_config(SEQ_JSON, **dict(SEQ_ONE, **dict(
            keys, SP_RNN_SCHEME="relay")))
        ref = _one_process_step(one, params[enc], batch)
        ranks = _rank_results(res, name)
        if name.startswith("halo"):
            worst[name] = max(
                abs(float(r["loss"]) - ref["loss"]) / abs(ref["loss"])
                for r in ranks) / HALO_LOSS_REL
            if not worst[name] <= 1.0:
                raise AssertionError("phase 28 (b) %s: loss off the exact "
                                     "one-process loss by %.3g of the halo "
                                     "bound" % (name, worst[name]))
        elif bf16:
            worst[name] = max(_held("(b) %s rank %d" % (name, i), rank, ref,
                                    True) for i, rank in enumerate(ranks))
        else:
            worst[name] = max(_held_grads("(b) %s rank %d" % (name, i), rank,
                                          ref) for i, rank in
                              enumerate(ranks))
        _same_replicas("(b) " + name, ranks, ref["params"])
        counts = [{k.split("/", 1)[1]: int(v) for k, v in rank.items()
                   if k.startswith("launches/") and int(v)} for rank in ranks]
        if enc == "bilstm-orig":
            scheme = name.split("-")[0]
            for i, c in enumerate(counts):
                if c != want[scheme]:
                    raise AssertionError("phase 28 (b) %s rank %d launched "
                                         "%s, not %s" % (name, i, c,
                                                         want[scheme]))
                for k, v in c.items():
                    launches[k] += v
        per_rank[name] = counts[0]
    sep = {}
    for enc in ("bilstm-orig", "attn-v1"):
        hp = load_config(SEQ_JSON, **dict(SEQ_ONE, ENCODER_TYPE=enc,
                                          COMPUTE_DTYPE="float32"))
        model = hp.get_model()(hp)
        tree = nest(weights.leaf_names(params[enc]),
                    [t.cuda() for t in weights.leaves(params[enc])])
        with torch.no_grad():
            ref = model.separate(tree, torch.from_numpy(mix).cuda()
                                 ).cpu().numpy()
        peak = float(np.abs(ref).max())
        sep[enc] = max(float(np.abs(r["y"] - ref).max()) for r in
                       _rank_results(res, "separate-" + enc)) / peak
        if not sep[enc] <= SERVE_RTOL:
            raise AssertionError("phase 28 (d) separate_sp %s: %.3g of the "
                                 "peak off separate" % (enc, sep[enc]))
    print("phase 28 (b)-(c) configs/seq-parallel.json's keys at 1 x 4 "
          "(bilstm-orig 4 x 300, B=8, T=%d: chunks of %d frames; SP_HALO "
          "16), four ranks on one card over gloo, a train and a valid step "
          "each: the relay in bfloat16 and float32 and the halo scheme in "
          "bfloat16 (worst ratio to the bound %s: phase 27's bounds, the "
          "halo's loss within %g of the exact loss); attn-v1 and moe-v1 "
          "with ring and Ulysses attention, float32 (%s); the ranks' "
          "parameters bit "
          "for bit; launches per rank (a step and a valid step) %s; the "
          "ranks took %.1f s"
          % (TRAIN_T, TRAIN_T // SEQ_MESH["MESH_SEQ"],
             {k: "%.3g" % v for k, v in worst.items()
              if not k.startswith(("attn", "moe"))}, HALO_LOSS_REL,
             {k: "%.3g" % v for k, v in worst.items()
              if k.startswith(("attn", "moe"))}, per_rank, ranks_s))
    print("phase 28 (d) separate_sp on a %.2f s request (T=%d, float32) on "
          "the four ranks vs separate on one process, of the peak: %s "
          "(bound %g)" % (64 * (SP_REQUEST_FRAMES - 1) / SMPRATE,
                          SP_REQUEST_FRAMES,
                          {k: "%.3g" % v for k, v in sep.items()},
                          SERVE_RTOL))
    print("phase 28 took %.1f s on %s; main-path launches %s"
          % (time.perf_counter() - t0, nvidia_smi(),
             {k: v for k, v in launches.items() if v}))
    return {"kernels": kern, "worst": worst, "separate": sep,
            "per_rank": per_rank, "launches": launches}


SEQ_CONV_MESHES = {"1x4": {"MESH_DATA": 1, "MESH_SEQ": 4},
                   "2x2": {"MESH_DATA": 2, "MESH_SEQ": 2}}
SEQ_CONV_ONE = {"MESH_DATA": 1, "MESH_SEQ": 1}
# the models at full width: (config file under configs/ or None for
# default.json's widths, keys); dtypes: float32, and the file's bfloat16
SEQ_CONV_MODELS = {
    "tcn-v1": ("tcn.json", {}),
    "dprnn-v1": ("dprnn.json", {"DPRNN_HOP": 64}),
    "conv-bilstm-v1": (None, {"ENCODER_TYPE": "conv-bilstm-v1"}),
    "tasnet-v1": (None, {"MODEL_TYPE": "tasnet-v1"})}
SEQ_CONV_B = 8
# the held steps: ANCHOR_AUX_LOSS 0 (its term jumps even in float64 at the
# files' 0.5: phase 21 (c)), no leaky ReLU kink (COMPARE_LEAKAGE) and
# HEAD_SCALE's head (_init), phase 21 (b)'s well-conditioned start
SEQ_CONV_HELD = {"ANCHOR_AUX_LOSS": 0.0, "RELU_LEAKAGE": COMPARE_LEAKAGE,
                 "BATCH_SIZE": SEQ_CONV_B}
# (b): tasnet-v1's separate_wav request
SEQ_CONV_REQUEST = 10 * SMPRATE
# (c): the shapes the held steps give the scan kernels, at 1 x 4 and at 2
# x 2 alike.  dprnn-v1 (H=128, B=8, T=256, 64-frame segments): the intra
# scan (T=64) on the rank's rows x segments (8 x 1, or 4 x 2), the inter
# scan (T=4, every segment) on its rows x positions (8 x 16, or 4 x 32),
# kernels B, 2 and 3 on ranks' processes; conv-bilstm-v1's relay (H=256,
# T=128 pooled twice to 32): the state forms and the lean state entry on
# a rank's chunk of 8 frames x 8 rows, or 16 x 4
SEQ_CONV_DPRNN_SCANS = {"intra": (64, 8), "inter": (4, 128)}
SEQ_CONV_RELAY_SHAPES = ((256, 8, 8), (256, 16, 4))
# (a)'s reading: the relative change of the input under which the
# one-process step's own move is printed beside the ranks'
SEQ_CONV_NUDGE = 1e-6


def _seq_conv_load(model: str, **keys):
    """The config of a phase 29 model: its file (if any), its keys, then
    ``keys``."""
    name, extra = SEQ_CONV_MODELS[model]
    files = [os.path.join(REPO_ROOT, "configs", name)] if name else []
    return load_config(*files, **dict(extra, **keys)), (
        ["configs/" + name] if name else [])


def _seq_conv_launches(model: str) -> dict:
    """The LSTM kernels one rank launches in a train step and a valid step
    of ``model`` under MESH_SEQ: dprnn-v1's dual path kernels 2 and 3 in
    the step and kernel B in the valid step, once per path and block (the
    intra scan over the rank's segments, the inter scan over every segment
    of its positions); conv-bilstm-v1's relay one state-entry saving
    forward, one seeded backward and one state-entry lean forward per
    direction and layer; none for tcn-v1 and tasnet-v1."""
    if model == "dprnn-v1":
        n = 2 * _seq_conv_load(model)[0].DPRNN_BLOCKS
        return {"bilstm_scan_train": n, "bilstm_scan_bwd": n,
                "bilstm_scan": n}
    if model == "conv-bilstm-v1":
        return {"lstm_scan_train_state": 4, "lstm_scan_bwd_seeded": 4,
                "lstm_scan": 4}
    return {}


def _seq_conv_cases(tmp: str) -> tuple:
    """The spec of phase 29 and what its one-process references need:
    per model and dtype the held keys, the seeded weights and the batch
    (its T the mesh's effective bucket); tcn-v1's and dprnn-v1's files'
    own keys as a reading; tasnet-v1's 10 s request."""
    from danet_tpu_torch.train.trainer import effective_bucket
    refs, cases = {}, []
    for model, (name, _) in SEQ_CONV_MODELS.items():
        tag = model.split("-v1")[0]
        dts = ["float32"] + (["bfloat16"] if name else [])
        runs = [(dt, dict(SEQ_CONV_HELD, COMPUTE_DTYPE=dt)) for dt in dts]
        if name:
            runs.append(("file", {"BATCH_SIZE": SEQ_CONV_B}))
        hp, files = _seq_conv_load(model, **SEQ_CONV_MESHES["1x4"])
        bucket = effective_bucket(hp)
        batch = _toy_batches(_seq_conv_load(
            model, BATCH_SIZE=SEQ_CONV_B, TIME_BUCKET=bucket)[0], 1)[0]
        np.savez(os.path.join(tmp, "%s-b.npz" % tag), src=batch)
        for run, keys in runs:
            one = _seq_conv_load(model, **dict(keys, **SEQ_CONV_ONE))[0]
            m = one.get_model()(one)
            params = (m.init(torch.Generator().manual_seed(0))
                      if run == "file" else _init(m))
            weights.save_npz(os.path.join(tmp, "%s-%s.npz" % (tag, run)),
                             params)
            refs[(model, run)] = (one, params, batch)
            for mesh, mkeys in SEQ_CONV_MESHES.items():
                if run == "file" and mesh != "1x4":
                    continue
                cases.append({"name": "%s-%s-%s" % (tag, run, mesh),
                              "kind": "step", "adam": True, "valid": True,
                              "params": "%s-%s.npz" % (tag, run),
                              "batch": "%s-b.npz" % tag, "configs": files,
                              "keys": dict(SEQ_CONV_MODELS[model][1],
                                           **dict(keys, **mkeys))})
    wav = (np.random.RandomState(29).randn(1, SEQ_CONV_REQUEST) * 0.3) \
        .astype(np.float32)
    np.savez(os.path.join(tmp, "wav.npz"), x=wav)
    for dt in ("float32", "bfloat16"):
        for path, (t, rows) in SEQ_CONV_DPRNN_SCANS.items():
            cases.append({"name": "kernels-%s-%s" % (path, dt),
                          "kind": "kernels", "T": t, "rows": rows, "H": 128,
                          "dtype": dt, "tol": _scan_tols(dt)})
    for mesh, mkeys in SEQ_CONV_MESHES.items():
        cases.append({"name": "tasnet-separate-" + mesh, "kind": "sp_conv",
                      "stack": "tasnet", "separate_wav": True,
                      "params": "tasnet-float32.npz", "x": "wav.npz",
                      "keys": dict(SEQ_CONV_MODELS["tasnet-v1"][1],
                                   **mkeys)})
    return refs, cases, wav


def phase_seq_conv() -> dict:
    """Phase 29: sequence parallelism of tcn-v1, dprnn-v1, conv-bilstm-v1
    and tasnet-v1 on one card (module docstring)."""
    import shutil
    import tempfile
    from danet_tpu_torch.parallel import smoke
    from danet_tpu_torch.parallel.sharding import nest
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="danet-phase29-")
    try:
        refs, cases, wav = _seq_conv_cases(tmp)
        spec = os.path.join(tmp, "seqconv.json")
        with open(spec, "w") as f:
            json.dump({"cases": cases}, f)
        t1 = time.perf_counter()
        smoke.launch(spec, os.path.join(tmp, "ranks"), 4, device="cuda",
                     backend="gloo", shared_card=True, timeout=420)
        ranks_s = time.perf_counter() - t1
        res = smoke.load_results(os.path.join(tmp, "ranks"), 4)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    worst, reading, per_rank = {}, {}, {}
    launches = {n: 0 for n in KERNELS}
    for (model, run), (one, params, batch) in refs.items():
        tag = model.split("-v1")[0]
        ref = _one_process_step(one, params, batch)
        for mesh in SEQ_CONV_MESHES:
            if run == "file" and mesh != "1x4":
                continue
            name = "%s-%s-%s" % (tag, run, mesh)
            ranks = _rank_results(res, name)
            if not ranks or not all(ranks):
                raise AssertionError("phase 29 (a) %s: a rank returned no "
                                     "results" % name)
            if run == "file":
                moved = _one_process_step(one, params, batch * (
                    1.0 + SEQ_CONV_NUDGE))
                reading[name] = tuple(
                    (max(abs(float(r["loss"]) - ref["loss"])
                         / abs(ref["loss"]) for r in rs),
                     max(float(np.max(np.abs(r["grads/" + k] - v)))
                         / max(float(np.max(np.abs(v))), 1e-30)
                         for r in rs for k, v in ref["grads"].items()))
                    for rs in (ranks, [{"loss": moved["loss"], **{
                        "grads/" + k: v for k, v in moved["grads"].items()}}]))
            elif run == "bfloat16":
                worst[name] = max(_held("(a) %s rank %d" % (name, i), r, ref,
                                        True, phase=29)
                                  for i, r in enumerate(ranks))
            else:
                worst[name] = max(_held_grads("(a) %s rank %d" % (name, i), r,
                                              ref, phase=29)
                                  for i, r in enumerate(ranks))
            _same_replicas("(a) " + name, ranks, ref["params"], phase=29)
            counts = [{k.split("/", 1)[1]: int(v) for k, v in r.items()
                       if k.startswith("launches/") and int(v)}
                      for r in ranks]
            want = _seq_conv_launches(model)
            for i, c in enumerate(counts):
                if c != want:
                    raise AssertionError("phase 29 (a) %s rank %d launched "
                                         "%s, not %s" % (name, i, c, want))
                if run != "file":
                    for k, v in c.items():
                        launches[k] += v
            per_rank[name] = counts[0]
    hp = _seq_conv_load("tasnet-v1", **SEQ_CONV_ONE)[0]
    model = hp.get_model()(hp)
    _, params, _ = refs[("tasnet-v1", "float32")]
    tree = nest(weights.leaf_names(params),
                [t.cuda() for t in weights.leaves(params)])
    with torch.no_grad():
        ref = model.separate_wav(tree, torch.from_numpy(wav).cuda()) \
            .cpu().numpy()
    peak = float(np.abs(ref).max())
    sep = {}
    for mesh in SEQ_CONV_MESHES:
        sep[mesh] = max(float(np.abs(r["y"] - ref).max()) for r in
                        _rank_results(res, "tasnet-separate-" + mesh)) / peak
        if not sep[mesh] <= SERVE_RTOL:
            raise AssertionError("phase 29 (b) tasnet-v1 separate_wav at %s:"
                                 " %.3g of the peak off one process"
                                 % (mesh, sep[mesh]))
    print("phase 29 (a) tcn-v1 (configs/tcn.json, 12 blocks 256 / 512, T=128"
          ": chunks of 32 frames at 1 x 4, largest span 16), dprnn-v1 "
          "(configs/dprnn.json, DPRNN_HOP 64, T=256 through effective_bucket"
          "), conv-bilstm-v1 (FFT_SIZE 256, T=128) and tasnet-v1 (default "
          "widths, T=128), B=%d, at 1 x 4 and 2 x 2 (data x seq), four ranks "
          "on one card over gloo, a train and a valid step each, held "
          "against one process (ANCHOR_AUX_LOSS 0, RELU_LEAKAGE %g, "
          "HEAD_SCALE): worst ratio to the bound %s (bfloat16: phase 27's "
          "bounds; float32: phase 28's); the ranks' parameters bit for bit; "
          "launches per rank %s; the ranks took %.1f s"
          % (SEQ_CONV_B, COMPARE_LEAKAGE,
             {k: "%.3g" % v for k, v in worst.items()},
             {k: v for k, v in per_rank.items() if v}, ranks_s))
    print("phase 29 (a) reading, not held: the files' own keys (bfloat16, "
          "ANCHOR_AUX_LOSS 0.5, kmeans, the head as initialised) at 1 x 4, "
          "(loss relative error, worst gradient error of its peak) of the "
          "ranks against one process, and beside it the one-process step's "
          "own move under a %g relative change of the input: %s"
          % (SEQ_CONV_NUDGE, {k: "%.3g, %.3g; own %.3g, %.3g" % (a + b)
                              for k, (a, b) in reading.items()}))
    print("phase 29 (b) tasnet-v1 separate_wav on a %d s request on the "
          "four ranks vs one process, of the peak: %s (bound %g)"
          % (SEQ_CONV_REQUEST // SMPRATE,
             {k: "%.3g" % v for k, v in sep.items()}, SERVE_RTOL))
    kernel_err = {}
    for dt in ("float32", "bfloat16"):
        for path in SEQ_CONV_DPRNN_SCANS:
            _held_kernels("%s %s" % (path, dt), _rank_results(
                res, "kernels-%s-%s" % (path, dt)), kernel_err, phase=29)
    relay = _seq_kernels(SEQ_CONV_RELAY_SHAPES, phase=29, part="(c)")
    print("phase 29 (c) dprnn-v1's scans on the ranks, kernels B, 2 and 3 "
          "against their plain versions (H=128; intra T=%d, %d rows; inter "
          "T=%d, %d rows; phase 4's and phase 6's bounds), max abs err %s; "
          "conv-bilstm-v1's relay, the state forms and the lean state entry "
          "at (H, T, B) %s: the lines above"
          % (*SEQ_CONV_DPRNN_SCANS["intra"], *SEQ_CONV_DPRNN_SCANS["inter"],
             {k: "%.3g" % v for k, v in kernel_err.items()},
             SEQ_CONV_RELAY_SHAPES))
    print("phase 29 took %.1f s on %s; main-path launches %s"
          % (time.perf_counter() - t0, nvidia_smi(),
             {k: v for k, v in launches.items() if v}))
    return {"worst": worst, "reading": reading, "separate": sep,
            "per_rank": per_rank, "launches": launches,
            "kernel_err": kernel_err, "relay": relay["max_abs_err"]}


def _bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """(ms, "operations" or "bytes"): the least time of the work on the
    card, the larger of its FLOPs at the ``peak`` rate (float32's by
    default) and its bytes at the memory rate."""
    by_ops = flops / peak * 1e3
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
    # the state forms: c_T out, or the seed dc_T in
    carry = b * h if name in ("lstm_scan_train_state",
                              "lstm_scan_bwd_seeded") else 0
    if "_bwd" in name:                 # d_hs, cs, c_prev, acts, wh; outs
        return flops, 4.0 * d * (3 * t * b * h + 4 * t * b * h + 4 * h * h
                                 + 4 * t * b * h + 2 * b * h + carry)
    out = t * b * h * (6 if "_train" in name else 1)
    return flops, 4.0 * d * (4 * t * b * h + 4 * h * h + 2 * b * h + out
                             + carry)


# the state forms' library yardsticks: nn.LSTM's, which takes (h0, c0) and
# returns the final carry too
STATE_LIBRARY = {"lstm_scan_train_state": "lstm_scan_train",
                 "lstm_scan_bwd_seeded": "lstm_scan_bwd"}
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


# each phase function's wall seconds in this run, printed before the
# kernels line (the script's time against its limit, phase by phase)
SECONDS = {}


def _timed(fn, *args):
    """``fn(*args)``, its wall seconds kept in SECONDS under its name."""
    t0 = time.perf_counter()
    out = fn(*args)
    SECONDS[fn.__name__] = round(time.perf_counter() - t0, 1)
    return out


def main():
    _timed(phase_environment)
    _timed(phase_build)
    window = load_config().FFT_WND_ARRAY
    stft = _timed(phase_stft, window)
    scan = _timed(phase_bilstm)
    serving = _timed(phase_serving)
    train_kernels = _timed(phase_train_kernels)
    training = _timed(phase_training)
    uni_kernels = _timed(phase_lstm_unidirectional)
    gru_kernels = _timed(phase_gru)
    serving_uni = _timed(phase_serving_unidirectional)
    training_uni = _timed(phase_training_unidirectional)
    library = _timed(phase_library, window)
    for name, run in (("bilstm_scan_bwd", train_kernels),
                      ("lstm_scan_bwd", uni_kernels)):
        ms = run["times"][name][0]
        print("kernel 3 %s T=%d B=32 float32: %.4f ms, %.3f us/step; library "
              "%.4f ms (%s)" % (name, TRAIN_T, ms, 1e3 * ms / TRAIN_T,
                                *library[name]))
    flash_kernels = _timed(phase_flash_kernels)
    serving_attn = _timed(phase_serving_attention)
    training_attn = _timed(phase_training_attention)
    logmag = _timed(phase_stft_logmag, window)
    training_tpu = _timed(phase_training_tpu)
    serving_tpu = _timed(phase_serving_tpu)
    tpu_whole = _timed(phase_tpu_whole)
    checkpoints = _timed(phase_checkpoints)
    new_encoders = _timed(phase_new_encoders)
    tasnet = _timed(phase_tasnet)
    causal_moe = _timed(phase_causal_moe)
    streaming = _timed(phase_streaming)
    bundles = _timed(phase_bundles, window)
    mesh = _timed(phase_mesh)
    pipe_expert = _timed(phase_pipe_expert)
    seq = _timed(phase_seq_parallel)
    seq_conv = _timed(phase_seq_conv)
    print("summary: bilstm_scan bfloat16 max_abs_err %.3g (atol %g); "
          "serving worst error vs CPU %.3g of the peak (rtol %g), lstm-orig "
          "%.3g, gru-v1 %.3g, attn-v1 %.3g; train steps vs CPU: worst "
          "relative loss/SNR err %s, step-1 gradients %.3g of the peak; "
          "lstm-orig %s, every step's gradients %.3g; gru-v1 %s, %.3g; "
          "attn-v1 %s, %.3g; configs/tpu.json serving %.3g, training %s, "
          "%.3g; configs/tpu.json whole: ingest %.3g, 8 steps %.3g, %.3g; "
          "checkpoints: resumed bit for bit, EMA and GRAD_ACCUM steps %.3g, "
          "%.3g; tasnet-v1: serving %.3g, training %s, %.3g, RELU_LEAKAGE "
          "0.3 in float64 %.3g; tcn-v1 and dprnn-v1 in float64 at their "
          "files' keys %.3g, %.3g (not held), at ANCHOR_AUX_LOSS 0 %.3g, "
          "%.3g; causal attn-v1: serving %.3g, chunked vs "
          "dense %.3g, training %.3g, %.3g; moe-v1 serving soft %.3g, "
          "routed %.3g, flash %.3g, training soft %s, %.3g, routed %s, "
          "%.3g, flash %.3g, %.3g"
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
             tasnet["training"]["float64"][("cuda", "float64")][1],
             new_encoders["float64"]["tcn-v1"][("cuda", "float64")][1],
             new_encoders["float64"]["dprnn-v1"][("cuda", "float64")][1],
             new_encoders["float64"]["tcn-v1 ANCHOR_AUX_LOSS 0"][
                 ("cuda", "float64")][1],
             new_encoders["float64"]["dprnn-v1 ANCHOR_AUX_LOSS 0"][
                 ("cuda", "float64")][1],
             causal_moe["causal"]["serving"]["max_rel_err"],
             causal_moe["causal"]["serving"]["chunked_vs_dense"],
             causal_moe["causal"]["training"]["step_rel"],
             causal_moe["causal"]["training"]["grad_rel"],
             causal_moe["moe"]["serving"]["soft"]["max_rel_err"],
             causal_moe["moe"]["serving"]["routed"]["max_rel_err"],
             causal_moe["moe"]["serving"]["flash"]["max_rel_err"],
             causal_moe["moe"]["training"]["soft"]["step_rel"],
             causal_moe["moe"]["training"]["soft"]["grad_rel"],
             causal_moe["moe"]["training"]["routed"]["step_rel"],
             causal_moe["moe"]["training"]["routed"]["grad_rel"],
             causal_moe["moe"]["training"]["flash"]["step_rel"],
             causal_moe["moe"]["training"]["flash"]["grad_rel"]))
    print("summary, phase 24: kernel 1 with its final carry max_abs_err "
          "float32 %.3g, bfloat16 %.3g; streams vs CPU (of the peak) %s; "
          "separate_long %.3g; demo card vs CPU (int16 steps) %s"
          % (streaming["carry"]["max_abs_err"][torch.float32],
             streaming["carry"]["max_abs_err"][torch.bfloat16],
             {k: "%.3g" % v["max_rel_err"]
              for k, v in streaming["cells"].items()},
             streaming["long"]["max_rel_err"],
             streaming["cli"]["int16_steps"]))
    paper = bundles["paper"]
    print("summary, phase 25: ops vs plain on the card %s; paper-model "
          "bundle vs live (of the peak) %s, vs the CPU bundle %s, bundle / "
          "live ms %s; attn-v1 flash bundle %.3g; bfloat16 weights %.3g "
          "(artifact %.3f of float32); stream bundles vs live %s; "
          "stft_mag_logmag %.3g; CLI int16 steps %s"
          % ({k: "%.3g" % v for k, v in bundles["ops"].items()},
             {n: "%.3g" % r["max_rel_err"] for n, r in paper.items()},
             {n: "%.3g" % r["cpu_rel_err"] for n, r in paper.items()},
             {n: "%.3f / %.3f" % (r["bundle_ms"], r["live_ms"])
              for n, r in paper.items()},
             bundles["flash"]["max_rel_err"],
             bundles["bf16"]["max_rel_err"], bundles["bf16"]["ratio"],
             {k: "%.3g" % v for k, v in bundles["streams"].items()},
             bundles["mag"]["max_abs_err"], bundles["cli"]))
    print("summary, phase 26: world 1 over NCCL bit for bit the plain "
          "Trainer (eager and an 8-step graph); two ranks on one card: "
          "parameters vs the one-process step %.3g, kernels vs plain %s; "
          "launches per rank %s"
          % (mesh["params_err"], {k: "%.3g" % v for k, v in
                                  mesh["kernel_err"].items()},
             mesh["per_rank"]))
    print("summary, phase 27: the pipeline at 1 x 4 vs the one-process "
          "step (of the bound) %s, kernels vs plain at a stage's shapes %s, "
          "launches per stage rank %s; expert parallelism at 1 x 2 %s"
          % ({k: "%.3g" % v for k, v in pipe_expert["pipe"]["worst"].items()},
             {k: "%.3g" % v for k, v in
              pipe_expert["pipe"]["kernel_err"].items()},
             pipe_expert["pipe"]["per_rank"],
             {k: "%.3g" % v for k, v in
              pipe_expert["expert"]["worst"].items()}))
    print("summary, phase 28: the state forms vs plain (float32, bfloat16) "
          "%s; sequence parallelism at 1 x 4 vs the one-process step (of "
          "the bound) %s; separate_sp vs separate (of the peak) %s; "
          "launches per rank %s"
          % ({k: "%.3g, %.3g" % (v[torch.float32], v[torch.bfloat16])
              for k, v in seq["kernels"]["max_abs_err"].items()},
             {k: "%.3g" % v for k, v in seq["worst"].items()},
             {k: "%.3g" % v for k, v in seq["separate"].items()},
             seq["per_rank"]))
    print("summary, phase 29: tcn-v1, dprnn-v1, conv-bilstm-v1 and "
          "tasnet-v1 under MESH_SEQ at 1 x 4 and 2 x 2 vs the one-process "
          "step (of the bound) %s; tasnet-v1 separate_wav (of the peak) %s; "
          "launches per rank %s; dprnn-v1's scans vs plain %s; the relay's "
          "vs plain (float32, bfloat16) %s"
          % ({k: "%.3g" % v for k, v in seq_conv["worst"].items()},
             {k: "%.3g" % v for k, v in seq_conv["separate"].items()},
             {k: v for k, v in seq_conv["per_rank"].items() if v},
             {k: "%.3g" % v for k, v in seq_conv["kernel_err"].items()},
             {k: "%.3g, %.3g" % (v[torch.float32], v[torch.bfloat16])
              for k, v in seq_conv["relay"].items()}))
    # launches: the counts of the main paths that run each kernel, each
    # zeroed just before its path and read just after it (kernel 6's: phase
    # 25 (f), dsp.stft_mag_logmag)
    paths = [serving["launches"], training["launches"],
             serving_attn["launches"], training_attn["launches"],
             serving_tpu["launches"], training_tpu["launches"],
             tpu_whole["launches"], checkpoints["launches"],
             new_encoders["launches"], tasnet["launches"],
             causal_moe["launches"], streaming["launches"],
             bundles["launches"], mesh["launches"],
             pipe_expert["launches"], seq["launches"],
             seq_conv["launches"]] + [
        run["launches"] for run in list(serving_uni.values())
        + list(training_uni.values())]
    launches = {name: sum(p[name] for p in paths) for name in KERNELS}
    ft = flash_kernels["times"]
    times = dict(stft=stft["times"][(1, 80000)],
                 bilstm_scan=scan["times"][(1251, 1)],
                 **train_kernels["times"], **uni_kernels["times"],
                 **gru_kernels["times"],
                 flash_attn=ft[("flash_attn", 1280, 1)],
                 flash_attn_bwd_dkv=ft[("flash_attn_bwd_dkv", TRAIN_T, 32)],
                 flash_attn_bwd_dq=ft[("flash_attn_bwd_dq", TRAIN_T, 32)],
                 stft_logmag=logmag["times"])
    ms28, plain28 = seq["kernels"]["times"][(600, TRAIN_T, 32, torch.float32)]
    times["lstm_scan_train_state"] = (ms28["state save"],
                                      plain28["lstm_scan_train_state"])
    times["lstm_scan_bwd_seeded"] = (ms28["seeded bwd"],
                                     plain28["lstm_scan_bwd_seeded"])
    times["stft_ri"] = times.pop("stft")
    errs = {"stft_ri": stft["max_abs_err"],
            "bilstm_scan": scan["max_abs_err"][torch.float32],
            "stft_logmag": logmag["max_abs_err"]}
    for phase in (train_kernels, uni_kernels, gru_kernels, flash_kernels,
                  seq["kernels"]):
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
        "lstm_scan_train_state": (
            "danet_tpu_torch/csrc/lstm_scan_lean.cu",
            "danet_tpu/ops/pallas/lstm.py:242 (n_dirs=1, save=True; "
            "JAX runs return_state under autograd on its XLA scan, "
            "danet_tpu/ops/rnn.py:125-126)"),
        "lstm_scan_bwd_seeded": (
            "danet_tpu_torch/csrc/bilstm_scan_bwd.cu",
            "danet_tpu/ops/pallas/lstm.py:275 (n_dirs=1; the final carry's "
            "cotangent, which JAX's XLA scan differentiates)"),
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
        lib_ms, lib_note = library[STATE_LIBRARY.get(name, name)]
        if name in STATE_LIBRARY:
            lib_note += "; with (h0, c0) in and (h_n, c_n) out"
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
        if name == "lstm_scan":
            state_ms, lean_ms = streaming["carry"]["times"][(600, t, b)][:2]
            entry["state_ms"] = state_ms
            entry["state"] = ("return_state's entry (the float32 c0 and "
                              "final carry c_T), timed beside the lean "
                              "entry's %.4f ms in phase 24 (a)" % lean_ms)
        if name == "flash_attn":
            entry["splits"] = cuda_attn.flash_splits(
                b, t, ATTN_H,
                torch.cuda.get_device_properties(0).multi_processor_count)
        if name == "stft_logmag":
            entry["launches_of"] = ("phase 25 (f): dsp.stft_mag_logmag, "
                                    "its one caller")
        kernels.append(entry)
        if not launches[name]:
            raise AssertionError("%s was not launched on its main path"
                                 % name)
    print("seconds per phase function: %s (%.1f s in all)"
          % (json.dumps(SECONDS), sum(SECONDS.values())))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
