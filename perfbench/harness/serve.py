"""Serving cells: one closed-loop client of the program's
``Separator.separate``.  Each request is one mixture waveform; the next is
sent when the last one's separated sources are numpy arrays on the host,
as a caller that waits for its answer sends them.  A request's latency is
that call's time on the host's clock; the client's time to build the next
waveform is outside it.

Set-up loads the weights from the seed and sends a few requests that span
the mix's lengths.  After the window a sample of the answers, drawn from
the seed with the longest among them, is compared with the reference
separating the same waveforms with the same weights.
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.harness import cell as cell_mod
from perfbench.harness import traffic as traffic_mod
from perfbench.harness import train
from perfbench.harness import weights as weights_mod
from perfbench.harness.counts import frames_of
from perfbench.harness.trace import profiled
from perfbench.reference import danet as ref

WARM_REPEATS = 2


def separator(cell, device):
    """The program's ``Separator`` with the seed's weights."""
    from danet_tpu_torch.serve import Separator
    _, m = train.model(cell)
    params = weights_mod.make(cell.keys, cell.widths, cell.seed, device)
    return Separator(m, params, device)


def compare(cell, answers: dict, traffic, device) -> dict:
    """{'wave_gap'}: the largest, over the sampled requests, of the
    largest difference between the program's separated waveforms and the
    reference's over the reference's peak."""
    ref.exact_float32()
    params = weights_mod.make(cell.keys, cell.widths, cell.seed, device)
    ids = sorted(answers)
    waves = [torch.from_numpy(traffic.request(i)).to(device) for i in ids]
    want = ref.separate(cell.keys, params, waves)
    gap = 0.0
    for i, w in zip(ids, want):
        got = torch.from_numpy(answers[i]).to(device)
        gap = max(gap, float((got - w).abs().max() / w.abs().max()))
    return {"wave_gap": gap}


def sample(n_done: int, lengths: list, seed: int, size: int) -> list:
    """``size`` request indices drawn from the seed among the ``n_done``
    finished, the longest (the first of them) included."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 6])
    ids = set(rng.choice(n_done, min(size, n_done) - 1,
                         replace=False).tolist())
    ids.add(int(np.argmax(lengths[:n_done])))
    return sorted(ids)


def run(cell, t_start: float, device="cuda") -> cell_mod.Result:
    cell_mod.reset_peak(device)
    sep = separator(cell, device)
    cell_mod.stage("separator, weights", t_start)
    traffic = traffic_mod.make(cell.traffic, cell.keys, cell.seed)
    cell_mod.stage("traffic", t_start)
    rng = np.random.default_rng(0)
    for n in traffic.warm_lengths():
        for _ in range(WARM_REPEATS):
            sep.separate(rng.standard_normal(n).astype(np.float32) * 0.1)
    cell_mod.sync(device)
    cell_mod.stage("warm requests", t_start)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    lat, lengths, answers = [], [], []
    slices = []

    def one(i):
        from torch.profiler import record_function
        with record_function("bench.client"):
            wav = traffic.request(i)
        with record_function("bench.request"):
            ts = time.perf_counter()
            try:
                out = sep.separate(wav)
            except RuntimeError:
                out = None
            lat.append(time.perf_counter() - ts)
        lengths.append(len(wav))
        answers.append(out)

    if cell.trace:
        with profiled(slices):
            for i in range(int(cell.traffic["trace_requests"])):
                one(i)
    else:
        i = 0
        while time.perf_counter() - t0 < cell.seconds:
            one(i)
            i += 1
    n = len(answers)
    bad = [i for i, a in enumerate(answers)
           if a is None or a.shape != (int(cell.keys["MAX_N_SIGNAL"]),
                                       lengths[i])]
    failed = len(bad)
    peak = cell_mod.peak_bytes(device)
    keep = {i: answers[i] for i in sample(n, lengths, cell.seed,
                                          int(cell.traffic["check_sample"]))}
    del sep, answers
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if any(keep[i] is None or i in bad for i in keep):
        got = {"wave_gap": float("inf")}
    else:
        got = compare(cell, keep, traffic, device)
    ms = np.asarray(lat) * 1e3
    metrics = {"setup_s": (setup_s, "s"),
               "request_ms_p50": (float(np.percentile(ms, 50)), "ms"),
               "request_ms_p95": (float(np.percentile(ms, 95)), "ms")}
    fft, hop = int(cell.keys["FFT_SIZE"]), int(cell.keys["FFT_STRIDE"])
    ctx = SimpleNamespace(keys=cell.keys, widths=cell.widths,
                          traffic=cell.traffic, chips=1,
                          requests=[frames_of(n_s, fft, hop)
                                    for n_s in lengths],
                          slice=slices[0] if slices else None)
    return train.finish(cell, metrics, ctx, got, n, failed, peak, device)
