"""The one traffic generator, driven by a mix's parameters
(``traffic/<name>.json``) and the run's seed.  The program receives only
what it makes.

Every waveform is the synthetic speech (RMS 0.2) times ``pcm_scale``:
at 8192 it has the amplitude of 16-bit PCM read as the files store it
(RMS about 1,640), which is how the reference's WAV loader hands WSJ0's
samples to the model.

``kind: "train"``: training batches of ``BATCH_SIZE`` mixtures of
``MAX_N_SIGNAL`` sources (the configuration's), each source a crop of
``frames`` STFT frames of an utterance from a pool of ``pool`` synthetic
utterances of ``utterance_s`` seconds; every row of batch i draws its
utterances and crops from a generator of (seed, i), so that any process
rebuilds any rows of any batch, and the ri spectra
[B, N, T, F, 2] are what the spectra wire ships.

``kind: "closed_loop"``: requests of one mixture each, whose lengths
cycle through ``cycle`` fixed quantiles of a log-uniform law on
[``min_s``, ``max_s``] seconds, each cycle in its own order drawn from the
seed: every seed sends the same set of lengths, in another order.  Each
source is a crop of one of ``pool`` utterances of ``max_s`` seconds.
"""
from __future__ import annotations

import math

import numpy as np

from perfbench.harness import synth


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63)] + list(stream))


class TrainTraffic:
    def __init__(self, params: dict, keys: dict, seed: int):
        self.batch = int(keys["BATCH_SIZE"])
        self.n_src = int(keys["MAX_N_SIGNAL"])
        self.frames = int(params["frames"])
        self.seed = seed
        sr = float(keys["SMPRATE"])
        rng = _rng(seed, 1)
        n = int(round(float(params["utterance_s"]) * sr))
        waves = np.stack([synth.utterance(rng, n, sr)
                          for _ in range(int(params["pool"]))]) \
            * np.float32(params["pcm_scale"])
        self.spectra = synth.stft_ri(waves, int(keys["FFT_SIZE"]),
                                     int(keys["FFT_STRIDE"]))
        if self.spectra.shape[1] < self.frames:
            raise ValueError("utterances of %d frames cannot give crops of "
                             "%d" % (self.spectra.shape[1], self.frames))

    def plan(self, i: int):
        """(utterances [B, N], crop starts [B, N]) of batch ``i``: N
        distinct utterances a row."""
        rng = _rng(self.seed, 2, i)
        pool, span = self.spectra.shape[0], self.spectra.shape[1]
        utt = np.argsort(rng.random((self.batch, pool)), axis=1)[
            :, :self.n_src]
        start = rng.integers(0, span - self.frames + 1,
                             size=(self.batch, self.n_src))
        return utt, start

    def shape(self) -> tuple:
        return (self.batch, self.n_src, self.frames) \
            + tuple(self.spectra.shape[2:])

    def batches(self, first: int, count: int, rows: slice = slice(None)
                ) -> np.ndarray:
        """Batches first .. first + count - 1 stacked, [count, B, N, T, F,
        2] float32; only ``rows`` are written (the rest is never read).
        One gather, so that a feeding thread holds the interpreter lock
        briefly."""
        out = np.empty((count,) + self.shape(), np.float32)
        plans = [self.plan(first + j) for j in range(count)]
        utt = np.stack([u for u, _ in plans])[:, rows]       # [K, b, N]
        start = np.stack([s for _, s in plans])[:, rows]
        frames = start[..., None] + np.arange(self.frames)   # [K, b, N, T]
        out[:, rows] = self.spectra[utt[..., None], frames]
        return out


class ClosedLoopTraffic:
    def __init__(self, params: dict, keys: dict, seed: int):
        self.sr = float(keys["SMPRATE"])
        self.n_src = int(keys["MAX_N_SIGNAL"])
        self.seed = seed
        lo, hi = float(params["min_s"]), float(params["max_s"])
        self.cycle = int(params["cycle"])
        q = (np.arange(self.cycle) + 0.5) / self.cycle
        self.lengths = np.round(np.exp(math.log(lo) + q * math.log(hi / lo))
                                * self.sr).astype(np.int64)
        rng = _rng(seed, 3)
        n = int(round(hi * self.sr))
        self.pool = np.stack([synth.utterance(rng, n, self.sr)
                              for _ in range(int(params["pool"]))]) \
            * np.float32(params["pcm_scale"])

    def length(self, i: int) -> int:
        """Samples of request ``i``."""
        order = _rng(self.seed, 4, i // self.cycle).permutation(self.cycle)
        return int(self.lengths[order[i % self.cycle]])

    def request(self, i: int) -> np.ndarray:
        """Request ``i``'s mixture waveform, float32 [L]."""
        n = self.length(i)
        rng = _rng(self.seed, 5, i)
        utt = rng.choice(self.pool.shape[0], self.n_src, replace=False)
        out = np.zeros(n, np.float32)
        for u in utt:
            s = int(rng.integers(0, self.pool.shape[1] - n + 1))
            out += self.pool[u, s:s + n]
        return out

    def warm_lengths(self) -> list:
        """Lengths that span the mix, the longest first (the caching
        allocator then holds blocks that fit every later request)."""
        return sorted({int(self.lengths[-1]), int(self.lengths[0]),
                       int(self.lengths[self.cycle // 2])}, reverse=True)


KINDS = {"train": TrainTraffic, "closed_loop": ClosedLoopTraffic}


def make(params: dict, keys: dict, seed: int):
    return KINDS[params["kind"]](params, keys, seed)
