"""Synthetic separable corpus: narrowband multi-tone "speakers".

Counterpart of ``danet_tpu/data/synth.py``.  Each utterance is a sum of a
few amplitude-modulated sinusoids drawn from a random narrow band, so a
mixture of two is separable by time-frequency masking.  Batch b of a
subset is drawn from its own ``RandomState(seed + subset base + b)``, so
epochs repeat exactly; generated batches are cached per (subset, shape
config) up to ``CACHE_BYTES_MAX`` bytes.  ``epoch_wave`` draws the same
utterances as ``epoch`` (the STFT consumes nothing from the stream).
"""
from __future__ import annotations

import numpy as np

from danet_tpu_torch.data import audio
from danet_tpu_torch.data.dataset import Dataset
from danet_tpu_torch.hparams import hparams


@hparams.register_dataset("synth")
class SyntheticTonesData(Dataset):
    """Deterministic-seed synthetic tone corpus, STFT'd on the fly."""

    DURATION_S = 1.5
    N_TONES = 3
    # the int16 wire's amplitude bound: a /N_TONES-scaled sum of N_TONES
    # unit-envelope sines, so |x| <= 1
    WAVE_SCALE = 1.0
    CACHE_BYTES_MAX = 4 << 30

    def __init__(self, hp=None, seed: int = 0):
        super().__init__(hp, seed)
        self.seed = seed
        self._cache = {}
        self._cache_bytes = 0

    @property
    def N_BATCHES(self):
        v = getattr(self.hp, "SYNTH_BATCHES", None)
        return 20 if v is None else int(v)

    def install_and_load(self):
        self.is_loaded = True

    def _utterance(self, rng: np.random.RandomState) -> np.ndarray:
        sr = self.hp.SMPRATE
        n = int(self.DURATION_S * sr)
        t = np.arange(n) / sr
        lo = rng.uniform(200.0, sr / 2 - 900.0)
        wav = np.zeros(n, dtype=np.float64)
        for _ in range(self.N_TONES):
            freq = rng.uniform(lo, lo + 600.0)
            phase = rng.uniform(0, 2 * np.pi)
            env_f = rng.uniform(0.5, 3.0)
            env = 0.55 + 0.45 * np.sin(
                2 * np.pi * env_f * t + rng.uniform(0, 2 * np.pi))
            wav += env * np.sin(2 * np.pi * freq * t + phase)
        return (wav / self.N_TONES).astype(np.float32)

    def _rng_for(self, subset: str, b: int) -> np.random.RandomState:
        base = {"train": 0, "valid": 10 ** 6, "test": 2 * 10 ** 6}[subset]
        return np.random.RandomState(self.seed + base + b)

    def _make_batch(self, subset: str, batch_size: int,
                    b: int) -> np.ndarray:
        hp = self.hp
        rng = self._rng_for(subset, b)
        return np.stack([
            audio.stft_np(self._utterance(rng), hp.FFT_SIZE, hp.FFT_STRIDE,
                          hp.FFT_WND_ARRAY).astype(hp.COMPLEXX)
            for _ in range(batch_size)])

    def _make_batch_wave(self, subset: str, batch_size: int,
                         b: int) -> np.ndarray:
        rng = self._rng_for(subset, b)
        return np.stack([self._utterance(rng) for _ in range(batch_size)])

    def _cached_batches(self, key, n_batches: int, make):
        cached = self._cache.get(key)
        for b in range(n_batches):
            if cached is not None and b < len(cached):
                batch = cached[b]
            else:
                batch = make(b)
                if self._cache_bytes + batch.nbytes <= self.CACHE_BYTES_MAX:
                    if cached is None:
                        cached = self._cache[key] = []
                    if b == len(cached):
                        cached.append(batch)
                        self._cache_bytes += batch.nbytes
            yield (batch,)

    def epoch(self, subset, batch_size, shuffle=False, rng=None, rand=None):
        """N_BATCHES complex spectra batches [batch, T, F]; ``shuffle``,
        ``rng`` and ``rand`` are unused (the batches are seeded)."""
        if not self.is_loaded:
            raise RuntimeError("Dataset is not loaded.")
        hp = self.hp
        key = (subset, batch_size, self.N_BATCHES, hp.FFT_SIZE,
               hp.FFT_STRIDE, hp.SMPRATE, hp.COMPLEXX,
               getattr(hp, "FFT_WND", "sqrt-hann"))
        yield from self._cached_batches(
            key, self.N_BATCHES,
            lambda b: self._make_batch(subset, batch_size, b))

    def epoch_wave(self, subset, batch_size, shuffle=False, rng=None,
                   rand=None):
        """The same utterances as [batch, S] float32 waveforms."""
        if not self.is_loaded:
            raise RuntimeError("Dataset is not loaded.")
        key = ("wave", subset, batch_size, self.N_BATCHES, self.hp.SMPRATE)
        yield from self._cached_batches(
            key, self.N_BATCHES,
            lambda b: self._make_batch_wave(subset, batch_size, b))
