"""Dataset base and the toy white-noise dataset.

Counterpart of ``danet_tpu/data/dataset.py:17-69``.  ``epoch(subset,
batch_size, shuffle, rng, rand)`` is a host-side generator of tuples whose
first element is a [batch, T, F] spectra array; a dataset that can feed
the wave wire (TRANSFER_DOMAIN='wave') also has ``epoch_wave`` with the
same arguments, whose batches are [batch, S] float32 waveforms, and
declares ``WAVE_SCALE``, the bound of its samples' magnitude that the
int16 wire's WAVE_PCM_SCALE must equal.  ``install_and_load()`` prepares
the data.  Random draws come from an explicit ``np.random.RandomState``
(the one passed to ``epoch``, else the dataset's own, seeded at
construction) and, for a random zero-pad split, a ``random.Random`` (the
``rand`` passed to ``epoch``, else the dataset's own), never from numpy's or Python's global one.
Drawn from a RandomState seeded like the global one that the JAX package
reseeds, the toy data are the same numbers.
"""
from __future__ import annotations

import random
from typing import Optional

import numpy as np

from danet_tpu_torch.hparams import hparams


class Dataset:
    def __init__(self, hp=None, seed: int = 0):
        self.hp = hp if hp is not None else hparams
        self.rng = np.random.RandomState(seed)
        self.rand = random.Random(seed)
        self.is_loaded = False

    def epoch(self, subset: str, batch_size: int, shuffle: bool = False,
              rng: Optional[np.random.RandomState] = None,
              rand: Optional[random.Random] = None):
        """Yields (signals, ...) tuples; signals is [batch, T, F]."""
        raise NotImplementedError()

    def install_and_load(self):
        raise NotImplementedError()

    # corpora stored as spectra (wsj0) feed the wave wire through the
    # exact inverse of their STFT, cached per utterance up to this many
    # bytes, so that epochs after the first are FFT-free
    WAVE_CACHE_BYTES_MAX = 2 << 30

    def _wave_from_spectra(self, key, spectra: np.ndarray) -> np.ndarray:
        """The waveform of one stored utterance (``audio.spectra_to_wave``
        under this dataset's FFT_SIZE, FFT_STRIDE and window), cached under
        ``key`` and the FFT parameters."""
        from danet_tpu_torch.data.audio import spectra_to_wave
        hp = self.hp
        cache = getattr(self, "_wave_cache", None)
        if cache is None:
            cache = self._wave_cache = {}
            self._wave_cache_bytes = 0
        full_key = (key, hp.FFT_SIZE, hp.FFT_STRIDE)
        hit = cache.get(full_key)
        if hit is not None:
            return hit
        wav = spectra_to_wave(np.asarray(spectra), hp.FFT_SIZE,
                              hp.FFT_STRIDE, hp.FFT_WND_ARRAY)
        if self._wave_cache_bytes + wav.nbytes <= self.WAVE_CACHE_BYTES_MAX:
            cache[full_key] = wav
            self._wave_cache_bytes += wav.nbytes
        return wav


@hparams.register_dataset("toy")
class WhiteNoiseData(Dataset):
    """Uniform white-noise spectra: 10 batches of [batch, 128, FEATURE_SIZE]
    per epoch and subset."""

    def epoch(self, subset, batch_size, shuffle=False, rng=None, rand=None):
        if not self.is_loaded:
            raise RuntimeError("Dataset is not loaded.")
        rng = rng if rng is not None else self.rng
        for _ in range(10):
            signal = rng.rand(batch_size, 128, self.hp.FEATURE_SIZE).astype(
                self.hp.FLOATX)
            yield (signal,)

    def install_and_load(self):
        self.is_loaded = True
