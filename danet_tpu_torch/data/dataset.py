"""Dataset base and the toy white-noise dataset.

Counterpart of ``danet_tpu/data/dataset.py:17-69``.  ``epoch(subset,
batch_size, shuffle, rng)`` is a host-side generator of tuples whose first
element is a [batch, T, F] spectra array; ``install_and_load()`` prepares
the data.  Random draws come from an explicit ``np.random.RandomState``
(the one passed to ``epoch``, else the dataset's own, seeded at
construction), never from numpy's global one.  Drawn from a RandomState
seeded like the global one that the JAX package reseeds, the toy data are
the same numbers.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from danet_tpu_torch.hparams import hparams


class Dataset:
    def __init__(self, hp=None, seed: int = 0):
        self.hp = hp if hp is not None else hparams
        self.rng = np.random.RandomState(seed)
        self.is_loaded = False

    def epoch(self, subset: str, batch_size: int, shuffle: bool = False,
              rng: Optional[np.random.RandomState] = None):
        """Yields (signals, ...) tuples; signals is [batch, T, F]."""
        raise NotImplementedError()

    def install_and_load(self):
        raise NotImplementedError()


@hparams.register_dataset("toy")
class WhiteNoiseData(Dataset):
    """Uniform white-noise spectra: 10 batches of [batch, 128, FEATURE_SIZE]
    per epoch and subset."""

    def epoch(self, subset, batch_size, shuffle=False, rng=None):
        if not self.is_loaded:
            raise RuntimeError("Dataset is not loaded.")
        rng = rng if rng is not None else self.rng
        for _ in range(10):
            signal = rng.rand(batch_size, 128, self.hp.FEATURE_SIZE).astype(
                self.hp.FLOATX)
            yield (signal,)

    def install_and_load(self):
        self.is_loaded = True
