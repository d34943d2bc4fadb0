"""The analysis / synthesis window registry (FFT_WND), numpy only.

A copy of ``danet_tpu/hparams.py``'s registry: importing anything of
``danet_tpu`` imports jax, which the port never does.  It lives apart from
``hparams`` so that the kernel ops (``ops/cuda/library.py``), which name
their window by its key, load without the config system: an exported
serving bundle runs with neither the models nor ``hparams`` imported.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def _hann_symmetric(n: int) -> np.ndarray:
    # scipy.signal.hann(n) is symmetric; the reference's default window is
    # sqrt(hann(FFT_SIZE)) (default.json FFT_WND 'sqrt-hann')
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / max(n - 1, 1))


WINDOW_REGISTRY: Dict[str, Callable[[int], np.ndarray]] = {
    "sqrt-hann": lambda n: np.sqrt(_hann_symmetric(n)),
    "hann": _hann_symmetric,
    "rect": lambda n: np.ones(n, dtype=np.float64),
    "hamming": lambda n: 0.54 - 0.46 * np.cos(
        2.0 * np.pi * np.arange(n) / max(n - 1, 1)),
}
