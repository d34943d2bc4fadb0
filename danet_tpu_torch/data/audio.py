"""WAV I/O for the serving path and the ri layout of host spectra.

Counterpart of ``danet_tpu/data/audio.py:22-25,132-181`` (``to_ri``,
``load_wav_raw`` and ``save_wav_raw``): numpy and scipy only.
"""
from __future__ import annotations

from math import ceil

import numpy as np
import scipy.io.wavfile
import scipy.signal


def to_ri(x: np.ndarray) -> np.ndarray:
    """Complex (or real) [...] -> float32 [..., 2], (real, imag) last."""
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def load_wav_raw(filename: str, smprate: int) -> np.ndarray:
    """WAV -> mono float32 waveform resampled to ``smprate``.

    Integer PCM is scaled to [-1, 1) per sample width (8-bit WAVs are
    unsigned, centred at 128)."""
    in_rate, data = scipy.io.wavfile.read(filename)
    dtype = data.dtype
    data = np.asarray(data, dtype=np.float64)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        if info.min == 0:
            data = data - (info.max + 1) / 2.0
        data = data / ((info.max + 1) / 2.0 if info.min == 0
                       else info.max + 1.0)
    if data.ndim > 1:
        data = data.mean(axis=-1)
    if in_rate != smprate:
        data = scipy.signal.resample(
            data, int(ceil(len(data) * smprate / in_rate)))
    return data.astype(np.float32)


def save_wav_raw(filename: str, wav: np.ndarray, smprate: int,
                 scale: float = None) -> None:
    """Float waveform -> 16-bit WAV at ``smprate``.

    ``scale`` is a shared normalization divisor: the stems of one
    separation pass the same value so their relative levels survive."""
    wav = np.asarray(wav, dtype=np.float64)
    if scale is None:
        scale = max(float(np.max(np.abs(wav))), 1.0)
    pcm = np.clip(wav / max(float(scale), 1e-12), -1.0, 1.0)
    scipy.io.wavfile.write(
        filename, smprate, (pcm * 32767.0).astype(np.int16))
