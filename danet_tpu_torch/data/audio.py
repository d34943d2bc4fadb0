"""Host-side audio: WAV I/O, the ri layout of host spectra, the
scipy-convention STFT and its inverses, and the random zero-pad.

Counterpart of ``danet_tpu/data/audio.py:22-181`` (``to_ri``,
``from_ri``, ``stft_np``, ``istft_np``, ``spectra_to_wave``,
``random_zeropad``, ``load_wavfile``, ``save_wavfile``, ``load_wav_raw``
and ``save_wav_raw``): numpy and scipy only.  The FFT
parameters are arguments where the JAX functions read its global
hparams; ``random_zeropad`` draws from an explicit ``random.Random``,
where the JAX function draws from Python's global, unseeded generator.
"""
from __future__ import annotations

import random
from math import ceil

import numpy as np
import scipy.io.wavfile
import scipy.signal


def to_ri(x: np.ndarray) -> np.ndarray:
    """Complex (or real) [...] -> float32 [..., 2], (real, imag) last."""
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def from_ri(x: np.ndarray) -> np.ndarray:
    """float [..., 2] (real, imag) -> complex64 [...]."""
    return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)


def stft_np(data: np.ndarray, fft_size: int, stride: int,
            window: np.ndarray) -> np.ndarray:
    """scipy-convention STFT -> complex64 [T, F]."""
    zxx = scipy.signal.stft(
        data, window=window, nperseg=fft_size,
        noverlap=fft_size - stride)[2]
    return zxx.astype(np.complex64).T


def istft_np(spectra: np.ndarray, stride: int,
             window: np.ndarray) -> np.ndarray:
    """Overlap-add iSTFT with window**2 normalization: output length
    T*stride, frames at i*stride for i*stride < T*stride - fft_size."""
    fft_size = (spectra.shape[1] - 1) * 2
    out_len = spectra.shape[0] * stride
    n_used = max(0, -(-(out_len - fft_size) // stride))
    frames = np.fft.irfft(spectra[:n_used], axis=-1).real * window
    out = np.zeros(out_len, dtype=np.float64)
    wsum = np.zeros(out_len, dtype=np.float64)
    w2 = np.asarray(window, dtype=np.float64) ** 2
    for i in range(n_used):
        out[i * stride:i * stride + fft_size] += frames[i]
        wsum[i * stride:i * stride + fft_size] += w2
    pos = wsum != 0
    out[pos] /= wsum[pos]
    return out


def spectra_to_wave(spectra: np.ndarray, fft_size: int, stride: int,
                    window: np.ndarray) -> np.ndarray:
    """The waveform whose ``stft_np`` reproduces ``spectra`` (complex
    [T, F]): ``scipy.signal.istft``, the exact inverse of
    ``scipy.signal.stft`` with its boundary zeros, trimmed or zero-padded
    to (T-1)*stride samples.  It lets a corpus stored as spectra ride the
    wave wire."""
    _, wav = scipy.signal.istft(
        np.asarray(spectra).T, window=window, nperseg=fft_size,
        noverlap=fft_size - stride)
    target = (spectra.shape[0] - 1) * stride
    if len(wav) > target:
        wav = wav[:target]
    elif len(wav) < target:
        wav = np.pad(wav, (0, target - len(wav)))
    return wav.astype(np.float32)


def random_zeropad(x: np.ndarray, padlen: int, axis: int,
                   rand: random.Random) -> np.ndarray:
    """Zero-pad ``axis`` by ``padlen`` with a random left/right split (a
    train-time augmentation), the split drawn from ``rand``."""
    if padlen == 0:
        return x
    left = rand.randint(0, padlen)
    right = padlen - left
    axis %= x.ndim
    pad = [(0, 0)] * axis + [(left, right)] + [(0, 0)] * (x.ndim - axis - 1)
    return np.pad(x, pad, mode="constant")


def load_wavfile(filename: str, smprate: int, fft_size: int, stride: int,
                 window: np.ndarray) -> np.ndarray:
    """WAV -> mono, resampled to ``smprate`` -> ``stft_np`` -> complex
    [T, F]; the samples as the file stores them (no PCM scaling)."""
    if filename is None:
        raise IOError("WAV file not specified, please specify via "
                      "--input-file argument.")
    in_rate, data = scipy.io.wavfile.read(filename)
    if data.ndim > 1:
        data = data.mean(axis=-1)
    if in_rate != smprate:
        data = scipy.signal.resample(
            data, int(ceil(len(data) * smprate / in_rate)))
    return stft_np(np.asarray(data, dtype=np.float64), fft_size, stride,
                   window)


def save_wavfile(filename: str, spectra: np.ndarray, smprate: int,
                 stride: int, window: np.ndarray) -> None:
    """complex [T, F] -> ``istft_np`` -> a float64 WAV at ``smprate``."""
    scipy.io.wavfile.write(filename, smprate,
                           istft_np(spectra, stride, window))


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
