"""The traffic's audio: a frozen copy of the port's synth-speech generator
(``danet_tpu_torch/data/synth_speech.py``, formant-filtered excitation)
and the scipy-convention STFT of its training spectra.

Frozen here so that a later change of the program cannot change what the
benchmark feeds it.  One change from the original: an utterance takes its
length in samples, so that a request of any length is one draw.  numpy
and scipy only, on the host.
"""
from __future__ import annotations

import numpy as np

# canonical formant targets (Hz), roughly /a/, /i/, /u/, /e/, /o/
_VOWEL_FORMANTS = np.asarray([
    [730.0, 1090.0, 2440.0],
    [270.0, 2290.0, 3010.0],
    [300.0, 870.0, 2240.0],
    [530.0, 1840.0, 2480.0],
    [570.0, 840.0, 2410.0],
], dtype=np.float64)
_FORMANT_BW = np.asarray([90.0, 110.0, 170.0], dtype=np.float64)


def _resonator_coeffs(freq: float, bw: float, sr: float):
    """2nd-order all-pole resonator (b, a) at ``freq`` Hz, bandwidth
    ``bw``, unit gain at the peak."""
    r = np.exp(-np.pi * bw / sr)
    theta = 2.0 * np.pi * freq / sr
    a = np.asarray([1.0, -2.0 * r * np.cos(theta), r * r])
    b = np.asarray([(1.0 - r) * np.sqrt(1.0 - 2.0 * r * np.cos(2 * theta)
                                        + r * r)])
    return b, a


def utterance(rng: np.random.Generator, n: int, sr: float) -> np.ndarray:
    """One speaker's utterance of ``n`` samples at ``sr`` Hz: 80-220 ms
    phones, voiced (a glottal pulse train on a drifting F0 plus
    aspiration) or unvoiced (noise), through three formant resonators
    whose state carries across phones; RMS 0.2.  float32 [n]."""
    from scipy.signal import lfilter, lfilter_zi

    nyq = sr / 2.0
    f0_base = rng.uniform(85.0, 245.0)
    vt = rng.uniform(0.82, 1.18)
    wav = np.zeros(n, dtype=np.float64)
    zis = [None] * len(_FORMANT_BW)
    pos = 0
    phase = 0.0
    while pos < n:
        seg = min(int(rng.uniform(0.08, 0.22) * sr), n - pos)
        voiced = rng.random() < 0.75
        t = np.arange(seg) / sr
        if voiced:
            f0 = f0_base * (1.0 + 0.12 * np.sin(
                2 * np.pi * rng.uniform(1.5, 5.0) * t
                + rng.uniform(0, 2 * np.pi))
                - 0.06 * t / max(t[-1], 1e-6))
            phases = phase + np.cumsum(f0) / sr
            phase = float(phases[-1])
            frac = phases % 1.0
            pulse = np.clip(1.0 - (frac / 0.12), 0.0, 1.0) ** 2
            exc = pulse + 0.06 * rng.standard_normal(seg)
            formants = (_VOWEL_FORMANTS[rng.integers(
                len(_VOWEL_FORMANTS))] * vt)
            bws = _FORMANT_BW * rng.uniform(0.9, 1.4)
        else:
            exc = rng.standard_normal(seg)
            formants = np.sort(rng.uniform(0.25, 0.95, 3)) * nyq * vt
            bws = _FORMANT_BW * rng.uniform(2.0, 4.0)
        formants = np.clip(formants, 60.0, nyq * 0.95)
        env = np.minimum(1.0, np.minimum(
            np.arange(seg) / max(1.0, 0.015 * sr),
            (seg - np.arange(seg)) / max(1.0, 0.03 * sr)))
        y = exc * env * rng.uniform(0.5, 1.0)
        for fi, (freq, bw) in enumerate(zip(formants, bws)):
            b, a = _resonator_coeffs(float(freq), float(bw), sr)
            if zis[fi] is None:
                zis[fi] = lfilter_zi(b, a) * 0.0
            y, zis[fi] = lfilter(b, a, y, zi=zis[fi])
        wav[pos:pos + seg] = y
        pos += seg
    wav = np.diff(wav, prepend=wav[:1]) * 0.5 + wav * 0.5
    rms = np.sqrt(np.mean(np.square(wav))) + 1e-9
    return (0.2 * wav / rms).astype(np.float32)


def sqrt_hann(n: int) -> np.ndarray:
    """The reference's default window, sqrt of the symmetric Hann window
    (FFT_WND 'sqrt-hann'), float32."""
    k = np.arange(n, dtype=np.float64)
    return np.sqrt(0.5 - 0.5 * np.cos(2.0 * np.pi * k / max(n - 1, 1))
                   ).astype(np.float32)


def stft_ri(wav: np.ndarray, fft_size: int, stride: int) -> np.ndarray:
    """scipy.signal.stft's spectra of [..., L] (zero boundary, padded end,
    scaled by 1 / sum(window)) as float32 ri [..., T, F, 2]."""
    from scipy.signal import stft
    z = stft(wav, window=sqrt_hann(fft_size), nperseg=fft_size,
             noverlap=fft_size - stride)[2]
    z = np.moveaxis(z.astype(np.complex64), -1, -2)
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)
