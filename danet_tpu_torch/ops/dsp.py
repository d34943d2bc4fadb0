"""STFT / iSTFT as matrix products against precomputed DFT bases.

Counterpart of ``danet_tpu/ops/dsp.py``.  Conventions match
``scipy.signal.stft`` with ``boundary='zeros'``, ``padded=True``, one-sided
output and ``1/window.sum()`` scaling.  The inverse is the
reference's overlap-add with a static window**2 denominator, including its
frame-count convention (trailing frames past ``T*stride - fft_size`` are
dropped).

Spectra use the ri layout: a trailing (real, imag) axis; ``stft`` and
``istft`` take the complex dtype on the host side, as JAX's do.

``stft_ri`` here is the plain path (STFT_BACKEND='xla'); the fused kernel
and its own plain version live in ``ops/cuda/stft.py``, and
``stft_mag_logmag`` runs that kernel's logmag epilogue (kernel 6).  The
iSTFT has no kernel on the TPU either (XLA work), so it stays plain
torch.

The streaming STFT / iSTFT (``stream_frames``, ``stft_frames_ri``,
``ola_periodic_denom``, ``istft_stream_ri``) keep the JAX package's
left-padded convention: the stream is led by ``fft_size - stride`` zeros,
every ``stride`` new samples give one frame that ends at the newest
sample, and the output lags the input by ``fft_size - stride`` samples.
Their DFT and inverse DFT are plain matrix products, as the JAX package
computes them outside any Pallas kernel.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from danet_tpu_torch.ops.nn import device_constant


def stft_frame_count(n_samples: int, fft_size: int, stride: int) -> int:
    """Number of STFT frames scipy.signal.stft produces for n_samples."""
    padded = n_samples + fft_size  # boundary='zeros' adds fft_size//2 twice
    nadd = (-(padded - fft_size) % stride) % stride
    return (padded + nadd - fft_size) // stride + 1


@functools.lru_cache(maxsize=8)
def _dft_basis(fft_size: int, dtype_name: str):
    """Real/imag DFT basis, windowless: B[n, k] = exp(-2i*pi*n*k/N)."""
    n = np.arange(fft_size)[:, None]
    k = np.arange(fft_size // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / fft_size
    return (np.cos(ang).astype(dtype_name),
            (-np.sin(ang)).astype(dtype_name))


@functools.lru_cache(maxsize=8)
def _idft_basis(fft_size: int, dtype_name: str):
    """Real iDFT basis: x[n] = Re @ C[k,n] + Im @ S[k,n] (one-sided)."""
    feat = fft_size // 2 + 1
    k = np.arange(feat)[:, None]
    n = np.arange(fft_size)[None, :]
    ang = 2.0 * np.pi * k * n / fft_size
    wk = np.full((feat, 1), 2.0)
    wk[0] = 1.0
    if fft_size % 2 == 0:
        wk[-1] = 1.0
    return ((wk * np.cos(ang) / fft_size).astype(dtype_name),
            (-wk * np.sin(ang) / fft_size).astype(dtype_name))


def frame_signal(x: torch.Tensor, fft_size: int,
                 stride: int) -> torch.Tensor:
    """[..., L] -> [..., T, fft_size] with scipy's boundary and end
    padding."""
    n = x.shape[-1]
    half = fft_size // 2
    padded = n + 2 * half
    nadd = (-(padded - fft_size) % stride) % stride
    xp = torch.nn.functional.pad(x, (half, half + nadd))
    return xp.unfold(-1, fft_size, stride)


def stft_ri(x: torch.Tensor, fft_size: int, stride: int,
            window: np.ndarray) -> torch.Tensor:
    """STFT of real signal(s) [..., L] -> ri [..., T, F, 2]."""
    tdt = getattr(torch, str(window.dtype))
    return stft_frames_ri(frame_signal(x.to(tdt), fft_size, stride), window)


def stft(x: torch.Tensor, fft_size: int, stride: int,
         window: np.ndarray) -> torch.Tensor:
    """STFT of real signal(s) [..., L] -> complex [..., T, F] (complex64
    for a float32 window): ``stft_ri``'s values as one complex tensor."""
    ri = stft_ri(x, fft_size, stride, window)
    return torch.complex(ri[..., 0], ri[..., 1])


def stft_mag_logmag(x: torch.Tensor, fft_size: int, stride: int,
                    window: np.ndarray):
    """(|Z|, log1p|Z|) [..., T, F] of the STFT of [..., L]: DaNet's feature
    front end without the complex spectra.  Kernel A's ``LOGMAG`` epilogue
    (kernel 6, the op ``danet::stft_ri`` with its logmag flag) on a CUDA
    tensor, its plain version on a CPU tensor; float32."""
    from danet_tpu_torch.ops.cuda import library

    lead = tuple(x.shape[:-1])
    out = library.stft_ri(x.reshape(-1, x.shape[-1]).float().contiguous(),
                          fft_size, stride, window, logmag=True)
    out = out.reshape(lead + tuple(out.shape[1:]))
    return out[..., 0], out[..., 1]


def stft_frames_ri(frames: torch.Tensor, window: np.ndarray) -> torch.Tensor:
    """Windowed DFT of framed samples [..., K, fft_size] -> ri [..., K, F, 2]
    (``stft_ri``'s scaling)."""
    fft_size = frames.shape[-1]
    dtype = str(window.dtype)
    cos_b, sin_b = _dft_basis(fft_size, dtype)
    scale = 1.0 / float(np.sum(window))
    key = ("stft-basis", fft_size, window.tobytes(), dtype)
    dev = frames.device
    wcos = device_constant(key + ("cos",),
                           lambda: window[:, None] * cos_b * scale, dev)
    wsin = device_constant(key + ("sin",),
                           lambda: window[:, None] * sin_b * scale, dev)
    frames = frames.to(getattr(torch, dtype))
    return torch.stack([frames @ wcos, frames @ wsin], dim=-1)


def stream_frames(wav_tail: torch.Tensor, wav_chunk: torch.Tensor,
                  fft_size: int, stride: int):
    """Frame a chunk [..., K stride] after the carried input tail [...,
    fft_size - stride] (zeros at the stream's start) -> (frames [..., K,
    fft_size], the new tail)."""
    p = fft_size - stride
    if wav_tail.shape[-1] != p:
        raise ValueError("the tail must hold fft_size - stride = %d samples, "
                         "got %d" % (p, wav_tail.shape[-1]))
    if wav_chunk.shape[-1] % stride:
        raise ValueError("chunk length must be a multiple of the stride")
    x = torch.cat([wav_tail, wav_chunk], dim=-1)
    return x.unfold(-1, fft_size, stride), x[..., x.shape[-1] - p:]


def ola_periodic_denom(window: np.ndarray, stride: int) -> np.ndarray:
    """[stride] steady-state window**2 overlap-add normaliser: entry j sums
    w^2[o] over the offsets o = j (mod stride), in float64, rounded to the
    window's dtype."""
    w2 = np.asarray(window, dtype=np.float64) ** 2
    denom = np.zeros(stride, dtype=np.float64)
    for o in range(w2.shape[0]):
        denom[o % stride] += w2[o]
    return denom.astype(window.dtype)


def istft_stream_ri(spectra_ri: torch.Tensor, stride: int,
                    window: np.ndarray, ola_tail: torch.Tensor):
    """Streaming inverse STFT of K frames [..., K, F, 2] (``stream_frames``'
    framing) with the carried overlap-add numerator [..., fft_size - stride]
    (zeros at the stream's start) -> (normalised samples [..., K stride],
    the new tail)."""
    fft_size = (spectra_ri.shape[-2] - 1) * 2
    p = fft_size - stride
    dtype = str(window.dtype)
    tdt = getattr(torch, dtype)
    dev = spectra_ri.device
    k = spectra_ri.shape[-3]
    lead = tuple(spectra_ri.shape[:-3])
    cos_b, sin_b = _idft_basis(fft_size, dtype)
    key = ("istft", fft_size, stride, window.tobytes(), dtype)
    frames = (spectra_ri[..., 0].to(tdt)
              @ device_constant(key + ("cos",), lambda: cos_b, dev)
              + spectra_ri[..., 1].to(tdt)
              @ device_constant(key + ("sin",), lambda: sin_b, dev))
    frames = frames * device_constant(key + ("window",),
                                      lambda: np.asarray(window), dev)
    buf = overlap_add(frames, stride)                      # [..., K s + p]
    buf = torch.cat([buf[..., :p] + ola_tail.to(buf.dtype), buf[..., p:]],
                    dim=-1)
    denom = device_constant(key + ("periodic-denominator",),
                            lambda: ola_periodic_denom(window, stride), dev)
    out = (buf[..., :k * stride].reshape(lead + (k, stride)) / denom) \
        .reshape(lead + (k * stride,))
    return out, buf[..., k * stride:]


def overlap_add(frames: torch.Tensor, stride: int) -> torch.Tensor:
    """Overlap-add of frames [..., K, win] at hop ``stride`` -> [...,
    (K - 1) * stride + win]: frame k lands on samples k * stride onwards.

    Deterministic, with no atomics: the frames, zero-padded to m = ceil(win
    / stride) segments of ``stride`` samples, are summed as m shifted slabs
    (segment q of frame k lands on block k + q), from q = m - 1 down to 0,
    so that every sample adds its frames in ascending order, the order of
    a sequential scatter-add into zeros (``index_add_`` on the CPU)."""
    k, win = frames.shape[-2], frames.shape[-1]
    m = -(-win // stride)
    lead = tuple(frames.shape[:-2])
    if m * stride != win:
        frames = torch.nn.functional.pad(frames, (0, m * stride - win))
    segs = frames.reshape(lead + (k, m, stride))
    out = None
    for q in range(m - 1, -1, -1):
        slab = torch.nn.functional.pad(segs[..., q, :], (0, 0, q, m - 1 - q))
        out = slab if out is None else out + slab
    out = out.reshape(lead + ((k + m - 1) * stride,))
    return out[..., :(k - 1) * stride + win]


def _ola_denominator(n_used: int, stride: int, window: np.ndarray,
                     out_len: int, key: tuple, dev) -> torch.Tensor:
    """The overlap-add sum of window**2 over ``n_used`` frames, out to
    ``out_len`` samples, summed in float64 and rounded to the window's
    dtype, zero entries replaced by 1.  Built on each call: it depends on
    the length."""
    w2 = device_constant(key + ("window-squared",),
                         lambda: np.asarray(window, np.float64) ** 2, dev)
    wsum = overlap_add(w2.expand(n_used, w2.numel()), stride)
    wsum = torch.nn.functional.pad(wsum, (0, out_len - wsum.shape[-1]))
    wsum = torch.where(wsum != 0, wsum, torch.ones_like(wsum))
    return wsum.to(getattr(torch, str(window.dtype)))


def istft(spectra: torch.Tensor, stride: int, window: np.ndarray,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT of complex spectra [..., T, F] -> real [..., T*stride]
    (or ``length``): ``istft_ri`` of their real and imaginary parts."""
    return istft_ri(torch.stack([spectra.real, spectra.imag], dim=-1),
                    stride, window, length)


def istft_ri(spectra_ri: torch.Tensor, stride: int, window: np.ndarray,
             length: int | None = None) -> torch.Tensor:
    """Inverse STFT from ri [..., T, F, 2] -> [..., T*stride] (or
    ``length``).  The overlap-add is ``overlap_add``: deterministic on the
    card too."""
    fft_size = (spectra_ri.shape[-2] - 1) * 2
    tdt = getattr(torch, str(window.dtype))
    dev = spectra_ri.device
    out_len = spectra_ri.shape[-3] * stride
    # reference loop: range(0, out_len - fft_size, stride)
    n_used = max(0, -(-(out_len - fft_size) // stride))
    lead = tuple(spectra_ri.shape[:-3])
    if n_used == 0:
        out = torch.zeros(lead + (out_len,), dtype=tdt, device=dev)
        return out if length is None else out[..., :length]

    cos_b, sin_b = _idft_basis(fft_size, str(window.dtype))
    key = ("istft", fft_size, stride, window.tobytes(), str(window.dtype))
    re = spectra_ri[..., :n_used, :, 0].to(tdt)
    im = spectra_ri[..., :n_used, :, 1].to(tdt)
    frames = (re @ device_constant(key + ("cos",), lambda: cos_b, dev)
              + im @ device_constant(key + ("sin",), lambda: sin_b, dev))
    frames = frames * device_constant(key + ("window",),
                                      lambda: np.asarray(window), dev)
    out = overlap_add(frames, stride)
    out = torch.nn.functional.pad(out, (0, out_len - out.shape[-1]))
    out = out / _ola_denominator(n_used, stride, window, out_len, key, dev)
    if length is not None:
        out = out[..., :length]
    return out
