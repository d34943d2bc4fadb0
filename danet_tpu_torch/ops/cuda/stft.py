"""Kernel A wrapper: fused framing + windowed DFT, [B, L] -> ri [B, T, F, 2].

Replaces ``danet_tpu/ops/pallas/stft.py::_stft_pallas_padded`` (reached by
``stft_ri_pallas`` with ``logmag=False``), and with ``logmag=True`` its
feature epilogue (kernel 6: ``(|Z|, log1p|Z|)`` in place of ``(re, im)``,
which nothing in either package calls on a main path).  The CUDA source is
``danet_tpu_torch/csrc/stft.cu``; its header says what bounds it on an H100
(f32 FMA rate and launch latency at serving shapes, not bytes: a 10 s wave
is 0.3 MB in and 1.3 MB out, all L2-resident) and how it tiles.

``stft_ri`` launches the kernel for a CUDA tensor and uses the plain
version, ``stft_ri_plain``, for a CPU tensor: framing plus one float32
``torch.matmul`` against the same basis.  ``stft_ri.launches`` counts the
kernel launches with ``logmag=False``, ``stft_logmag.launches`` those with
``logmag=True``.
"""
from __future__ import annotations

import numpy as np
import torch

from danet_tpu_torch.ops import dsp

_BASIS_CACHE: dict = {}


def _basis_np(fft_size: int, window: np.ndarray) -> np.ndarray:
    """Windowed DFT basis [fft_size, 2F] f32, re/im columns interleaved
    (2f real, 2f+1 imag), built as the TPU kernel's ``_basis_banded``:
    float64 window x scale x the f32 cos / -sin basis, then cast to f32."""
    cos_b, sin_b = dsp._dft_basis(fft_size, "float32")
    w = window.astype(np.float64)[:, None] * (1.0 / float(np.sum(window)))
    return np.stack([w * cos_b, w * sin_b], axis=-1).reshape(
        fft_size, -1).astype(np.float32)


def _basis(fft_size: int, stride: int, window: np.ndarray,
           device: torch.device) -> torch.Tensor:
    """The basis on ``device``, cached per (fft, stride, window bytes)."""
    key = (fft_size, stride, window.tobytes(), str(device))
    hit = _BASIS_CACHE.get(key)
    if hit is None:
        hit = torch.from_numpy(_basis_np(fft_size, window)).to(device)
        _BASIS_CACHE[key] = hit
    return hit


def stft_ri_plain(x: torch.Tensor, fft_size: int, stride: int,
                  window: np.ndarray, logmag: bool = False) -> torch.Tensor:
    """Plain version of kernel A (and with ``logmag`` of kernel 6):
    [B, L] -> [B, T, F, 2] in float32."""
    basis = _basis(fft_size, stride, window, x.device)
    frames = dsp.frame_signal(x.float(), fft_size, stride)
    out = torch.matmul(frames, basis)
    out = out.reshape(out.shape[:-1] + (fft_size // 2 + 1, 2))
    if not logmag:
        return out
    re, im = out[..., 0], out[..., 1]
    mag = torch.sqrt(re * re + im * im)
    return torch.stack([mag, torch.log1p(mag)], dim=-1)


def stft_ri(x: torch.Tensor, fft_size: int, stride: int,
            window: np.ndarray, logmag: bool = False) -> torch.Tensor:
    """Fused STFT: [B, L] or [L] float32 -> ri [B, T, F, 2] (or [T, F, 2]),
    or with ``logmag`` (|Z|, log1p|Z|) stacked in place of (re, im).

    scipy conventions (boundary zeros, padded, 1/sum(window) scaling), as
    ``danet_tpu.ops.pallas.stft.stft_ri_pallas``.  Kernel on a CUDA
    tensor, plain version on a CPU tensor."""
    if x.dim() == 1:
        return stft_ri(x[None], fft_size, stride, window, logmag)[0]
    if x.dim() != 2:
        raise ValueError("stft_ri expects [B, L] or [L], got %s"
                         % (tuple(x.shape),))
    if x.device.type == "cpu":
        return stft_ri_plain(x, fft_size, stride, window, logmag)
    if x.device.type != "cuda":
        raise ValueError("stft_ri: unsupported device %s" % (x.device,))
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("stft_ri kernel takes a contiguous float32 wave, "
                         "got %s%s" % (x.dtype, "" if x.is_contiguous()
                                       else " (non-contiguous)"))
    from danet_tpu_torch.ops.cuda import _build

    b, n = x.shape
    n_frames = dsp.stft_frame_count(n, fft_size, stride)
    n_cols = 2 * (fft_size // 2 + 1)
    basis = _basis(fft_size, stride, window, x.device)
    out = torch.empty((b, n_frames, n_cols // 2, 2), dtype=torch.float32,
                      device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.danet_stft_ri(x.data_ptr(), basis.data_ptr(),
                                   out.data_ptr(), b, n, n_frames, fft_size,
                                   stride, n_cols, int(bool(logmag)), stream)
    _build.check(status, "stft_ri kernel")
    if logmag:
        stft_logmag.launches += 1
    else:
        stft_ri.launches += 1
    return out


def stft_logmag(x: torch.Tensor, fft_size: int, stride: int,
                window: np.ndarray) -> torch.Tensor:
    """Kernel 6: ``stft_ri(..., logmag=True)``, under its own counter."""
    return stft_ri(x, fft_size, stride, window, logmag=True)


stft_ri.launches = 0
stft_logmag.launches = 0
