"""Kernel A wrapper: fused framing + windowed DFT, [B, L] -> ri [B, T, F, 2].

Replaces ``danet_tpu/ops/pallas/stft.py::_stft_pallas_padded`` (reached by
``stft_ri_pallas`` with ``logmag=False``), and with ``logmag=True`` its
feature epilogue (kernel 6: ``(|Z|, log1p|Z|)`` in place of ``(re, im)``,
which nothing in either package calls on a main path).  The CUDA source is
``danet_tpu_torch/csrc/stft.cu``; its header says what bounds it on an H100
and how it tiles: blocks of 32 frames x 64 columns (the Nyquist pair folded
into the last column block), the frames and the block's basis slice staged
once by ``cp.async``.  It frames any stride.

``stft_ri`` launches the kernel for a CUDA tensor and uses the plain
version, ``stft_ri_plain``, for a CPU tensor: framing plus one float32
``torch.matmul`` against the interleaved basis ``[fft, 2F]``.  The kernel
reads the same values in its own layout (``kernel_basis_np``), built once
and cached beside the plain basis.  ``stft_ri.launches`` counts the kernel
launches with ``logmag=False``, ``stft_logmag.launches`` those with
``logmag=True``.
"""
from __future__ import annotations

import numpy as np
import torch

from danet_tpu_torch.ops import dsp
from danet_tpu_torch.ops.cuda.lstm import _launch, _on_cuda

_BASIS_CACHE: dict = {}
# the kernel's basis layout (csrc/stft.cu): column blocks of BLOCK_COLS,
# each row ROW_COLS wide (the block, a folded pair of columns, padding)
BLOCK_COLS = 64
ROW_COLS = BLOCK_COLS + 4


def _basis_np(fft_size: int, window: np.ndarray) -> np.ndarray:
    """Windowed DFT basis [fft_size, 2F] f32, re/im columns interleaved
    (2f real, 2f+1 imag), built as the TPU kernel's ``_basis_banded``:
    float64 window x scale x the f32 cos / -sin basis, then cast to f32."""
    cos_b, sin_b = dsp._dft_basis(fft_size, "float32")
    w = window.astype(np.float64)[:, None] * (1.0 / float(np.sum(window)))
    return np.stack([w * cos_b, w * sin_b], axis=-1).reshape(
        fft_size, -1).astype(np.float32)


def kernel_basis_np(basis: np.ndarray) -> np.ndarray:
    """The kernel's layout of a ``[fft, 2F]`` basis: ``[blocks, fft4,
    ROW_COLS]`` f32, fft4 = fft rounded up to 4.  Block j holds columns
    64 j .. 64 j + 63; a remainder of 2 columns (2F = fft + 2 for an fft
    that is a multiple of 64) is folded into the last block as its columns
    64 and 65, a larger one gets a block of its own; everything else is
    zero."""
    fft, n_cols = basis.shape
    full, rest = divmod(n_cols, BLOCK_COLS)
    blocks = full if full and rest <= 2 else full + 1
    out = np.zeros((blocks, -(-fft // 4) * 4, ROW_COLS), np.float32)
    for j in range(blocks):
        lo = j * BLOCK_COLS
        hi = n_cols if j == blocks - 1 else lo + BLOCK_COLS
        out[j, :fft, :hi - lo] = basis[:, lo:hi]
    return out


def _basis(fft_size: int, stride: int, window: np.ndarray,
           device: torch.device, kernel: bool = False) -> torch.Tensor:
    """The basis on ``device`` (with ``kernel``, in the kernel's layout),
    cached per (fft, stride, window bytes)."""
    key = (fft_size, stride, window.tobytes(), str(device), kernel)
    hit = _BASIS_CACHE.get(key)
    if hit is None:
        basis = _basis_np(fft_size, window)
        if kernel:
            basis = kernel_basis_np(basis)
        hit = torch.from_numpy(basis).to(device)
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
    if not _on_cuda(x, "stft_ri"):
        return stft_ri_plain(x, fft_size, stride, window, logmag)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("stft_ri kernel takes a contiguous float32 wave, "
                         "got %s%s" % (x.dtype, "" if x.is_contiguous()
                                       else " (non-contiguous)"))
    b, n = x.shape
    n_frames = dsp.stft_frame_count(n, fft_size, stride)
    n_cols = 2 * (fft_size // 2 + 1)
    basis = _basis(fft_size, stride, window, x.device, kernel=True)
    out = torch.empty((b, n_frames, n_cols // 2, 2), dtype=torch.float32,
                      device=x.device)
    _launch("danet_stft_ri", "stft_ri kernel", x.device, (x, basis, out),
            (b, n, n_frames, fft_size, stride, n_cols, int(bool(logmag))))
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
