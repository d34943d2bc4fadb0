"""The forward kernels as ``torch.library`` custom ops, namespace ``danet``.

A program exported with ``torch.export`` (``serve.export_separator``,
``export_streamer``) records a custom op by name.  The launch wrappers of
``ops/cuda/*.py`` pass ``data_ptr()`` to ctypes, which an export's fake
tensors do not have: traced on the card they fail, traced on the CPU they
leave only the plain versions in the graph.  So the kernels that the
no-grad paths run are ops:

  op                        kernel               wrapper
  danet::stft_ri            A (logmag: 6)        stft.stft_ri
  danet::bilstm_scan        B                    lstm.bilstm_scan
  danet::lstm_scan          1f, lean             lstm.lstm_scan
  danet::lstm_scan_state    1f, state entry      lstm.lstm_scan(..., True)
  danet::gru_scan           4f, lean             gru.gru_scan
  danet::flash_attn         5f                   attention.flash_attn

Each op dispatches by its tensors' device, the rule ``_on_cuda`` applies:
its CUDA implementation is the wrapper (which launches the kernel or
raises, and counts the launch on ``<wrapper>.launches``), its CPU
implementation the wrapper's plain version; ``register_fake`` gives the
output shapes and dtypes.  The training kernels stay inside their
``autograd.Function``s.  Kernel A's window is passed by its registry name
and dtype (``windows.WINDOW_REGISTRY``), not as an array: an op takes no
numpy, and a name keeps the exported graph free of a host copy.

Importing this module registers the ops; it builds nothing.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from danet_tpu_torch.ops import dsp
from danet_tpu_torch.ops.cuda import attention as cuda_attn
from danet_tpu_torch.ops.cuda import gru as cuda_gru
from danet_tpu_torch.ops.cuda import lstm as cuda_lstm
from danet_tpu_torch.ops.cuda import stft as cuda_stft
from danet_tpu_torch.ops.nn import acc_dtype
from danet_tpu_torch.windows import WINDOW_REGISTRY

_LIB = torch.library.Library("danet", "DEF")


def _define(schema: str, cuda, cpu, fake):
    """Define ``danet::<schema>`` with its CUDA, CPU and fake
    implementations; -> the op."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake("danet::" + name, fake, lib=_LIB)
    return getattr(torch.ops.danet, name)


# ----------------------------------------------------------------- kernel A
@functools.lru_cache(maxsize=16)
def registry_window(name: str, dtype: str, fft_size: int) -> np.ndarray:
    """The window ``name`` of ``fft_size`` points, in ``dtype``, as
    ``hparams`` builds FFT_WND_ARRAY."""
    return WINDOW_REGISTRY[name](fft_size).astype(dtype)


_WINDOW_NAMES: dict = {}


def window_key(window: np.ndarray) -> tuple:
    """(registry name, dtype) of a window array; ValueError for a window
    that no registry entry gives."""
    key = (window.dtype.str, window.tobytes())
    hit = _WINDOW_NAMES.get(key)
    if hit is None:
        for name in WINDOW_REGISTRY:
            if np.array_equal(registry_window(name, str(window.dtype),
                                              window.size), window):
                hit = _WINDOW_NAMES[key] = (name, str(window.dtype))
                break
        else:
            raise ValueError("the STFT op takes a window of the registry "
                             "(%s); got another %d-point window"
                             % (", ".join(sorted(WINDOW_REGISTRY)),
                                window.size))
    return hit


def _stft_cuda(x, fft_size, stride, window, window_dtype, logmag):
    return cuda_stft.stft_ri(x, fft_size, stride,
                             registry_window(window, window_dtype, fft_size),
                             logmag)


def _stft_cpu(x, fft_size, stride, window, window_dtype, logmag):
    return cuda_stft.stft_ri_plain(
        x, fft_size, stride, registry_window(window, window_dtype, fft_size),
        logmag)


def _stft_fake(x, fft_size, stride, window, window_dtype, logmag):
    torch._check(x.dim() == 2, lambda: "danet::stft_ri takes [B, L]")
    t = dsp.stft_frame_count(x.shape[1], fft_size, stride)
    return x.new_empty((x.shape[0], t, fft_size // 2 + 1, 2),
                       dtype=torch.float32)


stft_ri_op = _define(
    "stft_ri(Tensor x, int fft_size, int stride, str window, "
    "str window_dtype, bool logmag) -> Tensor",
    _stft_cuda, _stft_cpu, _stft_fake)


def stft_ri(x: torch.Tensor, fft_size: int, stride: int,
            window: np.ndarray, logmag: bool = False) -> torch.Tensor:
    """``danet::stft_ri`` on [B, L]: ``ops/cuda/stft.py::stft_ri``'s
    signature, the window an array of the registry."""
    name, dtype = window_key(np.asarray(window))
    return stft_ri_op(x, fft_size, stride, name, dtype, bool(logmag))


# ---------------------------------------------------------- kernels B, 1, 4
def _hs_fake(xp, wh, c0, h0, tanh_cand):
    return xp.new_empty(tuple(xp.shape[:-1]) + (xp.shape[-1] // 4,))


def _state_fake(xp, wh, c0, h0, tanh_cand):
    return (_hs_fake(xp, wh, c0, h0, tanh_cand),
            xp.new_empty((xp.shape[1], xp.shape[2] // 4),
                         dtype=acc_dtype(xp)))


_SCAN = "(Tensor xp, Tensor wh, Tensor c0, Tensor h0, bool tanh_cand)"

bilstm_scan = _define(
    "bilstm_scan" + _SCAN + " -> Tensor",
    lambda *a: cuda_lstm.bilstm_scan(*a),
    lambda *a: cuda_lstm.bilstm_scan_plain(*a), _hs_fake)

lstm_scan = _define(
    "lstm_scan" + _SCAN + " -> Tensor",
    lambda *a: cuda_lstm.lstm_scan(*a),
    lambda *a: cuda_lstm.lstm_scan_plain(*a), _hs_fake)

lstm_scan_state = _define(
    "lstm_scan_state" + _SCAN + " -> (Tensor, Tensor)",
    lambda *a: cuda_lstm.lstm_scan(*a, return_state=True),
    lambda *a: cuda_lstm.lstm_scan_plain(*a, return_state=True),
    _state_fake)

gru_scan = _define(
    "gru_scan(Tensor gx, Tensor cx, Tensor wgh, Tensor wch, Tensor c0) "
    "-> Tensor",
    lambda *a: cuda_gru.gru_scan(*a),
    lambda *a: cuda_gru.gru_scan_plain(*a),
    lambda gx, cx, wgh, wch, c0: cx.new_empty(cx.shape, dtype=gx.dtype))


# ----------------------------------------------------------------- kernel 5f
def _flash_fake(q, k, v, seg, sm_scale):
    b, t, h, d = q.shape
    stats = q.new_empty((b, h, t), dtype=torch.float32)
    return q.new_empty((b, t, h, d)), stats, torch.empty_like(stats)


flash_attn = _define(
    "flash_attn(Tensor q, Tensor k, Tensor v, Tensor? seg, float sm_scale) "
    "-> (Tensor, Tensor, Tensor)",
    lambda *a: cuda_attn.flash_attn(*a),
    lambda *a: tuple(v.contiguous() for v in cuda_attn.flash_attn_plain(*a)),
    _flash_fake)
