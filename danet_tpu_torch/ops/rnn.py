"""Recurrent layers: hoisted input projections + fused scans.

Counterpart of ``danet_tpu/ops/rnn.py:35-177,180-237,289-354``: the
one-direction LSTM (``lstm_apply``), the bidirectional LSTM
(``bilstm_apply``) and the GRU (``gru_init``/``gru_apply``).  LSTM
parameters are ``wx [I, 4, H]``, ``wh [H, 4, H]``, ``b [4, H]`` with gate
order cand|i|f|o; GRU parameters ``wgx [I, 2, H]``, ``wgh [H, 2, H]``,
``bg [2, H]``, ``wcx [I, H]``, ``wch [H, H]``, ``bc [H]``.  The input
projection of all timesteps is one matmul (JAX leaves it to XLA; here
``torch.matmul``); only the recurrent products stay inside the time loop,
which is a hand kernel: ``ops/cuda/lstm.py`` (kernel B when no gradient is
needed, else ``LstmScan``/``BiLstmScan``: kernel 2 forward, kernel 3
backward) and ``ops/cuda/gru.py`` (``gru_scan``, else ``GruScan``).

``LSTM_BACKEND`` keeps its JAX values: 'auto' and 'pallas' mean the hand
kernels for CUDA tensors (their plain versions for CPU tensors);
'xla' and 'pallas-interpret' mean the plain versions everywhere.
``return_state`` (the final carry, used only by streaming and sequence
parallelism) is not ported and raises NotImplementedError.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from danet_tpu_torch.ops.cuda import gru as cuda_gru
from danet_tpu_torch.ops.cuda import lstm as cuda_lstm
from danet_tpu_torch.ops.nn import dropout, ee, uniform_init

BACKENDS = ("auto", "xla", "pallas", "pallas-interpret")


def lstm_init(generator: torch.Generator, idim: int, hdim: int,
              w_scale: Optional[float] = None,
              gate_bias: tuple = (0.0, 0.0, 0.0, 0.0), device=None) -> dict:
    """LSTM params: wx [idim,4,h], wh [h,4,h], b [4,h]; gate_bias is
    (candidate, input, forget, output)."""
    if w_scale is None:
        w_scale = 1.0 / math.sqrt(hdim)
    b = np.repeat(np.asarray(gate_bias, np.float32)[:, None], hdim, axis=1)
    return {
        "wx": uniform_init(generator, (idim, 4, hdim), w_scale, device),
        "wh": uniform_init(generator, (hdim, 4, hdim), w_scale, device),
        "b": torch.from_numpy(b).to(device),
    }


def bilstm_init(generator: torch.Generator, idim: int, hdim: int,
                w_scale=None, gate_bias=(0.0, 0.0, 0.0, 0.0),
                device=None) -> dict:
    return {
        "fwd": lstm_init(generator, idim, hdim, w_scale, gate_bias, device),
        "bwd": lstm_init(generator, idim, hdim, w_scale, gate_bias, device),
    }


def lstm_input_proj(params: dict, x_tm: torch.Tensor) -> torch.Tensor:
    """[T, B, idim] -> [T, B, 4, hdim] in the input's dtype."""
    dt = x_tm.dtype
    return ee("tbi,igh->tbgh", x_tm, params["wx"].to(dt)) \
        + params["b"].to(dt)


def _check_backend(backend: str, return_state: bool = False) -> bool:
    """True when ``backend`` takes the hand kernels (for CUDA tensors)."""
    if backend not in BACKENDS:
        raise ValueError("Unknown RNN backend %r (expected one of %s)"
                         % (backend, ", ".join(BACKENDS)))
    if return_state:
        raise NotImplementedError(
            "return_state (the final carry, for streaming and sequence "
            "parallelism) is not ported")
    return backend in ("auto", "pallas")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(v.requires_grad for v in tensors)


def lstm_apply(params: dict, x: torch.Tensor,
               candidate_activation: str = "tanh", reverse: bool = False,
               c0: Optional[torch.Tensor] = None,
               h0: Optional[torch.Tensor] = None, backend: str = "auto",
               return_state: bool = False) -> torch.Tensor:
    """One-direction LSTM over x [B, T, idim] -> [B, T, hdim].

    ``reverse`` runs over the time-reversed input and re-reverses the
    output.  The initial state is ``c0``/``h0`` [B, hdim], zeros by
    default."""
    use_kernel = _check_backend(backend, return_state)
    dt = x.dtype
    x_tm = x.transpose(0, 1)                                # [T, B, I]
    if reverse:
        x_tm = x_tm.flip(0)
    t, b = x_tm.shape[0], x_tm.shape[1]
    hdim = params["wh"].shape[0]
    xp = lstm_input_proj(params, x_tm).reshape(t, b, 4 * hdim).contiguous()
    wh = params["wh"].to(dt).reshape(hdim, 4 * hdim).contiguous()
    z = torch.zeros((b, hdim), dtype=dt, device=x.device)
    c0 = z if c0 is None else c0.to(dt).contiguous()
    h0 = z if h0 is None else h0.to(dt).contiguous()
    tanh_cand = candidate_activation == "tanh"
    if _needs_grad(xp, wh, c0, h0):
        hs = cuda_lstm.LstmScan.apply(xp, wh, c0, h0, tanh_cand, use_kernel)
    elif use_kernel:
        hs = cuda_lstm.lstm_scan(xp, wh, c0, h0, tanh_cand)
    else:
        hs = cuda_lstm.lstm_scan_plain(xp, wh, c0, h0, tanh_cand)
    if reverse:
        hs = hs.flip(0)
    return hs.transpose(0, 1)


def bilstm_apply(params: dict, x: torch.Tensor,
                 candidate_activation: str = "tanh",
                 dropout_rng: Optional[torch.Generator] = None,
                 keep_prob: float = 1.0,
                 backend: str = "auto") -> torch.Tensor:
    """BiLSTM: concat(fwd, bwd) [B, T, 2h], both directions in one fused
    scan (direction 1 runs on the time-reversed input and is restored),
    then inverted dropout drawn from ``dropout_rng`` when keep_prob < 1."""
    use_kernel = _check_backend(backend)
    dt = x.dtype
    x_tm = x.transpose(0, 1)                                # [T, B, I]
    t, b = x_tm.shape[0], x_tm.shape[1]
    hdim = params["fwd"]["wh"].shape[0]
    xp2 = torch.stack(
        [lstm_input_proj(params["fwd"], x_tm).reshape(t, b, 4 * hdim),
         lstm_input_proj(params["bwd"], x_tm.flip(0)).reshape(
             t, b, 4 * hdim)], dim=1).contiguous()          # [T, 2, B, 4H]
    wh2 = torch.stack(
        [params["fwd"]["wh"].to(dt).reshape(hdim, 4 * hdim),
         params["bwd"]["wh"].to(dt).reshape(hdim, 4 * hdim)]).contiguous()
    z = torch.zeros((2, b, hdim), dtype=dt, device=x.device)
    tanh_cand = candidate_activation == "tanh"
    if _needs_grad(xp2, wh2):
        hs2 = cuda_lstm.BiLstmScan.apply(xp2, wh2, z, z, tanh_cand,
                                         use_kernel)
    elif use_kernel:
        hs2 = cuda_lstm.bilstm_scan(xp2, wh2, z, z, tanh_cand)
    else:
        hs2 = cuda_lstm.bilstm_scan_plain(xp2, wh2, z, z, tanh_cand)
    y = torch.cat([hs2[:, 0].transpose(0, 1),
                   hs2[:, 1].flip(0).transpose(0, 1)], dim=-1)
    if dropout_rng is not None and keep_prob < 1.0:
        y = dropout(dropout_rng, y, keep_prob)
    return y


def gru_init(generator: torch.Generator, idim: int, hdim: int,
             w_scale: Optional[float] = None, device=None) -> dict:
    """GRU params (reference ops.py:151-188); the candidate bias starts at
    1.0 as in the reference."""
    if w_scale is None:
        w_scale = 0.1 / math.sqrt(hdim)
    return {
        "wgx": uniform_init(generator, (idim, 2, hdim), w_scale, device),
        "wgh": uniform_init(generator, (hdim, 2, hdim), w_scale, device),
        "bg": torch.zeros((2, hdim), device=device),
        "wcx": uniform_init(generator, (idim, hdim), w_scale, device),
        "wch": uniform_init(generator, (hdim, hdim), w_scale, device),
        "bc": torch.ones((hdim,), device=device),
    }


def gru_apply(params: dict, x: torch.Tensor,
              c0: Optional[torch.Tensor] = None, backend: str = "auto",
              return_state: bool = False) -> torch.Tensor:
    """GRU over x [B, T, idim] -> [B, T, hdim]: gates (r, u) from x and c,
    candidate tanh from x and c * r, c' = c * u + cand * (1 - u).  The
    initial state is ``c0`` [B, hdim], zeros by default."""
    use_kernel = _check_backend(backend, return_state)
    hdim = params["wch"].shape[0]
    dt = x.dtype
    x_tm = x.transpose(0, 1)                                # [T, B, I]
    t, b = x_tm.shape[0], x_tm.shape[1]
    gx = (ee("tbi,igh->tbgh", x_tm, params["wgx"].to(dt))
          + params["bg"].to(dt)).reshape(t, b, 2 * hdim).contiguous()
    cx = (ee("tbi,ih->tbh", x_tm, params["wcx"].to(dt))
          + params["bc"].to(dt)).contiguous()
    wgh = params["wgh"].to(dt).reshape(hdim, 2 * hdim).contiguous()
    wch = params["wch"].to(dt).contiguous()
    c0 = torch.zeros((b, hdim), dtype=dt, device=x.device) if c0 is None \
        else c0.to(dt).contiguous()
    if _needs_grad(gx, cx, wgh, wch, c0):
        cs = cuda_gru.GruScan.apply(gx, cx, wgh, wch, c0, use_kernel)
    elif use_kernel:
        cs = cuda_gru.gru_scan(gx, cx, wgh, wch, c0)
    else:
        cs = cuda_gru.gru_scan_plain(gx, cx, wgh, wch, c0)
    return cs.transpose(0, 1)
