"""Bidirectional LSTM layer: hoisted input projection + fused scan.

Counterpart of ``danet_tpu/ops/rnn.py:35-54,96-101,180-237``.  Parameters
are ``wx [I, 4, H]``, ``wh [H, 4, H]``, ``b [4, H]`` with gate order
cand|i|f|o.  The input projection of all timesteps is one matmul (JAX
leaves it to XLA; here ``torch.matmul``); only ``h @ Wh`` stays inside the
time loop, which is a hand kernel (``ops/cuda/lstm.py``): kernel B when no
gradient is needed, else ``BiLstmScan`` (kernel 2 forward, kernel 3
backward).

``LSTM_BACKEND`` keeps its JAX values: 'auto' and 'pallas' mean the hand
kernels for CUDA tensors (their plain versions for CPU tensors);
'xla' and 'pallas-interpret' mean the plain versions everywhere.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

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


def bilstm_apply(params: dict, x: torch.Tensor,
                 candidate_activation: str = "tanh",
                 dropout_rng: Optional[torch.Generator] = None,
                 keep_prob: float = 1.0,
                 backend: str = "auto") -> torch.Tensor:
    """BiLSTM: concat(fwd, bwd) [B, T, 2h], both directions in one fused
    scan (direction 1 runs on the time-reversed input and is restored),
    then inverted dropout drawn from ``dropout_rng`` when keep_prob < 1."""
    if backend not in BACKENDS:
        raise ValueError("Unknown RNN backend %r (expected one of %s)"
                         % (backend, ", ".join(BACKENDS)))
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
    use_kernel = backend in ("auto", "pallas")
    if torch.is_grad_enabled() and (xp2.requires_grad or wh2.requires_grad):
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
