"""Recurrent layers: hoisted input projections + fused scans.

Counterpart of ``danet_tpu/ops/rnn.py:35-354``: the one-direction LSTM
(``lstm_apply``), the bidirectional LSTM (``bilstm_apply``, and
``bilstm_apply_tp``, one rank's share under tensor parallelism) and the
GRU (``gru_init``/``gru_apply``).  LSTM
parameters are ``wx [I, 4, H]``, ``wh [H, 4, H]``, ``b [4, H]`` with gate
order cand|i|f|o; GRU parameters ``wgx [I, 2, H]``, ``wgh [H, 2, H]``,
``bg [2, H]``, ``wcx [I, H]``, ``wch [H, H]``, ``bc [H]``.  The input
projection of all timesteps is one matmul (JAX leaves it to XLA; here
``torch.matmul``); only the recurrent products stay inside the time loop,
which is a hand kernel: ``ops/cuda/lstm.py`` (kernel B when no gradient is
needed, else ``LstmScan``/``BiLstmScan``: kernel 2 forward, kernel 3
backward) and ``ops/cuda/gru.py`` (``gru_scan``, else ``GruScan``).  The
no-gradient scans go through their ``torch.library`` ops
(``ops/cuda/library.py``: ``danet::bilstm_scan``, ``lstm_scan``,
``lstm_scan_state``, ``gru_scan``), so that an exported program records
them.

``LSTM_BACKEND`` keeps its JAX values: 'auto' and 'pallas' mean the hand
kernels for CUDA tensors (their plain versions for CPU tensors);
'xla' and 'pallas-interpret' mean the plain versions everywhere.  JAX's
``lstm_backend_default`` also resolves 'auto' to its XLA scan under
MESH_MODEL > 1, only because a ``pallas_call`` has no GSPMD partitioning
rule; here every rank runs its own rows with the full weights
(``bilstm_apply_tp``), so 'auto' keeps the kernels under tensor
parallelism too.
``return_state`` returns the final carry as well, as JAX's does (for a
reversed scan, the state after consuming the input down to its first
frame): the LSTM's ``(c, h)``, c in float32 whatever the compute dtype
(the kernel's own carry, from kernel B's state entry; h is the last row
of hs), and the GRU's ``c``, the last row of kernel 4f's ``cs``.  Under
autograd (sequence parallelism's relay and halo warm-up,
``parallel/seq_parallel.py``) the LSTM's carry runs through
``LstmScanState``: the saving forward's state entry and kernel 3 seeded
with the cotangent of c (h's arrives in hs's); the GRU's carry is a row
of cs, whose cotangent ``GruScan`` already takes.  JAX routes
``return_state`` to its XLA scan instead (its Pallas kernels have no
carry output); here it stays on the hand kernels.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from danet_tpu_torch.ops.cuda import gru as cuda_gru
from danet_tpu_torch.ops.cuda import library
from danet_tpu_torch.ops.cuda import lstm as cuda_lstm
from danet_tpu_torch.ops.nn import acc_dtype, dropout, ee, uniform_init

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


def _check_backend(backend: str) -> bool:
    """True when ``backend`` takes the hand kernels (for CUDA tensors)."""
    if backend not in BACKENDS:
        raise ValueError("Unknown RNN backend %r (expected one of %s)"
                         % (backend, ", ".join(BACKENDS)))
    return backend in ("auto", "pallas")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(v.requires_grad for v in tensors)


def lstm_apply(params: dict, x: torch.Tensor,
               candidate_activation: str = "tanh", reverse: bool = False,
               c0: Optional[torch.Tensor] = None,
               h0: Optional[torch.Tensor] = None, backend: str = "auto",
               return_state: bool = False):
    """One-direction LSTM over x [B, T, idim] -> [B, T, hdim].

    ``reverse`` runs over the time-reversed input and re-reverses the
    output.  The initial state is ``c0``/``h0`` [B, hdim], zeros by
    default.  ``return_state`` -> (hs, (c, h)), the final carry: c in
    float32 (float64 for float64 inputs), h in x's dtype; c0 is then kept
    in that float32 too."""
    use_kernel = _check_backend(backend)
    dt = x.dtype
    x_tm = x.transpose(0, 1)                                # [T, B, I]
    if reverse:
        x_tm = x_tm.flip(0)
    t, b = x_tm.shape[0], x_tm.shape[1]
    hdim = params["wh"].shape[0]
    xp = lstm_input_proj(params, x_tm).reshape(t, b, 4 * hdim).contiguous()
    wh = params["wh"].to(dt).reshape(hdim, 4 * hdim).contiguous()
    z = torch.zeros((b, hdim), dtype=dt, device=x.device)
    cdt = acc_dtype(xp) if return_state else dt
    c0 = z.to(cdt) if c0 is None else c0.to(cdt).contiguous()
    h0 = z if h0 is None else h0.to(dt).contiguous()
    tanh_cand = candidate_activation == "tanh"
    if return_state:
        if _needs_grad(xp, wh, c0, h0):
            hs, c_t = cuda_lstm.LstmScanState.apply(xp, wh, c0, h0,
                                                    tanh_cand, use_kernel)
        elif use_kernel:
            hs, c_t = library.lstm_scan_state(xp, wh, c0, h0, tanh_cand)
        else:
            hs, c_t = cuda_lstm.lstm_scan_plain(xp, wh, c0, h0, tanh_cand,
                                                True)
        state = (c_t, hs[-1])
        if reverse:
            hs = hs.flip(0)
        return hs.transpose(0, 1), state
    if _needs_grad(xp, wh, c0, h0):
        hs = cuda_lstm.LstmScan.apply(xp, wh, c0, h0, tanh_cand, use_kernel)
    elif use_kernel:
        hs = library.lstm_scan(xp, wh, c0, h0, tanh_cand)
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
        hs2 = library.bilstm_scan(xp2, wh2, z, z, tanh_cand)
    else:
        hs2 = cuda_lstm.bilstm_scan_plain(xp2, wh2, z, z, tanh_cand)
    y = torch.cat([hs2[:, 0].transpose(0, 1),
                   hs2[:, 1].flip(0).transpose(0, 1)], dim=-1)
    if dropout_rng is not None and keep_prob < 1.0:
        y = dropout(dropout_rng, y, keep_prob)
    return y


def bilstm_apply_tp(params: dict, x: torch.Tensor, mesh,
                    candidate_activation: str = "tanh",
                    backend: str = "pallas") -> torch.Tensor:
    """The BiLSTM of one rank under tensor parallelism: the body of JAX's
    ``bilstm_apply_tp`` shard_map (``danet_tpu/ops/rnn.py:249-287``).

    ``x`` is this rank's rows of the global batch and ``params`` the
    layer's FULL weights: the trainer splits the batch over ('data',
    'model') and gathers the 'model'-sharded leaves over the 'model' group
    once per step (``parallel/sharding.py``), where JAX's ``in_specs`` do
    both per layer.  Every rank then runs the fused scan on its rows with
    the full recurrent weights (kernels 2 and 3 under autograd, B without,
    on a card): the exact TP-over-hidden recurrence would need a gather of
    h at every step, which no single kernel launch can hold.  No dropout:
    the caller draws it from the rank's own generator.  A rank's slice of
    the weights (wh [H, 4, H / n_model]) raises ValueError."""
    if "model" not in mesh.shape:
        raise ValueError("bilstm_apply_tp needs a mesh with a 'model' axis")
    for d in ("fwd", "bwd"):
        wh = params[d]["wh"]
        if wh.shape[0] != wh.shape[-1]:
            raise ValueError(
                "bilstm_apply_tp needs the full weights (wh %s is one "
                "rank's slice): gather them over the 'model' group first"
                % (tuple(wh.shape),))
    return bilstm_apply(params, x, candidate_activation, backend=backend)


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
              return_state: bool = False):
    """GRU over x [B, T, idim] -> [B, T, hdim]: gates (r, u) from x and c,
    candidate tanh from x and c * r, c' = c * u + cand * (1 - u).  The
    initial state is ``c0`` [B, hdim], zeros by default.
    ``return_state`` -> (cs, c), c the last row of cs."""
    use_kernel = _check_backend(backend)
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
        cs = library.gru_scan(gx, cx, wgh, wch, c0)
    else:
        cs = cuda_gru.gru_scan_plain(gx, cx, wgh, wch, c0)
    if return_state:
        return cs.transpose(0, 1), cs[-1]
    return cs.transpose(0, 1)
