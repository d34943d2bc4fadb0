"""Kernel B wrapper: fused bidirectional LSTM time loop, one launch per layer.

Replaces the lean (inference) forward of
``danet_tpu/ops/pallas/lstm.py::bilstm_scan_pallas`` (``_fwd_call`` with
``n_dirs=2, save=False``).  The CUDA source is
``danet_tpu_torch/csrc/bilstm_scan.cu``; its header says what bounds it on
an H100 (the per-step latency of the grid-wide barrier and of the h_{t-1}
exchange through L2, not FLOPs) and how Wh is split over blocks.

``bilstm_scan`` launches the kernel for CUDA tensors and uses the plain
version, ``bilstm_scan_plain``, for CPU tensors: a Python loop over T with
the same float32 gate math and the same per-step rounding of h to the
storage dtype.  ``bilstm_scan.launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def bilstm_scan_plain(xp: torch.Tensor, wh: torch.Tensor, c0: torch.Tensor,
                      h0: torch.Tensor, tanh_cand: bool) -> torch.Tensor:
    """Plain version of kernel B.

    xp [T, 2, B, 4H] (direction 1 already time-reversed), wh [2, H, 4H],
    c0/h0 [2, B, H] -> hs [T, 2, B, H] in xp's dtype."""
    hdim = wh.shape[1]
    dt = xp.dtype
    whf = wh.float()
    c = c0.float()
    h = h0.to(dt)
    hs = torch.empty(xp.shape[:3] + (hdim,), dtype=dt, device=xp.device)
    for t in range(xp.shape[0]):
        act = xp[t].float() + torch.bmm(h.float(), whf)   # [2, B, 4H] f32
        cand = act[..., :hdim]
        if tanh_cand:
            cand = torch.tanh(cand)
        i = torch.sigmoid(act[..., hdim:2 * hdim])
        f = torch.sigmoid(act[..., 2 * hdim:3 * hdim])
        o = torch.sigmoid(act[..., 3 * hdim:])
        c = i * cand + f * c
        h = (o * torch.tanh(c)).to(dt)
        hs[t] = h
    return hs


def _check(xp, wh, c0, h0):
    if xp.dim() != 4 or xp.shape[1] != 2:
        raise ValueError("xp must be [T, 2, B, 4H], got %s"
                         % (tuple(xp.shape),))
    t, _, b, g4 = xp.shape
    hdim = g4 // 4
    if g4 != 4 * hdim or tuple(wh.shape) != (2, hdim, g4):
        raise ValueError("wh must be [2, H, 4H] = %s, got %s"
                         % ((2, hdim, g4), tuple(wh.shape)))
    for name, v in (("c0", c0), ("h0", h0)):
        if tuple(v.shape) != (2, b, hdim):
            raise ValueError("%s must be [2, B, H] = %s, got %s"
                             % (name, (2, b, hdim), tuple(v.shape)))
    for name, v in (("xp", xp), ("wh", wh), ("c0", c0), ("h0", h0)):
        if v.dtype != xp.dtype:
            raise ValueError("%s is %s, xp is %s: one storage dtype"
                             % (name, v.dtype, xp.dtype))
        if v.device != xp.device:
            raise ValueError("%s on %s, xp on %s" % (name, v.device,
                                                     xp.device))
        if not v.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    if xp.dtype not in _DTYPE_CODES:
        raise ValueError("bilstm_scan kernel takes float32 or bfloat16, "
                         "got %s" % (xp.dtype,))
    return t, b, hdim


def bilstm_scan(xp: torch.Tensor, wh: torch.Tensor, c0: torch.Tensor,
                h0: torch.Tensor, tanh_cand: bool) -> torch.Tensor:
    """Fused bidirectional LSTM scan (signature of the plain version).

    Kernel on CUDA tensors, plain version on CPU tensors."""
    if xp.device.type == "cpu":
        return bilstm_scan_plain(xp, wh, c0, h0, tanh_cand)
    if xp.device.type != "cuda":
        raise ValueError("bilstm_scan: unsupported device %s" % (xp.device,))
    t, b, hdim = _check(xp, wh, c0, h0)
    from danet_tpu_torch.ops.cuda import _build

    hs = torch.empty((t, 2, b, hdim), dtype=xp.dtype, device=xp.device)
    lib = _build.library()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        status = lib.danet_bilstm_scan(
            xp.data_ptr(), wh.data_ptr(), c0.data_ptr(), h0.data_ptr(),
            hs.data_ptr(), t, b, hdim, _DTYPE_CODES[xp.dtype],
            int(bool(tanh_cand)), stream)
    _build.check(status, "bilstm_scan kernel")
    bilstm_scan.launches += 1
    return hs


bilstm_scan.launches = 0
