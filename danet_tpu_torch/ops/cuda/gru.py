"""Wrappers of the fused GRU kernels, one launch per layer.

Replaces ``danet_tpu/ops/pallas/gru.py::gru_scan_pallas`` and its custom
VJP:

  * ``gru_scan``: kernel 4f, the lean (inference) forward (``_fwd_call``
    with ``save=False``);
  * ``gru_scan_train``: kernel 4f that also stores the residuals
    ``acts = [r | u | cand]`` (``save=True``);
  * ``gru_scan_bwd``: kernel 4b, the reverse-time backward (``_bwd_call``);
  * ``GruScan``: the ``torch.autograd.Function`` that ties them together
    as ``gru_scan_pallas``'s ``jax.custom_vjp`` does.

The CUDA sources are ``danet_tpu_torch/csrc/gru_scan.cu`` and
``csrc/gru_scan_bwd.cu``; their headers say what bounds them on an H100
(the two row exchanges per step between all blocks, through L2, not
FLOPs) and how the weights are split over blocks.

As in ``ops/cuda/lstm.py``, each wrapper launches its kernel for CUDA
tensors and uses its plain version (``*_plain``: Python loops over T with
the same float32 math and the same roundings to the storage dtype as
``gru.py:34-70``) for CPU tensors; on any other device it raises.
``<wrapper>.launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from danet_tpu_torch.ops.cuda.lstm import (_DTYPE_CODES, _check, _launch,
                                           _on_cuda)


def _scan_plain(gx, cx, wgh, wch, c0, save: bool):
    hdim = wch.shape[0]
    dt = gx.dtype
    wghf, wchf = wgh.float(), wch.float()
    c = c0.float()
    cs, acts = [], []
    for t in range(gx.shape[0]):
        # the product operands are rounded to the storage dtype: dt(c),
        # dt(c * r)
        gact = gx[t].float() + torch.mm(c.to(dt).float(), wghf)
        r = torch.sigmoid(gact[:, :hdim])
        u = torch.sigmoid(gact[:, hdim:])
        cand = torch.tanh(cx[t].float()
                          + torch.mm((c * r).to(dt).float(), wchf))
        c = c * u + cand * (1.0 - u)
        cs.append(c.to(dt))
        if save:
            acts.append(torch.cat([r, u, cand], dim=-1).to(dt))
    if not save:
        return torch.stack(cs)
    return torch.stack(cs), torch.stack(acts)


def gru_scan_plain(gx: torch.Tensor, cx: torch.Tensor, wgh: torch.Tensor,
                   wch: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 4f, lean.

    gx [T, B, 2H] (r|u), cx [T, B, H], wgh [H, 2H], wch [H, H], c0 [B, H]
    -> cs [T, B, H] in gx's dtype."""
    return _scan_plain(gx, cx, wgh, wch, c0, False)


def gru_scan_train_plain(gx, cx, wgh, wch, c0):
    """Plain version of kernel 4f with residuals: -> (cs, acts [T, B, 3H]
    = [r | u | cand]), in gx's dtype."""
    return _scan_plain(gx, cx, wgh, wch, c0, True)


def gru_scan_bwd_plain(d_cs, acts, c_prev, wgh, wch):
    """Plain version of kernel 4b: ``_bwd_kernel`` / ``_gru_bwd_step``
    (gru.py:50-70,102-134) in reverse time.

    d_cs, c_prev [T, B, H], acts [T, B, 3H], wgh [H, 2H], wch [H, H] ->
    (dgx [T, B, 2H], dcx [T, B, H], dc0 [B, H]) in d_cs's dtype.  dcx and
    dgx are rounded to that dtype before they feed the products with Wch
    and Wgh."""
    hdim = wch.shape[0]
    dt = d_cs.dtype
    wghf, wchf = wgh.float(), wch.float()
    dc = torch.zeros(d_cs.shape[1:], dtype=torch.float32,
                     device=d_cs.device)
    dgx, dcx = [None] * acts.shape[0], [None] * acts.shape[0]
    for t in range(acts.shape[0] - 1, -1, -1):
        a = acts[t].float()
        r, u, cand = a[:, :hdim], a[:, hdim:2 * hdim], a[:, 2 * hdim:]
        cp = c_prev[t].float()
        dc_total = d_cs[t].float() + dc
        du_pre = dc_total * (cp - cand) * u * (1.0 - u)
        dcand = (dc_total * (1.0 - u) * (1.0 - cand * cand)).to(dt)
        dcr = torch.mm(dcand.float(), wchf.t())
        dc = dc_total * u + dcr * r
        dr_pre = dcr * cp * r * (1.0 - r)
        dg = torch.cat([dr_pre, du_pre], dim=-1).to(dt)
        dc = dc + torch.mm(dg.float(), wghf.t())
        dgx[t], dcx[t] = dg, dcand
    return torch.stack(dgx), torch.stack(dcx), dc.to(dt)


def exchange_rows(b: int, hdim: int, device) -> torch.Tensor:
    """Scratch of kernel 4f, [2, B, H] words of 8 bytes: the rows its
    blocks exchange each step, dt(c) and dt(c * r), as value-and-step-tag
    words at B=1; at B > 1 the dt(c * r) values and the blocks'
    flags.  The kernel clears what it uses before its first step."""
    return torch.empty((2, b, hdim), dtype=torch.int64, device=device)


def exchange_flags(hdim: int, device) -> torch.Tensor:
    """Scratch of kernel 4b, [2, H] int32: one flag per block for each of
    the two rows its blocks exchange each step (dcx[t] with the du half of
    dgx[t], then the dr half), H covering any block count.  The kernel
    clears what it uses before its first step."""
    return torch.empty((2, hdim), dtype=torch.int32, device=device)


def _fwd(entry: str, save: bool, gx, cx, wgh, wch, c0):
    if gx.dim() != 3 or gx.shape[-1] % 2:
        raise ValueError("gx must be [T, B, 2H], got %s"
                         % (tuple(gx.shape),))
    t, b, g2 = gx.shape
    hdim = g2 // 2
    _check([("gx", gx), ("cx", cx), ("wgh", wgh), ("wch", wch), ("c0", c0)],
           [gx.shape, (t, b, hdim), (hdim, g2), (hdim, hdim), (b, hdim)])
    cs = torch.empty_like(cx)
    outs = (cs, torch.empty((t, b, 3 * hdim), dtype=gx.dtype,
                            device=gx.device)) if save else (cs,)
    _launch(entry, entry + " kernel", gx.device,
            (gx, cx, wgh, wch, c0) + outs + (exchange_rows(b, hdim,
                                                           gx.device),),
            (t, b, hdim, _DTYPE_CODES[gx.dtype]))
    return outs if save else cs


def gru_scan(gx: torch.Tensor, cx: torch.Tensor, wgh: torch.Tensor,
             wch: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """Kernel 4f, the lean forward (signature of the plain version)."""
    if not _on_cuda(gx, "gru_scan"):
        return gru_scan_plain(gx, cx, wgh, wch, c0)
    cs = _fwd("danet_gru_scan", False, gx, cx, wgh, wch, c0)
    gru_scan.launches += 1
    return cs


def gru_scan_train(gx, cx, wgh, wch, c0):
    """Kernel 4f with residuals: -> (cs, acts)."""
    if not _on_cuda(gx, "gru_scan_train"):
        return gru_scan_train_plain(gx, cx, wgh, wch, c0)
    out = _fwd("danet_gru_scan_train", True, gx, cx, wgh, wch, c0)
    gru_scan_train.launches += 1
    return out


def gru_scan_bwd(d_cs, acts, c_prev, wgh, wch):
    """Kernel 4b, the backward: -> (dgx, dcx, dc0) (signature of the plain
    version)."""
    if not _on_cuda(d_cs, "gru_scan_bwd"):
        return gru_scan_bwd_plain(d_cs, acts, c_prev, wgh, wch)
    if acts.dim() != 3 or acts.shape[-1] % 3:
        raise ValueError("acts must be [T, B, 3H], got %s"
                         % (tuple(acts.shape),))
    t, b, g3 = acts.shape
    hdim = g3 // 3
    _check([("d_cs", d_cs), ("acts", acts), ("c_prev", c_prev),
            ("wgh", wgh), ("wch", wch)],
           [(t, b, hdim), acts.shape, (t, b, hdim), (hdim, 2 * hdim),
            (hdim, hdim)])
    dgx = torch.empty((t, b, 2 * hdim), dtype=acts.dtype, device=acts.device)
    dcx = torch.empty_like(d_cs)
    dc0 = torch.empty((b, hdim), dtype=acts.dtype, device=acts.device)
    _launch("danet_gru_scan_bwd", "gru_scan_bwd kernel", acts.device,
            (d_cs, acts, c_prev, wgh, wch, dgx, dcx, dc0,
             exchange_flags(hdim, acts.device)),
            (t, b, hdim, _DTYPE_CODES[acts.dtype]))
    gru_scan_bwd.launches += 1
    return dgx, dcx, dc0


for _fn in (gru_scan, gru_scan_train, gru_scan_bwd):
    _fn.launches = 0


class GruScan(torch.autograd.Function):
    """Differentiable fused GRU scan: the counterpart of
    ``gru_scan_pallas`` with its custom VJP (gru.py:196-230).

    ``GruScan.apply(gx, cx, wgh, wch, c0, use_kernel) -> cs``.  The forward
    runs kernel 4f with residuals (or its plain version when
    ``use_kernel`` is false); the backward runs kernel 4b (or its plain
    version) and computes dWgh = sum_t c_prev^T dgx[t] and dWch =
    sum_t dt(c_prev * r)^T dcx[t] as bulk matmuls over all timesteps,
    outside the kernel, as the JAX package does.  Callers that need no
    gradient call ``gru_scan``."""

    @staticmethod
    def forward(ctx, gx, cx, wgh, wch, c0, use_kernel: bool):
        fwd = gru_scan_train if use_kernel else gru_scan_train_plain
        cs, acts = fwd(gx, cx, wgh, wch, c0)
        ctx.save_for_backward(wgh, wch, c0, cs, acts)
        ctx.use_kernel = use_kernel
        return cs

    @staticmethod
    def backward(ctx, d_cs):
        wgh, wch, c0, cs, acts = ctx.saved_tensors
        c_prev = torch.cat([c0[None], cs[:-1]])
        bwd = gru_scan_bwd if ctx.use_kernel else gru_scan_bwd_plain
        dgx, dcx, dc0 = bwd(d_cs.contiguous(), acts, c_prev, wgh, wch)
        hdim = wch.shape[0]
        r = acts[..., :hdim]
        # c_prev * r in the storage dtype, then an f32-accumulated product
        dwgh = torch.mm(c_prev.float().reshape(-1, hdim).t(),
                        dgx.float().reshape(-1, 2 * hdim))
        dwch = torch.mm((c_prev * r).float().reshape(-1, hdim).t(),
                        dcx.float().reshape(-1, hdim))
        return dgx, dcx, dwgh.to(wgh.dtype), dwch.to(wch.dtype), dc0, None
