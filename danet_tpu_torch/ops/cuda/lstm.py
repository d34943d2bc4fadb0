"""Wrappers of the fused LSTM kernels, one launch per layer.

Replaces ``danet_tpu/ops/pallas/lstm.py::bilstm_scan_pallas`` (n_dirs=2)
and ``lstm_scan_pallas`` (n_dirs=1) with their custom VJPs:

  * ``bilstm_scan`` / ``lstm_scan``: kernel B, the lean (inference)
    forward (``_fwd_call`` with ``save=False``);
  * ``bilstm_scan_train``: kernel 2, the forward that also stores the
    residuals ``cs`` and ``acts`` (``save=True``), kernel B's design with
    ``SAVE``; ``lstm_scan_train``: the same on one direction;
  * ``bilstm_scan_bwd`` / ``lstm_scan_bwd``: kernel 3, the reverse-time
    backward (``_bwd_call``);
  * ``BiLstmScan`` / ``LstmScan``: the autograd Functions that tie
    them together as ``_make_scan`` does with ``jax.custom_vjp``.

The one-direction wrappers launch the same kernels with the direction
count as a parameter (``[T, 1, B, .]`` is ``[T, B, .]``), each under its
own C entry point and launch counter.  The CUDA sources are
``danet_tpu_torch/csrc/lstm_scan_lean.cu`` (kernel B, and with ``SAVE``
kernel 2 and its one-direction form) and ``csrc/bilstm_scan_bwd.cu``
(kernel 3); their headers say what bounds them on an H100 (the latency of
each step's exchange of h between the blocks, through L2, not FLOPs) and
how Wh is split over blocks.  The forwards pass no grid barrier: their
blocks exchange h as value-and-step words at B=1 and behind per-block
flags above it, each direction on its own (``exchange_words``).

Each wrapper launches its kernel for CUDA tensors and uses its plain
version (``*_plain``: Python loops over T with the same float32 gate math
and the same roundings to the storage dtype) for CPU tensors; on any other
device it raises.  ``<wrapper>.launches`` counts the kernel launches.

A kernel's shared memory grows with the batch, so one launch takes at most
a ceiling of rows (``max_rows``: from the kernel library, by H, dtype and
kind; at H=128 about 5,000 rows for the forwards and 885 for the
backward).  A larger batch is split into launches of at most that many
rows each; the rows are independent, so the split is exact.
"""
from __future__ import annotations

import ctypes
import math

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scan_plain(xp, wh, c0, h0, tanh_cand: bool, save: bool):
    hdim = wh.shape[1]
    dt = xp.dtype
    whf = wh.float()
    c = c0.float()
    h = h0.to(dt)
    hs, cs, acts = [], [], []
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
        hs.append(h)
        if save:
            cs.append(c.to(dt))
            acts.append(torch.cat([cand, i, f, o], dim=-1).to(dt))
    if not save:
        return torch.stack(hs)
    return torch.stack(hs), torch.stack(cs), torch.stack(acts)


def bilstm_scan_plain(xp: torch.Tensor, wh: torch.Tensor, c0: torch.Tensor,
                      h0: torch.Tensor, tanh_cand: bool) -> torch.Tensor:
    """Plain version of kernel B.

    xp [T, 2, B, 4H] (direction 1 already time-reversed), wh [2, H, 4H],
    c0/h0 [2, B, H] -> hs [T, 2, B, H] in xp's dtype."""
    return _scan_plain(xp, wh, c0, h0, tanh_cand, False)


def bilstm_scan_train_plain(xp, wh, c0, h0, tanh_cand: bool):
    """Plain version of kernel 2: -> (hs, cs [T, 2, B, H], acts
    [T, 2, B, 4H]), acts = [cand, i, f, o] after their activations; all in
    xp's dtype."""
    return _scan_plain(xp, wh, c0, h0, tanh_cand, True)


def lstm_scan_plain(xp, wh, c0, h0, tanh_cand: bool) -> torch.Tensor:
    """Plain version of the one-direction kernel B: xp [T, B, 4H], wh
    [H, 4H], c0/h0 [B, H] -> hs [T, B, H]."""
    return _scan_plain(xp[:, None], wh[None], c0[None], h0[None], tanh_cand,
                       False)[:, 0]


def lstm_scan_train_plain(xp, wh, c0, h0, tanh_cand: bool):
    """Plain version of the one-direction saving forward: -> (hs, cs
    [T, B, H], acts [T, B, 4H])."""
    out = _scan_plain(xp[:, None], wh[None], c0[None], h0[None], tanh_cand,
                      True)
    return tuple(v[:, 0] for v in out)


def bilstm_scan_bwd_plain(d_hs, acts, cs, c_prev, wh, tanh_cand: bool):
    """Plain version of kernel 3: ``_bwd_kernel`` / ``_cell_bwd_step``
    (lstm.py:80-96,144-197) in reverse time.

    d_hs, cs, c_prev [T, 2, B, H], acts [T, 2, B, 4H], wh [2, H, 4H] ->
    (dxp [T, 2, B, 4H], dc0, dh0 [2, B, H]) in d_hs's dtype.  dxp is
    rounded to that dtype before it feeds dh_{t-1} = dxp[t] @ Wh^T."""
    hdim = wh.shape[1]
    dt = d_hs.dtype
    wht = wh.float().transpose(1, 2)                       # [2, 4H, H]
    dc = torch.zeros(cs.shape[1:], dtype=torch.float32, device=cs.device)
    dh = torch.zeros_like(dc)
    dxp = [None] * acts.shape[0]
    for t in range(acts.shape[0] - 1, -1, -1):
        a = acts[t].float()
        cand, i = a[..., :hdim], a[..., hdim:2 * hdim]
        f, o = a[..., 2 * hdim:3 * hdim], a[..., 3 * hdim:]
        tanh_c = torch.tanh(cs[t].float())
        dh_total = d_hs[t].float() + dh
        do_pre = dh_total * tanh_c * o * (1.0 - o)
        dc = dc + dh_total * o * (1.0 - tanh_c * tanh_c)
        dcand = dc * i
        dcand_pre = dcand * (1.0 - cand * cand) if tanh_cand else dcand
        di_pre = dc * cand * i * (1.0 - i)
        df_pre = dc * c_prev[t].float() * f * (1.0 - f)
        dact = torch.cat([dcand_pre, di_pre, df_pre, do_pre], dim=-1).to(dt)
        dxp[t] = dact
        dc = dc * f
        dh = torch.bmm(dact.float(), wht)
    return torch.stack(dxp), dc.to(dt), dh.to(dt)


def lstm_scan_bwd_plain(d_hs, acts, cs, c_prev, wh, tanh_cand: bool):
    """Plain version of the one-direction kernel 3: d_hs, cs, c_prev
    [T, B, H], acts [T, B, 4H], wh [H, 4H] -> (dxp [T, B, 4H], dc0, dh0
    [B, H])."""
    dxp, dc0, dh0 = bilstm_scan_bwd_plain(
        d_hs[:, None], acts[:, None], cs[:, None], c_prev[:, None], wh[None],
        tanh_cand)
    return dxp[:, 0], dc0[0], dh0[0]


def _check(named, shapes):
    """Shapes, one storage dtype, one device, contiguity."""
    first = named[0][1]
    for (name, v), shape in zip(named, shapes):
        if tuple(v.shape) != tuple(shape):
            raise ValueError("%s must be %s, got %s"
                             % (name, tuple(shape), tuple(v.shape)))
        if v.dtype != first.dtype:
            raise ValueError("%s is %s, %s is %s: one storage dtype"
                             % (name, v.dtype, named[0][0], first.dtype))
        if v.device != first.device:
            raise ValueError("%s on %s, %s on %s"
                             % (name, v.device, named[0][0], first.device))
        if not v.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    if first.dtype not in _DTYPE_CODES:
        raise ValueError("the scan kernels take float32 or bfloat16, got %s"
                         % (first.dtype,))


def _dirs(n_dirs: int, *shape) -> tuple:
    """(n_dirs, *shape), without the direction axis for one direction."""
    return shape if n_dirs == 1 else (n_dirs,) + shape


def _fwd_shapes(xp, wh, c0, h0, n_dirs: int):
    """(T, B, H) of a forward call on ``n_dirs`` directions."""
    if xp.dim() != 2 + len(_dirs(n_dirs, 0)) or xp.shape[-1] % 4 \
            or (n_dirs == 2 and xp.shape[1] != 2):
        raise ValueError("xp must be [T, %sB, 4H], got %s"
                         % ("2, " if n_dirs == 2 else "", tuple(xp.shape)))
    t, b, g4 = xp.shape[0], xp.shape[-2], xp.shape[-1]
    hdim = g4 // 4
    _check([("xp", xp), ("wh", wh), ("c0", c0), ("h0", h0)],
           [xp.shape, _dirs(n_dirs, hdim, g4), _dirs(n_dirs, b, hdim),
            _dirs(n_dirs, b, hdim)])
    return t, b, hdim


def _on_cuda(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (what, x.device))
    return True


def _launch(entry: str, what: str, device, tensors, ints) -> None:
    from danet_tpu_torch.ops.cuda import _build

    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, entry)(*[v.data_ptr() for v in tensors],
                                     *ints, stream)
    _build.check(status, what)


def exchange_words(n_dirs: int, b: int, hdim: int, device) -> torch.Tensor:
    """Scratch of the forwards, [2, D, B, H] words of 8 bytes: the rows h_t its
    blocks exchange each step, as value-and-step-tag words by the parity
    of t at B=1; at B > 1 the blocks' flags.  The kernel clears what it
    uses before its first step."""
    return torch.empty((2, n_dirs, b, hdim), dtype=torch.int64,
                       device=device)


_MAX_ROWS: dict = {}


def max_rows(device, hdim: int, dtype, kind: str) -> int:
    """The most batch rows one launch of a ``kind`` ('lean', 'save' or
    'bwd') kernel takes at H = ``hdim`` in ``dtype`` on ``device``: the
    largest batch whose shared memory fits the card's opt-in, from the
    kernel library (the same for one and two directions); cached.  0 (no
    split) for a device that is not a card, where no kernel launches."""
    if torch.device(device).type != "cuda":
        return 0
    from danet_tpu_torch.ops.cuda import _build

    lib = _build.library()
    key = (id(lib), str(device), hdim, dtype, kind)
    rows = _MAX_ROWS.get(key)
    if rows is None:
        entry = "danet_lstm_scan_%smax_rows" % ("bwd_" if kind == "bwd"
                                                else "")
        out = ctypes.c_int(0)
        args = (hdim,) if kind == "bwd" else (
            int(kind == "save"), hdim, _DTYPE_CODES[dtype])
        with torch.cuda.device(device):
            status = getattr(lib, entry)(*args, ctypes.byref(out))
        _build.check(status, entry)
        rows = _MAX_ROWS[key] = out.value
    return rows


def _by_rows(run, rows: int, *batched):
    """``run(*batched)`` over the batch axis (-2) of every tensor in
    ``batched``, in launches of at most ``rows`` rows (as even as can be)
    when the batch exceeds it, the outputs joined on that axis; run once
    as it is otherwise (a ceiling below one row included: the launch then
    reports the kernel's refusal)."""
    b = batched[0].shape[-2]
    if rows < 1 or b <= rows:
        return run(*batched)
    step = -(-b // math.ceil(b / rows))
    parts = [run(*[v[..., lo:lo + step, :].contiguous() for v in batched])
             for lo in range(0, b, step)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p, dim=-2) for p in zip(*parts))
    return torch.cat(parts, dim=-2)


def _fwd(wrapper, entry: str, n_dirs: int, save: bool, xp, wh, c0, h0,
         tanh_cand, rows=None):
    """Launch a forward kernel, ``wrapper.launches`` counting each launch:
    -> hs, or (hs, cs, acts) when ``save``.  A batch above ``rows``
    (``max_rows`` by default) is split across launches."""
    t, b, hdim = _fwd_shapes(xp, wh, c0, h0, n_dirs)
    if rows is None:
        rows = max_rows(xp.device, hdim, xp.dtype, "save" if save else "lean")

    def launch(xp, c0, h0):
        b = xp.shape[-2]
        hs = torch.empty((t,) + _dirs(n_dirs, b, hdim), dtype=xp.dtype,
                         device=xp.device)
        outs = (hs, torch.empty_like(hs), torch.empty_like(xp)) if save \
            else (hs,)
        xch = exchange_words(n_dirs, b, hdim, xp.device)
        _launch(entry, entry + " kernel", xp.device, (xp, wh, c0, h0) + outs
                + (xch,), (t, b, hdim, _DTYPE_CODES[xp.dtype],
                           int(bool(tanh_cand))))
        wrapper.launches += 1
        return outs if save else hs
    return _by_rows(launch, rows, xp, c0, h0)


def _bwd(wrapper, entry: str, n_dirs: int, d_hs, acts, cs, c_prev, wh,
         tanh_cand, rows=None):
    """Launch a backward kernel, ``wrapper.launches`` counting each launch:
    -> (dxp, dc0, dh0).  A batch above ``rows`` (``max_rows`` by default)
    is split across launches."""
    if acts.dim() != 2 + len(_dirs(n_dirs, 0)) or acts.shape[-1] % 4 \
            or (n_dirs == 2 and acts.shape[1] != 2):
        raise ValueError("acts must be [T, %sB, 4H], got %s"
                         % ("2, " if n_dirs == 2 else "",
                            tuple(acts.shape)))
    t, b, g4 = acts.shape[0], acts.shape[-2], acts.shape[-1]
    hdim = g4 // 4
    hshape = (t,) + _dirs(n_dirs, b, hdim)
    _check([("d_hs", d_hs), ("acts", acts), ("cs", cs), ("c_prev", c_prev),
            ("wh", wh)],
           [hshape, acts.shape, hshape, hshape, _dirs(n_dirs, hdim, g4)])
    if rows is None:
        rows = max_rows(acts.device, hdim, acts.dtype, "bwd")

    def launch(d_hs, acts, cs, c_prev):
        b = acts.shape[-2]
        dxp = torch.empty_like(acts)
        dc0 = torch.empty(_dirs(n_dirs, b, hdim), dtype=acts.dtype,
                          device=acts.device)
        dh0 = torch.empty_like(dc0)
        _launch(entry, entry + " kernel", acts.device,
                (d_hs, acts, cs, c_prev, wh, dxp, dc0, dh0),
                (t, b, hdim, _DTYPE_CODES[acts.dtype], int(bool(tanh_cand))))
        wrapper.launches += 1
        return dxp, dc0, dh0
    return _by_rows(launch, rows, d_hs, acts, cs, c_prev)


def bilstm_scan(xp: torch.Tensor, wh: torch.Tensor, c0: torch.Tensor,
                h0: torch.Tensor, tanh_cand: bool) -> torch.Tensor:
    """Kernel B, the lean forward (signature of the plain version)."""
    if not _on_cuda(xp, "bilstm_scan"):
        return bilstm_scan_plain(xp, wh, c0, h0, tanh_cand)
    return _fwd(bilstm_scan, "danet_bilstm_scan", 2, False, xp, wh, c0, h0,
                tanh_cand)


def bilstm_scan_train(xp, wh, c0, h0, tanh_cand: bool):
    """Kernel 2, the forward that stores residuals: -> (hs, cs, acts)."""
    if not _on_cuda(xp, "bilstm_scan_train"):
        return bilstm_scan_train_plain(xp, wh, c0, h0, tanh_cand)
    return _fwd(bilstm_scan_train, "danet_bilstm_scan_train", 2, True, xp,
                wh, c0, h0, tanh_cand)


def bilstm_scan_bwd(d_hs, acts, cs, c_prev, wh, tanh_cand: bool):
    """Kernel 3, the backward: -> (dxp, dc0, dh0) (signature of the plain
    version)."""
    if not _on_cuda(d_hs, "bilstm_scan_bwd"):
        return bilstm_scan_bwd_plain(d_hs, acts, cs, c_prev, wh, tanh_cand)
    return _bwd(bilstm_scan_bwd, "danet_bilstm_scan_bwd", 2, d_hs, acts, cs,
                c_prev, wh, tanh_cand)


def lstm_scan(xp: torch.Tensor, wh: torch.Tensor, c0: torch.Tensor,
              h0: torch.Tensor, tanh_cand: bool) -> torch.Tensor:
    """Kernel B on one direction: xp [T, B, 4H], wh [H, 4H], c0/h0 [B, H]
    -> hs [T, B, H]."""
    if not _on_cuda(xp, "lstm_scan"):
        return lstm_scan_plain(xp, wh, c0, h0, tanh_cand)
    return _fwd(lstm_scan, "danet_lstm_scan", 1, False, xp, wh, c0, h0,
                tanh_cand)


def lstm_scan_train(xp, wh, c0, h0, tanh_cand: bool):
    """The saving forward on one direction: -> (hs, cs [T, B, H], acts
    [T, B, 4H])."""
    if not _on_cuda(xp, "lstm_scan_train"):
        return lstm_scan_train_plain(xp, wh, c0, h0, tanh_cand)
    return _fwd(lstm_scan_train, "danet_lstm_scan_train", 1, True, xp, wh,
                c0, h0, tanh_cand)


def lstm_scan_bwd(d_hs, acts, cs, c_prev, wh, tanh_cand: bool):
    """Kernel 3 on one direction: -> (dxp [T, B, 4H], dc0, dh0 [B, H])."""
    if not _on_cuda(d_hs, "lstm_scan_bwd"):
        return lstm_scan_bwd_plain(d_hs, acts, cs, c_prev, wh, tanh_cand)
    return _bwd(lstm_scan_bwd, "danet_lstm_scan_bwd", 1, d_hs, acts, cs,
                c_prev, wh, tanh_cand)


for _fn in (bilstm_scan, bilstm_scan_train, bilstm_scan_bwd, lstm_scan,
            lstm_scan_train, lstm_scan_bwd):
    _fn.launches = 0


# (train forward, its plain version, backward, its plain version) by
# direction count
_TRAIN_KERNELS = {
    1: (lstm_scan_train, lstm_scan_train_plain, lstm_scan_bwd,
        lstm_scan_bwd_plain),
    2: (bilstm_scan_train, bilstm_scan_train_plain, bilstm_scan_bwd,
        bilstm_scan_bwd_plain),
}


def _scan_forward(ctx, n_dirs, xp, wh, c0, h0, tanh_cand, use_kernel):
    fwd, fwd_plain, _, _ = _TRAIN_KERNELS[n_dirs]
    hs, cs, acts = (fwd if use_kernel else fwd_plain)(xp, wh, c0, h0,
                                                      tanh_cand)
    ctx.save_for_backward(wh, c0, h0, hs, cs, acts)
    ctx.n_dirs = n_dirs
    ctx.tanh_cand = tanh_cand
    ctx.use_kernel = use_kernel
    return hs


def _scan_backward(ctx, d_hs):
    wh, c0, h0, hs, cs, acts = ctx.saved_tensors
    _, _, bwd, bwd_plain = _TRAIN_KERNELS[ctx.n_dirs]
    c_prev = torch.cat([c0[None], cs[:-1]])
    h_prev = torch.cat([h0[None], hs[:-1]])
    # d_hs may arrive through a transpose and a flip of hs
    dxp, dc0, dh0 = (bwd if ctx.use_kernel else bwd_plain)(
        d_hs.contiguous(), acts, cs, c_prev, wh, ctx.tanh_cand)
    hdim = hs.shape[-1]
    if ctx.n_dirs == 1:                    # 'tbh,tbg->hg'
        dwh = torch.mm(h_prev.float().reshape(-1, hdim).t(),
                       dxp.float().reshape(-1, 4 * hdim))
    else:                                  # 'tdbh,tdbg->dhg'
        t, _, b, _ = hs.shape
        dwh = torch.bmm(
            h_prev.float().permute(1, 3, 0, 2).reshape(2, hdim, t * b),
            dxp.float().permute(1, 0, 2, 3).reshape(2, t * b, 4 * hdim))
    return dxp, dwh.to(wh.dtype), dc0, dh0, None, None


class BiLstmScan(torch.autograd.Function):
    """Differentiable fused BiLSTM scan: the counterpart of ``_make_scan(2)``
    (lstm.py:309-338).

    ``BiLstmScan.apply(xp, wh, c0, h0, tanh_cand, use_kernel) -> hs``.  The
    forward runs kernel 2 (or its plain version when ``use_kernel`` is
    false) and keeps its residuals; the backward runs kernel 3 (or its
    plain version) and computes dWh = sum_t h_{t-1}^T dxp[t] as one bulk
    matmul over all timesteps, outside the kernel, as the JAX package does.
    Callers that need no gradient call ``bilstm_scan`` (kernel B)."""

    @staticmethod
    def forward(ctx, xp, wh, c0, h0, tanh_cand: bool, use_kernel: bool):
        return _scan_forward(ctx, 2, xp, wh, c0, h0, tanh_cand, use_kernel)

    @staticmethod
    def backward(ctx, d_hs):
        return _scan_backward(ctx, d_hs)


class LstmScan(torch.autograd.Function):
    """``BiLstmScan`` on one direction, the counterpart of
    ``_make_scan(1)`` (``lstm_scan_pallas``): xp [T, B, 4H], wh [H, 4H],
    c0/h0 [B, H] -> hs [T, B, H]; dWh is one matmul, 'tbh,tbg->hg'.
    Callers that need no gradient call ``lstm_scan``."""

    @staticmethod
    def forward(ctx, xp, wh, c0, h0, tanh_cand: bool, use_kernel: bool):
        return _scan_forward(ctx, 1, xp, wh, c0, h0, tanh_cand, use_kernel)

    @staticmethod
    def backward(ctx, d_hs):
        return _scan_backward(ctx, d_hs)
