"""Wrappers of the fused LSTM kernels, one launch per layer.

Replaces ``danet_tpu/ops/pallas/lstm.py::bilstm_scan_pallas`` (n_dirs=2)
and ``lstm_scan_pallas`` (n_dirs=1) with their custom VJPs:

  * ``bilstm_scan`` / ``lstm_scan``: kernel B, the lean (inference)
    forward (``_fwd_call`` with ``save=False``); ``lstm_scan`` with
    ``return_state`` also returns the final cell state in float32, the
    kernel's own carry (its C entry ``danet_lstm_scan_state`` takes c0 in
    float32 too), which streaming carries from chunk to chunk;
  * ``bilstm_scan_train``: kernel 2, the forward that also stores the
    residuals ``cs`` and ``acts`` (``save=True``), kernel B's design with
    ``SAVE``; ``lstm_scan_train``: the same on one direction;
  * ``bilstm_scan_bwd`` / ``lstm_scan_bwd``: kernel 3, the reverse-time
    backward (``_bwd_call``);
  * ``lstm_scan_train_state`` / ``lstm_scan_bwd_seeded``: the saving
    forward with the final carry (c0 and c_T float32) and kernel 3 with
    its dc carry seeded by c_T's cotangent, one direction: the final
    carry under autograd (``lstm_apply``'s ``return_state``, which
    sequence parallelism's relay and halo warm-up differentiate; JAX runs
    its XLA scan there, the Pallas kernel having no carry output);
  * ``BiLstmScan`` / ``LstmScan`` / ``LstmScanState``: the autograd
    Functions that tie them together as ``_make_scan`` does with
    ``jax.custom_vjp``.

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
and the same roundings to the storage dtype; float64 for float64 inputs,
which the kernels do not take) for CPU tensors; on any other device it
raises.  ``<wrapper>.launches`` counts the kernel launches.

Row groups.  A direction's hidden units are split over ceil(H / 8)
blocks, each holding its units' slice of Wh, and a block takes its rows in
passes of 32.  A launch has G row groups (grid.z): G copies of those
blocks, each over its own rows, whole passes of them (``group_spans``),
each copy with its own Wh slices and its own exchange.  ``launch_plan``
picks G on the host: 1 for one pass (B <= 32, B=1's tagged words
included) and where one copy of the blocks already fills the card at one
block per SM (bilstm-orig's 76, lstm-orig's 75), else up to one pass per
group, as many copies as the card holds at once (``stacked_cap``: the
SMs times the kernel's blocks per SM, ``blocks_per_sm``, over a
direction's blocks; on an H100 at H=128 with two directions 8 for the
forwards in float32, 4 for kernel 3).  Every row keeps the pass it has
with G = 1, so the outputs are bit for bit those of the G = 1 launch;
``groups=1`` (an internal argument of the wrappers) forces that launch.

A group's shared memory grows with its rows, so a group takes at most a
ceiling of rows (``max_rows``: from the kernel library, by H, dtype and
kind; at H=128 about 5,000 rows for the forwards and 885 for the
backward).  A larger batch is split into launches whose groups stay
within it; the rows are independent, so the split is exact.
"""
from __future__ import annotations

import ctypes
import math

import torch

from danet_tpu_torch.ops.nn import acc_dtype

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PASS = 32     # batch rows per pass of a block (csrc: PASS)
UNITS = 8     # hidden units per block (csrc: UNITS)


def _scan_plain(xp, wh, c0, h0, tanh_cand: bool, save: bool,
                state: bool = False):
    hdim = wh.shape[1]
    dt = xp.dtype
    acc = acc_dtype(xp)                    # float32, or float64 for float64
    whf = wh.to(acc)
    c = c0.to(acc)
    h = h0.to(dt)
    hs, cs, acts = [], [], []
    for t in range(xp.shape[0]):
        act = xp[t].to(acc) + torch.bmm(h.to(acc), whf)   # [2, B, 4H] f32
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
        return (torch.stack(hs), c) if state else torch.stack(hs)
    out = (torch.stack(hs), torch.stack(cs), torch.stack(acts))
    return out + (c,) if state else out


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


def lstm_scan_plain(xp, wh, c0, h0, tanh_cand: bool,
                    return_state: bool = False):
    """Plain version of the one-direction kernel B: xp [T, B, 4H], wh
    [H, 4H], c0/h0 [B, H] -> hs [T, B, H]; with ``return_state``
    (hs, c_T [B, H]), the final cell state in the carry's float32 (float64
    for float64 inputs), c0 taken in any float dtype."""
    out = _scan_plain(xp[:, None], wh[None], c0[None], h0[None], tanh_cand,
                      False, return_state)
    if return_state:
        return out[0][:, 0], out[1][0]
    return out[:, 0]


def lstm_scan_train_plain(xp, wh, c0, h0, tanh_cand: bool):
    """Plain version of the one-direction saving forward: -> (hs, cs
    [T, B, H], acts [T, B, 4H])."""
    out = _scan_plain(xp[:, None], wh[None], c0[None], h0[None], tanh_cand,
                      True)
    return tuple(v[:, 0] for v in out)


def lstm_scan_train_state_plain(xp, wh, c0, h0, tanh_cand: bool):
    """Plain version of the saving forward's state entry: -> (hs, cs,
    acts, c_T [B, H]), c_T in the carry's float32 (float64 for float64
    inputs), c0 taken in any float dtype."""
    hs, cs, acts, c_t = _scan_plain(xp[:, None], wh[None], c0[None],
                                    h0[None], tanh_cand, True, True)
    return hs[:, 0], cs[:, 0], acts[:, 0], c_t[0]


def bilstm_scan_bwd_plain(d_hs, acts, cs, c_prev, wh, tanh_cand: bool,
                          dc_T=None):
    """Plain version of kernel 3: ``_bwd_kernel`` / ``_cell_bwd_step``
    (lstm.py:80-96,144-197) in reverse time.

    d_hs, cs, c_prev [T, 2, B, H], acts [T, 2, B, 4H], wh [2, H, 4H] ->
    (dxp [T, 2, B, 4H], dc0, dh0 [2, B, H]) in d_hs's dtype.  dxp is
    rounded to that dtype before it feeds dh_{t-1} = dxp[t] @ Wh^T.  The dc
    carry starts at ``dc_T`` [2, B, H] (the final cell state's cotangent)
    when given, else at zero."""
    hdim = wh.shape[1]
    dt = d_hs.dtype
    acc = acc_dtype(d_hs)                  # float32, or float64 for float64
    wht = wh.to(acc).transpose(1, 2)                       # [2, 4H, H]
    dc = torch.zeros(cs.shape[1:], dtype=acc, device=cs.device) \
        if dc_T is None else dc_T.to(acc)
    dh = torch.zeros_like(dc)
    dxp = [None] * acts.shape[0]
    for t in range(acts.shape[0] - 1, -1, -1):
        a = acts[t].to(acc)
        cand, i = a[..., :hdim], a[..., hdim:2 * hdim]
        f, o = a[..., 2 * hdim:3 * hdim], a[..., 3 * hdim:]
        tanh_c = torch.tanh(cs[t].to(acc))
        dh_total = d_hs[t].to(acc) + dh
        do_pre = dh_total * tanh_c * o * (1.0 - o)
        dc = dc + dh_total * o * (1.0 - tanh_c * tanh_c)
        dcand = dc * i
        dcand_pre = dcand * (1.0 - cand * cand) if tanh_cand else dcand
        di_pre = dc * cand * i * (1.0 - i)
        df_pre = dc * c_prev[t].to(acc) * f * (1.0 - f)
        dact = torch.cat([dcand_pre, di_pre, df_pre, do_pre], dim=-1).to(dt)
        dxp[t] = dact
        dc = dc * f
        dh = torch.bmm(dact.to(acc), wht)
    return torch.stack(dxp), dc.to(dt), dh.to(dt)


def lstm_scan_bwd_plain(d_hs, acts, cs, c_prev, wh, tanh_cand: bool,
                        dc_T=None):
    """Plain version of the one-direction kernel 3: d_hs, cs, c_prev
    [T, B, H], acts [T, B, 4H], wh [H, 4H] -> (dxp [T, B, 4H], dc0, dh0
    [B, H]); with ``dc_T`` [B, H] the seeded form's."""
    dxp, dc0, dh0 = bilstm_scan_bwd_plain(
        d_hs[:, None], acts[:, None], cs[:, None], c_prev[:, None], wh[None],
        tanh_cand, None if dc_T is None else dc_T[None])
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
    of t at B=1; at B > 1 the blocks' flags, [D, G, ceil(H / 8)] ints (G <=
    ceil(B / 32), so they fit).  The kernel clears what it uses before its
    first step."""
    return torch.empty((2, n_dirs, b, hdim), dtype=torch.int64,
                       device=device)


def group_cap(hdim: int, n_dirs: int, n_sm: int, per_sm: int = 1) -> int:
    """The most row groups of one launch: copies of a direction's blocks
    (ceil(H / 8) x D of them) that the card's ``n_sm`` SMs hold at once,
    ``per_sm`` blocks on each; 1 where one copy already fills the card at
    one block per SM."""
    blocks = -(-hdim // UNITS) * n_dirs
    return 1 if n_sm < 2 * blocks else max(1, n_sm * per_sm // blocks)


def stacked_cap(b: int, hdim: int, n_dirs: int, n_sm: int, rows: int,
                residency) -> int:
    """``group_cap`` for a batch of ``b`` rows, with the blocks per SM
    that ``residency(rows)`` gives at the rows of a group with one block
    per SM (at most the row ceiling ``rows``, when it is at least 1): more
    groups hold fewer rows, so they fit as well."""
    one = group_cap(hdim, n_dirs, n_sm)
    if one == 1 or b <= PASS:
        return 1
    most = group_spans(b, row_groups(b, one))
    g_rows = max(hi - lo for lo, hi in most)
    g_rows = min(g_rows, rows) if rows >= 1 else g_rows
    return group_cap(hdim, n_dirs, n_sm, residency(g_rows))


def row_groups(b: int, cap: int) -> int:
    """G of a launch of ``b`` rows: one pass of 32 rows per group at most,
    ``cap`` groups at most; 1 for a batch of one pass."""
    return max(1, min(-(-b // PASS), cap))


def group_spans(b: int, groups: int) -> list:
    """The rows [lo, hi) of each row group of a launch of ``b`` rows: the
    passes split as evenly as whole passes allow, every group but the last
    a whole number of passes (csrc/common.cuh::row_group)."""
    passes = -(-b // PASS)
    return [(g * passes // groups * PASS,
             min(b, (g + 1) * passes // groups * PASS))
            for g in range(groups)]


_SMS: dict = {}
_RESIDENCY: dict = {}


def blocks_per_sm(device, hdim: int, n_dirs: int, dtype, kind: str,
                  rows: int) -> int:
    """The blocks of a ``kind`` ('lean', 'save' or 'bwd') kernel of
    ``n_dirs`` directions at H = ``hdim`` in ``dtype`` that one SM of
    ``device`` holds at once when its groups hold ``rows`` rows (the
    fewest over the kind's instances), from the kernel library; cached."""
    from danet_tpu_torch.ops.cuda import _build

    lib = _build.library()
    key = (id(lib), str(device), hdim, n_dirs, dtype, kind, rows)
    blocks = _RESIDENCY.get(key)
    if blocks is None:
        bwd = kind == "bwd"
        entry = "danet_lstm_scan_%sblocks_per_sm" % ("bwd_" if bwd else "")
        args = (n_dirs, hdim, rows, _DTYPE_CODES[dtype])
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            status = getattr(lib, entry)(
                *(args if bwd else (int(kind == "save"),) + args),
                ctypes.byref(out))
        _build.check(status, entry)
        blocks = _RESIDENCY[key] = out.value
    return blocks


def _group_cap(device, b: int, hdim: int, n_dirs: int, dtype, kind: str,
               rows: int, groups) -> int:
    """``groups`` when given, else ``stacked_cap`` on ``device``'s SMs and
    the kernel's residency; 1 off the card."""
    if groups is not None:
        return groups
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    n_sm = _SMS.get(device.index)
    if n_sm is None:
        n_sm = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return stacked_cap(b, hdim, n_dirs, n_sm, rows, lambda r: blocks_per_sm(
        device, hdim, n_dirs, dtype, kind, r))


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


def _launch_rows(rows: int, cap: int) -> int:
    """The most rows of one launch whose groups (up to ``cap``) hold at
    most ``rows`` each: whole passes per group."""
    return rows if cap == 1 or rows < PASS else cap * (rows // PASS * PASS)


def _spans(b: int, rows: int) -> list:
    """The rows [lo, hi) of each launch of a batch of ``b``: launches of at
    most ``rows`` rows, as even as can be (one launch when ``rows`` < 1)."""
    if rows < 1 or b <= rows:
        return [(0, b)]
    step = -(-b // math.ceil(b / rows))
    return [(lo, min(b, lo + step)) for lo in range(0, b, step)]


def plan_launches(b: int, rows: int, cap: int) -> list:
    """The launches of a scan of ``b`` rows whose groups hold at most
    ``rows`` rows each (0: no ceiling), at most ``cap`` groups per launch:
    [(lo, hi, G)], the batch's rows [lo, hi) in G row groups, in order."""
    return [(lo, hi, row_groups(hi - lo, cap))
            for lo, hi in _spans(b, _launch_rows(rows, cap))]


def launch_plan(device, b: int, hdim: int, n_dirs: int, dtype, kind: str,
                groups=None) -> list:
    """The launches of a ``kind`` ('lean', 'save' or 'bwd') scan of ``b``
    rows on ``device``: [(rows, G)] in order.  ``groups``: at most that
    many row groups (1: the G = 1 launches), else ``stacked_cap``'s."""
    rows = max_rows(device, hdim, dtype, kind)
    return [(hi - lo, g) for lo, hi, g in plan_launches(
        b, rows, _group_cap(device, b, hdim, n_dirs, dtype, kind, rows,
                            groups))]


def _by_rows(run, rows: int, *batched):
    """``run(*batched)`` over the batch axis (-2) of every tensor in
    ``batched``, in launches of at most ``rows`` rows (as even as can be)
    when the batch exceeds it, the outputs joined on that axis; run once
    as it is otherwise (a ceiling below one row included: the launch then
    reports the kernel's refusal)."""
    spans = _spans(batched[0].shape[-2], rows)
    if len(spans) == 1:
        return run(*batched)
    parts = [run(*[v[..., lo:hi, :].contiguous() for v in batched])
             for lo, hi in spans]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p, dim=-2) for p in zip(*parts))
    return torch.cat(parts, dim=-2)


def _fwd(wrapper, entry: str, n_dirs: int, save: bool, xp, wh, c0, h0,
         tanh_cand, rows=None, state: bool = False, groups=None):
    """Launch a forward kernel, ``wrapper.launches`` counting each launch:
    -> hs, or (hs, cs, acts) when ``save``, or (hs, c_T) when ``state``
    (one direction; c0 and c_T float32), or (hs, cs, acts, c_T) with both.
    Each launch runs in row groups (at most ``groups``, else
    ``stacked_cap``'s); a batch whose groups would hold more than ``rows``
    (``max_rows`` by default) is split across launches, and so is c_T."""
    if state:
        t, b, hdim = _fwd_shapes(xp, wh, h0, h0, n_dirs)
        if c0.dtype != torch.float32 or tuple(c0.shape) != (b, hdim) \
                or c0.device != xp.device or not c0.is_contiguous():
            raise ValueError("c0 must be a contiguous float32 %s on %s, got "
                             "%s %s" % ((b, hdim), xp.device, c0.dtype,
                                        tuple(c0.shape)))
    else:
        t, b, hdim = _fwd_shapes(xp, wh, c0, h0, n_dirs)
    if rows is None:
        rows = max_rows(xp.device, hdim, xp.dtype, "save" if save else "lean")
    cap = _group_cap(xp.device, b, hdim, n_dirs, xp.dtype,
                     "save" if save else "lean", rows, groups)

    def launch(xp, c0, h0):
        b = xp.shape[-2]
        hs = torch.empty((t,) + _dirs(n_dirs, b, hdim), dtype=xp.dtype,
                         device=xp.device)
        outs = (hs,)
        if save:
            outs += (torch.empty_like(hs), torch.empty_like(xp))
        if state:
            outs += (torch.empty(c0.shape, dtype=torch.float32,
                                 device=xp.device),)
        xch = exchange_words(n_dirs, b, hdim, xp.device)
        _launch(entry, entry + " kernel", xp.device, (xp, wh, c0, h0) + outs
                + (xch,), (t, b, hdim, _DTYPE_CODES[xp.dtype],
                           int(bool(tanh_cand)), row_groups(b, cap)))
        wrapper.launches += 1
        return outs if save or state else hs
    return _by_rows(launch, _launch_rows(rows, cap), xp, c0, h0)


def _bwd(wrapper, entry: str, n_dirs: int, d_hs, acts, cs, c_prev, wh,
         tanh_cand, rows=None, dc_T=None, groups=None):
    """Launch a backward kernel, ``wrapper.launches`` counting each launch:
    -> (dxp, dc0, dh0); ``dc_T`` (one direction, float32 [B, H]): the
    seeded entry's seed.  Row groups and the split as ``_fwd``'s; dc_T is
    split with the batch."""
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
    seeds = ()
    if dc_T is not None:
        if n_dirs != 1 or dc_T.dtype != torch.float32 \
                or tuple(dc_T.shape) != (b, hdim) \
                or dc_T.device != acts.device or not dc_T.is_contiguous():
            raise ValueError("dc_T must be a contiguous float32 %s on %s, "
                             "got %s %s" % ((b, hdim), acts.device,
                                            dc_T.dtype, tuple(dc_T.shape)))
        seeds = (dc_T,)
    if rows is None:
        rows = max_rows(acts.device, hdim, acts.dtype, "bwd")
    cap = _group_cap(acts.device, b, hdim, n_dirs, acts.dtype, "bwd", rows,
                     groups)

    def launch(d_hs, acts, cs, c_prev, *seed):
        b = acts.shape[-2]
        dxp = torch.empty_like(acts)
        dc0 = torch.empty(_dirs(n_dirs, b, hdim), dtype=acts.dtype,
                          device=acts.device)
        dh0 = torch.empty_like(dc0)
        _launch(entry, entry + " kernel", acts.device,
                (d_hs, acts, cs, c_prev, wh, dxp, dc0, dh0) + seed,
                (t, b, hdim, _DTYPE_CODES[acts.dtype], int(bool(tanh_cand)),
                 row_groups(b, cap)))
        wrapper.launches += 1
        return dxp, dc0, dh0
    return _by_rows(launch, _launch_rows(rows, cap), d_hs, acts, cs, c_prev,
                    *seeds)


def bilstm_scan(xp: torch.Tensor, wh: torch.Tensor, c0: torch.Tensor,
                h0: torch.Tensor, tanh_cand: bool, *,
                groups=None) -> torch.Tensor:
    """Kernel B, the lean forward (signature of the plain version).
    ``groups``, here and in every wrapper below: at most that many row
    groups per launch (1: the G = 1 launch), else ``stacked_cap``'s."""
    if not _on_cuda(xp, "bilstm_scan"):
        return bilstm_scan_plain(xp, wh, c0, h0, tanh_cand)
    return _fwd(bilstm_scan, "danet_bilstm_scan", 2, False, xp, wh, c0, h0,
                tanh_cand, groups=groups)


def bilstm_scan_train(xp, wh, c0, h0, tanh_cand: bool, *, groups=None):
    """Kernel 2, the forward that stores residuals: -> (hs, cs, acts)."""
    if not _on_cuda(xp, "bilstm_scan_train"):
        return bilstm_scan_train_plain(xp, wh, c0, h0, tanh_cand)
    return _fwd(bilstm_scan_train, "danet_bilstm_scan_train", 2, True, xp,
                wh, c0, h0, tanh_cand, groups=groups)


def bilstm_scan_bwd(d_hs, acts, cs, c_prev, wh, tanh_cand: bool, *,
                    groups=None):
    """Kernel 3, the backward: -> (dxp, dc0, dh0) (signature of the plain
    version)."""
    if not _on_cuda(d_hs, "bilstm_scan_bwd"):
        return bilstm_scan_bwd_plain(d_hs, acts, cs, c_prev, wh, tanh_cand)
    return _bwd(bilstm_scan_bwd, "danet_bilstm_scan_bwd", 2, d_hs, acts, cs,
                c_prev, wh, tanh_cand, groups=groups)


def lstm_scan(xp: torch.Tensor, wh: torch.Tensor, c0: torch.Tensor,
              h0: torch.Tensor, tanh_cand: bool, return_state: bool = False,
              *, groups=None):
    """Kernel B on one direction: xp [T, B, 4H], wh [H, 4H], c0/h0 [B, H]
    -> hs [T, B, H]; with ``return_state`` -> (hs, c_T [B, H] float32), c0
    then float32 (the carry of an earlier call)."""
    if not _on_cuda(xp, "lstm_scan"):
        return lstm_scan_plain(xp, wh, c0, h0, tanh_cand, return_state)
    if return_state:
        return _fwd(lstm_scan, "danet_lstm_scan_state", 1, False, xp, wh,
                    c0, h0, tanh_cand, state=True, groups=groups)
    return _fwd(lstm_scan, "danet_lstm_scan", 1, False, xp, wh, c0, h0,
                tanh_cand, groups=groups)


def lstm_scan_train(xp, wh, c0, h0, tanh_cand: bool, *, groups=None):
    """The saving forward on one direction: -> (hs, cs [T, B, H], acts
    [T, B, 4H])."""
    if not _on_cuda(xp, "lstm_scan_train"):
        return lstm_scan_train_plain(xp, wh, c0, h0, tanh_cand)
    return _fwd(lstm_scan_train, "danet_lstm_scan_train", 1, True, xp, wh,
                c0, h0, tanh_cand, groups=groups)


def lstm_scan_bwd(d_hs, acts, cs, c_prev, wh, tanh_cand: bool, *,
                  groups=None):
    """Kernel 3 on one direction: -> (dxp [T, B, 4H], dc0, dh0 [B, H])."""
    if not _on_cuda(d_hs, "lstm_scan_bwd"):
        return lstm_scan_bwd_plain(d_hs, acts, cs, c_prev, wh, tanh_cand)
    return _bwd(lstm_scan_bwd, "danet_lstm_scan_bwd", 1, d_hs, acts, cs,
                c_prev, wh, tanh_cand, groups=groups)


def lstm_scan_train_state(xp, wh, c0, h0, tanh_cand: bool, *, groups=None):
    """The saving forward's state entry on one direction: c0 [B, H]
    float32 -> (hs, cs [T, B, H], acts [T, B, 4H], c_T [B, H] float32)."""
    if not _on_cuda(xp, "lstm_scan_train_state"):
        return lstm_scan_train_state_plain(xp, wh, c0, h0, tanh_cand)
    return _fwd(lstm_scan_train_state, "danet_lstm_scan_train_state", 1,
                True, xp, wh, c0, h0, tanh_cand, state=True, groups=groups)


def lstm_scan_bwd_seeded(d_hs, acts, cs, c_prev, wh, tanh_cand: bool,
                         dc_T=None, *, groups=None):
    """Kernel 3 on one direction with its dc carry seeded by ``dc_T``
    [B, H] float32 (zeros when None): -> (dxp, dc0, dh0)."""
    if dc_T is None:
        dc_T = torch.zeros(cs.shape[1:], dtype=acc_dtype(cs),
                           device=cs.device)
    if not _on_cuda(d_hs, "lstm_scan_bwd_seeded"):
        return lstm_scan_bwd_plain(d_hs, acts, cs, c_prev, wh, tanh_cand,
                                   dc_T)
    return _bwd(lstm_scan_bwd_seeded, "danet_lstm_scan_bwd_seeded", 1, d_hs,
                acts, cs, c_prev, wh, tanh_cand, dc_T=dc_T, groups=groups)


for _fn in (bilstm_scan, bilstm_scan_train, bilstm_scan_bwd, lstm_scan,
            lstm_scan_train, lstm_scan_bwd, lstm_scan_train_state,
            lstm_scan_bwd_seeded):
    _fn.launches = 0


# (train forward, its plain version, backward, its plain version) by
# direction count
_TRAIN_KERNELS = {
    1: (lstm_scan_train, lstm_scan_train_plain, lstm_scan_bwd,
        lstm_scan_bwd_plain),
    2: (bilstm_scan_train, bilstm_scan_train_plain, bilstm_scan_bwd,
        bilstm_scan_bwd_plain),
}


def _scan_forward(ctx, n_dirs, xp, wh, c0, h0, tanh_cand, use_kernel,
                  state: bool = False):
    """``state``: the one-direction state entry, -> (hs, c_T)."""
    if state:
        out = (lstm_scan_train_state if use_kernel
               else lstm_scan_train_state_plain)(xp, wh, c0, h0, tanh_cand)
    else:
        fwd, fwd_plain, _, _ = _TRAIN_KERNELS[n_dirs]
        out = (fwd if use_kernel else fwd_plain)(xp, wh, c0, h0, tanh_cand)
    hs, cs, acts = out[:3]
    ctx.save_for_backward(wh, c0, h0, hs, cs, acts)
    ctx.n_dirs = n_dirs
    ctx.tanh_cand = tanh_cand
    ctx.use_kernel = use_kernel
    ctx.state = state
    return (hs, out[3]) if state else hs


def _scan_backward(ctx, d_hs, dc_T=None):
    """The backward of ``_scan_forward``; with its ``state``, ``dc_T`` (or
    None, unused c_T) seeds kernel 3's dc carry."""
    wh, c0, h0, hs, cs, acts = ctx.saved_tensors
    _, _, bwd, bwd_plain = _TRAIN_KERNELS[ctx.n_dirs]
    c_prev = torch.cat([c0[None].to(cs.dtype), cs[:-1]])
    h_prev = torch.cat([h0[None], hs[:-1]])
    if d_hs is None:                       # only c_T was used
        d_hs = torch.zeros_like(hs)
    if ctx.state:
        if dc_T is not None:
            dc_T = dc_T.to(acc_dtype(cs)).contiguous()
        dxp, dc0, dh0 = lstm_scan_bwd_seeded(
            d_hs.contiguous(), acts, cs, c_prev, wh, ctx.tanh_cand, dc_T) \
            if ctx.use_kernel else lstm_scan_bwd_plain(
                d_hs.contiguous(), acts, cs, c_prev, wh, ctx.tanh_cand,
                dc_T)
        dc0 = dc0.to(c0.dtype)
    else:
        # d_hs may arrive through a transpose and a flip of hs
        dxp, dc0, dh0 = (bwd if ctx.use_kernel else bwd_plain)(
            d_hs.contiguous(), acts, cs, c_prev, wh, ctx.tanh_cand)
    hdim = hs.shape[-1]
    acc = acc_dtype(dxp)
    if ctx.n_dirs == 1:                    # 'tbh,tbg->hg'
        dwh = torch.mm(h_prev.to(acc).reshape(-1, hdim).t(),
                       dxp.to(acc).reshape(-1, 4 * hdim))
    else:                                  # 'tdbh,tdbg->dhg'
        t, _, b, _ = hs.shape
        dwh = torch.bmm(
            h_prev.to(acc).permute(1, 3, 0, 2).reshape(2, hdim, t * b),
            dxp.to(acc).permute(1, 0, 2, 3).reshape(2, t * b, 4 * hdim))
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


class LstmScanState(torch.autograd.Function):
    """``LstmScan`` with the final carry: c0 [B, H] in float32 (float64
    for float64 inputs) -> (hs [T, B, H], c_T [B, H] float32), the
    forward's state entry (``lstm_scan_train_state``) and kernel 3 seeded
    with c_T's cotangent (``lstm_scan_bwd_seeded``), or their plain
    versions when ``use_kernel`` is false.  h_T is hs[-1]: its cotangent
    arrives in d_hs.  dc0 is returned in c0's dtype (the kernel rounds it
    to the storage type first).  Callers that need no gradient call
    ``lstm_scan(..., return_state=True)``."""

    @staticmethod
    def forward(ctx, xp, wh, c0, h0, tanh_cand: bool, use_kernel: bool):
        ctx.set_materialize_grads(False)
        return _scan_forward(ctx, 1, xp, wh, c0, h0, tanh_cand, use_kernel,
                             state=True)

    @staticmethod
    def backward(ctx, d_hs, dc_T):
        return _scan_backward(ctx, d_hs, dc_T)
