"""The work of a step or a request, counted from the cell's shapes, and the
card's published peaks: the yardstick of the MFU and roofline metrics,
whatever implements the work.

Model FLOPs are the forward pass's matrix products (each multiply-add two
operations): the LSTMs' input and recurrent products, the linear layers
and the embedding head; a training step is three times its forward,
nothing recomputed counted.  A scan's bound is the larger of its
recurrent product's operations over the float32 peak and its bytes over
the memory bandwidth, each input read once and each output written once,
as the Bound column of the kernel table in PERF.md.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, bfloat16
# dense on the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
ITEM = {"float32": 4, "bfloat16": 2}


def _lstm_fwd(i: int, h: int, dirs: int) -> float:
    """FLOPs of one frame of one row through an LSTM layer."""
    return 2.0 * dirs * (i + h) * 4 * h


def forward_flops(keys: dict, widths: dict, rows: int, frames: int) -> float:
    """The forward pass's matrix FLOPs over ``rows`` x ``frames``."""
    f = int(keys["FFT_SIZE"]) // 2 + 1
    fe = f * int(keys["EMBED_SIZE"])
    kind = keys["ENCODER_TYPE"]
    if kind == "bilstm-orig":
        h, layers = int(widths["BILSTM_HIDDEN"]), int(widths["BILSTM_LAYERS"])
        per = _lstm_fwd(f, h, 2) + (layers - 1) * _lstm_fwd(2 * h, h, 2) \
            + 2.0 * 2 * h * fe
        return per * rows * frames
    if kind == "dprnn-v1":
        d, h = int(keys["DPRNN_DIM"]), int(keys["DPRNN_HIDDEN"])
        p, s = dprnn_chunks(keys, frames)
        block = 2 * (_lstm_fwd(d, h, 2) + 2.0 * 2 * h * d)   # intra + inter
        return (rows * frames * 2.0 * (f * d + d * fe)
                + int(keys["DPRNN_BLOCKS"]) * block * rows * s * p)
    raise ValueError("no count for ENCODER_TYPE %r" % kind)


def dprnn_chunks(keys: dict, frames: int) -> tuple:
    """(P, S): dprnn-v1's chunk length and chunk count at ``frames``."""
    p = min(int(keys["DPRNN_CHUNK"]), frames)
    hop = max(p // 2, 1)
    return p, max(-(-(frames - p) // hop), 0) + 1


def scans(keys: dict, widths: dict, rows: int, frames: int) -> list:
    """(T, B, H, directions) of every LSTM scan of a forward pass."""
    kind = keys["ENCODER_TYPE"]
    if kind == "bilstm-orig":
        h = int(widths["BILSTM_HIDDEN"])
        return [(frames, rows, h, 2)] * int(widths["BILSTM_LAYERS"])
    if kind == "dprnn-v1":
        h = int(keys["DPRNN_HIDDEN"])
        p, s = dprnn_chunks(keys, frames)
        return [(p, rows * s, h, 2), (s, rows * p, h, 2)] \
            * int(keys["DPRNN_BLOCKS"])
    raise ValueError("no scans for ENCODER_TYPE %r" % kind)


def scan_bound_s(t: int, b: int, h: int, dirs: int, kind: str,
                 dtype: str = "float32") -> float:
    """Least time of one scan launch: ``kind`` 'lean' (kernel B: reads the
    input projections and Wh, writes h), 'save' (kernel 2: also writes c
    and the gate activations) or 'bwd' (kernel 3: reads dh, the
    activations, c and Wh, writes the input projections' gradient)."""
    ops = 2.0 * dirs * t * b * h * 4 * h
    rows = t * dirs * b
    words = {"lean": rows * (4 * h + h),
             "save": rows * (4 * h + h + h + 4 * h),
             "bwd": rows * (h + 4 * h + h + 4 * h)}[kind] + dirs * h * 4 * h
    return max(ops / PEAK_FLOPS[dtype], words * ITEM[dtype] / PEAK_BYTES)


def train_scan_bound_s(keys: dict, widths: dict, rows: int,
                       frames: int) -> float:
    """Least time of a training step's scans: each layer's saving forward
    and backward."""
    dt = keys.get("COMPUTE_DTYPE", "float32")
    return sum(scan_bound_s(t, b, h, d, "save", dt)
               + scan_bound_s(t, b, h, d, "bwd", dt)
               for t, b, h, d in scans(keys, widths, rows, frames))


def infer_scan_bound_s(keys: dict, widths: dict, rows: int,
                       frames: int) -> float:
    """Least time of a forward pass's lean scans."""
    dt = keys.get("COMPUTE_DTYPE", "float32")
    return sum(scan_bound_s(t, b, h, d, "lean", dt)
               for t, b, h, d in scans(keys, widths, rows, frames))


def frames_of(samples: int, fft: int, hop: int) -> int:
    """STFT frames of a request of ``samples`` (scipy's boundary)."""
    padded = samples + fft
    return (padded + (-(padded - fft)) % hop - fft) // hop + 1
