"""Small functional layer library: the mixed-precision matmul contract, the
linear layer, layer norm, GELU, leaky ReLU, the causal attention band,
dropout, the convolutions and the max pool, the position-wise halves of a
TCN block around its depthwise convolution (tcn-v1's and tasnet-v1's,
dense or on a sequence-parallel chunk), and the cache of host constants
on the device.

Counterpart of ``danet_tpu/ops/nn.py:17-187`` (GELU: ``jax.nn.gelu``).
The convolutions are ATen's (``_Conv``): JAX computes them with
``lax.conv_general_dilated`` and ``reduce_window``, outside any Pallas
kernel.  Their forward and backward run under ``_conv_flags`` whatever
the process has set: float32 without TF32 (PyTorch allows TF32 to cuDNN
by default, and its 10-bit mantissa misses the 1e-4 bar), deterministic
algorithms (a K-step CUDA graph and eager steps sum alike) and
``torch.backends.cudnn.benchmark`` off, so that the algorithm cuDNN
picks at the graph's eager warm-up is the one the capture records.
``mm``/``ee`` take operands in the compute dtype, accumulate in float32
and cast the result back to the first operand's dtype; float64 operands
(a float64 run of the plain path, the reference of ``chip_smoke.py``
phase 22) accumulate in float64, and so do the layer norm and the
depthwise convolution.  Products of bf16
values are exact in float32, so upcasting the operands and running a
float32 product is that contract exactly.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch


_CONSTANTS: dict = {}


def device_constant(key, make, device, dtype=None) -> torch.Tensor:
    """``torch.from_numpy(make())`` on ``device`` (in ``dtype``, if given),
    built at the first call per (key, device, dtype) and cached: later
    calls copy nothing from the host, which a step captured in a CUDA graph
    must not do.  ``key`` names everything ``make`` depends on, never an
    input's length: the cache is never emptied, so a constant of every
    request length would grow it for the life of a server.  Built outside
    inference mode even under it (serving), so that training can save it
    for backward, and outside a ``torch.export`` trace's fake-tensor mode,
    so that the cache holds a real tensor (which the exported program
    keeps as a constant)."""
    full = (key, str(torch.device(device)), dtype)
    hit = _CONSTANTS.get(full)
    if hit is None:
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with torch.inference_mode(False), unset_fake_temporarily():
            hit = torch.from_numpy(make()).to(device=device, dtype=dtype)
        _CONSTANTS[full] = hit
    return hit


def uniform_init(generator: torch.Generator, shape, scale: float,
                 device=None, dtype=torch.float32) -> torch.Tensor:
    """U(-scale, scale), drawn on the CPU from ``generator`` (so a seed
    gives the same weights on every device), then moved to ``device``."""
    w = torch.rand(shape, generator=generator, dtype=torch.float64)
    return ((w * 2.0 - 1.0) * scale).to(device=device, dtype=dtype)


def acc_dtype(*ts: torch.Tensor) -> torch.dtype:
    """The dtype sums of these tensors accumulate in: float32, or float64
    when one of them is float64 (a float64 run of the plain path)."""
    dt = torch.float32
    for t in ts:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul with float32 accumulation (float64 for float64 operands),
    output in ``a``'s dtype."""
    dt = acc_dtype(a, b)
    return torch.matmul(a.to(dt), b.to(dt)).to(a.dtype)


def ee(subscripts: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Einsum with float32 accumulation (float64 for float64 operands),
    output in ``a``'s dtype."""
    dt = acc_dtype(a, b)
    return torch.einsum(subscripts, a.to(dt), b.to(dt)).to(a.dtype)


def linear_init(generator: torch.Generator, idim: int, odim: int,
                w_scale: Optional[float] = None, bias: bool = True,
                device=None) -> dict:
    """Params for y = x @ W + b; glorot-uniform W by default."""
    if w_scale is None:
        w_scale = math.sqrt(6.0 / (idim + odim))
    params = {"w": uniform_init(generator, (idim, odim), w_scale, device)}
    if bias:
        params["b"] = torch.zeros(odim, device=device)
    return params


def linear_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W (+ b) on the last axis, any leading rank."""
    y = mm(x, params["w"].to(x.dtype))
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def layer_norm(params: dict, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis with {'g', 'b'} params: population
    variance, ``rsqrt(var + 1e-6)``.  The mean and variance are taken in
    float32 (float64 for float64 ``x``) and rounded to ``x``'s dtype, as
    ``jnp.mean``/``jnp.var`` do for bfloat16."""
    xf = x.to(acc_dtype(x))
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    xn = (x - mu.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + 1e-6)
    return xn * params["g"].to(x.dtype) + params["b"].to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation (exact GELU
    differs from it by about 1e-3)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def leaky_relu(x: torch.Tensor, alpha: float = 0.0) -> torch.Tensor:
    """max(x * alpha, x); plain ReLU for alpha 0."""
    if alpha == 0.0:
        return torch.relu(x)
    return torch.maximum(x * alpha, x)


def tcn_block_in(blk: dict, h_seq: torch.Tensor,
                 alpha: float) -> torch.Tensor:
    """A TCN block's layer norm -> linear D -> H -> leaky ReLU: its
    depthwise convolution's input."""
    y = layer_norm(blk["ln1"], h_seq)
    return leaky_relu(linear_apply(blk["in"], y), alpha)


def tcn_block_out(blk: dict, h_seq: torch.Tensor, y: torch.Tensor,
                  alpha: float) -> torch.Tensor:
    """A TCN block's convolution output -> layer norm -> leaky ReLU ->
    linear H -> D, plus the residual ``h_seq``."""
    y = leaky_relu(layer_norm(blk["ln2"], y), alpha)
    return h_seq + linear_apply(blk["out"], y)


def causal_band(qpos: torch.Tensor, kpos: torch.Tensor,
                window: int) -> torch.Tensor:
    """The ATTN_CAUSAL band, defined once: True where key position
    ``kpos`` is visible to query position ``qpos``, the query itself and
    the ``window - 1`` positions before it (``kpos <= qpos`` and ``kpos >
    qpos - window``).  The dense and the chunked banded attention
    (``ops/local_attention.py``) both build their masks with it."""
    return (kpos <= qpos) & (kpos > qpos - window)


def dropout_mask(generator: torch.Generator, shape, keep_prob: float,
                 device) -> torch.Tensor:
    """The boolean keep mask of a dropout of a tensor of ``shape`` on
    ``device``: one uniform per element drawn from ``generator`` on the
    generator's device, kept below ``keep_prob``.  Drawn ahead of a
    rematerialised region, it is the mask ``dropout`` would draw there."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u.to(device) < keep_prob


def dropout(generator: Optional[torch.Generator], x: torch.Tensor,
            keep_prob: float, mask: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Inverted dropout: keep each element with probability ``keep_prob``
    and scale it by 1 / keep_prob.  The mask is ``mask``, or drawn from
    ``generator`` (``dropout_mask``).  ``keep_prob >= 1`` is the
    identity."""
    if keep_prob >= 1.0:
        return x
    if mask is None:
        mask = dropout_mask(generator, x.shape, keep_prob, x.device)
    return torch.where(mask, x / keep_prob, torch.zeros_like(x))


def conv2d_init(generator: torch.Generator, in_ch: int, out_ch: int,
                ksize: int, w_scale: Optional[float] = None,
                device=None) -> dict:
    """Params of an NCHW 'SAME' convolution: w [out, in, k, k] (glorot
    uniform by default), b [out] zeros."""
    if w_scale is None:
        w_scale = math.sqrt(6.0 / ((in_ch + out_ch) * ksize * ksize))
    return {"w": uniform_init(generator, (out_ch, in_ch, ksize, ksize),
                              w_scale, device),
            "b": torch.zeros(out_ch, device=device)}


@contextlib.contextmanager
def _conv_flags():
    """cuDNN's settings for the convolutions (module docstring): no TF32,
    deterministic algorithms, benchmark off; restored on exit."""
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark
    cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = \
        False, True, False
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = saved


class _Conv(torch.autograd.Function):
    """A bias-free convolution of stride 1 (``aten.convolution``), its
    forward and its backward (``aten.convolution_backward``, run later by
    autograd) each under ``_conv_flags``."""

    @staticmethod
    def forward(ctx, x, w, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (padding, dilation, groups)
        ones = [1] * len(padding)
        with _conv_flags():
            return torch.ops.aten.convolution(
                x, w, None, ones, padding, dilation, False,
                [0] * len(padding), groups)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        padding, dilation, groups = ctx.conf
        ones = [1] * len(padding)
        with _conv_flags():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                dy, x, w, None, ones, padding, dilation, False,
                [0] * len(padding), groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None


def conv2d_apply(params: dict, x: torch.Tensor,
                 valid_h: bool = False) -> torch.Tensor:
    """NCHW 'SAME' convolution ((k - 1) // 2 zeros before, the rest after).
    The kernel takes the activation's dtype and so does the output, as in
    the JAX package (whose docstring says why); the bias is added after,
    in that dtype.  ``valid_h``: VALID over H, the padding left out there
    (a sequence-parallel chunk that carries its neighbours' halos), SAME
    over W."""
    w = params["w"].to(x.dtype)
    pads = [((k - 1) // 2, k - 1 - (k - 1) // 2) for k in w.shape[2:]]
    if valid_h:
        pads[0] = (0, 0)
    if any(lo != hi for lo, hi in pads):
        x = torch.nn.functional.pad(x, [p for lo_hi in pads[::-1]
                                        for p in lo_hi])
        pads = [(0, 0)] * len(pads)
    y = _Conv.apply(x, w, [lo for lo, _ in pads], [1, 1], 1)
    return y + params["b"].to(x.dtype)[None, :, None, None]


def conv1d_depthwise_init(generator: torch.Generator, channels: int,
                          ksize: int, w_scale: Optional[float] = None,
                          device=None) -> dict:
    """Params of a depthwise 1-D convolution over time: w [C, 1, K]
    (uniform, fan-in = fan-out = K by default), b [C] zeros."""
    if w_scale is None:
        w_scale = math.sqrt(6.0 / (2 * ksize))
    return {"w": uniform_init(generator, (channels, 1, ksize), w_scale,
                              device),
            "b": torch.zeros(channels, device=device)}


def conv1d_depthwise_apply(params: dict, x: torch.Tensor, dilation: int = 1,
                           causal: bool = False,
                           valid: bool = False) -> torch.Tensor:
    """Depthwise dilated convolution over axis 1 of [B, T, C] -> [B, T, C],
    in float32 (float64 for float64 ``x``) and cast back to x's dtype.
    ``causal`` pads (K - 1) dilation zeros on the left; otherwise that
    span splits as (span // 2, span - span // 2).  ``valid`` pads nothing
    (-> [B, T - span, C]: a stream's chunk after its tail)."""
    w = params["w"]
    dt = acc_dtype(x)
    span = (w.shape[-1] - 1) * dilation
    pad = (0, 0) if valid else (span, 0) if causal else (
        span // 2, span - span // 2)
    xt = torch.nn.functional.pad(x.transpose(1, 2).to(dt), pad)
    y = _Conv.apply(xt, w.to(dt), [0], [dilation], w.shape[0])
    y = (y + params["b"].to(dt)[None, :, None]).to(x.dtype)
    return y.transpose(1, 2)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool of stride 2 over the last two axes of NCHW, VALID: an
    odd size floors."""
    return torch.nn.functional.max_pool2d(x, 2, 2)
