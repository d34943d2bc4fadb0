"""Small functional layer library: the mixed-precision matmul contract, the
linear layer, layer norm, GELU, leaky ReLU, dropout, and the cache of host
constants on the device.

Counterpart of ``danet_tpu/ops/nn.py:17-80,97-107`` (GELU: ``jax.nn.gelu``).  ``mm``/``ee`` take
operands in the compute dtype, accumulate in float32 and cast the result
back to the first operand's dtype.  Products of bf16 values are exact in float32,
so upcasting the operands and running a float32 product is that contract
exactly.
"""
from __future__ import annotations

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
    for backward."""
    full = (key, str(torch.device(device)), dtype)
    hit = _CONSTANTS.get(full)
    if hit is None:
        with torch.inference_mode(False):
            hit = torch.from_numpy(make()).to(device=device, dtype=dtype)
        _CONSTANTS[full] = hit
    return hit


def uniform_init(generator: torch.Generator, shape, scale: float,
                 device=None, dtype=torch.float32) -> torch.Tensor:
    """U(-scale, scale), drawn on the CPU from ``generator`` (so a seed
    gives the same weights on every device), then moved to ``device``."""
    w = torch.rand(shape, generator=generator, dtype=torch.float64)
    return ((w * 2.0 - 1.0) * scale).to(device=device, dtype=dtype)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul with float32 accumulation, output in ``a``'s dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def ee(subscripts: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Einsum with float32 accumulation, output in ``a``'s dtype."""
    return torch.einsum(subscripts, a.float(), b.float()).to(a.dtype)


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
    float32 and rounded to ``x``'s dtype, as ``jnp.mean``/``jnp.var`` do
    for bfloat16."""
    xf = x.float()
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


def dropout(generator: torch.Generator, x: torch.Tensor,
            keep_prob: float) -> torch.Tensor:
    """Inverted dropout: keep each element with probability ``keep_prob``
    and scale it by 1 / keep_prob.  The mask is drawn from ``generator``
    on the generator's device.  ``keep_prob >= 1`` is the identity."""
    if keep_prob >= 1.0:
        return x
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    keep = u.to(x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))
