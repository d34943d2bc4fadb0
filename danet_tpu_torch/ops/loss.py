"""Losses and metrics: permutation-invariant MSE, batched SNR.

Counterpart of ``danet_tpu/ops/loss.py:20-23,42-123,126-215,218-243``
(``permutations_array``, ``pit_mse_loss`` with its 'gemm' method,
``pit_mse_masked_ri``, ``unpermute``, ``batch_snr``).  The permutation
search is a dense product against a constant one-hot permutation stack;
the cost matrix only picks the permutation and is computed from detached
tensors (JAX's ``stop_gradient``), and the loss of the winning permutation
is recomputed exactly on the differentiable path.
"""
from __future__ import annotations

import itertools
from math import prod

import numpy as np
import torch

SNR_COEFF = 4.342944819  # 10 / ln(10)


def permutations_array(n: int) -> np.ndarray:
    """All permutations of range(n) as an int64 [n!, n] array."""
    return np.asarray(list(itertools.permutations(range(n))), dtype=np.int64)


def _perm_onehot(n: int, device):
    """(perms [P, N] int64, one-hot stack [P, N, N] float32):
    onehot[p, i, perms[p, i]] = 1."""
    perms = permutations_array(n)
    onehot = np.zeros((len(perms), n, n), dtype=np.float32)
    onehot[np.arange(len(perms))[:, None], np.arange(n)[None, :], perms] = 1
    return (torch.from_numpy(perms).to(device),
            torch.from_numpy(onehot).to(device))


def pit_mse_loss(x: torch.Tensor, y: torch.Tensor, complex_ri: bool = False):
    """Permutation-invariant MSE between per-source tensors [B, N, ...].

    Per-(i, j) mean squared error over all non-(B, N) axes, cost of a
    permutation = sum over sources, argmin over the N! permutations, mean
    over the batch.  With ``complex_ri`` the last axis is (real, imag): the
    squared error sums over it and the mean's divisor excludes it.

    Returns (loss, perms [N!, N], perm_idx [B]); ``perms[perm_idx[b], i]``
    is the prediction index matched to target source i."""
    b, n = x.shape[0], x.shape[1]
    perms, onehot = _perm_onehot(n, x.device)
    d_mean = prod(x.shape[2:])
    if complex_ri:
        d_mean //= x.shape[-1]
    xf = x.reshape(b, n, -1)
    yf = y.reshape(b, n, -1)
    xs, ys = xf.detach(), yf.detach()
    xx = torch.sum(xs * xs, dim=-1)                       # [B, N]
    yy = torch.sum(ys * ys, dim=-1)
    xy = torch.einsum("bid,bjd->bij", xs.float(), ys.float())
    cross = (xx[:, :, None] + yy[:, None, :] - 2.0 * xy) / d_mean
    perm_idx = torch.argmin(torch.einsum("bij,pij->bp", cross, onehot), dim=1)
    y_pit = torch.einsum("bnm,bmd->bnd", onehot[perm_idx], yf)
    loss = torch.mean(torch.sum(torch.square(xf - y_pit), dim=(1, 2))
                      / d_mean)
    return loss, perms, perm_idx


def pit_mse_masked_ri(src_ri: torch.Tensor, sep_pwr: torch.Tensor,
                      phase_unit: torch.Tensor, eps: float = 1e-7):
    """PIT complex-MSE of the masked reconstruction ``sep_pwr * phase_unit``
    without materializing it: ||x - m p||^2 = ||x||^2 - 2 m <x, p>
    + m^2 ||p||^2.

    src_ri [B, N, T, F, 2], sep_pwr [B, N, T, F], phase_unit [B, T, F, 2]
    -> (loss, perms, perm_idx, snr [B] in dB), with ``batch_snr``'s
    semantics for the SNR of the un-permuted reconstruction."""
    b, n = src_ri.shape[0], src_ri.shape[1]
    perms, onehot = _perm_onehot(n, src_ri.device)
    d_mean = prod(src_ri.shape[2:-1])                     # T*F
    src_sq = torch.sum(torch.square(src_ri), dim=-1)      # [B, N, T, F]
    s_proj = torch.sum(src_ri * phase_unit[:, None], dim=-1)
    p2 = torch.sum(torch.square(phase_unit), dim=-1)      # [B, T, F]
    m2p = torch.square(sep_pwr) * p2[:, None]             # [B, N, T, F]

    # the cost matrix picks the permutation only: no gradient through it
    sp_s = s_proj.detach().reshape(b, n, -1)
    m_s = sep_pwr.detach().reshape(b, n, -1)
    xx = torch.sum(src_sq.detach(), dim=(2, 3))            # [B, N]
    pp = torch.sum(m2p.detach(), dim=(2, 3))               # [B, N]
    xy = torch.einsum("bid,bjd->bij", sp_s, m_s)
    cost = (xx[:, :, None] + pp[:, None, :] - 2.0 * xy) / d_mean
    perm_idx = torch.argmin(torch.einsum("bij,pij->bp", cost, onehot), dim=1)

    # exact loss of the winning permutation (the differentiable path)
    m_pit = torch.einsum("bnm,bmd->bnd", onehot[perm_idx],
                         sep_pwr.reshape(b, n, -1)).reshape(sep_pwr.shape)
    err = torch.sum(src_sq - 2.0 * m_pit * s_proj
                    + torch.square(m_pit) * p2[:, None], dim=(2, 3))  # [B, N]
    loss = torch.mean(torch.sum(err, dim=1) / d_mean)

    sig_pwr = torch.sum(src_sq, dim=(1, 2, 3)) / (n * d_mean)
    # the expanded form can go epsilon-negative at very high SNR; clamp
    noise_pwr = torch.clamp(torch.sum(err, dim=1), min=0.0) / (n * d_mean)
    snr = SNR_COEFF * (torch.log(sig_pwr + eps) - torch.log(noise_pwr + eps))
    return loss, perms, perm_idx, snr


def unpermute(y: torch.Tensor, perms: torch.Tensor,
              perm_idx: torch.Tensor) -> torch.Tensor:
    """output[b, i] = y[b, perms[perm_idx[b], i]] for y [B, N, ...]."""
    sel = perms[perm_idx]                                 # [B, N]
    sel = sel.reshape(sel.shape + (1,) * (y.dim() - 2)).expand(y.shape)
    return torch.gather(y, 1, sel)


def batch_snr(clear_signal: torch.Tensor, noisy_signal: torch.Tensor,
              eps: float = 1e-7, complex_ri: bool = False) -> torch.Tensor:
    """Batched SNR in dB, zero-mean assumption -> [batch].  With
    ``complex_ri`` the last axis is (real, imag): powers are squared
    magnitudes, and the mean's divisor excludes that axis."""
    noise = clear_signal - noisy_signal
    if complex_ri:
        dims = tuple(range(1, clear_signal.dim() - 1))
        sig_pwr = torch.mean(torch.sum(torch.square(clear_signal), dim=-1),
                             dim=dims)
        noise_pwr = torch.mean(torch.sum(torch.square(noise), dim=-1),
                               dim=dims)
    else:
        if clear_signal.is_complex():
            clear_signal, noise = clear_signal.abs(), noise.abs()
        dims = tuple(range(1, clear_signal.dim()))
        sig_pwr = torch.mean(torch.square(clear_signal), dim=dims)
        noise_pwr = torch.mean(torch.square(noise), dim=dims)
    return SNR_COEFF * (torch.log(sig_pwr + eps) - torch.log(noise_pwr + eps))
