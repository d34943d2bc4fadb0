"""Losses and metrics: permutation-invariant MSE and SI-SNR, batched SNR,
SI-SNR, BSS-eval and the deep-clustering objective.

Counterpart of ``danet_tpu/ops/loss.py:20-528`` (``permutations_array``,
``pit_mse_loss`` with its 'gemm' and 'dense' methods,
``pit_mse_masked_ri``, ``unpermute``, ``batch_snr``, ``si_snr``,
``pit_si_snr_loss``, ``bss_eval_sources``, ``combinations_gather``,
``batch_cross_snr``, ``dc_loss``).  No model calls
``combinations_gather`` or ``batch_cross_snr``: they are public utilities
of the package, as in JAX.  The permutation
search is a dense product against a constant one-hot permutation stack;
in the 'gemm' forms the cost matrix only picks the permutation and is
computed from detached tensors (JAX's ``stop_gradient``), and the loss of
the winning permutation is recomputed exactly on the differentiable path.
"""
from __future__ import annotations

import itertools
from math import prod

import numpy as np
import torch

from danet_tpu_torch.ops.nn import acc_dtype, device_constant

SNR_COEFF = 4.342944819  # 10 / ln(10)


def permutations_array(n: int) -> np.ndarray:
    """All permutations of range(n) as an int64 [n!, n] array."""
    return np.asarray(list(itertools.permutations(range(n))), dtype=np.int64)


def _perm_onehot(n: int, device):
    """(perms [P, N] int64, one-hot stack [P, N, N] float32):
    onehot[p, i, perms[p, i]] = 1."""
    def make_onehot():
        perms = permutations_array(n)
        onehot = np.zeros((len(perms), n, n), dtype=np.float32)
        onehot[np.arange(len(perms))[:, None], np.arange(n)[None, :],
               perms] = 1
        return onehot

    return (device_constant(("perms", n), lambda: permutations_array(n),
                            device),
            device_constant(("perm-onehot", n), make_onehot, device))


def pit_mse_loss(x: torch.Tensor, y: torch.Tensor, complex_ri: bool = False,
                 method: str = "gemm"):
    """Permutation-invariant MSE between per-source tensors [B, N, ...].

    Per-(i, j) mean squared error over all non-(B, N) axes, cost of a
    permutation = sum over sources, argmin over the N! permutations, mean
    over the batch.  With ``complex_ri`` the last axis is (real, imag): the
    squared error sums over it and the mean's divisor excludes it.

    ``method`` 'gemm' takes the cost matrix in Gram form from detached
    tensors and recomputes the winning permutation's loss; any other value
    ('dense') is the literal form, the loss gathered from the [B, N, N]
    matrix of pairwise means (the same value up to float32 summation
    order).

    Returns (loss, perms [N!, N], perm_idx [B]); ``perms[perm_idx[b], i]``
    is the prediction index matched to target source i."""
    b, n = x.shape[0], x.shape[1]
    perms, onehot = _perm_onehot(n, x.device)
    if method != "gemm":
        sq = torch.square(x[:, :, None] - y[:, None])         # [B, N, N, ...]
        if complex_ri:
            sq = torch.sum(sq, dim=-1)
        cross = torch.mean(sq, dim=tuple(range(3, sq.dim())))  # [B, N, N]
        loss_sets = torch.einsum("bij,pij->bp", cross, onehot)
        perm_idx = torch.argmin(loss_sets, dim=1)
        return (torch.mean(torch.gather(loss_sets, 1, perm_idx[:, None])),
                perms, perm_idx)
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


def si_snr(target: torch.Tensor, estimate: torch.Tensor,
           eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SNR in dB over the last axis."""
    target = target - torch.mean(target, dim=-1, keepdim=True)
    estimate = estimate - torch.mean(estimate, dim=-1, keepdim=True)
    dot = torch.sum(target * estimate, dim=-1, keepdim=True)
    t_pwr = torch.sum(torch.square(target), dim=-1, keepdim=True)
    proj = dot / (t_pwr + eps) * target
    noise = estimate - proj
    ratio = (torch.sum(torch.square(proj), dim=-1)
             / (torch.sum(torch.square(noise), dim=-1) + eps))
    return 10.0 * torch.log10(ratio + eps)


def pit_si_snr_loss(target_wav: torch.Tensor, estimate_wav: torch.Tensor,
                    eps: float = 1e-8):
    """Permutation-invariant negative SI-SNR of waveforms [B, N, L].

    The pairwise SI-SNR matrix in Gram form: with zero-mean t_i, e_j and
    d_ij = <t_i, e_j>, ||proj||^2 = d^2 / ||t||^2 and ||noise||^2 =
    ||e||^2 - ||proj||^2, at least 0 (the Gram form can go
    epsilon-negative where the elementwise form cannot).  The permutation
    of the highest mean SI-SNR wins.  -> (loss, perms, perm_idx), with
    ``pit_mse_loss``'s un-permute contract; loss = -mean over the batch of
    the winning permutation's mean SI-SNR (dB)."""
    n = target_wav.shape[1]
    perms, onehot = _perm_onehot(n, target_wav.device)
    t = target_wav - torch.mean(target_wav, dim=-1, keepdim=True)
    e = estimate_wav - torch.mean(estimate_wav, dim=-1, keepdim=True)
    dt = acc_dtype(t, e)
    d = torch.einsum("bil,bjl->bij", t.to(dt), e.to(dt))     # [B, N, N]
    t_pwr = torch.sum(torch.square(t), dim=-1)                # [B, N]
    e_pwr = torch.sum(torch.square(e), dim=-1)
    proj_pwr = torch.square(d) / (t_pwr[:, :, None] + eps)
    # maximum, not clamp: at a tie it passes half the gradient, as JAX's
    noise_pwr = torch.maximum(e_pwr[:, None, :] - proj_pwr,
                              proj_pwr.new_zeros(()))
    cross = 10.0 * torch.log10(proj_pwr / (noise_pwr + eps) + eps)
    score_sets = torch.einsum("bij,pij->bp", cross,
                              onehot.to(cross.dtype)) / n
    perm_idx = torch.argmax(score_sets, dim=1)
    loss = -torch.mean(torch.gather(score_sets, 1, perm_idx[:, None]))
    return loss, perms, perm_idx


def bss_eval_sources(ref: torch.Tensor, est: torch.Tensor,
                     filt_len: int = 512, eps: float = 1e-10,
                     rcond: float = 1e-6) -> dict:
    """BSS-eval SDR / SIR / SAR with a time-invariant distortion filter of
    ``filt_len`` taps (BSS Eval v3 ``bss_eval_sources`` semantics).

    ref, est: [N, T] or a batch [B, N, T] of source-aligned waveforms
    (est[i] estimates ref[i]).  Each estimate is split into s_target, its
    least-squares projection onto its own reference delayed by 0..L-1
    samples; e_interf, the rest of its projection onto all references'
    delays; and e_artif.  The correlations come from one rFFT at the
    smallest power of two >= T + L, the projection coefficients from the
    [N L, N L] block-Toeplitz Gram system (and the per-source [L, L]
    blocks) with the ridge rcond * trace / (N L), and the projections are
    synthesized in the frequency domain.  float32 throughout, as in the
    JAX package.  -> {"sdr", "sir", "sar"}, each [N] (or [B, N]) in dB."""
    if ref.dim() == 2:
        return {k: v[0] for k, v in bss_eval_sources(
            ref[None], est[None], filt_len, eps, rcond).items()}
    b, n, t = ref.shape
    ell = int(filt_len)
    nfft = 1
    while nfft < t + ell:       # linear (non-circular) correlations
        nfft *= 2
    dev = ref.device
    est32 = est.float()
    rf = torch.fft.rfft(ref.float(), nfft, dim=-1)          # [B, N, K]
    ef = torch.fft.rfft(est32, nfft, dim=-1)

    # correlations between references at lags -(L-1)..(L-1), folded
    cc = torch.fft.irfft(torch.conj(rf[:, :, None]) * rf[:, None], nfft,
                         dim=-1)                            # [B, N, N, nfft]
    lags = torch.arange(-(ell - 1), ell, device=dev) % nfft
    cc = cc[..., lags]                                      # [B, N, N, 2L-1]
    # Toeplitz blocks: G[j a, j' b] = cc[j, j', (a - b) + L - 1]
    a_idx = torch.arange(ell, device=dev)
    toep = cc[..., a_idx[:, None] - a_idx[None, :] + ell - 1]  # [B,N,N,L,L]
    gram = toep.permute(0, 1, 3, 2, 4).reshape(b, n * ell, n * ell)

    # c[i, j, a] = sum_t est_i[t] ref_j[t - a]
    ec = torch.fft.irfft(torch.conj(rf[:, None]) * ef[:, :, None], nfft,
                         dim=-1)                            # [B, Ne, Nr, nfft]
    c_all = ec[..., :ell]

    ridge = rcond * torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1) \
        / (n * ell)                                         # [B]
    eye_full = torch.eye(n * ell, dtype=gram.dtype, device=dev)
    h_all = torch.linalg.solve(
        gram + ridge[:, None, None] * eye_full,
        c_all.reshape(b, n, n * ell).transpose(1, 2))       # [B, NL, Ne]
    h_all = h_all.transpose(1, 2).reshape(b, n, n, ell)

    own = torch.arange(n, device=dev)
    gram_own = toep[:, own, own]                            # [B, N, L, L]
    eye_own = torch.eye(ell, dtype=gram.dtype, device=dev)
    c_own = c_all[:, own, own]                              # [B, N, L]
    h_own = torch.linalg.solve(gram_own + ridge[:, None, None, None] * eye_own,
                               c_own[..., None])[..., 0]    # [B, N, L]

    hf_all = torch.fft.rfft(h_all, nfft, dim=-1)            # [B, Ne, Nr, K]
    p_all = torch.fft.irfft(torch.sum(hf_all * rf[:, None], dim=2), nfft,
                            dim=-1)[..., :t + ell - 1]
    hf_own = torch.fft.rfft(h_own, nfft, dim=-1)
    p_own = torch.fft.irfft(hf_own * rf, nfft, dim=-1)[..., :t + ell - 1]

    est_pad = torch.nn.functional.pad(est32, (0, ell - 1))
    s_target, e_interf, e_artif = p_own, p_all - p_own, est_pad - p_all

    def pwr(x):
        return torch.sum(torch.square(x), dim=-1)

    def db(num, den):
        return 10.0 * (torch.log10(num + eps) - torch.log10(den + eps))

    return {"sdr": db(pwr(s_target), pwr(e_interf + e_artif)),
            "sir": db(pwr(s_target), pwr(e_interf)),
            "sar": db(pwr(s_target + e_interf), pwr(e_artif))}


def combinations_gather(data: torch.Tensor,
                        subset_size: int) -> torch.Tensor:
    """All C(total, subset_size) subsets of the rows of ``data``, in
    ``itertools.combinations`` order: [total, ...] -> [C, k, ...]."""
    total = data.shape[0]
    combs = device_constant(
        ("combinations", total, subset_size),
        lambda: np.asarray(list(itertools.combinations(
            range(total), subset_size)), dtype=np.int64), data.device)
    return data[combs]


def batch_cross_snr(clear_signal: torch.Tensor, noisy_signal: torch.Tensor,
                    eps: float = 1e-7,
                    complex_ri: bool = False) -> torch.Tensor:
    """The SNR in dB of every pair of sources, [B, m, n]: entry (b, i, j)
    is ``batch_snr`` of clear source i against noisy source j, over the
    axes after the source axis (with ``complex_ri``, the last one is
    (real, imag) and is summed, not averaged)."""
    xs = clear_signal.unsqueeze(2)                      # [B, m, 1, ...]
    ys = noisy_signal.unsqueeze(1)                      # [B, 1, n, ...]
    noise = xs - ys
    if complex_ri:
        xs, noise = (torch.sum(torch.square(v), dim=-1) for v in (xs, noise))
    else:
        if xs.is_complex():
            xs, noise = xs.abs(), noise.abs()
        xs, noise = torch.square(xs), torch.square(noise)
    # torch.mean over dim=() would reduce every axis; JAX's reduces none
    dims = tuple(range(3, xs.dim()))
    sig_pwr = torch.mean(xs, dim=dims) if dims else xs
    noise_pwr = torch.mean(noise, dim=dims) if dims else noise
    return SNR_COEFF * (torch.log(sig_pwr + eps) - torch.log(noise_pwr + eps))


def dc_loss(embed: torch.Tensor, src_pwr: torch.Tensor,
            weights: torch.Tensor = None, eps: float = 1e-8) -> torch.Tensor:
    """Deep-clustering objective mean_b ||V V^T - Y Y^T||_F^2 / (TF)^2 in
    its low-rank form ||V^T V||^2 - 2 ||V^T Y||^2 + ||Y^T Y||^2.

    embed [B, T, F, E] (row-normalized, in float32), src_pwr [B, N, T, F]
    (the argmax over N labels each bin; a tie, such as a zero-padded bin,
    takes the first source), optional per-bin weights [B, T, F] normalized
    per example to sum to TF, each row of V and Y scaled by sqrt(w)."""
    b, t, f, e = embed.shape
    n = src_pwr.shape[1]
    v = embed.reshape(b, t * f, e).float()
    v = v * torch.rsqrt(torch.sum(torch.square(v), dim=-1, keepdim=True)
                        + eps)
    labels = torch.argmax(src_pwr, dim=1).reshape(b, t * f)
    y = (labels[..., None] == torch.arange(                  # [B, TF, N]
        n, device=labels.device)).float()
    if weights is not None:
        w = weights.reshape(b, t * f).float()
        w = w * (t * f / (torch.sum(w, dim=-1, keepdim=True) + eps))
        sw = torch.sqrt(w)[..., None]
        v = v * sw
        y = y * sw
    vtv = torch.einsum("bte,btd->bed", v, v)
    vty = torch.einsum("bte,btn->ben", v, y)
    yty = torch.einsum("btn,btm->bnm", y, y)
    per_ex = (torch.sum(torch.square(vtv), dim=(1, 2))
              - 2.0 * torch.sum(torch.square(vty), dim=(1, 2))
              + torch.sum(torch.square(yty), dim=(1, 2)))
    return torch.mean(per_ex) / float(t * f) ** 2
