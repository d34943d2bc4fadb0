"""Plain PyTorch reference of the benchmark's DaNet configurations.

Written from the published descriptions, not from the program: DaNet
(Chen, Luo & Mesgarani, arXiv:1707.03634, eqs. 1-9: the log-magnitude
features centred per utterance, the BiLSTM encoder and its bias-free
linear head to T x F x E embeddings, attractors as the mixture-magnitude
weighted means of each source's dominant bins in training, the anchored
attractors of eqs. 6-9 at inference, sigmoid masks, the PIT MSE of the
masked spectra), the dual-path RNN block (Luo, Chen & Yoshioka,
arXiv:1910.06379: chunks of P frames at hop P / 2, an intra-chunk BiLSTM
and an inter-chunk BiLSTM, each with a linear layer, a layer norm and a
residual, then overlap-add), k-means refinement of the attractors, Adam
(Kingma & Ba) after an element clip, and the scipy-convention STFT with
its overlap-add inverse.  Gate order of an LSTM's weights: candidate,
input, forget, output.

Every product runs in ``dt``'s precision (float32 with TF32 off, or
bfloat16 for the precision control) with the recurrent state and the gate
arithmetic in float32; everything after the encoder's head runs in
float32.  Python loops over time, no kernel of any library beyond
PyTorch's own operators.  It imports nothing of the program and takes
only what the benchmark makes: the seed's weights and inputs.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional

import torch

F32 = torch.float32


def exact_float32() -> None:
    """Float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------------
# signal front end
# ---------------------------------------------------------------------------

def window(fft_size: int, device) -> torch.Tensor:
    k = torch.arange(fft_size, dtype=torch.float64)
    w = torch.sqrt(0.5 - 0.5 * torch.cos(2.0 * math.pi * k
                                         / max(fft_size - 1, 1)))
    return w.to(device=device, dtype=F32)


def stft(wav: torch.Tensor, fft_size: int, stride: int) -> torch.Tensor:
    """scipy.signal.stft of [B, L]: fft_size / 2 zeros on both sides, the
    end padded to whole hops, frames at every ``stride``, the window, the
    one-sided DFT scaled by 1 / sum(window).  -> ri [B, T, F, 2]."""
    w = window(fft_size, wav.device)
    half = fft_size // 2
    n = wav.shape[-1] + 2 * half
    extra = (-(n - fft_size)) % stride
    x = torch.nn.functional.pad(wav.to(F32), (half, half + extra))
    frames = x.unfold(-1, fft_size, stride) * w
    z = torch.fft.rfft(frames, dim=-1) / w.sum()
    return torch.stack([z.real, z.imag], dim=-1)


def istft(spec_ri: torch.Tensor, fft_size: int, stride: int) -> torch.Tensor:
    """The reference's inverse of [..., T, F, 2]: the inverse DFT of the
    frames that start before T * stride - fft_size, windowed, overlap-added
    and divided by the overlap-added squared window (1 where that is 0).
    -> [..., T * stride]."""
    t_frames = spec_ri.shape[-3]
    out_len = t_frames * stride
    used = max(0, -(-(out_len - fft_size) // stride))
    w = window(fft_size, spec_ri.device)
    z = torch.complex(spec_ri[..., :used, :, 0].to(F32),
                      spec_ri[..., :used, :, 1].to(F32))
    frames = torch.fft.irfft(z, n=fft_size, dim=-1) * w
    lead = frames.shape[:-2]
    out = frames.new_zeros(lead + (out_len + fft_size,))
    wsum = torch.zeros(out_len + fft_size, dtype=torch.float64,
                       device=spec_ri.device)
    w2 = w.double() ** 2
    for i in range(used):
        out[..., i * stride:i * stride + fft_size] += frames[..., i, :]
        wsum[i * stride:i * stride + fft_size] += w2
    wsum = torch.where(wsum != 0, wsum, torch.ones_like(wsum)).to(F32)
    return (out / wsum)[..., :out_len]


# ---------------------------------------------------------------------------
# the encoders
# ---------------------------------------------------------------------------

def _flip(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Each row's first ``lengths[b]`` frames reversed in time (all of
    them without ``lengths``); frames past a row's length stay."""
    if lengths is None:
        return x.flip(1)
    t = torch.arange(x.shape[1], device=x.device)
    idx = torch.where(t[None] < lengths[:, None],
                      lengths[:, None] - 1 - t[None], t[None])
    return torch.gather(x, 1, idx[..., None].expand(x.shape))


def bilstm(p: dict, x: torch.Tensor, dt, lengths=None) -> torch.Tensor:
    """Bidirectional LSTM over [B, T, I] -> [B, T, 2H] (forward, then
    backward outputs); the backward direction reads each row's frames from
    its own last one."""
    b, t, i = x.shape
    h_dim = p["fwd"]["wh"].shape[0]
    xs = torch.stack([x, _flip(x, lengths)]).to(dt)          # [2, B, T, I]
    wx = torch.stack([p[d]["wx"].reshape(i, 4 * h_dim)
                      for d in ("fwd", "bwd")]).to(dt)
    bias = torch.stack([p[d]["b"].reshape(4 * h_dim)
                        for d in ("fwd", "bwd")]).to(dt)
    wh = torch.stack([p[d]["wh"].reshape(h_dim, 4 * h_dim)
                      for d in ("fwd", "bwd")]).to(dt)
    xp = (torch.matmul(xs.reshape(2, b * t, i), wx).reshape(
        2, b, t, 4 * h_dim) + bias[:, None, None]).to(dt)
    h = torch.zeros((2, b, h_dim), dtype=dt, device=x.device)
    c = torch.zeros((2, b, h_dim), dtype=F32, device=x.device)
    outs = []
    for k in range(t):
        g = xp[:, :, k].to(F32) + torch.bmm(h, wh).to(F32)
        cand = torch.tanh(g[..., :h_dim])
        gi = torch.sigmoid(g[..., h_dim:2 * h_dim])
        gf = torch.sigmoid(g[..., 2 * h_dim:3 * h_dim])
        go = torch.sigmoid(g[..., 3 * h_dim:])
        c = gi * cand + gf * c
        h = (go * torch.tanh(c)).to(dt)
        outs.append(h)
    y = torch.stack(outs, dim=2)                              # [2, B, T, H]
    return torch.cat([y[0], _flip(y[1], lengths)], dim=-1)


def _centre(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """x [B, T, C] minus its mean over the row's (valid) frames and
    channels."""
    if mask is None:
        return x - x.mean(dim=(1, 2), keepdim=True)
    m = mask[..., None].to(x.dtype)
    n = m.sum(dim=(1, 2), keepdim=True) * x.shape[-1]
    return x - (x * m).sum(dim=(1, 2), keepdim=True) / n


def _linear(p: dict, x: torch.Tensor, dt) -> torch.Tensor:
    y = torch.matmul(x.to(dt), p["w"].to(dt))
    return y + p["b"].to(dt) if "b" in p else y


def _layer_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    xf = x.to(F32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-6)
    return (y * p["g"].to(F32) + p["b"].to(F32)).to(x.dtype)


def _head(p: dict, x: torch.Tensor, n_freq: int, dt, mask=None):
    """Centre, then the bias-free linear map to F x E per frame."""
    y = _linear(p, _centre(x, mask), dt)
    return y.reshape(x.shape[0], x.shape[1], n_freq, -1)


def encode(cfg: dict, params: dict, logmag: torch.Tensor, dt,
           lengths=None) -> torch.Tensor:
    """Log-magnitude features [B, T, F] -> embeddings [B, T, F, E] in
    float32; ``lengths`` (frames per row) for a padded batch."""
    enc = params["encoder"]
    n_freq = logmag.shape[-1]
    mask = None if lengths is None else (
        torch.arange(logmag.shape[1], device=logmag.device)[None]
        < lengths[:, None])
    x = _centre(logmag.to(F32), mask).to(dt)
    kind = cfg["ENCODER_TYPE"]
    if kind == "bilstm-orig":
        i = 0
        while "lstm%d" % i in enc:
            x = bilstm(enc["lstm%d" % i], x, dt, lengths)
            i += 1
    elif kind == "dprnn-v1":
        if lengths is not None:
            raise NotImplementedError("dprnn-v1 serves no padded batch here")
        x = _dprnn(cfg, enc, _linear(enc["bottleneck"], x, dt), dt)
    else:
        raise ValueError("no reference for ENCODER_TYPE %r" % kind)
    return _head(enc["output"], x, n_freq, dt, mask).to(F32)


def _dprnn(cfg: dict, enc: dict, h: torch.Tensor, dt) -> torch.Tensor:
    """The dual-path blocks over [B, T, D]: chunks of P frames at hop P/2
    (the end zero-padded to whole chunks), each block intra then inter,
    then the count-normalised overlap-add back to [B, T, D]."""
    b, t, d = h.shape
    p = min(int(cfg["DPRNN_CHUNK"]), t)
    hop = max(p // 2, 1)
    n_chunks = max(-(-(t - p) // hop), 0) + 1
    total = (n_chunks - 1) * hop + p
    hp = torch.nn.functional.pad(h, (0, 0, 0, total - t))
    chunks = torch.stack([hp[:, s * hop:s * hop + p]
                          for s in range(n_chunks)], dim=1)   # [B, S, P, D]
    i = 0
    while "block%d" % i in enc:
        blk = enc["block%d" % i]
        y = bilstm(blk["intra"], chunks.reshape(b * n_chunks, p, d), dt)
        y = _layer_norm(blk["intra_ln"], _linear(
            blk["intra_proj"], y, dt).reshape(b, n_chunks, p, d))
        chunks = chunks + y
        y = chunks.transpose(1, 2).reshape(b * p, n_chunks, d)
        y = _linear(blk["inter_proj"], bilstm(blk["inter"], y, dt), dt)
        y = _layer_norm(blk["inter_ln"],
                        y.reshape(b, p, n_chunks, d).transpose(1, 2))
        chunks = chunks + y
        i += 1
    out = chunks.new_zeros((b, total, d))
    count = torch.zeros(total, dtype=chunks.dtype, device=chunks.device)
    for s in range(n_chunks):
        out[:, s * hop:s * hop + p] += chunks[:, s]
        count[s * hop:s * hop + p] += 1
    return (out / count[None, :, None])[:, :t]


# ---------------------------------------------------------------------------
# attractors, masks, losses
# ---------------------------------------------------------------------------

def features(mix_ri: torch.Tensor, eps: float):
    """(|mix| [B, T, F], log1p |mix|, the unit phasor [B, T, F, 2])."""
    mag = torch.sqrt((mix_ri ** 2).sum(-1))
    return mag, torch.log1p(mag), mix_ri / (mag[..., None] + eps)


def truth_weighted(embed: torch.Tensor, src_pwr: torch.Tensor,
                   mix_pwr: torch.Tensor, eps: float) -> torch.Tensor:
    """Each source's attractor: the mean of the embeddings of the bins it
    dominates, weighted by the mixture magnitude.  -> [B, N, E]."""
    b, n = src_pwr.shape[:2]
    e = embed.reshape(b, -1, embed.shape[-1])
    dom = torch.argmax(src_pwr, dim=1).reshape(b, -1)
    wgt = (dom[..., None] == torch.arange(n, device=e.device)).to(F32) \
        * mix_pwr.reshape(b, -1, 1)                            # [B, K, N]
    return torch.einsum("bkn,bke->bne", wgt, e) / (
        wgt.sum(1)[..., None] + eps)


def anchored(embed: torch.Tensor, anchors: torch.Tensor,
             n_src: int) -> torch.Tensor:
    """Eqs. 6-9: for every N-subset of the anchors, the softmax assignment
    of each bin to the subset's anchors and the assignment-weighted mean
    embeddings; the subset whose most similar pair of distinct attractors
    is least similar wins.  -> [B, N, E]."""
    b = embed.shape[0]
    e = embed.reshape(b, -1, embed.shape[-1])
    combs = torch.tensor(list(itertools.combinations(
        range(anchors.shape[0]), n_src)), device=e.device)
    sets = anchors.to(F32)[combs]                              # [P, N, E]
    assign = torch.softmax(torch.einsum("bke,pne->bpkn", e, sets), dim=-1)
    attr = torch.einsum("bpkn,bke->bpne", assign, e) / assign.sum(
        2)[..., None]
    sim = torch.einsum("bpne,bpme->bpnm", attr, attr)
    eye = torch.eye(n_src, dtype=torch.bool, device=e.device)
    sim = sim.masked_fill(eye, float("-inf")).amax(dim=(-1, -2))
    choice = torch.argmin(sim, dim=1)
    return attr[torch.arange(b, device=e.device), choice]


def kmeans(embed: torch.Tensor, anchors: torch.Tensor, n_src: int,
           mix_pwr: torch.Tensor, n_iter: int, eps: float) -> torch.Tensor:
    """The anchored attractors refined by ``n_iter`` rounds of soft
    k-means: softmax assignment of every bin to the centroids, weighted by
    the mixture magnitude, then the weighted means.  -> [B, N, E]."""
    b = embed.shape[0]
    e = embed.reshape(b, -1, embed.shape[-1])
    w = mix_pwr.reshape(b, -1, 1)
    c = anchored(embed, anchors, n_src)
    for _ in range(n_iter):
        a = torch.softmax(torch.einsum("bke,bne->bkn", e, c), dim=-1) * w
        c = torch.einsum("bkn,bke->bne", a, e) / (a.sum(1)[..., None] + eps)
    return c


def masked_power(embed: torch.Tensor, attractors: torch.Tensor,
                 mix_pwr: torch.Tensor) -> torch.Tensor:
    """Sigmoid masks of the embeddings' dot products with the attractors,
    times the mixture magnitude.  -> [B, N, T, F]."""
    b, t, f = mix_pwr.shape
    e = embed.reshape(b, -1, embed.shape[-1])
    m = torch.sigmoid(torch.einsum("bke,bne->bnk", e, attractors))
    return m.reshape(b, -1, t, f) * mix_pwr[:, None]


def _pit(sq: torch.Tensor) -> torch.Tensor:
    """sq [B, N, N] (target i, estimate j) -> the batch mean of the least
    sum over permutations."""
    n = sq.shape[1]
    perms = list(itertools.permutations(range(n)))
    costs = torch.stack([sum(sq[:, i, p[i]] for i in range(n))
                         for p in perms], dim=1)
    return costs.min(dim=1).values.mean()


def train_loss(cfg: dict, params: dict, src_ri: torch.Tensor, dt
               ) -> torch.Tensor:
    """The training objective on per-source spectra [B, N, T, F, 2]: the
    mixture is their sum; the PIT MSE of the masked reconstructions over
    T x F (truth-weighted attractors), plus ANCHOR_AUX_LOSS times the PIT
    MSE of the magnitudes that the inference attractors (k-means) give."""
    eps = float(cfg["EPS"])
    mix_ri = src_ri.sum(1)
    mix_pwr, logmag, phase = features(mix_ri, eps)
    src_pwr = torch.sqrt((src_ri ** 2).sum(-1))
    embed = encode(cfg, params, logmag, dt)
    attr = truth_weighted(embed, src_pwr, mix_pwr, eps)
    sep_ri = masked_power(embed, attr, mix_pwr)[..., None] * phase[:, None]
    tf = src_ri.shape[2] * src_ri.shape[3]
    sq = ((src_ri[:, :, None] - sep_ri[:, None]) ** 2).sum(
        dim=(3, 4, 5)) / tf
    loss = _pit(sq)
    aux_w = float(cfg.get("ANCHOR_AUX_LOSS") or 0.0)
    if aux_w > 0.0:
        if cfg["INFER_ESTIMATOR_METHOD"] != "kmeans":
            raise ValueError("the reference's auxiliary loss is k-means'")
        attr_inf = kmeans(embed, params["infer_estimator"]["anchors"],
                          src_ri.shape[1], mix_pwr,
                          int(cfg.get("KMEANS_ITER") or 5), eps)
        pwr = masked_power(embed, attr_inf, mix_pwr)
        sq = ((src_pwr[:, :, None] - pwr[:, None]) ** 2).sum(
            dim=(3, 4)) / tf
        loss = loss + aux_w * _pit(sq)
    return loss


def leaves(tree: dict) -> list:
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def leaf_names(tree: dict, prefix: str = "") -> list:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(leaf_names(v, prefix + k + "/"))
        else:
            out.append(prefix + k)
    return out


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) on the clipped gradient
    (each element to +/- ``clip``), over a list of float32 tensors."""

    def __init__(self, params: list, lr: float, clip: float):
        self.lr, self.clip, self.count = lr, clip, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params: list, grads: list) -> None:
        self.count += 1
        c1 = 1.0 - 0.9 ** self.count
        c2 = 1.0 - 0.999 ** self.count
        for p, g, m, v in zip(params, grads, self.m, self.v):
            g = g.clamp(-self.clip, self.clip)
            m.mul_(0.9).add_(0.1 * g)
            v.mul_(0.999).add_(0.001 * g * g)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8))


def train_steps(cfg: dict, params: dict, batches, dt=F32,
                loss_fn=None) -> dict:
    """Adam steps from ``params`` (copied) on each batch of ``batches``
    ([B, N, T, F, 2] ri spectra on the card).  -> {"loss": [per step],
    "m": the first moments, "change": each leaf's change, "params": the
    final weights}; every list aligned with ``leaves(params)``."""
    start = [p.detach().to(F32) for p in leaves(params)]
    work = [p.clone().requires_grad_(True) for p in start]
    tree = _rebuild(params, iter(work))
    opt = Adam(work, float(cfg["LR"]), float(cfg["GRAD_CLIP_THRES"]))
    loss_fn = loss_fn or train_loss
    losses = []
    for batch in batches:
        loss = loss_fn(cfg, tree, batch, dt)
        grads = torch.autograd.grad(loss, work, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(work, grads)]
        opt.step(work, grads)
        losses.append(float(loss.detach()))
    return {"loss": losses, "m": opt.m,
            "change": [w.detach() - s for w, s in zip(work, start)],
            "params": [w.detach() for w in work]}


def _rebuild(tree: dict, it) -> dict:
    return {k: _rebuild(v, it) if isinstance(v, dict) else next(it)
            for k, v in tree.items()}


@torch.no_grad()
def separate(cfg: dict, params: dict, waves: list, dt=F32) -> list:
    """Inference on mixture waveforms of any lengths (one padded batch):
    STFT, features, encoder, anchored attractors, masks, the mixture's
    phase, inverse STFT.  -> per request [N, L] float32 on the card."""
    fft, hop = int(cfg["FFT_SIZE"]), int(cfg["FFT_STRIDE"])
    eps = float(cfg["EPS"])
    n_src = int(cfg["MAX_N_SIGNAL"])
    lens = [int(w.shape[-1]) for w in waves]
    batch = torch.zeros((len(waves), max(lens)), dtype=F32,
                        device=waves[0].device)
    for i, w in enumerate(waves):
        batch[i, :lens[i]] = w
    spec = stft(batch, fft, hop)                              # [B, T, F, 2]
    frames = torch.tensor([_n_frames(n, fft, hop) for n in lens],
                          device=spec.device)
    mix_pwr, logmag, phase = features(spec, eps)
    embed = encode(cfg, params, logmag, dt, lengths=frames)
    out = []
    for i in range(len(waves)):
        t = int(frames[i])
        attr = anchored(embed[i:i + 1, :t],
                        params["infer_estimator"]["anchors"], n_src)
        pwr = masked_power(embed[i:i + 1, :t], attr, mix_pwr[i:i + 1, :t])
        sep = pwr[..., None] * phase[i:i + 1, None, :t]
        out.append(istft(sep[0], fft, hop)[:, :lens[i]])
    return out


def _n_frames(n: int, fft: int, hop: int) -> int:
    """Frames of scipy's STFT of n samples (``stft``'s count)."""
    padded = n + fft
    extra = (-(padded - fft)) % hop
    return (padded + extra - fft) // hop + 1
