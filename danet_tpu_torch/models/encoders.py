"""Encoders: ``toy``, ``lstm-orig``, ``bilstm-orig``, ``gru-v1``,
``attn-v1``, ``tcn-v1``, ``dprnn-v1``, ``conv-bilstm-v1`` and the LSTM
output head.

Counterpart of ``danet_tpu/models/encoders.py:25-41,67-147,176-249,
313-520,672-725,744-879,910-1091,1141-1251``: the dense paths (no
pipeline, sequence or tensor parallelism, no streaming hooks).
``bilstm-orig`` drops out after every layer in training, ``attn-v1``
after every block's MLP, ``tcn-v1`` after every block, ``dprnn-v1``
after each path of a block and ``conv-bilstm-v1`` after each BiLSTM;
``lstm-orig`` and ``gru-v1`` do not, because their JAX ``apply`` ignores
``train``.  REMAT rematerialises the layers of ``lstm-orig`` and
``bilstm-orig`` and the blocks of ``tcn-v1`` and ``dprnn-v1`` in the
backward (``_maybe_remat``), where JAX's dense paths call
``_maybe_remat``.  ``HDIM`` and ``N_LAYERS`` are class attributes of the
recurrent encoders, as in the JAX package, so tests can narrow both
packages the same way; ``attn-v1``, ``tcn-v1`` and ``dprnn-v1`` read
their widths from their keys.
"""
from __future__ import annotations

from math import sqrt

import numpy as np
import torch
import torch.utils.checkpoint

from danet_tpu_torch.hparams import hparams
from danet_tpu_torch.models.base import Encoder
from danet_tpu_torch.ops import nn, rnn
from danet_tpu_torch.ops.cuda import attention


def _candidate_activation(hp) -> str:
    """'linear' reproduces the reference's no-tanh candidate cell
    (LSTM_LEGACY_CELL); the default is 'tanh'."""
    return "linear" if getattr(hp, "LSTM_LEGACY_CELL", False) else "tanh"


def _backend(hp) -> str:
    """LSTM_BACKEND: 'auto' and 'pallas' take the hand kernels on CUDA."""
    return getattr(hp, "LSTM_BACKEND", "auto") or "auto"


def _centered(log_spectra):
    return log_spectra - torch.mean(log_spectra, dim=(1, 2), keepdim=True)


def _maybe_remat(hp, fn):
    """REMAT=true: ``fn`` under ``torch.utils.checkpoint`` whenever
    autograd records, so that its activations are recomputed in the
    backward instead of stored.  Non-reentrant, so that the recompute
    runs the same (saving) kernels as the first forward: a REMAT step
    launches each layer's saving forward twice and its backward once,
    also in the K-step CUDA graph.  No RNG state is kept, because no
    region reads a default generator: dropout stays outside the region,
    or its masks are drawn before it and passed in."""
    if not bool(getattr(hp, "REMAT", False)):
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return run


def _int_key(hp, key: str, default: int) -> int:
    """An integer width key, ``default`` when absent or null."""
    v = getattr(hp, key, None)
    return default if v is None else int(v)


@hparams.register_encoder("toy")
class ToyEncoder(Encoder):
    """3-layer MLP for debugging (the default.json encoder)."""

    def init(self, generator, device=None):
        hp = self.hp
        return {
            "linear0": nn.linear_init(generator, hp.FEATURE_SIZE,
                                      hp.FFT_SIZE * 2, device=device),
            "linear1": nn.linear_init(generator, hp.FFT_SIZE * 2,
                                      hp.FEATURE_SIZE * hp.EMBED_SIZE,
                                      device=device),
        }

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None):
        hp = self.hp
        b, t = log_spectra.shape[0], log_spectra.shape[1]
        mid = nn.leaky_relu(nn.linear_apply(params["linear0"], log_spectra),
                            hp.RELU_LEAKAGE)
        if tap:
            tap("mid_act", mid)
        out = nn.linear_apply(params["linear1"], mid)
        return out.reshape(b, t, hp.FEATURE_SIZE, hp.EMBED_SIZE)


class _LstmHead:
    """Output head: mean-center + bias-free linear to F*E + reshape."""

    @staticmethod
    def init(generator, hp, in_dim, device=None):
        return nn.linear_init(generator, in_dim,
                              hp.FEATURE_SIZE * hp.EMBED_SIZE,
                              w_scale=1.85, bias=False, device=device)

    @staticmethod
    def apply(params, hp, x):
        x = x - torch.mean(x, dim=(1, 2), keepdim=True)
        out = nn.linear_apply(params, x)
        return out.reshape(x.shape[0], x.shape[1], hp.FEATURE_SIZE,
                           hp.EMBED_SIZE)


@hparams.register_encoder("lstm-orig")
class LstmEncoder(Encoder):
    """4x unidirectional LSTM, 600 units (reference modules.py:140-196)."""

    HDIM = 600
    N_LAYERS = 4

    def init(self, generator, device=None):
        hp = self.hp
        w_scale = 1.15 / sqrt(self.HDIM)
        gate_bias = (0.0, 1.5, -1.0, 1.0)
        params = {}
        in_dim = hp.FEATURE_SIZE
        for i in range(self.N_LAYERS):
            params[f"lstm{i}"] = rnn.lstm_init(
                generator, in_dim, self.HDIM, w_scale, gate_bias, device)
            in_dim = self.HDIM
        params["output"] = _LstmHead.init(generator, hp, in_dim, device)
        return params

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None):
        """[B, T, F] -> [B, T, F, E]; no dropout (``train`` is ignored);
        taps ``lstm<i>_h``."""
        hp = self.hp
        act = _candidate_activation(hp)
        layer = _maybe_remat(hp, lambda p, v: rnn.lstm_apply(
            p, v, act, backend=_backend(hp)))
        x = _centered(log_spectra)
        for i in range(self.N_LAYERS):
            x = layer(params[f"lstm{i}"], x)
            if tap:
                tap("lstm%d_h" % i, x)
        return _LstmHead.apply(params["output"], hp, x)


@hparams.register_encoder("bilstm-orig")
class BiLstmEncoder(Encoder):
    """4x BiLSTM, 300 units per direction -- the paper architecture."""

    HDIM = 300
    N_LAYERS = 4

    def init(self, generator, device=None):
        hp = self.hp
        w_scale = 0.75 / sqrt(self.HDIM)
        gate_bias = (0.0, 1.5, -1.0, 1.0)
        params = {}
        in_dim = hp.FEATURE_SIZE
        for i in range(self.N_LAYERS):
            params[f"lstm{i}"] = rnn.bilstm_init(
                generator, in_dim, self.HDIM, w_scale, gate_bias, device)
            in_dim = self.HDIM * 2
        params["output"] = _LstmHead.init(generator, hp, in_dim, device)
        return params

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None):
        """[B, T, F] -> [B, T, F, E]; with ``train``, inverted dropout at
        DROPOUT_KEEP_PROB after every layer, drawn from ``generator``;
        taps ``lstm<i>_h``."""
        hp = self.hp
        act = _candidate_activation(hp)
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        # the dropout that ends each layer stays outside the region
        layer = _maybe_remat(hp, lambda p, v: rnn.bilstm_apply(
            p, v, act, backend=_backend(hp)))
        x = _centered(log_spectra)
        for i in range(self.N_LAYERS):
            x = layer(params[f"lstm{i}"], x)
            if generator is not None:
                x = nn.dropout(generator, x, keep)
            if tap:
                tap("lstm%d_h" % i, x)
        return _LstmHead.apply(params["output"], hp, x)


@hparams.register_encoder("gru-v1")
class GruEncoder(Encoder):
    """4x unidirectional GRU, 600 units; the same centering and head as
    the LSTM encoders.  The dense path only: MESH_SEQ's sequence-parallel
    GRU stack is not ported (``DaNet._check_parallel_support`` refuses
    it)."""

    HDIM = 600
    N_LAYERS = 4

    def init(self, generator, device=None):
        hp = self.hp
        w_scale = 0.1 / sqrt(self.HDIM)  # reference main.py:175
        params = {}
        in_dim = hp.FEATURE_SIZE
        for i in range(self.N_LAYERS):
            params[f"gru{i}"] = rnn.gru_init(generator, in_dim, self.HDIM,
                                             w_scale, device)
            in_dim = self.HDIM
        params["output"] = _LstmHead.init(generator, hp, in_dim, device)
        return params

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None):
        """[B, T, F] -> [B, T, F, E]; no dropout (``train`` is ignored);
        taps ``gru<i>_h``."""
        hp = self.hp
        x = _centered(log_spectra)
        for i in range(self.N_LAYERS):
            x = rnn.gru_apply(params[f"gru{i}"], x, backend=_backend(hp))
            if tap:
                tap("gru%d_h" % i, x)
        return _LstmHead.apply(params["output"], hp, x)


def _posenc_denominators(d: int) -> np.ndarray:
    """10000 ** (2 i / d) for i < d / 2, float64: the sinusoidal positions'
    wavelengths over 2 pi."""
    return 10000.0 ** (2 * np.arange(d // 2) / d)


@hparams.register_encoder("attn-v1")
class AttentionEncoder(Encoder):
    """Pre-LN transformer encoder over frames (not in the reference).

    ATTN_DIM, ATTN_HEADS, ATTN_LAYERS, ATTN_MLP_MULT set the widths;
    ATTN_BACKEND picks the attention: 'flash' the flash kernels
    (``ops/cuda/attention.py``, T a multiple of 128), 'auto' and 'xla' the
    dense attention in plain PyTorch.  ATTN_CAUSAL (banded attention and
    the streaming hooks) is not ported and raises NotImplementedError;
    MESH_SEQ > 1 (sequence-parallel attention) is refused by
    ``DaNet._check_parallel_support``."""

    def _dims(self):
        hp = self.hp
        d = _int_key(hp, "ATTN_DIM", 256)
        heads = _int_key(hp, "ATTN_HEADS", 4)
        if d % 2 != 0:
            raise ValueError("ATTN_DIM must be even (got %d)" % d)
        if d % heads != 0:
            raise ValueError(
                "ATTN_DIM (%d) must divide by ATTN_HEADS (%d)" % (d, heads))
        return (d, heads, _int_key(hp, "ATTN_LAYERS", 4),
                _int_key(hp, "ATTN_MLP_MULT", 4))

    def init(self, generator, device=None):
        hp = self.hp
        d, _, n_layers, mlp = self._dims()
        params = {
            "embed": nn.linear_init(generator, hp.FEATURE_SIZE, d,
                                    device=device),
            "output": nn.linear_init(generator, d,
                                     hp.FEATURE_SIZE * hp.EMBED_SIZE,
                                     bias=False, device=device),
        }
        for i in range(n_layers):
            params[f"block{i}"] = {
                "qkv": nn.linear_init(generator, d, 3 * d, device=device),
                "proj": nn.linear_init(generator, d, d, device=device),
                "ln1": {"g": torch.ones(d, device=device),
                        "b": torch.zeros(d, device=device)},
                "ln2": {"g": torch.ones(d, device=device),
                        "b": torch.zeros(d, device=device)},
                "mlp_in": nn.linear_init(generator, d, mlp * d,
                                         device=device),
                "mlp_out": nn.linear_init(generator, mlp * d, d,
                                          device=device),
            }
        return params

    @staticmethod
    def _posenc(t, d, dtype, device):
        """Sinusoidal positions [t, d] in ``dtype``: angles and sines in
        float64 on ``device``, rounded to float32 first, as the JAX
        package's numpy table.  Built on each call (it depends on t); only
        the wavelengths are cached."""
        den = nn.device_constant(("posenc-denominators", d),
                                 lambda: _posenc_denominators(d), device)
        ang = torch.arange(t, dtype=torch.float64, device=device)[:, None] \
            / den[None, :]
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return pe.float().to(dtype)

    @staticmethod
    def _dense_attention(q, k, v, key_mask):
        """Full masked multi-head attention: q, k, v [B, T, H, D], key_mask
        [B, T] bool -> [B, T, H, D].  Logits in q's dtype, masked keys at
        -1e9 and the softmax in float32, as XLA runs the JAX package's."""
        hd = q.shape[-1]
        logits = nn.ee("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
            torch.full((), hd, dtype=q.dtype, device=q.device))
        logits = torch.where(key_mask[:, None, None, :], logits.float(),
                             torch.full((), -1e9, dtype=torch.float32,
                                        device=q.device))
        attn = torch.softmax(logits, dim=-1).to(q.dtype)
        return nn.ee("bhqk,bkhd->bqhd", attn, v)

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None):
        """[B, T, F] -> [B, T, F, E]; with ``train``, inverted dropout at
        DROPOUT_KEEP_PROB on every block's MLP output, drawn from
        ``generator``; taps ``block<i>_h``."""
        hp = self.hp
        if bool(getattr(hp, "ATTN_CAUSAL", False)):
            raise NotImplementedError(
                "ATTN_CAUSAL (banded attention, streaming) is not ported")
        d, heads, n_layers, _ = self._dims()
        b, t = log_spectra.shape[0], log_spectra.shape[1]
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        drop = generator is not None and keep < 1.0
        attn_fn = attention.resolve_attn_fn(hp, t, self._dense_attention)

        # zero-padded frames have exactly zero spectra: they are no keys,
        # and they do not shift the mean of the real frames
        key_mask = torch.any(log_spectra != 0.0, dim=-1)       # [B, T]
        mcount = torch.sum(key_mask, dim=1)[:, None, None]
        # JAX's weakly typed float32 denominator takes the spectra's dtype
        den = (mcount * log_spectra.shape[-1] + 1e-6).to(log_spectra.dtype)
        mu = torch.sum(log_spectra * key_mask[..., None], dim=(1, 2),
                       keepdim=True) / den
        x = (log_spectra - mu) * key_mask[..., None].to(log_spectra.dtype)
        h = nn.linear_apply(params["embed"], x)
        h = h + self._posenc(t, d, h.dtype, h.device)
        for i in range(n_layers):
            p = params[f"block{i}"]
            y = nn.layer_norm(p["ln1"], h)
            qkv = nn.linear_apply(p["qkv"], y).reshape(b, t, 3, heads,
                                                       d // heads)
            o = attn_fn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], key_mask)
            h = h + nn.linear_apply(p["proj"], o.reshape(b, t, d))
            y = nn.layer_norm(p["ln2"], h)
            y = nn.linear_apply(p["mlp_out"],
                                nn.gelu(nn.linear_apply(p["mlp_in"], y)))
            if drop:
                y = nn.dropout(generator, y, keep)
            h = h + y
            if tap:
                tap("block%d_h" % i, h)
        out = nn.linear_apply(params["output"], h)
        return out.reshape(b, t, hp.FEATURE_SIZE, hp.EMBED_SIZE)


@hparams.register_encoder("tcn-v1")
class TcnEncoder(Encoder):
    """Temporal convolutional encoder (Conv-TasNet's TCN as a DaNet
    embedding encoder): the bottleneck linear F -> D, then TCN_BLOCKS x
    TCN_REPEATS residual blocks of dilation 2 ** (i % TCN_BLOCKS), each
    layer norm -> linear D -> H -> leaky ReLU -> depthwise conv over T ->
    layer norm -> leaky ReLU -> linear H -> D, plus the residual; then the
    LSTM head.  TCN_CAUSAL left-pads the convolutions (the offline path;
    the streaming hooks are not ported).  Widths: TCN_DIM, TCN_HIDDEN,
    TCN_KERNEL."""

    def _dims(self):
        hp = self.hp
        return (_int_key(hp, "TCN_DIM", 256), _int_key(hp, "TCN_HIDDEN", 512),
                _int_key(hp, "TCN_KERNEL", 3), _int_key(hp, "TCN_BLOCKS", 4),
                _int_key(hp, "TCN_REPEATS", 3),
                bool(getattr(hp, "TCN_CAUSAL", False)))

    def _n_blocks(self) -> int:
        _, _, _, x_blocks, repeats, _ = self._dims()
        return x_blocks * repeats

    def _dilation(self, i: int) -> int:
        return 2 ** (i % self._dims()[3])

    def init(self, generator, device=None):
        hp = self.hp
        d, h, k, _, _, _ = self._dims()
        params = {
            "bottleneck": nn.linear_init(generator, hp.FEATURE_SIZE, d,
                                         device=device),
            "output": _LstmHead.init(generator, hp, d, device),
        }
        for i in range(self._n_blocks()):
            params[f"block{i}"] = {
                "ln1": {"g": torch.ones(d, device=device),
                        "b": torch.zeros(d, device=device)},
                "in": nn.linear_init(generator, d, h, device=device),
                "dconv": nn.conv1d_depthwise_init(generator, h, k,
                                                  device=device),
                "ln2": {"g": torch.ones(h, device=device),
                        "b": torch.zeros(h, device=device)},
                "out": nn.linear_init(generator, h, d, device=device),
            }
        return params

    @staticmethod
    def _block(blk, h_seq, dilation: int, causal: bool, alpha: float):
        """One residual block over [B, T, D]."""
        y = nn.layer_norm(blk["ln1"], h_seq)
        y = nn.leaky_relu(nn.linear_apply(blk["in"], y), alpha)
        y = nn.conv1d_depthwise_apply(blk["dconv"], y, dilation=dilation,
                                      causal=causal)
        y = nn.leaky_relu(nn.layer_norm(blk["ln2"], y), alpha)
        return h_seq + nn.linear_apply(blk["out"], y)

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None):
        """[B, T, F] -> [B, T, F, E]; with ``train``, inverted dropout at
        DROPOUT_KEEP_PROB after every block, drawn from ``generator`` in
        block order; taps ``block<i>_h``."""
        hp = self.hp
        causal = self._dims()[5]
        alpha = hp.RELU_LEAKAGE
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        h = nn.linear_apply(params["bottleneck"], _centered(log_spectra))
        # the recompute runs in the backward, after this loop: each
        # block's dilation is bound now
        layer = _maybe_remat(hp, lambda p, v, dilation: self._block(
            p, v, dilation, causal, alpha))
        for i in range(self._n_blocks()):
            h = layer(params[f"block{i}"], h, self._dilation(i))
            if generator is not None:
                h = nn.dropout(generator, h, keep)
            if tap:
                tap("block%d_h" % i, h)
        return _LstmHead.apply(params["output"], hp, h)


@hparams.register_encoder("dprnn-v1")
class DprnnEncoder(Encoder):
    """Dual-path RNN encoder (Luo, Chen & Yoshioka, ICASSP 2020) over STFT
    frames: the bottleneck linear F -> D; the frames cut into S chunks of
    P = DPRNN_CHUNK frames at DPRNN_HOP (P // 2 by default); DPRNN_BLOCKS
    blocks, each an intra-chunk BiLSTM over P (batched over B S) and an
    inter-chunk (Bi)LSTM over S (batched over B P), each path followed by
    a linear back to D, a layer norm and the residual; the chunks merged
    by count-normalised overlap-add; the LSTM head.  DPRNN_INTER_CAUSAL
    makes the inter-chunk LSTM one-directional.  Widths: DPRNN_DIM (D),
    DPRNN_HIDDEN (H per direction)."""

    def _dims(self):
        hp = self.hp
        p = _int_key(hp, "DPRNN_CHUNK", 64)
        hop = _int_key(hp, "DPRNN_HOP", max(p // 2, 1))
        if not 1 <= hop <= p:
            raise ValueError(
                "DPRNN_HOP must be in [1, DPRNN_CHUNK]; got hop=%d P=%d"
                % (hop, p))
        return (_int_key(hp, "DPRNN_DIM", 128),
                _int_key(hp, "DPRNN_HIDDEN", 128), p, hop,
                _int_key(hp, "DPRNN_BLOCKS", 4),
                bool(getattr(hp, "DPRNN_INTER_CAUSAL", False)))

    def init(self, generator, device=None):
        hp = self.hp
        d, h, _, _, n_blocks, inter_causal = self._dims()
        gate_bias = (0.0, 0.0, 1.0, 0.0)      # forget-gate bias 1

        def ln():
            return {"g": torch.ones(d, device=device),
                    "b": torch.zeros(d, device=device)}

        params = {
            "bottleneck": nn.linear_init(generator, hp.FEATURE_SIZE, d,
                                         device=device),
            "output": _LstmHead.init(generator, hp, d, device),
        }
        for i in range(n_blocks):
            intra = rnn.bilstm_init(generator, d, h, gate_bias=gate_bias,
                                    device=device)
            intra_proj = nn.linear_init(generator, 2 * h, d, device=device)
            if inter_causal:
                inter = rnn.lstm_init(generator, d, h, gate_bias=gate_bias,
                                      device=device)
            else:
                inter = rnn.bilstm_init(generator, d, h,
                                        gate_bias=gate_bias, device=device)
            params[f"block{i}"] = {
                "intra": intra, "intra_proj": intra_proj, "intra_ln": ln(),
                "inter": inter,
                "inter_proj": nn.linear_init(
                    generator, h if inter_causal else 2 * h, d,
                    device=device),
                "inter_ln": ln(),
            }
        return params

    @staticmethod
    def _segment(x, p: int, hop=None):
        """[B, T, D] -> (chunks [B, S, P, D], (hop, T)): x zero-padded at
        the end to (S - 1) hop + P frames, chunk s its frames s hop ..
        s hop + P - 1; hop P // 2 by default, at most P."""
        t = x.shape[1]
        hop = max(p // 2, 1) if hop is None else min(hop, p)
        n_chunks = max(-(-(t - p) // hop), 0) + 1
        total = (n_chunks - 1) * hop + p
        x = torch.nn.functional.pad(x, (0, 0, 0, total - t))
        return x.unfold(1, p, hop).permute(0, 1, 3, 2), (hop, t)

    @staticmethod
    def _merge(chunks, seg_info):
        """Count-normalised overlap-add of chunks [B, S, P, D] back to
        [B, T, D].  The chunks that do not overlap (s mod m alike, m =
        ceil(P / hop)) are laid end to end as one slab, and the m slabs
        are summed in the order of s mod m: a fixed order, no atomics.
        The count is held in the chunks' dtype, as in the JAX package."""
        hop, t = seg_info
        b, s, p, d = chunks.shape
        total = (s - 1) * hop + p
        m = -(-p // hop)
        acc = None
        for r in range(min(m, s)):
            part = chunks[:, r::m]                       # [B, n, P, D]
            n = part.shape[1]
            slab = torch.nn.functional.pad(part, (0, 0, 0, m * hop - p)) \
                .reshape(b, n * m * hop, d)
            # chunk r + j m starts at frame (r + j m) hop
            slab = torch.nn.functional.pad(
                slab, (0, 0, r * hop, max(total - r * hop - n * m * hop, 0))
            )[:, :total]
            acc = slab if acc is None else acc + slab
        f = torch.arange(total, device=chunks.device)
        first = torch.clamp(torch.div(f - p + hop, hop,
                                      rounding_mode="floor"), min=0)
        last = torch.clamp(torch.div(f, hop, rounding_mode="floor"),
                           max=s - 1)
        cnt = (last - first + 1).to(chunks.dtype)
        return (acc / cnt[None, :, None])[:, :t]

    @staticmethod
    def _block(blk, chunks, inter_causal: bool, backend: str, masks=None,
               keep: float = 1.0):
        """One dual-path block over chunks [B, S, P, D]; ``masks`` the
        intra and inter paths' dropout masks, drawn before the block."""
        b, s, p, d = chunks.shape
        y = rnn.bilstm_apply(blk["intra"], chunks.reshape(b * s, p, d),
                             "tanh", backend=backend)
        y = nn.linear_apply(blk["intra_proj"], y).reshape(b, s, p, d)
        y = nn.layer_norm(blk["intra_ln"], y)
        if masks is not None:
            y = nn.dropout(None, y, keep, masks[0])
        chunks = chunks + y
        y = chunks.transpose(1, 2).reshape(b * p, s, d)
        if inter_causal:
            y = rnn.lstm_apply(blk["inter"], y, "tanh", backend=backend)
        else:
            y = rnn.bilstm_apply(blk["inter"], y, "tanh", backend=backend)
        y = nn.linear_apply(blk["inter_proj"], y)
        y = nn.layer_norm(blk["inter_ln"], y.reshape(b, p, s, d)
                          .transpose(1, 2))
        if masks is not None:
            y = nn.dropout(None, y, keep, masks[1])
        return chunks + y

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None):
        """[B, T, F] -> [B, T, F, E]; with ``train``, inverted dropout at
        DROPOUT_KEEP_PROB on each path's output, the masks drawn from
        ``generator`` before each block, intra then inter; taps
        ``block<i>_chunks``.  With T < DPRNN_CHUNK, one chunk of T frames
        at the default hop."""
        hp = self.hp
        _, _, p, hop, n_blocks, inter_causal = self._dims()
        backend = _backend(hp)
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        drop = generator is not None and keep < 1.0
        h = nn.linear_apply(params["bottleneck"], _centered(log_spectra))
        p_eff = min(p, h.shape[1])
        chunks, seg_info = self._segment(h, p_eff,
                                         hop if p_eff == p else None)
        layer = _maybe_remat(hp, lambda blk, c, masks: self._block(
            blk, c, inter_causal, backend, masks, keep))
        for i in range(n_blocks):
            masks = tuple(nn.dropout_mask(generator, chunks.shape, keep,
                                          chunks.device)
                          for _ in range(2)) if drop else None
            chunks = layer(params[f"block{i}"], chunks, masks)
            if tap:
                tap("block%d_chunks" % i, chunks)
        return _LstmHead.apply(params["output"], hp,
                               self._merge(chunks, seg_info))


@hparams.register_encoder("conv-bilstm-v1")
class ConvBiLstmEncoder(Encoder):
    """CNN + BiLSTM hybrid (the reference's modules.py:263-379): down
    conv8-conv16-pool, conv32-conv16-pool and centering; two BiLSTMs of
    FFT_SIZE units over 2 FFT_SIZE inputs, the residual and re-centering;
    up conv32-conv64, a pixel shuffle x2 in T and F, conv16-conv8; a
    bias-free linear to F E.  T must be a multiple of LENGTH_ALIGN (4),
    and FEATURE_SIZE // 4 == FFT_SIZE // 8."""

    ALIGN = 4   # two 2x2 pools, then a x2 shuffle and the fold of 4

    def init(self, generator, device=None):
        hp = self.hp
        nfft = hp.FFT_SIZE
        gate_bias = (0.0, 1.0, -1.0, 1.0)   # reference modules.py:282-285
        w_scale = 2.0 / sqrt(nfft)
        up_scale = 3e-1                     # reference modules.py:336-338

        def conv(i, o, k, scale=None):
            return nn.conv2d_init(generator, i, o, k, scale, device)

        return {
            "down0a": conv(1, 8, 5), "down0b": conv(8, 16, 5),
            "down1a": conv(16, 32, 3), "down1b": conv(32, 16, 3),
            "lstm0": rnn.bilstm_init(generator, nfft * 2, nfft, w_scale,
                                     gate_bias, device),
            "lstm1": rnn.bilstm_init(generator, nfft * 2, nfft, w_scale,
                                     gate_bias, device),
            "up0a": conv(16, 32, 3, up_scale),
            "up0b": conv(32, 64, 3, up_scale),
            "up1a": conv(16, 16, 5), "up1b": conv(16, 8, 5),
            "output": nn.linear_init(generator, nfft,
                                     hp.FEATURE_SIZE * hp.EMBED_SIZE,
                                     bias=False, device=device),
        }

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None):
        """[B, T, F] -> [B, T, F, E]; with ``train``, inverted dropout at
        DROPOUT_KEEP_PROB after each BiLSTM, drawn from ``generator``;
        taps ``conv_act``, ``lstm_act`` and ``mid4``.  Raises ValueError
        when T is not a multiple of LENGTH_ALIGN (4)."""
        hp = self.hp
        nfft = hp.FFT_SIZE
        alpha = hp.RELU_LEAKAGE
        act = _candidate_activation(hp)
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        b, t = log_spectra.shape[0], log_spectra.shape[1]
        if t % self.ALIGN:
            raise ValueError(
                "conv-bilstm-v1 takes T a multiple of LENGTH_ALIGN (%d); got "
                "T=%d" % (self.ALIGN, t))

        def conv(name, v):
            return nn.leaky_relu(nn.conv2d_apply(params[name], v), alpha)

        x = conv("down0b", conv("down0a", log_spectra[:, None]))
        x = nn.max_pool_2x2(x)                         # [B, 16, T/2, F/2]
        if tap:
            tap("conv_act", x)
        x = nn.max_pool_2x2(conv("down1b", conv("down1a", x)))
        x = x - torch.mean(x, dim=(1, 2, 3), keepdim=True)  # [B, 16, T/4, F/8]
        skip = x
        seq = x.transpose(1, 2).reshape(b, x.shape[2], nfft * 2)
        for name in ("lstm0", "lstm1"):
            seq = rnn.bilstm_apply(params[name], seq, act,
                                   dropout_rng=generator, keep_prob=keep,
                                   backend=_backend(hp))
        if tap:
            tap("lstm_act", seq)
        x = seq.reshape(b, -1, 16, nfft // 8).transpose(1, 2) + skip
        x = x - torch.mean(x, dim=(1, 2, 3), keepdim=True)
        if tap:
            tap("mid4", x)
        x = conv("up0b", conv("up0a", x))              # [B, 64, T/4, F/8]
        t4 = x.shape[2]
        x = x.reshape(b, 16, 2, 2, t4, nfft // 8).permute(0, 1, 4, 2, 5, 3) \
            .reshape(b, 16, t4 * 2, nfft // 4)         # pixel shuffle x2
        x = conv("up1b", conv("up1a", x))              # [B, 8, T/2, F/4]
        x = x.transpose(1, 2).reshape(b, -1, nfft)
        out = nn.linear_apply(params["output"], x)
        return out.reshape(b, -1, hp.FEATURE_SIZE, hp.EMBED_SIZE)
