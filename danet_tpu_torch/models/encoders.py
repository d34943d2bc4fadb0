"""Encoders: ``toy``, ``lstm-orig``, ``bilstm-orig``, ``gru-v1``,
``attn-v1`` and the LSTM output head.

Counterpart of ``danet_tpu/models/encoders.py:25-34,67-147,176-249,
313-520,672-725``: the dense paths (no pipeline, sequence or tensor
parallelism, no rematerialization, no streaming hooks).  ``bilstm-orig``
drops out after every layer in training and ``attn-v1`` after every
block's MLP; ``lstm-orig`` and ``gru-v1`` do not, because their JAX
``apply`` ignores ``train``.  ``HDIM`` and ``N_LAYERS`` are class
attributes of the recurrent encoders, as in the JAX package, so tests can
narrow both packages the same way; ``attn-v1`` reads its widths from the
ATTN_* keys.
"""
from __future__ import annotations

from math import sqrt

import numpy as np
import torch

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
        x = _centered(log_spectra)
        for i in range(self.N_LAYERS):
            x = rnn.lstm_apply(params[f"lstm{i}"], x, act,
                               backend=_backend(hp))
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
        x = _centered(log_spectra)
        for i in range(self.N_LAYERS):
            x = rnn.bilstm_apply(params[f"lstm{i}"], x, act,
                                 dropout_rng=generator, keep_prob=keep,
                                 backend=_backend(hp))
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

        def get(key, default):
            v = getattr(hp, key, None)
            return default if v is None else int(v)

        d = get("ATTN_DIM", 256)
        heads = get("ATTN_HEADS", 4)
        if d % 2 != 0:
            raise ValueError("ATTN_DIM must be even (got %d)" % d)
        if d % heads != 0:
            raise ValueError(
                "ATTN_DIM (%d) must divide by ATTN_HEADS (%d)" % (d, heads))
        return d, heads, get("ATTN_LAYERS", 4), get("ATTN_MLP_MULT", 4)

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
