"""Encoders: ``toy``, ``lstm-orig``, ``bilstm-orig``, ``gru-v1`` and the
LSTM output head.

Counterpart of ``danet_tpu/models/encoders.py:25-34,67-147,176-249,
672-725``: the dense paths (no pipeline, sequence or tensor parallelism,
no rematerialization, no streaming hooks).  ``bilstm-orig`` drops out after
every layer in training; ``lstm-orig`` and ``gru-v1`` do not, because
their JAX ``apply`` ignores ``train``.  ``HDIM`` and ``N_LAYERS`` are
class attributes, as in the JAX package, so tests can narrow both packages
the same way.
"""
from __future__ import annotations

from math import sqrt

import torch

from danet_tpu_torch.hparams import hparams
from danet_tpu_torch.models.base import Encoder
from danet_tpu_torch.ops import nn, rnn


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

    def apply(self, params, log_spectra, train=False, generator=None):
        hp = self.hp
        b, t = log_spectra.shape[0], log_spectra.shape[1]
        mid = nn.leaky_relu(nn.linear_apply(params["linear0"], log_spectra),
                            hp.RELU_LEAKAGE)
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

    def apply(self, params, log_spectra, train=False, generator=None):
        """[B, T, F] -> [B, T, F, E]; no dropout (``train`` is ignored)."""
        hp = self.hp
        act = _candidate_activation(hp)
        x = _centered(log_spectra)
        for i in range(self.N_LAYERS):
            x = rnn.lstm_apply(params[f"lstm{i}"], x, act,
                               backend=_backend(hp))
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

    def apply(self, params, log_spectra, train=False, generator=None):
        """[B, T, F] -> [B, T, F, E]; with ``train``, inverted dropout at
        DROPOUT_KEEP_PROB after every layer, drawn from ``generator``."""
        hp = self.hp
        act = _candidate_activation(hp)
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        x = _centered(log_spectra)
        for i in range(self.N_LAYERS):
            x = rnn.bilstm_apply(params[f"lstm{i}"], x, act,
                                 dropout_rng=generator, keep_prob=keep,
                                 backend=_backend(hp))
        return _LstmHead.apply(params["output"], hp, x)


@hparams.register_encoder("gru-v1")
class GruEncoder(Encoder):
    """4x unidirectional GRU, 600 units; the same centering and head as
    the LSTM encoders.  The dense path only: MESH_SEQ's sequence-parallel
    GRU stack is not ported."""

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

    def apply(self, params, log_spectra, train=False, generator=None):
        """[B, T, F] -> [B, T, F, E]; no dropout (``train`` is ignored)."""
        hp = self.hp
        x = _centered(log_spectra)
        for i in range(self.N_LAYERS):
            x = rnn.gru_apply(params[f"gru{i}"], x, backend=_backend(hp))
        return _LstmHead.apply(params["output"], hp, x)
