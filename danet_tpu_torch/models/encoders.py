"""Encoders: ``bilstm-orig`` and its output head.

Counterpart of ``danet_tpu/models/encoders.py:25-34,91-113,176-249``, the
inference path only (no dropout, no pipeline / sequence / tensor
parallelism yet).  ``HDIM`` and ``N_LAYERS`` are class attributes, as in
the JAX package, so tests can narrow both packages the same way.
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

    def apply(self, params, log_spectra):
        hp = self.hp
        act = _candidate_activation(hp)
        backend = getattr(hp, "LSTM_BACKEND", "auto") or "auto"
        x = log_spectra - torch.mean(log_spectra, dim=(1, 2), keepdim=True)
        for i in range(self.N_LAYERS):
            x = rnn.bilstm_apply(params[f"lstm{i}"], x, act, backend)
        return _LstmHead.apply(params["output"], hp, x)
