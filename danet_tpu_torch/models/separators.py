"""Separators: dot-product masks (sigmoid / softmax over sources).

Counterpart of ``danet_tpu/models/separators.py``.
"""
from __future__ import annotations

import torch

from danet_tpu_torch.hparams import hparams
from danet_tpu_torch.models.base import Separator
from danet_tpu_torch.ops.nn import ee


class _DotSeparator(Separator):
    def _masks(self, logits):
        raise NotImplementedError()

    def apply(self, params, mix_pwr, attractors, embed_flat):
        b, t, f = mix_pwr.shape
        logits = ee("bke,bne->bkn", embed_flat,
                    attractors.to(embed_flat.dtype))
        masks = self._masks(logits.reshape(b, t, f, -1)).to(mix_pwr.dtype)
        return (mix_pwr[..., None] * masks).permute(0, 3, 1, 2)


@hparams.register_separator("dot-sigmoid-orig")
class DotSeparatorSigmoid(_DotSeparator):
    """Sigmoid masks -- the default."""

    def _masks(self, logits):
        return torch.sigmoid(logits)


@hparams.register_separator("dot-softmax-orig")
class DotSeparatorSoftmax(_DotSeparator):
    """Softmax-over-sources masks."""

    def _masks(self, logits):
        return torch.softmax(logits, dim=-1)
