"""Attractor estimators: ``truth-weighted`` and ``anchor``.

Counterpart of ``danet_tpu/models/estimators.py:84-102,185-276``.
``truth-weighted`` is the default train estimator and is here so that
``DaNet`` builds from ``default.json``; ``anchor`` is the inference
estimator of the serving path, with the JAX package's N=2 sigmoid strength
reduction and its eq-8 diagonal exclusion (pairwise similarity between
DISTINCT attractors only).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from danet_tpu_torch.hparams import hparams
from danet_tpu_torch.models.base import Estimator
from danet_tpu_torch.ops.nn import ee


def _hard_assignment(src_pwr: torch.Tensor) -> torch.Tensor:
    """[B, N, T, F] -> one-hot dominant source [B, T*F, N]."""
    b, n = src_pwr.shape[0], src_pwr.shape[1]
    labels = torch.argmax(src_pwr, dim=1)
    onehot = torch.nn.functional.one_hot(labels, n).to(src_pwr.dtype)
    return onehot.reshape(b, -1, n)


@hparams.register_estimator("truth-weighted")
class WeightedAverageEstimator(Estimator):
    """Mixture-magnitude-weighted mean of each source's embeddings."""

    USE_TRUTH = True

    def apply(self, params, embed, src_pwr=None, mix_pwr=None):
        b, e = embed.shape[0], embed.shape[-1]
        embed_flat = embed.reshape(b, -1, e)
        w = mix_pwr.reshape(b, -1, 1).to(embed_flat.dtype)
        wgt = _hard_assignment(src_pwr).to(embed_flat.dtype) * w
        sums = ee("bkn,bke->bne", wgt, embed_flat)
        wsum = torch.sum(wgt, dim=1)[..., None]
        return sums / (wsum + self.hp.EPS)


@hparams.register_estimator("anchor")
class AnchoredEstimator(Estimator):
    """Trainable anchors + softmax assignment + least-similar subset pick
    (DaNet paper eq. 6-9) over the C(NUM_ANCHOR, N) anchor subsets."""

    USE_TRUTH = False

    def init(self, generator, device=None):
        hp = self.hp
        anchors = torch.randn((hp.NUM_ANCHOR, hp.EMBED_SIZE),
                              generator=generator, dtype=torch.float32)
        return {"anchors": anchors.to(device)}

    @staticmethod
    def _attractor_sets_pairs(embed, anchors, combs):
        """N=2: a two-way softmax is a sigmoid of the logit difference, so
        the per-subset assignment never materializes; slot 1 follows by
        sum-complement.  -> [B, P, 2, E]"""
        b, e_dim = embed.shape[0], embed.shape[-1]
        e_flat = embed.reshape(b, -1, e_dim)                 # [B, K, E]
        k = e_flat.shape[1]
        d = ee("bke,ae->bka", e_flat, anchors)               # [B, K, A]
        s = torch.sigmoid(d[..., combs[:, 0]] - d[..., combs[:, 1]])
        num0 = ee("bkp,bke->bpe", s, e_flat)                 # [B, P, E]
        num1 = torch.sum(e_flat, dim=1)[:, None] - num0
        den0 = torch.sum(s.float(), dim=1)                   # [B, P]
        den1 = k - den0
        att0 = num0 / den0[..., None].to(embed.dtype)
        att1 = num1 / den1[..., None].to(embed.dtype)
        return torch.stack([att0, att1], dim=2)

    @staticmethod
    def _attractor_sets_general(embed, anchors, combs):
        """eq (6)-(7) for any N: per-subset softmax.  -> [B, P, N, E]"""
        anchor_sets = anchors[combs]                         # [P, N, E]
        logits = ee("btfe,pce->bptfc", embed, anchor_sets)
        assignment = torch.softmax(logits, dim=-1)
        attractor_sets = ee("bptfc,btfe->bpce", assignment, embed)
        return attractor_sets / torch.sum(
            assignment.float(), dim=(2, 3))[..., None].to(embed.dtype)

    def subset_choice(self, params, embed):
        """(attractor sets [B, P, N, E], chosen subset index [B])."""
        hp = self.hp
        n = hp.MAX_N_SIGNAL
        combs = torch.as_tensor(
            np.asarray(list(itertools.combinations(range(hp.NUM_ANCHOR), n)),
                       dtype=np.int64), device=embed.device)
        anchors = params["anchors"].to(embed.dtype)
        if n == 2:
            sets = self._attractor_sets_pairs(embed, anchors, combs)
        else:
            sets = self._attractor_sets_general(embed, anchors, combs)
        # eq (8): max pairwise similarity between DISTINCT attractors
        sim = ee("bpce,bpde->bpcd", sets, sets).float()
        diag = torch.eye(sim.shape[-1], dtype=torch.bool, device=sim.device)
        sim = sim.masked_fill(diag, float("-inf"))
        in_set_sim = torch.amax(sim, dim=(-1, -2))
        # eq (9): the least-similar subset
        return sets, torch.argmin(in_set_sim, dim=1)

    def apply(self, params, embed, src_pwr=None, mix_pwr=None):
        sets, choice = self.subset_choice(params, embed)
        return sets[torch.arange(sets.shape[0], device=sets.device), choice]
