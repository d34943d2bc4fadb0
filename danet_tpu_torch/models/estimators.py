"""Attractor estimators: ``truth``, ``truth-threshold``, ``truth-weighted``,
``anchor`` and ``kmeans``.

Counterpart of ``danet_tpu/models/estimators.py``.  The three truth
estimators average each source's embeddings over the bins it dominates:
``truth`` with the reference's ``/(count + 1)``, ``truth-threshold`` over
the bins whose mixture magnitude exceeds 5, ``truth-weighted`` (the
default train estimator) weighted by the mixture magnitude.  ``anchor`` is
the inference estimator of the serving path, with the JAX package's N=2
sigmoid strength reduction and its eq-8 diagonal exclusion (pairwise
similarity between DISTINCT attractors only).  ``kmeans`` (the inference
estimator of ``configs/tpu.json``) starts from the anchor's attractors and
refines them by KMEANS_ITER unrolled rounds of mixture-magnitude-weighted
soft assignment.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from danet_tpu_torch.hparams import hparams
from danet_tpu_torch.models.base import Estimator
from danet_tpu_torch.ops.nn import device_constant, ee


def _hard_assignment(src_pwr: torch.Tensor) -> torch.Tensor:
    """[B, N, T, F] -> one-hot dominant source [B, T*F, N]."""
    b, n = src_pwr.shape[0], src_pwr.shape[1]
    labels = torch.argmax(src_pwr, dim=1)
    # one_hot by comparison: torch's one_hot checks its labels on the
    # host off the card, which a step in a CUDA graph must not do
    onehot = (labels[..., None] == torch.arange(
        n, device=labels.device)).to(src_pwr.dtype)
    return onehot.reshape(b, -1, n)


@hparams.register_estimator("truth")
class AverageEstimator(Estimator):
    """Per-source mean of the embeddings, over the reference's
    ``count + 1``."""

    USE_TRUTH = True

    def apply(self, params, embed, src_pwr=None, mix_pwr=None):
        b, e = embed.shape[0], embed.shape[-1]
        embed_flat = embed.reshape(b, -1, e)
        onehot = _hard_assignment(src_pwr).to(embed_flat.dtype)
        sums = ee("bkn,bke->bne", onehot, embed_flat)
        counts = torch.sum(onehot, dim=1)
        return sums / (counts[..., None] + 1.0)


@hparams.register_estimator("truth-threshold")
class ThresholdedAverageEstimator(Estimator):
    """Per-source mean over the bins whose mixture magnitude exceeds 5."""

    USE_TRUTH = True

    def apply(self, params, embed, src_pwr=None, mix_pwr=None):
        b, e = embed.shape[0], embed.shape[-1]
        embed_flat = embed.reshape(b, -1, e)
        w = (mix_pwr.reshape(b, -1, 1) > 5.0).to(embed_flat.dtype)
        wgt = _hard_assignment(src_pwr).to(embed_flat.dtype) * w
        sums = ee("bkn,bke->bne", wgt, embed_flat)
        wsum = torch.sum(wgt, dim=1)[..., None]
        return sums / (wsum + self.hp.EPS)


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
        the per-subset assignment never materializes.  -> [B, P, 2, E]

        Slot 1 takes the sigmoid of the negated difference and its own sums
        over the K = T*F bins, as slot 0 does.  The JAX package takes slot
        1's sums as the totals minus slot 0's, equal in real arithmetic but
        a cancelling float32 difference: with it, the order in which the
        card's GEMM sums over K put the anchors' gradient (through kmeans
        and ANCHOR_AUX_LOSS) 1e-4 of its peak away from the CPU's."""
        b, e_dim = embed.shape[0], embed.shape[-1]
        e_flat = embed.reshape(b, -1, e_dim)                 # [B, K, E]
        d = ee("bke,ae->bka", e_flat, anchors)               # [B, K, A]
        diff = d[..., combs[:, 0]] - d[..., combs[:, 1]]     # [B, K, P]
        s = torch.sigmoid(torch.stack([diff, -diff], dim=-1))
        num = ee("bkpc,bke->bpce", s, e_flat)                # [B, P, 2, E]
        den = torch.sum(s.float(), dim=1)                    # [B, P, 2]
        return num / den[..., None].to(embed.dtype)

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
        combs = device_constant(
            ("anchor-subsets", hp.NUM_ANCHOR, n), lambda: np.asarray(
                list(itertools.combinations(range(hp.NUM_ANCHOR), n)),
                dtype=np.int64), embed.device)
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


@hparams.register_estimator("kmeans")
class KMeansEstimator(AnchoredEstimator):
    """Truth-free k-means attractors: centroids start from the anchor
    mechanism (eq. 6-9, the same parameters) and take KMEANS_ITER (default
    5) unrolled rounds of soft assignment weighted by the mixture
    magnitude (uniform without one), then a weighted mean per centroid.

    N=2 takes the anchor's strength reduction: the two-way softmax is a
    sigmoid of the logit difference, and the complement centroid follows
    from the loop-invariant weighted totals.  The weight sums run in
    float32 and are rounded to the compute dtype, as in the JAX package."""

    def apply(self, params, embed, src_pwr=None, mix_pwr=None):
        hp = self.hp
        n_iter = getattr(hp, "KMEANS_ITER", None)
        n_iter = 5 if n_iter is None else int(n_iter)
        b, e = embed.shape[0], embed.shape[-1]
        embed_flat = embed.reshape(b, -1, e)               # [B, K, E]
        if mix_pwr is not None:
            w = mix_pwr.reshape(b, -1, 1).to(embed_flat.dtype)
        else:
            w = torch.ones(embed_flat.shape[:2] + (1,),
                           dtype=embed_flat.dtype, device=embed.device)
        centroids = super().apply(params, embed)           # [B, N, E]
        if centroids.shape[1] == 2:
            w1 = w[..., 0]                                 # [B, K]
            sums_w = ee("bk,bke->be", w1, embed_flat)      # loop-invariant
            wsum_w = torch.sum(w1.float(), dim=1, keepdim=True)

            def step(c):
                dc = (c[:, 0] - c[:, 1]).to(embed_flat.dtype)
                s = torch.sigmoid(ee("bke,be->bk", embed_flat, dc)) * w1
                sums0 = ee("bk,bke->be", s, embed_flat)
                wsum0 = torch.sum(s.float(), dim=1, keepdim=True)
                c0 = sums0 / (wsum0 + hp.EPS).to(sums0.dtype)
                c1 = (sums_w - sums0) / (wsum_w - wsum0
                                         + hp.EPS).to(sums0.dtype)
                return torch.stack([c0, c1], dim=1).to(c.dtype)
        else:
            def step(c):
                logits = ee("bke,bne->bkn", embed_flat,
                            c.to(embed_flat.dtype))
                assign = torch.softmax(logits, dim=-1) * w     # [B, K, N]
                sums = ee("bkn,bke->bne", assign, embed_flat)
                wsum = torch.sum(assign, dim=1)[..., None]
                return (sums / (wsum + hp.EPS)).to(c.dtype)

        for _ in range(n_iter):
            centroids = step(centroids)
        return centroids
