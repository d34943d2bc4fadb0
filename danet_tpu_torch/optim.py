"""Optimizers: sgd, adam and adamw behind one clip step, with a learning
rate that can be set at run time.

Counterpart of ``danet_tpu/optim.py:17-129``, where optax builds
chain(clip, inject_hyperparams(rule)).  Here the same update rules are
written out over the tensors of the parameter tree, with optax's
hyperparameters (b1 0.9, b2 0.999, eps 1e-8, no eps_root), and applied in
place (the parameters are leaves of the autograd graph, so the update runs
under ``torch.no_grad``).  The clip step first scales the whole gradient
to a global norm of at most GRAD_CLIP_NORM (when set, > 0), then clips
every element to +/- GRAD_CLIP_THRES (when not None).

``make_optimizer(hp, params)`` builds the OPTIMIZER_TYPE registered with
``hparams.register_optimizer``; ``set_learn_rate`` / ``get_learn_rate``
read and write its learning rate.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from danet_tpu_torch.hparams import hparams
from danet_tpu_torch.weights import leaves

B1, B2, EPS = 0.9, 0.999, 1e-8


class Optimizer:
    """The clip step and one update rule ('sgd', 'adam' or 'adamw') over
    the leaves of a parameter tree; holds its moments, step count and
    learning rate."""

    def __init__(self, params: dict, rule: str, learn_rate: float,
                 grad_clip: Optional[float] = None,
                 clip_norm: Optional[float] = None,
                 weight_decay: float = 0.0):
        if rule not in ("sgd", "adam", "adamw"):
            raise ValueError("Unknown update rule %r" % (rule,))
        self.params = leaves(params)
        self.rule = rule
        self.lr = float(learn_rate)
        self.grad_clip = grad_clip
        self.clip_norm = clip_norm
        self.weight_decay = float(weight_decay)
        self.count = 0
        if rule != "sgd":
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]

    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Global-norm clip (GRAD_CLIP_NORM), then value clip
        (GRAD_CLIP_THRES)."""
        if self.clip_norm:
            max_norm = float(self.clip_norm)
            norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                  for g in grads))
            scale = torch.where(norm < max_norm, torch.ones_like(norm),
                                max_norm / torch.clamp(norm, min=1e-38))
            grads = [g * scale.to(g.dtype) for g in grads]
        if self.grad_clip is not None:
            c = float(self.grad_clip)
            grads = [torch.clamp(g, -c, c) for g in grads]
        return grads

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """Apply one update; ``grads`` are aligned with ``leaves(params)``
        (zeros for parameters the loss does not reach)."""
        grads = self.clip(grads)
        self.count += 1
        if self.rule != "sgd":
            bc1 = 1.0 - B1 ** self.count
            bc2 = 1.0 - B2 ** self.count
        for i, (p, g) in enumerate(zip(self.params, grads)):
            if self.rule == "sgd":
                u = g
            else:
                mu = self.mu[i].copy_((1.0 - B1) * g + B1 * self.mu[i])
                nu = self.nu[i].copy_((1.0 - B2) * torch.square(g)
                                      + B2 * self.nu[i])
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
                if self.rule == "adamw":
                    u = u + self.weight_decay * p
            p.add_(u * -self.lr)


@hparams.register_optimizer("sgd")
def sgd_ozer(params, learn_rate, grad_clip=None, clip_norm=None, hp=None):
    return Optimizer(params, "sgd", learn_rate, grad_clip, clip_norm)


@hparams.register_optimizer("adam")
def adam_ozer(params, learn_rate, grad_clip=None, clip_norm=None, hp=None):
    return Optimizer(params, "adam", learn_rate, grad_clip, clip_norm)


@hparams.register_optimizer("adamw")
def adamw_ozer(params, learn_rate, grad_clip=None, clip_norm=None, hp=None):
    """Adam with decoupled weight decay WEIGHT_DECAY (None means 1e-4; an
    explicit 0 turns it off)."""
    wd = getattr(hp if hp is not None else hparams, "WEIGHT_DECAY", None)
    return Optimizer(params, "adamw", learn_rate, grad_clip, clip_norm,
                     weight_decay=1e-4 if wd is None else float(wd))


def make_optimizer(hp, params: dict) -> Optimizer:
    """The configured OPTIMIZER_TYPE over ``params``, at LR, with the clip
    step of GRAD_CLIP_NORM and GRAD_CLIP_THRES."""
    return hp.get_optimizer()(
        params, hp.LR, grad_clip=hp.GRAD_CLIP_THRES,
        clip_norm=getattr(hp, "GRAD_CLIP_NORM", None), hp=hp)


def set_learn_rate(opt: Optimizer, lr: float) -> None:
    opt.lr = float(lr)


def get_learn_rate(opt: Optimizer) -> float:
    return opt.lr
