"""Optimizers: sgd, adam and adamw behind one clip step, with a learning
rate that can be set at run time.

Counterpart of ``danet_tpu/optim.py:17-129``, where optax builds
chain(clip, inject_hyperparams(rule)).  Here the same update rules are
written out over the tensors of the parameter tree, with optax's
hyperparameters (b1 0.9, b2 0.999, eps 1e-8, no eps_root), and applied in
place (the parameters are leaves of the autograd graph, so the update runs
under ``torch.no_grad``).  The clip step first scales the whole gradient
to a global norm of at most GRAD_CLIP_NORM (when set, > 0), then clips
every element to +/- GRAD_CLIP_THRES (when not None).  On a mesh the
parameters, their moments and gradients are the rank's slices
(``parallel/sharding.py``): the update is elementwise, and only the global
norm needs the other slices (``Optimizer.norm_reduce``).

The step's scalars, Adam's reciprocal bias corrections and the negated
learning rate, are a float32 tensor on the parameters' device
(``host_scalars``; on a card copied from pinned memory) rather than Python
numbers, on every device alike, so that a step captured in a CUDA graph
reads the values of its replay and the card and the CPU run the same
arithmetic.  ``m * (1 / bc)`` is how a CUDA op divides by a Python number
(a product with its float32 reciprocal); JAX divides by ``bc``, which
differs from it by at most one float32 ulp.

``make_optimizer(hp, params)`` builds the OPTIMIZER_TYPE registered with
``hparams.register_optimizer``; ``set_learn_rate`` / ``get_learn_rate``
read and write its learning rate.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
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
        # on a mesh the parameters are the rank's slices: a Trainer sets
        # this to sum their squares over the 'model' group (the clip's
        # global norm), given the per-leaf sums of squares
        self.norm_reduce = None
        self.mu = self.nu = None
        if rule != "sgd":
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]

    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Global-norm clip (GRAD_CLIP_NORM), then value clip
        (GRAD_CLIP_THRES)."""
        if self.clip_norm:
            max_norm = float(self.clip_norm)
            sq = [torch.sum(torch.square(g.float())) for g in grads]
            if self.norm_reduce is not None:
                sq = self.norm_reduce(sq)
            norm = torch.sqrt(sum(sq))
            scale = torch.where(norm < max_norm, torch.ones_like(norm),
                                max_norm / torch.clamp(norm, min=1e-38))
            grads = [g * scale.to(g.dtype) for g in grads]
        if self.grad_clip is not None:
            c = float(self.grad_clip)
            grads = [torch.clamp(g, -c, c) for g in grads]
        return grads

    def host_scalars(self, count: int, k: int = 1) -> np.ndarray:
        """float32 [k, 3] of the steps that take the count to ``count``,
        ``count + 1``, ...: 1 / (1 - B1^c) and 1 / (1 - B2^c), each the
        float32 reciprocal of the float32 rounding of the float64 value,
        and -LR."""
        out = np.ones((k, 3), np.float32)
        out[:, 2] = np.float32(-self.lr)
        if self.rule != "sgd":
            for j in range(k):
                c = count + j
                out[j, 0] = np.float32(1.0) / np.float32(1.0 - B1 ** c)
                out[j, 1] = np.float32(1.0) / np.float32(1.0 - B2 ** c)
        return out

    def device_scalars(self, count: int, k: int = 1) -> torch.Tensor:
        """``host_scalars`` on the parameters' device: on a card by a
        non-blocking copy from pinned memory (PyTorch's host allocator
        keeps the pinned block until the copy has run)."""
        host = torch.from_numpy(self.host_scalars(count, k))
        dev = self.params[0].device
        if dev.type != "cuda":
            return host.to(dev)
        return host.pin_memory().to(dev, non_blocking=True)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor],
             scalars: Optional[torch.Tensor] = None) -> None:
        """Apply one update; ``grads`` are aligned with ``leaves(params)``
        (zeros for parameters the loss does not reach).  ``scalars`` is
        this step's row of ``device_scalars`` (without one, the step makes
        its own)."""
        grads = self.clip(grads)
        self.count += 1
        if scalars is None:
            scalars = self.device_scalars(self.count)[0]
        self.update(self.params, self.mu, self.nu, grads, scalars)

    def update(self, params, mu, nu, grads, scalars) -> None:
        """The update rule in place on ``params`` (and the moments ``mu``,
        ``nu``) from clipped ``grads``, with ``scalars`` a row of
        ``device_scalars``."""
        inv1, inv2, neg_lr = scalars[0], scalars[1], scalars[2]
        for i, (p, g) in enumerate(zip(params, grads)):
            if self.rule == "sgd":
                u = g
            else:
                m = mu[i].copy_((1.0 - B1) * g + B1 * mu[i])
                v = nu[i].copy_((1.0 - B2) * torch.square(g) + B2 * nu[i])
                u = (m * inv1) / (torch.sqrt(v * inv2) + EPS)
                if self.rule == "adamw":
                    u = u + self.weight_decay * p
            p.add_(u * neg_lr)


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
