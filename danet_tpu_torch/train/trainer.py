"""Training loop: batch preparation, the train and valid steps, and a
plain epoch loop.

Counterpart of ``danet_tpu/train/trainer.py``: ``prepare_batch``
(:143-169), ``Trainer`` with its steps (:223-393), ``init_state``
(:492-502), the learning rate (:584-588) and ``train`` (:642-1038).  The
JAX trainer jits one fused step; here a step runs eagerly on ``device``:
ingest the prepared numpy batch, forward, backward (autograd, through the
recurrent kernels' and the flash-attention kernels' autograd Functions),
clip, update in place.

Not ported, and refused with NotImplementedError: GRAD_ACCUM > 1,
EMA_DECAY > 0, TRAIN_STEPS_PER_CALL > 1, TRANSFER_DOMAIN='wave', wires
other than float32, NAN_CHECKS, REMAT, the valid-crash rollback
(VALID_CRASH_FACTOR > 0) and the hang watchdog (WATCHDOG_SECS > 0);
``DaNet`` itself refuses MESH_* > 1.  Checkpoints, the NaN rollback, profiling and metric files are not
ported either: ``train`` raises on a NaN epoch instead of rolling back.

The data stream is reproducible: every epoch draws its batches and crops
from ``np.random.RandomState(crc32(...))`` of the same (epoch, seed) key
that the JAX trainer seeds numpy's global generator with.
"""
from __future__ import annotations

import math
import sys
import time
import zlib
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from danet_tpu_torch import optim as optim_lib
from danet_tpu_torch import weights
from danet_tpu_torch.data import audio
from danet_tpu_torch.weights import leaves


def prepare_batch(flat_spectra: np.ndarray, batch_size: int, n_signal: int,
                  max_len: Optional[int] = None,
                  bucket: Optional[int] = None,
                  rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Host-side batch prep: flat [B*N, T, F] -> ri [B, N, T', F, 2].

    Consecutive utterances form the N sources of a mixture; then a random
    crop to ``max_len`` frames (drawn from ``rng``) and zero padding up to
    a multiple of ``bucket``."""
    if flat_spectra.shape[0] != batch_size * n_signal:
        raise ValueError("got %d utterances for batch %d x %d sources"
                         % (flat_spectra.shape[0], batch_size, n_signal))
    spectra = flat_spectra.reshape(
        batch_size, n_signal, -1, flat_spectra.shape[-1])
    t = spectra.shape[2]
    if max_len is not None and t > max_len:
        if rng is None:
            raise ValueError("cropping to MAX_TRAIN_LEN needs an explicit "
                             "np.random.RandomState")
        beg = rng.randint(0, t - max_len)
        spectra = spectra[:, :, beg:beg + max_len]
        t = max_len
    if bucket:
        pad = (-t) % bucket
        if pad:
            spectra = np.pad(spectra, [(0, 0), (0, 0), (0, pad), (0, 0)])
    return audio.to_ri(spectra)


def _dict_format(di) -> str:
    return " ".join("%s=%s" % (k, v) for k, v in di.items())


class Trainer:
    """Owns the steps and the loop for one model on one ``device`` (the
    card unless the caller asks for the CPU).  The state is {params, opt,
    step, epoch, generator}: ``opt`` holds the optimizer's moments and
    learning rate, ``generator`` draws dropout."""

    def __init__(self, model, hp=None, device="cuda"):
        self.hp = hp if hp is not None else model.hp
        self.model = model
        self.device = torch.device(device)
        self._check_config()
        model.check_train_config()

    def _check_config(self) -> None:
        hp = self.hp

        def num(key):
            return float(getattr(hp, key, 0) or 0)

        refused = [
            ("GRAD_ACCUM > 1", num("GRAD_ACCUM") > 1),
            ("EMA_DECAY > 0", num("EMA_DECAY") > 0),
            ("TRAIN_STEPS_PER_CALL > 1", num("TRAIN_STEPS_PER_CALL") > 1),
            ("TRANSFER_DOMAIN other than 'spectra'",
             str(getattr(hp, "TRANSFER_DOMAIN", "spectra")) != "spectra"),
            ("TRANSFER_DTYPE other than 'float32'",
             str(getattr(hp, "TRANSFER_DTYPE", "float32")) != "float32"),
            ("NAN_CHECKS", bool(getattr(hp, "NAN_CHECKS", False))),
            ("REMAT", bool(getattr(hp, "REMAT", False))),
            ("VALID_CRASH_FACTOR > 0", num("VALID_CRASH_FACTOR") > 0),
            ("WATCHDOG_SECS > 0", num("WATCHDOG_SECS") > 0),
        ]
        for what, bad in refused:
            if bad:
                raise NotImplementedError(
                    "%s is not ported to the PyTorch trainer" % what)

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None,
                   params: Optional[dict] = None) -> dict:
        """Fresh state: parameters drawn from ``generator`` (or a copy of
        ``params``, a tree of tensors or numpy arrays), a fresh optimizer
        at LR, and a dropout generator on the device seeded from
        ``generator``."""
        generator = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        if params is None:
            params = self.model.init(generator, self.device)
        else:
            params = weights.from_jax(weights.to_jax(params), self.device)
        for p in leaves(params):
            p.requires_grad_(True)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        return {"params": params,
                "opt": optim_lib.make_optimizer(self.hp, params),
                "step": 0, "epoch": 0,
                "generator": torch.Generator(self.device).manual_seed(seed)}

    def ingest(self, batch_np: np.ndarray) -> torch.Tensor:
        """A prepared float32 batch [B, N, T, F, 2] onto the device."""
        return torch.from_numpy(
            np.ascontiguousarray(batch_np, dtype=np.float32)).to(self.device)

    def loss_and_grads(self, params: dict, src_ri: torch.Tensor,
                       generator: Optional[torch.Generator] = None):
        """(metrics, grads): {"loss", "SNR"} and "DC" (the raw
        deep-clustering term, with DC_LOSS_WEIGHT > 0) as detached 0-d
        tensors, and the train loss's gradient aligned with
        ``leaves(params)`` (zeros where the loss does not reach)."""
        loss, aux = self.model.train_loss(params, src_ri, generator)
        ps = leaves(params)
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(ps, grads)]
        metrics = {"loss": loss.detach(), "SNR": aux["snr"].detach()}
        if "dc" in aux:
            metrics["DC"] = aux["dc"].detach()
        return metrics, grads

    def train_step(self, state: dict, batch_np: np.ndarray) -> dict:
        """One step on a prepared batch: ingest, forward, backward, clip,
        update.  -> {"loss", "SNR"} (and "DC") as 0-d tensors on the
        device."""
        metrics, grads = self.loss_and_grads(
            state["params"], self.ingest(batch_np), state["generator"])
        state["opt"].step(grads)
        state["step"] += 1
        return metrics

    @torch.no_grad()
    def valid_step(self, state: dict, batch_np: np.ndarray) -> dict:
        """Validation metrics of one prepared batch: every metric of
        ``valid_metrics`` but the separated spectra."""
        m = self.model.valid_metrics(state["params"], self.ingest(batch_np))
        return {k: v for k, v in m.items() if k != "separated_ri"}

    def set_learn_rate(self, state: dict, lr: float) -> None:
        optim_lib.set_learn_rate(state["opt"], lr)

    def get_learn_rate(self, state: dict) -> float:
        return optim_lib.get_learn_rate(state["opt"])

    # ------------------------------------------------------------------
    def _batches(self, dataset, subset, rng, max_len):
        hp = self.hp
        for data_pt in dataset.epoch(subset, hp.BATCH_SIZE * hp.MAX_N_SIGNAL,
                                     shuffle=subset == "train", rng=rng):
            yield prepare_batch(data_pt[0], hp.BATCH_SIZE, hp.MAX_N_SIGNAL,
                                max_len=max_len,
                                bucket=getattr(hp, "TIME_BUCKET", None),
                                rng=rng)

    def _metrics_sweep(self, state, dataset, subset, rng) -> OrderedDict:
        acc, n = {}, 0
        for batch in self._batches(dataset, subset, rng, None):
            for k, v in self.valid_step(state, batch).items():
                acc[k] = acc.get(k, 0.0) + float(v)
            n += 1
            sys.stdout.write(".")
            sys.stdout.flush()
        return OrderedDict((k, v / n) for k, v in sorted(acc.items()))

    def train(self, n_epoch: int, dataset, valid_on_epoch: bool = True,
              state: Optional[dict] = None, seed: int = 0,
              lr: Optional[float] = None) -> dict:
        """Plain epoch loop: per-epoch mean loss, SNR and LR on stdout
        (':' per step), the LR_DECAY_TYPE policy, and a validation sweep
        ('.' per batch) after each epoch when ``valid_on_epoch``."""
        hp = self.hp
        if state is None:
            state = self.init_state(torch.Generator().manual_seed(seed))
        if lr is not None:
            self.set_learn_rate(state, lr)
            print("Set learning rate to %f" % lr)
        else:
            print("Learning rate: %f" % self.get_learn_rate(state))
        base_lr = self.get_learn_rate(state)
        best_loss, best_loss_time = float("inf"), 0
        epoch0 = int(state["epoch"])
        n_total = epoch0 + n_epoch
        for epoch in range(epoch0, n_total):
            rng = np.random.RandomState(zlib.crc32(
                b"danet-epoch-%d-retry-0-seed-%d" % (epoch, seed)))
            report, n_steps, seconds = OrderedDict(), 0, 0.0
            for batch in self._batches(dataset, "train", rng,
                                       hp.MAX_TRAIN_LEN):
                t0 = time.perf_counter()
                metrics = self.train_step(state, batch)
                row = {k: float(v) for k, v in metrics.items()}  # syncs
                seconds += time.perf_counter() - t0
                row["LR"] = self.get_learn_rate(state)
                for k, v in row.items():
                    report[k] = report.get(k, 0.0) + v
                n_steps += 1
                sys.stdout.write(":")
                sys.stdout.flush()
            if n_steps == 0:
                raise RuntimeError(
                    "dataset yielded no training batches for batch size %d"
                    % (hp.BATCH_SIZE * hp.MAX_N_SIGNAL))
            for k in report:
                report[k] /= n_steps

            decay = hp.LR_DECAY_TYPE
            if decay == "adaptive":
                if report["loss"] < best_loss:
                    best_loss, best_loss_time = report["loss"], 0
                else:
                    best_loss_time += 1
            elif decay == "fixed":
                best_loss_time += 1
            elif decay == "cosine":
                frac = (epoch - epoch0 + 1) / max(n_epoch, 1)
                floor_lr = base_lr * hp.LR_DECAY
                self.set_learn_rate(state, floor_lr + 0.5 * (
                    base_lr - floor_lr) * (1.0 + math.cos(
                        math.pi * min(frac, 1.0))))
            elif decay is not None:
                raise ValueError('Unknown LR_DECAY_TYPE "%s"' % decay)
            if best_loss_time == hp.NUM_EPOCH_PER_LR_DECAY:
                best_loss_time = 0
                old_lr = self.get_learn_rate(state)
                self.set_learn_rate(state, old_lr * hp.LR_DECAY)
                sys.stdout.write("[LR %f -> %f]" % (
                    old_lr, self.get_learn_rate(state)))
            if any(math.isnan(v) for v in report.values()):
                raise FloatingPointError(
                    "epoch %d got NaN values (the NaN rollback is not "
                    "ported)" % (epoch + 1))
            state["epoch"] = epoch + 1
            sys.stdout.write("\nEpoch %d/%d %s (%.3fs/step)\n" % (
                epoch + 1, n_total, _dict_format(report), seconds / n_steps))
            sys.stdout.flush()
            if valid_on_epoch:
                report = self._metrics_sweep(state, dataset, "valid", rng)
                sys.stdout.write("\nValid  %d/%d %s\n" % (
                    epoch + 1, n_total, _dict_format(report)))
                sys.stdout.flush()
        return state
