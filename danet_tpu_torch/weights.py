"""Weight bridge between the JAX package's parameter tree and the port.

The port keeps the JAX package's parameter layout key for key (nested
dicts; LSTM ``wx [I,4,H]``, ``wh [H,4,H]``, ``b [4,H]`` with gate order
cand|i|f|o; a bias-free head ``w``; ``anchors [A, E]``), so the bridge
only changes the leaf type:

  * ``from_jax(tree)``: nested dict of numpy arrays (what
    ``jax.device_get(params)`` returns) -> nested dict of torch tensors;
  * ``to_jax(params)``: the reverse, numpy leaves that ``jax.numpy``
    takes as they are;
  * ``from_jax_state(tree)``: a JAX ``Trainer`` state (its numpy tree,
    ``jax.tree_util.tree_map(np.asarray, state)``) -> the host tree of a
    port train state (``train/checkpoint.py``), which
    ``Trainer.restore`` copies into a live state.

``save_npz``/``load_npz`` store a tree in one ``.npz`` with keys joined by
``/`` (for example ``encoder/lstm0/fwd/wh``).  Only leaves are stored:
components without parameters come back absent, and the model treats an
absent component as ``{}``.  Export weights from a JAX session with
``save_npz(path, jax.device_get(params))``; Orbax checkpoints need jax and
are not read here.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def from_jax(tree: Mapping, device=None) -> dict:
    """Nested dict of numpy arrays (or tensors) -> nested dict of tensors
    on ``device``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = from_jax(v, device)
        else:
            t = v if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.array(v, copy=True))
            out[k] = t.to(device)
    return out


def leaves(tree: Mapping) -> list:
    """The leaves of a nested dict, depth first in key order."""
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, Mapping) else [v])
    return out


def leaf_names(tree: Mapping) -> list:
    """The '/'-joined key paths of ``leaves(tree)``, in the same order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.extend(k + "/" + n for n in leaf_names(v))
        else:
            out.append(k)
    return out


def to_jax(params: Mapping) -> dict:
    """Nested dict of tensors (or numpy arrays) -> nested dict of numpy
    arrays."""
    return {k: to_jax(v) if isinstance(v, Mapping)
            else v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in params.items()}


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        if "/" in k:
            raise ValueError("parameter key %r contains '/'" % (k,))
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + k + "/"))
        else:
            flat[prefix + k] = (v.detach().cpu().numpy()
                                if isinstance(v, torch.Tensor)
                                else np.asarray(v))
    return flat


def save_npz(path: str, tree: Mapping) -> None:
    """Save a tree of tensors or numpy arrays to ``path`` (.npz)."""
    np.savez(path, **_flatten(tree))


def load_npz(path: str, device=None) -> dict:
    """Load a tree saved by ``save_npz`` as tensors on ``device``."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return from_jax(tree, device)


def _adam_state(opt_state):
    """optax's ScaleByAdamState (count, mu, nu) inside a chain state, found
    by its fields (the port imports no optax), or None (sgd)."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, tuple):
        for part in opt_state:
            found = _adam_state(part)
            if found is not None:
                return found
    inner = getattr(opt_state, "inner_state", None)
    return None if inner is None else _adam_state(inner)


def from_jax_state(tree: Mapping) -> dict:
    """The numpy tree of a JAX ``Trainer`` state -> the host tree of the
    port's train state: ``params``; ``opt`` from the optimizer chain
    (clip, inject_hyperparams(rule)) of ``danet_tpu/optim.py``: Adam's
    ``mu``, ``nu`` and ``count`` (for sgd, inject_hyperparams' count) and
    the injected ``learning_rate``; ``step``, ``epoch`` and ``ema`` as
    they are.  JAX draws dropout from keys derived from the step, so there
    is no generator state to carry."""
    inject = tree["opt_state"][-1]
    adam = _adam_state(inject.inner_state)
    opt = {"count": int(np.asarray(
               (adam if adam is not None else inject).count)),
           "lr": float(np.asarray(inject.hyperparams["learning_rate"]))}
    if adam is not None:
        opt["mu"] = to_jax(adam.mu)
        opt["nu"] = to_jax(adam.nu)
    out = {"params": to_jax(tree["params"]), "opt": opt,
           "step": int(np.asarray(tree["step"])),
           "epoch": int(np.asarray(tree["epoch"]))}
    if tree.get("ema") is not None:
        out["ema"] = to_jax(tree["ema"])
    return out
