"""Weight bridge between the JAX package's parameter tree and the port.

The port keeps the JAX package's parameter layout key for key (nested
dicts; LSTM ``wx [I,4,H]``, ``wh [H,4,H]``, ``b [4,H]`` with gate order
cand|i|f|o; a bias-free head ``w``; ``anchors [A, E]``), so the bridge
only changes the leaf type:

  * ``from_jax(tree)``: nested dict of numpy arrays (what
    ``jax.device_get(params)`` returns) -> nested dict of torch tensors;
  * ``to_jax(params)``: the reverse, numpy leaves that ``jax.numpy``
    takes as they are.

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
