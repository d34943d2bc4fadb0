"""Train-state checkpoints: save, load and the weights that evaluation
runs on.

Counterpart of ``danet_tpu/train/checkpoint.py``, in the port's own format
instead of Orbax's: a checkpoint is a directory (``saves/<name>_e<k>``,
``saves/<name>_best``, ``saves/<name>_preempt``, or the ``-o`` path) that
holds one ``state.npz``, keyed as ``weights.save_npz`` keys a tree
(``params/encoder/lstm0/fwd/wh``).  It holds the whole train state:

    params/...           the parameters
    opt/mu/..., opt/nu/...  Adam's moments (adam, adamw; none for sgd),
                         keyed like the parameters
    opt/count, opt/lr    the optimizer's step count and learning rate
    step, epoch          the counters
    ema/...              the EMA of the parameters (EMA_DECAY > 0)
    generator/state, generator/device, generator/seed
                         the dropout generator: its state (on a card its
                         seed and Philox offset), the device type it was
                         drawn on, and its seed

A save writes a temporary file in the directory and renames it over
``state.npz``, so a kill in the middle of a save leaves the previous
checkpoint (or none) where ``-i`` reads, never half of one.

``load_checkpoint`` returns the host tree of a state (nested dicts of
numpy arrays with the keys above; ``step``, ``epoch`` and ``opt/count``
as Python ints), checked leaf by leaf against a template state:
a checkpoint of another architecture raises a ``ValueError`` that names
the leaf counts or the first leaf that differs.  ``Trainer.restore``
copies such a tree into a live state.
"""
from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from danet_tpu_torch.weights import leaf_names, leaves

STATE_FILE = "state.npz"
# the parts of a state that the template's structure must match; "ema"
# and "generator" may be missing on either side (see load_checkpoint)
STRUCTURAL = ("params", "opt", "step", "epoch")


def _file(path: str) -> str:
    return os.path.join(os.path.abspath(path), STATE_FILE)


def exists(path: str) -> bool:
    """Whether ``path`` holds a complete checkpoint."""
    return os.path.isfile(_file(path))


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flat(state: Mapping, data: bool = True) -> dict:
    """{key: array} of a live state (``Trainer.init_state``'s dict, whose
    "opt" is an ``optim.Optimizer``) or of a host tree; with ``data``
    False the values are (shape, dtype) only, and nothing is copied off
    the device."""
    def conv(x):
        if data:
            return _numpy(x)
        if isinstance(x, torch.Tensor):
            return tuple(x.shape), str(x.dtype).replace("torch.", "")
        x = np.asarray(x)
        return x.shape, str(x.dtype)

    flat = {}

    def tree(prefix, t):
        for name, leaf in zip(leaf_names(t), leaves(t)):
            flat[prefix + name] = conv(leaf)

    if "params" in state:
        tree("params/", state["params"])
    opt = state.get("opt")
    if isinstance(opt, Mapping):
        for m in ("mu", "nu"):
            if opt.get(m) is not None:
                tree("opt/%s/" % m, opt[m])
        flat["opt/count"] = conv(np.int64(opt["count"]))
        flat["opt/lr"] = conv(np.float64(opt["lr"]))
    elif opt is not None:
        names = leaf_names(state["params"])
        for m in ("mu", "nu"):
            moments = getattr(opt, m)
            if moments is not None:
                for name, t in zip(names, moments):
                    flat["opt/%s/%s" % (m, name)] = conv(t)
        flat["opt/count"] = conv(np.int64(opt.count))
        flat["opt/lr"] = conv(np.float64(opt.lr))
    for key in ("step", "epoch"):
        if key in state:
            flat[key] = conv(np.int64(state[key]))
    if state.get("ema") is not None:
        tree("ema/", state["ema"])
    gen = state.get("generator")
    if isinstance(gen, torch.Generator):
        flat["generator/state"] = conv(gen.get_state())
        flat["generator/device"] = conv(np.array(gen.device.type))
        flat["generator/seed"] = conv(np.uint64(gen.initial_seed()))
    elif gen is not None:
        for k, v in gen.items():
            flat["generator/" + k] = conv(v)
    return flat


def _nest(flat: Mapping) -> dict:
    """The host tree of a flat {key: array} dict; the counters as ints."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    for key in ("step", "epoch"):
        if key in tree:
            tree[key] = int(tree[key])
    if "opt" in tree:
        tree["opt"]["count"] = int(tree["opt"]["count"])
        tree["opt"]["lr"] = float(tree["opt"]["lr"])
    return tree


def save_checkpoint(path: str, state: Mapping) -> None:
    """Save a train state (a live state or a host tree) to the directory
    ``path``: written to a temporary file there, then renamed over
    ``state.npz``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    final = _file(path)
    tmp = "%s.tmp-%d" % (final, os.getpid())
    with open(tmp, "wb") as f:
        np.savez(f, **_flat(state))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def _read(path: str) -> dict:
    if not exists(path):
        raise FileNotFoundError("no checkpoint at %s (%s missing)"
                                % (path, STATE_FILE))
    with np.load(_file(path), allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _check(path: str, got: Mapping, want: Mapping) -> None:
    """Leaf by leaf: the same number of leaves, the same keys, shapes and
    dtypes, else a ValueError that names the difference."""
    if len(got) != len(want):
        raise ValueError(
            "checkpoint %s holds %d leaves but the expected state has %d "
            "— different architecture/config? (e.g. a different "
            "ENCODER_TYPE or encoder dims than the checkpoint was "
            "trained with)" % (path, len(got), len(want)))
    for key, (shape, dtype) in want.items():
        if key not in got:
            missing = sorted(set(want) - set(got))
            raise ValueError(
                "checkpoint %s lacks %s (holds %s instead) — different "
                "architecture/config?"
                % (path, missing[:4], sorted(set(got) - set(want))[:4]))
        g = got[key]
        if tuple(g.shape) != tuple(shape):
            raise ValueError(
                "checkpoint %s[%r] has shape %s but the expected state has "
                "%s — different architecture/config?"
                % (path, key, tuple(g.shape), tuple(shape)))
        if str(g.dtype) != dtype and key.startswith(("params/", "ema/")):
            raise ValueError(
                "checkpoint %s[%r] dtype %s != expected %s (different "
                "FLOATX config?)" % (path, key, g.dtype, dtype))


def _select(flat: Mapping, tops) -> dict:
    return {k: v for k, v in flat.items() if k.split("/", 1)[0] in tops}


def load_checkpoint(path: str, template: Mapping,
                    partial: bool = False) -> dict:
    """The host tree of the checkpoint at ``path``, checked against
    ``template`` (a live state or a host tree).  ``partial``: only the
    template's top-level keys (e.g. ``{"params": ...}``) are read and
    checked.  Otherwise the structural parts (params, opt, step, epoch)
    must match; a checkpoint without an EMA restored into a state with one
    gets the restored params as its EMA (the EMA restarts there), an EMA
    the template lacks is dropped, and so is a generator it lacks."""
    path = os.path.abspath(path)
    flat = _read(path)
    want = _flat(template, data=False)
    tops = {k.split("/", 1)[0] for k in want}
    if partial:
        got = _select(flat, tops)
        _check(path, got, want)
        return _nest(got)
    got = _select(flat, STRUCTURAL)
    _check(path, got, _select(want, STRUCTURAL))
    if "ema" in tops:
        ema = _select(flat, ("ema",))
        if ema:
            _check(path, ema, _select(want, ("ema",)))
        else:
            ema = {"ema/" + k.split("/", 1)[1]: np.copy(v)
                   for k, v in got.items() if k.startswith("params/")}
        got.update(ema)
    if "generator" in tops:
        got.update(_select(flat, ("generator",)))
    return _nest(got)


def load_eval_params(path: str, params_template: Mapping) -> dict:
    """The weights that evaluation and serving run on: the EMA when the
    checkpoint holds one, else the parameters; checked against
    ``params_template`` and returned as a tree of numpy arrays."""
    path = os.path.abspath(path)
    flat = _read(path)
    key = "ema" if any(k.startswith("ema/") for k in flat) else "params"
    got = {"params/" + k.split("/", 1)[1]: v
           for k, v in _select(flat, (key,)).items()}
    _check(path, got, _flat({"params": params_template}, data=False))
    return _nest(got)["params"]

