"""Hyperparameter system of the PyTorch port: layered JSON config plus
component registries.

Counterpart of ``danet_tpu/hparams.py``.  It reads the same
``default.json`` and ``configs/*.json`` with the same keys.  The window
registry is a copy, not an import: importing anything of ``danet_tpu``
imports jax, which the port never does.

The registries are class attributes of THIS class, separate from the JAX
package's, so that registering ``bilstm-orig`` here cannot overwrite the
reference's entry when both packages live in one process (the parity
tests).
"""
from __future__ import annotations

import json
import os
import re
import sys
from typing import Any, Callable, Dict

import numpy as np

DEFAULT_JSON = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "default.json")


def _hann_symmetric(n: int) -> np.ndarray:
    # scipy.signal.hann(n) is symmetric; the reference's default window is
    # sqrt(hann(FFT_SIZE)) (default.json FFT_WND 'sqrt-hann')
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / max(n - 1, 1))


WINDOW_REGISTRY: Dict[str, Callable[[int], np.ndarray]] = {
    "sqrt-hann": lambda n: np.sqrt(_hann_symmetric(n)),
    "hann": _hann_symmetric,
    "rect": lambda n: np.ones(n, dtype=np.float64),
    "hamming": lambda n: 0.54 - 0.46 * np.cos(
        2.0 * np.pi * np.arange(n) / max(n - 1, 1)),
}


class Hyperparameter:
    """Hyperparameter namespace (UPPERCASE attributes) + registries."""

    pattern = r"[A-Z][A-Z0-9_]*"
    encoder_registry: Dict[str, Any] = {}
    model_registry: Dict[str, Any] = {}
    estimator_registry: Dict[str, Any] = {}
    separator_registry: Dict[str, Any] = {}
    ozer_registry: Dict[str, Any] = {}
    dataset_registry: Dict[str, Any] = {}

    def digest(self) -> None:
        """Recompute derived hyperparameters (COMPLEXX, FEATURE_SIZE,
        FFT_WND_ARRAY) after any update."""
        self.COMPLEXX = {"float32": "complex64",
                         "float64": "complex128"}[self.FLOATX]
        self.FEATURE_SIZE = 1 + self.FFT_SIZE // 2
        keep = getattr(self, "DROPOUT_KEEP_PROB", 1.0)
        if not (isinstance(keep, float) and 0.0 < keep <= 1.0):
            raise ValueError("DROPOUT_KEEP_PROB must be a float in (0, 1], "
                             "got %r" % (keep,))
        wnd_name = getattr(self, "FFT_WND", "sqrt-hann")
        if wnd_name not in WINDOW_REGISTRY:
            raise KeyError("Unknown FFT_WND %r; valid options: %s"
                           % (wnd_name, sorted(WINDOW_REGISTRY)))
        self.FFT_WND_ARRAY = WINDOW_REGISTRY[wnd_name](
            self.FFT_SIZE).astype(self.FLOATX)

    def load(self, di: dict) -> None:
        pat = re.compile(self.pattern)
        for k, v in di.items():
            if pat.fullmatch(k) is None:
                raise NameError("Bad hyperparameter key %r" % (k,))
            if not isinstance(v, (str, int, float, bool, type(None))):
                raise TypeError("Hyperparameter %s has non-scalar value %r"
                                % (k, v))
        self.__dict__.update(di)

    def load_json(self, path: str) -> None:
        with open(path, "r") as f:
            self.load(json.load(f))

    # registries: the same decorator surface as danet_tpu.hparams
    @classmethod
    def register_encoder(cls_, name):
        def wrapper(cls):
            cls_.encoder_registry[name] = cls
            return cls
        return wrapper

    def get_encoder(self, name=None):
        return type(self).encoder_registry[
            self.ENCODER_TYPE if name is None else name]

    @classmethod
    def register_model(cls_, name):
        def wrapper(cls):
            cls_.model_registry[name] = cls
            return cls
        return wrapper

    def get_model(self, name=None):
        return type(self).model_registry[
            (getattr(self, "MODEL_TYPE", "danet") or "danet")
            if name is None else name]

    @classmethod
    def register_estimator(cls_, name):
        def wrapper(cls):
            cls_.estimator_registry[name] = cls
            return cls
        return wrapper

    def get_estimator(self, name):
        return type(self).estimator_registry[name]

    @classmethod
    def register_separator(cls_, name):
        def wrapper(cls):
            cls_.separator_registry[name] = cls
            return cls
        return wrapper

    def get_separator(self, name):
        return type(self).separator_registry[name]

    @classmethod
    def register_optimizer(cls_, name):
        def wrapper(fn):
            cls_.ozer_registry[name] = fn
            return fn
        return wrapper

    def get_optimizer(self, name=None):
        return type(self).ozer_registry[
            self.OPTIMIZER_TYPE if name is None else name]

    @classmethod
    def register_dataset(cls_, name):
        def wrapper(cls):
            cls_.dataset_registry[name] = cls
            return cls
        return wrapper

    def get_dataset(self, name=None):
        return type(self).dataset_registry[
            self.DATASET_TYPE if name is None else name]


def load_config(*json_files: str, **overrides) -> Hyperparameter:
    """A fresh namespace: ``default.json``, then each file in order, then
    the keyword overrides; digested."""
    hp = Hyperparameter()
    hp.load_json(DEFAULT_JSON)
    for path in json_files:
        hp.load_json(path)
    hp.load(overrides)
    hp.digest()
    return hp


def apply_overrides(hp, pairs) -> None:
    """CLI ``--set KEY=VALUE`` overrides (``danet_tpu/hparams.py:179-202``):
    values are JSON-typed (``--set TCN_BLOCKS=5`` -> int 5,
    ``--set NAN_CHECKS=true`` -> bool), else a bare string.  A missing
    '=' raises ValueError; a key the loaded config does not carry gets a
    warning on stderr (a misspelt key would otherwise train the default).
    The caller digests afterwards."""
    for kv in pairs:
        key, eq, val = kv.partition("=")
        if not eq:
            raise ValueError("--set expects KEY=VALUE, got %r" % (kv,))
        try:
            val = json.loads(val)
        except ValueError:
            pass  # a bare string
        if not hasattr(hp, key):
            print("WARNING: --set %s: key not present in the loaded "
                  "config (new key, or a typo?)" % key, file=sys.stderr)
        hp.load({key: val})


hparams = Hyperparameter()
