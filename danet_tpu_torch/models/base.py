"""Module bases: Encoder / Estimator / Separator.

Counterpart of ``danet_tpu/models/base.py``.  A module is built from the
hyperparameter namespace and exposes

  * ``init(generator, device) -> params`` -- its parameter dict (may be
    ``{}``), drawn from an explicit ``torch.Generator``;
  * ``apply(params, ...) -> outputs`` -- a function of params and inputs.

The parameter dicts have the JAX package's layout, key for key, so
``danet_tpu_torch.weights`` carries them across unchanged.
"""
from __future__ import annotations


class ModelModule:
    def __init__(self, hp, name: str):
        self.hp = hp
        self.name = name

    def init(self, generator, device=None) -> dict:
        return {}

    def apply(self, params, *args, **kwargs):
        raise NotImplementedError()


class Encoder(ModelModule):
    """Maps log-magnitude spectra [B, T, F] to embeddings [B, T, F, E];
    ``train`` turns on dropout, drawn from ``generator``.  An encoder may
    take ``tap(name, value)``, which it calls with its internal
    activations (per-layer hidden sequences), for debug mode."""

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None):
        raise NotImplementedError()

    def apply_debug(self, params, log_spectra):
        """(embed, fetches): the forward pass and a dict of the internal
        activations that ``apply`` taps, for the debug mode's .mat dump.
        An encoder whose ``apply`` takes no ``tap`` contributes none."""
        import inspect
        sig = inspect.signature(self.apply).parameters
        fetches = {}
        if "tap" in sig or any(p.kind is inspect.Parameter.VAR_KEYWORD
                               for p in sig.values()):
            embed = self.apply(params, log_spectra, tap=fetches.__setitem__)
        else:
            embed = self.apply(params, log_spectra)
        return embed, fetches


class Estimator(ModelModule):
    """Estimates attractors [B, N, E] from embeddings (and, for USE_TRUTH
    estimators, ground-truth per-source power)."""

    USE_TRUTH = True

    def apply(self, params, embed, src_pwr=None, mix_pwr=None):
        raise NotImplementedError()


class Separator(ModelModule):
    """Per-source power spectra [B, N, T, F] from mixture power,
    attractors and flat embeddings."""

    def apply(self, params, mix_pwr, attractors, embed_flat):
        raise NotImplementedError()
