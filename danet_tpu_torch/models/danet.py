"""DaNet model composition for inference: wave -> STFT -> encoder ->
attractors -> masks -> iSTFT.

Counterpart of ``danet_tpu/models/danet.py:47-133,310-333,720-754``:
``__init__``, ``init``, ``_embed``, ``_mix_features``, ``_separate_tail``,
``separate`` and ``separate_wav``.  Training, ``separate_long``,
``separate_stream`` and ``separate_sp`` are not ported yet.

The unit phase vector is ``mix / (|mix| + eps)``, as in the JAX package
(not atan2).
"""
from __future__ import annotations

import torch

from danet_tpu_torch.hparams import hparams
from danet_tpu_torch.ops import dsp
from danet_tpu_torch.ops.cuda import stft as cuda_stft

STFT_BACKENDS = ("auto", "xla", "pallas")


@hparams.register_model("danet")
class DaNet:
    """The composed model; sub-modules resolved from the port's registries
    by the same config keys as the JAX package (ENCODER_TYPE,
    TRAIN/INFER_ESTIMATOR_METHOD, SEPARATOR_TYPE)."""

    def __init__(self, hp=None, name: str = "danet"):
        hp = hp if hp is not None else hparams
        self.hp = hp
        self.name = name
        self.encoder = hp.get_encoder()(hp, "encoder")
        self.train_estimator = hp.get_estimator(
            hp.TRAIN_ESTIMATOR_METHOD)(hp, "train_estimator")
        self.same_method = (
            hp.INFER_ESTIMATOR_METHOD == hp.TRAIN_ESTIMATOR_METHOD)
        if self.same_method:
            self.infer_estimator = self.train_estimator
        else:
            self.infer_estimator = hp.get_estimator(
                hp.INFER_ESTIMATOR_METHOD)(hp, "infer_estimator")
        if self.infer_estimator.USE_TRUTH:
            raise ValueError("INFER_ESTIMATOR_METHOD %r needs ground truth"
                             % (hp.INFER_ESTIMATOR_METHOD,))
        self.separator = hp.get_separator(hp.SEPARATOR_TYPE)(hp, "separator")

    def init(self, generator: torch.Generator, device=None) -> dict:
        """Random parameters with the JAX package's layout."""
        params = {
            "encoder": self.encoder.init(generator, device),
            "train_estimator": self.train_estimator.init(generator, device),
            "separator": self.separator.init(generator, device),
        }
        if not self.same_method:
            params["infer_estimator"] = self.infer_estimator.init(
                generator, device)
        return params

    def _embed(self, params, logmag):
        """Encoder forward in COMPUTE_DTYPE; -> [B, T, F, E]."""
        cdt = getattr(torch, getattr(self.hp, "COMPUTE_DTYPE", "float32"))
        return self.encoder.apply(params["encoder"], logmag.to(cdt))

    def _infer_est_params(self, params):
        # components without parameters may be absent (save_npz keeps
        # leaves only)
        key = "train_estimator" if self.same_method else "infer_estimator"
        return params.get(key, {})

    def _mix_features(self, mix_ri):
        """(mix_pwr, logmag, phase_unit) from mixture ri spectra."""
        mix_pwr = torch.sqrt(torch.sum(mix_ri * mix_ri, dim=-1))
        return (mix_pwr, torch.log1p(mix_pwr),
                mix_ri / (mix_pwr[..., None] + self.hp.EPS))

    def _separate_tail(self, params, embed, mix_pwr, phase_unit):
        """Attractors -> masks -> reconstruction: [B, N, T, F, 2]."""
        b = embed.shape[0]
        embed_flat = embed.reshape(b, -1, embed.shape[-1])
        attractors = self.infer_estimator.apply(
            self._infer_est_params(params), embed, mix_pwr=mix_pwr)
        sep_pwr = self.separator.apply(
            params.get("separator", {}), mix_pwr, attractors, embed_flat)
        return sep_pwr[..., None] * phase_unit[:, None]

    def separate(self, params, mix_ri: torch.Tensor) -> torch.Tensor:
        """Mixture ri spectra [B, T, F, 2] -> separated ri [B, N, T, F, 2]
        (source order arbitrary, as in the reference)."""
        mix_pwr, logmag, phase_unit = self._mix_features(mix_ri)
        embed = self._embed(params, logmag)
        return self._separate_tail(params, embed, mix_pwr, phase_unit)

    def separate_wav(self, params, wav: torch.Tensor) -> torch.Tensor:
        """Waveforms [B, L] -> separated waveforms [B, N, L'],
        L' = num_frames * FFT_STRIDE (the reference's overlap-add length).

        STFT_BACKEND keeps its JAX values: 'auto' and 'pallas' take the
        fused STFT kernel for a CUDA tensor (its plain version on the
        CPU), 'xla' the plain framing + matmul path."""
        hp = self.hp
        window = hp.FFT_WND_ARRAY
        be = getattr(hp, "STFT_BACKEND", "auto") or "auto"
        if be not in STFT_BACKENDS:
            raise ValueError("Unknown STFT_BACKEND %r" % (be,))
        if be == "xla":
            mix_ri = dsp.stft_ri(wav, hp.FFT_SIZE, hp.FFT_STRIDE, window)
        else:
            mix_ri = cuda_stft.stft_ri(wav, hp.FFT_SIZE, hp.FFT_STRIDE,
                                       window)
        sep_ri = self.separate(params, mix_ri)
        return dsp.istft_ri(sep_ri, hp.FFT_STRIDE, window)
