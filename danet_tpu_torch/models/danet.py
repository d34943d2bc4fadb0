"""DaNet model composition: features -> encoder -> attractors -> masks,
the PIT training loss and validation metrics, and inference (wave -> STFT
-> ... -> iSTFT).

Counterpart of ``danet_tpu/models/danet.py:30-133,136-191,266-333,
720-754``: ``mixture_features``, ``__init__``, ``init``, ``_embed``,
``train_loss`` (its 'pit-mse' branch), ``valid_metrics`` (without
EVAL_SI_SNR / EVAL_SDR), ``_mix_features``, ``_separate_tail``,
``separate`` and ``separate_wav``.  ``MIX_SNR_DB``, ``DC_LOSS_WEIGHT``,
``ANCHOR_AUX_LOSS``, ``REG_APPLY`` and the 'pit-si-snr' loss raise
NotImplementedError; ``separate_long``, ``separate_stream`` and
``separate_sp`` are not ported yet.  ``_check_parallel_support`` keeps
JAX's refusals (``:73-105``) and refuses every other MESH_* > 1.

The unit phase vector is ``mix / (|mix| + eps)``, as in the JAX package
(not atan2).
"""
from __future__ import annotations

import torch

from danet_tpu_torch.hparams import hparams
from danet_tpu_torch.ops import dsp
from danet_tpu_torch.ops import loss as loss_ops
from danet_tpu_torch.ops.cuda import stft as cuda_stft

STFT_BACKENDS = ("auto", "xla", "pallas")


def mixture_features(src_ri: torch.Tensor, eps: float):
    """From per-source ri spectra [B, N, T, F, 2]: (mix_ri [B, T, F, 2],
    src_pwr [B, N, T, F], mix_pwr [B, T, F], logmag [B, T, F], phase_unit
    [B, T, F, 2]).  The mixture is the sum of the sources."""
    mix_ri = torch.sum(src_ri, dim=1)
    src_pwr = torch.sqrt(torch.sum(torch.square(src_ri), dim=-1))
    mix_pwr = torch.sqrt(torch.sum(torch.square(mix_ri), dim=-1))
    logmag = torch.log1p(mix_pwr)
    phase_unit = mix_ri / (mix_pwr[..., None] + eps)
    return mix_ri, src_pwr, mix_pwr, logmag, phase_unit


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
            # a separate inference estimator must not need the truth; one
            # shared with training may (validation passes the sources)
            if self.infer_estimator.USE_TRUTH:
                raise ValueError(
                    "INFER_ESTIMATOR_METHOD %r needs ground truth"
                    % (hp.INFER_ESTIMATOR_METHOD,))
        self.separator = hp.get_separator(hp.SEPARATOR_TYPE)(hp, "separator")
        self._check_parallel_support()

    def _check_parallel_support(self):
        """JAX's refusals of a MESH_* axis that the configured encoder has
        no route for (``ValueError``, word for word); then
        NotImplementedError for every MESH_* > 1 that JAX accepts: the port
        runs on one device, in serving and in training."""
        from danet_tpu_torch.models import encoders as enc_mod
        hp, enc = self.hp, self.encoder

        def n(key):
            return int(getattr(hp, key, 1) or 1)

        if n("MESH_PIPE") > 1 and not isinstance(
                enc, enc_mod.BiLstmEncoder):
            raise ValueError(
                "MESH_PIPE>1 requires a pipeline-capable encoder "
                "(bilstm-orig); got ENCODER_TYPE=%r" % hp.ENCODER_TYPE)
        if n("MESH_SEQ") > 1 and not isinstance(
                enc, (enc_mod.BiLstmEncoder, enc_mod.AttentionEncoder,
                      enc_mod.GruEncoder)):
            raise ValueError(
                "MESH_SEQ>1 requires a sequence-parallel encoder "
                "(bilstm-orig, gru-v1, attn-v1, moe-v1, tcn-v1, "
                "dprnn-v1, conv-bilstm-v1); got ENCODER_TYPE=%r"
                % hp.ENCODER_TYPE)
        if n("MESH_EXPERT") > 1:       # the MoE encoder is not ported
            raise ValueError(
                "MESH_EXPERT>1 requires the MoE encoder (moe-v1); got "
                "ENCODER_TYPE=%r" % hp.ENCODER_TYPE)
        if n("MESH_PIPE") > 1 and n("MESH_SEQ") > 1:
            raise ValueError(
                "MESH_PIPE and MESH_SEQ cannot combine (the encoder "
                "routes through one strategy); pick one")
        for key in ("MESH_DATA", "MESH_MODEL", "MESH_PIPE", "MESH_EXPERT",
                    "MESH_SEQ"):
            if n(key) > 1:
                raise NotImplementedError(
                    "%s > 1 is not ported: the port runs on one device"
                    % key)

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

    def _embed(self, params, logmag, train=False, generator=None):
        """Encoder forward in COMPUTE_DTYPE; -> [B, T, F, E]."""
        cdt = getattr(torch, getattr(self.hp, "COMPUTE_DTYPE", "float32"))
        return self.encoder.apply(params["encoder"], logmag.to(cdt),
                                  train=train, generator=generator)

    def check_train_config(self) -> None:
        """Raise NotImplementedError for training options not ported."""
        hp = self.hp
        for key in ("MIX_SNR_DB", "DC_LOSS_WEIGHT", "ANCHOR_AUX_LOSS"):
            if float(getattr(hp, key, 0.0) or 0.0) > 0.0:
                raise NotImplementedError("%s > 0 is not ported" % key)
        if getattr(hp, "REG_APPLY", False) and hp.REG_TYPE is not None:
            raise NotImplementedError("REG_APPLY is not ported")
        loss_type = getattr(hp, "TRAIN_LOSS_TYPE", "pit-mse") or "pit-mse"
        if loss_type != "pit-mse":
            raise NotImplementedError(
                "TRAIN_LOSS_TYPE %r is not ported (only 'pit-mse')"
                % (loss_type,))

    def train_loss(self, params, src_ri: torch.Tensor,
                   generator: torch.Generator = None):
        """PIT loss of the masked complex reconstruction, through the train
        estimator (which sees the true sources).  src_ri [B, N, T, F, 2]
        -> (loss, {"snr", "perm_idx"}); ``generator`` draws the encoder's
        dropout."""
        self.check_train_config()
        eps = self.hp.EPS
        _, src_pwr, mix_pwr, logmag, phase_unit = mixture_features(
            src_ri, eps)
        embed = self._embed(params, logmag, train=True, generator=generator)
        embed_flat = embed.reshape(embed.shape[0], -1, embed.shape[-1])
        attractors = self.train_estimator.apply(
            params.get("train_estimator", {}), embed, src_pwr=src_pwr,
            mix_pwr=mix_pwr)
        sep_pwr = self.separator.apply(
            params.get("separator", {}), mix_pwr, attractors, embed_flat)
        loss, _, perm_idx, snr = loss_ops.pit_mse_masked_ri(
            src_ri, sep_pwr, phase_unit, eps=eps)
        return loss, {"snr": torch.mean(snr), "perm_idx": perm_idx}

    def valid_metrics(self, params, src_ri: torch.Tensor) -> dict:
        """Validation loss and SNR through the inference estimator: PIT
        loss on magnitudes, un-permute, reconstruct with the mixture phase,
        SNR against the true sources.  -> {"loss", "SNR", "separated_ri"}."""
        hp = self.hp
        if getattr(hp, "EVAL_SI_SNR", False) or getattr(hp, "EVAL_SDR",
                                                        False):
            raise NotImplementedError("EVAL_SI_SNR / EVAL_SDR are not ported")
        _, src_pwr, mix_pwr, logmag, phase_unit = mixture_features(
            src_ri, hp.EPS)
        embed = self._embed(params, logmag)
        embed_flat = embed.reshape(embed.shape[0], -1, embed.shape[-1])
        attractors = self.infer_estimator.apply(
            self._infer_est_params(params), embed, src_pwr=src_pwr,
            mix_pwr=mix_pwr)
        sep_pwr = self.separator.apply(
            params.get("separator", {}), mix_pwr, attractors, embed_flat)
        loss, perms, perm_idx = loss_ops.pit_mse_loss(src_pwr, sep_pwr)
        sep_ri = loss_ops.unpermute(sep_pwr, perms, perm_idx)[..., None] \
            * phase_unit[:, None]
        snr = torch.mean(loss_ops.batch_snr(src_ri, sep_ri, eps=hp.EPS,
                                            complex_ri=True))
        return {"loss": loss, "SNR": snr, "separated_ri": sep_ri}

    def _check_truth_free(self) -> None:
        if self.infer_estimator.USE_TRUTH:
            raise ValueError(
                "INFER_ESTIMATOR_METHOD %r needs the true sources: it "
                "serves valid_metrics, not separation"
                % (self.hp.INFER_ESTIMATOR_METHOD,))

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
        self._check_truth_free()
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
