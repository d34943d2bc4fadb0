"""DaNet model composition: features -> encoder -> attractors -> masks,
the training loss and validation metrics, and inference (wave -> STFT ->
... -> iSTFT).

Counterpart of ``danet_tpu/models/danet.py:30-333,720-775``:
``mixture_features``, ``__init__``, ``init``, ``_embed``, ``train_loss``
(the 'pit-mse' and 'pit-si-snr' losses, MIX_SNR_DB, the deep-clustering
auxiliary DC_LOSS_WEIGHT, ANCHOR_AUX_LOSS and REG_APPLY),
``valid_metrics`` (with EVAL_SI_SNR and EVAL_SDR), ``_mix_features``,
``_separate_tail``, ``separate``, ``separate_wav`` and ``reg_loss``.
``separate_long``, ``separate_stream`` and ``separate_sp`` are not ported
yet.  ``_check_parallel_support`` keeps JAX's refusals (``:73-105``) and
refuses every other MESH_* > 1.

The unit phase vector is ``mix / (|mix| + eps)``, as in the JAX package
(not atan2).
"""
from __future__ import annotations

import torch

from danet_tpu_torch import weights
from danet_tpu_torch.hparams import hparams
from danet_tpu_torch.ops import dsp
from danet_tpu_torch.ops import loss as loss_ops
from danet_tpu_torch.ops.cuda import stft as cuda_stft

STFT_BACKENDS = ("auto", "xla", "pallas")
TRAIN_LOSS_TYPES = ("pit-mse", "pit-si-snr")
DC_WEIGHT_TYPES = ("mr", "none")


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
                      enc_mod.GruEncoder, enc_mod.TcnEncoder,
                      enc_mod.DprnnEncoder, enc_mod.ConvBiLstmEncoder)):
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
        """Raise ValueError for a TRAIN_LOSS_TYPE, or a DC_WEIGHT_TYPE with
        DC_LOSS_WEIGHT > 0, that train_loss does not know, as the JAX
        package's train_loss does."""
        hp = self.hp
        loss_type = getattr(hp, "TRAIN_LOSS_TYPE", "pit-mse") or "pit-mse"
        if loss_type not in TRAIN_LOSS_TYPES:
            raise ValueError("Unknown TRAIN_LOSS_TYPE %r" % (loss_type,))
        wt = getattr(hp, "DC_WEIGHT_TYPE", "mr") or "mr"
        if _num(hp, "DC_LOSS_WEIGHT") > 0.0 and wt not in DC_WEIGHT_TYPES:
            raise ValueError("Unknown DC_WEIGHT_TYPE %r" % (wt,))

    @staticmethod
    def mix_gain_db(shape, mix_db: float,
                    generator: torch.Generator) -> torch.Tensor:
        """MIX_SNR_DB's per-source level offsets: uniform in +/- mix_db / 2
        dB, [B, N, 1, 1, 1], drawn from ``generator`` on its device."""
        u = torch.rand(shape, generator=generator, device=generator.device)
        return (u * 2.0 - 1.0) * (0.5 * mix_db)

    def _wav(self, spectra_ri):
        return dsp.istft_ri(spectra_ri, self.hp.FFT_STRIDE,
                            self.hp.FFT_WND_ARRAY)

    def train_loss(self, params, src_ri: torch.Tensor,
                   generator: torch.Generator = None):
        """The training loss through the train estimator (which sees the
        true sources), with the auxiliary terms the config turns on.
        src_ri [B, N, T, F, 2] -> (loss, {"snr", "perm_idx"} and "dc" with
        DC_LOSS_WEIGHT > 0); ``generator`` draws the encoder's dropout and
        MIX_SNR_DB's gains (none without it, as JAX without an rng)."""
        self.check_train_config()
        hp = self.hp
        eps = hp.EPS
        mix_db = _num(hp, "MIX_SNR_DB")
        if mix_db > 0.0 and generator is not None:
            b, n = src_ri.shape[0], src_ri.shape[1]
            db = self.mix_gain_db((b, n, 1, 1, 1), mix_db, generator)
            src_ri = src_ri * (10.0 ** (db.to(src_ri.device) / 20.0)).to(
                src_ri.dtype)
        _, src_pwr, mix_pwr, logmag, phase_unit = mixture_features(
            src_ri, eps)
        embed = self._embed(params, logmag, train=True, generator=generator)
        embed_flat = embed.reshape(embed.shape[0], -1, embed.shape[-1])
        attractors = self.train_estimator.apply(
            params.get("train_estimator", {}), embed, src_pwr=src_pwr,
            mix_pwr=mix_pwr)
        sep_pwr = self.separator.apply(
            params.get("separator", {}), mix_pwr, attractors, embed_flat)

        wave_loss = (getattr(hp, "TRAIN_LOSS_TYPE", "pit-mse")
                     or "pit-mse") == "pit-si-snr"
        if wave_loss:
            # waveform-domain uPIT through the iSTFT
            sep_ri = sep_pwr[..., None] * phase_unit[:, None]
            wav_src = self._wav(src_ri)
            loss, perms, perm_idx = loss_ops.pit_si_snr_loss(
                wav_src, self._wav(sep_ri))
            snr = torch.mean(loss_ops.batch_snr(
                src_ri, loss_ops.unpermute(sep_ri, perms, perm_idx),
                eps=eps, complex_ri=True))
        else:
            loss, _, perm_idx, snr_vec = loss_ops.pit_mse_masked_ri(
                src_ri, sep_pwr, phase_unit, eps=eps)
            snr = torch.mean(snr_vec)
        aux_out = {"snr": snr, "perm_idx": perm_idx}

        dc_w = _num(hp, "DC_LOSS_WEIGHT")
        if dc_w > 0.0:
            wt = getattr(hp, "DC_WEIGHT_TYPE", "mr") or "mr"
            dc = loss_ops.dc_loss(embed, src_pwr,
                                  weights=mix_pwr if wt == "mr" else None)
            # the auxiliary as a share of the primary loss: a scale with
            # no gradient, capped at 1e3 (danet_tpu/models/danet.py:211-227)
            scale = torch.clamp(torch.abs(loss) / (dc + 1e-20),
                                max=1e3).detach()
            loss = loss + dc_w * scale * dc
            aux_out["dc"] = dc

        aux_w = _num(hp, "ANCHOR_AUX_LOSS")
        if aux_w > 0.0 and not self.same_method:
            # trains the inference path (anchors, kmeans) jointly, with
            # mix_pwr so that kmeans runs the refinement it runs at
            # inference; in the main loss's family
            attr_inf = self.infer_estimator.apply(
                self._infer_est_params(params), embed, mix_pwr=mix_pwr)
            sep_pwr_inf = self.separator.apply(
                params.get("separator", {}), mix_pwr, attr_inf, embed_flat)
            if wave_loss:
                aux, _, _ = loss_ops.pit_si_snr_loss(wav_src, self._wav(
                    sep_pwr_inf[..., None] * phase_unit[:, None]))
            else:
                aux, _, _ = loss_ops.pit_mse_loss(src_pwr, sep_pwr_inf)
            loss = loss + aux_w * aux

        if getattr(hp, "REG_APPLY", False) and hp.REG_TYPE is not None:
            loss = loss + reg_loss(params, hp.REG_TYPE, hp.REG_SCALE)
        return loss, aux_out

    def valid_metrics(self, params, src_ri: torch.Tensor) -> dict:
        """Validation loss and SNR through the inference estimator: PIT
        loss on magnitudes, un-permute, reconstruct with the mixture phase,
        SNR against the true sources; with EVAL_SI_SNR the SI-SNR, with
        EVAL_SDR BSS-eval's SDR, SIR and SAR (BSS_FILT_LEN taps) of the
        waveforms.  -> {"loss", "SNR", "separated_ri", ...}."""
        hp = self.hp
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
        out = {"loss": loss, "SNR": snr, "separated_ri": sep_ri}
        eval_si = getattr(hp, "EVAL_SI_SNR", False)
        eval_sdr = getattr(hp, "EVAL_SDR", False)
        if eval_si or eval_sdr:
            wav_src, wav_sep = self._wav(src_ri), self._wav(sep_ri)
            if eval_si:
                out["SI_SNR"] = torch.mean(loss_ops.si_snr(wav_src, wav_sep))
            if eval_sdr:
                bss = loss_ops.bss_eval_sources(
                    wav_src, wav_sep,
                    filt_len=int(getattr(hp, "BSS_FILT_LEN", 512)))
                out.update(SDR=torch.mean(bss["sdr"]),
                           SIR=torch.mean(bss["sir"]),
                           SAR=torch.mean(bss["sar"]))
        return out

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


def _num(hp, key: str) -> float:
    return float(getattr(hp, key, 0.0) or 0.0)


def reg_loss(params, reg_type: str, scale: float) -> torch.Tensor:
    """L1 or L2 regularization over every parameter (REG_APPLY; the
    reference defines it but never adds it, so it is off by default)."""
    ps = weights.leaves(params)
    if reg_type == "L2":
        return scale * sum(torch.sum(torch.square(p)) for p in ps)
    if reg_type == "L1":
        # |p| with JAX's derivative at 0 (+1, where torch.abs gives 0)
        return scale * sum(torch.sum(torch.where(p >= 0, p, -p)) for p in ps)
    raise ValueError("Unknown REG_TYPE %r" % (reg_type,))
