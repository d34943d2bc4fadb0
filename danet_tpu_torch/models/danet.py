"""DaNet model composition: features -> encoder -> attractors -> masks,
the training loss and validation metrics, and inference (wave -> STFT ->
... -> iSTFT).

Counterpart of ``danet_tpu/models/danet.py:30-333,395-775``:
``mixture_features``, ``__init__``, ``init``, ``_embed``, ``train_loss``
(the 'pit-mse' and 'pit-si-snr' losses, MIX_SNR_DB, the deep-clustering
auxiliary DC_LOSS_WEIGHT, ANCHOR_AUX_LOSS and REG_APPLY),
``valid_metrics`` (with EVAL_SI_SNR and EVAL_SDR), ``_mix_features``,
``_separate_tail``, ``separate``, ``separate_wav``, ``reg_loss``, the
long-form ``separate_long`` and the causal streaming surface
(``separate_stream`` over spectra; ``stream_init`` / ``stream_step`` over
waveforms, every carried value in one state dict) and ``separate_sp``
(sequence-parallel inference over a mesh's 'seq' axis, ``:336-392``).
``_check_parallel_support`` keeps JAX's refusals (``:73-105``);
``seq_leaves`` names the leaves each rank of a 'seq' group differentiates
from its chunk alone (``parallel/sharding.py::leaf_owners``).

The unit phase vector is ``mix / (|mix| + eps)``, as in the JAX package
(not atan2).  Under a profiler the stages are spans
(``danet_tpu_torch/spans.py``): ``danet.stft``, ``danet.features``,
``danet.encoder``, ``danet.estimator``, ``danet.masks`` and
``danet.istft`` on the inference path, and in ``train_loss`` the
encoder, estimator and masks spans and ``danet.loss``.
"""
from __future__ import annotations

import numpy as np
import torch

from danet_tpu_torch import weights
from danet_tpu_torch.hparams import hparams
from danet_tpu_torch.ops import dsp
from danet_tpu_torch.ops import loss as loss_ops
from danet_tpu_torch.ops.cuda import library
from danet_tpu_torch.ops.nn import device_constant
from danet_tpu_torch.spans import span

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
        # a rank's batch mean -> the global batch's: set by a Trainer on a
        # mesh (parallel/collectives.py::mean), for the one term of
        # train_loss that is not a mean over rows (the DC share's scale)
        self.batch_mean = None
        # per leaf, the share of REG_APPLY's gradient this rank keeps: set
        # by a Trainer whose mesh has leaves owned by an axis (reg_loss)
        self.reg_shares = None
        self._check_parallel_support()

    def _check_parallel_support(self):
        """JAX's refusals of a MESH_* axis that the configured encoder has
        no route for (``ValueError``, word for word).  Every MESH_* axis is
        ported (the Trainer's mesh, ``parallel/``), with each encoder JAX
        routes it for."""
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
        if n("MESH_EXPERT") > 1 and not isinstance(
                enc, enc_mod.MoEAttentionEncoder):
            raise ValueError(
                "MESH_EXPERT>1 requires the MoE encoder (moe-v1); got "
                "ENCODER_TYPE=%r" % hp.ENCODER_TYPE)
        if n("MESH_PIPE") > 1 and n("MESH_SEQ") > 1:
            raise ValueError(
                "MESH_PIPE and MESH_SEQ cannot combine (the encoder "
                "routes through one strategy); pick one")

    def seq_leaves(self):
        """The pattern of the leaf names whose gradient each rank of a
        'seq' group computes from its T-chunk alone (the encoder's
        ``SEQ_LEAVES``), or None."""
        if self.encoder.SEQ_LEAVES is None:
            return None
        return "encoder/" + self.encoder.SEQ_LEAVES

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

    def _cdt(self) -> torch.dtype:
        return getattr(torch, getattr(self.hp, "COMPUTE_DTYPE", "float32"))

    def _embed(self, params, logmag, train=False, generator=None):
        """Encoder forward in COMPUTE_DTYPE; -> [B, T, F, E]."""
        with span("danet.encoder"):
            return self.encoder.apply(params["encoder"],
                                      logmag.to(self._cdt()), train=train,
                                      generator=generator)

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
        with span("danet.estimator"):
            attractors = self.train_estimator.apply(
                params.get("train_estimator", {}), embed, src_pwr=src_pwr,
                mix_pwr=mix_pwr)
        with span("danet.masks"):
            sep_pwr = self.separator.apply(
                params.get("separator", {}), mix_pwr, attractors, embed_flat)
        with span("danet.loss"):
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
                # the auxiliary as a share of the primary loss: a scale
                # with no gradient, capped at 1e3
                # (danet_tpu/models/danet.py:211-227), of the global
                # batch's means on a mesh
                gm = self.batch_mean or (lambda v: v)
                scale = torch.clamp(torch.abs(gm(loss.detach()))
                                    / (gm(dc.detach()) + 1e-20), max=1e3)
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
                    params.get("separator", {}), mix_pwr, attr_inf,
                    embed_flat)
                if wave_loss:
                    aux, _, _ = loss_ops.pit_si_snr_loss(wav_src, self._wav(
                        sep_pwr_inf[..., None] * phase_unit[:, None]))
                else:
                    aux, _, _ = loss_ops.pit_mse_loss(src_pwr, sep_pwr_inf)
                loss = loss + aux_w * aux

            if getattr(hp, "REG_APPLY", False) and hp.REG_TYPE is not None:
                loss = loss + reg_loss(params, hp.REG_TYPE, hp.REG_SCALE,
                                       self.reg_shares)
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
        with span("danet.estimator"):
            attractors = self.infer_estimator.apply(
                self._infer_est_params(params), embed, mix_pwr=mix_pwr)
        with span("danet.masks"):
            sep_pwr = self.separator.apply(
                params.get("separator", {}), mix_pwr, attractors, embed_flat)
            return sep_pwr[..., None] * phase_unit[:, None]

    def separate(self, params, mix_ri: torch.Tensor) -> torch.Tensor:
        """Mixture ri spectra [B, T, F, 2] -> separated ri [B, N, T, F, 2]
        (source order arbitrary, as in the reference)."""
        self._check_truth_free()
        with span("danet.features"):
            mix_pwr, logmag, phase_unit = self._mix_features(mix_ri)
        embed = self._embed(params, logmag)
        return self._separate_tail(params, embed, mix_pwr, phase_unit)

    def separate_sp(self, params, mix_ri: torch.Tensor, mesh, halo: int = 32,
                    seq_axis: str = "seq", sp_attn: str = "ring"
                    ) -> torch.Tensor:
        """Sequence-parallel inference over ``mesh``'s ``seq_axis``: [B, T,
        F, 2] -> [B, N, T, F, 2] (JAX ``separate_sp``).

        The encoder runs T-split per its family: bilstm-orig's stack by
        SP_RNN_SCHEME ('relay', exact, or 'halo' with ``halo`` frames;
        ``parallel/seq_parallel.bilstm_stack_sp``), its output gathered
        over the axis before the head; attn-v1 and moe-v1 with the
        sequence-parallel attention ``sp_attn`` ('ring' or 'ulysses',
        which needs ATTN_HEADS divisible by the axis size), the band of
        ATTN_CAUSAL in global positions.  Every rank of the group passes
        the same request and returns the whole answer; the front end, the
        head, the estimator and the masks run alike on each, where JAX's
        GSPMD splits them over T.  Other encoders raise
        NotImplementedError, as in JAX.  Collective over the group."""
        from danet_tpu_torch.models.encoders import (AttentionEncoder,
                                                      BiLstmEncoder,
                                                      _LstmHead, _backend,
                                                      _candidate_activation,
                                                      _centered)
        from danet_tpu_torch.parallel import collectives, seq_parallel
        hp = self.hp
        self._check_truth_free()
        mix_pwr, logmag, phase_unit = self._mix_features(mix_ri)
        enc = params["encoder"]
        if isinstance(self.encoder, AttentionEncoder):
            if sp_attn == "ulysses":
                from danet_tpu_torch.parallel.ulysses import (
                    ulysses_attention as sp_attention)
            else:
                from danet_tpu_torch.parallel.ring_attention import (
                    ring_attention as sp_attention)
            causal_w = self.encoder._causal_window()
            embed = self.encoder.apply(
                enc, logmag.to(self._cdt()),
                attn_fn=lambda q, k, v, km: sp_attention(
                    q, k, v, mesh, seq_axis=seq_axis, key_mask=km,
                    data_axis=None, causal_window=causal_w),
                attn_fn_is_causal=True)
        elif isinstance(self.encoder, BiLstmEncoder):
            x = _centered(logmag.to(self._cdt()))
            layers = [enc[f"lstm{i}"] for i in range(self.encoder.N_LAYERS)]
            h = seq_parallel.bilstm_stack_sp(
                layers, x, mesh, halo=halo, seq_axis=seq_axis,
                candidate_activation=_candidate_activation(hp),
                backend=_backend(hp), data_axis=None,
                scheme=getattr(hp, "SP_RNN_SCHEME", "relay") or "relay")
            h = collectives.leave_gather(mesh, h, seq_axis, 1)
            embed = _LstmHead.apply(enc["output"], hp, h)
        else:
            raise NotImplementedError(
                "separate_sp supports bilstm-orig and attention encoders")
        return self._separate_tail(params, embed, mix_pwr, phase_unit)

    # ------------------------------------------------------------------
    def separate_long(self, params, mix_ri: torch.Tensor,
                      chunk_frames: int = 256,
                      overlap_frames: int = 32) -> torch.Tensor:
        """Long-form separation, [T, F, 2] -> [N, T, F, 2]: overlapping
        chunks of ``chunk_frames`` as ONE ``separate`` batch (the chunk
        axis is the batch axis: with bilstm-orig one kernel B launch per
        layer for all chunks), each chunk's sources permuted to best match
        the previous aligned chunk over the overlap (magnitude MSE; the
        first minimum wins), then a crossfaded overlap-add (a linear ramp
        over the overlap; the first chunk keeps its head, the last its
        tail).  No state spans chunks."""
        hp = self.hp
        t, f = mix_ri.shape[0], mix_ri.shape[1]
        n = hp.MAX_N_SIGNAL
        hop = chunk_frames - overlap_frames
        if hop <= 0 or overlap_frames <= 0:
            raise ValueError(
                "separate_long needs 1 <= overlap_frames < chunk_frames "
                "(alignment + crossfade); got chunk %d, overlap %d"
                % (chunk_frames, overlap_frames))
        ov = overlap_frames
        n_chunks = max(1, -(-(t - ov) // hop))
        t_pad = ov + n_chunks * hop
        mix_p = torch.nn.functional.pad(mix_ri, (0, 0, 0, 0, 0, t_pad - t))
        chunks = mix_p.unfold(0, chunk_frames, hop).permute(0, 3, 1, 2)
        sep = self.separate(params, chunks.contiguous())  # [C, N, W, F, 2]

        # the permutation chain over the overlaps
        perms = device_constant(
            ("perms", n), lambda: loss_ops.permutations_array(n),
            sep.device)                                   # [P, N]
        rows = torch.arange(n, device=sep.device)[None, :]

        def mag(x):
            return torch.sqrt(torch.sum(torch.square(x), dim=-1))

        aligned = [sep[0]]
        tail = mag(sep[0][:, -ov:])                       # [N, V, F]
        for c in range(1, n_chunks):
            head = mag(sep[c][:, :ov])
            cost = torch.mean(torch.square(tail[:, None] - head[None, :]),
                              dim=(2, 3))                 # [N, N]
            best = perms[torch.argmin(torch.sum(cost[rows, perms], dim=1))]
            aligned.append(sep[c][best])
            tail = mag(aligned[-1][:, -ov:])
        aligned = torch.stack(aligned)                    # [C, N, W, F, 2]

        # crossfaded overlap-add, summed in chunk order
        ramp = np.linspace(0.0, 1.0, ov + 2)[1:-1]
        w = np.ones((n_chunks, chunk_frames))
        w[:, :ov] = ramp
        w[:, -ov:] = ramp[::-1]
        w[0, :ov] = 1.0
        w[-1, -ov:] = 1.0
        w = torch.from_numpy(w.astype(np.float32)).to(sep.device)
        contrib = aligned * w.to(sep.dtype)[:, None, :, None, None]
        # frames as the samples of dsp.overlap_add: [N, F 2, C, W]
        contrib = contrib.permute(1, 3, 4, 0, 2).reshape(
            n, f * 2, n_chunks, chunk_frames)
        out = dsp.overlap_add(contrib, hop).reshape(n, f, 2, t_pad)
        den = dsp.overlap_add(w.to(sep.dtype), hop)
        out = out.permute(0, 3, 1, 2) / den[None, :, None, None]
        return out[:, :t]

    # ------------------------------------------------------------------
    def _stream_capable(self) -> bool:
        """True when the encoder streams exactly and causally (the gate of
        separate_stream and stream_init)."""
        from danet_tpu_torch.models import encoders as enc_mod
        hp, enc = self.hp, self.encoder
        if isinstance(enc, (enc_mod.LstmEncoder, enc_mod.GruEncoder)):
            return True
        if isinstance(enc, enc_mod.AttentionEncoder):
            return bool(getattr(hp, "ATTN_CAUSAL", False))
        if isinstance(enc, enc_mod.TcnEncoder):
            return bool(getattr(hp, "TCN_CAUSAL", False))
        if isinstance(enc, enc_mod.DprnnEncoder):
            d = enc._dims()
            return bool(getattr(hp, "DPRNN_INTER_CAUSAL", False)) and (
                d[2] == d[3])
        return False

    def _stream_granularity(self) -> int:
        """Frames per streaming advance (dprnn-v1: DPRNN_CHUNK; else 1)."""
        fn = getattr(self.encoder, "stream_granularity", None)
        return int(fn()) if fn is not None else 1

    def _require_causal(self, method: str, hint: str = "") -> None:
        """JAX's ValueError for an encoder that cannot stream exactly."""
        if not self._stream_capable():
            raise ValueError(
                "%s requires a causal encoder (lstm-orig, gru-v1, "
                "attn-v1/moe-v1 with ATTN_CAUSAL=true, tcn-v1 with "
                "TCN_CAUSAL=true, or dprnn-v1 with DPRNN_INTER_CAUSAL=true "
                "and DPRNN_HOP == DPRNN_CHUNK); got ENCODER_TYPE=%r%s"
                % (method, self.hp.ENCODER_TYPE, hint))
        self._check_truth_free()

    def separate_stream(self, params, mix_ri: torch.Tensor,
                        chunk_frames: int = 64,
                        warmup_frames: int = 128) -> torch.Tensor:
        """Causal online separation, [T, F, 2] -> [N, T, F, 2]: a warm-up
        window, then chunks of ``chunk_frames`` with the encoder's state
        carried across them (JAX's ``lax.scan`` is a loop here), so the
        output does not depend on the chunk size.  The input's and the
        head's centring means and the attractors (the inference estimator)
        are frozen from the warm-up window.  A T that the chunks do not
        divide is padded with zero frames and trimmed."""
        self._require_causal(
            "separate_stream", ". Bidirectional encoders need future "
            "context — use separate_long.")
        g = self._stream_granularity()
        t = mix_ri.shape[0]
        w = int(min(warmup_frames, t))
        w = max(w - w % g, g)
        if w > t:
            raise ValueError(
                "stream too short: the encoder advances in %d-frame "
                "segments but the stream has only %d frames" % (g, t))
        if chunk_frames < 1:
            raise ValueError("chunk_frames must be at least 1, got %d"
                             % chunk_frames)
        if chunk_frames % g:
            raise ValueError(
                "chunk_frames=%d must be a multiple of the encoder's "
                "stream granularity %d (DPRNN_CHUNK)" % (chunk_frames, g))
        n_chunks = -(-(t - w) // chunk_frames) if t > w else 0
        t_pad = w + n_chunks * chunk_frames
        mix_p = torch.nn.functional.pad(
            mix_ri, (0, 0, 0, 0, 0, t_pad - t))[None]
        mix_pwr, logmag, phase_unit = self._mix_features(mix_p)
        cdt, enc = self._cdt(), self.encoder

        # warm-up: the state, the frozen statistics and attractors
        mu_in = torch.mean(logmag[:, :w], dim=(1, 2), keepdim=True)
        state = enc.stream_state_init(1, cdt, mix_ri.device)
        h_w, state = enc.stream_hidden(
            params["encoder"], (logmag[:, :w] - mu_in).to(cdt), state)
        mu_head = torch.mean(h_w, dim=(1, 2), keepdim=True)
        embed_w = enc.stream_head(params["encoder"], h_w, mu_head)
        attractors = self.infer_estimator.apply(
            self._infer_est_params(params), embed_w, mix_pwr=mix_pwr[:, :w])

        def sep_chunk(embed, lo, hi):
            ef = embed.reshape(1, -1, embed.shape[-1])
            sep_pwr = self.separator.apply(params.get("separator", {}),
                                           mix_pwr[:, lo:hi], attractors, ef)
            return sep_pwr[..., None] * phase_unit[:, None, lo:hi]

        outs = [sep_chunk(embed_w, 0, w)]
        for lo in range(w, t_pad, chunk_frames):
            hi = lo + chunk_frames
            h, state = enc.stream_hidden(
                params["encoder"], (logmag[:, lo:hi] - mu_in).to(cdt), state)
            outs.append(sep_chunk(
                enc.stream_head(params["encoder"], h, mu_head), lo, hi))
        return torch.cat(outs, dim=2)[0, :, :t]

    # ------------------------------------------------------------------
    # Waveform streaming: chunks of samples in, separated chunks out, every
    # carried value in the state dict, so that stream_step is a function
    # of (state, chunk).
    def _stream_sep_frames(self, params, mix_ri, logmag, mu_in, mu_head,
                           attractors, enc_state):
        """One chunk's spectral path: frames [B, K, F, 2] -> (separated ri
        [B, N, K, F, 2], mix_pwr, the encoder's new state)."""
        mix_pwr = torch.sqrt(torch.sum(torch.square(mix_ri), dim=-1))
        phase_unit = mix_ri / (mix_pwr[..., None] + self.hp.EPS)
        h, enc_state = self.encoder.stream_hidden(
            params["encoder"], (logmag - mu_in).to(self._cdt()), enc_state)
        embed = self.encoder.stream_head(params["encoder"], h, mu_head)
        ef = embed.reshape(embed.shape[0], -1, embed.shape[-1])
        sep_pwr = self.separator.apply(params.get("separator", {}), mix_pwr,
                                       attractors, ef)
        return sep_pwr[..., None] * phase_unit[:, None], mix_pwr, enc_state

    def stream_init(self, params, wav_warmup: torch.Tensor):
        """Start a causal waveform stream: [B, Lw] -> (separated [B, N, Lw],
        state).  The warm-up window runs through the encoder, and the
        centring means and attractors are frozen from it; Lw is a multiple
        of FFT_STRIDE (and of FFT_STRIDE x DPRNN_CHUNK for dprnn-v1).  The
        state dict holds ``enc`` (the encoder's state), ``stft_tail`` and
        ``ola_tail`` (the streaming STFT's input tail and iSTFT's overlap-
        add numerator), ``mu_in``, ``mu_head`` and ``attractors``.  Output
        lags input by FFT_SIZE - FFT_STRIDE samples."""
        self._require_causal("stream_init")
        hp = self.hp
        fft, stride = hp.FFT_SIZE, hp.FFT_STRIDE
        p = fft - stride
        b, lw = wav_warmup.shape[0], wav_warmup.shape[-1]
        if lw < stride:
            raise ValueError(
                "warmup window must cover at least one frame "
                "(>= FFT_STRIDE=%d samples, got %d)" % (stride, lw))
        g = self._stream_granularity()
        if g > 1 and (lw // stride) % g:
            raise ValueError(
                "the encoder advances in %d-frame segments: the warmup "
                "window must be a multiple of %d samples "
                "(FFT_STRIDE * granularity; got %d samples = %d frames)"
                % (g, g * stride, lw, lw // stride))
        window = hp.FFT_WND_ARRAY
        dev = wav_warmup.device
        frames, stft_tail = dsp.stream_frames(
            torch.zeros((b, p), dtype=wav_warmup.dtype, device=dev),
            wav_warmup, fft, stride)
        mix_ri = dsp.stft_frames_ri(frames, window)       # [B, W, F, 2]
        mix_pwr = torch.sqrt(torch.sum(torch.square(mix_ri), dim=-1))
        logmag = torch.log1p(mix_pwr)
        mu_in = torch.mean(logmag, dim=(1, 2), keepdim=True)
        cdt = self._cdt()
        h, enc_state = self.encoder.stream_hidden(
            params["encoder"], (logmag - mu_in).to(cdt),
            self.encoder.stream_state_init(b, cdt, dev))
        mu_head = torch.mean(h, dim=(1, 2), keepdim=True)
        embed = self.encoder.stream_head(params["encoder"], h, mu_head)
        attractors = self.infer_estimator.apply(
            self._infer_est_params(params), embed, mix_pwr=mix_pwr)
        phase_unit = mix_ri / (mix_pwr[..., None] + hp.EPS)
        sep_pwr = self.separator.apply(
            params.get("separator", {}), mix_pwr, attractors,
            embed.reshape(b, -1, embed.shape[-1]))
        out, ola_tail = dsp.istft_stream_ri(
            sep_pwr[..., None] * phase_unit[:, None], stride, window,
            torch.zeros((b, hp.MAX_N_SIGNAL, p), dtype=torch.float32,
                        device=dev))
        return out, {"enc": enc_state, "stft_tail": stft_tail,
                     "ola_tail": ola_tail, "mu_in": mu_in,
                     "mu_head": mu_head, "attractors": attractors}

    def stream_step(self, params, state: dict, wav_chunk: torch.Tensor):
        """One causal streaming step: (state, [B, Lc]) -> ([B, N, Lc], the
        new state); Lc a multiple of FFT_STRIDE.  The output does not
        depend on the chunk size and lags the input by FFT_SIZE -
        FFT_STRIDE samples."""
        hp = self.hp
        window = hp.FFT_WND_ARRAY
        frames, stft_tail = dsp.stream_frames(
            state["stft_tail"], wav_chunk, hp.FFT_SIZE, hp.FFT_STRIDE)
        mix_ri = dsp.stft_frames_ri(frames, window)
        logmag = torch.log1p(torch.sqrt(torch.sum(torch.square(mix_ri),
                                                  dim=-1)))
        sep_ri, _, enc_state = self._stream_sep_frames(
            params, mix_ri, logmag, state["mu_in"], state["mu_head"],
            state["attractors"], state["enc"])
        out, ola_tail = dsp.istft_stream_ri(sep_ri, hp.FFT_STRIDE, window,
                                            state["ola_tail"])
        return out, dict(state, enc=enc_state, stft_tail=stft_tail,
                         ola_tail=ola_tail)

    def separate_wav(self, params, wav: torch.Tensor) -> torch.Tensor:
        """Waveforms [B, L] -> separated waveforms [B, N, L'],
        L' = num_frames * FFT_STRIDE (the reference's overlap-add length).

        STFT_BACKEND keeps its JAX values: 'auto' and 'pallas' take the
        fused STFT kernel for a CUDA tensor (its plain version on the
        CPU) as the op ``danet::stft_ri``, 'xla' the plain framing +
        matmul path."""
        hp = self.hp
        window = hp.FFT_WND_ARRAY
        be = getattr(hp, "STFT_BACKEND", "auto") or "auto"
        if be not in STFT_BACKENDS:
            raise ValueError("Unknown STFT_BACKEND %r" % (be,))
        with span("danet.stft"):
            if be == "xla":
                mix_ri = dsp.stft_ri(wav, hp.FFT_SIZE, hp.FFT_STRIDE, window)
            else:
                mix_ri = library.stft_ri(wav, hp.FFT_SIZE, hp.FFT_STRIDE,
                                         window)
        sep_ri = self.separate(params, mix_ri)
        with span("danet.istft"):
            return dsp.istft_ri(sep_ri, hp.FFT_STRIDE, window)

    def parameter_count(self, params) -> int:
        return sum(p.numel() for p in weights.leaves(params))


def _num(hp, key: str) -> float:
    return float(getattr(hp, key, 0.0) or 0.0)


def reg_loss(params, reg_type: str, scale: float,
             shares=None) -> torch.Tensor:
    """L1 or L2 regularization over every parameter (REG_APPLY; the
    reference defines it but never adds it, so it is off by default).

    ``shares`` (a Trainer on a mesh sets the model's ``reg_shares``): per
    leaf, the share of its term's gradient this rank keeps, 1 / the size
    of the axis that owns the leaf (``sharding.leaf_owners``), whose
    ranks' gradients are summed where every rank computes this term
    whole; the value stays whole."""
    ps = weights.leaves(params)
    if reg_type == "L2":
        terms = [torch.sum(torch.square(p)) for p in ps]
    elif reg_type == "L1":
        # |p| with JAX's derivative at 0 (+1, where torch.abs gives 0)
        terms = [torch.sum(torch.where(p >= 0, p, -p)) for p in ps]
    else:
        raise ValueError("Unknown REG_TYPE %r" % (reg_type,))
    total = scale * sum(terms)
    if shares is None:
        return total
    kept = scale * sum(t * w for t, w in zip(terms, shares))
    return total.detach() + (kept - kept.detach())
