"""Conv-TasNet (Luo & Mesgarani, TASLP 2019): waveform-domain separation
with a learned filterbank, ``MODEL_TYPE='tasnet-v1'``.

Counterpart of ``danet_tpu/models/tasnet.py:51-405,498``: ``_frame``,
``_overlap_add`` (``ops/dsp.py::overlap_add``), ``TasNet`` with
``_check_parallel_support``, ``init``, the dense forward
``_separate_wav_padded`` (with its debug taps),
``train_loss`` (MIX_SNR_DB, REG_APPLY), ``valid_metrics`` (EVAL_SI_SNR,
EVAL_SDR), ``separate_wav``, ``separate`` and ``parameter_count``.  The
mixture is framed into TASNET_WIN-sample windows at hop TASNET_STRIDE,
projected on a learned basis (ReLU), layer-normed and bottlenecked, run
through TASNET_BLOCKS x TASNET_REPEATS residual TCN blocks
(``TcnEncoder._block``, dilation 2 ** (i % TASNET_BLOCKS), RELU_LEAKAGE,
TASNET_CAUSAL left padding); a linear head gives one mask per source and
basis vector (TASNET_MASK: 'sigmoid', 'relu' or 'softmax' over the
sources), and the masked features are decoded by a learned basis and
overlap-added.  The basis features and the blocks run in COMPUTE_DTYPE,
the mask head's output, the masks and the decoder in float32.  The
blocks are never rematerialised (the JAX model ignores REMAT too).

The Trainer, checkpoints, the CLI and ``serve.Separator`` use the same
surface as ``DaNet``: batches stay ri spectra [B, N, T, F, 2], inverted to
waveforms by ``dsp.istft_ri`` at the front of ``train_loss`` and
``valid_metrics``; on the wave wire the Trainer's ingest has run kernel A
on the waveforms first.  ``separate`` (spectra in and out) runs the STFT
of the separated waves by STFT_BACKEND as ``DaNet.separate_wav`` does:
kernel A on the card under 'auto' and 'pallas'.  Not ported yet: the
streaming methods (``stream_*``, ROADMAP.md queue 1 item 5) and the
MESH_SEQ forward ``_forward_sp`` (item 6).
"""
from __future__ import annotations

import numpy as np
import torch

from danet_tpu_torch import weights
from danet_tpu_torch.hparams import hparams
from danet_tpu_torch.models.danet import STFT_BACKENDS, DaNet, reg_loss
from danet_tpu_torch.models.encoders import TcnEncoder
from danet_tpu_torch.ops import dsp, nn
from danet_tpu_torch.ops import loss as loss_ops
from danet_tpu_torch.ops.cuda import stft as cuda_stft

MASKS = ("sigmoid", "relu", "softmax")


def _frame(x: torch.Tensor, win: int, stride: int) -> torch.Tensor:
    """[..., L] -> [..., K, win] valid framing, K = (L - win) / stride + 1;
    L must satisfy (L - win) % stride == 0 (callers pad)."""
    length = x.shape[-1]
    assert (length - win) % stride == 0, (length, win, stride)
    return x.unfold(-1, win, stride)


@hparams.register_model("tasnet-v1")
class TasNet:
    """Waveform in, waveform out; the Trainer's and the server's model
    surface (``init``, ``train_loss``, ``valid_metrics``, ``separate``,
    ``separate_wav``)."""

    # MIX_SNR_DB's per-source gains, drawn as DaNet draws them
    mix_gain_db = staticmethod(DaNet.mix_gain_db)

    def __init__(self, hp=None, name: str = "tasnet"):
        hp = hp if hp is not None else hparams
        self.hp = hp
        self.name = name
        self._check_parallel_support()

    def _check_parallel_support(self):
        """JAX's refusal of the mesh axes this model has no route for
        (``ValueError``, word for word); then NotImplementedError for the
        two it has, data parallelism and MESH_SEQ: the port runs on one
        device."""
        def n(key):
            return int(getattr(self.hp, key, 1) or 1)

        for key in ("MESH_MODEL", "MESH_PIPE", "MESH_EXPERT"):
            if n(key) > 1:
                raise ValueError(
                    "MODEL_TYPE='tasnet-v1' supports data parallelism "
                    "and MESH_SEQ only; %s>1 is not routed" % key)
        for key in ("MESH_DATA", "MESH_SEQ"):
            if n(key) > 1:
                raise NotImplementedError(
                    "%s > 1 is not ported for tasnet-v1: the port runs on "
                    "one device (ROADMAP.md, queue 1 item 6)" % key)

    def _dims(self) -> dict:
        hp = self.hp

        def get(key, default):
            v = getattr(hp, key, None)
            return default if v is None else int(v)

        return {
            "n_basis": get("TASNET_FILTERS", 512),
            "win": get("TASNET_WIN", 16),
            "stride": get("TASNET_STRIDE", 8),
            "bottleneck": get("TASNET_BOTTLENECK", 128),
            "hidden": get("TASNET_HIDDEN", 512),
            "kernel": get("TASNET_KERNEL", 3),
            "x_blocks": get("TASNET_BLOCKS", 8),
            "repeats": get("TASNET_REPEATS", 3),
            "causal": bool(getattr(hp, "TASNET_CAUSAL", False)),
            "mask": str(getattr(hp, "TASNET_MASK", "sigmoid") or "sigmoid"),
        }

    def _n_blocks(self) -> int:
        d = self._dims()
        return d["x_blocks"] * d["repeats"]

    def _dilation(self, i: int) -> int:
        return 2 ** (i % self._dims()["x_blocks"])

    def check_train_config(self) -> None:
        """Raise ValueError for a TASNET_MASK the forward does not know (the
        JAX model raises it at its first forward)."""
        mask = self._dims()["mask"]
        if mask not in MASKS:
            raise ValueError("Unknown TASNET_MASK %r" % (mask,))

    def init(self, generator: torch.Generator, device=None) -> dict:
        """Random parameters with the JAX package's layout: the bases at
        1/sqrt(fan_in), glorot-uniform linears, unit layer norms."""
        d = self._dims()
        nb, win, bd, h, k = (d["n_basis"], d["win"], d["bottleneck"],
                             d["hidden"], d["kernel"])

        def ln(width):
            return {"g": torch.ones(width, device=device),
                    "b": torch.zeros(width, device=device)}

        params = {
            "enc_basis": nn.uniform_init(generator, (win, nb),
                                         1.0 / np.sqrt(win), device),
            "dec_basis": nn.uniform_init(generator, (nb, win),
                                         1.0 / np.sqrt(nb), device),
            "ln_in": ln(nb),
            "bottleneck": nn.linear_init(generator, nb, bd, device=device),
            "mask_head": nn.linear_init(generator, bd,
                                        self.hp.MAX_N_SIGNAL * nb,
                                        device=device),
        }
        for i in range(self._n_blocks()):
            params[f"block{i}"] = {
                "ln1": ln(bd),
                "in": nn.linear_init(generator, bd, h, device=device),
                "dconv": nn.conv1d_depthwise_init(generator, h, k,
                                                  device=device),
                "ln2": ln(h),
                "out": nn.linear_init(generator, h, bd, device=device),
            }
        return params

    # ------------------------------------------------------------------
    def _pad_len(self, length: int) -> int:
        """The length padded to a multiple of the stride (at least one
        stride), which the zero-suffix framing divides evenly."""
        stride = self._dims()["stride"]
        length = max(length, stride)
        return length + (-length) % stride

    def _mask_and_decode(self, params, feats, y):
        """TCN output y [B, K, bottleneck] -> (masks [B, N, K, nb], decoded
        frames [B, N, K, win]), in float32."""
        d = self._dims()
        b, k = y.shape[0], y.shape[1]
        dt = nn.acc_dtype(y)                # float32 (float64 in float64)
        logits = nn.linear_apply(params["mask_head"], y).to(dt)
        logits = logits.reshape(b, k, self.hp.MAX_N_SIGNAL, d["n_basis"])
        if d["mask"] == "sigmoid":
            masks = torch.sigmoid(logits)
        elif d["mask"] == "relu":
            masks = torch.relu(logits)
        elif d["mask"] == "softmax":
            masks = torch.softmax(logits, dim=2)          # over the sources
        else:
            raise ValueError("Unknown TASNET_MASK %r" % (d["mask"],))
        masks = torch.movedim(masks, 2, 1)                # [B, N, K, nb]
        sep_feats = feats.to(dt)[:, None] * masks
        return masks, nn.mm(sep_feats, params["dec_basis"].to(dt))

    def _separate_wav_padded(self, params, mix_wav, train: bool = False,
                             generator=None, tap=None):
        """The forward: [B, L] (L a multiple of the stride) -> [B, N, L +
        win - stride]; callers trim to the request length.

        Zero-suffix framing: K = L / stride frames of the signal extended
        by win - stride zeros, so that every sample is covered.  With
        ``train``, inverted dropout at DROPOUT_KEEP_PROB after every block,
        drawn from ``generator`` in block order.  ``tap(name, value)``
        receives ``basis_feats``, ``block<i>_h`` and ``masks``."""
        hp = self.hp
        d = self._dims()
        cdt = getattr(torch, getattr(hp, "COMPUTE_DTYPE", "float32"))
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        overlap = d["win"] - d["stride"]
        ext = torch.nn.functional.pad(mix_wav, (0, overlap))
        frames = _frame(ext, d["win"], d["stride"])       # [B, K, win]
        feats = torch.relu(nn.mm(frames.to(cdt),
                                 params["enc_basis"].to(cdt)))
        if tap:
            tap("basis_feats", feats)
        y = nn.layer_norm(params["ln_in"], feats)
        y = nn.linear_apply(params["bottleneck"], y)
        for i in range(self._n_blocks()):
            y = TcnEncoder._block(params[f"block{i}"], y, self._dilation(i),
                                  d["causal"], hp.RELU_LEAKAGE)
            if generator is not None:
                y = nn.dropout(generator, y, keep)
            if tap:
                tap("block%d_h" % i, y)
        masks, sep_frames = self._mask_and_decode(params, feats, y)
        if tap:
            tap("masks", masks)
        # the plain sum: the decoder basis is learned, so no window
        # normalisation; deterministic on the card
        return dsp.overlap_add(sep_frames, d["stride"])  # [B, N, L']

    def _pad(self, wav: torch.Tensor) -> torch.Tensor:
        length = wav.shape[-1]
        return torch.nn.functional.pad(wav, (0, self._pad_len(length)
                                             - length))

    # ------------------------------------------------------------------
    def _src_wavs(self, src_ri: torch.Tensor) -> torch.Tensor:
        """Per-source waveforms of ri spectra: [B, N, T, F, 2] -> [B, N,
        T * FFT_STRIDE]."""
        return dsp.istft_ri(src_ri, self.hp.FFT_STRIDE,
                            self.hp.FFT_WND_ARRAY)

    def _pit(self, wav_src, sep):
        """(uPIT negative SI-SNR, the separated waves in the sources'
        order, the permutation indices)."""
        loss, perms, perm_idx = loss_ops.pit_si_snr_loss(wav_src, sep)
        return loss, loss_ops.unpermute(sep, perms, perm_idx), perm_idx

    def train_loss(self, params, src_ri: torch.Tensor,
                   generator: torch.Generator = None):
        """uPIT negative SI-SNR of the separated waveforms -> (loss, {"snr",
        "perm_idx"}); ``generator`` draws the blocks' dropout and
        MIX_SNR_DB's per-source gains (none without it)."""
        self.check_train_config()
        hp = self.hp
        wav_src = self._src_wavs(src_ri)                  # [B, N, Lw]
        mix_db = float(getattr(hp, "MIX_SNR_DB", 0.0) or 0.0)
        if mix_db > 0.0 and generator is not None:
            db = self.mix_gain_db(wav_src.shape[:2] + (1,), mix_db,
                                  generator)
            wav_src = wav_src * (10.0 ** (db.to(wav_src.device) / 20.0)).to(
                wav_src.dtype)
        length = wav_src.shape[-1]
        mix = self._pad(torch.sum(wav_src, dim=1))
        sep = self._separate_wav_padded(params, mix, train=True,
                                        generator=generator)[..., :length]
        loss, sep_pit, perm_idx = self._pit(wav_src, sep)
        snr = torch.mean(loss_ops.batch_snr(wav_src, sep_pit, eps=hp.EPS))
        if getattr(hp, "REG_APPLY", False) and hp.REG_TYPE is not None:
            loss = loss + reg_loss(params, hp.REG_TYPE, hp.REG_SCALE)
        return loss, {"snr": snr, "perm_idx": perm_idx}

    def valid_metrics(self, params, src_ri: torch.Tensor) -> dict:
        """The uPIT negative SI-SNR (this family's loss, not comparable to
        DaNet's spectral MSE) and the SNR of the waveforms; with
        EVAL_SI_SNR the SI-SNR, with EVAL_SDR BSS-eval's SDR, SIR and SAR
        (BSS_FILT_LEN taps)."""
        hp = self.hp
        wav_src = self._src_wavs(src_ri)
        length = wav_src.shape[-1]
        sep = self._separate_wav_padded(
            params, self._pad(torch.sum(wav_src, dim=1)))[..., :length]
        loss, sep_pit, _ = self._pit(wav_src, sep)
        out = {"loss": loss,
               "SNR": torch.mean(loss_ops.batch_snr(wav_src, sep_pit,
                                                    eps=hp.EPS))}
        if getattr(hp, "EVAL_SI_SNR", False):
            out["SI_SNR"] = torch.mean(loss_ops.si_snr(wav_src, sep_pit))
        if getattr(hp, "EVAL_SDR", False):
            bss = loss_ops.bss_eval_sources(
                wav_src, sep_pit,
                filt_len=int(getattr(hp, "BSS_FILT_LEN", 512)))
            out.update(SDR=torch.mean(bss["sdr"]), SIR=torch.mean(bss["sir"]),
                       SAR=torch.mean(bss["sar"]))
        return out

    # ------------------------------------------------------------------
    def separate_wav(self, params, wav: torch.Tensor) -> torch.Tensor:
        """Mixture waveforms [B, L] -> separated waveforms [B, N, L] (source
        order arbitrary)."""
        length = wav.shape[-1]
        return self._separate_wav_padded(params, self._pad(wav))[..., :length]

    def separate(self, params, mix_ri: torch.Tensor) -> torch.Tensor:
        """Mixture ri spectra [B, T, F, 2] -> separated ri spectra [B, N,
        T, F, 2]: iSTFT, ``separate_wav``, then the STFT by STFT_BACKEND
        ('auto' and 'pallas': kernel A on a CUDA tensor, its plain version
        on the CPU; 'xla': the plain framing and matmul)."""
        hp = self.hp
        be = getattr(hp, "STFT_BACKEND", "auto") or "auto"
        if be not in STFT_BACKENDS:
            raise ValueError("Unknown STFT_BACKEND %r" % (be,))
        window = hp.FFT_WND_ARRAY
        sep = self.separate_wav(params, dsp.istft_ri(mix_ri, hp.FFT_STRIDE,
                                                     window))
        b, n, length = sep.shape
        flat = sep.reshape(b * n, length).contiguous()
        stft = dsp.stft_ri if be == "xla" else cuda_stft.stft_ri
        spec = stft(flat, hp.FFT_SIZE, hp.FFT_STRIDE, window)
        spec = spec.reshape((b, n) + tuple(spec.shape[1:]))
        return spec[:, :, :mix_ri.shape[1]]

    def parameter_count(self, params) -> int:
        return sum(p.numel() for p in weights.leaves(params))
