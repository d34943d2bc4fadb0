"""Conv-TasNet (Luo & Mesgarani, TASLP 2019): waveform-domain separation
with a learned filterbank, ``MODEL_TYPE='tasnet-v1'``.

Counterpart of ``danet_tpu/models/tasnet.py:51-499``: ``_frame``,
``_overlap_add`` (``ops/dsp.py::overlap_add``), ``TasNet`` with
``_check_parallel_support``, ``init``, the dense forward
``_separate_wav_padded`` (with its debug taps), the sequence-parallel
forward ``_forward_sp``,
``train_loss`` (MIX_SNR_DB, REG_APPLY), ``valid_metrics`` (EVAL_SI_SNR,
EVAL_SDR), ``separate_wav``, ``separate``, ``parameter_count`` and the
streaming methods (``stream_granularity_samples``,
``stream_latency_samples``, ``stream_state_init``, ``stream_init``,
``stream_step``).  The mixture is framed into TASNET_WIN-sample windows
at hop TASNET_STRIDE, projected on a learned basis (ReLU), layer-normed
and bottlenecked, run through TASNET_BLOCKS x TASNET_REPEATS residual
TCN blocks (``TcnEncoder._block``, dilation 2 ** (i % TASNET_BLOCKS),
RELU_LEAKAGE, TASNET_CAUSAL left padding); a linear head gives one mask
per source and basis vector (TASNET_MASK: 'sigmoid', 'relu' or 'softmax'
over the sources), and the masked features are decoded by a learned
basis and overlap-added.  The basis features and the blocks run in COMPUTE_DTYPE,
the mask head's output, the masks and the decoder in float32.  The
blocks are never rematerialised (the JAX model ignores REMAT too).

The Trainer, checkpoints, the CLI and ``serve.Separator`` use the same
surface as ``DaNet``: batches stay ri spectra [B, N, T, F, 2], inverted to
waveforms by ``dsp.istft_ri`` at the front of ``train_loss`` and
``valid_metrics``; on the wave wire the Trainer's ingest has run kernel A
on the waveforms first.  ``separate`` (spectra in and out) runs the STFT
of the separated waves by STFT_BACKEND as ``DaNet.separate_wav`` does:
kernel A on the card under 'auto' and 'pallas', as the op
``danet::stft_ri``.  The exact causal stream (``stream_init`` /
``stream_step`` with TASNET_CAUSAL, ``danet_tpu/models/tasnet.py:407-496``)
carries the framing's input tail, each block's convolution tail
(``TcnEncoder._block_stream``) and the decoder's overlap-add tail.

Under MESH_SEQ > 1 with a mesh that has the 'seq' axis, the forward runs
sample-sharded (``_forward_sp``, ``danet_tpu/models/tasnet.py:184-282``):
each rank frames its chunk of samples with its right neighbour's (win -
stride)-sample head, runs the TCN through ``seq_parallel.tcn_chunk_sp``
(the convolutions' halos), masks and decodes its frames, and ships its
overlap-add tail to the right neighbour; the waveforms are gathered over
'seq', and the loss, the PIT and the metrics run whole on every rank.
Every leaf's gradient is then the chunk's alone (``seq_leaves``).
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
from danet_tpu_torch.ops.cuda import library

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
        self.reg_shares = None              # as DaNet's (reg_loss)
        self._check_parallel_support()

    def _check_parallel_support(self):
        """JAX's refusal of the mesh axes this model has no route for
        (``ValueError``, word for word); MESH_DATA (the Trainer's mesh)
        and MESH_SEQ (``_forward_sp``) are routed."""
        for key in ("MESH_MODEL", "MESH_PIPE", "MESH_EXPERT"):
            if int(getattr(self.hp, key, 1) or 1) > 1:
                raise ValueError(
                    "MODEL_TYPE='tasnet-v1' supports data parallelism "
                    "and MESH_SEQ only; %s>1 is not routed" % key)

    @staticmethod
    def seq_leaves() -> str:
        """Under MESH_SEQ every leaf's gradient is the rank's chunk's
        alone: the forward is sharded up to the waveforms' gather."""
        return ""

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

    def _forward_sp(self, params, mix_wav, mesh, train: bool = False,
                    generator=None, seq_axis: str = "seq"):
        """The exact sequence-parallel forward (JAX ``_forward_sp``): [B,
        L] (the rows' whole padded mixture, the same on every rank of the
        'seq' group; L a multiple of stride x S) -> [B, N, L], gathered over
        'seq'.  Each rank takes its L / S samples, frames them with the
        (win - stride)-sample head of its right neighbour's chunk (zeros
        at the last rank: the dense forward's zero suffix), runs the TCN
        on its frames (``seq_parallel.tcn_chunk_sp``: each block's
        convolution halos; dropout masks drawn whole, this rank's frames
        kept), masks and decodes them, and adds its left neighbour's (win
        - stride)-sample overlap-add tail to its head.  Collective over the
        'seq' group."""
        from danet_tpu_torch.parallel import collectives, seq_parallel
        hp = self.hp
        d = self._dims()
        win, stride = d["win"], d["stride"]
        overlap = win - stride
        s = mesh.shape[seq_axis]
        length = mix_wav.shape[-1]
        if length % (stride * s):
            raise ValueError(
                "MESH_SEQ=%d needs the padded waveform length %d to "
                "divide by stride*seq = %d" % (s, length, stride * s))
        cdt = getattr(torch, getattr(hp, "COMPUTE_DTYPE", "float32"))
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        last = mix_wav.dim() - 1
        wav = collectives.enter_sharded(mesh, mix_wav, seq_axis, last)
        ext = seq_parallel.with_halos(mesh, wav, seq_axis, last, 0, overlap)
        frames = _frame(ext, win, stride)           # [B, L / S / stride, win]
        feats = torch.relu(nn.mm(frames.to(cdt),
                                 params["enc_basis"].to(cdt)))
        y = nn.layer_norm(params["ln_in"], feats)
        y = seq_parallel.tcn_chunk_sp(
            params, y, mesh,
            [self._dilation(i) for i in range(self._n_blocks())],
            d["kernel"], d["causal"], hp.RELU_LEAKAGE, seq_axis,
            dropout_rng=generator, keep_prob=keep,
            remat=bool(getattr(hp, "REMAT", False)))
        _, sep_frames = self._mask_and_decode(params, feats, y)
        buf = dsp.overlap_add(sep_frames, stride)   # [B, N, L / S + overlap]
        out = buf[..., :buf.shape[-1] - overlap]
        if overlap:
            from_left = collectives.shift_from_left(
                mesh, buf[..., buf.shape[-1] - overlap:], seq_axis)
            out = torch.cat([out[..., :overlap] + from_left,
                             out[..., overlap:]], dim=-1)
        return collectives.leave_gather(mesh, out, seq_axis, out.dim() - 1)

    def _separate_wav_padded(self, params, mix_wav, train: bool = False,
                             generator=None, tap=None):
        """The forward: [B, L] (L a multiple of the stride) -> [B, N, L +
        win - stride] ([B, N, L] on the sequence-parallel route); callers
        trim to the request length.

        Zero-suffix framing: K = L / stride frames of the signal extended
        by win - stride zeros, so that every sample is covered.  With
        ``train``, inverted dropout at DROPOUT_KEEP_PROB after every block,
        drawn from ``generator`` in block order.  ``tap(name, value)``
        receives ``basis_feats``, ``block<i>_h`` and ``masks`` (and runs
        the dense path).  With MESH_SEQ > 1 and a mesh that has the 'seq'
        axis (``encoders._route_mesh``), the sequence-parallel route
        ``_forward_sp``."""
        hp = self.hp
        n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
        if n_seq > 1 and tap is None:
            from danet_tpu_torch.models.encoders import _route_mesh
            mesh = _route_mesh(hp, "seq", n_seq)
            if mesh is not None:
                return self._forward_sp(params, mix_wav, mesh, train=train,
                                        generator=generator)
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
            loss = loss + reg_loss(params, hp.REG_TYPE, hp.REG_SCALE,
                                   self.reg_shares)
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
        stft = dsp.stft_ri if be == "xla" else library.stft_ri
        spec = stft(flat, hp.FFT_SIZE, hp.FFT_STRIDE, window)
        spec = spec.reshape((b, n) + tuple(spec.shape[1:]))
        return spec[:, :, :mix_ri.shape[1]]

    # ------------------------------------------------------------------
    # Exact causal streaming (TASNET_CAUSAL): waveform chunks in, separated
    # chunks out, every carried value in the state dict, the surface of
    # DaNet.stream_init / stream_step (serve.Streamer, export_streamer).
    # The masks are per frame, with no utterance statistics, so the stream
    # is exact: its output is the offline separation of the zero-prefixed
    # stream, delayed by win - stride samples.
    def stream_granularity_samples(self) -> int:
        """Chunk sizes are multiples of the basis stride."""
        return self._dims()["stride"]

    def stream_latency_samples(self) -> int:
        """The output lags the input by the frames' overlap."""
        d = self._dims()
        return d["win"] - d["stride"]

    def _require_causal(self) -> None:
        if not self._dims()["causal"]:
            raise ValueError(
                "TasNet streams only with TASNET_CAUSAL=true (non-causal "
                "dilated convs need future frames)")

    def stream_state_init(self, batch: int, device=None) -> dict:
        """A fresh stream's state, zeros: the input tail of the framing
        (float32), each block's convolution tail (the causal left padding,
        in COMPUTE_DTYPE) and the decoder's overlap-add tail (float32)."""
        self._require_causal()
        d = self._dims()
        cdt = getattr(torch, getattr(self.hp, "COMPUTE_DTYPE", "float32"))
        overlap = d["win"] - d["stride"]
        return {
            "wav_tail": torch.zeros((batch, overlap), device=device),
            "conv_tails": [
                torch.zeros((batch, (d["kernel"] - 1) * self._dilation(i),
                             d["hidden"]), dtype=cdt, device=device)
                for i in range(self._n_blocks())],
            "ola_tail": torch.zeros((batch, self.hp.MAX_N_SIGNAL, overlap),
                                    device=device),
        }

    def stream_init(self, params, wav_warmup: torch.Tensor):
        """Start a stream: [B, Lw] -> (separated [B, N, Lw], state), Lw a
        multiple of TASNET_STRIDE; a step from the zero state (there are
        no statistics to freeze)."""
        self._require_causal()
        return self.stream_step(
            params, self.stream_state_init(wav_warmup.shape[0],
                                           wav_warmup.device), wav_warmup)

    def stream_step(self, params, state: dict, wav_chunk: torch.Tensor):
        """One streaming step: (state, [B, Lc]) -> ([B, N, Lc], the new
        state); Lc a multiple of TASNET_STRIDE.  The output does not depend
        on the chunk size and lags the input by win - stride samples."""
        hp = self.hp
        d = self._dims()
        cdt = getattr(torch, getattr(hp, "COMPUTE_DTYPE", "float32"))
        win, stride = d["win"], d["stride"]
        overlap = win - stride
        lc = wav_chunk.shape[-1]
        if lc % stride:
            raise ValueError(
                "chunk length %d must be a multiple of TASNET_STRIDE=%d"
                % (lc, stride))
        ext = torch.cat([state["wav_tail"], wav_chunk.float()], dim=-1)
        frames = _frame(ext, win, stride)           # [B, Lc / stride, win]
        feats = torch.relu(nn.mm(frames.to(cdt),
                                 params["enc_basis"].to(cdt)))
        y = nn.layer_norm(params["ln_in"], feats)
        y = nn.linear_apply(params["bottleneck"], y)
        tails = []
        for i in range(self._n_blocks()):
            y, tail = TcnEncoder._block_stream(
                params[f"block{i}"], y, self._dilation(i), hp.RELU_LEAKAGE,
                state["conv_tails"][i])
            tails.append(tail)
        _, sep_frames = self._mask_and_decode(params, feats, y)
        buf = dsp.overlap_add(sep_frames, stride)     # [B, N, Lc + overlap]
        buf = torch.cat([buf[..., :overlap] + state["ola_tail"],
                         buf[..., overlap:]], dim=-1)
        return buf[..., :lc], {"wav_tail": ext[..., ext.shape[-1] - overlap:],
                               "conv_tails": tails,
                               "ola_tail": buf[..., lc:]}

    def parameter_count(self, params) -> int:
        return sum(p.numel() for p in weights.leaves(params))
