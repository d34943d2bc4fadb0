"""Serving: a loaded separator that answers waveform requests, and a live
streamer that separates a stream chunk by chunk.

Counterpart of the request path of ``danet_tpu/serve.py:184-239,515-528``
and of ``StreamerBundle`` (``:329-386``).
The JAX package serves ``jax.export`` artifacts with length buckets; here
the model runs eagerly on the card (``DaNet.separate_wav``: fused STFT
kernel, the encoder -- a recurrent scan kernel per layer, or with attn-v1
and ATTN_BACKEND 'flash' a flash-attention kernel per block, which needs
T = L / FFT_STRIDE + 1 a multiple of 128 -- attractors, masks, iSTFT), and
``torch.export`` artifacts are later work.

CLI:

    python -m danet_tpu_torch.serve run -c cfg.json -w weights.npz \\
        -if mixture.wav -o prefix [--device cuda]

writes ``prefix_0.wav``, ``prefix_1.wav``, ...  ``-w`` is a parameter
tree saved by ``danet_tpu_torch.weights.save_npz`` (for example from a JAX
session: ``save_npz(path, jax.device_get(params))``), or a checkpoint
directory of the port's trainer (``train/checkpoint.py``), whose EMA is
served when it holds one.

Streaming (a causal encoder: lstm-orig, gru-v1, attn-v1 / moe-v1 with
ATTN_CAUSAL, tcn-v1 with TCN_CAUSAL, dprnn-v1 with DPRNN_INTER_CAUSAL and
DPRNN_HOP == DPRNN_CHUNK)::

    s = load_streamer("w.npz", ["cfg.json"], chunk_samples=4096,
                      warmup_samples=16000)
    first = s.start(wav[:16000])                 # [1, N, 16000]
    for i in range(16000, len(wav) - 4095, 4096):
        out = s.feed(wav[i:i + 4096])            # [1, N, 4096]

Each call runs ``DaNet.stream_init`` / ``stream_step`` on the card; the
output lags the input by ``latency_samples`` (FFT_SIZE - FFT_STRIDE).
"""
from __future__ import annotations

import argparse
import os
from typing import Sequence

import numpy as np
import torch

from danet_tpu_torch import weights as weights_lib
from danet_tpu_torch.hparams import load_config


class Separator:
    """A built model, its weights on ``device`` and its config."""

    def __init__(self, model, params: dict, device):
        self.model = model
        self.hp = model.hp
        self.device = torch.device(device)
        self.params = weights_lib.from_jax(params, self.device)

    @torch.inference_mode()
    def separate(self, wav) -> np.ndarray:
        """[L] or [B, L] float waveform -> [N, L] or [B, N, L] float32
        separated sources: trimmed to the request length, and squeezed back
        to [N, L] for a rank-1 request, as the JAX package's
        ``SeparatorBundle.separate`` returns them."""
        x = torch.as_tensor(np.asarray(wav, dtype=np.float32))
        squeeze = x.dim() == 1
        if squeeze:
            x = x[None]
        if x.dim() != 2:
            raise ValueError("expected a waveform [L] or [B, L], got %s"
                             % (tuple(x.shape),))
        out = self.model.separate_wav(self.params, x.to(self.device))
        out = out[..., :x.shape[1]].cpu().numpy()
        return out[0] if squeeze else out


class Streamer:
    """The live counterpart of the JAX package's ``StreamerBundle``: holds
    the stream's state on ``device`` and feeds it fixed-size chunks.
    ``start(wav_warmup)`` -> [B, N, warmup_samples] and ``feed(chunk)`` ->
    [B, N, chunk_samples], float32 numpy; a rank-1 waveform is one row.
    The sizes are fixed (constant latency), multiples of FFT_STRIDE."""

    def __init__(self, model, params: dict, device, chunk_samples: int,
                 warmup_samples: int):
        hp = model.hp
        stride = int(hp.FFT_STRIDE)
        if chunk_samples <= 0 or warmup_samples <= 0 \
                or chunk_samples % stride or warmup_samples % stride:
            raise ValueError(
                "chunk_samples/warmup_samples must be positive multiples of "
                "the stream granularity %d (got %d, %d)"
                % (stride, chunk_samples, warmup_samples))
        self.model = model
        self.hp = hp
        self.device = torch.device(device)
        self.params = weights_lib.from_jax(params, self.device)
        self.chunk_samples = int(chunk_samples)
        self.warmup_samples = int(warmup_samples)
        self.latency_samples = int(hp.FFT_SIZE) - stride
        self._state = None

    def _rows(self, wav, n: int, what: str) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(wav, dtype=np.float32))
        if x.dim() == 1:
            x = x[None]
        if x.dim() != 2 or x.shape[1] != n:
            raise ValueError("%s must be [%d] or [B, %d] samples, got %s"
                             % (what, n, n, tuple(x.shape)))
        return x.to(self.device)

    @torch.inference_mode()
    def start(self, wav_warmup) -> np.ndarray:
        """Start (or restart) the stream on its warm-up window."""
        out, self._state = self.model.stream_init(
            self.params, self._rows(wav_warmup, self.warmup_samples,
                                    "the warm-up"))
        return out.cpu().numpy()

    @torch.inference_mode()
    def feed(self, chunk) -> np.ndarray:
        """The separated samples of one chunk, ``latency_samples`` late."""
        if self._state is None:
            raise RuntimeError("call start(warmup) before feed(chunk)")
        out, self._state = self.model.stream_step(
            self.params, self._state,
            self._rows(chunk, self.chunk_samples, "a chunk"))
        return out.cpu().numpy()


def _load(weights: str, config_files: Sequence[str]):
    """default.json + ``config_files`` -> (model, parameters): ``weights``
    a .npz, or a checkpoint directory (its EMA if it holds one, else its
    parameters, checked against the model's)."""
    hp = load_config(*config_files)
    model = hp.get_model()(hp)
    if os.path.isdir(weights):
        from danet_tpu_torch.train.checkpoint import load_eval_params
        params = load_eval_params(weights, model.init(torch.Generator()))
    else:
        params = weights_lib.load_npz(weights)
    return model, params


def load_separator(weights: str, config_files: Sequence[str] = (),
                   device="cuda") -> Separator:
    """A ``Separator`` of the model and weights ``_load`` reads, on
    ``device``."""
    return Separator(*_load(weights, config_files), device)


def load_streamer(weights: str, config_files: Sequence[str] = (),
                  chunk_samples: int = 4096, warmup_samples: int = 16000,
                  device="cuda") -> Streamer:
    """A ``Streamer`` of the model and weights ``_load`` reads, on
    ``device``."""
    model, params = _load(weights, config_files)
    return Streamer(model, params, device, chunk_samples, warmup_samples)


def _main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m danet_tpu_torch.serve")
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="separate one WAV file")
    run.add_argument("-c", "--config", action="append", default=[],
                     help="config JSON layered over default.json "
                          "(repeatable)")
    run.add_argument("-w", "--weights", required=True,
                     help=".npz parameter tree (weights.save_npz) or a "
                          "checkpoint directory of the trainer")
    run.add_argument("-if", "--input-file", required=True)
    run.add_argument("-o", "--output-prefix", required=True)
    run.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from danet_tpu_torch.data import audio

    sep = load_separator(args.weights, args.config, args.device)
    wav = audio.load_wav_raw(args.input_file, sep.hp.SMPRATE)
    out = sep.separate(wav)
    # one shared normalization across all stems keeps relative levels
    scale = max(float(np.max(np.abs(out))), 1.0)
    for i, src in enumerate(out):
        path = "%s_%d.wav" % (args.output_prefix, i)
        audio.save_wav_raw(path, src, sep.hp.SMPRATE, scale=scale)
        print("wrote", path)


if __name__ == "__main__":
    _main()
