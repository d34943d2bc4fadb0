"""Serving: a loaded separator that answers waveform requests.

Counterpart of the request path of ``danet_tpu/serve.py:184-239,515-528``.
The JAX package serves ``jax.export`` artifacts with length buckets; here
the model runs eagerly on the card (``DaNet.separate_wav``: fused STFT
kernel, the encoder -- a recurrent scan kernel per layer, or with attn-v1
and ATTN_BACKEND 'flash' a flash-attention kernel per block, which needs
T = L / FFT_STRIDE + 1 a multiple of 128 -- attractors, masks, iSTFT), and
``torch.export`` artifacts are later work.

CLI:

    python -m danet_tpu_torch.serve run -c cfg.json -w weights.npz \\
        -if mixture.wav -o prefix [--device cuda]

writes ``prefix_0.wav``, ``prefix_1.wav``, ...  ``weights.npz`` is a
parameter tree saved by ``danet_tpu_torch.weights.save_npz`` (for example
from a JAX session: ``save_npz(path, jax.device_get(params))``).
"""
from __future__ import annotations

import argparse
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


def load_separator(weights: str, config_files: Sequence[str] = (),
                   device="cuda") -> Separator:
    """default.json + ``config_files`` -> model; ``weights`` (.npz) ->
    parameters on ``device``."""
    hp = load_config(*config_files)
    model = hp.get_model()(hp)
    return Separator(model, weights_lib.load_npz(weights), device)


def _main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m danet_tpu_torch.serve")
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="separate one WAV file")
    run.add_argument("-c", "--config", action="append", default=[],
                     help="config JSON layered over default.json "
                          "(repeatable)")
    run.add_argument("-w", "--weights", required=True,
                     help=".npz parameter tree (weights.save_npz)")
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
