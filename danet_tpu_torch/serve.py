"""Serving: exported length-bucketed artifacts, and live models that answer
waveform requests or separate a stream chunk by chunk.

Counterpart of ``danet_tpu/serve.py``.  The JAX package exports
``separate_wav`` with ``jax.export`` into StableHLO; here
``torch.export`` captures the same programs into ``.pt2`` files:

  * ``export_separator`` writes one program per waveform-length bucket,
    the parameters baked in as buffers; ``SeparatorBundle`` pads a
    request to the smallest bucket that admits it and trims the result
    back.  Static shapes: a server holds a fixed set of programs, and a
    request whose frame count the encoder would refuse (flash attn-v1
    needs T a multiple of 128, conv-bilstm-v1 of 4) is served at a
    bucket that gives it one.
  * ``export_streamer`` writes the causal stream as two programs,
    ``stream_warmup.pt2`` (``stream_init``) and ``stream_step.pt2``
    (``stream_step``), the state a pytree input and output;
    ``StreamerBundle`` keeps the state on the device between feeds.

The hand kernels are ``torch.library`` ops (``ops/cuda/library.py``), so
an exported graph names them (``danet.stft_ri``, ``danet.bilstm_scan``,
...) and a bundle exported on the card runs them there; one exported on
the CPU runs their plain versions.  A bundle runs on the device type it
was exported for (``manifest["platforms"]``).  Loading one needs no
model code: this module imports ``hparams`` and the models only to build
a live model or to export one.

Layout of an artifact directory (``manifest.json`` has the JAX package's
keys; its ``format`` is this port's, so neither package loads the
other's artifacts):

    manifest.json                 buckets, batch, model/config summary
    sep_<LENGTH>.pt2              ``export_separator``: one per bucket
    stream_warmup.pt2, stream_step.pt2          ``export_streamer``

The live forms run the model eagerly on the card: ``Separator`` runs each
request as it comes (``DaNet.separate_wav``), ``Streamer`` runs
``stream_init`` / ``stream_step``.

Serving runs on one device: every entry here (``load_model``, both live
forms, both exports) drops a training config's MESH_* keys first
(``dense_config``, as ``danet_tpu/serve.py:135-146`` does), so that a
model trained on a mesh serves densely on one card.

CLI (``--device cpu`` for the CPU; the card by default):

    python -m danet_tpu_torch.serve export -c cfg.json -i weights.npz \\
        -o bundle [--lengths 16000,40000,80000] [--weights-dtype bfloat16]
    python -m danet_tpu_torch.serve run -d bundle -if mixture.wav -o prefix
    python -m danet_tpu_torch.serve run -c cfg.json -w weights.npz \\
        -if mixture.wav -o prefix
    python -m danet_tpu_torch.serve export-stream -c cfg.json \\
        -i weights.npz -o stream [--chunk 4096] [--warmup 16384]
    python -m danet_tpu_torch.serve run-stream -d stream -if mixture.wav \\
        -o prefix

``run`` writes ``prefix_0.wav``, ``prefix_1.wav``, ...  Weights (``-i``,
``-w``) are a parameter tree saved by ``danet_tpu_torch.weights.save_npz``
(for example from a JAX session: ``save_npz(path,
jax.device_get(params))``), or a checkpoint directory of the port's
trainer (``train/checkpoint.py``), whose EMA is served when it holds one.

Streaming (a causal model: lstm-orig, gru-v1, attn-v1 / moe-v1 with
ATTN_CAUSAL, tcn-v1 with TCN_CAUSAL, dprnn-v1 with DPRNN_INTER_CAUSAL and
DPRNN_HOP == DPRNN_CHUNK, or tasnet-v1 with TASNET_CAUSAL)::

    s = load_streamer("w.npz", ["cfg.json"], chunk_samples=4096,
                      warmup_samples=16000)       # or load_streamer(dir)
    first = s.start(wav[:16000])                 # [1, N, 16000]
    for i in range(16000, len(wav) - 4095, 4096):
        out = s.feed(wav[i:i + 4096])            # [1, N, 4096]

The output lags the input by ``latency_samples``: FFT_SIZE - FFT_STRIDE
for DaNet, TASNET_WIN - TASNET_STRIDE for tasnet-v1 (the model's
``stream_latency_samples``).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from danet_tpu_torch import weights as weights_lib
from danet_tpu_torch.ops.cuda import library  # noqa: F401  (the ops)
from danet_tpu_torch.spans import span

MANIFEST_NAME = "manifest.json"
SEPARATOR_FORMAT = "danet-tpu-torch-serve-v1"
STREAMER_FORMAT = "danet-tpu-torch-serve-stream-v1"
STREAM_WARMUP_FILE = "stream_warmup.pt2"
STREAM_STEP_FILE = "stream_step.pt2"
_FLOAT_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float32": torch.float32}


def _bucket_file(length: int) -> str:
    return "sep_%d.pt2" % length


def _cast_weights(params: dict, weights_dtype: Optional[str]) -> dict:
    """Floating-point parameters cast to a reduced serving dtype
    (bfloat16 halves an artifact); the model casts each weight to its
    compute dtype where it uses it.  Other leaves pass through."""
    if not weights_dtype:
        return params
    dt = _FLOAT_DTYPES.get(str(weights_dtype))
    if dt is None:
        raise ValueError("weights_dtype must be a float dtype (%s), got %r"
                         % (", ".join(_FLOAT_DTYPES), weights_dtype))
    return {k: _cast_weights(v, weights_dtype) if isinstance(v, dict)
            else v.to(dt) if v.is_floating_point() else v
            for k, v in params.items()}


class _Baked(torch.nn.Module):
    """``fn(params, *inputs)`` as a module whose buffers are the
    parameters, named by their key paths ('/' -> '__')."""

    def __init__(self, fn, params: dict):
        super().__init__()
        self._fn = fn
        self._names = weights_lib.leaf_names(params)
        for name, v in zip(self._names, weights_lib.leaves(params)):
            self.register_buffer(name.replace("/", "__"), v)

    def forward(self, *inputs):
        tree: dict = {}
        for name in self._names:
            *parents, leaf = name.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = getattr(self, name.replace("/", "__"))
        return self._fn(tree, *inputs)


def _export(fn, params: dict, path: str, *inputs) -> None:
    """torch.export ``fn`` with ``params`` baked in, static shapes, no
    gradient; saved to ``path``."""
    with torch.no_grad():
        program = torch.export.export(_Baked(fn, params), inputs,
                                      strict=False)
    torch.export.save(program, path)


def _baked_params(params, device, weights_dtype) -> dict:
    return _cast_weights(weights_lib.from_jax(params, device), weights_dtype)


def _summary(hp, device, weights_dtype) -> dict:
    """The manifest's model keys (the JAX package's)."""
    return {
        "platforms": [torch.device(device).type],
        "n_signal": int(hp.MAX_N_SIGNAL),
        "smprate": int(hp.SMPRATE),
        "fft_size": int(hp.FFT_SIZE),
        "fft_stride": int(hp.FFT_STRIDE),
        "encoder": str(hp.ENCODER_TYPE),
        "infer_estimator": str(hp.INFER_ESTIMATOR_METHOD),
        "separator": str(hp.SEPARATOR_TYPE),
        "weights_dtype": str(weights_dtype or "float32"),
    }


def _write_manifest(out_dir: str, manifest: dict) -> dict:
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return manifest


def _read_manifest(directory: str, fmt: str, what: str) -> dict:
    with open(os.path.join(directory, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    if manifest.get("format") != fmt:
        raise ValueError("not a danet-tpu %s artifact of the PyTorch port: "
                         "%r (format %r)" % (what, directory,
                                             manifest.get("format")))
    return manifest


MESH_KEYS = ("MESH_DATA", "MESH_MODEL", "MESH_PIPE", "MESH_EXPERT",
             "MESH_SEQ")


def dense_config(hp):
    """``hp`` for one device: a copy with every MESH_* key 1 when any is
    above 1, else ``hp`` itself."""
    if all(int(getattr(hp, k, 1) or 1) <= 1 for k in MESH_KEYS):
        return hp
    hp = copy.copy(hp)
    for k in MESH_KEYS:
        setattr(hp, k, 1)
    return hp


def dense_model(model):
    """``model``, rebuilt on ``dense_config`` of its hparams when they
    configure a mesh."""
    hp = dense_config(model.hp)
    return model if hp is model.hp else type(model)(hp, name=model.name)


def export_separator(model, params, out_dir: str, lengths: Sequence[int],
                     batch: int = 1, device="cuda",
                     weights_dtype: Optional[str] = None) -> dict:
    """Export ``model.separate_wav(params, .)`` for each length bucket.

    ``model`` a built model (DaNet or TasNet; its hparams pin the DSP and
    encoder config, and are not changed); ``params`` its parameter tree
    (tensors or numpy), baked into the artifact; ``lengths`` the
    waveform-length buckets in samples; ``batch`` the programs' static
    batch; ``device`` where the programs run ('cuda': the kernels; 'cpu':
    their plain versions); ``weights_dtype`` an optional reduced dtype of
    the baked parameters (``_cast_weights``).  -> the manifest, also
    written to ``out_dir/manifest.json``."""
    lengths = sorted(int(v) for v in lengths)
    model = dense_model(model)
    os.makedirs(out_dir, exist_ok=True)
    params = _baked_params(params, device, weights_dtype)
    for length in lengths:
        _export(model.separate_wav, params,
                os.path.join(out_dir, _bucket_file(length)),
                torch.zeros((batch, length), device=device))
    manifest = dict(_summary(model.hp, device, weights_dtype),
                    format=SEPARATOR_FORMAT, lengths=lengths,
                    batch=int(batch))
    return _write_manifest(out_dir, manifest)


class SeparatorBundle:
    """A loaded separator artifact: the bucket programs and the manifest.

    ``separate(wav)`` zero-pads the request to the smallest bucket that
    admits it, runs that bucket's program and trims the outputs back to
    the request length."""

    def __init__(self, directory: str):
        self.manifest = _read_manifest(directory, SEPARATOR_FORMAT,
                                       "serving")
        self.device = torch.device(self.manifest["platforms"][0])
        self._programs = {
            int(length): torch.export.load(os.path.join(
                directory, _bucket_file(int(length)))).module()
            for length in self.manifest["lengths"]}

    @property
    def lengths(self):
        return sorted(self._programs)

    def _pick_bucket(self, length: int) -> int:
        for cand in self.lengths:
            if cand >= length:
                return cand
        raise ValueError(
            "request length %d exceeds the largest exported bucket %d"
            % (length, self.lengths[-1]))

    @torch.no_grad()
    def separate(self, wav) -> np.ndarray:
        """[L] or [B, L] float waveform -> [N, L] or [B, N, L] float32
        separated sources (a rank-1 request squeezed back)."""
        wav = np.asarray(wav, dtype=np.float32)
        squeeze = wav.ndim == 1
        if squeeze:
            wav = wav[None]
        batch = self.manifest["batch"]
        if wav.shape[0] != batch:
            raise ValueError("artifact was exported with batch=%d, got %d"
                             % (batch, wav.shape[0]))
        length = wav.shape[1]
        bucket = self._pick_bucket(length)
        padded = np.zeros((batch, bucket), dtype=np.float32)
        padded[:, :length] = wav
        out = self._programs[bucket](torch.from_numpy(padded).to(
            self.device))
        out = out[..., :length].cpu().numpy()
        return out[0] if squeeze else out


def stream_timing(model) -> tuple:
    """(granularity, latency) in samples of a model's stream: from its
    ``stream_granularity_samples`` / ``stream_latency_samples`` hooks
    where it has them (tasnet-v1: TASNET_STRIDE, TASNET_WIN -
    TASNET_STRIDE), else the STFT's (FFT_STRIDE, FFT_SIZE - FFT_STRIDE)."""
    hp = model.hp
    gran = getattr(model, "stream_granularity_samples", None)
    stride = int(gran()) if gran else int(hp.FFT_STRIDE)
    lat = getattr(model, "stream_latency_samples", None)
    latency = int(lat()) if lat else int(hp.FFT_SIZE) - int(hp.FFT_STRIDE)
    return stride, latency


def _check_stream_sizes(model, chunk_samples: int,
                        warmup_samples: int) -> tuple:
    stride, latency = stream_timing(model)
    if chunk_samples <= 0 or warmup_samples <= 0 \
            or chunk_samples % stride or warmup_samples % stride:
        raise ValueError(
            "chunk_samples/warmup_samples must be positive multiples of "
            "the stream granularity %d (got %d, %d)"
            % (stride, chunk_samples, warmup_samples))
    return stride, latency


def export_streamer(model, params, out_dir: str, chunk_samples: int,
                    warmup_samples: int, batch: int = 1, device="cuda",
                    weights_dtype: Optional[str] = None) -> dict:
    """Export the causal stream as two programs: the warm-up
    (``stream_init``: [batch, warmup_samples] -> (separated, state)) and
    the step (``stream_step``: (state, [batch, chunk_samples]) ->
    (separated, state)), every carried value in the state pytree.  Both
    sizes are multiples of the stream's granularity (``stream_timing``);
    the step's input size is fixed (constant latency).  -> the
    manifest."""
    model = dense_model(model)
    stride, latency = _check_stream_sizes(model, chunk_samples,
                                          warmup_samples)
    os.makedirs(out_dir, exist_ok=True)
    params = _baked_params(params, device, weights_dtype)
    wav = torch.zeros((batch, warmup_samples), device=device)
    _export(model.stream_init, params,
            os.path.join(out_dir, STREAM_WARMUP_FILE), wav)
    # the step's example state: a warm-up's, run
    with torch.no_grad():
        _, state = model.stream_init(params, wav)
    _export(model.stream_step, params,
            os.path.join(out_dir, STREAM_STEP_FILE), state,
            torch.zeros((batch, chunk_samples), device=device))
    manifest = dict(_summary(model.hp, device, weights_dtype),
                    format=STREAMER_FORMAT, chunk_samples=int(chunk_samples),
                    warmup_samples=int(warmup_samples), batch=int(batch),
                    latency_samples=latency, fft_stride=stride)
    return _write_manifest(out_dir, manifest)


def _rows(wav, n: int, what: str, device) -> torch.Tensor:
    """A waveform [n] or [B, n] as float32 rows on ``device``."""
    x = torch.as_tensor(np.asarray(wav, dtype=np.float32))
    if x.dim() == 1:
        x = x[None]
    if x.dim() != 2 or x.shape[1] != n:
        raise ValueError("%s must be [%d] or [B, %d] samples, got %s"
                         % (what, n, n, tuple(x.shape)))
    return x.to(device)


class StreamerBundle:
    """A loaded stream artifact: ``start(wav_warmup)`` -> [B, N,
    warmup_samples] and ``feed(chunk)`` -> [B, N, chunk_samples], float32
    numpy, the state kept on the device between calls.  The output lags
    the input by ``manifest['latency_samples']`` samples."""

    def __init__(self, directory: str):
        self.manifest = _read_manifest(directory, STREAMER_FORMAT,
                                       "streaming")
        self.device = torch.device(self.manifest["platforms"][0])
        self._warmup = torch.export.load(
            os.path.join(directory, STREAM_WARMUP_FILE)).module()
        self._step = torch.export.load(
            os.path.join(directory, STREAM_STEP_FILE)).module()
        self._state = None

    @property
    def chunk_samples(self) -> int:
        return int(self.manifest["chunk_samples"])

    @property
    def warmup_samples(self) -> int:
        return int(self.manifest["warmup_samples"])

    @property
    def latency_samples(self) -> int:
        return int(self.manifest["latency_samples"])

    @torch.no_grad()
    def start(self, wav_warmup) -> np.ndarray:
        """Start (or restart) the stream on its warm-up window."""
        out, self._state = self._warmup(_rows(
            wav_warmup, self.warmup_samples, "the warm-up", self.device))
        return out.cpu().numpy()

    @torch.no_grad()
    def feed(self, chunk) -> np.ndarray:
        """The separated samples of one chunk, ``latency_samples`` late."""
        if self._state is None:
            raise RuntimeError("call start(warmup) before feed(chunk)")
        out, self._state = self._step(self._state, _rows(
            chunk, self.chunk_samples, "a chunk", self.device))
        return out.cpu().numpy()


class Separator:
    """A built model, its weights on ``device`` and its config: each
    request runs ``separate_wav`` eagerly, as it comes."""

    def __init__(self, model, params: dict, device):
        self.model = dense_model(model)
        self.hp = self.model.hp
        self.device = torch.device(device)
        self.params = weights_lib.from_jax(params, self.device)

    @torch.inference_mode()
    def separate(self, wav) -> np.ndarray:
        """[L] or [B, L] float waveform -> [N, L] or [B, N, L] float32
        separated sources: trimmed to the request length, and squeezed back
        to [N, L] for a rank-1 request, as ``SeparatorBundle.separate``
        returns them.  Profiled, the call is the span ``danet.request``,
        its stages the spans of ``danet_tpu_torch/spans.py``."""
        with span("danet.request"):
            with span("danet.upload"):
                x = torch.as_tensor(np.asarray(wav, dtype=np.float32))
                squeeze = x.dim() == 1
                if squeeze:
                    x = x[None]
                if x.dim() != 2:
                    raise ValueError("expected a waveform [L] or [B, L], "
                                     "got %s" % (tuple(x.shape),))
                x_dev = x.to(self.device)
            out = self.model.separate_wav(self.params, x_dev)
            with span("danet.download"):
                out = out[..., :x.shape[1]].cpu().numpy()
        return out[0] if squeeze else out


class Streamer:
    """The live counterpart of ``StreamerBundle``: holds the stream's
    state on ``device`` and feeds it fixed-size chunks.
    ``start(wav_warmup)`` -> [B, N, warmup_samples] and ``feed(chunk)`` ->
    [B, N, chunk_samples], float32 numpy; a rank-1 waveform is one row.
    The sizes are fixed (constant latency), multiples of the stream's
    granularity (``stream_timing``)."""

    def __init__(self, model, params: dict, device, chunk_samples: int,
                 warmup_samples: int):
        model = dense_model(model)
        _, self.latency_samples = _check_stream_sizes(
            model, chunk_samples, warmup_samples)
        self.model = model
        self.hp = model.hp
        self.device = torch.device(device)
        self.params = weights_lib.from_jax(params, self.device)
        self.chunk_samples = int(chunk_samples)
        self.warmup_samples = int(warmup_samples)
        self._state = None

    @torch.inference_mode()
    def start(self, wav_warmup) -> np.ndarray:
        """Start (or restart) the stream on its warm-up window."""
        out, self._state = self.model.stream_init(
            self.params, _rows(wav_warmup, self.warmup_samples,
                               "the warm-up", self.device))
        return out.cpu().numpy()

    @torch.inference_mode()
    def feed(self, chunk) -> np.ndarray:
        """The separated samples of one chunk, ``latency_samples`` late."""
        if self._state is None:
            raise RuntimeError("call start(warmup) before feed(chunk)")
        out, self._state = self.model.stream_step(
            self.params, self._state,
            _rows(chunk, self.chunk_samples, "a chunk", self.device))
        return out.cpu().numpy()


def load_model(weights: str, config_files: Sequence[str] = ()):
    """default.json + ``config_files`` -> (model, parameters): ``weights``
    a .npz, or a checkpoint directory (its EMA if it holds one, else its
    parameters, checked against the model's)."""
    from danet_tpu_torch.hparams import load_config

    hp = dense_config(load_config(*config_files))
    model = hp.get_model()(hp)
    if os.path.isdir(weights):
        from danet_tpu_torch.train.checkpoint import load_eval_params
        params = load_eval_params(weights, model.init(torch.Generator()))
    else:
        params = weights_lib.load_npz(weights)
    return model, params


def _is_bundle(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MANIFEST_NAME))


def load_separator(path: str, config_files: Sequence[str] = (),
                   device="cuda"):
    """A ``SeparatorBundle`` of the artifact directory ``path`` (one that
    holds a manifest; it runs where it was exported for), else a live
    ``Separator`` on ``device`` of the weights ``path`` (.npz or a
    checkpoint directory) and the config ``load_model`` reads."""
    if _is_bundle(path):
        return SeparatorBundle(path)
    return Separator(*load_model(path, config_files), device)


def load_streamer(path: str, config_files: Sequence[str] = (),
                  chunk_samples: int = 4096, warmup_samples: int = 16000,
                  device="cuda"):
    """A ``StreamerBundle`` of the artifact directory ``path``, else a live
    ``Streamer`` on ``device`` of the weights and config that
    ``load_model`` reads."""
    if _is_bundle(path):
        return StreamerBundle(path)
    model, params = load_model(path, config_files)
    return Streamer(model, params, device, chunk_samples, warmup_samples)


# ---------------------------------------------------------------------------
# CLI: python -m danet_tpu_torch.serve {export,run,export-stream,run-stream}
# ---------------------------------------------------------------------------
def _write_stems(prefix: str, out: np.ndarray, smprate: int) -> None:
    """One WAV per source, with one normalisation shared by all stems:
    their relative levels survive."""
    from danet_tpu_torch.data import audio

    scale = max(float(np.max(np.abs(out))), 1.0)
    for i, src in enumerate(out):
        path = "%s_%d.wav" % (prefix, i)
        audio.save_wav_raw(path, src, smprate, scale=scale)
        print("wrote", path)


def _run_stream(bundle, wav: np.ndarray) -> np.ndarray:
    """A whole waveform through a stream: the warm-up window, then chunks;
    zero-padded to whole chunks, and trimmed to len(wav) + latency (the
    output lags the input, so the last latency samples of content flush
    into the padding)."""
    warm, chunk = bundle.warmup_samples, bundle.chunk_samples
    total = max(len(wav), warm)
    n_chunks = -(-(total - warm) // chunk)
    padded = np.zeros(warm + n_chunks * chunk, dtype=np.float32)
    padded[:len(wav)] = wav
    parts = [bundle.start(padded[:warm])]
    for i in range(n_chunks):
        lo = warm + i * chunk
        parts.append(bundle.feed(padded[lo:lo + chunk]))
    out = np.concatenate(parts, axis=-1)[0]
    return out[..., :len(wav) + bundle.latency_samples]


def _main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m danet_tpu_torch.serve",
        description="export / run separation serving artifacts")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def model_args(p, what):
        p.add_argument("-c", "--config", action="append", default=[],
                       help="config JSON layered over default.json "
                            "(repeatable)")
        p.add_argument("-i", "--input-pfile", required=True,
                       help="%s: .npz parameter tree (weights.save_npz) "
                            "or a checkpoint directory of the trainer"
                            % what)
        p.add_argument("-o", "--out-dir", required=True)
        p.add_argument("--batch", type=int, default=1)
        p.add_argument("--device", default="cuda",
                       help="device the artifact runs on (cuda or cpu)")
        p.add_argument("--weights-dtype", default=None,
                       help="reduced dtype of the baked parameters (e.g. "
                            "'bfloat16': half the artifact size)")

    ex = sub.add_parser("export", help="export a trained model")
    model_args(ex, "weights to export")
    ex.add_argument("--lengths", default="16000,40000,80000",
                    help="comma-separated waveform-length buckets")

    rn = sub.add_parser("run", help="separate one WAV file")
    src = rn.add_mutually_exclusive_group(required=True)
    src.add_argument("-d", "--artifact-dir",
                     help="an artifact of 'export'")
    src.add_argument("-w", "--weights",
                     help="live: .npz parameter tree (weights.save_npz) or "
                          "a checkpoint directory of the trainer")
    rn.add_argument("-c", "--config", action="append", default=[],
                    help="with -w: config JSON layered over default.json "
                         "(repeatable)")
    rn.add_argument("-if", "--input-file", required=True)
    rn.add_argument("-o", "--output-prefix", default="separated")
    rn.add_argument("--device", default="cuda", help="with -w")

    exs = sub.add_parser(
        "export-stream",
        help="export the causal streaming pipeline (a two-program "
             "artifact; needs a causal model)")
    model_args(exs, "weights to export")
    exs.add_argument("--chunk", type=int, default=4096,
                     help="step-program chunk size in samples (a multiple "
                          "of the stream granularity)")
    exs.add_argument("--warmup", type=int, default=16384,
                     help="warm-up program window in samples")

    rs = sub.add_parser(
        "run-stream",
        help="separate a WAV by simulated streaming through a stream "
             "artifact")
    rs.add_argument("-d", "--artifact-dir", required=True)
    rs.add_argument("-if", "--input-file", required=True)
    rs.add_argument("-o", "--output-prefix", default="separated")
    args = ap.parse_args(argv)

    if args.cmd in ("export", "export-stream"):
        model, params = load_model(args.input_pfile, args.config)
        if args.cmd == "export":
            manifest = export_separator(
                model, params, args.out_dir,
                [int(x) for x in args.lengths.split(",")], batch=args.batch,
                device=args.device, weights_dtype=args.weights_dtype)
        else:
            manifest = export_streamer(
                model, params, args.out_dir, chunk_samples=args.chunk,
                warmup_samples=args.warmup, batch=args.batch,
                device=args.device, weights_dtype=args.weights_dtype)
        print(json.dumps(manifest, indent=2, sort_keys=True))
        return

    from danet_tpu_torch.data import audio

    if args.cmd == "run-stream":
        bundle = StreamerBundle(args.artifact_dir)
        smprate = bundle.manifest["smprate"]
        out = _run_stream(bundle, audio.load_wav_raw(args.input_file,
                                                     smprate))
    elif args.artifact_dir:
        bundle = SeparatorBundle(args.artifact_dir)
        smprate = bundle.manifest["smprate"]
        out = bundle.separate(audio.load_wav_raw(args.input_file, smprate))
    else:
        sep = load_separator(args.weights, args.config, args.device)
        smprate = sep.hp.SMPRATE
        out = sep.separate(audio.load_wav_raw(args.input_file, smprate))
    _write_stems(args.output_prefix, out, smprate)


if __name__ == "__main__":
    _main()
