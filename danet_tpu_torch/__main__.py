"""The port's command line, the counterpart of ``main.py``:

    python -m danet_tpu_torch -m train -ds toy -ne 2 -o saves/run --device cpu
    python -m danet_tpu_torch -m test -ds toy -i saves/run
    python -m danet_tpu_torch -m demo -i saves/run [-if mixture.wav]

Modes: ``train``, ``valid``, ``test``, ``demo``, ``debug`` and
``interactive``; flags ``-n -m -i -o -c -ne --no-save-on-epoch
--no-valid-on-epoch -if -ds -lr -tl -bs --seed`` as ``main.py`` has them,
plus ``--device`` (the card unless ``cpu`` is asked for) and ``--set
KEY=VALUE``.  Configs layer as in ``main.py``: default.json, then each
``-c`` file, then the flags, then ``--set``.

``-i`` restores a checkpoint (``train/checkpoint.py``); a resumed ``-m
train`` keeps the checkpoint's learning rate unless ``-lr`` is given.
``-o`` saves the trained state.  ``valid`` and ``test`` print one sweep's
mean metrics.  ``demo`` separates ``-if`` (or a test mixture it writes to
``demo.wav``) into ``*_separated_<i>.wav``; ``debug`` writes one test
batch's inputs, encoder activations, embeddings, attractors, masks and
outputs to ``debug/debug_data.mat``; ``interactive`` builds everything and
returns, for ``python -i -m danet_tpu_torch -m interactive``, with the
module's ``g_args``, ``g_model``, ``g_trainer``, ``g_state`` and
``g_dataset`` set.  Demo and debug run at BATCH_SIZE 1.

``--stream`` (and ``--stream-chunk``, ``--stream-warmup``) and demo with
DEMO_CHUNK_FRAMES > 0 need ``DaNet.separate_stream`` / ``separate_long``,
which are not ported (ROADMAP.md, queue 1 item 5): they raise
NotImplementedError.  The debug mode's waveform-model branch (MODEL_TYPE
tasnet-v1) waits for that model's port.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

import danet_tpu_torch  # noqa: F401  (populates the registries)
from danet_tpu_torch.data import audio
from danet_tpu_torch.hparams import apply_overrides, load_config
from danet_tpu_torch.train.trainer import Trainer
from danet_tpu_torch.weights import leaves

STREAM_TODO = ("not ported: it needs DaNet.separate_stream / "
               "separate_long, long-form and streaming inference "
               "(ROADMAP.md, queue 1 item 5)")

g_args = None
g_hp = None
g_model = None
g_trainer = None
g_state = None
g_dataset = None


def build_argparser(prog: str = "python -m danet_tpu_torch"):
    parser = argparse.ArgumentParser(prog=prog)
    parser.add_argument("-n", "--name", default="UnnamedExperiment",
                        help="name of experiment, affects checkpoint saves")
    parser.add_argument("-m", "--mode", default="train",
                        help='Mode: "train", "valid", "test", "demo", '
                             '"debug" or "interactive"')
    parser.add_argument("-i", "--input-pfile",
                        help="path to input model parameter file")
    parser.add_argument("-o", "--output-pfile",
                        help="path to output model parameters file")
    parser.add_argument("-c", "--hparams-file", action="append", default=[],
                        help="hyperparameters (config) JSON file, layered "
                             "over default.json (repeatable)")
    parser.add_argument("-ne", "--num-epoch", type=int, default=10,
                        help="number of training epochs")
    parser.add_argument("--no-save-on-epoch", action="store_true",
                        help="don't save parameters after each epoch")
    parser.add_argument("--no-valid-on-epoch", action="store_true",
                        help="don't sweep validation set after each epoch")
    parser.add_argument("-if", "--input-file",
                        help='input WAV file for "demo" mode')
    parser.add_argument("-ds", "--dataset",
                        help="dataset to use, overrides hparams.DATASET_TYPE")
    parser.add_argument("-lr", "--learn-rate",
                        help="learn rate, overrides hparams.LR")
    parser.add_argument("-tl", "--train-length",
                        help="training segment length, overrides "
                             "hparams.MAX_TRAIN_LEN")
    parser.add_argument("-bs", "--batch-size",
                        help="batch size, overrides hparams.BATCH_SIZE")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights, dropout and data")
    parser.add_argument("--set", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="override one config key (JSON-typed value; "
                             "repeatable)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: the card)")
    parser.add_argument("--stream", action="store_true",
                        help='"demo" mode: causal online separation '
                             "(not ported)")
    parser.add_argument("--stream-chunk", type=int, default=64,
                        help="--stream: frames per streaming chunk")
    parser.add_argument("--stream-warmup", type=int, default=128,
                        help="--stream: warmup frames")
    return parser


def load_hparams(args):
    """default.json, the -c files, the flags, then --set; digested."""
    overrides = {}
    for flag, key, cast, least in (("learn_rate", "LR", float, 0.0),
                                   ("train_length", "MAX_TRAIN_LEN", int, 2),
                                   ("batch_size", "BATCH_SIZE", int, 1)):
        value = getattr(args, flag)
        if value is not None:
            overrides[key] = cast(value)
            if overrides[key] < least:
                raise ValueError("%s=%s: must be at least %s"
                                 % (key, value, least))
    if args.dataset is not None:
        overrides["DATASET_TYPE"] = args.dataset
    hp = load_config(*args.hparams_file, **overrides)
    apply_overrides(hp, args.set)
    hp.digest()
    return hp


def _draw_test_mixture(hp, dataset, shuffle=False):
    """N test utterances, zero-padded at random to one length (a multiple
    of LENGTH_ALIGN): [N, T, F]."""
    for data_pt in dataset.epoch("test", hp.MAX_N_SIGNAL, shuffle=shuffle):
        break
    sigs = data_pt[0]
    max_len = max(len(x) for x in sigs)
    max_len += (-max_len) % hp.LENGTH_ALIGN
    return np.stack([
        audio.random_zeropad(x, max_len - len(x), -2, dataset.rand)
        for x in sigs])


def run_demo(args):
    hp = g_hp
    if args.stream:
        raise NotImplementedError("--stream is " + STREAM_TODO)
    if int(getattr(hp, "DEMO_CHUNK_FRAMES", 0) or 0) > 0:
        raise NotImplementedError("demo with DEMO_CHUNK_FRAMES > 0 is "
                                  + STREAM_TODO)
    window = hp.FFT_WND_ARRAY
    if args.input_file is None:
        filename = "demo.wav"
        raw_mixture = np.sum(_draw_test_mixture(hp, g_dataset), axis=0)
        audio.save_wavfile(filename, raw_mixture, hp.SMPRATE,
                           hp.FFT_STRIDE, window)
        print("Mixture written to %s" % filename)
    else:
        filename = args.input_file
        raw_mixture = audio.load_wavfile(filename, hp.SMPRATE, hp.FFT_SIZE,
                                         hp.FFT_STRIDE, window)
        pad = (-len(raw_mixture)) % hp.LENGTH_ALIGN
        if pad:
            raw_mixture = np.pad(raw_mixture, [(0, pad), (0, 0)])
    sep_ri = g_trainer.separate(g_state, audio.to_ri(raw_mixture[None]))
    signals = audio.from_ri(sep_ri[0])                # [N, T, F] complex
    base, ext = os.path.splitext(filename)
    for i, s in enumerate(signals):
        out = base + ("_separated_%d" % (i + 1)) + (ext or ".wav")
        audio.save_wavfile(out, s, hp.SMPRATE, hp.FFT_STRIDE, window)
        print("Separated source written to %s" % out)
    if "DISPLAY" not in os.environ:
        print("Warning: no display found, not generating plot")
        return
    from colorsys import hsv_to_rgb
    import matplotlib.pyplot as plt
    colors = np.asarray([
        hsv_to_rgb(h, 0.95, 0.98)
        for h in np.arange(hp.MAX_N_SIGNAL, dtype=np.float32)
        / hp.MAX_N_SIGNAL])
    composite = -np.einsum("nwh,nc->nwhc", np.log1p(np.abs(signals)),
                           colors)
    composite /= np.min(composite)
    n = len(signals)
    for i in range(n):
        plt.subplot(1, n + 2, i + 1)
        plt.imshow(composite[i])
    plt.subplot(1, n + 2, n + 1)
    plt.imshow(0.9 * composite.sum(axis=0))
    plt.subplot(1, n + 2, n + 2)
    plt.imshow(np.log1p(np.abs(raw_mixture)))
    plt.show()


@torch.no_grad()
def debug_fetch(model, params: dict, src_ri: torch.Tensor) -> dict:
    """One batch through the model's parts with the encoder's taps: the
    embeddings, attractors (the train estimator, on the true sources),
    masks, separated spectra and the encoder's activations."""
    from danet_tpu_torch.models.danet import mixture_features
    hp = model.hp
    _, src_pwr, mix_pwr, logmag, phase_unit = mixture_features(src_ri,
                                                               hp.EPS)
    cdt = getattr(torch, getattr(hp, "COMPUTE_DTYPE", "float32"))
    embed, fetches = model.encoder.apply_debug(params["encoder"],
                                               logmag.to(cdt))
    embed_flat = embed.reshape(embed.shape[0], -1, embed.shape[-1])
    attractors = model.train_estimator.apply(
        params.get("train_estimator", {}), embed, src_pwr=src_pwr,
        mix_pwr=mix_pwr)
    sep_pwr = model.separator.apply(params.get("separator", {}), mix_pwr,
                                    attractors, embed_flat)
    return dict(embed=embed, attrs=attractors, masks=sep_pwr,
                output=sep_pwr[..., None] * phase_unit[:, None], **fetches)


def run_debug(args):
    import scipy.io
    hp = g_hp
    src = _draw_test_mixture(hp, g_dataset, shuffle=True)
    src_ri = torch.from_numpy(audio.to_ri(src[None])).to(g_trainer.device)
    data = debug_fetch(g_model, g_trainer.eval_params(g_state), src_ri)
    data = {k: v.detach().float().cpu().numpy() for k, v in data.items()}
    data["input"] = np.stack([src.real, src.imag], -1)
    os.makedirs("debug", exist_ok=True)
    scipy.io.savemat("debug/debug_data.mat", data)
    print("Debug data written to debug/debug_data.mat")


def main(argv=None, prog: str = "python -m danet_tpu_torch"):
    global g_args, g_hp, g_model, g_trainer, g_state, g_dataset
    g_args = build_argparser(prog).parse_args(argv)
    hp = g_hp = load_hparams(g_args)

    sys.stdout.write('Preparing dataset "%s" ... ' % hp.DATASET_TYPE)
    sys.stdout.flush()
    g_dataset = hp.get_dataset()(hp, seed=g_args.seed)
    g_dataset.install_and_load()
    sys.stdout.write("done\n")

    print('Encoder type: "%s"' % hp.ENCODER_TYPE)
    print('Separator type: "%s"' % hp.SEPARATOR_TYPE)
    print('Training estimator type: "%s"' % hp.TRAIN_ESTIMATOR_METHOD)
    print('Inference estimator type: "%s"' % hp.INFER_ESTIMATOR_METHOD)

    if g_args.mode in ("demo", "debug"):
        hp.BATCH_SIZE = 1
        print('  Warning: setting hparams.BATCH_SIZE to 1 for "%s" mode'
              % g_args.mode)
        if g_args.mode == "debug":
            hp.DEBUG = True

    sys.stdout.write("Building model ... ")
    sys.stdout.flush()
    g_model = hp.get_model()(hp)
    g_trainer = Trainer(g_model, hp, g_args.device, name=g_args.name)
    g_state = g_trainer.init_state(
        torch.Generator().manual_seed(g_args.seed))
    print("done (%d parameters, 1 device(s): %s)" % (
        sum(p.numel() for p in leaves(g_state["params"])),
        g_trainer.device.type))

    if g_args.input_pfile is not None:
        sys.stdout.write(
            "Loading parameters from %s ... " % g_args.input_pfile)
        g_state = g_trainer.load_params(g_state, g_args.input_pfile)
        sys.stdout.write("done\n")

    mode = g_args.mode
    if mode == "interactive":
        print("Now in interactive mode, you should run this with python -i")
        return
    elif mode == "train":
        # an explicit -lr wins; a fresh run starts at LR; a resume keeps
        # the checkpoint's (possibly decayed) learning rate
        explicit_lr = (float(g_args.learn_rate)
                       if g_args.learn_rate is not None else
                       (hp.LR if g_args.input_pfile is None else None))
        g_state = g_trainer.train(
            n_epoch=g_args.num_epoch, dataset=g_dataset,
            save_on_epoch=not g_args.no_save_on_epoch,
            valid_on_epoch=not g_args.no_valid_on_epoch,
            state=g_state, seed=g_args.seed, lr=explicit_lr)
        if g_args.output_pfile is not None:
            sys.stdout.write(
                "Saving parameters into %s ... " % g_args.output_pfile)
            g_trainer.save_params(g_state, g_args.output_pfile)
            sys.stdout.write("done\n")
    elif mode == "test":
        g_trainer.test(g_state, g_dataset, seed=g_args.seed)
    elif mode == "valid":
        g_trainer.test(g_state, g_dataset, "valid", "Valid",
                       seed=g_args.seed)
    elif mode == "demo":
        run_demo(g_args)
    elif mode == "debug":
        run_debug(g_args)
    else:
        raise ValueError('Unknown mode "%s"' % mode)


if __name__ == "__main__":
    main()
