"""Train the port from the command line (the counterpart of ``main.py -m
train``):

    python -m danet_tpu_torch.train [-c cfg.json] [-ds toy] [-ne N] \\
        [-bs B] [-lr LR] [--seed S] [--no-valid-on-epoch] [--device cuda]

Configs layer over ``default.json`` as in the JAX package.  The dataset
is the registered DATASET_TYPE (``toy``, ``synth``, ``synth-speech``,
``wsj0``, the last from WSJ0_PATH; h5py is needed for it).  Prints the
per-epoch loss / SNR / LR line and the validation line that the JAX CLI
prints and writes ``metrics.jsonl`` under SUMMARY_DIR (and TensorBoard
scalars where tensorboardX is installed); saves no checkpoint
(checkpoints are not ported).  ``configs/tpu.json`` trains with its own
trainer keys: the int16 wave wire, TRAIN_STEPS_PER_CALL (CUDA graphs on
the card), METRICS_EVERY and WATCHDOG_SECS.
"""
from __future__ import annotations

import argparse
import sys

import torch

from danet_tpu_torch.hparams import load_config
from danet_tpu_torch.train.trainer import Trainer
from danet_tpu_torch.weights import leaves


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m danet_tpu_torch.train")
    ap.add_argument("-c", "--config", action="append", default=[],
                    help="config JSON layered over default.json "
                         "(repeatable)")
    ap.add_argument("-ds", "--dataset",
                    help="dataset, overrides DATASET_TYPE")
    ap.add_argument("-ne", "--num-epoch", type=int, default=10)
    ap.add_argument("-bs", "--batch-size", type=int,
                    help="overrides BATCH_SIZE")
    ap.add_argument("-lr", "--learn-rate", type=float, help="overrides LR")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, dropout and data")
    ap.add_argument("--no-valid-on-epoch", action="store_true",
                    help="don't sweep the validation set after each epoch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    overrides = {}
    if args.dataset is not None:
        overrides["DATASET_TYPE"] = args.dataset
    if args.batch_size is not None:
        overrides["BATCH_SIZE"] = args.batch_size
    if args.learn_rate is not None:
        overrides["LR"] = args.learn_rate
    hp = load_config(*args.config, **overrides)

    sys.stdout.write('Preparing dataset "%s" ... ' % hp.DATASET_TYPE)
    dataset = hp.get_dataset()(hp, seed=args.seed)
    dataset.install_and_load()
    sys.stdout.write("done\n")
    print('Encoder type: "%s"' % hp.ENCODER_TYPE)
    print('Separator type: "%s"' % hp.SEPARATOR_TYPE)
    print('Training estimator type: "%s"' % hp.TRAIN_ESTIMATOR_METHOD)
    print('Inference estimator type: "%s"' % hp.INFER_ESTIMATOR_METHOD)

    sys.stdout.write("Building model ... ")
    model = hp.get_model()(hp)
    trainer = Trainer(model, hp, args.device)
    state = trainer.init_state(torch.Generator().manual_seed(args.seed))
    print("done (%d parameters, device %s)" % (
        sum(p.numel() for p in leaves(state["params"])), trainer.device))
    trainer.train(args.num_epoch, dataset,
                  valid_on_epoch=not args.no_valid_on_epoch, state=state,
                  seed=args.seed, lr=hp.LR)


if __name__ == "__main__":
    main()
