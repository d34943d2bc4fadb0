"""Train the port from the command line: an alias of ``python -m
danet_tpu_torch -m train`` (``danet_tpu_torch/__main__.py``), with the same
flags:

    python -m danet_tpu_torch.train [-c cfg.json] [-ds toy] [-ne N] \\
        [-bs B] [-lr LR] [-n NAME] [-i CKPT] [-o CKPT] [--seed S] \\
        [--no-save-on-epoch] [--no-valid-on-epoch] [--set KEY=VALUE] \\
        [--device cuda]

It prints the per-epoch loss / SNR / LR line and the validation line that
the JAX CLI prints, writes ``metrics.jsonl`` under SUMMARY_DIR (and
TensorBoard scalars where tensorboardX is installed), saves
``saves/<name>_e<k>`` after each epoch unless ``--no-save-on-epoch``, and
resumes from ``-i``.
"""
from __future__ import annotations

import sys

from danet_tpu_torch.__main__ import main as cli_main


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    cli_main(["-m", "train"] + argv, prog="python -m danet_tpu_torch.train")


if __name__ == "__main__":
    main()
