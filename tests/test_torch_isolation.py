"""The port must import without jax: the machine that runs it on the GPU
has none.  Importing the package, its command line, serving, training,
checkpoint, optimizer, loss, attention, kernel-op and profiling modules,
tasnet-v1, the wav-dir and timit datasets, the banded attention, the MoE
forms, the mesh (``parallel``: sharding, collectives, multihost, the
pipeline, sequence parallelism, ring and Ulysses attention and the
multi-process smoke runner), the console prompts, the
SPHERE decoder's bindings, the TIMIT and WSJ0 preprocessors
(imported, their ``main`` not run) and chip_smoke.py in a fresh
interpreter must load no jax, no optax and no danet_tpu module."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_torch_port_imports_no_jax():
    code = ("import danet_tpu_torch, danet_tpu_torch.__main__, "
            "danet_tpu_torch.serve, danet_tpu_torch.train, "
            "danet_tpu_torch.train.__main__, "
            "danet_tpu_torch.train.checkpoint, "
            "danet_tpu_torch.optim, danet_tpu_torch.ops.loss, "
            "danet_tpu_torch.ops.cuda.attention, danet_tpu_torch.perf_probe, "
            "danet_tpu_torch.ops.cuda.library, danet_tpu_torch.windows, "
            "danet_tpu_torch.models.tasnet, danet_tpu_torch.data.wavdir, "
            "danet_tpu_torch.data.timit, "
            "danet_tpu_torch.ops.local_attention, "
            "danet_tpu_torch.parallel.expert, "
            "danet_tpu_torch.parallel.sharding, "
            "danet_tpu_torch.parallel.collectives, "
            "danet_tpu_torch.parallel.multihost, "
            "danet_tpu_torch.parallel.smoke, "
            "danet_tpu_torch.parallel.pipeline, danet_tpu_torch.utils, "
            "danet_tpu_torch.parallel.seq_parallel, "
            "danet_tpu_torch.parallel.ring_attention, "
            "danet_tpu_torch.parallel.ulysses, "
            "danet_tpu_torch.native.sphere, "
            "danet_tpu_torch.native.sphere_convert, "
            "danet_tpu_torch.data.TIMIT.process, "
            "danet_tpu_torch.data.WSJ0.process, "
            "chip_smoke, sys; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'optax', 'danet_tpu')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
