"""The port must import without jax: the machine that serves it on the GPU
has none.  Importing the package and its serving module in a fresh
interpreter must load no jax and no danet_tpu module."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_torch_port_imports_no_jax():
    code = ("import danet_tpu_torch, danet_tpu_torch.serve, sys; "
            "assert not any(m in ('jax', 'danet_tpu') or m.startswith("
            "('jax.', 'danet_tpu.')) for m in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
