"""The harness without a card: it refuses to measure; nothing it runs
imports JAX or the JAX package, nor the reference the program; and a run
whose timed path is broken underneath comes out not correct, once for
each fault a cell can have."""
import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import run
from perfbench.harness import cell as cell_mod
from perfbench.harness import serve, train
from perfbench.tests import tiny

BENCH = cell_mod.BENCH
ARGS = ["--workload", "danet-bilstm.train", "--seed", str(2 ** 31 + 5),
        "--seconds", "1", "--trace", "0"]


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


def test_refuses_with_fewer_cards_than_the_cell(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


def test_fails_without_the_program(tmp_path):
    """A checkout of BENCHMARK.json and perfbench/ alone prints nothing."""
    shutil.copy(os.path.join(cell_mod.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py"] + ARGS,
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                found = set(_imports(path)) & set(cell_mod.FORBIDDEN)
                assert not found, (path, found)
                if os.sep + "reference" in path:
                    assert "danet_tpu_torch" not in set(_imports(path))


def test_forbidden_modules_compares_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "danet_tpu_torch_x", sys)
    assert "danet_tpu_torch_x" not in cell_mod.forbidden_modules()
    monkeypatch.setitem(sys.modules, "danet_tpu.models", sys)
    assert cell_mod.forbidden_modules() == ["danet_tpu.models"]


@pytest.fixture
def limits():
    """The cells' own limits."""
    return {n: cell_mod.load(n).limits for n in ("danet-bilstm.train",
                                                 "danet-bilstm.serve")}


def _train(monkeypatch, name="danet-bilstm.train"):
    c = tiny.cell(name, monkeypatch)
    return train.run(c, 0.0, "cpu")


def test_a_sound_training_run_is_correct(monkeypatch):
    r = _train(monkeypatch)
    assert r.correct, r.checks
    assert r.attempted > 0 and r.failed == 0


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(
        monkeypatch):
    from danet_tpu_torch import optim
    monkeypatch.setattr(optim.Optimizer, "update",
                        lambda self, *a, **k: None)
    r = _train(monkeypatch)
    assert not r.correct, r.checks


def test_half_the_batch_is_not_correct(monkeypatch):
    from danet_tpu_torch.models.danet import DaNet
    loss = DaNet.train_loss
    monkeypatch.setattr(DaNet, "train_loss", lambda self, p, src, g=None:
                        loss(self, p, src[:src.shape[0] // 2], g))
    r = _train(monkeypatch)
    assert not r.correct, r.checks


def test_an_altered_answer_is_not_correct(monkeypatch):
    from danet_tpu_torch.serve import Separator
    sep = Separator.separate

    def altered(self, wav):
        out = sep(self, wav)
        if len(wav) == max_len[0]:
            out = out.copy()
            out[0, len(wav) // 2] += np.abs(out).max()
        return out

    c = tiny.cell("danet-bilstm.serve", monkeypatch)
    max_len = [int(max(c.traffic and serve.traffic_mod.make(
        c.traffic, c.keys, c.seed).lengths))]
    assert serve.run(c, 0.0, "cpu").correct
    monkeypatch.setattr(Separator, "separate", altered)
    r = serve.run(c, 0.0, "cpu")
    assert not r.correct, r.checks


MESH_WORKER = r'''
import sys, time
sys.path.insert(0, sys.argv[4])
import pytest
from perfbench.harness import train
from perfbench.tests import tiny
rank, port, broken = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3] == "1"
if broken:
    from danet_tpu_torch.parallel import collectives
    collectives.reduce_grads = lambda mesh, grads, *a, **k: grads
mp = pytest.MonkeyPatch()
c = tiny.cell("danet-bilstm.train", mp, config="multichip-dp4")
c.config.update(MESH_DATA=2)
c.chips = 2
r = train.run_mesh(c, time.perf_counter(), rank, 2, port, device="cpu")
if r is not None:
    print("CORRECT", r.correct, r.checks)
'''


@pytest.mark.parametrize("broken", [False, True])
def test_the_exchange_left_out_is_not_correct(broken, tmp_path):
    """Two ranks on the CPU over gloo; with the gradients' all-reduce left
    out each rank steps on its own rows."""
    script = tmp_path / "rank.py"
    script.write_text(MESH_WORKER)
    port = run._free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(int(broken)),
         cell_mod.ROOT], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in (0, 1)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    line = [ln for ln in outs[0].splitlines() if ln.startswith("CORRECT")]
    assert line and line[0].startswith("CORRECT %s" % (not broken)), outs[0]
