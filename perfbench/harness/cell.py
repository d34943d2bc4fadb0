"""A cell's definition, read from data files by name, and the result line.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``),
its chips and its end-to-end metrics; the per-layer metrics are the
readers in ``metrics/``, each run in the cells that report the end-to-end
metric it moves.  Nothing here knows a cell by name.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
# the program's build and kernel caches: fixed directories in the checkout
CACHE = os.path.join(ROOT, ".perfbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "danet_tpu")


def _load_json(*parts) -> dict:
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    end_to_end: list
    limits: dict
    config: dict          # the whole configuration file
    traffic: dict
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False

    @property
    def keys(self) -> dict:
        """The program's configuration keys (upper case)."""
        return {k: v for k, v in self.config.items() if k.isupper()}

    @property
    def widths(self) -> dict:
        return self.config.get("widths", {})


def load(name: str) -> Cell:
    w = _load_json("workloads", name + ".json")
    return Cell(name=name, config_name=w["config"],
                traffic_name=w["traffic"], chips=int(w["chips"]),
                end_to_end=list(w["end_to_end"]), limits=dict(w["limits"]),
                config=_load_json("configs", w["config"] + ".json"),
                traffic=_load_json("traffic", w["traffic"] + ".json"))


def metric_readers(end_to_end) -> dict:
    """{name: module} of every per-layer reader in ``metrics/`` whose
    end-to-end metric (its ``MOVES``) the cell reports."""
    out = {}
    folder = os.path.join(BENCH, "metrics")
    for fname in sorted(os.listdir(folder)):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        name = fname[:-3]
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + name.replace(".", "_"),
            os.path.join(folder, fname))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if mod.MOVES in end_to_end:
            out[name] = mod
    return out


def cache_env() -> dict:
    """Environment of the program's caches and of libraries that would
    load JAX by themselves: every cache at a fixed path in the checkout."""
    return {"TRITON_CACHE_DIR": os.path.join(CACHE, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(CACHE, "torch_extensions"),
            "CUDA_CACHE_PATH": os.path.join(CACHE, "cuda"),
            "USE_FLAX": "0", "USE_JAX": "0"}


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict                     # name -> (value, unit)
    device: dict
    checks: dict                      # name -> (value, limit)
    breakdown: dict = field(default_factory=dict)

    def line(self) -> str:
        out = {"correct": bool(self.correct),
               "attempted": int(self.attempted),
               "failed": int(self.failed),
               "metrics": {k: {"value": v, "unit": u}
                           for k, (v, u) in self.metrics.items()
                           if math.isfinite(v)},
               "device": self.device}
        if self.breakdown:
            out["breakdown"] = self.breakdown
        out["checks"] = {k: {"value": v if math.isfinite(v) else None,
                             "limit": lim}
                         for k, (v, lim) in self.checks.items()}
        return json.dumps(out, allow_nan=False)


def judge(checks: dict) -> bool:
    """Every compared number finite and at most its limit."""
    return all(isinstance(v, (int, float)) and math.isfinite(v) and v <= lim
               for v, lim in checks.values())


def stage(what: str, t_start: float) -> None:
    """A set-up stage's end on stderr, in seconds since ``t_start``."""
    import time
    print("setup %s at %.3f s" % (what, time.perf_counter() - t_start),
          file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def device_name(device) -> str:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
