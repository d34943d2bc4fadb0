"""Metric files and step timing of the train loop.

Counterpart of ``danet_tpu/train/metrics.py``: ``MetricsWriter`` writes
every scalar (train rows per step, the valid sweep per epoch) to
``metrics.jsonl`` in the run directory ``SUMMARY_DIR/"<stamp>
<SUMMARY_TITLE>"``, one JSON record per call, and to TensorBoard through
tensorboardX where that package can be imported (it is optional).
``StepTimer`` times the train loop between its metric fetches: each
fetch waits for the device to finish the steps it brings, so the wall
time from the end of one fetch to the end of the next, over the steps
fetched, is what those steps took on the device and the host together
(with K-step CUDA graphs too, where a call returns at its launch).
"""
from __future__ import annotations

import datetime
import json
import os
import time
from typing import Optional


class MetricsWriter:
    def __init__(self, summary_dir: str, title: str,
                 tensorboard: bool = True):
        stamp = datetime.datetime.now().strftime("%m%d_%H%M%S")
        self.run_dir = os.path.join(summary_dir, "%s %s" % (stamp, title))
        os.makedirs(self.run_dir, exist_ok=True)
        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(self.run_dir)
            except Exception:
                self._tb = None
        self._jsonl = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")

    def scalars(self, prefix: str, values: dict, step: int) -> None:
        rec = {"step": int(step), "t": time.time()}
        for k, v in values.items():
            v = float(v)
            rec["%s/%s" % (prefix, k)] = v
            if self._tb is not None:
                self._tb.add_scalar("%s/%s" % (prefix, k), v, step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


class NullWriter:
    """A ``MetricsWriter`` that writes nothing (the ranks of a mesh other
    than rank 0)."""

    run_dir = None

    def scalars(self, prefix: str, values: dict, step: int) -> None:
        pass

    def close(self) -> None:
        pass


class StepTimer:
    """Wall time per step between the loop's metric fetches: ``start``
    marks where the first interval begins, ``lap(steps)`` the end of a
    fetch that brought ``steps`` steps' metrics, and returns the time
    since the previous mark over those steps."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.total = 0.0
        self.count = 0

    def start(self):
        self.t0 = time.perf_counter()

    def lap(self, steps: int) -> float:
        now = time.perf_counter()
        dt, self.t0 = now - self.t0, now
        self.total += dt
        self.count += steps
        return dt / steps

    @property
    def mean(self) -> float:
        """Seconds per step over every lap so far."""
        return self.total / max(self.count, 1)
