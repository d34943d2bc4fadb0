"""Metric files and step timing of the train loop.

Counterpart of ``danet_tpu/train/metrics.py``: ``MetricsWriter`` writes
every scalar (train rows per step, the valid sweep per epoch) to
``metrics.jsonl`` in the run directory ``SUMMARY_DIR/"<stamp>
<SUMMARY_TITLE>"``, one JSON record per call, and to TensorBoard through
tensorboardX where that package can be imported (it is optional).
``StepTimer`` keeps the mean wall time of the timed calls: the loop times
the dispatch of a step, not its completion on the device.
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


class StepTimer:
    """Mean wall time of the timed calls."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.total = 0.0
        self.count = 0

    def start(self):
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self.t0
        self.total += dt
        self.count += 1
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)
