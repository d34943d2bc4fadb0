"""The traced slice of a run: ``torch.profiler`` over a bounded number of
the window's calls, read back from its Chrome trace.

``Slice`` holds the device's operations (kernels, copies, sets) inside
the slice, the slice's own span (the harness's ``bench.slice``
annotation, on the host's clock, which the profiler aligns the device's
to) and the host spans of the thread that drove it.  The union of the
device intervals is the busy time; its gaps are the idle time, named by
the innermost host span that covers each gap's middle.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict

import torch

SLICE = "bench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profiled(out: list):
    """Profile the body (CPU and CUDA activity) inside a ``bench.slice``
    span, synchronised at its end; append the read ``Slice`` to ``out``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        with record_function(SLICE):
            yield
            torch.cuda.synchronize()
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out.append(Slice(json.load(f)))
    finally:
        os.remove(path)


def union(intervals) -> list:
    """Merged [start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def covered(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


class Slice:
    def __init__(self, trace: dict):
        events = [e for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
        spans = [e for e in events if e.get("name") == SLICE
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise RuntimeError("the trace holds no %s span" % SLICE)
        top = spans[0]
        self.t0 = float(top["ts"])
        self.t1 = self.t0 + float(top["dur"])
        self.device = []                      # (name, start, end) in us
        for e in events:
            if e.get("cat") in DEVICE_CATS:
                s = max(float(e["ts"]), self.t0)
                t = min(float(e["ts"]) + float(e["dur"]), self.t1)
                if t > s:
                    self.device.append((e["name"], s, t))
        self.host = [(e["name"], float(e["ts"]), float(e["ts"]) + float(
            e["dur"])) for e in events
            if e.get("cat") in ("user_annotation", "cpu_op")
            and e.get("tid") == top.get("tid") and e.get("pid") == top.get(
                "pid") and e is not top]
        self.host.sort(key=lambda x: x[1])
        self._starts = [s for _, s, _ in self.host]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return covered((s, e) for _, s, e in self.device) * 1e-6

    def busy_of(self, match) -> float:
        """Seconds covered by the device operations whose name ``match``
        accepts."""
        return covered((s, e) for n, s, e in self.device if match(n)) * 1e-6

    def time_of(self, match) -> float:
        """Summed durations (seconds) of the operations ``match`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        """The operations that took most device time, and the idle time
        by what the host was doing, each the ``top`` largest, seconds."""
        by_op = defaultdict(float)
        for n, s, e in self.device:
            by_op[_short(n)] += (e - s) * 1e-6
        gaps, at = [], self.t0
        for s, e in union((s, e) for _, s, e in self.device) + [
                [self.t1, self.t1]]:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        by_host = defaultdict(float)
        for s, e in gaps:
            by_host[self._doing((s + e) / 2)] += (e - s) * 1e-6
        first = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in first],
                "idle_gaps": [[n, v] for n, v in idle]}

    def _doing(self, t: float) -> str:
        """The innermost host span covering ``t``: host spans nest, so it
        is the latest-starting one that has not ended."""
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, max(i - 4096, -1), -1):
            n, s, e = self.host[j]
            if e > t:
                return n
        return "host, outside any span"


def _short(name: str) -> str:
    """A kernel's name without its argument list, at most 96 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    return (name if cut <= 0 else name[:cut])[:96]
