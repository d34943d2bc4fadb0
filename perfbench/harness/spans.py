"""The program's own spans in a traced slice (``danet_tpu_torch/spans.py``
names them: ``danet.request``, ``danet.train.feed_wait``, ...), read from
the thread that drove the slice, against the card's operations.

A slice of a program without such spans holds none: the readers that use
these functions then return None.
"""
from __future__ import annotations

from perfbench.harness.trace import union


def named(sl, *names) -> list:
    """[start, end) in µs of the driving thread's spans called one of
    ``names``, merged."""
    return union((s, e) for n, s, e in sl.host if n in names)


def device(sl) -> list:
    """The union of the slice's device operations' intervals."""
    return union((s, e) for _, s, e in sl.device)


def idle(sl) -> list:
    """The gaps of the slice, [t0, t1), in which no operation ran on the
    card."""
    gaps, at = [], sl.t0
    for s, e in device(sl) + [[sl.t1, sl.t1]]:
        if s > at:
            gaps.append([at, s])
        at = max(at, e)
    return gaps


def overlap(a: list, b: list) -> float:
    """µs in both of two merged, sorted lists of intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def length(a: list) -> float:
    return sum(e - s for s, e in a)
