"""The traffic generator: the same seed gives the same inputs, another
seed other inputs, and every seed the same set of request lengths."""
import numpy as np

from perfbench.harness import traffic
from perfbench.tests import tiny

SEED = 2 ** 31 + 7


def test_train_batches_repeat_under_a_seed(monkeypatch):
    c = tiny.cell("danet-bilstm.train", monkeypatch)
    a = traffic.make(c.traffic, c.keys, SEED).batches(3, 2)
    b = traffic.make(c.traffic, c.keys, SEED).batches(3, 2)
    assert a.shape == (2, 4, 2, 32, 129, 2) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    other = traffic.make(c.traffic, c.keys, SEED + 1).batches(3, 2)
    assert not np.array_equal(a, other)
    # every row of a batch is its own draw
    flat = a[0].reshape(4, -1)
    assert len({r.tobytes() for r in flat}) == 4


def test_train_rows_are_rebuilt_alone(monkeypatch):
    """A rank fills only its rows; they equal those of the whole batch."""
    c = tiny.cell("danet-bilstm.train", monkeypatch)
    t = traffic.make(c.traffic, c.keys, SEED)
    whole = t.batches(0, 2)
    part = t.batches(0, 2, rows=slice(2, 4))
    np.testing.assert_array_equal(part[:, 2:4], whole[:, 2:4])


def test_requests_repeat_and_cycle_through_the_same_lengths(monkeypatch):
    c = tiny.cell("danet-bilstm.serve", monkeypatch)
    a = traffic.make(c.traffic, c.keys, SEED)
    b = traffic.make(c.traffic, c.keys, SEED)
    for i in (0, 5, 300):
        np.testing.assert_array_equal(a.request(i), b.request(i))
    other = traffic.make(c.traffic, c.keys, SEED + 1)
    cyc = a.cycle
    for first in (0, cyc):
        got = sorted(a.length(i) for i in range(first, first + cyc))
        assert got == sorted(other.length(i) for i in range(cyc))
    assert [a.length(i) for i in range(cyc)] != [
        other.length(i) for i in range(cyc)]
    lo, hi = c.traffic["min_s"] * 8000, c.traffic["max_s"] * 8000
    assert lo <= min(a.lengths) and max(a.lengths) <= hi
