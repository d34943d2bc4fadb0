"""The readers of the program's spans (``request_idle_share.serve``,
``launches_per_request.serve``, ``feed_idle_share.train``) on hand-built
Chrome traces read by ``harness/trace.Slice``, against values worked out
by hand; None where the slice holds no such span."""
from types import SimpleNamespace

import pytest

from perfbench.harness import cell as cell_mod
from perfbench.harness import spans
from perfbench.harness.trace import Slice

MAIN, OTHER = 11, 12


def _ev(name, ts, dur, cat, tid=MAIN):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "pid": 1, "tid": tid}


def _ann(name, ts, dur, tid=MAIN):
    return _ev(name, ts, dur, "user_annotation", tid)


def _slice(events) -> Slice:
    return Slice({"traceEvents": [_ann("bench.slice", 0, 1000)] + events})


def _reader(name):
    mods = cell_mod.metric_readers(["request_ms_p50", "train_mix_per_s"])
    return mods[name]


def _read(name, sl):
    return _reader(name).read(SimpleNamespace(slice=sl))


def _two_requests() -> list:
    """Request A [100, 400) and B [600, 800) on the driving thread, each
    inside the harness's bench.request; the card: in A [150, 250), [200,
    260), a copy [300, 350) and [390, 420) (it starts in A and ends after
    it), in B [650, 750), and [450, 500) between them, under the client;
    a request span on another thread, which the readers leave out."""
    return [
        _ann("bench.request", 90, 320), _ann("danet.request", 100, 300),
        _ann("danet.encoder", 140, 130),
        _ann("bench.client", 420, 170),
        _ann("bench.request", 590, 220), _ann("danet.request", 600, 200),
        _ann("danet.request", 450, 100, tid=OTHER),
        _ev("k1", 150, 100, "kernel", tid=7), _ev("k2", 200, 60, "kernel",
                                                  tid=8),
        _ev("Memcpy DtoH", 300, 50, "gpu_memcpy", tid=7),
        _ev("k3", 390, 30, "kernel", tid=7),
        _ev("k4", 450, 50, "kernel", tid=7),
        _ev("k5", 650, 100, "kernel", tid=7),
    ]


def test_request_idle_share_of_two_requests():
    # busy inside A: [150, 260) + [300, 350) + [390, 400) = 170 us of
    # 300; inside B 100 of 200: (500 - 270) / 500
    sl = _slice(_two_requests())
    assert _read("request_idle_share.serve", sl) == pytest.approx(46.0)
    # the whole slice's idle share counts the client's time too: busy
    # 110 + 50 + 30 + 50 + 100 us of 1000
    assert 100 * (1 - sl.busy_s / sl.window_s) == pytest.approx(66.0)


def test_launches_per_request_of_two_requests():
    # A: k1, k2, the copy, k3 (it starts inside A); B: k5; k4 is the
    # client's and the other thread's span is not a request of the slice
    sl = _slice(_two_requests())
    assert _read("launches_per_request.serve", sl) == pytest.approx(2.5)


def test_feed_idle_share_with_an_operation_overlapping_a_feed_span():
    # device [0, 300), [350, 700), [800, 1000): gaps [300, 350) and
    # [700, 800); the feed wait [280, 330) overlaps the first operation
    # and the first gap (30 us), a put [690, 720) the second gap (20), a
    # put [900, 950) no gap, and a feed wait on another thread counts
    # nothing: 50 us of the slice's 1000
    sl = _slice([
        _ann("danet.train.call", 0, 270),
        _ann("danet.train.feed_wait", 280, 50),
        _ann("danet.train.put", 690, 30),
        _ann("danet.train.put", 900, 50),
        _ann("danet.train.feed_wait", 700, 100, tid=OTHER),
        _ev("step", 0, 300, "kernel", tid=7),
        _ev("step", 350, 350, "kernel", tid=7),
        _ev("Memcpy HtoD", 800, 200, "gpu_memcpy", tid=7),
    ])
    assert _read("feed_idle_share.train", sl) == pytest.approx(5.0)
    assert spans.idle(sl) == [[300, 350], [700, 800]]


@pytest.mark.parametrize("name", ["request_idle_share.serve",
                                  "launches_per_request.serve",
                                  "feed_idle_share.train"])
def test_no_program_spans_read_none(name):
    """A slice with the harness's spans alone (the program before its
    spans) and a run without a slice both read None."""
    events = [_ann("bench.client", 0, 100), _ann("bench.request", 100, 400),
              _ev("k1", 150, 100, "kernel", tid=7),
              _ann("danet.request", 100, 400, tid=OTHER),
              _ann("danet.train.put", 100, 400, tid=OTHER)]
    assert _read(name, _slice(events)) is None
    assert _read(name, None) is None


def test_overlap_of_interval_lists():
    a = [[0, 10], [20, 30], [40, 50]]
    b = [[5, 25], [45, 60]]
    assert spans.overlap(a, b) == 5 + 5 + 5
    assert spans.overlap(a, []) == 0
    assert spans.length(a) == 30
