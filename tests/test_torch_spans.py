"""PyTorch port, the profiler spans (``danet_tpu_torch/spans.py``): the
shared null context while no profiler records, the spans of a request
(``Separator.separate``) nested under one ``danet.request`` on the
calling thread, the epoch loop's spans on its two threads in a
PROFILE_STEPS trace, a bundle exported with no profiler op in its graph,
and ``perf_probe``'s table of them."""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from danet_tpu_torch import perf_probe, serve, spans  # noqa: E402
from danet_tpu_torch.data.dataset import WhiteNoiseData  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import DaNet  # noqa: E402
from danet_tpu_torch.models import encoders as tenc  # noqa: E402
from danet_tpu_torch.train.trainer import Trainer  # noqa: E402

STAGES = ["danet.upload", "danet.stft", "danet.features", "danet.encoder",
          "danet.estimator", "danet.masks", "danet.istft", "danet.download"]


def _trace_spans(path) -> list:
    """(name, tid, start, end) of the trace's user annotations, by start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], e["tid"], float(e["ts"]), float(e["ts"]) + float(
        e["dur"])) for e in events if e.get("cat") == "user_annotation"
        and e.get("ph") == "X"]
    return sorted(out, key=lambda x: x[2])


def _inside(child, parent) -> bool:
    return (child[1] == parent[1] and parent[2] <= child[2]
            and child[3] <= parent[3])


def _profiled_spans(fn, tmp_path) -> list:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    return _trace_spans(path)


def test_torch_span_off_is_the_shared_null_context(monkeypatch):
    """With no profiler on, ``span`` returns one shared null context and
    builds no ``record_function``."""
    def refuse(name):
        raise AssertionError("record_function built with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = spans.span("danet.request"), spans.span("danet.encoder")
    assert a is b is spans._OFF
    with a:
        with b:
            pass


def test_torch_span_on_records_a_user_annotation(tmp_path):
    """Under ``torch.profiler`` a span is a ``record_function``: one user
    annotation of its name, nesting as the code nests."""
    def body():
        assert spans.span("danet.outer") is not spans._OFF
        with spans.span("danet.outer"):
            with spans.span("danet.inner"):
                torch.ones(4).sum()

    got = _profiled_spans(body, tmp_path)
    assert [g[0] for g in got] == ["danet.outer", "danet.inner"]
    assert _inside(got[1], got[0])
    assert spans.span("danet.after") is spans._OFF


def test_torch_span_records_on_a_thread_started_before_the_profiler(
        tmp_path):
    """A thread that existed before a profiler of every thread started
    (the prefetch thread under PROFILE_STEPS) sees it on, and its spans
    land in the trace under its own thread id."""
    from danet_tpu_torch.train.trainer import _all_threads
    kw = _all_threads()
    if not kw:
        pytest.skip("this PyTorch cannot profile every thread")
    go, done, seen = threading.Event(), threading.Event(), []

    def worker():
        go.wait()
        seen.append(spans.span("danet.worker") is not spans._OFF)
        with spans.span("danet.worker"):
            torch.ones(4).sum()
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    prof = profile(activities=[ProfilerActivity.CPU], **kw)
    prof.start()
    with spans.span("danet.main"):
        go.set()
        assert done.wait(30)
    prof.stop()
    t.join(30)
    assert not t.is_alive()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    got = {g[0]: g for g in _trace_spans(path)}
    assert seen == [True]
    assert got["danet.worker"][1] != got["danet.main"][1]


@pytest.fixture
def tiny_separator(monkeypatch):
    monkeypatch.setattr(tenc.BiLstmEncoder, "HDIM", 6)
    monkeypatch.setattr(tenc.BiLstmEncoder, "N_LAYERS", 2)
    hp = load_config(ENCODER_TYPE="bilstm-orig")
    model = hp.get_model()(hp)
    params = model.init(torch.Generator().manual_seed(0))
    return serve.Separator(model, params, "cpu")


@pytest.mark.parametrize("shape", [(2000,), (2, 1500)])
def test_torch_request_spans_nest_under_one_request(tiny_separator,
                                                    tmp_path, shape):
    """``Separator.separate`` on a tiny bilstm-orig, called twice: one
    ``danet.request`` per call, and inside each, on the calling thread,
    the eight stages in order; the answers equal the unprofiled ones."""
    wav = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = tiny_separator.separate(wav)
    outs = []
    got = _profiled_spans(lambda: outs.extend(
        tiny_separator.separate(wav) for _ in range(2)), tmp_path)
    for out in outs:
        np.testing.assert_array_equal(out, want)
    requests = [g for g in got if g[0] == "danet.request"]
    assert len(requests) == 2
    assert {g[1] for g in got} == {threading.get_native_id()}
    for req in requests:
        inner = [g for g in got if g is not req and _inside(g, req)]
        assert [g[0] for g in inner] == STAGES
        # the stages follow one another
        for a, b in zip(inner, inner[1:]):
            assert a[3] <= b[2]


class LongerNoiseData(WhiteNoiseData):
    """Twice the toy epoch: with 2-step calls the prefetch thread is still
    casting when the profile window opens."""

    def epoch(self, subset, batch_size, **kw):
        for _ in range(2):
            yield from super().epoch(subset, batch_size, **kw)


@pytest.mark.parametrize("k", [1, 2])
def test_torch_profile_steps_trace_holds_the_loop_spans(tmp_path, capsys,
                                                        k):
    """PROFILE_STEPS = 2K on the CPU (two calls): the trace holds the feed
    wait, the put and the metrics fetch on the main thread, the wire cast
    on the prefetch thread, and each step (inside its call with K=2) with
    the model's stages, the backward and the optimizer inside it."""
    logs = tmp_path / "logs"
    hp = load_config(BATCH_SIZE=2, MAX_TRAIN_LEN=16, PROFILE_STEPS=2 * k,
                     TRAIN_STEPS_PER_CALL=k, SUMMARY_DIR=str(logs))
    tr = Trainer(DaNet(hp), hp, "cpu")
    ds = LongerNoiseData(hp)
    ds.install_and_load()
    tr.train(1, ds, save_on_epoch=False, valid_on_epoch=False)
    capsys.readouterr()
    (run_dir,) = os.listdir(str(logs))
    got = _trace_spans(os.path.join(str(logs), run_dir, "profile",
                                    "trace.json"))
    names = {g[0] for g in got}
    steps = [g for g in got if g[0] == "danet.train.step"]
    assert len(steps) == 2 * k
    main = steps[0][1]
    for name in ("danet.train.feed_wait", "danet.train.put",
                 "danet.train.metrics_fetch"):
        assert name in names
        assert {g[1] for g in got if g[0] == name} == {main}
    casts = [g for g in got if g[0] == "danet.train.wire_cast"]
    assert casts and all(g[1] != main for g in casts)
    for step in steps:
        inner = [g[0] for g in got if _inside(g, step) and g is not step]
        for name in ("danet.encoder", "danet.estimator", "danet.masks",
                     "danet.loss", "danet.backward", "danet.optimizer"):
            assert name in inner, (name, inner)
    calls = [g for g in got if g[0] == "danet.train.call"]
    if k == 1:
        assert not calls
    else:
        assert len(calls) == 2
        assert all(any(_inside(s, c) for c in calls) for s in steps)


def test_torch_bundle_exported_with_profiler_off_has_no_profiler_op(
        tmp_path):
    """``export_separator`` with no profiler on: the exported graph holds
    no profiler op (the spans are null contexts), and the bundle runs."""
    hp = load_config(ENCODER_TYPE="toy")
    model = hp.get_model()(hp)
    params = model.init(torch.Generator().manual_seed(0))
    serve.export_separator(model, params, str(tmp_path / "b"), [2048],
                           device="cpu")
    program = torch.export.load(str(tmp_path / "b" / "sep_2048.pt2"))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets and not any("profiler" in t for t in targets)
    out = serve.SeparatorBundle(str(tmp_path / "b")).separate(
        np.zeros(2000, np.float32))
    assert out.shape == (hp.MAX_N_SIGNAL, 2000)


def test_torch_perf_probe_report_prints_the_spans(tiny_separator, capsys):
    """``perf_probe``'s report of a profile lists each ``danet.*`` span
    with its calls and host ms per request, and no busy share."""
    wav = np.zeros(2000, np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            tiny_separator.separate(wav)
    rows = perf_probe._span_rows(prof, 2)
    assert sorted(r[0] for r in rows) == sorted(["danet.request"] + STAGES)
    assert all(r[1] == 1.0 and r[2] > 0.0 for r in rows)
    assert rows[0][0] == "danet.request"
    perf_probe._report("tiny serve", prof, 2, 1.0)
    out = capsys.readouterr().out
    assert "span danet.encoder" in out and "busy" not in out
