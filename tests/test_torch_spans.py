"""The port's spans (``utils/spans.py``) on the CPU, under ``torch.profiler``
with CPU activity.

Off (no profiler in the thread), a span is the shared null context and
writes no record. On, nested spans carry their parent, thread and group
(an issue thread's into the handing thread's store);
each is a ``cpu_op`` range on the profiler's clock (never a
``user_annotation``, which kineto mirrors onto the device's timeline); a
second profiled interval holds only its own records, another thread's
interval leaves them be, and a thread keeps at most ``CAP``. Then the spans at the
port's boundaries: a scanner's stage, dispatch and collect of two groups,
and the step cache's first sight, capture and replay (the stub graph of
``test_torch_step_graph.py``).
"""

import contextlib
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_step_graph import stub  # noqa: E402, F401
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from audio_matcher_tpu_torch.models.matcher import MatchConfig  # noqa: E402
from audio_matcher_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from audio_matcher_tpu_torch.parallel.step_graph import StepGraphs  # noqa: E402
from audio_matcher_tpu_torch.parallel.sweep import ShardedScanner  # noqa: E402
from audio_matcher_tpu_torch.utils import spans  # noqa: E402

SR = 1000


def _profiled():
    """A CPU profile of a fresh interval: a span opened with the profiler
    off first, as every caller's set-up does."""
    with spans.span("before"):
        pass
    return profile(activities=[ProfilerActivity.CPU])


def _names(records):
    return [r.name for r in records]


@pytest.mark.parametrize("open_span", [
    lambda: spans.span("off"),
    lambda: spans.span("off", 3),
    lambda: spans.issue_span(spans.sink(), "off", 3, "cpu"),
], ids=["span", "span-grouped", "issue_span"])
def test_off_a_span_is_the_shared_null_context(open_span):
    with _profiled():
        with spans.span("on"):
            pass
    assert not spans.enabled()
    ctx = open_span()
    assert ctx is spans._NULL
    with ctx:
        pass
    assert _names(spans.records()) == ["on"]


def test_nested_spans_carry_parent_thread_and_group():
    seen = {}

    def worker(into):
        seen["enabled"] = spans.enabled()
        with spans.issue_span(into, "issue", 7, "cpu"):
            with spans.issue_span(into, "inner", None, "cpu"):
                pass

    with _profiled():
        with spans.span("outer", 7):
            with spans.span("inner"):
                with spans.span("leaf", 8):
                    pass
            t = threading.Thread(target=worker, args=(spans.sink(),))
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and seen["enabled"] is False
    got = {(r.name, r.thread == threading.get_ident()): r
           for r in spans.records()}
    here = threading.get_ident()
    assert got["outer", True].parent is None
    assert got["inner", True].parent == "outer"
    assert got["leaf", True].parent == "inner"
    assert [got[k, True].group for k in ("outer", "inner", "leaf")] == [
        7, 7, 8]
    assert {got[k, True].thread for k in ("outer", "inner", "leaf")} == {
        here}
    issue, inner = got["issue", False], got["inner", False]
    assert issue.parent is None and issue.device == "cpu"
    assert inner.parent == "issue" and inner.group == 7
    assert issue.thread == inner.thread != here
    for r in got.values():
        assert r.t0_ns <= r.t1_ns


def test_a_span_is_a_cpu_op_on_the_profilers_clock():
    with _profiled() as prof:
        for name in ("a", "b"):
            with spans.span(name):
                time.sleep(0.002)
    mine = {r.name: r for r in spans.records()}
    events = [ev for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith(spans.PREFIX)]
    assert sorted(ev.name() for ev in events) == [
        "audio_matcher.a", "audio_matcher.b"]
    for ev in events:
        assert ev.activity_type() == "cpu_op"
        assert not ev.is_user_annotation()
        assert ev.device_type() == torch.autograd.DeviceType.CPU
        r = mine[ev.name()[len(spans.PREFIX):]]
        assert abs(ev.start_ns() - r.t0_ns) < 1_000_000


def test_the_range_category_is_pinned(tmp_path):
    """``_RecordFunctionFast`` ranges are ``cpu_op``s and
    ``record_function`` ranges ``user_annotation``s in the chrome trace: a
    torch whose ranges change category fails here first."""
    with _profiled() as prof:
        with spans.span("fast"):
            pass
        with torch.profiler.record_function(spans.PREFIX + "annotation"):
            pass
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    cats = {e["name"]: e.get("cat")
            for e in json.loads((tmp_path / "t.json").read_text())
            ["traceEvents"] if e.get("name", "").startswith(spans.PREFIX)}
    assert cats == {"audio_matcher.fast": "cpu_op",
                    "audio_matcher.annotation": "user_annotation"}


def test_a_second_interval_holds_only_its_own_records():
    with _profiled():
        with spans.span("first"):
            pass
    assert _names(spans.records()) == ["first"]
    with spans.span("between"):  # off: not recorded, and opens a new one
        pass
    assert _names(spans.records()) == ["first"]
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("second"):
            pass
        with spans.span("third"):
            pass
    assert _names(spans.records()) == ["second", "third"]


def _in_thread(run):
    out = {}
    t = threading.Thread(target=lambda: out.update(value=run()))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    return out["value"]


@pytest.mark.parametrize("other", ["profiled after", "unprofiled during"])
def test_another_threads_interval_leaves_this_ones_records(other):
    """A second thread's later profiled interval (one profiler runs at a
    time), or its spans with the profiler off during this thread's,
    neither clears this thread's records nor adds to them."""
    def run():
        with _profiled() if other == "profiled after" else (
                contextlib.nullcontext()):
            with spans.span("theirs"):
                pass
        return _names(spans.records())

    with _profiled():
        with spans.span("mine"):
            pass
        if other == "unprofiled during":
            theirs = _in_thread(run)
        with spans.span("mine, later"):
            pass
    if other == "profiled after":
        theirs = _in_thread(run)
    assert theirs == (["theirs"] if other == "profiled after" else [])
    assert _names(spans.records()) == ["mine", "mine, later"]


def test_a_thread_keeps_its_latest_records_up_to_the_cap(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)

    def run():
        with _profiled():
            for i in range(5):
                with spans.span(str(i)):
                    pass
        return _names(spans.records())

    assert _in_thread(run) == ["2", "3", "4"]


@pytest.mark.parametrize("shards", [1, 2])
def test_a_scanner_records_each_boundary_once_a_group(shards):
    """On a mesh, the issue thread's ``dispatch.issue`` too, on because the
    dispatching thread is profiled."""
    rng = np.random.default_rng(5)
    snippets = [(rng.standard_normal(m) * 0.2).astype(np.float32)
                for m in (SR // 2, SR // 3)]
    episodes = [(rng.standard_normal(secs * SR) * 0.05).astype(np.float32)
                for secs in (9, 7)]
    cfg = MatchConfig(chunk_secs=2.0, distance_secs=2.0,
                      fft_impl="xla_packed", peaks_impl="jnp")
    where = "cpu" if shards == 1 else make_mesh(shards, "cpu")
    sc = ShardedScanner(snippets, SR, cfg, device=where, graphs=False)
    sc.scan_resident(episodes[:1])  # the scanner's first group, off
    with _profiled():
        ahead = sc.scan_dispatch(sc.stage_resident(episodes[:1]))
        nxt = sc.scan_dispatch(sc.stage_resident(episodes[1:]))
        sc.scan_collect(ahead)
        sc.scan_collect(nxt)
    recs = spans.records()
    for name, parent in (("stage", None), ("stage.alloc", "stage"),
                         ("stage.fill", "stage"), ("dispatch", None),
                         ("collect", None), ("collect.peaks", "collect")):
        got = [r for r in recs if r.name == name]
        assert sorted(r.group for r in got) == [1, 2], name
        assert {r.parent for r in got} == {parent}, name
    issued = [r for r in recs if r.name == "dispatch.issue"]
    assert sorted(r.group for r in issued) == ([1, 2] if shards > 1 else [])
    assert {(r.parent, r.device) for r in issued} <= {(None, "cpu")}


def test_the_step_cache_records_first_sight_capture_and_replay(stub):
    cache = StepGraphs()
    x = torch.arange(6.0)

    def step(a):
        return (a * 2,)

    with _profiled():
        for _ in range(3):
            with spans.span("call"):
                out = cache(("double",), step, (x,))
    calls = [[]]
    for name in _names(spans.records()):  # a call closes after its spans
        if name == "call":
            calls.append([])
        else:
            calls[-1].append(name)
    assert calls.pop() == []
    assert torch.equal(out[0], x * 2)
    assert dict(cache.stats) == {"first": 1, "captures": 1, "hits": 1}
    replay = ["graph.copy_in", "graph.launch", "graph.copy_out"]
    assert calls == [["graph.first"], ["graph.capture"] + replay, replay]
