"""The readers that rest on the program's own spans (``fill_ms.batch``,
``upload_ms.batch``) on hand-made records and trace summaries: what each
reads, nothing where no span was recorded or the trace holds no copy,
and nothing from a program without the recorder."""

import sys
import types

import pytest

from audio_matcher_tpu_torch.utils import spans
from portbench import common

MS = 1_000_000  # ns
HTOD = "Memcpy HtoD (Pinned -> Device)"


def _rec(name, t0_ms, dur_ms, group=0):
    return spans.Record(name, None, 1, group, t0_ms * MS,
                        (t0_ms + dur_ms) * MS)


def _window():
    """Two groups as the batch driver stages and dispatches them."""
    out = []
    for g, t in ((0, 0), (1, 200)):
        out += [_rec("stage.alloc", t, 1, g),
                _rec("stage.fill", t + 1, 100 + 20 * g, g),
                _rec("stage.upload", t + 130, 2, g), _rec("stage", t, 135, g),
                _rec("graph.launch", t + 140, 3, g),
                _rec("dispatch", t + 136, 30, g)]
    return out


def _run(device_ops=((HTOD, 0.044), ("major_pass", 0.5)), driver="batch"):
    trace = None if device_ops is None else {
        "device_ops": [list(op) for op in device_ops]}
    return types.SimpleNamespace(mix={"driver": driver}, trace=trace)


@pytest.mark.parametrize("metric,device_ops,want", [
    ("fill_ms.batch", None, 110.0),
    ("fill_ms.batch", (), 110.0),
    ("upload_ms.batch", ((HTOD, 0.044), ("major_pass", 0.5)), 22.0),
    ("upload_ms.batch", (("Memcpy HtoD (Pageable -> Device)", 0.004),
                         (HTOD, 0.040), ("Memcpy DtoD", 1.0)), 22.0),
], ids=["fill", "fill-cpu-trace", "upload", "upload-two-kinds"])
def test_portbench_span_readers_read_their_spans(monkeypatch, metric,
                                                 device_ops, want):
    monkeypatch.setattr(spans, "records", _window)
    assert common.reader(metric)(_run(device_ops)) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["fill_ms.batch", "upload_ms.batch"])
@pytest.mark.parametrize("case", ["no records", "no recorder",
                                  "another driver"])
def test_portbench_span_readers_find_nothing(monkeypatch, metric, case):
    run = _run()
    monkeypatch.setattr(spans, "records", lambda: [])
    if case == "no recorder":  # the program before it had spans
        monkeypatch.setattr(spans, "records", _window)
        monkeypatch.setitem(sys.modules,
                            "audio_matcher_tpu_torch.utils.spans", None)
    elif case == "another driver":
        monkeypatch.setattr(spans, "records", _window)
        run = _run(driver="serial")
    assert common.reader(metric)(run) is None


@pytest.mark.parametrize("device_ops", [None, (), (("major_pass", 0.5),)],
                         ids=["untraced", "cpu-trace", "no-copy"])
def test_portbench_upload_needs_a_copy_in_the_trace(monkeypatch, device_ops):
    """On the CPU the trace holds no device event: only the fill reads."""
    monkeypatch.setattr(spans, "records", _window)
    assert common.reader("upload_ms.batch")(_run(device_ops)) is None
