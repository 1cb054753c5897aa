"""``SnippetMatcher.match`` as the matcher CLI calls it, on the CPU at the
small sizes of ``portbench/tests/small.py`` (one query, 2 windows a slab,
2 slabs a live group, so a 30 s episode scans 4 slabs in 2 groups).

On 3 seeds of the benchmark's traffic for ``snippet_1h.serial``, the
live path (a progress callback) and the one-call path (none) find the
plain reference's positions (``portbench/reference/xcorr_peaks.py``),
with heights and prominences within the cell's limits; both scan more
than one slab. The spans (``utils/spans.py``) of a call: under a
profiler one ``match``, and a ``dispatch`` and a ``collect`` (with
``collect.wait`` inside) a scan group; with no profiler, none.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from audio_matcher_tpu_torch.models.matcher import (  # noqa: E402
    MatchConfig,
    SnippetMatcher,
)
from audio_matcher_tpu_torch.utils import spans  # noqa: E402
from portbench import cell, generator  # noqa: E402
from portbench.reference import xcorr_peaks as ref  # noqa: E402
from portbench.tests.small import overrides  # noqa: E402

CELL = "snippet_1h.serial"
SEEDS = [2**31 + 24, 2**31 + 240, 2**31 + 2400]
LIMIT = 1e-4  # the cell's height_gap and prominence_gap


def _files():
    over = overrides(CELL)
    over["config"]["queries"]["count"] = 1
    over["config"]["match"].update(slab=2, progress_slabs_per_dispatch=2)
    over["traffic"]["grouping"]["max_rows"] = 1
    return cell.files(CELL, overrides=over)


def _matcher(cfg, tr):
    return SnippetMatcher(tr.queries[0], tr.sr, MatchConfig(**cfg["match"]),
                          device="cpu")


def _match(m, samples, live: bool):
    progress = (lambda phase, k: None) if live else None
    return m.match(samples, scale=True, n_samples=len(samples),
                   progress=progress)


@pytest.fixture(scope="module")
def traffic():
    cfg, mix = _files()
    return cfg, {s: generator.make(cfg, mix, s, torch.device("cpu"))
                 for s in SEEDS}


@pytest.mark.parametrize("live", [True, False], ids=["live", "one-call"])
@pytest.mark.parametrize("seed", SEEDS)
def test_both_paths_find_the_references_peaks(traffic, seed, live):
    cfg, by_seed = traffic
    tr = by_seed[seed]
    m = _matcher(cfg, tr)
    geo = ref.geometry(cfg, [len(tr.queries[0])])
    compared = 0
    for e, samples in enumerate(tr.episodes):
        got = _match(m, samples, live)
        want = ref.peaks_of(ref.dequantize(samples, tr.wire, "cpu"),
                            tr.queries[0], geo)
        assert [p.position for p in got] == [w[0] for w in want], e
        assert sorted(w[0] for w in want) == sorted(
            at for _, at in tr.plants[e])
        for p, w in zip(got, want):
            assert abs(p.height - w[1]) <= LIMIT
            assert abs(p.prominence - w[2]) <= LIMIT
        compared += len(want)
    assert compared >= len(tr.episodes)


@pytest.mark.parametrize("live", [True, False], ids=["live", "one-call"])
def test_both_paths_scan_more_than_one_slab(traffic, monkeypatch, live):
    cfg, by_seed = traffic
    tr = by_seed[SEEDS[0]]
    m = _matcher(cfg, tr)
    scans = []
    real = SnippetMatcher._scan

    def scan(self, rows, ns, scale, slab, n_slabs):
        scans.append(n_slabs)
        return real(self, rows, ns, scale, slab, n_slabs)

    monkeypatch.setattr(SnippetMatcher, "_scan", scan)
    _match(m, tr.episodes[0], live)
    assert sum(scans) > 1
    assert scans == ([2, 2] if live else [4])


def _names(records):
    return [r.name for r in records]


@pytest.mark.parametrize("live", [True, False], ids=["live", "one-call"])
@pytest.mark.parametrize("profiled", [True, False],
                         ids=["profiled", "no-profiler"])
def test_a_match_records_its_spans_only_under_a_profiler(
        traffic, monkeypatch, live, profiled):
    cfg, by_seed = traffic
    tr = by_seed[SEEDS[0]]
    m = _matcher(cfg, tr)
    opened = []
    real = spans._Span

    def counted(*args):
        opened.append(args[0])
        return real(*args)

    monkeypatch.setattr(spans, "_Span", counted)
    groups = 2 if live else 1
    calls = 2
    if not profiled:
        for e in range(calls):
            _match(m, tr.episodes[e], live)
        assert opened == []
        return
    with spans.span("before"):  # off: the profiled interval opens fresh
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        want = [_match(m, tr.episodes[e], live) for e in range(calls)]
    recs = spans.records()
    names = _names(recs)
    assert names.count("match") == calls
    assert names.count("stage") == calls
    assert names.count("dispatch") == calls * groups
    assert names.count("collect") == calls * groups
    assert names.count("collect.wait") == calls * groups
    assert names.count("collect.peaks") == calls
    by = {}
    for r in recs:
        by.setdefault(r.name, set()).add(r.parent)
    assert by["match"] == {None}
    assert by["stage"] == by["dispatch"] == by["collect"] == {"match"}
    assert by["collect.wait"] == by["collect.peaks"] == {"collect"}
    # the spans change no answer
    again = [_match(m, tr.episodes[e], live) for e in range(calls)]
    assert [[(p.position, p.height, p.prominence) for p in ps]
            for ps in again] == [[(p.position, p.height, p.prominence)
                                  for p in ps] for ps in want]
    assert np.all([len(ps) > 0 for ps in want])
