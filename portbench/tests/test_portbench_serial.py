"""The cell ``snippet_1h.serial`` on the CPU at the small sizes (one query,
2 windows a slab and 2 slabs a live group, so every request takes the
matcher CLI's live path in 2 groups; a group of the traffic is one
request): untraced, ``correct`` with both end-to-end metrics; traced,
its ``.single`` readers on what the run recorded and on a hand-made trace,
the ``.batch`` readers silent on it and the ``.single`` ones on
``batch_scan.equal``; an answer altered, or a live scan's second group
never read back, is not correct. And the cell is new files and new entries of
``BENCHMARK.json`` only."""

import dataclasses
import io
import json
import shutil
import subprocess
import sys
import tarfile
import types
from pathlib import Path

import pytest

from audio_matcher_tpu_torch.models.matcher import SnippetMatcher
from portbench import cell, common
from portbench.tests.small import overrides

ROOT = Path(__file__).resolve().parents[2]
CELL = "snippet_1h.serial"
SEED = 2**31 + 2424
SINGLE = ["fill_ms.single", "upload_ms.single", "graph_hit_pct.single",
          "corr_roofline_pct.single", "collect_ms.single",
          "device_idle_pct.single"]
# what the readers find on the CPU: the program's spans (no device trace,
# no graph)
ON_THE_CPU = {"fill_ms.single", "collect_ms.single"}
# the harness as it stood before the cell
PARENT = "53cef704492918237780e25d0235e396a44da4dc"


def _over(workload=CELL):
    over = overrides(workload)
    if workload == CELL:
        over["config"]["queries"]["count"] = 1
        over["config"]["match"].update(slab=2,
                                       progress_slabs_per_dispatch=2)
        over["traffic"]["grouping"]["max_rows"] = 1
    return over


def _run(trace: bool, workload=CELL, seconds=0.4) -> dict:
    return cell.run(workload, SEED, seconds, trace, "cpu",
                    overrides=_over(workload), say=lambda s: None)


def test_portbench_serial_untraced_is_correct_with_the_end_to_end_metrics():
    line = _run(False)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    m = line["metrics"]
    assert set(m) == {"pair_hours_per_s", "setup_s"}
    assert m["pair_hours_per_s"]["value"] > 0
    assert m["setup_s"]["value"] > 0
    assert line["check"]["peaks_compared"]["value"] >= 1


def test_portbench_serial_traced_reports_its_span_readers():
    line = _run(True)
    assert line["correct"] is True
    assert set(line["metrics"]) == ON_THE_CPU
    for name in ON_THE_CPU:
        assert line["metrics"][name]["value"] > 0


def _record(driver="serial", n_items=4):
    """A traced window of ``n_items`` requests, as a run hands it to the
    readers, with a device trace summary and the matchers' graph stats."""
    cfg, mix = cell.files(CELL)
    mix = dict(mix, driver=driver)
    F, B = 28.4e9, 0.652e9
    return types.SimpleNamespace(
        cfg=cfg, mix=mix, window_s=0.4, setup_s=1.0,
        items=[{"episode": 0, "F": F, "B": B, "pair_hours": 1.0}]
        * n_items,
        graph={"hits": 2 * n_items},
        spans={},
        trace={"window_s": 0.4, "busy_s": 0.1, "kernel_s": 0.06,
               "device_ops": [["Memcpy HtoD (Pinned -> Device)", 0.056],
                              ["major_pass", 0.03]]})


def _span_records(n_items=4):
    from audio_matcher_tpu_torch.utils import spans

    out = []
    for k in range(n_items):
        t = k * 100_000_000
        out += [spans.Record("stage.fill", "stage", 1, None, t,
                             t + 23_000_000),
                spans.Record("collect.peaks", "collect", 1, None,
                             t + 60_000_000, t + 62_000_000)]
    return out


def test_portbench_serial_readers_read_a_traced_window(monkeypatch):
    from audio_matcher_tpu_torch.utils import spans

    monkeypatch.setattr(spans, "records", _span_records)
    run = _record()
    want = {"fill_ms.single": 23.0, "collect_ms.single": 2.0,
            "upload_ms.single": 14.0, "graph_hit_pct.single": 100.0,
            "device_idle_pct.single": 75.0,
            "corr_roofline_pct.single":
                100 * 4 * 28.4e9 / 67e12 / 0.06}
    for name in SINGLE:
        assert common.reader(name)(run) == pytest.approx(want[name]), name


@pytest.mark.parametrize("metric", SINGLE)
def test_portbench_single_readers_are_silent_on_the_batch_cell(monkeypatch,
                                                               metric):
    from audio_matcher_tpu_torch.utils import spans

    monkeypatch.setattr(spans, "records", _span_records)
    assert common.reader(metric)(_record(driver="batch")) is None


def test_portbench_batch_readers_are_silent_on_this_cell(monkeypatch):
    from audio_matcher_tpu_torch.utils import spans

    monkeypatch.setattr(spans, "records", _span_records)
    bench = common.benchmark()
    batch = [m["name"] for m in bench["per_layer"]
             if m["name"].endswith(".batch")]
    assert batch
    for name in batch:
        assert common.reader(name)(_record()) is None, name


def test_portbench_single_metrics_list_this_cell_only():
    bench = common.benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in SINGLE:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "pair_hours_per_s"
    assert {m["name"] for m in common.metrics_of(bench, CELL, True)} == \
        set(SINGLE)
    assert not set(SINGLE) & {
        m["name"] for m in common.metrics_of(bench, "batch_scan.equal",
                                             True)}


def test_portbench_batch_cell_traced_reads_no_single_metric():
    line = _run(True, "batch_scan.equal", 0.3)
    assert line["correct"] is True
    assert not any(name.endswith(".single") for name in line["metrics"])


def test_portbench_serial_an_answer_altered_is_not_correct(monkeypatch):
    real = SnippetMatcher.match

    def match(self, *a, **kw):
        out = real(self, *a, **kw)
        if out:
            out[0] = dataclasses.replace(out[0],
                                         position=out[0].position + 1)
        return out

    monkeypatch.setattr(SnippetMatcher, "match", match)
    assert _run(False)["correct"] is False


def test_portbench_serial_a_group_left_out_of_a_live_scan_is_not_correct(
        monkeypatch):
    """The live path's second group never read back: its windows' peaks
    go missing."""
    real = SnippetMatcher._scan_episode
    calls = []

    def scan(self, episode_dev, n, scale, kw):
        out = real(self, episode_dev, n, scale, kw)
        calls.append(1)
        if len(calls) % 2 == 0:
            out = tuple(a.clone() for a in out)
            out[1].fill_(float("-inf"))
        return out

    monkeypatch.setattr(SnippetMatcher, "_scan_episode", scan)
    assert _run(False)["correct"] is False


NEW_FILES = ["portbench/configs/snippet_1h.json",
             "portbench/traffic/serial.json", "portbench/drivers/serial.py"
             ] + [f"portbench/metrics/{m}.py" for m in SINGLE]


def test_portbench_serial_cell_is_new_files_and_new_entries(tmp_path):
    """The harness as it stood before the cell (``PARENT``), with the
    cell's new files laid over it and its new entries appended to its
    ``BENCHMARK.json``, runs the cell: no file that was there needed an
    edit. The new files were not there; every entry that was is kept, in
    its place."""
    try:
        archive = subprocess.run(
            ["git", "archive", PARENT, "portbench", "BENCHMARK.json"],
            cwd=ROOT, capture_output=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"needs the repository's history: {e}")
    with tarfile.open(fileobj=io.BytesIO(archive)) as tar:
        tar.extractall(tmp_path, filter="data")
    old = json.loads((tmp_path / "BENCHMARK.json").read_text())
    new = common.benchmark()
    for key, value in old.items():
        if isinstance(value, list):
            assert new[key][: len(value)] == value, key
        else:
            assert new[key] == value, key
    added = {k: [e["name"] for e in new[k][len(old[k]):]]
             for k in ("configs", "workloads", "end_to_end", "per_layer")}
    assert added == {"configs": ["snippet_1h"], "workloads": [CELL],
                     "end_to_end": [], "per_layer": SINGLE}
    for path in NEW_FILES:
        assert not (tmp_path / path).exists(), path
        shutil.copy(ROOT / path, tmp_path / path)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))

    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from portbench import cell\n"
        f"over = json.loads({json.dumps(_over())!r})\n"
        f"print(json.dumps(cell.run({CELL!r}, {SEED}, 0.3, False, 'cpu',"
        " overrides=over, say=lambda s: None)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         check=True, capture_output=True, text=True,
                         timeout=600).stdout
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["pair_hours_per_s"]["value"] > 0
