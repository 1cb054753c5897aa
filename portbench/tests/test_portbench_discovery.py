"""A configuration, a traffic mix, a driver and a per-layer metric added as
new files and new entries of BENCHMARK.json, with no edit to a file
already there, run as a cell of their own: untraced it reports the
end-to-end metrics, for the ``batch`` driver and for one of another name,
on one card and over four shards; traced, the new per-layer metric."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

# a driver under a name of its own: the sweep's scanner, but a group staged,
# scanned and collected before the next is staged
ONE_BY_ONE = '''\
import time

from audio_matcher_tpu_torch.models.matcher import MatchConfig
from audio_matcher_tpu_torch.parallel.sweep import ShardedScanner

from portbench.check import as_triples


def _scan(sc, tr, k):
    eps = tr.group(k)
    return eps, sc.scan_resident([tr.episodes[e] for e in eps])


def build(ctx):
    tr = ctx.traffic
    sc = ShardedScanner(tr.queries, tr.sr, MatchConfig(**ctx.cfg["match"]),
                        device=ctx.where)
    for k in range(len(tr.groups)):
        _scan(sc, tr, k)
    return sc


def window(sc, ctx):
    tr, items, answers = ctx.traffic, [], []
    t0 = time.perf_counter()
    while not items or time.perf_counter() < t0 + ctx.seconds:
        eps, peaks = _scan(sc, tr, len(items))
        for e, per_query in zip(eps, peaks):
            for q, pk in enumerate(per_query):
                answers.append((len(items), e, q, as_triples(pk)))
        items.append({"episodes": eps, "pair_hours": sum(
            tr.seconds(e) for e in eps) / 3600.0 * len(tr.queries)})
    return {"window_s": time.perf_counter() - t0, "items": items,
            "answers": answers, "graph": {},
            "seen": [e for i in items for e in i["episodes"]]}


def release(sc):
    pass
'''

END_TO_END = {"pair_hours_per_s", "setup_s"}


def _hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("driver,devices,trace", [
    ("batch", 1, True), ("one_by_one", 1, False),
    ("one_by_one", 4, False), ("batch", 4, False)],
    ids=["batch-traced-per-layer", "one_by_one-1", "one_by_one-4",
         "batch-4"])
def test_portbench_new_files_make_a_new_cell(tmp_path, driver, devices,
                                             trace):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _hashes(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"

    cfg = json.loads((pb / "configs" / "batch_scan.json").read_text())
    cfg.update(name="batch_q2", queries=dict(cfg["queries"], count=2))
    (pb / "configs" / "batch_q2.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "equal.json").read_text())
    mix.update(driver=driver, devices=devices)
    mix["episodes"]["count"] = 2
    traffic = f"new_{driver}_{devices}"
    (pb / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
    if driver != "batch":
        (pb / "drivers" / f"{driver}.py").write_text(ONE_BY_ONE)
    workload = f"batch_q2.{traffic}"
    bench["configs"].append(dict(bench["configs"][0], name="batch_q2",
                                 file="portbench/configs/batch_q2.json"))
    bench["workloads"].append({"name": workload, "config": "batch_q2",
                               "traffic": traffic, "chips": devices,
                               "why": "new"})
    if trace:
        (pb / "metrics" / "groups_per_s.batch.py").write_text(
            "def read(run):\n    return len(run.items) / run.window_s\n")
        bench["per_layer"].append({
            "name": "groups_per_s.batch", "unit": "1/s", "better": "higher",
            "source": "host_clock", "layer": "entry",
            "moves": "pair_hours_per_s", "workloads": [workload]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from portbench import cell\n"
        "from portbench.tests.small import overrides\n"
        "over = overrides('batch_scan.equal')\n"
        "over['traffic']['episodes']['count'] = 2\n"
        f"over['traffic']['grouping']['max_rows'] = max(2, {devices})\n"
        f"print(json.dumps(cell.run({workload!r}, 5, 0.3, {trace}, 'cpu',"
        " overrides=over, say=lambda s: None)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         check=True, capture_output=True, text=True,
                         timeout=600).stdout
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["count"] == devices
    metrics = line["metrics"]
    if trace:
        assert metrics["groups_per_s.batch"]["value"] > 0
        assert metrics["groups_per_s.batch"]["unit"] == "1/s"
    else:
        assert set(metrics) == END_TO_END
        assert metrics["pair_hours_per_s"]["value"] > 0
        assert metrics["pair_hours_per_s"]["unit"] == "pair-h/s"
        assert metrics["setup_s"]["value"] > 0

    # the cell took new files and new entries only
    after = _hashes(tmp_path)
    changed = [p for p, h in before.items() if after.get(p) != h]
    assert changed == ["BENCHMARK.json"]  # its new entries
