"""A configuration, a traffic mix and a per-layer metric added as new files
and new entries of BENCHMARK.json, with no edit to a file already there,
run as a cell of their own."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_portbench_new_files_make_a_new_cell(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "batch_scan.json").read_text())
    cfg.update(name="batch_q2", queries=dict(cfg["queries"], count=2))
    (pb / "configs" / "batch_q2.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "equal.json").read_text())
    mix["episodes"]["count"] = 2
    (pb / "traffic" / "pair.json").write_text(json.dumps(mix))
    (pb / "metrics" / "groups_per_s.batch.py").write_text(
        "def read(run):\n    return len(run.items) / run.window_s\n")
    bench["configs"].append(dict(bench["configs"][0], name="batch_q2",
                                 file="portbench/configs/batch_q2.json"))
    bench["workloads"].append({"name": "batch_q2.pair", "config": "batch_q2",
                               "traffic": "pair", "chips": 1, "why": "new"})
    bench["per_layer"].append({
        "name": "groups_per_s.batch", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "entry",
        "moves": "pair_hours_per_s", "workloads": ["batch_q2.pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from portbench import cell\n"
        "from portbench.tests.small import overrides\n"
        "over = overrides('batch_scan.equal')\n"
        "over['traffic']['episodes']['count'] = 2\n"
        "print(json.dumps(cell.run('batch_q2.pair', 5, 0.3, True, 'cpu',"
        " overrides=over, say=lambda s: None)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         check=True, capture_output=True, text=True,
                         timeout=600).stdout
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["groups_per_s.batch"]["value"] > 0
    assert line["metrics"]["groups_per_s.batch"]["unit"] == "1/s"
