"""The result line of a run: its keys, its metrics by the cell's entries
in BENCHMARK.json, and the check last."""

import json

import pytest

from portbench import cell, common
from portbench.tests.small import cells, overrides

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload,trace,cards", [
    (w, trace, cards) for w in cells()
    for trace, cards in ((False, 1), (True, 1), (False, 4))])
def test_portbench_the_last_line_has_the_contracts_keys(workload, trace,
                                                        cards):
    bench = common.benchmark()
    over = overrides(workload, cards)
    line = cell.run(workload, 2**31 + 99, 0.3, trace, "cpu",
                    overrides=over, say=lambda s: None)
    json.dumps(line)
    want = KEYS + (["breakdown"] if trace else []) + ["check"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert dev["count"] == cell.files(workload, bench, over)[1]["devices"]
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"]: m["unit"]
             for m in common.metrics_of(bench, workload, trace)}
    # every metric of the cell is read; on the CPU the device trace is
    # empty and no step is graphed, so those readers find nothing and
    # their metrics are left out
    card_only = {m["name"] for m in bench["per_layer"]
                 if m["source"] in ("device_trace", "program_counter")}
    assert set(line["metrics"]) == set(names) - card_only
    for name, m in line["metrics"].items():
        assert m["unit"] == names[name] and m["value"] == m["value"]
    for name, v in line["check"].items():
        assert "value" in v and len(v) == 2
