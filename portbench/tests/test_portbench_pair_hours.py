"""``pair_hours_per_s`` on hand-made records: the ``batch`` driver's
window reads as it always has, float for float; another driver's window
reads its items' ``pair_hours`` over its seconds; nothing where no item
carries ``pair_hours``."""

import types

import pytest

from portbench import common


def _batch_reader_before(run):
    """The reader as it stood when it read the ``batch`` driver alone."""
    if run.mix["driver"] != "batch" or not run.items:
        return None
    return sum(g["pair_hours"] for g in run.items) / run.window_s


def _run(driver, items, window_s=50.0123456789):
    return types.SimpleNamespace(mix={"driver": driver}, items=items,
                                 window_s=window_s)


# 3 rows of 1 h (and one of 0.7 h) against 4 queries, as the batch driver
# records a group
BATCH = [{"episodes": [0, 1, 2], "F": 1.0, "B": 2.0, "pair_hours": 12.0},
         {"episodes": [3, 4, 5], "F": 1.0, "B": 2.0,
          "pair_hours": (1 + 1 + 0.7) * 4}] * 7
SERIAL = [{"pair_hours": 1.0}] * 3 + [{"pair_hours": 0.1}]


@pytest.mark.parametrize("driver,items,want", [
    ("batch", BATCH, _batch_reader_before(_run("batch", BATCH))),
    ("serial", SERIAL, 3.1 / 50.0123456789),
    ("serial", SERIAL + [{"answered": 0}], 3.1 / 50.0123456789),
    ("serial", [{"answered": 1}, {}], None),
    ("batch", [], None),
    ("serial", [], None),
], ids=["batch-as-before", "another-driver", "some-items-without",
        "no-item-with", "batch-no-items", "no-items"])
def test_portbench_pair_hours_per_s_reads_any_window(driver, items, want):
    got = common.reader("pair_hours_per_s")(_run(driver, items))
    if want is None:
        assert got is None
    elif driver == "batch":
        assert got == want  # the same float, not an approximation
    else:
        assert got == pytest.approx(want, rel=1e-15)
