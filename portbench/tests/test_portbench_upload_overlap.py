"""The readers of the program's staging counter (``upload_overlap_pct.*``)
on hand-set counts: the share of early bytes for their own driver,
nothing for the other driver, before any staging, or from a program
without the counter."""

import collections
import types

import pytest

from audio_matcher_tpu_torch.models import matcher
from portbench import common

DRIVERS = {"upload_overlap_pct.batch": "batch",
           "upload_overlap_pct.single": "serial"}


def _run(driver):
    return types.SimpleNamespace(mix={"driver": driver}, trace=None,
                                 items=[{}])


@pytest.mark.parametrize("metric", DRIVERS)
def test_portbench_upload_overlap_reads_the_early_share(monkeypatch,
                                                        metric):
    monkeypatch.setattr(matcher, "STAGING_STATS", collections.Counter(
        staged_bytes=4000, early_bytes=3900))
    got = common.reader(metric)(_run(DRIVERS[metric]))
    assert got == pytest.approx(97.5)


@pytest.mark.parametrize("metric", DRIVERS)
@pytest.mark.parametrize("case", ["no counter", "nothing staged",
                                  "another driver"])
def test_portbench_upload_overlap_finds_nothing(monkeypatch, metric, case):
    driver = DRIVERS[metric]
    monkeypatch.setattr(matcher, "STAGING_STATS", collections.Counter(
        staged_bytes=4000, early_bytes=3900))
    if case == "no counter":  # the program before it counted
        monkeypatch.delattr(matcher, "STAGING_STATS")
    elif case == "nothing staged":
        monkeypatch.setattr(matcher, "STAGING_STATS", collections.Counter())
    else:
        driver = "serial" if driver == "batch" else "batch"
    assert common.reader(metric)(_run(driver)) is None
