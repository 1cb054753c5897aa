"""The traffic: the same from the same seed, other from another, the same
lengths and groups for every seed; plants inside their episodes and apart;
and the frozen grouping rule against ``sweep_archive``'s own."""

import numpy as np
import pytest
import torch

from portbench import generator
from portbench.tests.small import cells, config_and_mix

CELLS = cells()


def _make(workload, seed):
    cfg, mix = config_and_mix(workload)
    return generator.make(cfg, mix, seed, torch.device("cpu"))


@pytest.mark.parametrize("workload", CELLS)
def test_portbench_the_same_seed_gives_the_same_traffic(workload):
    a, b = _make(workload, 2**31 + 7), _make(workload, 2**31 + 7)
    assert a.groups == b.groups and a.start == b.start
    assert a.plants == b.plants
    for x, y in zip(a.queries + a.episodes, b.queries + b.episodes):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("workload", CELLS)
def test_portbench_another_seed_gives_other_traffic(workload):
    a, b = _make(workload, 11), _make(workload, 12)
    assert not np.array_equal(a.queries[0], b.queries[0])
    assert not np.array_equal(a.episodes[0], b.episodes[0])
    # the same work in another order: the same lengths and groups
    assert [len(e) for e in a.episodes] == [len(e) for e in b.episodes]
    assert a.groups == b.groups


@pytest.mark.parametrize("workload", CELLS)
def test_portbench_plants_lie_inside_their_episodes_and_apart(workload):
    for seed in range(5):
        tr = _make(workload, seed)
        cfg, mix = config_and_mix(workload)
        gap = (mix["plants"]["gap_secs"] - mix["plants"]["jitter_secs"]) \
            * tr.sr
        assert gap > cfg["match"]["distance_secs"] * tr.sr
        for e, ep in enumerate(tr.episodes):
            at = sorted(p for _, p in tr.plants[e])
            assert all(0 <= p and p + len(tr.queries[q]) <= len(ep)
                       for q, p in tr.plants[e])
            assert all(b - a >= gap for a, b in zip(at, at[1:]))


def test_portbench_the_grouping_rule_is_the_sweeps(monkeypatch, tmp_path):
    from audio_matcher_tpu_torch.hostio import prefetch
    from audio_matcher_tpu_torch.models.matcher import MatchConfig
    from audio_matcher_tpu_torch.parallel import sweep

    rng = np.random.default_rng(3)
    lengths = [int(rng.choice([600, 1800, 3600]) * rng.uniform(0.9, 1.1))
               for _ in range(40)]
    max_bytes = 2 * 3600 * 3
    seen = []

    class Scanner:
        def __init__(self, snippets, sr, config, device):
            self.sr, self.config = sr, MatchConfig(transfer_dtype="int16")
            self.device, self.devices = torch.device("cpu"), [None]
            self.step_graphs = None

        def describe(self):
            return "fake"

        def stage_resident(self, episodes):
            seen.append([len(e) for e in episodes])
            return episodes

        def scan_dispatch(self, staged):
            return staged

        def scan_collect(self, dispatched):
            return [[[]] for _ in dispatched]

    def decoded(todo, **kw):
        for p in todo:
            yield prefetch.DecodedFile(p, 1, np.zeros(int(p.stem[1:]),
                                                      np.int16))

    monkeypatch.setattr(sweep, "ShardedScanner", Scanner)
    monkeypatch.setattr(prefetch, "decode_prefetched", decoded)
    monkeypatch.setenv("AUDIO_MATCHER_GROUP_BYTES", str(max_bytes))
    paths = [tmp_path / f"e{n}" for n in lengths]
    sweep.sweep_archive(paths, [np.ones(4, np.float32)], 1, device="cpu",
                        group_size=8)
    ours = generator.group_rule([2 * n for n in lengths], 8, max_bytes)
    assert seen == [[lengths[i] for i in g] for g in ours]
