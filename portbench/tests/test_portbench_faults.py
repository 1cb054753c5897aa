"""``correct`` must come out false for the control and for every fault a
cell can have, at the small sizes on the CPU: the plain reference in
bfloat16 in the program's place (the control); an answer altered where it
is produced; half of a group's episodes left out; on a mesh (the cell's
traffic over 4 CPU shards, as a 4-card cell would run it), the cards past
the first never reaching the host. (A step that returns its state
unchanged is a training cell's fault: no cell here trains.)"""

import dataclasses

import numpy as np
import pytest
import torch

from audio_matcher_tpu_torch.parallel import sweep
from portbench import cell, check, generator
from portbench.tests.small import cells, config_and_mix, overrides

SEED = 2**31 + 12345
RUNS = [(w, cards) for w in cells() for cards in (1, 4)]


def _run(workload: str, cards: int = 1) -> dict:
    return cell.run(workload, SEED, 0.3, False, "cpu",
                    overrides=overrides(workload, cards), say=lambda s: None)


@pytest.mark.parametrize("workload", cells())
def test_portbench_the_control_is_not_correct(workload):
    cfg, mix = config_and_mix(workload)
    for seed in (SEED, SEED + 1, SEED + 2):
        tr = generator.make(cfg, mix, seed, torch.device("cpu"))
        pairs = check.sample_pairs(tr, mix, seed,
                                   [e for g in tr.groups for e in g])
        ok, shown = check.judge(check.control(tr, cfg, pairs, "cpu"),
                                cfg["limits"])
        assert not ok, shown


@pytest.mark.parametrize("workload,cards", RUNS)
def test_portbench_sound_runs_are_correct(workload, cards):
    assert _run(workload, cards)["correct"] is True


def _moved(peaks):
    return [dataclasses.replace(p, position=p.position + 1) for p in peaks]


@pytest.mark.parametrize("workload,cards", RUNS)
def test_portbench_an_answer_altered_is_not_correct(workload, cards,
                                                    monkeypatch):
    real = sweep.ShardedScanner._peaks

    def peaks(self, arrays, ns, n_real):
        out = real(self, arrays, ns, n_real)
        for per_query in out:
            for q, pk in enumerate(per_query):
                if pk:
                    per_query[q] = _moved(pk)
                    return out
        return out

    monkeypatch.setattr(sweep.ShardedScanner, "_peaks", peaks)
    assert _run(workload, cards)["correct"] is False


@pytest.mark.parametrize("workload,cards", RUNS)
def test_portbench_half_the_batch_left_out_is_not_correct(workload, cards,
                                                          monkeypatch):
    real = sweep._Scanner.scan_collect

    def collect(self, dispatched):
        out = real(self, dispatched)
        for e in range(len(out) // 2, len(out)):
            out[e] = [[] for _ in out[e]]
        return out

    monkeypatch.setattr(sweep._Scanner, "scan_collect", collect)
    assert _run(workload, cards)["correct"] is False


@pytest.mark.parametrize("workload", cells())
def test_portbench_the_cards_results_left_out_is_not_correct(workload,
                                                             monkeypatch):
    def collect(self, dispatched):
        outs, ns, n_real, ready = dispatched
        shards = [sweep.read_back(o, r) for o, r in zip(outs, ready)]
        for parts in shards[1:]:  # never gathered from cards 1-3
            parts[1][...] = -np.inf
        arrays = [np.concatenate(parts) for parts in zip(*shards)]
        return self._peaks(arrays, ns, n_real)

    monkeypatch.setattr(sweep._Scanner, "scan_collect", collect)
    assert _run(workload, 4)["correct"] is False
