"""Small sizes for running the cells on the CPU (the port's plain
versions): 4 kHz audio, 4 s chunks, 1-1.25 s queries, 30 s episodes,
groups of 2; with ``cards`` > 1 the same traffic over a mesh of that many
CPU shards."""

import copy

_BASE = {
    "config": {"sample_rate": 4000,
               "queries": {"count": 4, "secs_base": 1.0, "secs_step": 0.25,
                           "secs_cycle": 2},
               "match": {"chunk_secs": 4.0, "distance_secs": 8.0}},
    "traffic": {"episodes": {"count": 4, "secs": 30},
                "plants": {"first_secs": [0.5, 2], "gap_secs": 10,
                           "jitter_secs": 0.5},
                "grouping": {"max_rows": 2}},
}


def overrides(workload: str, cards: int = 1) -> dict:
    """The overrides that shrink ``workload`` for the CPU."""
    over = copy.deepcopy(_BASE)
    if cards > 1:
        over["traffic"]["devices"] = cards
        over["traffic"]["grouping"]["max_rows"] = cards
    return over


def config_and_mix(workload: str, cards: int = 1):
    """The cell's configuration and traffic mix at the small sizes."""
    from portbench import cell

    return cell.files(workload, overrides=overrides(workload, cards))


def cells() -> list[str]:
    """Every cell of ``BENCHMARK.json``."""
    from portbench import common

    return [w["name"] for w in common.benchmark()["workloads"]]
