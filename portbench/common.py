"""Finding a cell's pieces by name, from ``BENCHMARK.json`` and the files
beside it, and the seeds every random stream of a run is drawn from."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout: BENCHMARK.json and the port's package


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def load_module(path: Path):
    """A module from a file, under a name of its own (metric files carry
    dots in their names, so they are not importable by name)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_file_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    return load_module(HERE / "drivers" / f"{name}.py")


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` False) or its per-layer
    ones: those that list it under ``workloads``, and those without that
    key."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The ``read(run)`` function of metric ``name``."""
    return load_module(HERE / "metrics" / f"{name}.py").read


def stream_seed(seed: int, *stream: str) -> int:
    """A 63-bit seed for one named random stream of a run: the same run
    seed gives the same streams, another seed other ones."""
    words = [int(seed) % (1 << 64)] + [
        int.from_bytes(s.encode(), "little") % (1 << 64) for s in stream]
    state = np.random.SeedSequence(words).generate_state(2, np.uint64)
    return int(state[0]) >> 1


def rng(seed: int, *stream: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, *stream))
