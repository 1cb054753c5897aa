#!/usr/bin/env python3
"""The archive sweep with its scan steps graphed against eager, on one GPU.

    python3 probe_sweep_graphs.py [--files 24] [--order eager,graphed,...]

Writes two seed-42 wav archives at 44.1 kHz (int16) into a temporary
directory and sweeps each with ``parallel.sweep.sweep_archive`` (the
sweep cell's settings: 4 queries of 10-11.5 s, int16 wire, chunk 60 s,
distance 480 s, groups of 8 under ``AUDIO_MATCHER_GROUP_BYTES``), once a
turn in ``--order``:

* ``mixed``: ``--files`` episodes whose lengths are drawn from the
  lengths of the repo's cells, 600 s (the archive sweep's files), 1800 s
  (config #3, ``bench.py``'s episode) and 3600 s (config #2,
  BASELINE.json's 1-hour episode), one of the three at random a file,
  each times a uniform factor in [0.9, 1.1], whole seconds; named in
  random order of length;
* ``uniform``: as many files of 600 s (the archive sweep's cell).

Every query is planted once in every file (at 2 + 14·q s). A turn
``graphed`` runs the default scanner (steps replayed as CUDA graphs,
``parallel/step_graph.py``); ``eager`` the same sweep with the scanner's
``graphs=False``. For each turn: the wall (decode, stage, scan, collect;
files written before), files/s, pair audio-hours/s, the groups' step
cache counts (eager first sights, captures, hits, evictions) and the hit
rate, and peak device memory. Every turn must find every plant within 1
sample, and all turns the same peaks. Prints the card's ``nvidia-smi``
name and power limit and writes the summary to
``chiprun_out/probe_sweep_graphs.json``.
"""

from __future__ import annotations

import argparse
import ast
import json
import logging
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from audio_matcher_tpu_torch.models.matcher import MatchConfig
from audio_matcher_tpu_torch.parallel import sweep
from chip_smoke import SNIPPET_SECS, SR, write_mono_wav

QUERIES = 4
CELL_SECS = (600, 1800, 3600)


def make_archive(root: Path, mix: str, n_files: int):
    """The archive's snippets and files → (snippets, paths, plants)."""
    rng = np.random.default_rng(42)
    snippets = [
        np.clip(rng.standard_normal(int((SNIPPET_SECS + 0.5 * q) * SR))
                * 0.15, -0.45, 0.45).astype(np.float32)
        for q in range(QUERIES)
    ]
    if mix == "mixed":
        secs = [int(round(s * rng.uniform(0.9, 1.1)))
                for s in rng.choice(CELL_SECS, n_files)]
    else:
        secs = [CELL_SECS[0]] * n_files
    paths, plants = [], {}
    for e, n in enumerate(secs):
        x = rng.standard_normal(n * SR, dtype=np.float32) * np.float32(0.05)
        at = [int((2.0 + 14.0 * q) * SR) for q in range(QUERIES)]
        for q, i in enumerate(at):
            x[i : i + len(snippets[q])] = snippets[q]
        path = root / f"{mix}_{e:03d}.wav"
        write_mono_wav(path, SR, x)
        paths.append(path)
        plants[str(path)] = at
    return snippets, paths, plants, secs


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


class _EagerScanner(sweep.ShardedScanner):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, graphs=False, **kwargs)


def sweep_turn(mode, paths, snippets, config):
    """One ``sweep_archive`` → (results, wall s, step cache counts)."""
    records = _Records()
    logger = logging.getLogger("audio_matcher_torch.sweep")
    logger.addHandler(records)
    logger.setLevel(logging.INFO)
    graphed_scanner = sweep.ShardedScanner
    if mode == "eager":
        sweep.ShardedScanner = _EagerScanner
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results = sweep.sweep_archive(paths, snippets, SR, config,
                                      device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sweep.ShardedScanner = graphed_scanner
        logger.removeHandler(records)
    stats = {}
    for m in records.messages:
        if m.startswith("sweep: step graphs "):
            stats = ast.literal_eval(m.split(" graphs ", 1)[1])
    return results, wall, stats


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--files", type=int, default=24)
    ap.add_argument("--order", default="eager,graphed,graphed,eager")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    config = MatchConfig(transfer_dtype="int16")
    summary = {"card": card, "archives": {}}
    for mix in ("mixed", "uniform"):
        with tempfile.TemporaryDirectory(prefix="am_probe_") as tmp:
            t0 = time.perf_counter()
            snippets, paths, plants, secs = make_archive(
                Path(tmp), mix, args.files)
            print(f"{mix}: {len(paths)} files, {sum(secs)} s of audio "
                  f"(lengths {sorted(secs)}), written in "
                  f"{time.perf_counter() - t0:.1f} s")
            pair_h = QUERIES * sum(secs) / 3600.0
            turns, first = [], None
            for mode in args.order.split(","):
                results, wall, stats = sweep_turn(mode, paths, snippets,
                                                  config)
                for path, at in plants.items():
                    for q, i in enumerate(at):
                        found = [p.position for p in results[path][q]]
                        if not any(abs(f - i) <= 1 for f in found):
                            raise AssertionError(
                                f"{mode}, {path}, query {q}: plant at {i}, "
                                f"found {found}")
                if first is None:
                    first = results
                elif results != first:
                    raise AssertionError(f"{mix}, {mode}: peaks differ")
                calls = sum(stats.get(k, 0)
                            for k in ("first", "captures", "hits"))
                turn = {
                    "mode": mode, "wall_s": wall,
                    "files_per_s": len(paths) / wall,
                    "pair_audio_hours_per_s": pair_h / wall,
                    "groups": calls or None, "step_graphs": stats,
                    "peak_allocated_gb":
                        torch.cuda.max_memory_allocated() / 1e9,
                    "peak_reserved_gb":
                        torch.cuda.max_memory_reserved() / 1e9,
                }
                turns.append(turn)
                print(f"{mix}, {mode}: wall {wall:.3f} s, "
                      f"{turn['files_per_s']:.3f} files/s, "
                      f"{turn['pair_audio_hours_per_s']:.3f} pair "
                      f"audio-hours/s; step graphs {stats}, hit rate "
                      f"{stats.get('hits', 0)}/{calls} groups; peak "
                      f"allocated {turn['peak_allocated_gb']:.2f} GB, "
                      f"reserved {turn['peak_reserved_gb']:.2f} GB; {card}")
            print(f"{mix}: every plant found within 1 sample in every "
                  f"turn, the peaks of all turns equal")
            summary["archives"][mix] = {"seconds": secs, "turns": turns}
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "probe_sweep_graphs.json").write_text(json.dumps(summary,
                                                            indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
