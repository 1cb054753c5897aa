#!/usr/bin/env python3
"""Two checkouts' graphed scan paths on one GPU, in turns.

    python3 probe_graph_paths.py OTHER_CHECKOUT   # from the repository root

Runs one process a turn, in the order OTHER, this checkout, this checkout,
OTHER; each imports ``audio_matcher_tpu_torch`` and ``chip_smoke`` (for
its inputs and constants) from its checkout, builds its kernels there,
and times three graphed paths at chip_smoke.py's shapes (seed 42,
44.1 kHz, mulaw8):

* config #2: ``SnippetMatcher.match_staged`` on one 3600 s episode x one
  10 s snippet, chunk 60 s (fft_len 2^22);
* the live path: the same with a progress callback (the matcher CLI's
  groups of slabs);
* config #3: ``ShardedScanner.scan_staged`` on 4 x 1800 s x 64 queries.

Each path is staged once and scanned twice untimed (a key's first sight
and its capture), then REPS times, each from a synchronized card to the
host's peaks; the p50 and the range are printed per turn, with the
cache's counts (the timed calls must all be replays). Prints the card's
``nvidia-smi`` name and power limit. ``--one CHECKOUT`` runs one turn.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPS = 15
PATHS = ("config #2", "live path", "config #3")


def one_turn(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import audio_matcher_tpu_torch as port
    import chip_smoke as cs
    from audio_matcher_tpu_torch import _build
    from audio_matcher_tpu_torch.models.matcher import (
        MatchConfig, SnippetMatcher, quantize_wire)
    from audio_matcher_tpu_torch.parallel.sweep import ShardedScanner

    assert os.path.dirname(port.__file__).startswith(os.path.abspath(root))
    _build.load()
    dev = torch.device("cuda", 0)
    config = MatchConfig(slab=cs.SLAB, slab_auto=True,
                         transfer_dtype="mulaw8")

    def timed(run):
        for _ in range(2):  # first sight, capture
            run()
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    out = {}
    snippets, _, episode = cs.make_bench_inputs(1, cs.SINGLE_EPISODE_SECS)
    wire = quantize_wire(episode, config.transfer_dtype)
    matcher = SnippetMatcher(snippets[0], cs.SR, config, device=dev)
    staged = matcher.stage(wire)
    out["config #2"] = timed(lambda: matcher.match_staged(staged))
    live = SnippetMatcher(snippets[0], cs.SR, config, device=dev)
    staged = live.stage(wire)
    out["live path"] = timed(
        lambda: live.match_staged(staged, progress=lambda p, k: None))
    stats = {"config #2": dict(matcher.step_graphs.stats),
             "live path": dict(live.step_graphs.stats)}
    del matcher, live, staged, wire, episode
    torch.cuda.empty_cache()
    snippets, _, episode = cs.make_bench_inputs()
    wire = quantize_wire(episode, config.transfer_dtype)
    scanner = ShardedScanner(snippets, cs.SR, config, device=dev)
    staged = scanner.stage_resident([wire] * cs.N_EPISODES)
    out["config #3"] = timed(lambda: scanner.scan_staged(staged))
    stats["config #3"] = dict(scanner.step_graphs.stats)
    return {"root": root, "times": out, "stats": stats}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--one")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_turn(args.one)))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(args.other)
    for turn, root in enumerate((other, here, here, other)):
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root],
            capture_output=True, text=True, cwd=root)
        if run.returncode:
            print(run.stdout[-4000:], run.stderr[-4000:])
            return run.returncode
        got = json.loads(run.stdout.strip().splitlines()[-1])
        name = "other" if root == other else "this"
        for path in PATHS:
            t = got["times"][path]
            st = got["stats"][path]
            if st.get("hits", 0) < REPS:
                raise AssertionError(f"{name} {path}: timed calls were not "
                                     f"all replays: {st}")
            print(f"turn {turn} ({name}: {root}): {path} graphed p50 of "
                  f"{REPS} {statistics.median(t):.2f} ms (min {min(t):.2f},"
                  f" max {max(t):.2f}); cache {st}; {smi}")
    print(smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
