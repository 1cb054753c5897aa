#!/usr/bin/env python3
"""The config #3 batch scan on one GPU against the same scan sharded over a mesh.

    python3 probe_mesh_scan.py        # from the repository root

Scans the config #3 bench shape (``bench.make_bench_inputs``: 4 x 1800 s
at 44.1 kHz x 64 queries of 10-13.5 s, seed 42; mulaw8, slab 8) through
``ShardedScanner`` on:

* one device (``cuda:0``);
* a mesh of that card twice (``Mesh.of(["cuda:0", "cuda:0"])``): two
  shards of 2 rows scanned one after the other on one card;
* a mesh of 2 cards and one of 4 cards, where that many are visible:
  each shard's scan issued by a host thread of its own, as
  ``scan_dispatch`` issues a mesh's shards.

Each layout stages the batch (fill + upload, synchronized) and scans it
once to warm, then runs REPS timed scans (wall, ending in a synchronize
of every card) and REPS timed dispatches (the host's time until
``scan_dispatch`` returns, before any synchronize); the order is one
device, the meshes, then one device again. Every layout's peaks must
equal the one-device scan's. Then two diagnostics of the host's part:

* the dispatch of the one-device scan queued behind ~1 s of
  ``torch.cuda._sleep`` on the card: if it returns well before the sleep
  ends, nothing in the scan's issue waits for the card; and one dispatch
  under ``torch.cuda.set_sync_debug_mode("warn")``, which warns at every
  operation that synchronizes with the card (a wait for room in the
  launch queue is not one);
* on every mesh, the shards' scans issued in turn by one host thread,
  shard 0's launches first, against a thread a shard.

Prints the p50 of each, its device-resident pair audio-hours/s and the
cards' ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import statistics
import subprocess
import time
import warnings

import torch

from audio_matcher_tpu_torch.models.matcher import MatchConfig, quantize_wire
from audio_matcher_tpu_torch.parallel.mesh import Mesh
from audio_matcher_tpu_torch.parallel.sweep import ShardedRows, ShardedScanner
from bench import EPISODE_SECS, SR, make_bench_inputs  # no jax at its top

N_EPISODES = 4
N_QUERIES = 64
SLAB = 8
REPS = 5


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def timed(fn, reps=REPS):
    """p50 and every time of ``fn()`` (s), the cards idle before each."""
    times = []
    for _ in range(reps):
        sync_all()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    sync_all()
    return statistics.median(times), times


def measure(scanner, batch):
    """(stage s, p50 scan s, every scan's s, p50 dispatch s, staged,
    peaks)."""
    sync_all()
    t0 = time.perf_counter()
    staged = scanner.stage_resident(batch)
    sync_all()
    t_stage = time.perf_counter() - t0
    peaks = scanner.scan_staged(staged)

    def scan():
        if scanner.scan_staged(staged) != peaks:
            raise AssertionError("a repeated scan differs")
        sync_all()

    t_scan, times = timed(scan)
    t_issue, _ = timed(lambda: scanner.scan_dispatch(staged))
    return t_stage, t_scan, times, t_issue, staged, peaks


def one_thread_scan(scanner, staged):
    """The shards' scans issued in turn by this thread; then collected."""
    rows, ns, n_real = staged
    n_max = int(ns.max())
    outs, ready = [], []
    for a, block in rows.blocks:
        with torch.cuda.device(block.device):
            outs.append(scanner._scan(block, ns[a : a + block.shape[0]],
                                      True, n_max))
            ready.append(torch.cuda.Event())
            ready[-1].record(torch.cuda.current_stream(block.device))
    return scanner.scan_collect((outs, ns, n_real, ready))


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_mesh_scan.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    n_cards = torch.cuda.device_count()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{n_cards} visible card(s)")
    config = MatchConfig(slab=SLAB, slab_auto=True, transfer_dtype="mulaw8")
    snippets, _, episode = make_bench_inputs(N_QUERIES)
    batch = [quantize_wire(episode, "mulaw8")] * N_EPISODES
    one = ShardedScanner(snippets, SR, config, device="cuda:0")
    layouts = [("one device", "cuda:0"),
               ("one card twice", Mesh.of(["cuda:0", "cuda:0"]))]
    for n in (2, 4):
        if n_cards >= n:
            layouts.append((f"{n} cards",
                            Mesh.of([f"cuda:{i}" for i in range(n)])))
    layouts.append(("one device, again", "cuda:0"))
    pair_h = N_EPISODES * N_QUERIES * EPISODE_SECS / 3600.0
    want = None
    for label, where in layouts:
        scanner = ShardedScanner(snippets, SR, config, device=where,
                                 query_state=one.query_state)
        t_stage, t_scan, times, t_issue, staged, peaks = measure(scanner,
                                                                 batch)
        if want is None:
            want = peaks
        elif peaks != want:
            raise AssertionError(f"{label}: peaks differ from one device")
        print(f"{label} ({scanner.describe()}): stage {t_stage:.4f} s, scan "
              f"p50 {t_scan:.4f} s of {[round(t, 4) for t in times]}, "
              f"{pair_h / t_scan:.3f} pair-h/s device-resident; dispatch "
              f"(host issue, no synchronize) p50 {t_issue:.4f} s")
        if label == "one device":
            torch.cuda._sleep(1 << 31)  # ~1 s of the card's clock
            t0 = time.perf_counter()
            scanner.scan_dispatch(staged)
            t_behind = time.perf_counter() - t0
            torch.cuda.synchronize()
            print(f"  the dispatch behind ~1 s of _sleep on the card: "
                  f"{t_behind:.4f} s until it returned, "
                  f"{time.perf_counter() - t0:.4f} s until the card was done")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    scanner.scan_dispatch(staged)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = [str(w.message) for w in caught]
            print(f"  synchronizing operations in one dispatch: {len(syncs)}"
                  f"{'; first: ' + syncs[0][:200] if syncs else ''}")
        if isinstance(staged[0], ShardedRows):
            if one_thread_scan(scanner, staged) != want:
                raise AssertionError(f"{label}: one-thread peaks differ")
            t_one, one_t = timed(lambda: one_thread_scan(scanner, staged))
            print(f"  {label}, every shard issued by one host thread: scan "
                  f"p50 {t_one:.4f} s of {[round(t, 4) for t in one_t]}")
        del scanner, staged
        torch.cuda.empty_cache()
    print("every layout's peaks equal the one-device scan's")
    print(smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
