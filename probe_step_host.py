#!/usr/bin/env python3
"""Where the host's time goes in one eager scan step of the port, on one GPU.

    python3 probe_step_host.py        # from the repository root

Four paths, each at chip_smoke.py's shape (seed 42, 44.1 kHz):

* config #2: ``SnippetMatcher`` on one 3600 s episode x one 10 s snippet,
  mulaw8, chunk 60 s; the step is ``_match_episode_resident``;
* config #3: ``ShardedScanner`` on 4 x 1800 s x 64 queries, mulaw8; the
  step is ``resident_match_step`` through ``_scan``;
* one sweep group: ``ShardedScanner`` on 8 x 600 s x 4 queries, int16;
* config #4: ``ShardedSpectrogramScanner`` on 4 x 1800 s x 8 queries,
  int16; the step is its ``_scan``.

Each step runs eagerly (the scanners with ``graphs=False``; the matcher's
step is called directly), as before the steps were captured as CUDA
graphs. Each path is staged once and run once to warm. Then, p50 of REPS
runs on the host's clock: ``issue`` (from the call of the step until it
returns, no synchronize: Python, the kernel wrappers and torch's
dispatch, plus any wait for room in the launch queue), ``wait`` (the
synchronize after it:
the card's work still queued), ``read back`` (the outputs to numpy) and
``peaks`` (the host's candidates to peaks: ``_extract_peaks`` or
``_peaks``). Then one more run under ``torch.profiler`` (CPU and CUDA
activity): the top-level aten ops of the step and their summed CPU time,
the kernel launches the CUDA runtime saw (``*LaunchKernel*`` calls) and
their summed CPU time, the memory copies and syncs it saw, and the card's
busy time (the union of its kernel and copy intervals). The profiler's own
cost inflates its host times: its counts are exact, its times are not the
unprofiled run's. Prints the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import numpy as np
import torch

from audio_matcher_tpu_torch.models.matcher import (
    MatchConfig,
    SnippetMatcher,
    _match_episode_resident,
    quantize_wire,
    scan_slab,
)
from audio_matcher_tpu_torch.models.spectrogram import SpectrogramConfig
from audio_matcher_tpu_torch.parallel.sweep import (
    ShardedScanner,
    ShardedSpectrogramScanner,
)
from chip_smoke import (
    EPISODE_SECS,
    N_EPISODES,
    SINGLE_EPISODE_SECS,
    SPEC_NOISE,
    SPEC_QUERIES,
    SR,
    SWEEP_EPISODE_SECS,
    SWEEP_GROUP,
    SWEEP_QUERIES,
    make_bench_inputs,
)

REPS = 5


def split(label, issue, read, peaks):
    """p50 of REPS host-clock splits of issue → wait → read back → peaks,
    then one profiled issue + wait."""
    out = issue()
    torch.cuda.synchronize()
    peaks(read(out))
    parts = {"issue": [], "wait": [], "read back": [], "peaks": [],
             "wall": []}
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = issue()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        arrays = read(out)
        t3 = time.perf_counter()
        peaks(arrays)
        t4 = time.perf_counter()
        for k, a, b in (("issue", t0, t1), ("wait", t1, t2),
                        ("read back", t2, t3), ("peaks", t3, t4),
                        ("wall", t0, t4)):
            parts[k].append((b - a) * 1e3)
    p50 = {k: statistics.median(v) for k, v in parts.items()}
    print(f"{label}: p50 of {REPS} (ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in p50.items()))
    profiled(label, issue)


def profiled(label, issue):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        issue()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = n_launch = n_copy = n_sync = 0
    op_ms = launch_ms = 0.0
    spans = []
    for ev in prof.events():
        us = ev.time_range.elapsed_us()
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
        elif ev.name.startswith("aten::") and ev.cpu_parent is None:
            ops += 1
            op_ms += us / 1e3
        elif "LaunchKernel" in ev.name:
            n_launch += 1
            launch_ms += us / 1e3
        elif "Memcpy" in ev.name or "Memset" in ev.name:
            n_copy += 1
        elif "Synchronize" in ev.name:
            n_sync += 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    print(f"{label}, profiled: issue {1e3 * (t1 - t0):.2f} ms, wall "
          f"{1e3 * wall:.2f} ms, device busy {busy / 1e3:.2f} ms; "
          f"{ops} top-level aten ops ({op_ms:.2f} ms CPU), {n_launch} kernel "
          f"launches seen by the CUDA runtime ({launch_ms:.2f} ms CPU), "
          f"{n_copy} copy/memset calls, {n_sync} synchronize calls")


def config2():
    snippets, _, episode = make_bench_inputs(1, SINGLE_EPISODE_SECS)
    cfg = MatchConfig(transfer_dtype="mulaw8")
    m = SnippetMatcher(snippets[0], SR, cfg, device="cuda")
    episode_dev, n = m.stage(quantize_wire(episode, "mulaw8"))
    n_pad = (episode_dev.shape[0] - m.overlap) // m.chunk
    slab = scan_slab(cfg, m.chunk, n, n_pad)
    n_windows = -(-n // m.chunk)
    inv_ac = np.float32(m.snippet.inv_autocorr)
    split("config #2, SnippetMatcher (_match_episode_resident)",
          lambda: _match_episode_resident(
              episode_dev, n, m._sample_f, inv_ac,
              **m._scan_kwargs(slab, n_pad // slab)),
          lambda out: [a.cpu().numpy() for a in out],
          lambda a: m._extract_peaks(*a, n_windows))


def scanner_split(label, scanner, episodes):
    rows, ns, n_real = scanner.stage_resident(episodes)
    n_max = int(ns.max())
    split(label, lambda: scanner._scan(rows, ns, True, n_max),
          lambda out: [a.cpu().numpy() for a in out],
          lambda a: scanner._peaks(a, ns, n_real))


def config3():
    snippets, _, episode = make_bench_inputs()
    cfg = MatchConfig(transfer_dtype="mulaw8")
    scanner_split("config #3, ShardedScanner (resident_match_step)",
                  ShardedScanner(snippets, SR, cfg, device="cuda",
                                 graphs=False),
                  [quantize_wire(episode, "mulaw8")] * N_EPISODES)


def sweep_group():
    snippets, _, episode = make_bench_inputs(SWEEP_QUERIES,
                                             SWEEP_EPISODE_SECS)
    cfg = MatchConfig(transfer_dtype="int16")
    scanner_split(f"one sweep group ({SWEEP_GROUP} x {SWEEP_EPISODE_SECS} s"
                  f" x {SWEEP_QUERIES} queries, int16)",
                  ShardedScanner(snippets, SR, cfg, device="cuda",
                                 graphs=False),
                  [quantize_wire(episode, "int16")] * SWEEP_GROUP)


def config4():
    snippets, _, base = make_bench_inputs(SPEC_QUERIES, EPISODE_SECS)
    rng = np.random.default_rng(4)
    episodes = [quantize_wire(base + rng.standard_normal(
        len(base), dtype=np.float32) * np.float32(SPEC_NOISE), "int16")
        for _ in range(N_EPISODES)]
    scanner_split("config #4, ShardedSpectrogramScanner (_scan)",
                  ShardedSpectrogramScanner(
                      snippets, SR, SpectrogramConfig(transfer_dtype="int16"),
                      device="cuda", graphs=False),
                  episodes)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_step_host.py needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    for path in (config2, config3, sweep_group, config4):
        path()
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
