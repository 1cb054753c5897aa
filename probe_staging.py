#!/usr/bin/env python3
"""Staging a sweep group: a fresh pinned buffer against a reused one, on one GPU.

    python3 probe_staging.py        # from the repository root

Stages groups of 8 int16 episodes at 44.1 kHz (fill the host buffer, then
one upload on the side stream) two ways:

* ``fresh``: ``models.matcher.stage_rows_host``, what the port runs: a new
  pinned tensor from PyTorch's caching host allocator each group, each row
  its episode then silence to the staged width;
* ``reused``: two buffers used in turn, each kept while the group shape
  stays (one slot: a new shape replaces it) and rewritten only after the
  event behind its last copy, re-silencing only the tail the row's
  previous episode left (the JAX package's ``StagingArena``, pinned).

Three traffics, 6 groups each after one warm-up group: ``sweep``, every
file 600 s (the chip smoke's sweep archive); ``mixed``, durations drawn
from 120-900 s (seed 0), whose groups all round up to one staged width
(16 windows of 60 s); ``mixed widths``, durations drawn from 120 s to a
longest file of 600-2100 s that changes every group, so each group has
another staged width.

Each group is timed alone (fill + upload + synchronize, p50), and the 6
groups back to back with one synchronize at the end. Order: fresh,
reused, reused, fresh.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import numpy as np
import torch

from audio_matcher_tpu_torch.models.matcher import (
    MatchConfig,
    side_stream,
    stage_rows_host,
    staged_width,
)

SR = 44100
GROUP = 8
GROUPS = 6
SNIPPET_SECS = 10.0


class ReusedBuffer:
    """One pinned [rows, width] int16 buffer kept while the shape stays."""

    def __init__(self):
        self.key = None
        self.buf = None
        self.fill: list[int] = []
        self.copied = None

    def stage(self, episodes, width, dev):
        if self.copied is not None:
            self.copied.synchronize()
        key = (len(episodes), width)
        if key != self.key:
            self.key, self.buf = key, None
            self.buf = torch.zeros(key, dtype=torch.int16, pin_memory=True)
            self.fill = [0] * len(episodes)
        out = self.buf.numpy()
        for i, ep in enumerate(episodes):
            n = len(ep)
            out[i, :n] = ep
            if self.fill[i] > n:
                out[i, n : self.fill[i]] = 0
            self.fill[i] = n
        side = side_stream(dev)
        with torch.cuda.stream(side):
            staged = self.buf.to(dev, non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record(side)
        main = torch.cuda.current_stream(dev)
        main.wait_event(self.copied)
        staged.record_stream(main)
        return staged


def width_of(cfg, episodes):
    chunk = int(round(cfg.chunk_secs * SR))
    overlap = int(SNIPPET_SECS * SR) + 2
    return staged_width(cfg, chunk, overlap, max(len(e) for e in episodes))


def run(way, groups, cfg, dev):
    """(each group's seconds alone, the last 6 back to back's total)."""
    buffers = (ReusedBuffer(), ReusedBuffer())

    def stage(k, eps):
        width = width_of(cfg, eps)
        if way == "fresh":
            return stage_rows_host(eps, [len(e) for e in eps], width, "int16",
                                   len(eps), dev)[0]
        return buffers[k % 2].stage(eps, width, dev)

    alone = []
    for k, eps in enumerate(groups):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = stage(k, eps)
        torch.cuda.synchronize()
        alone.append(time.perf_counter() - t0)
        want = np.zeros(staged.shape[1], np.int16)
        want[: len(eps[-1])] = eps[-1]
        if not np.array_equal(staged[-1].cpu().numpy(), want):
            raise AssertionError(f"{way}: group {k} staged wrong")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k, eps in enumerate(groups[1:]):
        stage(k, eps)
    torch.cuda.synchronize()
    return alone, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_staging.py needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    cfg = MatchConfig(transfer_dtype="int16")
    rng = np.random.default_rng(0)
    pool = rng.integers(-3000, 3000, 2100 * SR, dtype=np.int16)

    def group(longest):
        secs = [longest] + list(rng.uniform(120, longest, GROUP - 1))
        return [pool[: int(s * SR)] for s in secs]

    traffics = {
        "sweep": [[pool[: 600 * SR]] * GROUP for _ in range(GROUPS + 1)],
        "mixed": [[pool[: int(s * SR)] for s in rng.uniform(120, 900, GROUP)]
                  for _ in range(GROUPS + 1)],
        "mixed widths": [group(longest) for longest in
                         (600, 1500, 900, 2100, 1200, 1800, 700)],
    }
    for name, groups in traffics.items():
        mb = [GROUP * width_of(cfg, g) * 2 / 1e6 for g in groups]
        print(f"{name}: {GROUPS + 1} groups of {GROUP}, staged "
              f"{', '.join(f'{m:.1f}' for m in mb)} MB int16")
        for way in ("fresh", "reused", "reused", "fresh"):
            alone, total = run(way, groups, cfg, dev)
            rate = statistics.median(m / t for m, t in zip(mb[1:], alone[1:]))
            print(f"  {way:6s}: first group {alone[0]:.4f} s; alone p50 "
                  f"{statistics.median(alone[1:]):.4f} s, p50 {rate:.1f} "
                  f"MB/s; {GROUPS} back to back {total:.4f} s "
                  f"({sum(mb[1:]) / total:.1f} MB/s); {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
