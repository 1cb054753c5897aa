#!/usr/bin/env python3
"""The archive sweep with its cross-rate file resampled by scipy on the
host against the card's polyphase resampler, on one GPU.

    python3 probe_sweep_resample.py        # from the repository root

Writes ``chip_smoke.py``'s sweep archive (24 wav files of 600 s at
44.1 kHz, one at 22.05 kHz, a corrupt one; 4 snippets, seed 42) to a
temporary directory, then runs ``sweep_cli.run --resample`` over it with
``--resample-impl scipy`` and ``device`` in turns (scipy, device, device,
scipy, three times after one warm run of each): the end-to-end seconds
of every run and the median of each impl. Nothing else differs between
the runs, so the difference is the resample's place in the pipeline.
"""

from __future__ import annotations

import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from chip_smoke import SWEEP_QUERIES, make_sweep_archive
from audio_matcher_tpu_torch.cli import sweep_cli

ROUNDS = 3


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_sweep_resample.py needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="am_probe_") as tmp:
        root = Path(tmp)
        make_sweep_archive(root)
        base = [str(root / "ep*.wav"), str(root / "zz_random.wav"),
                "--resample", "--no-out", "--device", "cuda"]
        for q in range(SWEEP_QUERIES):
            base += ["--snippet", str(root / f"snippet{q}.wav")]
        times = {"scipy": [], "device": []}
        order = ["scipy", "device"] + ["scipy", "device", "device",
                                       "scipy"] * ROUNDS
        for i, impl in enumerate(order):
            ns = sweep_cli.build_parser().parse_args(
                base + ["--resample-impl", impl])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if sweep_cli.run(ns) != 0:
                raise AssertionError(f"the sweep with {impl} failed")
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
            if i >= 2:  # the first two are warm-up runs
                times[impl].append(t)
            print(f"run {i}: --resample-impl {impl}: {t:.3f} s"
                  f"{' (warm-up)' if i < 2 else ''}")
    for impl, ts in times.items():
        print(f"{impl}: median {statistics.median(ts):.3f} s of "
              f"{', '.join(f'{t:.3f}' for t in ts)}; 25 files")
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
