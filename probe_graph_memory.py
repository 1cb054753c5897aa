#!/usr/bin/env python3
"""chip_smoke.py's ``graph_memory`` sequence on two checkouts, on one GPU.

    python3 probe_graph_memory.py OTHER_CHECKOUT   # from the repository root

Runs one process a checkout, OTHER and then this one. Each imports
``audio_matcher_tpu_torch`` from its checkout and this checkout's
``chip_smoke.py`` (by path), builds the kernels there and runs two of
chip_smoke's phases: ``jnp_scan`` (the ``vpu`` + ``jnp`` scan of 1 x
1800 s x 64 queries alone: its peaks and peak memory), then
``graph_memory`` (``match()`` three times at fft_len 2^28, twice at four
shapes of 2^22 - 2^23, twice at 2^28 again, then that scan's shape with
the graphs live). Its reading of the last small graph alone runs in a
fresh process of this script on the checkout's port too; at both readings
the allocator's segments of 64 MB or more are listed (size, pool,
allocated bytes, the live blocks in it). A turn that runs
out of device memory prints the error, the device's store and the
allocator's memory at the error, and the probe goes on to the next turn.
Prints the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def load(root: str):
    """This checkout's chip_smoke, on ``root``'s port."""
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    import audio_matcher_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"the port came from {port.__file__}")
    cs._build.load()
    return cs


def segments(label: str) -> None:
    """The caching allocator's segments of 64 MB or more: size, memory
    pool ((0, 0): the default one; else a graph's), bytes allocated and
    the live blocks' sizes; and the total of the smaller ones."""
    import torch

    snap = torch.cuda.memory_snapshot()
    big = sorted((s for s in snap if s["total_size"] >= 64 << 20),
                 key=lambda s: -s["total_size"])
    print(f"{label}: torch.cuda.memory_reserved "
          f"{torch.cuda.memory_reserved() / 1e9:.3f} GB in {len(snap)} "
          f"segments")
    for s in big:
        live = [b["size"] >> 20 for b in s["blocks"]
                if b["state"] == "active_allocated"]
        print(f"  {s['total_size'] / 1e9:.3f} GB, pool "
              f"{s['segment_pool_id']}, allocated "
              f"{s['allocated_size'] / 1e9:.3f} GB, live blocks (MB) {live}")
    rest = sum(s["total_size"] for s in snap if s["total_size"] < 64 << 20)
    print(f"  smaller segments {rest / 1e9:.3f} GB")


def alone(root: str, chunk_secs: float) -> float:
    segments(f"{root}: after the eviction")
    run = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--alone", root,
         repr(chunk_secs)], capture_output=True, text=True, timeout=600)
    if run.returncode:
        raise RuntimeError(f"--alone: {run.stderr[-3000:]}")
    print(run.stdout, end="")
    return json.loads(run.stdout.strip().splitlines()[-1])["reserved_gb"]


def one_turn(root: str, card: str) -> dict:
    cs = load(root)
    import torch

    cs.CARD["line"] = card
    config = cs.smoke_config()
    dev = torch.device("cuda", 0)
    rows = {name: {} for name in cs.KERNEL_ROWS}
    t0 = time.perf_counter()
    cs.jnp_scan(config, dev, rows)
    torch.cuda.empty_cache()
    try:
        cs.graph_memory(config, dev, rows,
                        alone=lambda chunk: alone(root, chunk))
        result = "passed"
    except (torch.cuda.OutOfMemoryError, AssertionError) as err:
        result = f"{type(err).__name__}: {str(err).splitlines()[0]}"
        print(f"{root}: {result}")
        print(f"{root}: at the error: {cs.store_line(dev)}; {cs.memory()}")
    print(f"{root}: {time.perf_counter() - t0:.1f} s; {card}")
    return {"root": root, "result": result}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--one")
    ap.add_argument("--alone", nargs=2, metavar=("ROOT", "CHUNK_SECS"))
    args = ap.parse_args()
    if args.alone:
        cs = load(args.alone[0])
        got = cs.graph_alone(cs.smoke_config(), float(args.alone[1]))
        segments(f"{args.alone[0]}: the same graph alone")
        print(json.dumps({"reserved_gb": got}))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.one:
        print(json.dumps(one_turn(args.one, card)))
        return 0
    results = []
    for root in (os.path.abspath(args.other), HERE):
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root],
            capture_output=True, text=True, cwd=root)
        print(run.stdout)
        if run.returncode:
            print(run.stderr[-4000:])
            return run.returncode
        results.append(json.loads(run.stdout.strip().splitlines()[-1]))
    print(json.dumps(results))
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
