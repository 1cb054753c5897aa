"""The readings the limits of ``correct`` are set from, for one cell, in
one process: the program's sound runs over many seeds (each a run of the
cell with a short window, judged as a benchmark run judges it), then the
control's over a few more (the plain reference in bfloat16 put in the
program's place, on the sample of pairs a run of that seed compares).

    python3 portbench/calibrate.py --workload <cell> --seconds 3 \\
        --seeds 11,12,... --control-seeds 21,22,23

prints one JSON line a seed and, last, the largest program reading and
the smallest control reading of each number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import cell, check, generator  # noqa: E402

NUMBERS = ("position_mismatches", "height_gap", "prominence_gap")


def _say(s: str) -> None:
    print(s, file=sys.stderr, flush=True)


def control_readings(workload: str, seed: int, device: str,
                     overrides=None) -> dict:
    """The control's readings on the pairs a run of ``seed`` compares,
    with every episode of the traffic's cycle taken as seen."""
    cfg, mix = cell.files(workload, overrides=overrides)
    dev = "cuda:0" if device == "cuda" else device
    tr = generator.make(cfg, mix, seed, dev)
    seen = [e for g in tr.groups for e in g]
    pairs = check.sample_pairs(tr, mix, seed, seen)
    return check.control(tr, cfg, pairs, dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    program, control = [], []
    for s in seeds:
        t = time.perf_counter()
        line = cell.run(args.workload, s, args.seconds, False, "cuda",
                        say=lambda _: None)
        got = {k: line["check"][k]["value"] for k in NUMBERS}
        got.update(seed=s, correct=line["correct"],
                   peaks=line["check"]["peaks_compared"]["value"],
                   seconds=time.perf_counter() - t)
        program.append(got)
        print(json.dumps({"program": got}), flush=True)
    for s in controls:
        got = control_readings(args.workload, s, "cuda")
        got["seed"] = s
        control.append(got)
        print(json.dumps({"control": got}), flush=True)
        check.free_device()
    summary = {"workload": args.workload}
    for k in NUMBERS:
        if program:
            summary[f"{k}.program_max"] = max(r[k] for r in program)
        if control:
            summary[f"{k}.control_min"] = min(r[k] for r in control)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
