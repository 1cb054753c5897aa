"""Run one cell of ``BENCHMARK.json`` on this machine's GPUs:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``check``: each number the
correctness check compared, beside its limit). The run fails, and prints
no result, without the cards the cell asks for, or if ``jax``, ``jaxlib``,
``flax`` or ``audio_matcher_tpu`` was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _say(s: str) -> None:
    print(s, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import cell, common

    bench = common.benchmark()
    spec = common.cell(bench, args.workload)
    want = common.traffic(spec["traffic"])["devices"]
    if not torch.cuda.is_available():
        _say("no CUDA device: the benchmark runs on NVIDIA GPUs only")
        return 2
    if torch.cuda.device_count() < want:
        _say(f"{args.workload} needs {want} GPUs, "
             f"{torch.cuda.device_count()} are visible")
        return 2
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi failed: {e}"
    _say(f"cards: {smi}; torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}; peaks FP32 67 TFLOP/s, HBM 3.35 TB/s "
         f"(H100 SXM at 700 W)")
    line = cell.run(args.workload, args.seed, args.seconds,
                    bool(args.trace), "cuda", bench, t_start=T_START,
                    say=_say)
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
