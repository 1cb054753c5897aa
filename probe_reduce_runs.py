#!/usr/bin/env python3
"""The block reduction's time against the run length of its warps, on one GPU.

    python3 probe_reduce_runs.py        # from the repository root

Times ``am_block_reduce_packed`` (kernel 5) on 256 pairs of [2670592]
planes (config #3's slab: 512 logical rows) and ``am_block_reduce``
(kernel 7) on a [64, 2818048] array (the xla_packed scan's slab), block
512, for every run length 1-16 that the wrapper can choose
(``cuda_kernels.reduce_grid``), median of 9 CUDA-event timings, beside one
``torch.amax`` over the same bytes and the run the wrapper picks. Random
values; every column valid.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch

from audio_matcher_tpu_torch import _build
from audio_matcher_tpu_torch.ops import cuda_kernels as K


def timing(fn, reps=9):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_reduce_runs.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _build.load()
    g = torch.Generator(device=dev).manual_seed(0)
    block = 512
    stream = torch.cuda.current_stream(dev).cuda_stream
    P, V = 256, 2670592
    yr = torch.randn(P, V, device=dev, generator=g)
    yi = torch.randn(P, V, device=dev, generator=g)
    x = torch.randn(64, 2818048, device=dev, generator=g)
    cases = (("kernel 5", 2 * P, V, (yr, yi)), ("kernel 7", 64, x.shape[1], (x,)))
    for label, rows, cols, planes in cases:
        nb = cols // block
        valid = torch.full((rows,), cols, dtype=torch.int32, device=dev)
        scale = torch.ones(rows, device=dev)
        out = K._block_outputs(rows, nb, dev)
        ptrs = [o.data_ptr() for o in out]
        amax = timing(lambda: [p.view(p.shape[0], -1, block).amax(-1)
                               for p in planes])
        print(f"{label}: [{rows} rows, {cols}], torch.amax {amax:.3f} ms; "
              f"the wrapper's run {K.reduce_grid(rows, nb, sms)[0]}")
        for run in (1, 2, 4, 8, 16):
            if len(planes) == 2:
                def call(run=run):
                    return lib.am_block_reduce_packed(
                        yr.data_ptr(), yi.data_ptr(), scale.data_ptr(),
                        valid.data_ptr(), *ptrs, rows, cols, block, K.GROUP,
                        run, stream)
            else:
                def call(run=run):
                    return lib.am_block_reduce(
                        x.data_ptr(), valid.data_ptr(), *ptrs, rows, cols,
                        block, K.GROUP, run, stream)
            _build.check(call(), label)
            warps = rows * -(-nb // run)
            print(f"{label}: run {run:2d}: {timing(call):.3f} ms "
                  f"({warps / (sms * K.SM_WARPS):.1f} waves of warps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
