#!/usr/bin/env python3
"""Where the time of the wire forward passes goes, on one GPU.

    python3 probe_wire_pass.py [--parent DIR]   # from the repository root

Builds variants of ``audio_matcher_tpu_torch/csrc/fft_major.cu``, each with
one part of ``walk_wire_strips`` taken out or replaced by editing a copy of
the source,
into libraries of their own under ``audio_matcher_tpu_torch/_build/probe``,
and times ``am_major_fwd_wire`` (kernel 1 on 8 mu-law windows of config
#3's slab, n = 2^22) and ``am_major_fwd_wire2`` (kernel 6 on 4 pairs of
windows of config #2's slabs, n = 2^22 and 2^24; ``CASES``) in each,
median of 9 CUDA-event timings. The variants' outputs are wrong by
construction: only their times are read. ``--parent DIR`` also times the ``fft_major.cu`` (and headers)
found in DIR, e.g. an earlier commit's ``csrc``, as the variant "parent",
first and last. Prints one line per (variant, case) and the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from audio_matcher_tpu_torch import _build
from audio_matcher_tpu_torch.ops import cuda_fft as F

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "audio_matcher_tpu_torch" / "_build" / "probe"

TMA_STORE = "    if (t < A / BOX) {"
LSU_STORE = "        else\n            store_forward(vr, vi, yr, yi,"
TMA_BRANCH = "        if constexpr (L::TMA)\n            stage_and_store<"
TMA_RULE = "        (4 << LOG2C) < 32 && "
STAGE_RULE = ("    static constexpr int STAGE = TMA ? A << LOG2C : 0;  // floats\n"
              "    static constexpr int SMEM = 4 * (TILE + STAGE) + REST;\n")
TWO_TILES = ("    static constexpr int STAGE = TMA ? A << LOG2C : 0;  // floats\n"
             "    static constexpr int TILES =\n"
             "        8 * TILE + 4 * STAGE + REST <= MAX_SMEM ? 2 : 1;\n"
             "    static constexpr int SMEM = 4 * (TILES * TILE + STAGE) + "
             "REST;\n")
STAGE_AT = "    float* stage = smem + L::TILE;"
STAGES = ("            run_group<true, Pl::w(0), Pl::qlo(0), Pl::k(0)>(vr, vi, "
          "u2, tw);\n")
STAGES2 = ("            transform<true, false, LOG2A, 1>(vr, vi, xt, xt, "
           "tile, u2, tw);\n")
STAGES3 = ("            transform<true, false, LOG2A>(vr, vi, xt, xt, tile, "
           "u2, tw);\n")
FETCH = ("        if (next < strips)\n"
         "            fetch_wire<In, PAIR, LOG2A>(")
GRID = "const long long blocks = strips < fit ? strips : fit;"
LUT_BUILD = "    if (sizeof(In) == 1)\n        for (int k = threadIdx.x; k < L::LUT;"
STORE_IM = "        yi[out + (r << log2M)] = vi[r];\n"


STORE_CALL = ("            store_forward(vr, vi, yr, yi,\n"
              "                          ((long long)(s2 >> strips2) << "
              "(LOG2A + lm2)) +\n"
              "                              ((long long)(tid >> LOG2C) << "
              "(lm2 + 4)) +\n"
              "                              ((s2 & ((1u << strips2) - 1)) "
              "<< LOG2C) + col2,\n"
              "                          lm2);\n")
LINE_STORES = ("            for (int r = 0; r < PTS; ++r) {\n"
               "                const long long o = ((long long)s2 << 14) + "
               "(r << 10) + tid;\n"
               "                yr[o] = vr[r];\n"
               "                yi[o] = vi[r];\n"
               "            }\n")


def edit(*pairs):
    """The source with each (old, new) replaced."""
    def run(s: str) -> str:
        for old, new in pairs:
            s = s.replace(old, new)
        return s
    return run


VARIANTS = {  # name -> (what is taken out or changed, edit of the source)
    "full": ("nothing", lambda s: s),
    "no_stores": ("the stores (kept behind a branch never taken)",
                  edit((TMA_STORE, TMA_STORE.replace(") {", " && c0 < 0) {")),
                       (LSU_STORE, LSU_STORE.replace(
                           "store_forward", "if (w_len < 0) store_forward")))),
    "no_stages": ("the radix-2 stages and exchanges",
                  edit((STAGES, ""), (STAGES2, ""), (STAGES3, ""))),
    "no_copy": ("the cp.async copy of the next strip",
                edit((FETCH, FETCH.replace("next < strips", "w_len < 0")))),
    "per_strip": ("the persistent walk: a block for each strip",
                  edit((GRID, "const long long blocks = strips;"))),
    "two_tiles": ("nothing: the planes exchange together, through a tile "
                  "of both where it fits",
                  edit((STAGE_RULE, TWO_TILES),
                       (STAGE_AT, "    float* stage = smem + L::TILES * "
                        "L::TILE;"),
                       (STAGES3, "            transform<true, L::TILES == 2, "
                        "LOG2A>(vr, vi, xt, xt + (L::TILES - 1) * L::TILE, "
                        "tile, u2, tw);\n"))),
    "real_only": ("the imaginary plane's stores (threads' stores)",
                  edit((STORE_IM, ""))),
    "stagger": ("nothing: odd blocks start 7 us late, out of step with the "
                "even ones", edit((LUT_BUILD, "    if (blockIdx.x & 1) "
                                   "__nanosleep(7000);\n" + LUT_BUILD))),
    "line_stores": ("nothing: the same bytes stored as whole 128-byte "
                    "lines, a warp's 32 values contiguous (a wrong layout)",
                    edit((STORE_CALL, LINE_STORES))),
    "tma_stores": ("nothing: the TMA stores the output at every A",
                   edit((TMA_RULE, "        "))),
    "lsu_stores": ("nothing: the threads store the output at every A",
                   edit((TMA_BRANCH, TMA_BRANCH.replace("(L::TMA)",
                                                        "(false)")))),
}


# (label, n, windows, window, chunk): the windows and their spacing of
# chip_smoke.py's slabs (chunks of 60 s at 44.1 kHz for config #3's scan,
# 10 s for config #2 at 2^22, 240 s at 2^24): every row starts on 16 bytes
CASES = (("kernel 1, 8 windows, 2^22", 1 << 22, 8, 3241352, 2646000),
         ("kernel 6, 4 pairs, 2^22", 1 << 22, 8, 3087002, 441000),
         ("kernel 6, 4 pairs, 2^24", 1 << 24, 8, 11025002, 10584000))


def build(name: str, edit, csrc: Path = _build.CSRC
          ) -> tuple[list[str], Path]:
    """The nvcc command of a variant's library, and the library's path."""
    src = (csrc / "fft_major.cu").read_text()
    new = edit(src)
    if name not in ("full", "parent") and new == src:
        raise RuntimeError(f"variant {name}: the edit found nothing")
    work = OUT / name
    work.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob("*.cuh"):
        (work / h.name).write_text(h.read_text())
    (work / "fft_major.cu").write_text(new)
    lib = work / "libprobe.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
           str(lib), str(work / "fft_major.cu")]
    return cmd, lib


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
        raise RuntimeError("probe_wire_pass.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    builds = {name: build(name, edit) for name, (_, edit) in VARIANTS.items()}
    if len(sys.argv) == 3 and sys.argv[1] == "--parent":
        builds["parent"] = build("parent", lambda s: s, Path(sys.argv[2]))
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, (cmd, _) in builds.items()}
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(log)
            raise RuntimeError(f"variant {name} did not build")
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{name}: built, {sum(map(int, spills))} B spilled in all")
        lib = ctypes.CDLL(str(builds[name][1]))
        for fn in ("am_major_fwd_wire", "am_major_fwd_wire2"):
            getattr(lib, fn).argtypes = list(_build.SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for label, n, B, W, chunk in CASES:
        A, M = F.split_factors(n)
        ep = torch.randint(0, 256, ((B - 1) * chunk + W,), device=dev,
                           generator=g, dtype=torch.int32).to(torch.uint8)
        win = ep.as_strided((B, W), (chunk, 1))
        cases.append((label, n, A, M, W, win))
    tw = {n: F.twiddle_table(F.split_factors(n)[0], dev) for n in (1 << 22,
                                                                   1 << 24)}
    stream = torch.cuda.current_stream(dev).cuda_stream
    for label, n, A, M, W, win in cases:
        pair = label.startswith("kernel 6")
        P = (win.shape[0] + 1) // 2 if pair else win.shape[0]
        yr = torch.empty((P, A, M), device=dev)
        yi = torch.empty_like(yr)
        la, lm = A.bit_length() - 1, M.bit_length() - 1
        x0, x1 = (win[0::2], win[1::2]) if pair else (win, None)
        order = list(libs) + (["parent"] if "parent" in libs else [])
        if "parent" in libs:
            order = ["parent"] + order[:-2] + ["parent"]
        for name in order:
            lib = libs[name]
            if pair:
                def run(lib=lib):
                    return lib.am_major_fwd_wire2(
                        0, x0.data_ptr(), x0.stride(0), x1.data_ptr(),
                        x1.stride(0), x1.shape[0], yr.data_ptr(),
                        yi.data_ptr(), tw[n].data_ptr(), P, la, lm, W, stream)
            else:
                def run(lib=lib):
                    return lib.am_major_fwd_wire(
                        0, x0.data_ptr(), x0.stride(0), yr.data_ptr(),
                        yi.data_ptr(), tw[n].data_ptr(), P, la, lm, W, stream)
            _build.check(run(), name)
            ms = timing(run)
            what = VARIANTS[name][0] if name in VARIANTS else "DIR's source"
            print(f"{label}: {name:10s} {ms:.3f} ms (taken out: {what})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
