#!/usr/bin/env python3
"""The major FFT pass at A = 8192 and 16384 against an earlier source, on
one GPU.

    python3 probe_major_cluster.py [--parent DIR | --variants]   # from the repository root

Builds ``audio_matcher_tpu_torch/csrc/fft_major.cu`` (and its headers)
into a library of its own under ``audio_matcher_tpu_torch/_build/probe``,
and with ``--parent DIR`` the ``fft_major.cu`` found in DIR (an earlier
commit's ``csrc``) beside it, both with the package's nvcc flags, side by
side. At fft_len 2^26, 2^27 and 2^28 (config #2's chunks of 1200, 3000
and 3100 s at 44.1 kHz, A x M = 8192 x 8192, 8192 x 16384, 16384 x
16384) it times kernel 6 (``am_major_fwd_wire2``, 4 pairs of mu-law
windows: config #2's slab of 8), kernel 4's inverse (``am_major_inverse``,
4 planes, the fused path's crop), kernel 1 (``am_major_fwd_wire``, 2
windows) and kernel 4's forward mode (``am_major_forward``, 2 planes) in
the order parent, this tree, this tree, parent (median of 7 CUDA-event
timings each), beside each call's byte bound and, for kernel 4, one
``torch.fft`` over the same axis. This tree's outputs must be within
TOL_FFT of the plain versions and bitwise equal over two launches. Prints
ptxas's registers and spills of every cluster pass, the clusters the card
holds for each (``cudaOccupancyMaxActiveClusters``), one JSON line per
call timed and the card's name and power limit. ``--variants`` instead builds
copies of this tree's source with one part of the cluster passes taken out
(``VARIANTS``: their outputs are wrong by construction, only their times
are read) and times kernels 6 and 4's inverse at 2^26 and 2^28 in each.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from audio_matcher_tpu_torch import _build
from audio_matcher_tpu_torch.models.matcher import (
    MatchConfig,
    SnippetMatcher,
    correlation_crop,
)
from audio_matcher_tpu_torch.ops import cuda_fft as F
from audio_matcher_tpu_torch.ops import fft_plan

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "audio_matcher_tpu_torch" / "_build" / "probe"
SR = 44100
CHUNKS = (1200.0, 3000.0, 3100.0)  # fft_len 2^26, 2^27, 2^28
SLAB = 8
TOL_FFT = 1e-5  # chip_smoke.py's: two f32 FFT algorithms
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA's data sheet)
ENTRIES = ("am_major_fwd_wire", "am_major_fwd_wire2", "am_major_forward",
           "am_major_inverse", "am_major_clusters")


def edit(*pairs):
    """The source with each (old, new) replaced."""
    def run(s: str) -> str:
        for old, new in pairs:
            s = s.replace(old, new)
        return s
    return run


STORE_PEER = '    asm volatile("st.shared::cluster.f32 [%0], %1;"'
FWD_STORE = "        yr[out + (row << lm)] = vr[r];\n        yi[out + (row << lm)] = vi[r];"
INV_STORE = "                if (a0 + (r << (7 + Cl::LOG2K)) < a_crop) {"
BLOCK_FFT = ("    transform<FORWARD, false, 11, 0, Pl::NG - 1>(vr, vi, xt, xt, "
             "tile, u, tw);\n    exchange<false, Pl::w(BEFORE), Pl::w(LAST)>"
             "(vr, vi, xt, xt, tile, u);\n")
MID_BARRIER = "    cluster_arrive();\n    cluster_wait();  // and read\n"
CROSS_BUILDS = (
    "        build_cluster_cross<LOG2A>(ct, c0, LOG2A + lm, sign);\n"
    "        bases[threadIdx.x] =\n"
    "            cluster_cross_base<LOG2A>(u, c0 + col, LOG2A + lm, sign);\n",
    "        build_cluster_cross<LOG2A>(ct, c0, log2n, -1.0f);\n"
    "        bases[threadIdx.x] = cluster_cross_base<LOG2A>(u, c0 + col, "
    "log2n,\n                                                       "
    "-1.0f);\n")
VARIANTS = {  # name -> (what is taken out, edit of fft_major.cu)
    "full": ("nothing", lambda s: s),
    "no_exchange": ("the sends through the cluster (its barriers stay)",
                    edit((STORE_PEER, "    if (v == 1.2345e30f) " +
                          STORE_PEER.strip()))),
    "no_stores": ("the stores of the output planes",
                  edit((FWD_STORE, "        if (lm < 0) {\n" + FWD_STORE +
                        "\n        }"),
                       (INV_STORE, INV_STORE.replace(
                           "< a_crop)", "< a_crop && lm2 < 0)")))),
    "no_block_fft": ("the block's 2048-point stages and exchanges",
                     edit((BLOCK_FFT, ""))),
    "no_mid_barrier": ("the cluster barrier between the planes' exchanges",
                       edit((MID_BARRIER, ""))),
    "no_cross_build": ("the cross twiddles' tables and bases (sincospif)",
                       edit(*[(b, "") for b in CROSS_BUILDS])),
}
VARIANT_KERNELS = ("6 fft_major_fwd_wire2", "4 fft_major inverse")


def build(name: str, csrc: Path, change=lambda s: s
          ) -> tuple[subprocess.Popen, Path]:
    """Start nvcc on csrc's fft_major.cu (its headers beside it), edited
    by ``change``."""
    work = OUT / name
    work.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob("*.cuh"):
        (work / h.name).write_text(h.read_text())
    src = (csrc / "fft_major.cu").read_text()
    new = change(src)
    if name in VARIANTS and name != "full" and new == src:
        raise RuntimeError(f"variant {name}: the edit found nothing")
    (work / "fft_major.cu").write_text(new)
    lib = work / "libprobe.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           str(work / "fft_major.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def load(lib: Path) -> ctypes.CDLL:
    out = ctypes.CDLL(str(lib))
    for fn in ENTRIES:
        if hasattr(out, fn):
            getattr(out, fn).argtypes = list(_build.SIGNATURES[fn])
            getattr(out, fn).restype = ctypes.c_int
    return out


def ptxas_lines(log: str) -> list[str]:
    """Registers and spill bytes of every cluster_pass instantiation."""
    fn, seen = None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            seen[fn] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            seen[fn]["spill"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            seen[fn]["registers"] = int(m[1])
    return [f"{fn}: {info.get('registers')} registers, "
            f"{info.get('spill')} B spilled"
            for fn, info in seen.items() if "cluster_pass" in fn]


def timing(fn, reps=7):
    """Median of ``reps`` CUDA-event timings, each call queued behind an
    untimed one."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        fn()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rel_err(got, want) -> float:
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    return err / max(w.abs().max().item() for w in want)


def cases(dev, g):
    """Per chunk of CHUNKS: the shapes config #2's matcher takes there
    (fft_len, factors, window, the fused path's crop rows), a slab of
    random mu-law windows at its spacing, the twiddle table and the
    stream."""
    rng = np.random.default_rng(42)
    snippet = (rng.standard_normal(10 * SR) * 0.15).astype(np.float32)
    for chunk_secs in CHUNKS:
        cfg = dataclasses.replace(
            MatchConfig(slab=SLAB, slab_auto=True, transfer_dtype="mulaw8"),
            chunk_secs=chunk_secs)
        matcher = SnippetMatcher(snippet, SR, cfg, device=dev)
        n, W, chunk = matcher.fft_len, matcher.window, matcher.chunk
        A, M = F.split_factors(n)
        la, lm = A.bit_length() - 1, M.bit_length() - 1
        width = correlation_crop(matcher.valid, cfg.block, n, "vpu", "pallas")
        a_crop = width // M
        del matcher
        torch.cuda.empty_cache()
        ep = torch.randint(0, 256, ((SLAB - 1) * chunk + W,), device=dev,
                           generator=g, dtype=torch.int32).to(torch.uint8)
        win = ep.as_strided((SLAB, W), (chunk, 1))
        tw = fft_plan.twiddle_table_plain(A, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        yield n, A, M, la, lm, W, win, a_crop, tw, stream


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_major_cluster.py needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    variants = sys.argv[1:] == ["--variants"]
    builds = {"change": build("change", _build.CSRC)}
    if len(sys.argv) == 3 and sys.argv[1] == "--parent":
        builds["parent"] = build("parent", Path(sys.argv[2]))
    if variants:
        builds.update({name: build(name, _build.CSRC, change)
                       for name, (_, change) in VARIANTS.items()})
    libs = {}
    for name, (proc, lib) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed ({proc.returncode})\n{log[-6000:]}")
            continue
        spills = sum(map(int, re.findall(r"(\d+) bytes spill stores", log)))
        print(f"{name}: built, {spills} B spilled in all")
        for line in ptxas_lines(log):
            print(f"  {line}")
        libs[name] = load(lib)
    dev = torch.device("cuda", 0)
    if "change" in libs:
        for la in (13, 14):
            for e, what in enumerate(("fwd_wire u8", "fwd_wire2 u8",
                                      "forward", "inverse")):
                got = ctypes.c_int(0)
                rc = libs["change"].am_major_clusters(e, 0, la,
                                                      ctypes.byref(got))
                print(f"A = 2^{la} {what}: {got.value} clusters of "
                      f"{1 << (la - 11)} (rc {rc})")
    order = (["parent", "change", "change", "parent"] if "parent" in libs
             else ["change", "change"] if "change" in libs else [])
    order = [o for o in order if o in libs] or list(libs)
    if variants:
        order = ["change"] + [v for v in VARIANTS if v in libs] + ["change"]
    g = torch.Generator(device=dev).manual_seed(0)
    bad = []
    for n, A, M, la, lm, W, win, a_crop, tw, stream in cases(dev, g):
        log2n = n.bit_length() - 1
        x0, x1 = win[0::2], win[1::2]
        P6 = x0.shape[0]
        eff = min(W, n)

        def planes(P, seed):
            gen = torch.Generator(device=dev).manual_seed(seed)
            return (torch.randn((P, A, M), device=dev, generator=gen),
                    torch.randn((P, A, M), device=dev, generator=gen))

        calls = {
            "6 fft_major_fwd_wire2": (
                lambda lib, y: lib.am_major_fwd_wire2(
                    0, x0.data_ptr(), x0.stride(0), x1.data_ptr(),
                    x1.stride(0), x1.shape[0], y[0].data_ptr(),
                    y[1].data_ptr(), tw.data_ptr(), P6, la, lm, eff, stream),
                (P6, A, M), lambda: F.fft_major_fwd_wire2_plain(
                    x0, x1, A, n, W),
                SLAB * eff + 8 * P6 * n, None, None),
            "1 fft_major_fwd_wire": (
                lambda lib, y: lib.am_major_fwd_wire(
                    0, win.data_ptr(), win.stride(0), y[0].data_ptr(),
                    y[1].data_ptr(), tw.data_ptr(), 2, la, lm, eff, stream),
                (2, A, M), lambda: F.fft_major_fwd_wire_plain(
                    win[:2], A, n, W),
                2 * eff + 16 * n, None, None),
        }
        V = planes(4, n + 1)
        calls["4 fft_major inverse"] = (
            lambda lib, y: lib.am_major_inverse(
                V[0].data_ptr(), V[1].data_ptr(), y[0].data_ptr(),
                y[1].data_ptr(), tw.data_ptr(), 4, la, lm, a_crop, stream),
            (4, a_crop, M),
            lambda: F.fft_major_plain(V[0], V[1], A, n, a_crop),
            32 * n + 8 * 4 * a_crop * M, V, True)
        Xf = planes(2, n + 2)
        calls["4 fft_major_forward"] = (
            lambda lib, y: lib.am_major_forward(
                Xf[0].data_ptr(), Xf[1].data_ptr(), y[0].data_ptr(),
                y[1].data_ptr(), tw.data_ptr(), 2, la, lm, stream),
            (2, A, M), lambda: F.fft_major_forward_plain(Xf[0], Xf[1], A, n),
            32 * n, Xf, False)
        for name, (call, shape, plain, n_bytes, fft_in, inv) in calls.items():
            if variants and (name not in VARIANT_KERNELS or log2n == 27):
                continue
            y = (torch.empty(shape, device=dev), torch.empty(shape, device=dev))
            bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            rec = {"kernel": name, "fft_len": f"2^{log2n}", "A": A, "M": M,
                   "bound_ms": bound_ms, "card": card}
            if "change" in libs:
                rc = call(libs["change"], y)
                torch.cuda.synchronize()
                if rc:
                    raise RuntimeError(f"{name} at 2^{log2n}: rc {rc}")
                first = (y[0].clone(), y[1].clone())
                call(libs["change"], y)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(first, y))
                del first
                err = rel_err(y, plain())
                rec.update(rel_err=err, twice_equal=same)
                if not (err <= TOL_FFT and same):
                    bad.append(f"{name} at 2^{log2n}: {err:.3e}, twice "
                               f"equal {same}")
                torch.cuda.empty_cache()
            for k, lib_name in enumerate(order):
                ms = timing(lambda: call(libs[lib_name], y))
                rec[f"{lib_name}_ms_{k}"] = ms
            if fft_in is not None:
                xc = torch.complex(fft_in[0], fft_in[1])
                rec["torch_fft_ms"] = timing(
                    (lambda: torch.fft.ifft(xc, dim=1, norm="forward")) if inv
                    else (lambda: torch.fft.fft(xc, dim=1)))
                del xc
            del y
            torch.cuda.empty_cache()
            print(json.dumps(rec))
        del V, Xf, win, calls
        torch.cuda.empty_cache()
    print(card)
    if bad or "change" not in libs:
        print("FAILED: " + "; ".join(bad or ["this tree did not build"]))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
