#!/usr/bin/env python3
"""The minor FFT pass at M = 8192 and 16384, forward and inverse, against
an earlier source, on one GPU.

    python3 probe_minor_wide.py [--parent DIR]   # from the repository root
    python3 probe_minor_wide.py --variants [--source DIR]
    python3 probe_minor_wide.py --check

Builds ``audio_matcher_tpu_torch/csrc/fft_minor.cu`` (and its headers)
into a library of its own under ``audio_matcher_tpu_torch/_build/
probe_minor``, and with ``--parent DIR`` the ``fft_minor.cu`` and headers
found in DIR
(an earlier commit's ``csrc``) beside it, both with the package's nvcc
flags, side by side. At fft_len 2^25, 2^26, 2^27 and 2^28 (config #2's
chunks of 600 to 3100 s at 44.1 kHz: A x M = 4096 x 8192, 8192 x 8192,
8192 x 16384, 16384 x 16384) it times the forward (``am_minor_forward``)
and inverse (``am_minor_inverse``) modes on P = 4 random planes, config
#2's slab of 4 window pairs, in the order parent, this tree, this tree,
parent (median of 7 CUDA-event timings each), beside each call's byte
bound (two f32 planes read, two written) and one ``torch.fft`` along the
rows of the same planes. This tree's outputs must be within TOL_FFT of
the plain versions and bitwise equal over two launches. Prints ptxas's
registers and spills of every minor-pass instantiation, the clusters the
card holds for each mode (``am_minor_clusters``, where the source has
it), one JSON line per call timed and the card's name and power limit.
``--check`` builds and checks this tree's source without timing it.
``--variants`` instead builds copies of this tree's source (or of DIR's
with ``--source DIR``) with one part of the pass taken out (``VARIANTS``,
each an edit of either design, the one-row blocks before the clusters or
the rows on clusters; their outputs are wrong by construction, only their
times are read) and times both modes at 2^25 and 2^28 in each.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from audio_matcher_tpu_torch import _build
from audio_matcher_tpu_torch.ops import cuda_fft as F
from audio_matcher_tpu_torch.ops import fft_plan

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "audio_matcher_tpu_torch" / "_build" / "probe_minor"
LOG2NS = (25, 26, 27, 28)
VARIANT_LOG2NS = (25, 28)
PLANES = 4  # config #2's slab of 8 windows as 4 window pairs
TOL_FFT = 1e-5  # chip_smoke.py's: two f32 FFT algorithms
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA's data sheet)
ENTRIES = ("am_minor_forward", "am_minor_inverse", "am_minor_clusters")
MODES = {"fft_minor": "am_minor_forward", "ifft_minor": "am_minor_inverse"}


def edit(*pairs):
    """The source with each (old, new) replaced where old occurs; the
    pairs of both designs are listed, and at least one must be found."""
    def run(s: str) -> str:
        for old, new in pairs:
            s = s.replace(old, new)
        return s
    return run


# the one-row blocks (up to the clusters): loads, stores of minor_pass
ROW_FWD_LOAD = ("                vr[r] = live ? __ldg(xr + base + u + (r << "
                "LOG2T)) : 0.0f;\n                vi[r] = live ? __ldg(xi + "
                "base + u + (r << LOG2T)) : 0.0f;")
ROW_INV_LOAD = ("                load_run(vr, xr + base + (u << LOG2_PTS));\n"
                "                load_run(vi, xi + base + (u << LOG2_PTS));")
ROW_FWD_STORE = ("                store_runs(yr + base, vr, u);\n"
                 "                store_runs(yi + base, vi, u);")
ROW_INV_STORE = ("                    yr[base + u + (r << LOG2T)] = vr[r];\n"
                 "                    yi[base + u + (r << LOG2T)] = vi[r];")
# the rows on clusters: minor_cluster_pass
CL_FWD_LOAD = ("                vr[r] = __ldg(xr + at + (r << Cl::W0));\n"
               "                vi[r] = __ldg(xi + at + (r << Cl::W0));")
CL_INV_LOAD = ("            load_runs(vr, xr + own, t);\n"
               "            load_runs(vi, xi + own, t);")
CL_FWD_STORE = ("        store_runs(yr + own, vr, t);\n"
                "        store_runs(yi + own, vi, t);")
CL_INV_STORE = ("            yr[row + U + (r << Cl::W0)] = vr[r];\n"
                "            yi[row + U + (r << Cl::W0)] = vi[r];")
CL_FWD_EXCHANGE = (" " * 8 + "exchange<true, Pl::w(1), Pl::w(2)>(vr, vi, sr, "
                   "si, tile,\n" + " " * 43 + "opaque((int)threadIdx.x));\n")
STORE_PEER = '    asm volatile("st.shared::cluster.f32 [%0], %1;"'
# fft_passes.cuh: the exchange into group 2 (the third forward, the second
# inverse) of a transform, and the stages of every group it runs
THIRD_EXCHANGE = "    if constexpr (S > 0) {\n        constexpr int F ="
GROUP_STAGES = ("    run_group<FORWARD, P::w(G), P::qlo(G), P::k(G)>(xr, xi, "
                "u, tw);\n")
ROOTED_STAGE = (" " * 45 + "float (&xi)[PTS], int q,\n" + " " * 45
                + "float2 b) {\n")


def _opaque_loads(text: str, a: str) -> str:
    """Loads replaced by a value the compiler cannot fold: the thread's
    index and the register."""
    return re.sub(r"__ldg\([^;]*\)", f"(float)({a} + r)", text)


def _guarded(text: str, var: str) -> str:
    """Stores kept in the code but never run (``var`` is never negative)."""
    pad = re.match(r"\s*", text).group(0)
    return f"{pad}if ({var} < 0) {{\n{text}\n{pad}}}"


def _no_load_run(text: str) -> str:
    return "\n".join(
        re.sub(r"load_runs?\((v[ri]), .*\);",
               r"for (int r = 0; r < PTS; ++r) \1[r] = (float)(r + "
               r"threadIdx.x);", line) for line in text.splitlines())


VARIANTS = {  # name -> (what is taken out, edit of fft_minor.cu and headers)
    "full": ("nothing", lambda s: s),
    "no_loads": ("the loads of the input planes", edit(
        (ROW_FWD_LOAD, _opaque_loads(ROW_FWD_LOAD, "u")),
        (ROW_INV_LOAD, _no_load_run(ROW_INV_LOAD)),
        (CL_FWD_LOAD, _opaque_loads(CL_FWD_LOAD, "U")),
        (CL_INV_LOAD, _no_load_run(CL_INV_LOAD)))),
    "no_stores": ("the stores of the output planes", edit(
        (ROW_FWD_STORE, _guarded(ROW_FWD_STORE, "(int)blockIdx.x")),
        (ROW_INV_STORE, _guarded(ROW_INV_STORE, "(int)blockIdx.x")),
        (CL_FWD_STORE, _guarded(CL_FWD_STORE, "(int)blockIdx.x")),
        (CL_INV_STORE, _guarded(CL_INV_STORE, "(int)blockIdx.x")))),
    "no_exchange": ("one exchange through shared memory (the one into "
                    "stage group 2)", edit(
        (THIRD_EXCHANGE, THIRD_EXCHANGE.replace("S > 0", "S > 0 && G != 2")),
        (CL_FWD_EXCHANGE, ""))),
    "no_stages": ("the stages of every group", edit(
        (GROUP_STAGES, ""), (ROOTED_STAGE, ROOTED_STAGE + "    if (q >= 0) "
                                           "return;\n"))),
    "no_cluster_sends": ("the sends through the cluster (its barriers "
                         "stay; the rows on clusters only)", edit(
        (STORE_PEER, "    if (v == 1.2345e30f) " + STORE_PEER.strip()))),
}


def build(name: str, csrc: Path, change=lambda s: s
          ) -> tuple[subprocess.Popen, Path] | None:
    """Start nvcc on csrc's fft_minor.cu (its headers beside it), each
    file edited by ``change``; None where a variant's edit found nothing
    in this source (the part is not in its design)."""
    work = OUT / name
    work.mkdir(parents=True, exist_ok=True)
    changed = False
    for src in [*csrc.glob("*.cuh"), csrc / "fft_minor.cu"]:
        text = src.read_text()
        new = change(text)
        changed |= new != text
        (work / src.name).write_text(new)
    if name in VARIANTS and name != "full" and not changed:
        return None
    lib = work / "libprobe.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           str(work / "fft_minor.cu")]
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
    """Registers and spill bytes of every minor-pass instantiation."""
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
            for fn, info in seen.items() if "minor" in fn]


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


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_minor_wide.py needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    args = sys.argv[1:]
    variants, check_only = "--variants" in args, "--check" in args
    source = (Path(args[args.index("--source") + 1]) if "--source" in args
              else _build.CSRC)
    builds = {}
    if not variants:
        builds["change"] = build("change", _build.CSRC)
    if "--parent" in args:
        builds["parent"] = build("parent", Path(args[args.index("--parent")
                                                     + 1]))
    if variants:
        for name, (_, change) in VARIANTS.items():
            got = build(name, source, change)
            if got is None:
                print(f"{name}: not in this source's design, skipped")
            else:
                builds[name] = got
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, lib in libs.items():
        if name in VARIANTS or not hasattr(lib, "am_minor_clusters"):
            continue
        for lm in (13, 14):
            for inverse in (0, 1):
                got = ctypes.c_int(0)
                rc = lib.am_minor_clusters(inverse, lm, ctypes.byref(got))
                mode = "inverse" if inverse else "forward"
                print(f"{name}: M = 2^{lm} {mode}: {got.value} clusters of "
                      f"{1 << (lm - 12)} (rc {rc})")
    if variants:
        base = "full"
        order = [base] + [v for v in VARIANTS if v in libs and v != base] + [
            base]
    else:
        base = "change"
        order = (["parent", "change", "change", "parent"] if "parent" in libs
                 else ["change", "change"])
    order = [o for o in order if o in libs]
    if check_only:
        order = []
    bad = []
    for log2n in (VARIANT_LOG2NS if variants else LOG2NS):
        n = 1 << log2n
        A, M = F.split_factors(n)
        lm = M.bit_length() - 1
        rows = PLANES * A
        gen = torch.Generator(device=dev).manual_seed(log2n)
        X = (torch.randn((PLANES, A, M), device=dev, generator=gen),
             torch.randn((PLANES, A, M), device=dev, generator=gen))
        Y = (torch.empty_like(X[0]), torch.empty_like(X[1]))
        tw = fft_plan.twiddle_table_plain(M, dev)
        for mode, entry in MODES.items():
            plain = F.fft_minor_plain if mode == "fft_minor" else (
                F.ifft_minor_plain)

            def call(lib, entry=entry):
                return getattr(lib, entry)(
                    X[0].data_ptr(), X[1].data_ptr(), Y[0].data_ptr(),
                    Y[1].data_ptr(), tw.data_ptr(), rows, lm, stream)

            rec = {"kernel": mode, "fft_len": f"2^{log2n}", "A": A, "M": M,
                   "P": PLANES,
                   "bound_ms": 16 * PLANES * n / HBM_BYTES_PER_S * 1e3,
                   "card": card}
            if base in libs:
                rc = call(libs[base])
                torch.cuda.synchronize()
                if rc:
                    raise RuntimeError(f"{mode} at 2^{log2n}: rc {rc}")
                first = (Y[0].clone(), Y[1].clone())
                call(libs[base])
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(first, Y))
                del first
                err = rel_err(Y, plain(X[0], X[1], M))
                torch.cuda.empty_cache()
                rec.update(rel_err=err, twice_equal=same)
                if not (err <= TOL_FFT and same):
                    bad.append(f"{mode} at 2^{log2n}: {err:.3e}, twice "
                               f"equal {same}")
            for k, lib_name in enumerate(order):
                rc = call(libs[lib_name])
                if rc:
                    raise RuntimeError(f"{lib_name} {mode} at 2^{log2n}: "
                                       f"rc {rc}")
                rec[f"{lib_name}_ms_{k}"] = timing(
                    lambda: call(libs[lib_name]))
            if order and not variants:
                xc = torch.complex(X[0], X[1])
                rec["torch_fft_ms"] = timing(
                    (lambda: torch.fft.fft(xc, dim=-1)) if mode == "fft_minor"
                    else (lambda: torch.fft.ifft(xc, dim=-1, norm="forward")))
                del xc
                torch.cuda.empty_cache()
            print(json.dumps(rec))
        del X, Y
        torch.cuda.empty_cache()
    print(card)
    if bad or base not in libs:
        print("FAILED: " + "; ".join(bad or [f"{base} did not build"]))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
