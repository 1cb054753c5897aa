#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``audio_matcher_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

1. Builds the hand-written kernels (``audio_matcher_tpu_torch/csrc``) with
   nvcc for sm_90a.
2. Runs each of the five kernel entry points of the batch scan, and its
   plain PyTorch version, on the card at the BASELINE config #3 slab shapes
   (8 windows of a 1800 s 44.1 kHz mu-law episode, 32 query pairs,
   A = M = 2048): the FFT passes must agree within TOL_FFT of the largest
   plain value, the block reduction exactly. Both are timed (median of 5
   CUDA-event timings).
3. Scans one episode on the kernel path and on the plain path: every raw
   candidate and every final peak at the same position, heights and
   prominences within TOL_SCAN.
4. Drives the config #3 batch scan end to end through ``ShardedScanner``:
   4 episodes x 64 queries (10-13.5 s), mulaw8 wire, slab 8, inputs built
   from seed 42 as the JAX package's bench builds them. Every plant of query
   0 must be found within 1 sample, and every kernel must have been launched
   by that scan.
5. Traces one more scan with torch.profiler and prints the device time of
   each kernel and the device's idle share of the scan.

The run uses one card: only the first visible device is made visible.
Any failure raises and exits non-zero. The second-to-last line is a JSON
object of the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
    "CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from audio_matcher_tpu_torch import _build  # noqa: E402
from audio_matcher_tpu_torch.models.matcher import (  # noqa: E402
    MatchConfig,
    pad_wire_on_device,
    quantize_wire,
    window_rows,
    windows_from_episode,
)
from audio_matcher_tpu_torch.ops import cuda_fft as F  # noqa: E402
from audio_matcher_tpu_torch.ops import cuda_kernels as K  # noqa: E402
from audio_matcher_tpu_torch.ops.peaks import peaks_crop_width  # noqa: E402
from audio_matcher_tpu_torch.parallel.sweep import ShardedScanner  # noqa: E402

SR = 44100
EPISODE_SECS = 1800
SNIPPET_SECS = 10.0
N_EPISODES = 4
N_QUERIES = 64
SLAB = 8
# Two f32 FFT algorithms (radix-2 butterflies in the kernels, cuFFT in the
# plain versions) on the same inputs: measured ~3e-7 of the largest value.
TOL_FFT = 1e-5
TOL_SCAN = 1.2e-5  # the reference's oracle tolerance (tests/test_correlate.py)
PLANT_TOL = 1  # samples

CSRC = "audio_matcher_tpu_torch/csrc/"
KERNEL_ROWS = {  # wrapper name → (CUDA source, the TPU kernel's pallas_call)
    "fft_major_fwd_wire": (CSRC + "fft_passes.cu",
                           "audio_matcher_tpu/ops/pallas_fft.py:357"),
    "fft_minor": (CSRC + "fft_passes.cu",
                  "audio_matcher_tpu/ops/pallas_fft.py:506"),
    "ifft_minor_product": (CSRC + "fft_passes.cu",
                           "audio_matcher_tpu/ops/pallas_fft.py:593"),
    "fft_major": (CSRC + "fft_passes.cu",
                  "audio_matcher_tpu/ops/pallas_fft.py:258"),
    "local_max_block_reduce_packed": (
        CSRC + "block_reduce.cu",
        "audio_matcher_tpu/ops/pallas_kernels.py:238"),
}


def make_bench_inputs():
    """Seed-42 snippets, plant offsets and episode, built in the order the
    JAX package's bench.py builds them (make_bench_inputs, make_audio)."""
    rng = np.random.default_rng(42)
    snippets = [
        np.clip(
            rng.standard_normal(int((SNIPPET_SECS + 0.5 * (q % 8)) * SR))
            * 0.15, -0.45, 0.45,
        ).astype(np.float32)
        for q in range(N_QUERIES)
    ]
    offsets = [o for o in (21.0, EPISODE_SECS * 0.55)
               if (o + SNIPPET_SECS + 0.5) < EPISODE_SECS] or [0.0]
    episode = (rng.standard_normal(int(EPISODE_SECS * SR)) * 0.05).astype(
        np.float32)
    for off in offsets:
        i = int(off * SR)
        episode[i : i + len(snippets[0])] = snippets[0]
    return snippets, offsets, episode


def check_plants(peaks, offsets, distance_secs):
    """Every episode finds query 0's plants within PLANT_TOL samples."""
    want = sorted(int(o * SR) for o in offsets)
    assert len(offsets) > 1 and offsets[1] - offsets[0] >= distance_secs
    for e, ep_peaks in enumerate(peaks):
        got = sorted(p.position for p in ep_peaks if p.height > 0.5)
        if len(got) != len(want) or any(
            abs(a - b) > PLANT_TOL for a, b in zip(got, want)
        ):
            raise AssertionError(
                f"episode {e}: plants at {want}, found {got}")


def cuda_ms(fn, reps=5):
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_planes(name, got, want, rows):
    """Largest |kernel - plain| of a pair of planes, against TOL_FFT."""
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    ref = max(w.abs().max().item() for w in want)
    rel = err / ref
    print(f"{name}: max |kernel - plain| = {err:.3e} "
          f"({rel:.3e} of max |plain| {ref:.3e}; tol {TOL_FFT:g})")
    if not rel <= TOL_FFT:
        raise AssertionError(f"{name} disagrees with its plain version")
    rows[name]["max_abs_err"] = err


def check_kernels(scanner, episode_wire, rows):
    """Every kernel entry point against its plain version at the config #3
    slab shapes, on the first slab of one staged episode."""
    st = scanner.query_state
    Qh, n = st.t_r.shape
    A, M = F.split_factors(n)
    staged, ns, _ = scanner.stage_resident([episode_wire])
    W = scanner.window
    ep = pad_wire_on_device(
        staged[0], (SLAB + window_rows(W, scanner.chunk)) * scanner.chunk)
    win = windows_from_episode(ep, 0, SLAB, scanner.chunk, W)
    print(f"slab: windows {tuple(win.shape)} {win.dtype}, n = {n} "
          f"(A = {A}, M = {M}), query pairs {Qh}")
    tr, ti = st.t_r.view(Qh, A, M), st.t_i.view(Qh, A, M)

    def timed(name, kernel, plain):
        rows[name]["ms"] = cuda_ms(kernel)
        rows[name]["plain_ms"] = cuda_ms(plain)
        print(f"{name}: kernel {rows[name]['ms']:.3f} ms, "
              f"plain {rows[name]['plain_ms']:.3f} ms")

    X = F.fft_major_fwd_wire(win, A, n, W)
    compare_planes("fft_major_fwd_wire", X,
                   F.fft_major_fwd_wire_plain(win, A, n, W), rows)
    timed("fft_major_fwd_wire",
          lambda: F.fft_major_fwd_wire(win, A, n, W, out=X),
          lambda: F.fft_major_fwd_wire_plain(win, A, n, W))

    Y = F.fft_minor(X[0], X[1], M)
    compare_planes("fft_minor", Y, F.fft_minor_plain(X[0], X[1], M), rows)
    timed("fft_minor", lambda: F.fft_minor(X[0], X[1], M, out=Y),
          lambda: F.fft_minor_plain(X[0], X[1], M))
    del X

    V = F.ifft_minor_product(Y[0], Y[1], tr, ti, M)
    Vp = F.ifft_minor_product_plain(Y[0], Y[1], tr, ti, M)
    compare_planes("ifft_minor_product", V, Vp, rows)
    timed("ifft_minor_product",
          lambda: F.ifft_minor_product(Y[0], Y[1], tr, ti, M, out=V),
          lambda: F.ifft_minor_product_plain(Y[0], Y[1], tr, ti, M, out=Vp))
    del Vp, Y

    width = F.round_planes_width(
        min(peaks_crop_width(scanner.valid, scanner.config.block), n), n)
    a_crop = width // M
    Z = F.fft_major(V[0], V[1], A, n, a_crop)
    Zp = F.fft_major_plain(V[0], V[1], A, n, a_crop)
    compare_planes("fft_major", Z, Zp, rows)
    timed("fft_major",
          lambda: F.fft_major(V[0], V[1], A, n, a_crop, out=Z),
          lambda: F.fft_major_plain(V[0], V[1], A, n, a_crop, out=Zp))
    del V, Zp

    P = Z[0].shape[0]
    zr, zi = Z[0].view(P, width), Z[1].view(P, width)
    Q = st.inv_ac.shape[0]
    scale = torch.nn.functional.pad(st.inv_ac, (0, 2 * Qh - Q)).repeat(SLAB)
    starts = torch.arange(SLAB, device=zr.device) * scanner.chunk
    win_len = (int(ns[0]) - starts).clamp(0, W)
    m_pad = torch.nn.functional.pad(st.m, (0, 2 * Qh - Q), value=1)
    valid = (win_len[:, None] - m_pad[None, :] + 1).clamp(min=0).reshape(-1)
    got = K.local_max_block_reduce_packed(zr, zi, scale, valid, 512)
    want = K.local_max_block_reduce_packed_plain(zr, zi, scale, valid, 512)
    same = [torch.equal(g, w) for g, w in zip(got, want)]
    print(f"local_max_block_reduce_packed: outputs {tuple(got[0].shape)}, "
          f"exactly equal to the plain version: {same}")
    if not all(same):
        raise AssertionError("the block reduction disagrees")
    rows["local_max_block_reduce_packed"]["max_abs_err"] = 0.0
    timed("local_max_block_reduce_packed",
          lambda: K.local_max_block_reduce_packed(zr, zi, scale, valid, 512),
          lambda: K.local_max_block_reduce_packed_plain(
              zr, zi, scale, valid, 512))
    del Z, zr, zi, got, want


def compare_paths(scanner, plain_scanner, episode_wire):
    """One episode on the kernel path and on the plain path: every raw
    candidate (64 queries x 32 windows x n_peaks) and the final peaks at
    the same positions, heights and prominences within TOL_SCAN."""
    staged = scanner.stage_resident([episode_wire])
    got = scanner.scan_dispatch(staged)
    want = plain_scanner.scan_dispatch(staged)
    (pk, hk, rk), (pp, hp, rp) = (
        [a.cpu().numpy() for a in d[0]] for d in (got, want))
    fin = np.isfinite(hp)
    if not np.array_equal(np.isfinite(hk), fin):
        raise AssertionError("kernel and plain paths found different counts")
    moved = int((fin & (pk != pp)).sum())
    dh = float(np.abs(hk[fin] - hp[fin]).max()) if fin.any() else 0.0
    dprom = float(np.abs(rk[fin] - rp[fin]).max()) if fin.any() else 0.0
    print(f"one episode, kernel path vs plain path: {int(fin.sum())} raw "
          f"candidates, {moved} at another position, max |dh| = {dh:.3e}, "
          f"max |dprom| = {dprom:.3e} (tol {TOL_SCAN:g})")
    if moved or not max(dh, dprom) <= TOL_SCAN:
        raise AssertionError("kernel and plain paths disagree")
    peaks_k = scanner.scan_collect(got)[0]
    peaks_p = plain_scanner.scan_collect(want)[0]
    for q, (g, w) in enumerate(zip(peaks_k, peaks_p)):
        if [p.position for p in g] != [p.position for p in w] or any(
            abs(a.height - b.height) > TOL_SCAN
            or abs(a.prominence - b.prominence) > TOL_SCAN
            for a, b in zip(g, w)
        ):
            raise AssertionError(f"query {q}: kernel path {g}, plain {w}")
    print(f"final peaks identical in position, within {TOL_SCAN:g} in "
          f"height and prominence: {sum(len(g) for g in peaks_k)} peaks")


def profile_scan(scanner, staged):
    """One scan under torch.profiler: device ms per kernel, and the share
    of the scan's wall time in which no kernel or copy ran on the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scanner.scan_staged(staged)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name, spans = {}, []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_name[ev.name] = (per_name.get(ev.name, 0.0)
                                 + ev.time_range.elapsed_us() / 1e3)
            spans.append((ev.time_range.start, ev.time_range.end))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):  # union of the device intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3
    print(f"profile of one scan: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share "
          f"{100 * (1 - busy_ms / (wall * 1e3)):.1f} %")
    if not spans:
        print("  no device events traced: per-kernel times not measured")
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1]):
        if ms >= 0.01 * busy_ms:
            print(f"  {ms:9.2f} ms  {100 * ms / busy_ms:5.1f} %  {name}")
    rest = sum(ms for ms in per_name.values() if ms < 0.01 * busy_ms)
    print(f"  {rest:9.2f} ms  {100 * rest / max(busy_ms, 1e-9):5.1f} %  "
          f"{sum(ms < 0.01 * busy_ms for ms in per_name.values())} other "
          f"kernels under 1 % each")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds():.2f} s)")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    snippets, offsets, episode = make_bench_inputs()
    config = MatchConfig(slab=SLAB, slab_auto=True, transfer_dtype="mulaw8")
    episode_wire = quantize_wire(episode, config.transfer_dtype)
    dev = torch.device("cuda", 0)
    scanner = ShardedScanner(snippets, SR, config, device=dev)
    plain_scanner = ShardedScanner(
        snippets, SR, config, device=dev, query_state=scanner.query_state,
        plain=True)
    print(f"config #3: {N_EPISODES} x {EPISODE_SECS} s episodes, "
          f"{N_QUERIES} queries, {config.transfer_dtype}, slab {SLAB}, "
          f"fft_len {scanner.fft_len}, {scanner.n_peaks} peaks per window")

    rows = {name: {"name": name, "route": "cuda", "source": src,
                   "replaces": tpu}
            for name, (src, tpu) in KERNEL_ROWS.items()}
    check_kernels(scanner, episode_wire, rows)
    torch.cuda.empty_cache()
    compare_paths(scanner, plain_scanner, episode_wire)
    torch.cuda.empty_cache()

    # the main path: stage the batch, scan it once to warm, then the
    # measured scan with every launch count reset just before it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = scanner.stage_resident([episode_wire] * N_EPISODES)
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    staged_mb = staged[0].numel() * staged[0].element_size() / 1e6
    scanner.scan_staged(staged)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in F.KERNELS + K.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    results = scanner.scan_staged(staged)
    t_scan = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in F.KERNELS + K.KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check_plants([per_query[0] for per_query in results], offsets,
                 config.distance_secs)
    n_pairs = N_EPISODES * N_QUERIES
    hours = EPISODE_SECS / 3600.0 * n_pairs
    print(f"stage: {staged_mb:.1f} MB in {t_stage:.3f} s "
          f"({staged_mb / t_stage:.1f} MB/s)")
    print(f"scan: {t_scan:.3f} s for {n_pairs} pairs")
    print(f"pair audio-hours/s: {hours / (t_stage + t_scan):.3f} end to "
          f"end, {hours / t_scan:.3f} device-resident")
    print(f"torch.cuda.max_memory_allocated during the scan: "
          f"{peak_gb:.2f} GB")
    print(f"plants of query 0 found within {PLANT_TOL} sample in all "
          f"{N_EPISODES} episodes")
    print(f"launches in the scan: {launches}")
    missing = [name for name, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"the scan never launched {missing}")
    for name, row in rows.items():
        row["launches"] = launches[name]
    profile_scan(scanner, staged)
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces",
                             "launches", "max_abs_err", "ms", "plain_ms")}
        for row in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
