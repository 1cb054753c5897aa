#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``audio_matcher_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

It drives the port's three paths, each through the entry points a user
calls, and holds every kernel against its plain PyTorch version:

1. Builds the hand-written kernels (``audio_matcher_tpu_torch/csrc``) with
   nvcc for sm_90a, one nvcc per source, all started together, and prints
   ptxas's registers, stack and spill bytes for every instantiation; a
   spill in an FFT pass or in the block reduction fails the run.
2. The batch scan (BASELINE config #3). Runs each of the five kernel entry
   points of the multi-query path, and its plain PyTorch version, on the
   card at the config #3 slab shapes (8 windows of a 1800 s 44.1 kHz
   mu-law episode, 32 query pairs, A = M = 2048): the FFT passes must
   agree within TOL_FFT of the largest plain value, the block reduction
   exactly. Both are timed (median of 5 CUDA-event timings). Scans one
   episode on the kernel path and on the plain path: every raw candidate
   and every final peak at the same position, heights and prominences
   within TOL_SCAN. Drives the scan end to end through ``ShardedScanner``:
   4 episodes x 64 queries (10-13.5 s), mulaw8 wire, slab 8, inputs built
   from seed 42 as the JAX package's bench builds them. Every plant of
   query 0 must be found within 1 sample, and every kernel of the path
   must have been launched by that scan. Traces one more scan with
   torch.profiler: the device time of each kernel and the device's idle
   share.
3. The single-query matcher (config #2: one 3600 s episode x one 10 s
   snippet, mulaw8, seed 42 as the bench builds it, plants at 21 s and
   1980 s). Kernel 6 (the window-pair forward pass) against its plain
   version at the config #2 slab (8 windows) and at an odd slab of 5;
   kernels 2-4 at the single-query launch shapes (4 planes, one query
   spectrum). One episode on the kernel path against the plain path.
   Then ``SnippetMatcher.stage`` + ``match_staged`` and
   ``ShardedScanner([snippet]).scan_resident``, 5 timed repeats each
   (p50 of stage, scan and end to end); both must find the two plants
   within 1 sample, with kernels 2-6 launched. A torch.profiler trace of
   one config #2 scan.
4. The ``xla_packed`` scan with the dense peak reduction (kernel 7):
   kernel 7 against its plain version at the scan's slab shape, then
   ``ShardedScanner(fft_impl="xla_packed")`` on 1 x 1800 s x 8 queries;
   the plants of query 0 found, kernel 7 launched.
5. The two-factor FFT from f32 planes, ``fft2_scrambled``: the forward
   major pass of complex planes (``fft_major_forward``) and the inverse
   minor pass (``ifft_minor``) against their plain versions at n = 2^22
   on the config #3 slab's 8 windows dequantized to f32, both timed
   beside ``torch.fft`` over the same axis; the forward + inverse round
   trip, which must give n times its input.
6. ``fft_impl="vpu"`` with ``peaks_impl="jnp"`` (the non-fused path, the
   [B, Q, V] correlation volume materialized): ``ShardedScanner`` on
   1 x 1800 s x 64 queries, against ``plain=True`` (every raw candidate)
   and against the fused scanner's final peaks; launches of the four FFT
   passes and none of the packed reduction; peak device memory; a
   profile. Then config #2 through ``SnippetMatcher(fft_impl="vpu",
   peaks_impl="jnp")`` (against plain, p50 of 5 runs) and through
   ``match(device="cuda")`` with the JAX package's defaults ``"xla"`` +
   ``"jnp"``, with ``"xla"`` + ``"pallas"`` (kernel 7) and with
   ``"mxu"`` + ``"jnp"``: each must find the plants and give the fused
   path's peaks within TOL_SCAN.
7. fft_len 2^23 and 2^24: config #2's episode through
   ``SnippetMatcher(chunk_secs=120)`` and ``(chunk_secs=240)`` on the
   fused path; kernels 6, 2, 3, 4 and 5 against their plain versions on
   one slab, timed; the plants found in p50-of-5 timed runs.

Every kernel is timed beside its bound: the larger of the bytes it must
move (each input read once, each output written once) over the H100's
3.35 TB/s and its FP32 operations (10 per radix-2 butterfly, 6 per
complex product) over 67 TFLOP/s, at the shapes it was timed at, and the
FFT passes beside their times when every radix-2 stage was one round trip
through shared memory (RADIX2_CHAIN_MS); the four rows redesigned after
that (the wire passes and both block reductions) also beside their times
before that redesign (BEFORE_REDESIGN_MS), and the two reductions beside
one ``torch.amax`` over the same planes, a plain streaming read's time on
this card (not the same function, so not a library time). Every path's launch counts are set to 0 just before the run that is read and
read just after it. The run uses one card: only the first visible
device is made visible. Any failure raises and exits non-zero. The
second-to-last line is a JSON object of the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""


from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import time

os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
    "CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from audio_matcher_tpu_torch import _build, match  # noqa: E402
from audio_matcher_tpu_torch.models.matcher import (  # noqa: E402
    MatchConfig,
    SnippetMatcher,
    _match_episode_resident,
    correlation_crop,
    pad_wire_on_device,
    quantize_wire,
    scan_slab,
    window_rows,
    windows_from_episode,
)
from audio_matcher_tpu_torch.ops import cuda_fft as F  # noqa: E402
from audio_matcher_tpu_torch.ops import cuda_kernels as K  # noqa: E402
from audio_matcher_tpu_torch.ops.correlate import (  # noqa: E402
    corr_slab_xla_packed,
)
from audio_matcher_tpu_torch.ops.peaks import peaks_crop_width  # noqa: E402
from audio_matcher_tpu_torch.ops.wire import dequant_to_f32  # noqa: E402
from audio_matcher_tpu_torch.parallel.sweep import ShardedScanner  # noqa: E402

SR = 44100
EPISODE_SECS = 1800
SNIPPET_SECS = 10.0
N_EPISODES = 4
N_QUERIES = 64
SLAB = 8
SINGLE_EPISODE_SECS = 3600  # config #2: one 1 h episode x one 10 s snippet
ODD_SLAB = 5  # a 10-minute episode's slab: the last window pair is padded
REPEATS = 5  # timed repeats of each config #2 entry point
XLA_QUERIES = 8  # the xla_packed scan: 1 x 1800 s x 8 queries
# Two f32 FFT algorithms (radix-2 butterflies in the kernels, cuFFT in the
# plain versions) on the same inputs: measured ~3e-7 of the largest value.
TOL_FFT = 1e-5
TOL_SCAN = 1.2e-5  # the reference's oracle tolerance (tests/test_correlate.py)
PLANT_TOL = 1  # samples
NAME_CHARS = 96  # kernel names printed by the profile phases
JNP_QUERIES = 64  # the vpu + jnp scan: 1 x 1800 s x 64 queries
LARGE_CHUNKS = (120.0, 240.0)  # chunk_secs giving fft_len 2^23 and 2^24
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA's data sheet)
# The FFT passes' times before the stage-group design, when every stage was
# one round trip through shared memory: this script at commit 0c3e91a on an
# NVIDIA H100 80GB HBM3 at 700 W, at the shapes timed here.
RADIX2_CHAIN_MS = {
    "fft_major_fwd_wire": 0.725, "fft_minor": 0.738,
    "ifft_minor_product": 22.346, "fft_major": 22.519,
    "fft_major_fwd_wire2": 0.440, "fft_major_forward": 0.842,
    "ifft_minor": 0.799,
}
# The times of the wire passes and the block reductions before their
# redesign: this script at commit 28b7f84 on an NVIDIA H100 80GB HBM3 at
# 700 W, at the shapes timed here.
BEFORE_REDESIGN_MS = {
    "fft_major_fwd_wire": 0.261, "local_max_block_reduce_packed": 3.467,
    "fft_major_fwd_wire2": 0.196, "local_max_block_reduce": 0.475,
}
FP32_FLOPS = 67e12  # H100 SXM, FP32 outside the tensor cores

CSRC = "audio_matcher_tpu_torch/csrc/"
KERNEL_ROWS = {  # wrapper name → (CUDA source, the TPU kernel's pallas_call)
    "fft_major_fwd_wire": (CSRC + "fft_major.cu",
                           "audio_matcher_tpu/ops/pallas_fft.py:357"),
    "fft_minor": (CSRC + "fft_minor.cu",
                  "audio_matcher_tpu/ops/pallas_fft.py:506"),
    "ifft_minor_product": (CSRC + "fft_minor.cu",
                           "audio_matcher_tpu/ops/pallas_fft.py:593"),
    "fft_major": (CSRC + "fft_major.cu",
                  "audio_matcher_tpu/ops/pallas_fft.py:258"),
    "local_max_block_reduce_packed": (
        CSRC + "block_reduce.cu",
        "audio_matcher_tpu/ops/pallas_kernels.py:238"),
    "fft_major_fwd_wire2": (CSRC + "fft_major.cu",
                            "audio_matcher_tpu/ops/pallas_fft.py:452"),
    "local_max_block_reduce": (
        CSRC + "block_reduce.cu",
        "audio_matcher_tpu/ops/pallas_kernels.py:137"),
    # fft_major with inverse=False, cross=True; fft_minor with inverse=True
    "fft_major_forward": (CSRC + "fft_major.cu",
                          "audio_matcher_tpu/ops/pallas_fft.py:258"),
    "ifft_minor": (CSRC + "fft_minor.cu",
                   "audio_matcher_tpu/ops/pallas_fft.py:506"),
}
ROW_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
BATCH_PATH = (F.fft_major_fwd_wire, F.fft_minor, F.ifft_minor_product,
              F.fft_major, K.local_max_block_reduce_packed)
SINGLE_PATH = (F.fft_major_fwd_wire2, F.fft_minor, F.ifft_minor_product,
               F.fft_major, K.local_max_block_reduce_packed)
XLA_PATH = (K.local_max_block_reduce,)
JNP_PATH = (F.fft_major_forward, F.fft_minor, F.ifft_minor_product,
            F.fft_major)
ROUND_TRIP_PATH = (F.fft_major_forward, F.fft_minor, F.ifft_minor,
                   F.fft_major)
ALL_KERNELS = F.KERNELS + K.KERNELS


def make_bench_inputs(n_queries=N_QUERIES, episode_secs=EPISODE_SECS):
    """Seed-42 snippets, plant offsets and episode, built in the order the
    JAX package's bench.py builds them (make_bench_inputs, make_audio)
    for BENCH_QUERIES=n_queries BENCH_EPISODE_SECS=episode_secs."""
    rng = np.random.default_rng(42)
    snippets = [
        np.clip(
            rng.standard_normal(int((SNIPPET_SECS + 0.5 * (q % 8)) * SR))
            * 0.15, -0.45, 0.45,
        ).astype(np.float32)
        for q in range(n_queries)
    ]
    offsets = [o for o in (21.0, episode_secs * 0.55)
               if (o + SNIPPET_SECS + 0.5) < episode_secs] or [0.0]
    episode = (rng.standard_normal(int(episode_secs * SR)) * 0.05).astype(
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


def cuda_ms(fn, reps=7):
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up,
    with the card idle before it. Each timed call is queued behind an
    untimed one, so that the host's part of a wrapper (checks, allocation,
    launch) overlaps the card's work and the events read the card's time of
    one call."""
    torch.cuda.synchronize()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_planes(name, got, want, rows=None):
    """Largest |kernel - plain| of a pair of planes, against TOL_FFT;
    recorded in ``rows`` when given, and returned."""
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    ref = max(w.abs().max().item() for w in want)
    rel = err / ref
    print(f"{name}: max |kernel - plain| = {err:.3e} "
          f"({rel:.3e} of max |plain| {ref:.3e}; tol {TOL_FFT:g})")
    if not rel <= TOL_FFT:
        raise AssertionError(f"{name} disagrees with its plain version")
    if rows is not None:
        rows[name]["max_abs_err"] = err
    return err


def fft_flops(rows, L):
    """FP32 operations of a radix-2 transform of length L on ``rows`` rows:
    L/2 butterflies per stage, log2 L stages, 10 operations each."""
    return rows * (L // 2) * (L.bit_length() - 1) * 10


def bound(n_bytes, flops):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the FP32 rate, in ms, and which."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(log):
    """One line per kernel of nvcc's ``-Xptxas -v`` output: registers,
    stack and spill bytes. Fails if an FFT pass or the block reduction
    spills."""
    fn, seen = None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            seen[fn] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            seen[fn].update(stack=int(m[1]), spill=int(m[2]) + int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            seen[fn]["registers"] = int(m[1])
    if not seen:
        print("  no ptxas report: the library was built before this run")
    for fn, info in seen.items():
        m = re.search(r"\d((?:major|minor)_pass|twiddle_table|block_reduce)"
                      r"(I\w*?EE)?", fn)
        print(f"  {m[1] + (m[2] or '') if m else fn[:56]}: "
              f"{info.get('registers')} registers, {info.get('stack')} B "
              f"stack, {info.get('spill')} B spilled")
    spills = [fn for fn, info in seen.items()
              if re.search(r"major_pass|minor_pass|block_reduce", fn)
              and info.get("spill", 0)]
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")


def timed(name, kernel, plain, row=None, work=None, library=None):
    """CUDA-event times of a kernel call, its plain version and, where one
    torch call computes the same transform, of that call; ``work`` is the
    (bytes, FP32 operations) of the kernel call, giving its bound.
    Recorded in ``row`` when given."""
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
    lib_ms = cuda_ms(library) if library is not None else None
    b_ms, b_by = bound(*work) if work is not None else (None, None)
    if row is not None:
        row.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib_ms)
    extra = f", bound {b_ms:.3f} ms ({b_by})" if work is not None else ""
    if library is not None:
        extra += f", torch.fft {lib_ms:.3f} ms"
    name_of = row["name"] if row is not None else None
    before = RADIX2_CHAIN_MS.get(name_of)
    if before is not None:
        extra += (f"; radix-2 chain {before:.3f} ms, {before / ms:.2f}x "
                  f"faster now")
    before = BEFORE_REDESIGN_MS.get(name_of)
    if before is not None:
        extra += (f"; before redesign (28b7f84) {before:.3f} ms, "
                  f"{before / ms:.2f}x faster now")
    print(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{extra}")


def read_once(label, planes, block, kernel_ms):
    """The yardstick of a plain streaming read: one ``torch.amax`` over
    each of the planes viewed as [rows, nb, block], timed."""
    views = [p.view(p.shape[0], -1, block) for p in planes]
    ms = cuda_ms(lambda: [v.amax(-1) for v in views])
    gb = sum(p.numel() for p in planes) * 4 / 1e9
    print(f"{label}: torch.amax over the same planes (read once) {ms:.3f} ms "
          f"({gb / ms:.1f} TB/s), the kernel {kernel_ms / ms:.2f}x of it")


def check_kernels(scanner, episode_wire, rows):
    """The five kernel entry points of the multi-query path against their
    plain versions at the config #3 slab shapes, on the first slab of one
    staged episode."""
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

    B = win.shape[0]
    X = F.fft_major_fwd_wire(win, A, n, W)
    compare_planes("fft_major_fwd_wire", X,
                   F.fft_major_fwd_wire_plain(win, A, n, W), rows)
    timed("fft_major_fwd_wire",
          lambda: F.fft_major_fwd_wire(win, A, n, W, out=X),
          lambda: F.fft_major_fwd_wire_plain(win, A, n, W),
          rows["fft_major_fwd_wire"],
          (B * min(W, n) * win.element_size() + 8 * B * n,
           fft_flops(B * M, A) + 6 * B * n))

    Y = F.fft_minor(X[0], X[1], M)
    compare_planes("fft_minor", Y, F.fft_minor_plain(X[0], X[1], M), rows)
    Xc = torch.complex(X[0], X[1])
    timed("fft_minor", lambda: F.fft_minor(X[0], X[1], M, out=Y),
          lambda: F.fft_minor_plain(X[0], X[1], M), rows["fft_minor"],
          (16 * B * n, fft_flops(B * A, M)),
          lambda: torch.fft.fft(Xc, dim=-1))
    del X, Xc

    V = F.ifft_minor_product(Y[0], Y[1], tr, ti, M)
    Vp = F.ifft_minor_product_plain(Y[0], Y[1], tr, ti, M)
    compare_planes("ifft_minor_product", V, Vp, rows)
    timed("ifft_minor_product",
          lambda: F.ifft_minor_product(Y[0], Y[1], tr, ti, M, out=V),
          lambda: F.ifft_minor_product_plain(Y[0], Y[1], tr, ti, M, out=Vp),
          rows["ifft_minor_product"],
          (8 * B * n + 8 * Qh * n + 8 * B * Qh * n,
           B * Qh * (fft_flops(A, M) + 6 * n)))
    del Vp, Y

    width = F.round_planes_width(
        min(peaks_crop_width(scanner.valid, scanner.config.block, "pallas"),
            n), n)
    a_crop = width // M
    P = V[0].shape[0]
    Z = F.fft_major(V[0], V[1], A, n, a_crop)
    Zp = F.fft_major_plain(V[0], V[1], A, n, a_crop)
    compare_planes("fft_major", Z, Zp, rows)
    del Zp
    Vc = torch.complex(V[0], V[1])
    timed("fft_major",
          lambda: F.fft_major(V[0], V[1], A, n, a_crop, out=Z),
          lambda: F.fft_major_plain(V[0], V[1], A, n, a_crop),
          rows["fft_major"],
          (8 * P * n + 8 * P * width, fft_flops(P * M, A) + 6 * P * n),
          lambda: torch.fft.ifft(Vc, dim=1, norm="forward"))
    del V, Vc

    zr, zi = Z[0].view(P, width), Z[1].view(P, width)
    Q = st.inv_ac.shape[0]
    scale = torch.nn.functional.pad(st.inv_ac, (0, 2 * Qh - Q)).repeat(SLAB)
    starts = torch.arange(SLAB, device=zr.device) * scanner.chunk
    win_len = (int(ns[0]) - starts).clamp(0, W)
    m_pad = torch.nn.functional.pad(st.m, (0, 2 * Qh - Q), value=1)
    valid = (win_len[:, None] - m_pad[None, :] + 1).clamp(min=0).reshape(-1)
    check_reduce_packed(zr, zi, scale, valid, rows)
    del Z, zr, zi


def check_reduce_packed(zr, zi, scale, valid, rows=None, label=""):
    """Kernel 5 against its plain version on pair-packed planes: exactly
    equal; timed, and recorded in ``rows`` when given."""
    name = "local_max_block_reduce_packed"
    got = K.local_max_block_reduce_packed(zr, zi, scale, valid, 512)
    want = K.local_max_block_reduce_packed_plain(zr, zi, scale, valid, 512)
    same = [torch.equal(g, w) for g, w in zip(got, want)]
    print(f"{name}{label}: outputs {tuple(got[0].shape)}, exactly equal to "
          f"the plain version: {same}")
    if not all(same):
        raise AssertionError("the block reduction disagrees")
    P, V = zr.shape
    nb = got[0].shape[1]
    if rows is not None:
        rows[name]["max_abs_err"] = 0.0
    row = rows[name] if rows is not None else {"name": None}
    timed(name + label,
          lambda: K.local_max_block_reduce_packed(zr, zi, scale, valid, 512),
          lambda: K.local_max_block_reduce_packed_plain(
              zr, zi, scale, valid, 512),
          row, (8 * P * V + 16 * P + 32 * P * nb, 2 * P * V))
    read_once(name + label, (zr, zi), 512, row["ms"])


def compare_raw(label, got, want):
    """Raw candidates (pos, h, prom) of the kernel path against the plain
    path: every one at the same position, heights and prominences within
    TOL_SCAN."""
    (pk, hk, rk), (pp, hp, rp) = (
        [a.cpu().numpy() for a in d] for d in (got, want))
    fin = np.isfinite(hp)
    if not np.array_equal(np.isfinite(hk), fin):
        raise AssertionError(f"{label}: the paths found different counts")
    moved = int((fin & (pk != pp)).sum())
    dh = float(np.abs(hk[fin] - hp[fin]).max()) if fin.any() else 0.0
    dprom = float(np.abs(rk[fin] - rp[fin]).max()) if fin.any() else 0.0
    print(f"{label}, kernel path vs plain path: {int(fin.sum())} raw "
          f"candidates, {moved} at another position, max |dh| = {dh:.3e}, "
          f"max |dprom| = {dprom:.3e} (tol {TOL_SCAN:g})")
    if moved or not max(dh, dprom) <= TOL_SCAN:
        raise AssertionError(f"{label}: kernel and plain paths disagree")


def compare_peaks(label, got, want):
    """Final peak lists per query: same positions, heights and
    prominences within TOL_SCAN."""
    for q, (g, w) in enumerate(zip(got, want)):
        if [p.position for p in g] != [p.position for p in w] or any(
            abs(a.height - b.height) > TOL_SCAN
            or abs(a.prominence - b.prominence) > TOL_SCAN
            for a, b in zip(g, w)
        ):
            raise AssertionError(f"{label}, query {q}: {g} against {w}")
    print(f"{label}: final peaks identical in position, within {TOL_SCAN:g} "
          f"in height and prominence: {sum(len(g) for g in got)} peaks")


def compare_paths(scanner, plain_scanner, episode_wire):
    """One episode on the kernel path and on the plain path: every raw
    candidate (64 queries x 32 windows x n_peaks) and the final peaks at
    the same positions, heights and prominences within TOL_SCAN."""
    staged = scanner.stage_resident([episode_wire])
    got = scanner.scan_dispatch(staged)
    want = plain_scanner.scan_dispatch(staged)
    compare_raw("one episode", got[0], want[0])
    compare_peaks("kernel path against plain path",
                  scanner.scan_collect(got)[0],
                  plain_scanner.scan_collect(want)[0])


def profile_run(label, run):
    """``run()`` under torch.profiler: device ms per kernel, and the share
    of its wall time in which no kernel or copy ran on the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    print(f"profile of {label}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share "
          f"{100 * (1 - busy_ms / (wall * 1e3)):.1f} %")
    if not spans:
        print("  no device events traced: per-kernel times not measured")
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1]):
        if ms >= 0.01 * busy_ms:  # a template's signature, cut to its head
            print(f"  {ms:9.2f} ms  {100 * ms / busy_ms:5.1f} %  "
                  f"{name[:NAME_CHARS]}")
    rest = sum(ms for ms in per_name.values() if ms < 0.01 * busy_ms)
    print(f"  {rest:9.2f} ms  {100 * rest / max(busy_ms, 1e-9):5.1f} %  "
          f"{sum(ms < 0.01 * busy_ms for ms in per_name.values())} other "
          f"kernels under 1 % each")


def counted(run, kernels):
    """``run()`` with every launch count set to 0 just before it; returns
    its result and the counts read just after it. Fails if a kernel of
    ``kernels`` (the path's) was never launched."""
    for k in ALL_KERNELS:
        k.launches = 0
    out = run()
    launches = {k.__name__: k.launches for k in ALL_KERNELS}
    missing = [k.__name__ for k in kernels if launches[k.__name__] <= 0]
    if missing:
        raise AssertionError(f"the run never launched {missing}")
    return out, launches


def batch_scan(config, device, rows):
    """Path 1, BASELINE config #3: kernels 1-5, one episode on both paths,
    the 4 x 1800 s x 64-query scan, its profile."""
    snippets, offsets, episode = make_bench_inputs()
    episode_wire = quantize_wire(episode, config.transfer_dtype)
    scanner = ShardedScanner(snippets, SR, config, device=device)
    plain_scanner = ShardedScanner(
        snippets, SR, config, device=device,
        query_state=scanner.query_state, plain=True)
    print(f"config #3: {N_EPISODES} x {EPISODE_SECS} s episodes, "
          f"{N_QUERIES} queries, {config.transfer_dtype}, slab {SLAB}, "
          f"fft_len {scanner.fft_len}, {scanner.n_peaks} peaks per window")
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
    t0 = time.perf_counter()
    results, launches = counted(lambda: scanner.scan_staged(staged),
                                BATCH_PATH)
    t_scan = time.perf_counter() - t0
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
    print(f"launches in the config #3 scan: {launches}")
    for k in BATCH_PATH:
        rows[k.__name__]["launches"] = launches[k.__name__]
    profile_run("one config #3 scan", lambda: scanner.scan_staged(staged))


def check_single_query_kernels(matcher, episode_wire, rows=None):
    """Kernel 6 at the matcher's slab and at an odd slab; kernels 2-5 at
    the single-query launch shapes (P = 4 planes, one query spectrum).
    ``rows``: record kernel 6's numbers (config #2); None at the other
    fft_len."""
    staged, n = matcher.stage(episode_wire)
    s_r, s_i = matcher._sample_f
    n_fft = matcher.fft_len
    A, M = F.split_factors(n_fft)
    W, chunk = matcher.window, matcher.chunk
    ep = pad_wire_on_device(staged, (SLAB + window_rows(W, chunk)) * chunk)
    win = windows_from_episode(ep, 0, SLAB, chunk, W)
    x0, x1 = win[0::2], win[1::2]
    P = x0.shape[0]
    tag = f" at fft_len 2^{n_fft.bit_length() - 1}"
    print(f"single-query slab: windows {tuple(win.shape)} {win.dtype} as "
          f"{P} pairs, n = {n_fft} (A = {A}, M = {M})")

    name = "fft_major_fwd_wire2"
    X = F.fft_major_fwd_wire2(x0, x1, A, n_fft, W)
    err = compare_planes(name + tag, X,
                         F.fft_major_fwd_wire2_plain(x0, x1, A, n_fft, W))
    if rows is not None:
        rows[name]["max_abs_err"] = err
    timed(name + tag,
          lambda: F.fft_major_fwd_wire2(x0, x1, A, n_fft, W, out=X),
          lambda: F.fft_major_fwd_wire2_plain(x0, x1, A, n_fft, W),
          rows[name] if rows is not None else None,
          (SLAB * min(W, n_fft) * win.element_size() + 8 * P * n_fft,
           fft_flops(P * M, A) + 6 * P * n_fft))
    odd = windows_from_episode(ep, 0, ODD_SLAB, chunk, W)
    compare_planes(
        f"{name}{tag}, odd slab {ODD_SLAB}",
        F.fft_major_fwd_wire2(odd[0::2], odd[1::2], A, n_fft, W),
        F.fft_major_fwd_wire2_plain(odd[0::2], odd[1::2], A, n_fft, W))

    label = f"{tag}, Qh = 1, P = {P}"
    Y = F.fft_minor(X[0], X[1], M)
    compare_planes(f"fft_minor{label}", Y, F.fft_minor_plain(X[0], X[1], M))
    timed(f"fft_minor{label}", lambda: F.fft_minor(X[0], X[1], M, out=Y),
          lambda: F.fft_minor_plain(X[0], X[1], M), None,
          (16 * P * n_fft, fft_flops(P * A, M)))
    tr, ti = s_r.view(1, A, M), s_i.view(1, A, M)
    V = F.ifft_minor_product(Y[0], Y[1], tr, ti, M)
    compare_planes(f"ifft_minor_product{label}", V,
                   F.ifft_minor_product_plain(Y[0], Y[1], tr, ti, M))
    timed(f"ifft_minor_product{label}",
          lambda: F.ifft_minor_product(Y[0], Y[1], tr, ti, M, out=V),
          lambda: F.ifft_minor_product_plain(Y[0], Y[1], tr, ti, M), None,
          (16 * P * n_fft + 8 * n_fft, P * (fft_flops(A, M) + 6 * n_fft)))
    width = correlation_crop(matcher.valid, matcher.config.block, n_fft,
                             "vpu", "pallas")
    a_crop = width // M
    Z = F.fft_major(V[0], V[1], A, n_fft, a_crop)
    compare_planes(f"fft_major{label}", Z,
                   F.fft_major_plain(V[0], V[1], A, n_fft, a_crop))
    timed(f"fft_major{label}",
          lambda: F.fft_major(V[0], V[1], A, n_fft, a_crop, out=Z),
          lambda: F.fft_major_plain(V[0], V[1], A, n_fft, a_crop), None,
          (8 * P * n_fft + 8 * P * width,
           fft_flops(P * M, A) + 6 * P * n_fft))
    del X, Y, V
    starts = torch.arange(2 * P, device=ep.device) * chunk
    valid = ((n - starts).clamp(0, W) - matcher.snippet.m + 1).clamp(min=0)
    scale = torch.full((2 * P,), matcher.snippet.inv_autocorr,
                       dtype=torch.float32, device=ep.device)
    check_reduce_packed(Z[0].view(P, width), Z[1].view(P, width), scale,
                        valid, label=label)


def compare_single_query_paths(matcher, plain_matcher, episode_wire,
                               label="one config #2 episode"):
    """One config #2 episode on the kernel path and on the plain path:
    every raw candidate at the same position, heights and prominences
    within TOL_SCAN, and the same final peaks."""
    staged = matcher.stage(episode_wire)
    n_pad = (staged[0].shape[0] - matcher.overlap) // matcher.chunk
    slab = scan_slab(matcher.config, matcher.chunk, staged[1], n_pad)
    got, want = (
        _match_episode_resident(
            staged[0], staged[1], m._sample_f,
            np.float32(m.snippet.inv_autocorr),
            **m._scan_kwargs(slab, n_pad // slab))
        for m in (matcher, plain_matcher))
    compare_raw(label, got, want)
    compare_peaks(label, [matcher.match_staged(staged)],
                  [plain_matcher.match_staged(staged)])


def timed_repeats(label, stage, scan, offsets, distance_secs,
                  path=SINGLE_PATH):
    """``REPEATS`` runs of stage then scan, each with the launch counts
    reset just before it; prints the p50 of stage, scan and end-to-end
    seconds, checks the plants every time, returns one run's counts
    (``path``: the kernels each run must launch)."""
    stage_s, scan_s, counts = [], [], []
    for r in range(REPEATS + 1):  # the first run warms up, untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = stage()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        peaks, launches = counted(lambda: scan(staged), path)
        t2 = time.perf_counter()
        check_plants([peaks], offsets, distance_secs)
        if r:
            stage_s.append(t1 - t0)
            scan_s.append(t2 - t1)
            counts.append(launches)
    if any(c != counts[0] for c in counts):
        raise AssertionError(f"{label}: launch counts differ: {counts}")
    e2e = [a + b for a, b in zip(stage_s, scan_s)]
    print(f"{label}: p50 of {REPEATS} runs: stage "
          f"{statistics.median(stage_s):.4f} s, scan "
          f"{statistics.median(scan_s):.4f} s, end to end "
          f"{statistics.median(e2e):.4f} s (e2e min {min(e2e):.4f}, max "
          f"{max(e2e):.4f}); plants found within {PLANT_TOL} sample; "
          f"launches per run {counts[0]}")
    return counts[0]


def single_query(config, device, rows):
    """Path 2, config #2 through ``SnippetMatcher`` and through
    ``ShardedScanner`` at Q = 1."""
    snippets, offsets, episode = make_bench_inputs(1, SINGLE_EPISODE_SECS)
    snippet = snippets[0]
    episode_wire = quantize_wire(episode, config.transfer_dtype)
    matcher = SnippetMatcher(snippet, SR, config, device=device)
    plain_matcher = SnippetMatcher(snippet, SR, config, device=device,
                                   plain=True)
    print(f"config #2: 1 x {SINGLE_EPISODE_SECS} s episode, one "
          f"{len(snippet) / SR:g} s snippet, {config.transfer_dtype}, "
          f"fft_len {matcher.fft_len}, path {matcher.fft_impl}, plants at "
          f"{offsets} s")
    check_single_query_kernels(matcher, episode_wire, rows)
    torch.cuda.empty_cache()
    compare_single_query_paths(matcher, plain_matcher, episode_wire)
    torch.cuda.empty_cache()

    launches = timed_repeats(
        "config #2, SnippetMatcher.stage + match_staged",
        lambda: matcher.stage(episode_wire), matcher.match_staged,
        offsets, config.distance_secs)
    rows["fft_major_fwd_wire2"]["launches"] = launches["fft_major_fwd_wire2"]
    scanner = ShardedScanner([snippet], SR, config, device=device)
    timed_repeats(
        "config #2, ShardedScanner([snippet]).stage_resident + scan_staged",
        lambda: scanner.stage_resident([episode_wire]),
        lambda staged: scanner.scan_staged(staged)[0][0],
        offsets, config.distance_secs)
    staged = matcher.stage(episode_wire)
    profile_run("one config #2 scan (SnippetMatcher.match_staged)",
                lambda: matcher.match_staged(staged))


def xla_packed_scan(config, device, rows):
    """Path 3: ``fft_impl="xla_packed"`` (torch.fft correlation) with the
    dense block reduction, kernel 7."""
    snippets, offsets, episode = make_bench_inputs(XLA_QUERIES, EPISODE_SECS)
    cfg = dataclasses.replace(config, fft_impl="xla_packed")
    episode_wire = quantize_wire(episode, cfg.transfer_dtype)
    scanner = ShardedScanner(snippets, SR, cfg, device=device)
    print(f"xla_packed scan: 1 x {EPISODE_SECS} s episode, {XLA_QUERIES} "
          f"queries, {cfg.transfer_dtype}, fft_len {scanner.fft_len}")

    # kernel 7 at the scan's slab shape: the first slab's correlation
    st = scanner.query_state
    staged, ns, _ = scanner.stage_resident([episode_wire])
    W, chunk = scanner.window, scanner.chunk
    ep = dequant_to_f32(pad_wire_on_device(
        staged[0], (SLAB + window_rows(W, chunk)) * chunk))
    win = windows_from_episode(ep, 0, SLAB, chunk, W)
    crop = correlation_crop(scanner.valid, cfg.block, scanner.fft_len,
                            "xla_packed", "pallas")
    Q = st.inv_ac.shape[0]
    c = corr_slab_xla_packed(win, torch.complex(st.t_r, st.t_i), crop)[:, :Q]
    x = (c * st.inv_ac[None, :, None]).reshape(SLAB * Q, crop)
    del c
    starts = torch.arange(SLAB, device=x.device) * chunk
    win_len = (int(ns[0]) - starts).clamp(0, W)
    valid = (win_len[:, None] - st.m[None, :] + 1).clamp(min=0).reshape(-1)
    block = min(cfg.block, 512)
    got = K.local_max_block_reduce(x, valid, block)
    want = K.local_max_block_reduce_plain(x, valid, block)
    same = [torch.equal(g, w) for g, w in zip(got, want)]
    print(f"local_max_block_reduce: rows {tuple(x.shape)}, outputs "
          f"{tuple(got[0].shape)}, exactly equal to the plain version: "
          f"{same}")
    if not all(same):
        raise AssertionError("the dense block reduction disagrees")
    row = rows["local_max_block_reduce"]
    row["max_abs_err"] = 0.0
    nb = got[0].shape[1]
    timed("local_max_block_reduce",
          lambda: K.local_max_block_reduce(x, valid, block),
          lambda: K.local_max_block_reduce_plain(x, valid, block), row,
          (4 * x.numel() + 4 * x.shape[0] + 16 * x.shape[0] * nb, 0))
    read_once("local_max_block_reduce", (x,), block, row["ms"])
    del x, got, want
    torch.cuda.empty_cache()

    scanner.scan_resident([episode_wire])  # warm: cuFFT plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, launches = counted(
        lambda: scanner.scan_resident([episode_wire]), XLA_PATH)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    check_plants([results[0][0]], offsets, cfg.distance_secs)
    print(f"xla_packed scan: stage + scan {t_run:.3f} s; plants of query 0 "
          f"found within {PLANT_TOL} sample; launches {launches}")
    row["launches"] = launches["local_max_block_reduce"]


def fft_modes(config, device, rows):
    """Path 4, ``fft2_scrambled`` on f32 planes at n = 2^22: the forward
    major pass of complex planes and the inverse minor pass against their
    plain versions and ``torch.fft`` on the config #3 slab's 8 windows
    dequantized to f32; the round trip through both, which must give n
    times its input, is the path whose launches are read."""
    snippets, _, episode = make_bench_inputs()
    scanner = ShardedScanner(snippets, SR, config, device=device)
    staged, _, _ = scanner.stage_resident(
        [quantize_wire(episode, config.transfer_dtype)])
    W, chunk, n = scanner.window, scanner.chunk, scanner.fft_len
    A, M = F.split_factors(n)
    ep = dequant_to_f32(pad_wire_on_device(
        staged[0], (SLAB + window_rows(W, chunk)) * chunk))
    xr = torch.nn.functional.pad(
        windows_from_episode(ep, 0, SLAB, chunk, W), (0, n - W))
    xi = torch.zeros_like(xr)
    del staged, ep
    B = SLAB
    print(f"fft2_scrambled: {B} f32 windows of {W} samples, n = {n} "
          f"(A = {A}, M = {M})")
    planes = (xr.view(B, A, M), xi.view(B, A, M))
    X = F.fft_major_forward(*planes, A, n)
    compare_planes("fft_major_forward", X,
                   F.fft_major_forward_plain(*planes, A, n), rows)
    xc = torch.complex(*planes)
    timed("fft_major_forward",
          lambda: F.fft_major_forward(*planes, A, n, out=X),
          lambda: F.fft_major_forward_plain(*planes, A, n),
          rows["fft_major_forward"],
          (16 * B * n, fft_flops(B * M, A) + 6 * B * n),
          lambda: torch.fft.fft(xc, dim=1))
    Y = F.fft_minor(X[0], X[1], M)
    del X, xc
    Z = F.ifft_minor(Y[0], Y[1], M)
    compare_planes("ifft_minor", Z, F.ifft_minor_plain(Y[0], Y[1], M), rows)
    yc = torch.complex(Y[0], Y[1])
    timed("ifft_minor", lambda: F.ifft_minor(Y[0], Y[1], M, out=Z),
          lambda: F.ifft_minor_plain(Y[0], Y[1], M), rows["ifft_minor"],
          (16 * B * n, fft_flops(B * A, M)),
          lambda: torch.fft.ifft(yc, dim=-1, norm="forward"))
    del Y, Z, yc

    work_f, work_i = {}, {}

    def round_trip():
        S = F.fft2_scrambled(xr, xi, n, work=work_f)
        return F.fft2_scrambled(S[0], S[1], n, inverse=True, work=work_i)

    back, launches = counted(round_trip, ROUND_TRIP_PATH)
    err = max((back[0] - n * xr).abs().max().item(),
              (back[1] - n * xi).abs().max().item())
    rel = err / (n * xr.abs().max().item())
    print(f"fft2_scrambled round trip: max |back - n·x| = {err:.3e} "
          f"({rel:.3e} of n·max|x|; tol {TOL_FFT:g}); launches {launches}; "
          f"{cuda_ms(round_trip):.3f} ms")
    if not rel <= TOL_FFT:
        raise AssertionError("the fft2_scrambled round trip disagrees")
    rows["ifft_minor"]["launches"] = launches["ifft_minor"]


def jnp_scan(config, device, rows):
    """Path 5, ``fft_impl="vpu"`` + ``peaks_impl="jnp"`` through
    ``ShardedScanner`` on 1 x 1800 s x 64 queries: f32 windows through the
    four FFT passes, the [B, Q, V] volume, the multi-pass picker."""
    snippets, offsets, episode = make_bench_inputs(JNP_QUERIES, EPISODE_SECS)
    cfg = dataclasses.replace(config, peaks_impl="jnp")
    episode_wire = quantize_wire(episode, cfg.transfer_dtype)
    scanner = ShardedScanner(snippets, SR, cfg, device=device)
    plain = ShardedScanner(snippets, SR, cfg, device=device,
                           query_state=scanner.query_state, plain=True)
    print(f"vpu + jnp scan: 1 x {EPISODE_SECS} s episode, {JNP_QUERIES} "
          f"queries, {cfg.transfer_dtype}, fft_len {scanner.fft_len}")
    staged = scanner.stage_resident([episode_wire])
    scanner.scan_dispatch(staged)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got, launches = counted(lambda: scanner.scan_dispatch(staged), JNP_PATH)
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"vpu + jnp scan: {t_scan:.3f} s, torch.cuda.max_memory_allocated "
          f"{peak_gb:.2f} GB; launches {launches}")
    if launches["local_max_block_reduce_packed"] or launches[
            "local_max_block_reduce"]:
        raise AssertionError("the jnp path launched a block reduction")
    rows["fft_major_forward"]["launches"] = launches["fft_major_forward"]
    compare_raw("vpu + jnp, one episode", got[0],
                plain.scan_dispatch(staged)[0])
    peaks = scanner.scan_collect(got)[0]
    check_plants([peaks[0]], offsets, cfg.distance_secs)
    fused = ShardedScanner(snippets, SR, config, device=device,
                           query_state=scanner.query_state)
    compare_peaks("vpu + jnp against the fused vpu + pallas scanner", peaks,
                  fused.scan_staged(staged)[0])
    profile_run("one vpu + jnp scan", lambda: scanner.scan_dispatch(staged))


def single_query_jnp(config, device, rows):
    """Path 6, config #2 through ``SnippetMatcher(fft_impl="vpu",
    peaks_impl="jnp")``, then ``match(device="cuda")`` with ``"xla"`` +
    ``"jnp"`` (the JAX package's defaults), ``"xla"`` + ``"pallas"`` and
    ``"mxu"`` + ``"jnp"``, each against the fused path's peaks."""
    snippets, offsets, episode = make_bench_inputs(1, SINGLE_EPISODE_SECS)
    snippet = snippets[0]
    episode_wire = quantize_wire(episode, config.transfer_dtype)
    cfg = dataclasses.replace(config, peaks_impl="jnp")
    matcher = SnippetMatcher(snippet, SR, cfg, device=device)
    plain = SnippetMatcher(snippet, SR, cfg, device=device, plain=True)
    compare_single_query_paths(matcher, plain, episode_wire,
                               "config #2, vpu + jnp")
    timed_repeats("config #2, vpu + jnp, SnippetMatcher.stage + match_staged",
                  lambda: matcher.stage(episode_wire), matcher.match_staged,
                  offsets, config.distance_secs, JNP_PATH)
    ref = SnippetMatcher(snippet, SR, config, device=device).match(
        episode_wire)
    for fft_impl, peaks_impl, path in (
        ("xla", "jnp", ()), ("xla", "pallas", XLA_PATH), ("mxu", "jnp", ()),
    ):
        kw = dict(dataclasses.asdict(config), fft_impl=fft_impl,
                  peaks_impl=peaks_impl)
        match(snippet, episode_wire, SR, device="cuda", **kw)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        peaks, launches = counted(
            lambda: match(snippet, episode_wire, SR, device="cuda", **kw),
            path)
        t_run = time.perf_counter() - t0
        check_plants([peaks], offsets, config.distance_secs)
        label = f"config #2, match(fft_impl={fft_impl!r}, " \
                f"peaks_impl={peaks_impl!r})"
        compare_peaks(label + " against vpu + pallas", [peaks], [ref])
        print(f"{label}: {t_run:.3f} s end to end; kernel launches "
              f"{ {k: v for k, v in launches.items() if v} }")


def large_fft(config, device, rows):
    """Path 7, fft_len 2^23 and 2^24: config #2's episode through the
    fused ``SnippetMatcher`` at 120 s and 240 s chunks; kernels 6, 2-5 on
    one slab against plain, and the plants in timed runs."""
    snippets, offsets, episode = make_bench_inputs(1, SINGLE_EPISODE_SECS)
    episode_wire = quantize_wire(episode, config.transfer_dtype)
    for chunk_secs in LARGE_CHUNKS:
        cfg = dataclasses.replace(config, chunk_secs=chunk_secs)
        matcher = SnippetMatcher(snippets[0], SR, cfg, device=device)
        print(f"chunk {chunk_secs:g} s: fft_len {matcher.fft_len}, "
              f"path {matcher.fft_impl}")
        check_single_query_kernels(matcher, episode_wire)
        torch.cuda.empty_cache()
        timed_repeats(
            f"fft_len {matcher.fft_len}, SnippetMatcher.stage + match_staged",
            lambda: matcher.stage(episode_wire), matcher.match_staged,
            offsets, config.distance_secs)
        torch.cuda.empty_cache()


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

    t_start = time.perf_counter()
    _build.load()
    print(f"kernel build + load: {time.perf_counter() - t_start:.2f} s "
          f"(nvcc {_build.build_seconds():.2f} s)")
    ptxas_report(_build.build_log())

    config = MatchConfig(slab=SLAB, slab_auto=True, transfer_dtype="mulaw8")
    dev = torch.device("cuda", 0)
    rows = {name: {"name": name, "route": "cuda", "source": src,
                   "replaces": tpu}
            for name, (src, tpu) in KERNEL_ROWS.items()}
    for phase in (batch_scan, single_query, xla_packed_scan, fft_modes,
                  jnp_scan, single_query_jnp, large_fft):
        t0 = time.perf_counter()
        phase(config, dev, rows)
        torch.cuda.empty_cache()
        print(f"[{phase.__name__}: {time.perf_counter() - t0:.1f} s]")
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")
    for row in rows.values():
        missing = [k for k in ROW_KEYS if k not in row]
        if missing or not row["launches"] > 0:
            raise AssertionError(f"kernel row {row['name']}: missing "
                                 f"{missing}, launches {row.get('launches')}")
    print(smi)
    print(json.dumps({"kernels": [
        {k: row[k] for k in ROW_KEYS} for row in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
