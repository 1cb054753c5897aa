#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``audio_matcher_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

It drives the port's paths, each through the entry points a user calls
(the library, and the matcher and sweep CLIs over files on disk), and
holds every kernel against its plain PyTorch version:

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
8. The archive sweep (config #5's path on one card), through
   ``sweep_cli.run`` with --resample, --progress-file and the int16 wire:
   24 mono wav episodes of 600 s at 44.1 kHz (config #3's literal episode
   length and query count, cut to three groups of 8), one at 22.05 kHz
   and a file of random bytes, against 4 snippets of 10-11.5 s, each
   planted twice in every episode from seed 42. Every plant must be in
   the label files within 1 sample, 25 files Done and the random one
   skipped, and kernels 1-5 launched once a slab of each of the 25
   staged rows (a group stages only its decoded rows). The first group's raw candidates against the plain path; a
   resume from a progress file holding the first group, which must
   rewrite the other files' labels byte for byte; files/s and pair
   audio-hours/s end to end; one group's wav decode and the resample on
   one host thread; the staging rate of one group into a fresh pinned
   buffer and of a group of mixed durations; torch.profiler traces of one
   group's
   scan and of one group from decode to collect.
9. Config #2 through the matcher CLI: ``matcher_cli.run`` on the
   3600 s episode and the 10 s snippet as wav files, mulaw8; the label
   file must hold both plants, and kernels 6, 2, 3, 4 and 5 must each
   have been launched once a slab of the 3600 s episode. Then
   ``--mode spectrogram`` on the same files: both plants within one hop,
   no kernel launched.
10. Spectrogram mode (BASELINE config #4; torch ops, no hand-written
   kernel on its path, so every launch count must stay 0): the batch scan
   at the JAX bench's spectrogram shape (4 x 1800 s x 8 queries of
   10-13.5 s, int16 wire, n_fft 1024, hop 256, 64 mels, distance 480 s,
   min_score 0.4; the bench's plants, seed 42, under added noise) through
   ``ShardedSpectrogramScanner``: every plant within one hop, the first
   episode's [Q, V] scores within TOL_SPEC of the port's CPU path on the
   same staged row, stage and scan times, pair audio-hours/s and a
   profile. Then ``SpectrogramMatcher`` on config #2's pair, p50 of 5.
11. The device resampler: 600 s of 22.05 kHz and of 48 kHz noise to
   44.1 kHz through ``hostio.decode.resample(impl="device")``, within
   TOL_RESAMPLE of scipy's float64 ``resample_poly`` (the int16 wire
   within 1), timed from the host and device-resident beside scipy. The
   archive sweep (8) resolves ``--resample`` to it (its log says so) and
   prints its share of a group; then ``sweep_cli.run --mode spectrogram
   --resample --progress-file`` over the archive's first 8 files and its
   22.05 kHz file: every plant of the 44.1 kHz files within one hop in the
   labels, the 22.05 kHz file's peaks equal to the CPU path's, a resume
   byte for byte.
12. Several devices and several processes, on the one card (one mesh of
   it twice, ``Mesh.of(["cuda:0", "cuda:0"])``): config #3 at full width
   (the bench shape of 2) sharded over that mesh, whose peaks must equal
   the one-device scan's exactly, with kernels 1-5 launched 16 times each
   (4 episodes x 4 slabs, however the rows shard), stage and scan seconds
   beside the one-device ones; a Q = 1 sharded scan of two copies of
   config #2's episode, equal to the one-device scan, kernel 6 launched.
   The archive sweep (8) again by two ``audio-sweep-torch`` processes of
   one cluster (``AM_COORDINATOR`` on loopback, ``AM_NUM_PROCESSES=2``,
   each with its own progress file) over the same 25 files: exit code 0
   for both, the one-process sweep's label files byte for byte, each file
   Done in exactly one store, both workers' wall times. Then the port's
   dry run (``parallel.dryrun``) on that mesh: the resident scan
   (``xla_packed`` + kernel 7), the windows path and the spectrogram
   scanner, every plant found.
13. The workflow's three tools in turn (``worker_archive``): config #2's
   3600 s episode from seed 42 with the snippet planted five times, 600 s
   apart, through ``matcher_cli.run`` on the card (mulaw8): four
   "Segment #k" labels, each within 1 sample of its plants, kernels 6 and
   2-5 launched once a slab. Then ``audio-worker-torch``
   (``worker_cli.main``, its answers on stdin) against the port's
   ``FakeAudacity`` with an index folder of one two-chapter series: the
   labels renamed, merged into two chapters, the "exported" chapter files
   (mp3 stubs: a frame header and a zero payload) tagged and moved into
   the archive, ``.done.txt`` Done, a second run skipping the file. Then
   ``archive-scroller-torch`` (``archive_cli.main``) and a scripted REPL
   (``list -c``, ``exit``) over the archive: the series and both
   chapters listed. The seconds of each tool are printed.

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

import contextlib
import dataclasses
import io
import json
import logging
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
    "CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from audio_matcher_tpu_torch import _build, match  # noqa: E402
from audio_matcher_tpu_torch.archive.repl import Holder  # noqa: E402
from audio_matcher_tpu_torch.cli import (  # noqa: E402
    archive_cli,
    matcher_cli,
    sweep_cli,
    worker_cli,
)
from audio_matcher_tpu_torch.hostio.decode import (  # noqa: E402
    read_audio,
    read_audio_int16,
    resample,
)
from audio_matcher_tpu_torch.hostio.labels import read_labels  # noqa: E402
from audio_matcher_tpu_torch.meta import tagger  # noqa: E402
from audio_matcher_tpu_torch.meta.progress import Progress, State  # noqa: E402
from audio_matcher_tpu_torch.models.spectrogram import (  # noqa: E402
    SpectrogramConfig,
    SpectrogramMatcher,
)
from audio_matcher_tpu_torch.models.matcher import (  # noqa: E402
    MatchConfig,
    SnippetMatcher,
    _match_episode_resident,
    correlation_crop,
    effective_slab,
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
from audio_matcher_tpu_torch.ops.resample import (  # noqa: E402
    resample_poly_device,
)
from audio_matcher_tpu_torch.ops.wire import dequant_to_f32  # noqa: E402
from audio_matcher_tpu_torch.parallel.dryrun import (  # noqa: E402
    dryrun_multichip,
)
from audio_matcher_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from audio_matcher_tpu_torch.parallel.sweep import (  # noqa: E402
    ShardedScanner,
    ShardedSpectrogramScanner,
    sweep_archive,
)
from audio_matcher_tpu_torch.worker.fake_audacity import (  # noqa: E402
    FakeAudacity,
)

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
# The archive sweep: config #3's episode length and query count (the
# literal 64 x 10 min x 4 shape), cut to 24 files, three groups of 8.
SWEEP_EPISODES = 24
SWEEP_EPISODE_SECS = 600
SWEEP_QUERIES = 4
SWEEP_GROUP = 8  # sweep_archive's default group size
SWEEP_SLOW_SR = 22050  # one more episode, resampled by the sweep
CARD = {"line": ""}  # nvidia-smi's name and power limit, set by main()
# Config #4, the JAX bench's spectrogram shape (BENCH_MODE=spectrogram):
# 4 x 1800 s x 8 queries of 10-13.5 s, int16 wire, n_fft 1024, hop 256,
# 64 mels, distance 480 s, min_score 0.4.
SPEC_QUERIES = 8
SPEC_NOISE = 0.05  # noise added over each episode, plants included
TOL_SPEC = 2e-4  # the JAX package's NCC tolerance (tests/test_spectrogram.py)
TOL_RESAMPLE = 2e-6  # against scipy's float64 resample_poly (tests/test_resample.py)
RESAMPLE_SECS = 600
WORKER_TIMEOUT = 600  # seconds for each process of the two-process sweep
WORKFLOW_PLANTS = (21.0, 621.0, 1221.0, 1821.0, 2421.0)  # s, > 480 s apart
# the worker's answers (tests/test_worker.py): ready, labels 1-2 "Serie 1",
# labels 3-4 "Serie 2", ready for the next step, exported
WORKFLOW_ANSWERS = ["", "Serie 1", "Serie 1", "Serie 2", "Serie 2", "", ""]
WORKFLOW_CHAPTERS = ("Kapitel Eins", "Kapitel Zwei")
MP3_STUB = b"\xff\xfb\x90\x00" + bytes(413)  # frame header, zero payload

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


def make_bench_inputs(n_queries=N_QUERIES, episode_secs=EPISODE_SECS,
                      offsets=None):
    """Seed-42 snippets, plant offsets and episode, built in the order the
    JAX package's bench.py builds them (make_bench_inputs, make_audio)
    for BENCH_QUERIES=n_queries BENCH_EPISODE_SECS=episode_secs; the
    snippet is planted at ``offsets`` (seconds) where given instead."""
    rng = np.random.default_rng(42)
    snippets = [
        np.clip(
            rng.standard_normal(int((SNIPPET_SECS + 0.5 * (q % 8)) * SR))
            * 0.15, -0.45, 0.45,
        ).astype(np.float32)
        for q in range(n_queries)
    ]
    if offsets is None:
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


def check_frame_plants(label, peaks, offsets, hop):
    """Every episode finds query 0's plants within one hop (the
    spectrogram mode is frame-accurate)."""
    want = sorted(int(o * SR) for o in offsets)
    for e, ep_peaks in enumerate(peaks):
        got = sorted(p.position for p in ep_peaks if p.height > 0.5)
        if len(got) != len(want) or any(
                abs(a - b) > hop for a, b in zip(got, want)):
            raise AssertionError(
                f"{label}, episode {e}: plants at {want}, found {got}")


def spectrogram_batch(config, device, rows):
    """Config #4, the batch scan at the JAX bench's spectrogram shape: 4 x
    1800 s x 8 queries, int16 wire, each episode the bench's (query 0
    planted at 21 s and 990 s) under its own noise. Every plant within one
    hop; the first episode's [Q, V] scores on the card within TOL_SPEC of
    the port's CPU path on the same staged row; no kernel launched (torch
    ops); stage and scan times, pair-h/s, a profile."""
    del config, rows  # no kernel row: this path runs torch ops
    snippets, offsets, base = make_bench_inputs(SPEC_QUERIES, EPISODE_SECS)
    rng = np.random.default_rng(4)
    episodes = [quantize_wire(base + rng.standard_normal(
        len(base), dtype=np.float32) * np.float32(SPEC_NOISE), "int16")
        for _ in range(N_EPISODES)]
    del base
    cfg = SpectrogramConfig(transfer_dtype="int16")
    scanner = ShardedSpectrogramScanner(snippets, SR, cfg, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = scanner.stage_resident(episodes)
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    staged_mb = staged[0].numel() * staged[0].element_size() / 1e6
    n_frames = 1 + (staged[0].shape[1] - cfg.n_fft) // cfg.hop
    print(f"config #4: {N_EPISODES} x {EPISODE_SECS} s episodes "
          f"({sum(len(e) for e in episodes) / 1e6:.1f} M samples), "
          f"{SPEC_QUERIES} queries of {min(scanner.t_ss)}-"
          f"{max(scanner.t_ss)} frames, int16, n_fft {cfg.n_fft}, hop "
          f"{cfg.hop}, {cfg.n_mels} mels; staged width {staged[0].shape[1]} "
          f"({n_frames} frames a row)")
    scanner.scan_staged(staged)  # warm: cuFFT plans, the query fingerprints
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results, launches = counted(lambda: scanner.scan_staged(staged), ())
    t_scan = time.perf_counter() - t0
    if any(launches.values()):
        raise AssertionError(f"the spectrogram scan launched {launches}")
    check_frame_plants("config #4", [r[0] for r in results], offsets,
                       cfg.hop)
    others = [p for r in results for q in r[1:] for p in q]
    pairs = N_EPISODES * SPEC_QUERIES
    hours = EPISODE_SECS / 3600.0 * pairs
    print(f"config #4 stage: {staged_mb:.1f} MB in {t_stage:.3f} s "
          f"({staged_mb / t_stage:.1f} MB/s); scan {t_scan:.3f} s for "
          f"{pairs} pairs; pair audio-hours/s: {hours / (t_stage + t_scan):.3f}"
          f" end to end, {hours / t_scan:.3f} device-resident; "
          f"torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {CARD['line']}")
    print(f"config #4: query 0's plants found within one hop ({cfg.hop} "
          f"samples) in all {N_EPISODES} episodes: "
          f"{[[(p.position, round(p.height, 4)) for p in r[0]] for r in results]}"
          f"; {len(others)} matches of the 7 unplanted queries; no kernel "
          f"launched")

    # the first episode's scores, card against the CPU path
    row = staged[0][0]
    got = scanner.scores(row).cpu()
    cpu = ShardedSpectrogramScanner(snippets, SR, cfg, device="cpu")
    t0 = time.perf_counter()
    want = cpu.scores(row.cpu())
    t_cpu = time.perf_counter() - t0
    err = max((got[q, : n_frames - t_s + 1] - want[q, : n_frames - t_s + 1])
              .abs().max().item() for q, t_s in enumerate(scanner.t_ss))
    print(f"config #4 scores of episode 0, [{got.shape[0]}, {got.shape[1]}]:"
          f" max |card - CPU path| = {err:.3e} (tol {TOL_SPEC:g}); the CPU "
          f"path took {t_cpu:.2f} s")
    if not err <= TOL_SPEC:
        raise AssertionError("config #4 scores disagree with the CPU path")
    profile_run("one config #4 scan", lambda: scanner.scan_staged(staged))
    print(CARD["line"])


def spectrogram_single(config, device, rows):
    """Config #4 on one pair: ``SpectrogramMatcher`` on the config #2
    episode (3600 s, plants at 21 s and 1980 s) and its 10 s snippet, p50
    of REPEATS warm runs from the host's f32 samples; the plants within
    one hop."""
    del config, rows
    snippets, offsets, episode = make_bench_inputs(1, SINGLE_EPISODE_SECS)
    matcher = SpectrogramMatcher(snippets[0], SR, device=device)
    matcher.match(episode)  # warm
    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        peaks, launches = counted(lambda: matcher.match(episode), ())
        times.append(time.perf_counter() - t0)
    if any(launches.values()):
        raise AssertionError(f"SpectrogramMatcher launched {launches}")
    check_frame_plants("config #4 single pair", [peaks], offsets,
                       matcher.config.hop)
    print(f"config #4 single pair (1 x {SINGLE_EPISODE_SECS} s x one "
          f"{SNIPPET_SECS:g} s snippet, SpectrogramMatcher.match from f32 "
          f"host samples: upload, log-mel, NCC, readback, peaks): p50 of "
          f"{REPEATS} {statistics.median(times):.4f} s (runs "
          f"{', '.join(f'{t:.4f}' for t in times)}); plants "
          f"{[(p.position, round(p.height, 4)) for p in peaks]} within one "
          f"hop; {CARD['line']}")


def device_resample(config, device, rows):
    """The polyphase resampler on the card: 600 s of 22.05 kHz and of
    48 kHz noise to 44.1 kHz through ``hostio.decode.resample(impl=
    "device")``, within TOL_RESAMPLE of scipy's float64 resample_poly and
    the int16 wire within 1; timed from the host (upload, matmul,
    readback; p50 of REPEATS) and device-resident (CUDA events), beside
    scipy on one host thread."""
    del config, rows
    import scipy.signal

    rng = np.random.default_rng(7)
    for sr_from in (SWEEP_SLOW_SR, 48000):
        x = rng.standard_normal(RESAMPLE_SECS * sr_from, dtype=np.float32
                                ) * np.float32(0.1)
        g = np.gcd(sr_from, SR)
        t0 = time.perf_counter()
        want = scipy.signal.resample_poly(
            x.astype(np.float64), SR // g, sr_from // g).astype(np.float32)
        t_scipy = time.perf_counter() - t0
        got = resample(x, sr_from, SR, impl="device", device=device)
        times = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, launches = counted(
                lambda: resample(x, sr_from, SR, impl="device",
                                 device=device), ())
            times.append(time.perf_counter() - t0)
        if any(launches.values()) or got.shape != want.shape:
            raise AssertionError(f"resample: {got.shape}, {launches}")
        err = float(np.abs(got - want).max())
        wire = resample(x, sr_from, SR, impl="device", wire_int16=True,
                        device=device)
        q = np.clip(np.round(want * 65535.0), -32768, 32767).astype(np.int32)
        werr = int(np.abs(wire.astype(np.int32) - q).max())
        xd = torch.from_numpy(x).to(device)
        ms = cuda_ms(lambda: resample_poly_device(xd, sr_from, SR,
                                                  device=device))
        print(f"resample {RESAMPLE_SECS} s {sr_from} -> {SR} Hz "
              f"({len(x)} -> {len(got)} samples): max |card - scipy| = "
              f"{err:.3e} (tol {TOL_RESAMPLE:g}), int16 wire within "
              f"{werr}; card from the host p50 "
              f"{statistics.median(times) * 1e3:.2f} ms, device-resident "
              f"{ms:.3f} ms; scipy (float64, one thread) {t_scipy:.3f} s; "
              f"{CARD['line']}")
        if not (err < TOL_RESAMPLE and werr <= 1):
            raise AssertionError(f"the resample at {sr_from} Hz disagrees")


def write_mono_wav(path, sr, samples):
    """A mono 16-bit wav of reference-scale samples (the int16 wire)."""
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(quantize_wire(samples, "int16").astype("<i2").tobytes())


def make_sweep_archive(root):
    """Seed-42 wav archive: SWEEP_QUERIES snippets of 10-11.5 s, then
    SWEEP_EPISODES episodes of SWEEP_EPISODE_SECS at 44.1 kHz and one at
    SWEEP_SLOW_SR, each with every snippet planted twice, 500-530 s apart
    (more than the 480 s distance, so both are kept), and one file of
    random bytes. Returns the planted samples at 44.1 kHz per file and
    query."""
    rng = np.random.default_rng(42)
    snippets = [
        np.clip(rng.standard_normal(int((SNIPPET_SECS + 0.5 * q) * SR))
                * 0.15, -0.45, 0.45).astype(np.float32)
        for q in range(SWEEP_QUERIES)
    ]
    for q, snip in enumerate(snippets):
        write_mono_wav(root / f"snippet{q}.wav", SR, snip)
    plants = {}
    for e in range(SWEEP_EPISODES + 1):
        slow = e == SWEEP_EPISODES
        sr = SWEEP_SLOW_SR if slow else SR
        x = rng.standard_normal(SWEEP_EPISODE_SECS * sr,
                                dtype=np.float32) * np.float32(0.05)
        gap = 500.0 + rng.uniform(0.0, 30.0)
        per_query = []
        for q, snip in enumerate(snippets):
            t1 = 2.0 + 14.0 * q + rng.uniform(0.0, 1.0)
            at = [int(t * sr) for t in (t1, t1 + gap)]
            piece = snip[::2] if slow else snip
            for i in at:
                x[i : i + len(piece)] = piece
            per_query.append([i * (SR // sr) for i in at])
        name = f"ep{e:02d}{'_22k' if slow else ''}.wav"
        write_mono_wav(root / name, sr, x)
        plants[name] = per_query
    (root / "zz_random.wav").write_bytes(rng.bytes(1 << 20))
    return plants


class _Records(logging.Handler):
    """Keeps the log records of a run."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def check_sweep_labels(root, plants, skip=()):
    """Every plant within PLANT_TOL samples in the ``.q{i}.txt`` labels:
    two plants give one label [first + 7 s, second]."""
    for name, per_query in plants.items():
        if name in skip:
            continue
        for q, (p1, p2) in enumerate(per_query):
            labels = read_labels((root / name).with_suffix(f".q{q}.txt"))
            got = [(lb.start * SR - 7 * SR, lb.end * SR) for lb in labels]
            if len(got) != 1 or abs(got[0][0] - p1) > PLANT_TOL + 0.5 or (
                    abs(got[0][1] - p2) > PLANT_TOL + 0.5):
                raise AssertionError(
                    f"{name}, query {q}: plants at {(p1, p2)}, labels {got}")


def archive_sweep(config, device, rows):
    """Path 8, the archive sweep (config #5's path on one card) through
    ``sweep_cli.run`` with --resample, --progress-file and the default
    int16 wire: every plant in the labels, 25 files Done and the random
    file skipped, kernels 1-5 launched once a slab of each staged row;
    the first group's raw candidates against the plain path; a resume;
    the staging rate; profiles of one group."""
    with tempfile.TemporaryDirectory(prefix="am_sweep_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        plants = make_sweep_archive(root)
        disk_mb = sum(f.stat().st_size for f in root.iterdir()) / 1e6
        print(f"sweep archive: {SWEEP_EPISODES} x {SWEEP_EPISODE_SECS} s at "
              f"{SR} Hz, one at {SWEEP_SLOW_SR} Hz, one random file, "
              f"{SWEEP_QUERIES} snippets; {disk_mb:.0f} MB of wav written in "
              f"{time.perf_counter() - t0:.1f} s")
        argv = [str(root / "ep*.wav"), str(root / "zz_random.wav"),
                "--resample", "--progress-file", str(root / ".done.txt"),
                "--device", str(device)]
        for q in range(SWEEP_QUERIES):
            argv += ["--snippet", str(root / f"snippet{q}.wav")]
        ns = sweep_cli.build_parser().parse_args(argv)
        records = _Records()
        logger = logging.getLogger("audio_matcher_torch")
        logger.addHandler(records)
        logger.setLevel(logging.INFO)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc, launches = counted(lambda: sweep_cli.run(ns), BATCH_PATH)
            torch.cuda.synchronize()
            t_sweep = time.perf_counter() - t0
        finally:
            logger.removeHandler(records)
        if rc != 0:
            raise AssertionError(f"sweep_cli.run returned {rc}")
        print("sweep path: " + next(m for m in records.messages
                                    if m.startswith("sweep: ")))
        if "sweep: files at another rate resample by device" not in (
                records.messages):
            raise AssertionError("--resample did not resolve to the card")
        skipped = [m for m in records.messages if m.startswith("skipping")]
        print(f"sweep log, skipped: {skipped}")
        if len(skipped) != 1 or "zz_random.wav" not in skipped[0]:
            raise AssertionError("the random file was not skipped alone")
        done = (root / ".done.txt").read_text().splitlines()
        if len(done) != len(plants) or not all(
                line.endswith(" Done") for line in done) or any(
                "zz_random" in line for line in done):
            raise AssertionError(f".done.txt: {done}")
        check_sweep_labels(root, plants)
        # every file, the resampled one too, is 600 s at 44.1 kHz: each
        # staged row is one decoded file, scanned in the same slabs
        slabs = n_slabs(config, SWEEP_EPISODE_SECS)
        want = len(plants) * slabs
        print(f"sweep launches: {launches}; {len(plants)} staged rows x "
              f"{slabs} slabs = {want} for each of kernels 1-5")
        check_launches("sweep", launches, BATCH_PATH, want)
        pair_h = len(plants) * SWEEP_QUERIES * SWEEP_EPISODE_SECS / 3600.0
        print(f"sweep end to end (decode + stage + scan + labels): "
              f"{len(plants)} files in {t_sweep:.3f} s, "
              f"{len(plants) / t_sweep:.3f} files/s, "
              f"{pair_h / t_sweep:.3f} pair audio-hours/s; plants found "
              f"within {PLANT_TOL} sample in all {len(plants)} x "
              f"{SWEEP_QUERIES} label files; {CARD['line']}")

        # the first group: kernels against the plain path, raw candidates
        names = sorted(plants)[:SWEEP_GROUP]
        snippets = [read_audio(root / f"snippet{q}.wav")[1]
                    for q in range(SWEEP_QUERIES)]
        cfg = dataclasses.replace(config, transfer_dtype="int16")
        scanner = ShardedScanner(snippets, SR, cfg, device=device)
        plain = ShardedScanner(snippets, SR, cfg, device=device,
                               query_state=scanner.query_state, plain=True)
        # the host's share of a group, one thread: decode; then the
        # resample of the 22.05 kHz file, on the card as the sweep runs it
        # and with scipy as it ran before
        t0 = time.perf_counter()
        episodes = [read_audio_int16(root / name)[1] for name in names]
        t_decode = time.perf_counter() - t0
        slow_sr, slow = read_audio_int16(
            root / next(n for n in plants if n.endswith("_22k.wav")))
        t_resample = {}
        for impl in ("device", "device", "scipy"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resample(slow, slow_sr, SR, impl=impl, wire_int16=True,
                     device=device)
            t_resample[impl] = time.perf_counter() - t0
        t_group = t_sweep / -(-len(plants) // SWEEP_GROUP)
        print(f"host, one thread: wav decode of one group ({SWEEP_GROUP} "
              f"files) {t_decode:.3f} s; resample of the {slow_sr} Hz file "
              f"on the card {t_resample['device']:.3f} s (warm; "
              f"{100 * t_resample['device'] / t_group:.1f} % of the sweep's "
              f"mean group, {t_group:.3f} s), with scipy "
              f"{t_resample['scipy']:.3f} s; {CARD['line']}")
        staged = scanner.stage_resident(episodes)
        compare_raw("sweep, first group", scanner.scan_dispatch(staged)[0],
                    plain.scan_dispatch(staged)[0])

        # resume: the progress file holds the first group, no labels left
        first = {}
        for f in sorted(root.glob("*.q*.txt")):
            first[f.name] = f.read_bytes()
            f.unlink()
        (root / ".done.txt").write_text("\n".join(done[:SWEEP_GROUP]) + "\n")
        t0 = time.perf_counter()
        if sweep_cli.run(ns) != 0:
            raise AssertionError("the resumed sweep failed")
        t_resume = time.perf_counter() - t0
        again = {f.name: f.read_bytes() for f in root.glob("*.q*.txt")}
        skip = {f"{Path(name).stem}.q{q}.txt" for name in names
                for q in range(SWEEP_QUERIES)}
        if again != {k: v for k, v in first.items() if k not in skip}:
            raise AssertionError("the resumed sweep's labels differ")
        if (root / ".done.txt").read_text().splitlines() != done:
            raise AssertionError("the resumed sweep's .done.txt differs")
        print(f"resume: {len(again)} label files rewritten byte for byte, "
              f"the first group's {len(skip)} left out, .done.txt equal; "
              f"{len(plants) - SWEEP_GROUP} files in {t_resume:.3f} s")
        two_process_sweep(root, first, device)

        # staging: the sweep's group, then a group of mixed durations
        # (120-600 s, one staged width for every row)
        mixed = [ep[: int(secs * SR)] for ep, secs in zip(
            episodes, np.linspace(120, SWEEP_EPISODE_SECS, len(episodes)))]
        for label, group in (("sweep group", episodes),
                             ("mixed 120-600 s", mixed)):
            times = []
            for _ in range(REPEATS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                staged = scanner.stage_resident(group)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            mb = staged[0].numel() * staged[0].element_size() / 1e6
            t = statistics.median(times[1:])
            print(f"staging one group ({label}, {len(group)} rows, {mb:.1f} "
                  f"MB int16, fill + upload into a fresh pinned buffer): "
                  f"p50 {t:.4f} s, {mb / t:.1f} MB/s; {CARD['line']}")
        staged = scanner.stage_resident(episodes)
        profile_run("the scan of one staged group",
                    lambda: scanner.scan_staged(staged))
        print(CARD["line"])
        profile_run(f"one sweep group, decode to collect ({SWEEP_GROUP} "
                    f"files, sweep_archive)",
                    lambda: sweep_archive([root / name for name in names],
                                          snippets, SR, cfg, device=device))
        print(CARD["line"])
        spectrogram_sweep(root, plants, snippets, device)


def spectrogram_sweep(root, plants, snippets, device):
    """Config #4 through the sweep CLI: ``sweep_cli.run --mode
    spectrogram --resample --progress-file`` over the archive's first
    SWEEP_GROUP files and its 22.05 kHz file (int16 wire, resampled on the
    card). Every plant of the 44.1 kHz files within one hop in the labels.
    The 22.05 kHz file's plants are half-band, aliased copies of
    full-band noise snippets, which a log-mel NCC over all 64 mels does
    not match (nor does the JAX package's, the same arithmetic): its peaks
    must equal the port's CPU path on the same file. A resume from a
    progress file holding the first half rewrites the rest byte for byte.
    No kernel is launched."""
    slow = next(n for n in plants if n.endswith("_22k.wav"))
    names = sorted(n for n in plants if n != slow)[:SWEEP_GROUP] + [slow]
    spec = root / "spectrogram"
    spec.mkdir()
    for name in names:
        (spec / name).symlink_to(root / name)
    argv = [str(spec / "ep*.wav"), "--mode", "spectrogram", "--resample",
            "--progress-file", str(spec / ".done.txt"), "--device",
            str(device)]
    for q in range(SWEEP_QUERIES):
        argv += ["--snippet", str(root / f"snippet{q}.wav")]
    ns = sweep_cli.build_parser().parse_args(argv)
    records = _Records()
    logger = logging.getLogger("audio_matcher_torch")
    logger.addHandler(records)
    logger.setLevel(logging.INFO)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, launches = counted(lambda: sweep_cli.run(ns), ())
        t_sweep = time.perf_counter() - t0
    finally:
        logger.removeHandler(records)
    path = [m for m in records.messages if m.startswith("sweep: ")]
    print(f"spectrogram sweep log: {path}")
    if rc != 0 or any(launches.values()) or not any(
            "spectrogram mode" in m for m in path) or (
            "sweep: files at another rate resample by device" not in path):
        raise AssertionError(f"spectrogram sweep: rc {rc}, {launches}")
    done = (spec / ".done.txt").read_text().splitlines()
    if len(done) != len(names) or not all(
            line.endswith(" Done") for line in done):
        raise AssertionError(f"spectrogram sweep .done.txt: {done}")
    hop = SpectrogramConfig().hop
    for name in names[:-1]:
        for q, (p1, p2) in enumerate(plants[name]):
            labels = read_labels((spec / name).with_suffix(f".q{q}.txt"))
            got = [(lb.start * SR - 7 * SR, lb.end * SR) for lb in labels]
            if len(got) != 1 or abs(got[0][0] - p1) > hop + 0.5 or (
                    abs(got[0][1] - p2) > hop + 0.5):
                raise AssertionError(f"spectrogram sweep {name}, query {q}: "
                                     f"plants at {(p1, p2)}, labels {got}")
    cfg = SpectrogramConfig(transfer_dtype="int16", resample_impl="device")
    want = sweep_archive([spec / slow], snippets, SR, device="cpu",
                         mode="spectrogram", spectrogram_config=cfg,
                         resample_mismatched=True)[str(spec / slow)]
    got = sweep_archive([spec / slow], snippets, SR, device=device,
                        mode="spectrogram", spectrogram_config=cfg,
                        resample_mismatched=True)[str(spec / slow)]
    for g, w in zip(got, want):
        if [p.position for p in g] != [p.position for p in w] or any(
                abs(a.height - b.height) > TOL_SPEC for a, b in zip(g, w)):
            raise AssertionError(f"{slow}: card {got}, CPU path {want}")
    pair_h = len(names) * SWEEP_QUERIES * SWEEP_EPISODE_SECS / 3600.0
    print(f"spectrogram sweep (decode + resample + stage + scan + labels): "
          f"{len(names)} files in {t_sweep:.3f} s, "
          f"{len(names) / t_sweep:.3f} files/s, {pair_h / t_sweep:.3f} pair "
          f"audio-hours/s; every plant of the {len(names) - 1} files at "
          f"{SR} Hz within one hop; {slow} (plants half-band): card "
          f"{[len(g) for g in got]} matches a query, the CPU path "
          f"{[len(w) for w in want]}; no kernel launched; {CARD['line']}")

    first = {f.name: f.read_bytes() for f in sorted(spec.glob("*.q*.txt"))}
    for f in spec.glob("*.q*.txt"):
        f.unlink()
    keep = len(names) // 2
    (spec / ".done.txt").write_text("\n".join(done[:keep]) + "\n")
    if sweep_cli.run(ns) != 0:
        raise AssertionError("the resumed spectrogram sweep failed")
    again = {f.name: f.read_bytes() for f in spec.glob("*.q*.txt")}
    skip = {f"{Path(n).stem}.q{q}.txt" for n in names[:keep]
            for q in range(SWEEP_QUERIES)}
    if again != {k: v for k, v in first.items() if k not in skip} or (
            (spec / ".done.txt").read_text().splitlines() != done):
        raise AssertionError("the resumed spectrogram sweep differs")
    print(f"spectrogram resume: {len(again)} label files rewritten byte for "
          f"byte, .done.txt equal")


def matcher_cli_run(config, device, rows):
    """Path 9, config #2 through the matcher CLI: one 3600 s episode x one
    10 s snippet (seed 42, plants at 21 s and 1980 s) as wav files,
    ``matcher_cli.run`` with --transfer mulaw8: the label file holds both
    plants, and kernel 6 was launched."""
    snippets, offsets, episode = make_bench_inputs(1, SINGLE_EPISODE_SECS)
    with tempfile.TemporaryDirectory(prefix="am_cli_") as tmp:
        root = Path(tmp)
        write_mono_wav(root / "intro.wav", SR, snippets[0])
        write_mono_wav(root / "episode.wav", SR, episode)
        argv = [str(root / "episode.wav"), "--snippet",
                str(root / "intro.wav"), "--transfer", "mulaw8",
                "--device", str(device)]
        parser = matcher_cli.build_parser()
        matcher_cli.run(parser.parse_args(argv + ["--no-out"]))  # warm
        ns = parser.parse_args(argv)
        t0 = time.perf_counter()
        rc, launches = counted(lambda: matcher_cli.run(ns), SINGLE_PATH)
        t_run = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"matcher_cli.run returned {rc}")
        cli_config = MatchConfig(chunk_secs=float(ns.chunk_size))
        slabs = n_slabs(cli_config, SINGLE_EPISODE_SECS)
        check_launches("matcher CLI", launches, SINGLE_PATH, slabs)
        labels = read_labels(root / "episode.txt")
        want = [int(o * SR) for o in offsets]
        got = [(lb.start * SR - 7 * SR, lb.end * SR) for lb in labels]
        if len(got) != 1 or any(abs(g - w) > PLANT_TOL + 0.5
                                for g, w in zip(got[0], want)):
            raise AssertionError(f"matcher CLI labels {got}, plants {want}")
        print(f"matcher CLI, config #2 ({SINGLE_EPISODE_SECS} s episode, "
              f"mulaw8, decode + stage + scan + labels): {t_run:.3f} s; "
              f"label {labels[0].to_line()!r} holds both plants within "
              f"{PLANT_TOL} sample; launches {launches} (one a slab, {slabs} "
              f"slabs); {CARD['line']}")

        # config #4 on the same files: --mode spectrogram, no kernel
        ns = parser.parse_args(argv + ["--mode", "spectrogram", "-o",
                                       str(root / "episode.spec.txt")])
        t0 = time.perf_counter()
        rc, launches = counted(lambda: matcher_cli.run(ns), ())
        t_run = time.perf_counter() - t0
        hop = SpectrogramConfig().hop
        labels = read_labels(root / "episode.spec.txt")
        got = [(lb.start * SR - 7 * SR, lb.end * SR) for lb in labels]
        if rc != 0 or any(launches.values()) or len(got) != 1 or any(
                abs(g - w) > hop + 0.5 for g, w in zip(got[0], want)):
            raise AssertionError(f"matcher CLI --mode spectrogram: rc {rc}, "
                                 f"labels {got}, plants {want}, {launches}")
        print(f"matcher CLI --mode spectrogram, config #4 single pair "
              f"({SINGLE_EPISODE_SECS} s episode, decode + log-mel + NCC + "
              f"labels): {t_run:.3f} s; label {labels[0].to_line()!r} holds "
              f"both plants within one hop; no kernel launched; "
              f"{CARD['line']}")


def scan_times(scanner, batch, kernels):
    """Stage ``batch`` and scan it once to warm, then the measured scan
    with the launch counts reset just before it → (peaks, launches, stage
    s, scan s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = scanner.stage_resident(batch)
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    scanner.scan_staged(staged)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    peaks, launches = counted(lambda: scanner.scan_staged(staged), kernels)
    return peaks, launches, t_stage, time.perf_counter() - t0


def n_slabs(config, episode_secs):
    """Slabs a staged row of ``episode_secs`` s is scanned in."""
    n_windows = -(-episode_secs * SR // int(config.chunk_secs * SR))
    return -(-n_windows // effective_slab(config, n_windows))


def check_launches(label, launches, kernels, want):
    """Each kernel of ``kernels`` launched ``want`` times, no other."""
    names = {k.__name__ for k in kernels}
    if any(launches[k] != want for k in names) or any(
            v for k, v in launches.items() if k not in names):
        raise AssertionError(f"{label}: launches {launches}, want {want} of "
                             f"each of {sorted(names)}")


def sharded_scan(config, device, rows):
    """Path 12, several devices in one process: config #3 at full width
    and config #2's single-query scan over a mesh of the one card twice,
    each against the one-device scan of the same batch."""
    mesh = Mesh.of([device, device])
    snippets, offsets, episode = make_bench_inputs()
    batch = [quantize_wire(episode, config.transfer_dtype)] * N_EPISODES
    one = ShardedScanner(snippets, SR, config, device=device)
    sharded = ShardedScanner(snippets, SR, config, device=mesh,
                             query_state=one.query_state)
    print(f"sharded config #3: {sharded.describe()}")
    runs = {}
    slabs = N_EPISODES * n_slabs(config, EPISODE_SECS)  # 4 x 4 = 16
    for label, scanner in (("one device", one), (mesh.describe(), sharded)):
        peaks, launches, t_stage, t_scan = scan_times(scanner, batch,
                                                      BATCH_PATH)
        check_launches(f"config #3 on {label}", launches, BATCH_PATH, slabs)
        check_plants([per_query[0] for per_query in peaks], offsets,
                     config.distance_secs)
        runs[label] = peaks
        print(f"config #3 on {label}: stage {t_stage:.3f} s, scan "
              f"{t_scan:.3f} s ({N_EPISODES * N_QUERIES * EPISODE_SECS / 3600 / t_scan:.3f} "
              f"pair-h/s device-resident); launches {launches}; "
              f"{CARD['line']}")
        torch.cuda.empty_cache()
    if runs["one device"] != runs[mesh.describe()]:
        raise AssertionError("the sharded config #3 scan differs from the "
                             "one-device scan")
    print(f"config #3 sharded over {mesh.describe()}: every peak of the "
          f"{N_EPISODES} x {N_QUERIES} pairs equal to the one-device scan")

    snippets, offsets, episode = make_bench_inputs(1, SINGLE_EPISODE_SECS)
    batch = [quantize_wire(episode, config.transfer_dtype)] * 2
    one = ShardedScanner(snippets, SR, config, device=device)
    sharded = ShardedScanner(snippets, SR, config, device=mesh,
                             query_state=one.query_state)
    runs = []
    for scanner in (one, sharded):
        peaks, launches, t_stage, t_scan = scan_times(scanner, batch,
                                                      SINGLE_PATH)
        check_launches(f"config #2 x 2 on {scanner.describe()}", launches,
                       SINGLE_PATH, 2 * n_slabs(config, SINGLE_EPISODE_SECS))
        check_plants([per_query[0] for per_query in peaks], offsets,
                     config.distance_secs)
        runs.append(peaks)
        print(f"config #2 x 2 episodes (Q = 1) on {scanner.describe()}: "
              f"stage {t_stage:.3f} s, scan {t_scan:.3f} s; launches "
              f"{launches}")
    if runs[0] != runs[1]:
        raise AssertionError("the sharded Q = 1 scan differs from the "
                             "one-device scan")
    print("config #2 x 2 sharded: every peak equal to the one-device scan")


def mesh_dryrun(config, device, rows):
    """Path 12, the port's dry run on a mesh of the one card twice: the
    resident scan (kernel 7), the windows path and the spectrogram
    scanner, every plant found."""
    mesh = Mesh.of([device, device])
    line, launches = counted(lambda: dryrun_multichip(mesh), XLA_PATH)
    check_launches("the dry run", launches, XLA_PATH,
                   launches["local_max_block_reduce"])
    print(f"dry run launches: {launches}; {CARD['line']}")


def console(run, stdin=""):
    """``run()`` with ``stdin`` as its standard input → (its result, what
    it printed)."""
    out = io.StringIO()
    saved = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out):
            result = run()
    finally:
        sys.stdin = saved
    return result, out.getvalue()


def worker_session(root, argv, stdin):
    """``audio-worker-torch`` with ``argv`` and ``stdin`` against a fresh
    ``FakeAudacity`` in ``root/pipes`` → (exit code, its command log)."""
    os.environ["AUDACITY_PIPE_DIR"] = str(root / "pipes")
    server = FakeAudacity(root / "pipes")
    try:
        rc, _ = console(lambda: worker_cli.main(argv), stdin)
        log = list(server.command_log)  # before stop(), which may add one
    finally:
        server.stop()
        del os.environ["AUDACITY_PIPE_DIR"]
    return rc, log


def check_listing(label, text):
    """The archive's listing: the series and both chapters, from the
    renamed episode."""
    want = ["Serie"] + [f"\t{nr} - {name} [radio - 2024-01-06]"
                        for nr, name in enumerate(WORKFLOW_CHAPTERS, 1)]
    if [ln for ln in text.replace("$> ", "").splitlines() if ln] != want:
        raise AssertionError(f"{label} listed {text!r}, want {want}")


def worker_archive(config, device, rows):
    """Path 13, the workflow's three tools in turn: the matcher CLI on the
    card writes the episode's label file, ``audio-worker-torch`` names,
    merges, tags and files the chapters against the fake Audacity, and
    ``archive-scroller-torch`` lists the archive."""
    offsets = [int(o * SR) for o in WORKFLOW_PLANTS]
    snippets, _, episode = make_bench_inputs(1, SINGLE_EPISODE_SECS,
                                             WORKFLOW_PLANTS)
    with tempfile.TemporaryDirectory(prefix="am_workflow_") as tmp:
        root = Path(tmp)
        work, archive = root / "work", root / "archive"
        (archive / "Serie").mkdir(parents=True)
        work.mkdir()
        (archive / "Serie" / "index.txt").write_text(
            "".join(f"{name}\n" for name in WORKFLOW_CHAPTERS))
        episode_path = work / "radio-2024_01_06.wav"
        write_mono_wav(root / "intro.wav", SR, snippets[0])
        write_mono_wav(episode_path, SR, episode)
        del episode

        # 1. the matcher CLI on the card
        ns = matcher_cli.build_parser().parse_args(
            [str(episode_path), "--snippet", str(root / "intro.wav"),
             "--transfer", "mulaw8", "--device", str(device)])
        t0 = time.perf_counter()
        rc, launches = counted(lambda: matcher_cli.run(ns), SINGLE_PATH)
        t_match = time.perf_counter() - t0
        slabs = n_slabs(MatchConfig(chunk_secs=float(ns.chunk_size)),
                        SINGLE_EPISODE_SECS)
        check_launches("the workflow's matcher CLI", launches, SINGLE_PATH,
                       slabs)
        found = read_labels(episode_path.with_suffix(".txt"))
        if rc != 0 or [lb.name for lb in found] != [
                f"Segment {k}" for k in range(1, len(offsets))] or any(
                abs(lb.start * SR - 7 * SR - offsets[k]) > PLANT_TOL + 0.5
                or abs(lb.end * SR - offsets[k + 1]) > PLANT_TOL + 0.5
                for k, lb in enumerate(found)):
            raise AssertionError(f"matcher CLI: rc {rc}, labels "
                                 f"{[lb.to_line() for lb in found]}, plants "
                                 f"{offsets}")

        # 2. the worker against the fake Audacity; the user's exports
        for nr, name in enumerate(WORKFLOW_CHAPTERS, 1):
            (work / f"Serie {nr} {name}.mp3").write_bytes(MP3_STUB)
        argv = [str(episode_path), "--index-folder", str(archive),
                "--config", str(root / "worker.toml"), "-n", "--silent",
                "--timeout", "30s"]
        t0 = time.perf_counter()
        rc, _ = worker_session(root, argv, "\n".join(WORKFLOW_ANSWERS) + "\n")
        t_worker = time.perf_counter() - t0
        renamed = [lb.name for lb in read_labels(episode_path.with_suffix(
            ".txt"))]
        want = [f"Serie {nr}.{part} {name}"
                for nr, name in enumerate(WORKFLOW_CHAPTERS, 1)
                for part in (1, 2)]
        if rc != 0 or renamed != want:
            raise AssertionError(f"worker: rc {rc}, labels {renamed}")
        for nr, name in enumerate(WORKFLOW_CHAPTERS, 1):
            moved = archive / "Serie" / f"Serie {nr} {name}.mp3"
            tag = tagger.TaggedFile.from_path(moved)
            got = [tag.get(f) for f in (tagger.Title, tagger.Album,
                                        tagger.Genre, tagger.Track,
                                        tagger.TotalTracks)]
            if got != [name, "Serie", "Hörbuch", nr, 2] or (
                    1, "00:00:00.000", "Part 1") not in (
                    tag._inner.get_chapters()) or (work / moved.name).exists():
                raise AssertionError(f"{moved}: tags {got}, chapters "
                                     f"{tag._inner.get_chapters()}")
            del tag
        done = (work / ".done.txt").read_text()
        if Progress(work / ".done.txt").get(episode_path.name) != State.DONE:
            raise AssertionError(f".done.txt holds {done!r}")
        rc, log = worker_session(root, argv, "")
        if rc != 0 or log != ["Exit:"]:
            raise AssertionError(f"the second worker run: rc {rc}, {log}")

        # 3. the archive: the episode's renamed label file filed in it
        shutil.copy(episode_path.with_suffix(".txt"), archive)
        t0 = time.perf_counter()
        rc, listing = console(lambda: archive_cli.main(
            [str(archive), "--config", str(root / "archive.toml"), "-y",
             "--silent"]))
        t_archive = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"archive CLI returned {rc}")
        check_listing("archive-scroller-torch", listing)
        _, repl = console(lambda: Holder(archive).repl(), "list -c\nexit\n")
        check_listing("the archive REPL", repl)
    print(f"workflow on config #2's episode ({SINGLE_EPISODE_SECS} s, "
          f"{len(offsets)} plants): matcher CLI {t_match:.3f} s (launches "
          f"{launches}, one a slab, {slabs} slabs; {len(found)} Segment "
          f"labels within {PLANT_TOL} sample of their plants), "
          f"audio-worker-torch {t_worker:.3f} s (4 labels renamed, 2 "
          f"chapters tagged and moved, Done; a second run skipped it), "
          f"archive-scroller-torch {t_archive:.3f} s (the series and both "
          f"chapters, CLI and REPL); {CARD['line']}")


def two_process_sweep(root, labels, device):
    """Path 12, several processes: the archive sweep by two
    ``audio-sweep-torch`` processes of one cluster on the card, over
    symlinks to the archive's files. Both exit 0, the label files equal
    ``labels`` (the one-process sweep's) byte for byte, each file is Done
    in exactly one of the two stores."""
    cluster = root / "cluster"
    cluster.mkdir()
    for f in sorted(root.glob("ep*.wav")) + [root / "zz_random.wav"]:
        (cluster / f.name).symlink_to(f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = [sys.executable, "-m", "audio_matcher_tpu_torch.cli.sweep_cli",
            str(cluster / "ep*.wav"), str(cluster / "zz_random.wav"),
            "--resample", "--device", str(device.type)]
    for q in range(SWEEP_QUERIES):
        argv += ["--snippet", str(root / f"snippet{q}.wav")]
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for pid in (0, 1):
            env = dict(os.environ, AM_COORDINATOR=f"127.0.0.1:{port}",
                       AM_NUM_PROCESSES="2", AM_PROCESS_ID=str(pid))
            logs.append(open(cluster / f"proc{pid}.log", "w"))
            procs.append(subprocess.Popen(
                argv + ["--progress-file", str(cluster / f"proc{pid}.done")],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        walls = [None, None]
        while None in walls:
            for pid, proc in enumerate(procs):
                if walls[pid] is None and proc.poll() is not None:
                    walls[pid] = time.perf_counter() - t0
            if time.perf_counter() - t0 > WORKER_TIMEOUT:
                raise AssertionError("a sweep process did not finish in "
                                     f"{WORKER_TIMEOUT} s")
            time.sleep(0.05)
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
        for f in logs:
            f.close()
    outs = [(cluster / f"proc{pid}.log").read_text() for pid in (0, 1)]
    for pid, (proc, out) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            raise AssertionError(f"sweep process {pid} returned "
                                 f"{proc.returncode}:\n{out[-4000:]}")
    got = {f.name: f.read_bytes() for f in sorted(cluster.glob("*.q*.txt"))}
    if got != labels:
        raise AssertionError(f"two-process labels differ: {len(got)} files, "
                             f"{len(labels)} from one process")
    done = [(cluster / f"proc{pid}.done").read_text().splitlines()
            for pid in (0, 1)]
    names = sorted(Path(line.rsplit(" ", 1)[0]).name for d in done
                   for line in d if line.endswith(" Done"))
    if names != sorted(n for n in (f.name for f in cluster.glob("ep*.wav"))):
        raise AssertionError(f"two-process .done stores: {done}")
    scanned = [next(line for line in out.splitlines() if "scanned" in line)
               for out in outs]
    print(f"two-process sweep (two audio-sweep-torch processes, one "
          f"cluster, one card): wall {walls[0]:.3f} s and {walls[1]:.3f} s "
          f"from both starts (import, cluster join, decode, stage, scan, "
          f"labels); {len(got)} label files equal to the one-process "
          f"sweep's byte for byte; {len(names)} files Done, "
          f"{[len(d) for d in done]} a store, none twice; logs: {scanned}; "
          f"{CARD['line']}")


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
    CARD["line"] = smi
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
                  jnp_scan, single_query_jnp, large_fft, spectrogram_batch,
                  spectrogram_single, device_resample, archive_sweep,
                  matcher_cli_run, sharded_scan, mesh_dryrun,
                  worker_archive):
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
