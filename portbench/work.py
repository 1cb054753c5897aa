"""The work of the correlation a scan computes, counted from the shapes of
a configuration and its episodes alone, and the chip's peaks that bound
its time.

F counts the mathematics, not the program's passes, in the FFTW
convention of 2.5·L·log2 L operations for a real transform of length L:
per overlap-save window of an episode, one forward transform shared by
every query; per query, a 6-operation complex product on the L/2 + 1 bins
and one inverse transform. B counts the episode's wire bytes read once,
the query spectra (complex64, L/2 + 1 bins a query) read once a scan, and
the picks (position, height, prominence: 12 bytes a slot) written once.
Packing pairs of rows into complex transforms, fusing passes or skipping
padded windows moves neither count: only the shapes do.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
PICK_BYTES = 12  # int32 position, float32 height, float32 prominence


def fft_len(cfg: dict, query_lengths) -> int:
    """The transform length the configuration implies: the smallest power
    of two holding a window (chunk + longest query + 2) and a query."""
    sr = cfg["sample_rate"]
    m = max(query_lengths)
    window = int(round(cfg["match"]["chunk_secs"] * sr)) + m + 2
    return 1 << (window + m - 2).bit_length()


def real_fft_flops(L: int) -> float:
    return 2.5 * L * math.log2(L)


def n_windows(n: int, chunk: int) -> int:
    return max(-(-n // chunk), 1)


def slots(cfg: dict, query_lengths) -> int:
    """Pick slots a window and query: the distance filter's most."""
    sr = cfg["sample_rate"]
    mc = cfg["match"]
    chunk = int(round(mc["chunk_secs"] * sr))
    valid = chunk + max(query_lengths) + 2 - min(query_lengths) + 1
    d = max(int(mc["distance_secs"]) * sr, 1)
    return min(valid // d + 2, mc["max_peaks_per_chunk"])


def scan_work(cfg: dict, query_lengths, episode_lengths,
              wire_bytes: int) -> tuple[float, float]:
    """(F operations, B bytes) of one scan of ``episode_lengths`` samples
    against the library."""
    L = fft_len(cfg, query_lengths)
    Q = len(query_lengths)
    chunk = int(round(cfg["match"]["chunk_secs"] * cfg["sample_rate"]))
    fft = real_fft_flops(L)
    per_window = fft + Q * (6 * (L // 2 + 1) + fft)
    S = slots(cfg, query_lengths)
    F = B = 0.0
    for n in episode_lengths:
        c = n_windows(n, chunk)
        F += c * per_window
        B += n * wire_bytes + c * Q * S * PICK_BYTES
    B += Q * (L // 2 + 1) * 8
    return F, B


def least_seconds(F: float, B: float) -> float:
    """The least time the chip could take for F operations and B bytes."""
    return max(F / FP32_FLOPS, B / HBM_BYTES_PER_S)
