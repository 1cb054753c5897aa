"""The plain reference of the matcher: overlap-save windows, the normalized
cross-correlation of each window with one query, scipy-style peak picking
in each window, and the cross-window dedup. Plain PyTorch (``torch.fft``
and elementwise ops) on whatever device the caller gives; it imports
nothing of the program under test and takes nothing the program made: the
host samples and the configuration's numbers only.

The semantics are the upstream matcher's (``NilsJochem/audio-matcher``),
as the configuration states them:

* a window starts every ``chunk`` samples and spans ``chunk + overlap``
  samples, ``overlap`` = the longest query of the library + 2 (so a peak on
  a hop boundary lies inside some window's interior); the last windows keep
  their true length, and a window shorter than a query yields nothing for
  it;
* the score at lag j is Σ_i x[j+i]·s[i] / Σ_i s[i]², for every lag at which
  the whole query lies inside the window;
* in each window: strict local maxima away from the valid range's ends,
  then scipy's greedy-by-height distance filter (|Δ| < distance
  suppressed; ties keep the lower lag), at most ``max_peaks`` picks;
  prominence as scipy's ``peak_prominences`` over the window's valid range;
* picks at or above the minimum prominence are rebased by the window's
  start, exact duplicates (a seam seen by two windows) keep the more
  prominent, and a peak is dropped when an immediate neighbour within the
  distance is strictly more prominent.

Why the comparison's limits are what they are: positions are integers and
must agree exactly. Heights and prominences are float32 sums over the
query's length taken by two different FFT algorithms (this one cuFFT, the
program its own passes), so they differ by the rounding of each; the
limits on those gaps are set between what the program reads against this
reference over a dozen seeds and what the same reference reads in
bfloat16 (:func:`correlate` with ``precision="bfloat16"``, the control),
as ``PERF.md`` records.
"""

from __future__ import annotations

import math

import torch

_NEG = float("-inf")
_POS = float("inf")


def fft_size(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


def dequantize(host, wire: str, device) -> torch.Tensor:
    """Host wire samples → float32 PCM on ``device`` (int16: value/65535)."""
    x = torch.as_tensor(host).to(device)
    if wire == "int16":
        return x.to(torch.float32) * torch.tensor(
            1.0 / 65535.0, dtype=torch.float32, device=device)
    if wire == "float32":
        return x.to(torch.float32)
    raise ValueError(f"the reference has no {wire!r} wire")


def windows(x: torch.Tensor, chunk: int, window: int):
    """[C, window] zero-padded windows of ``x`` and their true lengths."""
    n = x.shape[0]
    c = max(-(-n // chunk), 1)
    out = torch.zeros((c, window), dtype=x.dtype, device=x.device)
    lens = []
    for k in range(c):
        seg = x[k * chunk : k * chunk + window]
        out[k, : seg.shape[0]] = seg
        lens.append(seg.shape[0])
    return out, torch.tensor(lens, device=x.device)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def correlate(wins: torch.Tensor, query: torch.Tensor,
              precision: str = "float32") -> torch.Tensor:
    """Scores [C, window − m + 1] of every window against one query.
    ``precision="bfloat16"`` rounds every stored value (the windows, the
    query, both spectra, their product, the scores) to bfloat16, the
    transforms themselves in float32 (``torch.fft`` has no bfloat16): the
    control."""
    m = query.shape[0]
    L = fft_size(wins.shape[1] + m - 1)
    low = precision == "bfloat16"
    if low:
        wins, query = _bf16(wins), _bf16(query)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    ac = float((query.double() ** 2).sum())
    inv = 1.0 / ac if ac else 0.0
    x = torch.fft.rfft(wins, n=L)
    s = torch.fft.rfft(query, n=L)
    if low:
        x = torch.complex(_bf16(x.real), _bf16(x.imag))
        s = torch.complex(_bf16(s.real), _bf16(s.imag))
    p = x * s.conj()
    del x
    if low:
        p = torch.complex(_bf16(p.real), _bf16(p.imag))
    c = torch.fft.irfft(p, n=L)[:, : wins.shape[1] - m + 1]
    del p
    scale = torch.tensor(inv, dtype=torch.float32, device=c.device)
    if low:
        return _bf16(_bf16(c) * _bf16(scale))
    return c * scale


def pick(scores: torch.Tensor, valid: torch.Tensor, distance: int,
         max_peaks: int):
    """Picks of every row: (row, lag, height, prominence) lists, scipy's
    ``find_peaks(distance=, prominence=)`` with strict maxima, at most
    ``max_peaks`` a row. ``valid`` [C]: each row's valid length."""
    C, V = scores.shape
    dev = scores.device
    cols = torch.arange(V, device=dev)[None, :]
    inside = cols < valid[:, None]
    x = torch.where(inside, scores, _NEG)
    lm = torch.zeros_like(inside)
    lm[:, 1:-1] = (x[:, 1:-1] > x[:, :-2]) & (x[:, 1:-1] > x[:, 2:])
    lm &= (cols >= 1) & (cols <= valid[:, None] - 2)
    y = torch.where(lm, x, _NEG)
    del lm
    x_min = torch.where(inside, scores, _POS)
    rows = torch.arange(C, device=dev)
    d = max(int(distance), 1)
    out = []
    for _ in range(max_peaks):
        idx = y.argmax(dim=1)
        h = y[rows, idx]
        live = torch.isfinite(h)
        if not bool(live.any()):
            break
        near = (cols > (idx - d)[:, None]) & (cols < (idx + d)[:, None])
        y.masked_fill_(near & live[:, None], _NEG)
        higher = (x > h[:, None]) & inside
        j = torch.where(higher & (cols < idx[:, None]), cols, -1).amax(1)
        k = torch.where(higher & (cols > idx[:, None]), cols,
                        V).amin(1)
        k = torch.minimum(k, valid)
        left = torch.where((cols > j[:, None]) & (cols <= idx[:, None]),
                           x_min, _POS).amin(1)
        right = torch.where((cols >= idx[:, None]) & (cols < k[:, None]),
                            x_min, _POS).amin(1)
        prom = h - torch.maximum(left, right)
        for r in torch.nonzero(live).flatten().tolist():
            out.append((r, int(idx[r]), float(h[r]), float(prom[r])))
    return out


def overshadow(peaks, sr: int, distance_secs: float):
    """Exact duplicates keep the more prominent; then a peak goes when an
    immediate neighbour within the distance is strictly more prominent.
    ``peaks``: (position, height, prominence) tuples."""
    best = {}
    for p in peaks:
        q = best.get(p[0])
        if q is None or p[2] > q[2]:
            best[p[0]] = p
    ps = sorted(best.values())
    out = []
    for i, p in enumerate(ps):
        shadowed = any(
            0 <= j < len(ps) and abs(p[0] - ps[j][0]) / sr < distance_secs
            and ps[j][2] > p[2] for j in (i - 1, i + 1))
        if not shadowed:
            out.append(p)
    return out


def geometry(cfg: dict, query_lengths) -> dict:
    """The window geometry and picking numbers a configuration states."""
    sr = cfg["sample_rate"]
    mc = cfg["match"]
    chunk = int(round(mc["chunk_secs"] * sr))
    window = chunk + max(query_lengths) + 2
    return {
        "sr": sr, "chunk": chunk, "window": window,
        "distance": int(mc["distance_secs"]) * sr,
        "distance_secs": mc["distance_secs"],
        "min_prominence": mc["prominence"] / 100.0,
        "max_peaks": mc["max_peaks_per_chunk"],
    }


def peaks_of(x: torch.Tensor, query, geo: dict,
             precision: str = "float32", wins=None):
    """The peaks one query finds in one dequantized episode ``x``:
    (position, height, prominence) tuples, sorted by position. ``wins``:
    the episode's (windows, lengths), to share between queries."""
    q = torch.as_tensor(query, dtype=torch.float32).to(x.device)
    m = q.shape[0]
    wins, lens = wins if wins is not None else windows(
        x, geo["chunk"], geo["window"])
    valid = (lens - m + 1).clamp(min=0)
    scores = correlate(wins, q, precision)
    picks = pick(scores, valid, geo["distance"], geo["max_peaks"])
    del scores
    cands = [(r * geo["chunk"] + lag, h, pr) for r, lag, h, pr in picks
             if math.isfinite(h) and pr >= geo["min_prominence"]]
    return overshadow(cands, geo["sr"], geo["distance_secs"])
