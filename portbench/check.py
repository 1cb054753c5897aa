"""The comparison that decides ``correct``: the program's peaks, as the
timed path returned them, against the plain reference's on the same host
samples.

Which answers are compared: a sample of (episode, query) pairs drawn from
the run's seed among the episodes the window scanned (the longest always
among them): every query planted in a sampled episode and ``extra_queries``
others, which must find nothing. Every answer the window returned for a
sampled pair is compared, however often its episode came round.

What is compared, each against a limit of the configuration's own:

* ``position_mismatches``: pairs whose peak positions differ from the
  reference's in any way (a peak missing, added or moved); limit 0;
* ``height_gap`` and ``prominence_gap``: the widest gap between a peak's
  height (prominence) and the reference's, over every peak found at a
  position the reference also found;
* ``peaks_compared``: at least one peak, so that a run that finds nothing
  cannot pass.
"""

from __future__ import annotations

import math

import torch

from .common import rng, load_module, HERE

def reference(cfg: dict):
    return load_module(HERE / "reference" / f"{cfg['reference']}.py")


def sample_pairs(traffic, mix: dict, seed: int, seen) -> dict:
    """{episode: [queries]} to compare, drawn from ``seed`` among the
    episodes ``seen`` in the window."""
    spec = mix["check"]
    r = rng(seed, "check")
    seen = sorted(set(seen))
    if not seen:
        return {}
    longest = max(seen, key=lambda e: len(traffic.episodes[e]))
    rest = [e for e in seen if e != longest]
    n = min(spec["episodes"] - 1, len(rest))
    chosen = [longest] + [rest[i] for i in
                          sorted(r.choice(len(rest), n, replace=False))]
    Q = len(traffic.queries)
    pairs = {}
    for e in chosen:
        planted = sorted({q for q, _ in traffic.plants[e]})
        others = [q for q in range(Q) if q not in planted]
        k = min(spec["extra_queries"], len(others))
        extra = [others[i] for i in r.choice(len(others), k, replace=False)]
        pairs[e] = planted + sorted(extra)
    return pairs


def reference_peaks(traffic, cfg: dict, pairs: dict, device,
                    precision: str = "float32") -> dict:
    """{(episode, query): [(position, height, prominence)]} by the plain
    reference, on ``device``."""
    ref = reference(cfg)
    lengths = [len(q) for q in traffic.queries]
    geo = ref.geometry(cfg, lengths)
    out = {}
    for e, queries in pairs.items():
        x = ref.dequantize(traffic.episodes[e], traffic.wire, device)
        wins = ref.windows(x, geo["chunk"], geo["window"])
        for q in queries:
            out[e, q] = ref.peaks_of(x, traffic.queries[q], geo, precision,
                                     wins)
        del x, wins
    return out


def compare(answers, refs: dict) -> dict:
    """``answers``: (episode, query, [(position, height, prominence)])
    triples as the program (or the control) returned them."""
    mismatches = peaks = 0
    h_gap = p_gap = 0.0
    for e, q, got in answers:
        want = refs.get((e, q))
        if want is None:
            continue
        if [p[0] for p in got] != [p[0] for p in want]:
            mismatches += 1
        at = {p[0]: p for p in want}
        for g in got:
            w = at.get(g[0])
            if w is not None:
                peaks += 1
                h_gap = max(h_gap, abs(g[1] - w[1]))
                p_gap = max(p_gap, abs(g[2] - w[2]))
    return {"position_mismatches": mismatches, "height_gap": h_gap,
            "prominence_gap": p_gap, "peaks_compared": peaks}


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, each number beside its limit)."""
    shown = {
        "position_mismatches": {"value": readings["position_mismatches"],
                                "limit": 0},
        "height_gap": {"value": readings["height_gap"],
                       "limit": limits["height_gap"]},
        "prominence_gap": {"value": readings["prominence_gap"],
                           "limit": limits["prominence_gap"]},
        "peaks_compared": {"value": readings["peaks_compared"],
                           "at_least": 1},
    }
    ok = (readings["position_mismatches"] == 0
          and readings["peaks_compared"] >= 1
          and math.isfinite(readings["height_gap"])
          and math.isfinite(readings["prominence_gap"])
          and readings["height_gap"] <= limits["height_gap"]
          and readings["prominence_gap"] <= limits["prominence_gap"])
    return ok, shown


def as_triples(peaks) -> list:
    """The program's ``Peak`` objects → (position, height, prominence)."""
    return [(int(p.position), float(p.height), float(p.prominence))
            for p in peaks]


def control(traffic, cfg: dict, pairs: dict, device) -> dict:
    """The control's readings: the reference computed in bfloat16, put in
    the program's place, against the reference in float32."""
    want = reference_peaks(traffic, cfg, pairs, device)
    got = reference_peaks(traffic, cfg, pairs, device, "bfloat16")
    return compare([(e, q, p) for (e, q), p in got.items()], want)


def free_device():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
