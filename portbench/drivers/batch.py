"""The archive sweep's loop: groups of episodes through one long-lived
``ShardedScanner`` (on one card or a mesh), one group deep, as
``sweep_archive``'s ``flush``/``emit`` run it: stage group k+1, dispatch
its scan, then wait for and collect group k. A closed loop with one
caller."""

from __future__ import annotations

import collections
import time

from audio_matcher_tpu_torch.models.matcher import MatchConfig, side_stream
from audio_matcher_tpu_torch.parallel.sweep import ShardedScanner

from portbench import work
from portbench.check import as_triples
from portbench.generator import WIRE_BYTES


def build(ctx):
    """The scanner, its query state, and every group shape the traffic
    uses scanned once; the window's first shape twice (its capture)."""
    tr = ctx.traffic
    sc = ShardedScanner(tr.queries, tr.sr, MatchConfig(**ctx.cfg["match"]),
                        device=ctx.where)
    sc.query_state
    chunk = sc.chunk
    shapes = {}
    for k in range(len(tr.groups)):
        g = tr.group(k)
        shape = (len(g), max(-(-len(tr.episodes[e]) // chunk) for e in g))
        shapes.setdefault(shape, k)
    order = list(shapes.values()) + [0]
    for k in order:
        _collect(sc, _issue(sc, tr, k, ctx)[1], ctx)
    return sc


def _sync_uploads(sc):
    for d in sc.devices:
        if d.type == "cuda":
            side_stream(d).synchronize()


def _issue(sc, tr, k, ctx):
    eps = tr.group(k)
    with ctx.spans("stage"):
        staged = sc.stage_resident([tr.episodes[e] for e in eps])
        if ctx.traced:  # the span ends when the rows are on the card
            _sync_uploads(sc)
    with ctx.spans("dispatch"):
        dispatched = sc.scan_dispatch(staged)
    return eps, dispatched


def _collect(sc, dispatched, ctx):
    ready = dispatched[3]
    with ctx.spans("wait"):
        for r in (ready if isinstance(ready, list) else [ready]):
            if r is not None:
                r.synchronize()
    with ctx.spans("collect"):
        return sc.scan_collect(dispatched)


def window(sc, ctx) -> dict:
    tr = ctx.traffic
    Q = len(tr.queries)
    lengths = [len(q) for q in tr.queries]
    stats = collections.Counter(sc.step_graphs.stats if sc.step_graphs
                                else {})
    groups, answers = [], []
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    k = 0
    pending = _issue(sc, tr, k, ctx)
    while True:
        k += 1
        nxt = _issue(sc, tr, k, ctx) if time.perf_counter() < deadline \
            else None
        eps, dispatched = pending
        peaks = _collect(sc, dispatched, ctx)
        item = len(groups)
        F, B = work.scan_work(ctx.cfg, lengths,
                              [len(tr.episodes[e]) for e in eps],
                              WIRE_BYTES[tr.wire])
        groups.append({
            "episodes": eps, "F": F, "B": B,
            "pair_hours": sum(tr.seconds(e) for e in eps) / 3600.0 * Q,
        })
        for e, per_query in zip(eps, peaks):
            for q, pk in enumerate(per_query):
                answers.append((item, e, q, as_triples(pk)))
        if nxt is None:
            break
        pending = nxt
    window_s = time.perf_counter() - t0
    after = collections.Counter(sc.step_graphs.stats if sc.step_graphs
                                else {})
    after.subtract(stats)
    return {"window_s": window_s, "items": groups, "answers": answers,
            "graph": dict(after),
            "seen": [e for g in groups for e in g["episodes"]]}


def release(sc):
    """Drop the scanner's graphs (the caller drops the scanner)."""
    if sc.step_graphs is not None:
        sc.step_graphs.clear()
