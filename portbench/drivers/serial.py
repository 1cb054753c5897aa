"""The matcher CLI's loop: one caller hands ``SnippetMatcher.match`` one
file at a time and waits for its offsets, as ``audio-matcher-torch``'s
``_match_pcm`` calls it (the whole host samples, ``scale=True``,
``n_samples`` the file's length, and a progress callback, so a file of
more than one slab takes the live path: groups of slabs, each read back
as it finishes). A request is one episode against one query; stage,
scan and collect run one after another, as in the CLI.

A matcher a query of the library (the CLI is run once a snippet: at the
configurations' one query, one matcher); the traffic's groups are walked
in order and each episode of a group is a request of its own (at
``max_rows`` 1, a group is one request)."""

from __future__ import annotations

import collections
import time

from audio_matcher_tpu_torch.models.matcher import MatchConfig, SnippetMatcher

from portbench import work
from portbench.check import as_triples
from portbench.generator import WIRE_BYTES


def _progress(phase: str, k: int) -> None:
    """The CLI's progress bar, without the bar."""


def build(ctx):
    """A matcher a query, on the one card, with graphs; each matches the
    first episode of each length twice (first sight, capture), so the
    window only replays."""
    if ctx.mix["devices"] != 1:
        raise ValueError("the serial driver runs on one device, as the "
                         "matcher CLI's --device names one")
    tr = ctx.traffic
    # the CLI's overlap: the snippet's length (with several queries the
    # longest, the library's windows that the reference scans)
    cfg = MatchConfig(**ctx.cfg["match"],
                      overlap_secs=max(map(len, tr.queries)) / tr.sr)
    matchers = [SnippetMatcher(q, tr.sr, cfg, device=ctx.where)
                for q in tr.queries]
    firsts = {len(e): e for e in reversed(tr.episodes)}.values()
    for m in matchers:
        for samples in firsts:
            for _ in range(2):
                _match(m, samples)
    return matchers


def _match(matcher, samples):
    return matcher.match(samples, scale=True, n_samples=len(samples),
                         progress=_progress)


def _graph_stats(matchers) -> collections.Counter:
    out = collections.Counter()
    for m in matchers:
        if m.step_graphs is not None:
            out.update(m.step_graphs.stats)
    return out


def window(matchers, ctx) -> dict:
    tr = ctx.traffic
    lengths = [len(q) for q in tr.queries]
    before = _graph_stats(matchers)
    items, answers = [], []
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    k = 0
    while not items or time.perf_counter() < deadline:
        for e in tr.group(k):
            samples = tr.episodes[e]
            for q, m in enumerate(matchers):
                with ctx.spans("request"):
                    peaks = _match(m, samples)
                F, B = work.scan_work(ctx.cfg, [lengths[q]], [len(samples)],
                                      WIRE_BYTES[tr.wire])
                answers.append((len(items), e, q, as_triples(peaks)))
                items.append({"episode": e, "F": F, "B": B,
                              "pair_hours": tr.seconds(e) / 3600.0})
        k += 1
    window_s = time.perf_counter() - t0
    after = _graph_stats(matchers)
    after.subtract(before)
    return {"window_s": window_s, "items": items, "answers": answers,
            "graph": dict(after), "seen": [i["episode"] for i in items]}


def release(matchers):
    """Drop the matchers' graphs (the caller drops the matchers)."""
    for m in matchers:
        if m.step_graphs is not None:
            m.step_graphs.clear()
