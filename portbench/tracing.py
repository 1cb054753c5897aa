"""Host spans around the calls into each layer, and the reading of a
``torch.profiler`` trace of the window: device busy time (the union of
kernel and copy intervals, per card), the kernels' summed time, the
longest device operations and the longest idle gaps, each named by the
host span it fell in."""

from __future__ import annotations

import collections
import contextlib
import time

import torch

SPAN_PREFIX = "pb."
NAME_CHARS = 80


class Spans:
    """Host wall seconds by span name. With ``traced``, each span is also a
    ``record_function`` range, so the profiler's trace carries it on the
    clock of the device's events."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = (torch.profiler.record_function(SPAN_PREFIX + name)
               if self.traced else contextlib.nullcontext())
        with ctx:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)


def _union(intervals):
    """Merged (start, end) intervals of a list, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def read_trace(prof, n_cards: int, window_name: str = "window") -> dict:
    """Reduce a profile whose window is the span ``window_name`` →
    {window_s, busy_s (mean over the ``n_cards`` cards used),
    busy_by_device, kernel_s (all cards), device_ops, idle_gaps,
    n_events}. Times in seconds."""
    window = None
    host = []
    device = collections.defaultdict(list)
    per_op = collections.Counter()
    kernel_us = 0.0
    cuda = torch.autograd.DeviceType.CUDA
    # the raw kineto events: prof.events() builds a tree of every event
    # first, minutes for a window of a few hundred thousand
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        a = ev.start_ns() / 1e3
        b = a + ev.duration_ns() / 1e3
        on_device = ev.device_type() == cuda
        if name.startswith(SPAN_PREFIX):
            # a span is listed on the host and again on the device's
            # timeline (a user annotation): only the host's counts
            if on_device:
                continue
            name = name[len(SPAN_PREFIX):]
            if name == window_name:
                window = (a, b)
            else:
                host.append((a, b, name))
        elif on_device:
            device[ev.device_index()].append((a, b))
            per_op[name[:NAME_CHARS]] += b - a
            if not _is_copy(name):
                kernel_us += b - a
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    busy, gaps = {}, []
    host.sort()
    for dev, ivs in device.items():
        merged = [[max(a, w0), min(b, w1)] for a, b in _union(ivs)
                  if b > w0 and a < w1]
        busy[dev] = sum(b - a for a, b in merged) / 1e6
        edges = [w0] + [x for iv in merged for x in iv] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((b - a, (a + b) / 2, dev))
    gaps = sorted(gaps, reverse=True)[:10]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(busy.values()) / n_cards,
        "busy_by_device": {str(d): s for d, s in busy.items()},
        "kernel_s": kernel_us / 1e6,
        "device_ops": [[n, us / 1e6] for n, us in per_op.most_common(10)],
        "idle_gaps": [[_label(host, mid) + (f" (card {dev})" if n_cards > 1
                                            else ""), us / 1e6]
                      for us, mid, dev in gaps],
        "n_events": sum(len(v) for v in device.values()),
    }


def _label(host, t: float) -> str:
    """The innermost host span at time ``t`` (the latest to start), or
    "host" when none is open."""
    best = None
    for a, b, name in host:
        if a > t:
            break
        if b >= t:
            best = name
    return best or "host"
