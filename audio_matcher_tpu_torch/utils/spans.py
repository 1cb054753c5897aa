"""Spans at the port's layer boundaries, on the profiler's clock.

A span is on exactly while a ``torch.profiler`` profile runs in the
calling thread (the profiler's own enabled state, which is kept per
thread): the benchmark's traced window, the CLIs' ``--xprof``. Off,
:func:`span` does one check and returns a shared null context: nothing
is allocated and no clock is read.

On, a span is a ``_RecordFunctionFast`` range named ``audio_matcher.<name>``,
which the profiler's trace lists as a ``cpu_op`` and does not mirror onto
the device's timeline (a ``record_function`` range is a
``user_annotation``, which it does mirror, and which a reader of device
time would count as device work). It is also a :class:`Record` in memory:
its name, its parent (the innermost span open in the thread), the thread,
its group (the scanner's sequence number of a staged group; a span given
none takes its parent's) and ``time.time_ns()`` at its start and end, the
clock of the profiler's host events. Nothing is exported: :func:`records`
hands the records to a reader, and the profiler's own trace carries the
ranges. Time on the card is the profiler's to read, from its device
events.

Each thread keeps the records of its own latest profiled interval (at
most ``CAP``): the first span a thread opens with the profiler on, after
one it opened with the profiler off, clears that thread's older records
and no other thread's. A card's issue thread, where the profiler is off,
records into the store of the thread that handed it the work
(:func:`sink`, :func:`issue_span`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast

PREFIX = "audio_matcher."
CAP = 1 << 16  # records a thread keeps; a traced window makes ~15 a group

_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_LOCAL = threading.local()  # .stack: open spans; .off: a span opened off;
#                             .records: closed spans of the latest interval


@dataclasses.dataclass
class Record:
    """One closed span. ``device`` names the card an issue thread's span
    issued to, else None."""

    name: str
    parent: str | None
    thread: int
    group: int | None
    t0_ns: int
    t1_ns: int
    device: str | None = None


class Grouped(tuple):
    """A tuple that carries the sequence number of its group (``group``):
    a scanner's staged triple and dispatched quadruple, so that the
    stage, dispatch and collect spans of one group share the number."""

    def __new__(cls, items, group: int | None):
        self = super().__new__(cls, items)
        self.group = group
        return self


def group_of(value) -> int | None:
    """The group number ``value`` carries (None for a plain tuple)."""
    return getattr(value, "group", None)


def _local(name: str, make):
    value = getattr(_LOCAL, name, None)
    if value is None:
        value = make()
        setattr(_LOCAL, name, value)
    return value


def _interval() -> collections.deque:
    """This thread's store of records, cleared when a profiled interval
    opens (the thread's last span opened with the profiler off)."""
    store = _local("records", lambda: collections.deque(maxlen=CAP))
    if getattr(_LOCAL, "off", True):
        _LOCAL.off = False
        store.clear()
    return store


class _Span:
    __slots__ = ("name", "parent", "group", "device", "sink", "range", "t0")

    def __init__(self, name: str, group, device, sink):
        stack = _local("stack", list)
        top = stack[-1] if stack else None
        self.name = name
        self.parent = top and top.name
        self.group = top.group if top and group is None else group
        self.device = device
        self.sink = sink

    def __enter__(self):
        self.range = _RecordFunctionFast(PREFIX + self.name)
        self.range.__enter__()
        _LOCAL.stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _LOCAL.stack.pop()
        self.range.__exit__(*exc)
        self.sink.append(Record(self.name, self.parent, threading.get_ident(),
                                self.group, self.t0, t1, self.device))
        return False


def enabled() -> bool:
    """Whether spans are on in this thread: a profiler runs in it."""
    return _enabled()


def span(name: str, group: int | None = None):
    """A host span ``name`` (without the prefix) around a ``with`` block,
    while the profiler runs in this thread; else the shared null
    context."""
    if not _enabled():
        _LOCAL.off = True
        return _NULL
    return _Span(name, group, None, _interval())


def sink():
    """This thread's store of records while the profiler runs in it, to
    hand to :func:`issue_span` in a thread of its own; else None."""
    return _interval() if _enabled() else None


def issue_span(into, name: str, group: int | None, device):
    """A host span in a thread of its own that issues to the card
    ``device``, recorded ``into`` the handing thread's :func:`sink`: the
    profiler's state is per thread, so the handing thread's decides."""
    if into is None:
        return _NULL
    return _Span(name, group, str(device), into)


def records() -> list[Record]:
    """The closed spans of this thread's latest profiled interval, in the
    order they closed."""
    return list(getattr(_LOCAL, "records", ()))
