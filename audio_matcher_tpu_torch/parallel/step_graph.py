"""Captured CUDA graphs of the port's scan steps: the counterpart of the
JAX package's jit-compiled steps (``_match_episode_resident``,
``resident_match_step``, the spectrogram scan), compiled once per set of
static arguments and cached.

A :class:`StepGraphs` maps a key to a captured :class:`torch.cuda.CUDAGraph`
with its static inputs and outputs. The key is what the caller gives (the
arguments the JAX ``jit``\\ s take as static: chunk, window, fft_len, slab,
n_slabs, the impls, ...) plus the shape and dtype of every copied input,
the address, shape and dtype of every held input, and the device. A step
is a function of tensors that returns a tuple of tensors:

* the first call with a key runs the step eagerly: that run is the
  warm-up a capture needs (the kernels' twiddle tables, ``torch.fft``
  plans and the shared device constants are built there);
* the second captures it (``capture_error_mode="thread_local"``: a
  mesh's devices are issued by host threads of their own) and replays
  it; later calls replay.

Copied inputs (the staged rows, the row lengths, a scale) are copied into
the graph's own buffers before each replay, one device-to-device copy
each. Held inputs (the query state) are read in place: they are part of
the key and the graph keeps them alive, so their addresses cannot be
reused. A replay's outputs are copied out behind it, so that the next
replay of the same graph cannot overwrite outputs not yet read back (the
sweep dispatches one group ahead). Every kernel launch counted during the
capture is added to its wrapper's count on every replay.

The graphs of every cache of the process on one device share one memory
pool, and at most :data:`GRAPHS_PER_DEVICE` of them are kept a device
(the least recently used is dropped, its blocks going back to the pool):
a replay only writes the pool's blocks, and a device's replays are issued
one at a time on its current stream, each from the copy of its inputs to
the copy of its outputs, so the process holds about one step's work
planes however many scanners and matchers it keeps, as the eager steps
share the allocator's cache. Threads may call one cache on one device
if they share that device's stream. A live pool keeps every block any
graph was captured into, and the allocator can take them back only when
no graph of the pool is left: so when a cache's graphs go (it is cleared
or dropped), the device's other graphs go with them and the pool with
them; their keys are kept as seen, so each captures again on its next
call.

A capture that fails raises, and so does every later call of its key;
nothing falls back to the eager step. Tensors on a device that is not
graphed (the CPU) run the step eagerly.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import weakref
from typing import Callable, Sequence

import torch

from .. import _build

# Graphs kept a device in the process. A graph pins its static inputs
# and outputs (the staged rows: 0.32 GB for config #3's 4 x 1800 s
# mulaw8 group, 1.09 GB for fft_len 2^28's episode) on top of the shared
# pool, whose size is the largest step's work (8.6 GB of product planes
# at config #3, ~30 GB at fft_len 2^28); four covers the full and last
# groups of two staged shapes, or the matcher CLI's two at two rates.
GRAPHS_PER_DEVICE = 4
SEEN_PER_DEVICE = 64  # keys remembered as seen once (an eager run each)
GRAPHED_DEVICE_TYPES = ("cuda",)  # steps on other devices run eagerly

# one capture at a time in the process: a capture's set-up synchronizes
# the device and empties the allocator's cache, which another thread's
# capture must not see
_CAPTURE_LOCK = threading.Lock()


class CudaGraph:
    """One step captured as a :class:`torch.cuda.CUDAGraph` (tests put a
    stub with the same three methods in its place)."""

    _streams: dict = {}  # device → the side stream captures run on

    def __init__(self):
        self._graph = torch.cuda.CUDAGraph()

    def capture(self, run: Callable[[], tuple], device: torch.device, pool):
        """``run()`` captured on ``device``'s capture stream into ``pool``
        (None: a new pool) → its outputs. The device is synchronized and
        the allocator's cached blocks released first, so that the eager
        warm-up's blocks are not held beside the capture's. An error in
        ``run`` ends the capture and propagates."""
        with torch.cuda.device(device):
            stream = self._streams.get(device)
            if stream is None:
                stream = self._streams[device] = torch.cuda.Stream(device)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            with torch.cuda.stream(stream):
                self._graph.capture_begin(
                    pool, capture_error_mode="thread_local")
                try:
                    outputs = run()
                except BaseException:
                    # the capture is invalid; end it, keep run's error
                    with contextlib.suppress(RuntimeError):
                        self._graph.capture_end()
                    raise
                self._graph.capture_end()
        return outputs

    def replay(self) -> None:
        self._graph.replay()

    def pool(self):
        return self._graph.pool()


@dataclasses.dataclass
class _Graph:
    graph: object
    inputs: tuple  # the graph's own input buffers
    held: tuple  # read in place; kept alive for their addresses
    outputs: tuple
    launches: dict  # {wrapper: launches} of one replay


@dataclasses.dataclass
class _Device:
    """The graphs of one device, of every cache in the process, by (cache
    token, key), least recently used first."""
    graphs: collections.OrderedDict = dataclasses.field(
        default_factory=collections.OrderedDict)
    seen: collections.OrderedDict = dataclasses.field(
        default_factory=collections.OrderedDict)
    failed: set = dataclasses.field(default_factory=set)
    pool: object = None  # the memory pool the device's graphs share
    # held from a replay's input copies to its output copies
    replaying: threading.Lock = dataclasses.field(
        default_factory=threading.Lock)


_LOCK = threading.Lock()  # guards _DEVICES and every _Device in it
_DEVICES: dict = {}  # torch.device → _Device
_HOLDING = threading.local()  # .inside: this thread holds _LOCK
_DROPPED: list = []  # caches collected while their thread held _LOCK


@contextlib.contextmanager
def _locked():
    """``_LOCK``; the caches the garbage collector dropped inside it (their
    finalizers ran in this thread) are forgotten before it is let go."""
    with _LOCK:
        _HOLDING.inside = True
        try:
            yield
            while _DROPPED:
                _drop(_DROPPED.pop())
        finally:
            _HOLDING.inside = False


def _drop(token) -> None:
    for dev in _DEVICES.values():
        had_graphs = any(k[0] is token for k in dev.graphs)
        for keys in (dev.graphs, dev.seen):
            for full in [k for k in keys if k[0] is token]:
                del keys[full]
        dev.failed = {k for k in dev.failed if k[0] is not token}
        if had_graphs:
            # the pool's blocks go back only with its last graph
            for full in dev.graphs:
                dev.seen[full] = True
            dev.graphs.clear()
            while len(dev.seen) > SEEN_PER_DEVICE:
                dev.seen.popitem(last=False)
        if not dev.graphs:
            dev.pool = None


def _forget(token) -> None:
    """Drop the graphs and keys of the cache ``token``; on a device where
    it had graphs, the other graphs go too (their keys kept as seen), and
    the pool with them. A cache's finalizer calls it, possibly in a
    thread that holds the lock: then it is left to :func:`_locked`."""
    if getattr(_HOLDING, "inside", False):
        _DROPPED.append(token)
        return
    with _locked():
        _drop(token)


def _signature(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype


class StepGraphs:
    """The captured scan steps of one scanner or matcher.

    Its graphs live in the process's per-device store (see the module's
    text), under keys of its own; they go with :meth:`clear` or when the
    cache is dropped. ``stats`` counts the calls that ran eagerly on a
    key's first sight (``"first"``), the ``"captures"``, the replays of a
    graph captured by an earlier call (``"hits"``) and the graphs its
    captures pushed out of the store (``"evicted"``).
    """

    def __init__(self):
        self._token = object()
        self.stats = collections.Counter()
        weakref.finalize(self, _forget, self._token)

    def key(self, key, inputs: Sequence[torch.Tensor],
            held: Sequence[torch.Tensor] = ()) -> tuple:
        """The full key of a call: ``key``, the device, the copied inputs'
        shapes and dtypes and the held inputs' addresses, shapes and
        dtypes."""
        return (key, inputs[0].device,
                tuple(_signature(t) for t in inputs),
                tuple((t.data_ptr(),) + _signature(t) for t in held))

    def clear(self) -> None:
        """Drop this cache's graphs and the keys it has seen, which frees
        their buffers; on a device where it had graphs, the other caches'
        graphs go too (each captures again on its next call), and the
        device's pool with them. The next call of this cache's keys runs
        eagerly again."""
        _forget(self._token)

    def __call__(self, key, step: Callable[..., tuple],
                 inputs: Sequence[torch.Tensor],
                 held: Sequence[torch.Tensor] = ()) -> tuple:
        """``step(*inputs, *held)`` → a tuple of tensors: eagerly on a
        device that is not graphed and on a key's first sight, else by a
        replay of its graph (captured on its second sight; a key whose
        capture failed tries again, and raises again)."""
        device = inputs[0].device
        if device.type not in GRAPHED_DEVICE_TYPES:
            return tuple(step(*inputs, *held))
        full = (self._token, self.key(key, inputs, held))
        with _locked():
            dev = _DEVICES.setdefault(device, _Device())
            entry = dev.graphs.get(full)
            if entry is not None:
                dev.graphs.move_to_end(full)
            first = (entry is None and full not in dev.seen
                     and full not in dev.failed)
            if first:
                dev.seen[full] = True
                while len(dev.seen) > SEEN_PER_DEVICE:
                    dev.seen.popitem(last=False)
        if first:
            self.stats["first"] += 1
            return tuple(step(*inputs, *held))
        if entry is None:
            entry = self._capture(dev, full, device, step, inputs, held)
        else:
            self.stats["hits"] += 1
        return self._replay(dev, entry, inputs)

    def _capture(self, dev: _Device, full, device, step, inputs,
                 held) -> _Graph:
        """Capture ``step`` reading copies of ``inputs`` made for the graph,
        into the device's pool, recording its launches, and store it."""
        buffers = tuple(t.clone() for t in inputs)
        graph = CudaGraph()
        try:
            with _CAPTURE_LOCK, _build.recording_launches() as launches:
                with _locked():
                    pool = dev.pool
                outputs = tuple(graph.capture(
                    lambda: step(*buffers, *held), device, pool))
        except BaseException:
            with _locked():
                dev.failed.add(full)
            raise
        entry = _Graph(graph, buffers, tuple(held), outputs, dict(launches))
        with _locked():
            if dev.pool is None:
                dev.pool = graph.pool()
            dev.seen.pop(full, None)
            dev.failed.discard(full)
            dev.graphs[full] = entry
            while len(dev.graphs) > GRAPHS_PER_DEVICE:
                dev.graphs.popitem(last=False)
                self.stats["evicted"] += 1
        self.stats["captures"] += 1
        return entry

    @staticmethod
    def _replay(dev: _Device, entry: _Graph, inputs) -> tuple:
        """Copy ``inputs`` into the graph's buffers, replay it and copy its
        outputs out, with no other replay of the device issued between."""
        with dev.replaying:
            for buffer, t in zip(entry.inputs, inputs):
                buffer.copy_(t)
            entry.graph.replay()
            _build.add_launches(entry.launches)
            return tuple(o.clone() for o in entry.outputs)


def run_step(graphs: StepGraphs | None, key, step: Callable[..., tuple],
             inputs: Sequence[torch.Tensor],
             held: Sequence[torch.Tensor] = ()) -> tuple:
    """``step(*inputs, *held)`` through ``graphs``, or eagerly where the
    caller keeps no cache (``graphs=False``, the plain paths)."""
    if graphs is None:
        return tuple(step(*inputs, *held))
    return graphs(key, step, inputs, held)
