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
the graph's own buffers, which lie in its pool, before each replay, one
device-to-device copy each. Held inputs (the query state) are read in
place: they are part of the key and the graph keeps them alive, so their
addresses cannot be reused. A replay's outputs are copied out behind it,
so that the next replay of the same graph cannot overwrite outputs not
yet read back (the sweep dispatches one group ahead). Every kernel launch
counted during the capture is added to its wrapper's count on every
replay.

The graphs of every cache of the process on one device share one memory
pool, and at most :data:`GRAPHS_PER_DEVICE` of them are kept a device. A
replay only writes the pool's blocks, and a device's replays are issued
one at a time on its current stream, each from the copy of its inputs to
the copy of its outputs, so the live graphs hold about the largest
step's work planes however many scanners and matchers keep them.
Threads may call one cache on one device if they share that device's
stream.

A live pool keeps every block any graph was captured into; the allocator
takes them back only when no graph of the pool is left. So graphs leave a
device's store all together, and the pool with them: when a capture finds
the store full (an eviction), when a cache that kept a graph there is
cleared or dropped, and when a call runs out of device memory beside them
(below). Their keys are kept as seen, so each captures again on its next
call. The pool's memory is then the allocator's: :meth:`StepGraphs.clear`
and every capture empty its cache.

A step that fits on the card alone also runs after any other has been
graphed, as the JAX package's jitted steps, which hold no memory between
calls: a key's first sight, a capture, and the device allocation of a
scan's inputs (the staged rows, the query spectra) go through
:func:`releasing`. If one of them runs out of device memory while the
device holds graphs, the device's graphs and pool are released as above
and the call runs once more, the same step on the same device; a second
error, or one with no graph held, raises. This is the caching
allocator's own rule (it frees its cached blocks and tries again before
it raises), extended to the pool. Routing the eager first sights into
the pool instead would let a later replay write the blocks of any eager
tensor that outlived its step, with no error.

A capture that fails raises, and so does every later call of its key;
nothing falls back to the eager step. One that ran out of memory has not
failed: its key stays seen. A first sight that raises leaves its key
unseen. Tensors on a device that is not graphed (the CPU) run the step
eagerly.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import threading
import weakref
from typing import Callable, Sequence

import torch

from .. import _build
from ..utils import spans

# Graphs kept a device in the process. A graph pins its static inputs
# and outputs (the staged rows: 0.32 GB for config #3's 4 x 1800 s
# mulaw8 group, 1.09 GB for fft_len 2^28's episode) on top of the shared
# pool, whose size is the largest step's work (8.6 GB of product planes
# at config #3, ~30 GB at fft_len 2^28); four covers the full and last
# groups of two staged shapes, or the matcher CLI's two at two rates. A
# capture that finds four releases them all (see the module's text).
GRAPHS_PER_DEVICE = 4
SEEN_PER_DEVICE = 64  # keys remembered as seen once (an eager run each)
GRAPHED_DEVICE_TYPES = ("cuda",)  # steps on other devices run eagerly

log = logging.getLogger("audio_matcher_torch.step_graph")

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
        (None: a new pool) → its outputs. An error in ``run`` ends the
        capture and propagates."""
        with torch.cuda.device(device):
            stream = self._streams.get(device)
            if stream is None:
                stream = self._streams[device] = torch.cuda.Stream(device)
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
    released: int = 0  # releases of its graphs by calls out of memory
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


def _release(dev: _Device) -> int:
    """Let every graph of ``dev`` go, and the pool with them (a pool's
    blocks go back only with its last graph), keeping their keys as seen;
    → how many went. The caller holds ``_LOCK``."""
    n = len(dev.graphs)
    for full in dev.graphs:
        dev.seen[full] = True
    dev.graphs.clear()
    while len(dev.seen) > SEEN_PER_DEVICE:
        dev.seen.popitem(last=False)
    dev.pool = None
    return n


def _empty_cache() -> None:
    """Hand the allocator's free blocks, a released pool's among them, back
    to the device; not while another thread captures (its set-up
    empties the cache too, see :func:`_settle`)."""
    with _CAPTURE_LOCK:
        torch.cuda.empty_cache()


def _settle(device: torch.device) -> None:
    """Before a capture: synchronize a CUDA ``device`` and hand the
    allocator's free blocks back, so that the graph's buffers and pool are
    not carved out of segments that the warm-up or an older pool left
    cached (a segment goes back only when all of it is free)."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def _drop(token) -> None:
    for dev in _DEVICES.values():
        had_graphs = any(k[0] is token for k in dev.graphs)
        for keys in (dev.graphs, dev.seen):
            for full in [k for k in keys if k[0] is token]:
                del keys[full]
        dev.failed = {k for k in dev.failed if k[0] is not token}
        if had_graphs:
            _release(dev)


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


def releasing(device, run: Callable[[], object], stats=None):
    """``run()``; if it runs out of device memory while ``device``'s store
    holds graphs, they are released with their pool (their keys kept as
    seen), the allocator's cache emptied, and ``run()`` runs once more. A
    second error raises, and so does one with no graph held. The release
    is counted in ``stats["released"]`` (a cache's counts), if given, and
    logged."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        return run()
    except torch.cuda.OutOfMemoryError:
        with _locked():
            dev = _DEVICES.get(device)
            if dev is None or not dev.graphs:
                raise
            n = _release(dev)
            dev.released += 1
    # out of the handler: the failed run's frames, and the tensors they
    # held, are gone before the cache is emptied
    with spans.span("graph.release"):
        _empty_cache()
    if stats is not None:
        stats["released"] += 1
    log.warning("%s ran out of memory beside %d graphs: released them and "
                "their pool, running again", device, n)
    return run()


def _signature(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype


class StepGraphs:
    """The captured scan steps of one scanner or matcher.

    Its graphs live in the process's per-device store (see the module's
    text), under keys of its own; they go with :meth:`clear` or when the
    cache is dropped. ``stats`` counts the calls that ran eagerly on a
    key's first sight (``"first"``), the ``"captures"``, the replays of a
    graph captured by an earlier call (``"hits"``) and the graphs its
    captures pushed out of the store (``"evicted"``). Spans
    (``utils/spans.py``): ``graph.first``, ``graph.capture`` and a
    replay's ``graph.copy_in``, ``graph.launch`` (the graph's launch
    alone) and ``graph.copy_out``; :func:`releasing`'s ``graph.release``.
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
        device's pool with them, back to the device. The next call of this
        cache's keys runs eagerly again."""
        _forget(self._token)
        _empty_cache()

    def __call__(self, key, step: Callable[..., tuple],
                 inputs: Sequence[torch.Tensor],
                 held: Sequence[torch.Tensor] = ()) -> tuple:
        """``step(*inputs, *held)`` → a tuple of tensors: eagerly on a
        device that is not graphed and on a key's first sight, else by a
        replay of its graph (captured on its second sight; a key whose
        capture failed tries again, and raises again). A first sight and a
        capture run through :func:`releasing`."""
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
            try:
                with spans.span("graph.first"):
                    return releasing(
                        device, lambda: tuple(step(*inputs, *held)),
                        self.stats)
            except BaseException:
                with _locked():  # no warm-up ran: the next call is a first
                    dev.seen.pop(full, None)
                raise
        if entry is None:
            with spans.span("graph.capture"):
                entry = releasing(device, lambda: self._capture(
                    dev, full, device, step, inputs, held), self.stats)
        else:
            self.stats["hits"] += 1
        return self._replay(dev, entry, inputs)

    def _capture(self, dev: _Device, full, device, step, inputs,
                 held) -> _Graph:
        """Capture ``step`` reading buffers of ``inputs``' shapes made for
        the graph, into the device's pool, recording its launches, and
        store it. A full store is released first (an eviction) and the
        device settled, so that the old pool goes back first. The buffers
        are allocated inside the capture (no kernel is recorded for them):
        they lie in the pool and go back with it, and a replay's input
        copies fill them."""
        graph = CudaGraph()
        buffers = []

        def run():
            if not buffers:  # once: a stub graph reruns ``run`` to replay
                buffers.extend(torch.empty_like(t) for t in inputs)
            return step(*buffers, *held)

        with _CAPTURE_LOCK:
            with _locked():
                if len(dev.graphs) >= GRAPHS_PER_DEVICE:
                    self.stats["evicted"] += _release(dev)
                pool = dev.pool
            _settle(device)
            try:
                with _build.recording_launches() as launches:
                    outputs = tuple(graph.capture(run, device, pool))
            except torch.cuda.OutOfMemoryError:
                raise  # not a failed capture: its key stays seen
            except BaseException:
                with _locked():
                    dev.failed.add(full)
                raise
            entry = _Graph(graph, tuple(buffers), tuple(held), outputs,
                           dict(launches))
            with _locked():
                if dev.pool is None:
                    dev.pool = graph.pool()
                dev.seen.pop(full, None)
                dev.failed.discard(full)
                dev.graphs[full] = entry
        self.stats["captures"] += 1
        return entry

    @staticmethod
    def _replay(dev: _Device, entry: _Graph, inputs) -> tuple:
        """Copy ``inputs`` into the graph's buffers, replay it and copy its
        outputs out, with no other replay of the device issued between."""
        with dev.replaying:
            with spans.span("graph.copy_in"):
                for buffer, t in zip(entry.inputs, inputs):
                    buffer.copy_(t)
            with spans.span("graph.launch"):
                entry.graph.replay()
            _build.add_launches(entry.launches)
            with spans.span("graph.copy_out"):
                return tuple(o.clone() for o in entry.outputs)


def run_step(graphs: StepGraphs | None, key, step: Callable[..., tuple],
             inputs: Sequence[torch.Tensor],
             held: Sequence[torch.Tensor] = ()) -> tuple:
    """``step(*inputs, *held)`` through ``graphs``, or eagerly where the
    caller keeps no cache (``graphs=False``, the plain paths), through
    :func:`releasing`: other caches' graphs give way to it too."""
    if graphs is None:
        return releasing(inputs[0].device,
                         lambda: tuple(step(*inputs, *held)))
    return graphs(key, step, inputs, held)
