"""The step cache (``parallel/step_graph.py``) and the scan steps it
captures, on the CPU.

A CUDA graph needs the card, so the cache's bookkeeping is checked with a
stub graph that "captures" by running the step once and "replays" by
running it again into the captured outputs, with the CPU graphed (the
``stub`` fixture): the key, the first-sight eager run, the capture, the
copied inputs and outputs, the launch counts of a replay, a failed
capture, the eviction, the store the caches of a process share and the
release of a device's graphs for a call that ran out of memory beside
them. Then the steps as the graphs capture them (row lengths,
scales and frame counts as tensors, nothing read from the host) against
the JAX package on the CPU at ``test_torch_scan.py``'s and
``test_torch_spectrogram.py``'s small sizes, with their tolerances:
positions identical, heights and prominences within 1.2e-5 (the PCM
scans) and 2e-4 (spectrogram scores). GPU tests (``test_torch_gpu.py``)
hold the real graphs against the eager steps, bitwise.
"""

import gc
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audio_matcher_tpu.models import matcher as JM  # noqa: E402
from audio_matcher_tpu.models.matcher import MatchConfig as JaxConfig  # noqa: E402
from audio_matcher_tpu.models.spectrogram import (  # noqa: E402
    SpectrogramConfig as JaxSpecConfig,
)
from audio_matcher_tpu.parallel.mesh import make_mesh  # noqa: E402
from audio_matcher_tpu.parallel.sweep import ShardedScanner as JaxScanner  # noqa: E402
from audio_matcher_tpu.parallel.sweep import (  # noqa: E402
    ShardedSpectrogramScanner as JaxSpecScanner,
)

from audio_matcher_tpu_torch import _build  # noqa: E402
from audio_matcher_tpu_torch.models import matcher as TM  # noqa: E402
from audio_matcher_tpu_torch.models.matcher import (  # noqa: E402
    MatchConfig,
    SnippetMatcher,
    query_state_from_numpy,
    resident_match_step,
)
from audio_matcher_tpu_torch.models.spectrogram import (  # noqa: E402
    SpectrogramConfig,
)
from audio_matcher_tpu_torch.parallel import step_graph  # noqa: E402
from audio_matcher_tpu_torch.parallel.step_graph import StepGraphs  # noqa: E402
from audio_matcher_tpu_torch.parallel.sweep import (  # noqa: E402
    ShardedScanner,
    ShardedSpectrogramScanner,
    spectrogram_step,
)

SR = 8000
TOL = 1.2e-5  # tests/test_torch_scan.py
TOL_SPEC = 2e-4  # tests/test_torch_spectrogram.py
PLANTS = {0: [(0, 1.3), (2, 3.7)], 1: [(1, 2.2), (0, 4.05)]}


class StubGraph:
    """A graph's protocol on the CPU: ``capture`` runs the step once and
    keeps its outputs; ``replay`` runs it again into them, counting no
    launch (a replay runs no Python)."""

    replays = 0

    def capture(self, run, device, pool):
        self.run = run
        self.outputs = run()
        self.pool_handle = pool if pool is not None else object()
        return self.outputs

    def replay(self):
        StubGraph.replays += 1
        with _build.recording_launches():
            for out, new in zip(self.outputs, self.run()):
                out.copy_(new)

    def pool(self):
        return self.pool_handle


@pytest.fixture
def stub(monkeypatch):
    """The CPU graphed by :class:`StubGraph`, in a store of the test's
    own."""
    monkeypatch.setattr(step_graph, "CudaGraph", StubGraph)
    monkeypatch.setattr(step_graph, "GRAPHED_DEVICE_TYPES", ("cpu",))
    monkeypatch.setattr(step_graph, "_DEVICES", {})


def _store(device="cpu"):
    return step_graph._DEVICES[torch.device(device)]


def _graphs_kept(cache, device="cpu"):
    got = step_graph._DEVICES.get(torch.device(device))
    return sum(k[0] is cache._token for k in got.graphs) if got else 0


def _inputs():
    """tests/test_torch_scan.py's snippets and episodes."""
    rng = np.random.default_rng(2024)
    snippets = [(rng.standard_normal(m) * 0.2).astype(np.float32)
                for m in (4000, 3600, 3800)]
    episodes = []
    for e, secs in enumerate((6.5, 5.0)):
        x = (rng.standard_normal(int(secs * SR)) * 0.05).astype(np.float32)
        for q, at in PLANTS[e]:
            i = int(at * SR)
            x[i : i + len(snippets[q])] = snippets[q]
        episodes.append(x)
    return snippets, episodes


class _Keys(StepGraphs):
    """A stub cache that keeps the full key of every call."""

    def __init__(self):
        super().__init__()
        self.seen_keys = []

    def __call__(self, key, step, inputs, held=()):
        self.seen_keys.append(self.key(key, inputs, held))
        return super().__call__(key, step, inputs, held)


def _scan_key(snippets, episodes, **kw):
    scanner = ShardedScanner(snippets, SR, MatchConfig(chunk_secs=1.0, **kw),
                             device="cpu")
    scanner.step_graphs = keys = _Keys()
    scanner.scan_staged(scanner.stage_resident(episodes))
    (key,) = keys.seen_keys
    return key


def test_key_equal_for_equal_shapes_and_apart_for_each_static_part():
    """The full key: the caller's static part, the device, the copied
    inputs' shapes and dtypes, the held inputs' addresses and shapes.
    Two batches of equal shapes on one scanner share it; E, the staged
    width, Q, the wire and the slab each change it, in the part they
    belong to."""
    snippets, episodes = _inputs()
    scanner = ShardedScanner(snippets, SR, MatchConfig(chunk_secs=1.0),
                             device="cpu")
    scanner.step_graphs = keys = _Keys()
    rng = np.random.default_rng(5)
    other = [(rng.standard_normal(len(e)) * 0.05).astype(np.float32)
             for e in episodes]
    for batch in (episodes, other):
        scanner.scan_staged(scanner.stage_resident(batch))
    assert keys.seen_keys[0] == keys.seen_keys[1]
    base = keys.seen_keys[0]
    static, device, copied, held = base
    assert static[0] == "resident" and device == torch.device("cpu")
    assert [c[1] for c in copied] == [torch.float32, torch.int64,
                                      torch.float32]

    fewer = _scan_key(snippets, episodes[:1])  # E
    assert fewer[2][0][0][0] == 1 and fewer[2] != copied
    longer = _scan_key(snippets, [episodes[0],
                                  np.concatenate([episodes[0]] * 3)])
    assert longer[2][0][0][1] > copied[0][0][1]  # the staged width
    one = _scan_key(snippets[:1], episodes)  # Q: the scale's shape
    assert one[2][2][0] == (1,) and one[2] != copied
    wire = _scan_key(snippets, episodes, transfer_dtype="mulaw8")
    assert wire[2][0][1] == torch.uint8 and wire[0] == static
    whole = [np.concatenate([episodes[0]] * 5)[: 32 * SR]] * 2  # 32 windows
    slab = _scan_key(snippets, whole, slab=4, slab_auto=False)
    wide = _scan_key(snippets, whole)  # slab 8
    assert slab[0] != wide[0] and slab[2] == wide[2]


def _launching_step(wrapper, scale):
    def step(x, y):
        _build.count_launch(wrapper)
        return (x * scale + y, x.sum(dim=-1))
    return step


def _fake_wrapper():
    def wrapper():
        """A kernel wrapper's launch count, nothing else."""
    wrapper.launches = 0
    return wrapper


def test_first_sight_runs_eagerly_then_capture_then_replays_copy(stub):
    """A key's first call runs the step; the second captures it (its
    launches recorded, not counted) and replays; later calls replay. Each
    replay reads its own inputs (copied into the graph's buffers) and
    hands back outputs of its own (the next replay cannot touch them),
    and adds the capture's launches to the wrapper's count."""
    cache = StepGraphs()
    kernel = _fake_wrapper()
    step = _launching_step(kernel, 2.0)
    y = torch.ones(3)
    outs = []
    for k in range(4):
        x = torch.full((2, 3), float(k))
        outs.append(cache("k", step, (x,), (y,)))
        assert kernel.launches == k + 1
    assert dict(cache.stats) == {"first": 1, "captures": 1, "hits": 2}
    assert _graphs_kept(cache) == 1
    for k, (a, b) in enumerate(outs):
        assert torch.equal(a, torch.full((2, 3), 2.0 * k + 1))
        assert torch.equal(b, torch.full((2,), 3.0 * k))
    (entry,) = _store().graphs.values()
    assert all(o.data_ptr() != e.data_ptr()
               for out in outs for o, e in zip(out, entry.outputs))
    assert entry.launches == {kernel: 1}


def test_two_groups_dispatched_ahead_keep_their_own_outputs(stub):
    """Group g+1 is replayed before group g is read back (the sweep's
    one-ahead pipeline): group g's outputs are unchanged."""
    cache = StepGraphs()
    step = _launching_step(_fake_wrapper(), 1.0)
    y = torch.zeros(4)
    cache("k", step, (torch.zeros(1, 4),), (y,))  # first sight
    g0 = cache("k", step, (torch.ones(1, 4),), (y,))
    g1 = cache("k", step, (torch.full((1, 4), 5.0),), (y,))
    assert torch.equal(g0[0], torch.ones(1, 4))
    assert torch.equal(g1[0], torch.full((1, 4), 5.0))


def test_eviction_keeps_the_most_recent_graphs_and_one_pool(stub,
                                                            monkeypatch):
    """The graphs of a device share one pool. At ``GRAPHS_PER_DEVICE``
    graphs a device, a capture first lets every graph of the device go
    with the pool (a live pool keeps every block captured into it), their
    keys kept as seen: the store keeps the most recent graph, and a key
    that was evicted captures again on its next call, with no eager first
    sight."""
    monkeypatch.setattr(step_graph, "GRAPHS_PER_DEVICE", 2)
    cache = StepGraphs()
    step = _launching_step(_fake_wrapper(), 1.0)
    y = torch.zeros(2)
    for key in ("a", "b", "a"):
        for _ in range(2):
            cache(key, step, (torch.ones(2),), (y,))
    dev = _store()
    assert len({e.graph.pool() for e in dev.graphs.values()}) == 1
    pool = dev.pool
    for _ in range(2):
        cache("c", step, (torch.ones(2),), (y,))
    # a: first, capture; b: first, capture; a: 2 hits; c: first, capture
    # (a and b go)
    assert dict(cache.stats) == {"first": 3, "captures": 3, "hits": 2,
                                 "evicted": 2}
    assert [k[1][0] for k in dev.graphs] == ["c"] and dev.pool is not pool
    assert {k[1][0] for k in dev.seen} == {"a", "b"}
    cache("b", step, (torch.ones(2),), (y,))
    assert (cache.stats["first"], cache.stats["captures"]) == (3, 4)
    assert [k[1][0] for k in dev.graphs] == ["c", "b"]
    cache.clear()
    assert _graphs_kept(cache) == 0 and dev.pool is None
    cache("a", step, (torch.ones(2),), (y,))
    assert cache.stats["first"] == 4


def test_caches_of_a_process_share_one_store_a_device(stub, monkeypatch):
    """Every cache of the process keeps its graphs in one store a device:
    one pool, at most ``GRAPHS_PER_DEVICE`` graphs in all (a capture of
    any cache that finds them there releases every cache's graphs, their
    keys kept as seen), one key of two caches two graphs; a cache's graphs
    and keys go when it is dropped, and with them the device's other
    graphs (a live pool keeps every block captured into it) and the pool;
    their keys are kept as seen, so each captures again on its next
    call."""
    monkeypatch.setattr(step_graph, "GRAPHS_PER_DEVICE", 3)
    a, b = StepGraphs(), StepGraphs()
    step = _launching_step(_fake_wrapper(), 1.0)
    y = torch.zeros(2)
    for cache, key in ((a, "k"), (a, "j"), (b, "k")):
        for _ in range(2):
            cache(key, step, (torch.ones(2),), (y,))
    dev = _store()
    assert (_graphs_kept(a), _graphs_kept(b)) == (2, 1)
    assert len({e.graph.pool() for e in dev.graphs.values()}) == 1
    for _ in range(2):
        b("j", step, (torch.ones(2),), (y,))
    assert (_graphs_kept(a), _graphs_kept(b)) == (0, 1)
    assert b.stats["evicted"] == 3 and not a.stats["evicted"]
    a("j", step, (torch.ones(2),), (y,))  # kept as seen: captured
    assert (_graphs_kept(a), _graphs_kept(b)) == (1, 1)
    pool = dev.pool
    b("x", step, (torch.ones(2),), (y,))  # seen once, kept as seen
    del b, cache
    gc.collect()
    assert not dev.graphs and dev.pool is None
    assert [k[0] for k in dev.seen] == [a._token, a._token]
    a("k", step, (torch.ones(2),), (y,))
    assert (a.stats["first"], a.stats["captures"]) == (2, 4)
    assert _graphs_kept(a) == 1 and dev.pool is not pool
    a.clear()
    assert not dev.graphs and dev.pool is None


def test_a_cache_that_kept_no_graph_leaves_the_others_when_it_goes(stub):
    """A cache dropped with no graph on the device (its keys seen once,
    or none) takes no other cache's graph, nor the pool."""
    a, b = StepGraphs(), StepGraphs()
    step = _launching_step(_fake_wrapper(), 1.0)
    y = torch.zeros(2)
    for _ in range(2):
        a("k", step, (torch.ones(2),), (y,))
    b("k", step, (torch.ones(2),), (y,))  # seen once: no graph
    pool = _store().pool
    del b
    gc.collect()
    assert _graphs_kept(a) == 1 and _store().pool is pool
    a("k", step, (torch.ones(2),), (y,))
    assert dict(a.stats) == {"first": 1, "captures": 1, "hits": 1}


def test_threads_calling_one_graph_each_get_their_own_outputs(stub):
    """Two threads replay one graph of one cache at once, each with inputs
    of its own: every call returns the step of its own inputs, since a
    replay's input copies, the replay and its output copies are issued
    with no other replay of the device between."""
    cache = StepGraphs()

    def step(x, y):
        time.sleep(1e-4)  # room for the other thread between the copies
        return (x + y,)

    y = torch.zeros(3)
    for _ in range(2):
        cache("k", step, (torch.zeros(3),), (y,))
    start = threading.Barrier(2)
    wrong = []

    def calls(value):
        start.wait()
        for _ in range(40):
            (got,) = cache("k", step, (torch.full((3,), value),), (y,))
            if not torch.equal(got, torch.full((3,), value)):
                wrong.append((value, got.tolist()))

    threads = [threading.Thread(target=calls, args=(v,)) for v in (1.0, 2.0)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not wrong
    assert dict(cache.stats) == {"first": 1, "captures": 1, "hits": 80}


def test_a_cache_dropped_inside_the_store_lock_goes_after_it(stub):
    """A cache's finalizer may run in the garbage collector while its
    thread holds the store's lock: its graphs are dropped when the lock is
    let go, with no deadlock."""
    cache = StepGraphs()
    step = _launching_step(_fake_wrapper(), 1.0)
    y = torch.zeros(2)
    for _ in range(2):
        cache("k", step, (torch.ones(2),), (y,))
    with step_graph._locked():
        step_graph._forget(cache._token)  # as its finalizer would, here
        assert _graphs_kept(cache) == 1
    assert _graphs_kept(cache) == 0 and _store().pool is None


def test_a_failed_capture_raises_on_every_later_call(stub, monkeypatch):
    """A capture that raises keeps no graph and is not forgotten: every
    later call of its key captures again and raises again, also after
    ``SEEN_PER_DEVICE`` other keys; none runs the step eagerly in its
    place. Other keys go on."""

    class Refusing(StubGraph):
        def capture(self, run, device, pool):
            raise RuntimeError("operation not permitted when capturing")

    monkeypatch.setattr(step_graph, "CudaGraph", Refusing)
    cache = StepGraphs()
    ran = []

    def step(x):
        ran.append(True)
        return (x + 1,)

    x = torch.ones(2)
    assert torch.equal(cache("k", step, (x,))[0], torch.full((2,), 2.0))
    for _ in range(3):
        with pytest.raises(RuntimeError, match="capturing"):
            cache("k", step, (x,))
    for j in range(step_graph.SEEN_PER_DEVICE + 1):
        cache(("other", j), step, (x,))
    with pytest.raises(RuntimeError, match="capturing"):
        cache("k", step, (x,))
    assert len(ran) == 1 + step_graph.SEEN_PER_DEVICE + 1
    assert dict(cache.stats) == {"first": step_graph.SEEN_PER_DEVICE + 2}
    assert _graphs_kept(cache) == 0
    monkeypatch.setattr(step_graph, "CudaGraph", StubGraph)
    for _ in range(2):
        cache("k", step, (x,))
    assert cache.stats["captures"] == 1
    assert len(ran) == step_graph.SEEN_PER_DEVICE + 5


class _RunsOutOfMemory:
    """``step`` that raises out of device memory on the runs numbered in
    ``fail`` (from 0), as an allocation in an eager run or a capture
    does."""

    def __init__(self, step, fail=()):
        self.step, self.fail, self.runs = step, set(fail), 0

    def __call__(self, *args):
        self.runs += 1
        if self.runs - 1 in self.fail:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (stub)")
        return self.step(*args)


def _hold_a_graph(cache, y):
    for _ in range(2):
        cache("held", _launching_step(_fake_wrapper(), 1.0),
              (torch.ones(3),), (y,))


@pytest.mark.parametrize("errors", [1, 2])
@pytest.mark.parametrize("where", ["first sight", "capture"])
def test_out_of_memory_beside_a_graph_releases_it_and_runs_again(
        stub, where, errors):
    """A key's first sight or capture that runs out of device memory while
    the device holds a graph (another key's): the device's graphs go with
    their pool, their keys kept as seen, the release counted in the
    cache's and the device's counts, and the call runs once more, with
    the outputs of a call that had room. A second error raises. Neither
    marks the key failed: a capture that succeeded on its second run is
    replayed, one that did not captures again on the next call, as does a
    key whose first sight ran on its second run; a first sight that did
    not run is a first sight again."""
    cache = StepGraphs()
    y = torch.zeros(3)
    _hold_a_graph(cache, y)
    dev = _store()
    pool = dev.pool
    plain = _launching_step(_fake_wrapper(), 2.0)
    start = 0 if where == "first sight" else 1
    step = _RunsOutOfMemory(plain, range(start, start + errors))
    x = torch.full((2, 3), 3.0)
    want = plain(x, y)
    if where == "capture":
        cache("k", step, (x,), (y,))  # first sight
    full = (cache._token, cache.key("k", (x,), (y,)))
    if errors == 2:
        with pytest.raises(torch.cuda.OutOfMemoryError, match="stub"):
            cache("k", step, (x,), (y,))
    else:
        got = cache("k", step, (x,), (y,))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    replayed = where == "capture" and errors == 1  # the stub's replay runs
    unseen = where == "first sight" and errors == 2
    assert step.runs == start + 2 + replayed
    assert cache.stats["released"] == 1 and dev.released == 1
    assert full not in dev.failed
    held = [k for k in dev.seen if k[1][0] == "held"]
    assert len(held) == 1 and held[0] not in dev.graphs
    if errors == 1 and where == "capture":
        assert list(dev.graphs) == [full] and dev.pool is not pool
    else:
        assert not dev.graphs and dev.pool is None
        assert (full in dev.seen) != unseen
    before = dict(cache.stats)
    got = cache("k", step, (x,), (y,))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    kind = "hits" if replayed else "first" if unseen else "captures"
    assert cache.stats[kind] == before.get(kind, 0) + 1
    assert cache.stats["released"] == 1


def test_out_of_memory_with_no_graph_held_raises_at_once(stub):
    """With no graph on the device there is nothing to give way: a first
    sight, an eager step (``run_step`` with no cache) and an allocation
    through ``releasing`` that run out of memory raise on their first run,
    and nothing is counted as released."""
    cache = StepGraphs()
    y = torch.zeros(3)
    step = _RunsOutOfMemory(_launching_step(_fake_wrapper(), 1.0), [0])
    with pytest.raises(torch.cuda.OutOfMemoryError):
        cache("k", step, (torch.ones(3),), (y,))
    eager = _RunsOutOfMemory(_launching_step(_fake_wrapper(), 1.0), [0])
    with pytest.raises(torch.cuda.OutOfMemoryError):
        step_graph.run_step(None, "k", eager, (torch.ones(3),), (y,))
    alloc = _RunsOutOfMemory(lambda: torch.zeros(4), [0])
    with pytest.raises(torch.cuda.OutOfMemoryError):
        step_graph.releasing("cpu", alloc)
    assert (step.runs, eager.runs, alloc.runs) == (1, 1, 1)
    assert "released" not in cache.stats and _store().released == 0


def test_an_eager_step_and_an_allocation_make_the_graphs_give_way(stub):
    """The graphs give way to an eager step (``run_step`` with no cache, as
    ``graphs=False`` and the plain paths run) and to an allocation through
    ``releasing`` (a scan's staged rows, its query spectra) that ran out
    of memory beside them: released, their keys kept as seen, and the call
    runs once more."""
    cache = StepGraphs()
    y = torch.zeros(3)
    plain = _launching_step(_fake_wrapper(), 2.0)
    x = torch.full((2, 3), 3.0)
    for run in ("eager step", "allocation"):
        _hold_a_graph(cache, y)
        dev = _store()
        if run == "eager step":
            step = _RunsOutOfMemory(plain, [0])
            got = step_graph.run_step(None, "k", step, (x,), (y,))
            assert all(torch.equal(a, b) for a, b in zip(got, plain(x, y)))
        else:
            step = _RunsOutOfMemory(lambda: torch.ones(4), [0])
            assert torch.equal(step_graph.releasing("cpu", step),
                               torch.ones(4))
        assert step.runs == 2 and not dev.graphs and dev.pool is None
    assert dev.released == 2 and "released" not in cache.stats
    cache("held", plain, (torch.ones(3),), (y,))
    assert cache.stats["captures"] == 3  # kept as seen: no first sight


def test_held_inputs_are_keyed_by_address_and_kept_alive(stub):
    """A held input (the query state) is read in place: another tensor of
    the same shape is another key, and the graph keeps the one it read."""
    cache = StepGraphs()
    step = _launching_step(_fake_wrapper(), 1.0)
    x = torch.ones(2)
    y0, y1 = torch.zeros(2), torch.zeros(2)
    assert cache.key("k", (x,), (y0,)) != cache.key("k", (x,), (y1,))
    cache("k", step, (x,), (y0,))
    cache("k", step, (x,), (y0,))
    (entry,) = _store().graphs.values()
    assert entry.held[0] is y0


def test_cpu_tensors_run_eagerly_and_graphs_off_by_name():
    """The default cache graphs CUDA tensors only; ``graphs=False`` and
    ``plain=True`` leave the scanners and the matcher without a cache."""
    cache = StepGraphs()
    step = _launching_step(_fake_wrapper(), 1.0)
    for _ in range(3):
        cache("k", step, (torch.ones(2),), (torch.zeros(2),))
    assert not cache.stats and _graphs_kept(cache) == 0
    snippets, _ = _inputs()
    cfg = MatchConfig(chunk_secs=1.0)
    assert ShardedScanner(snippets, SR, cfg, device="cpu").step_graphs
    for kw in ({"graphs": False}, {"plain": True}):
        assert ShardedScanner(snippets, SR, cfg, device="cpu",
                              **kw).step_graphs is None
        assert SnippetMatcher(snippets[0], SR, cfg, device="cpu",
                              **kw).step_graphs is None
    assert ShardedSpectrogramScanner(snippets, SR, device="cpu",
                                     graphs=False).step_graphs is None


# ------------------------------------------ the steps against the JAX package
def _assert_raw(got, want):
    pos, h, prom = (np.asarray(a) for a in got)
    assert pos.shape == want[0].shape
    np.testing.assert_array_equal(np.isfinite(h), np.isfinite(want[1]))
    fin = np.isfinite(want[1])
    np.testing.assert_array_equal(pos[fin], want[0][fin])
    np.testing.assert_allclose(h[fin], want[1][fin], rtol=0, atol=TOL)
    np.testing.assert_allclose(prom[fin], want[2][fin], rtol=0, atol=TOL)


@pytest.mark.parametrize("n_queries", [1, 3])
@pytest.mark.parametrize("wire", ["mulaw8", "int16"])
def test_resident_step_on_tensors_matches_jax(wire, n_queries, stub):
    """``resident_match_step`` with the row lengths as an int64 tensor,
    the JAX scanner's query state and a stub graph's capture and replay:
    the JAX scanner's raw candidates, both wires, Q = 1 (window pairs)
    and Q = 3 (query pairs, the odd pad query)."""
    snippets, episodes = _inputs()
    snippets = snippets[:n_queries]
    kw = dict(chunk_secs=1.0, transfer_dtype=wire)
    js = JaxScanner(snippets, SR, JaxConfig(fft_impl="vpu",
                                            peaks_impl="pallas", **kw),
                    mesh=make_mesh(1))
    (pos, h, prom), _, _ = js.scan_dispatch(js.stage_resident(episodes))
    want = tuple(np.asarray(a) for a in (pos, h, prom))
    state = query_state_from_numpy(
        np.asarray(js._sample_f_resident[0]),
        np.asarray(js._sample_f_resident[1]), np.asarray(js._inv_ac),
        np.asarray(js._m), "cpu")
    scanner = ShardedScanner(snippets, SR, MatchConfig(**kw), device="cpu",
                             query_state=state)
    rows, ns, _ = scanner.stage_resident(episodes)
    n_pad = (rows.shape[1] - scanner.overlap) // scanner.chunk
    slab = TM.scan_slab(scanner.config, scanner.chunk, int(ns.max()), n_pad)
    step = resident_match_step(
        scanner.chunk, scanner.window, scanner.fft_len, scanner.valid,
        scanner.distance_samples, scanner.n_peaks, scanner.config.block,
        slab, n_pad // slab)
    ns_t = torch.from_numpy(ns.astype(np.int64))
    _assert_raw(step(rows, ns_t, state.t_r, state.t_i, state.inv_ac,
                     state.m), want)
    scanner.step_graphs = StepGraphs()
    for _ in range(3):  # first sight, capture + replay, replay
        _assert_raw(scanner.scan_dispatch((rows, ns, len(episodes)))[0],
                    want)
    assert dict(scanner.step_graphs.stats) == {"first": 1, "captures": 1,
                                               "hits": 1}


@pytest.mark.parametrize("wire", ["mulaw8", "int16"])
def test_episode_step_on_tensors_matches_jax(wire, stub):
    """The one resident step at Q = 1 with the length, the matcher's
    query state and its inverse autocorrelation as tensors (as
    ``match_staged`` runs it, through a stub graph) against the JAX
    matcher's ``_match_episode_resident``, and the final peaks."""
    snippets, episodes = _inputs()
    kw = dict(chunk_secs=1.0, distance_secs=1.0, transfer_dtype=wire)
    jm = JM.SnippetMatcher(snippets[0], SR, JaxConfig(
        fft_impl="vpu", peaks_impl="pallas", **kw))
    tm = SnippetMatcher(snippets[0], SR, MatchConfig(**kw), device="cpu")
    staged, j_staged = tm.stage(episodes[0]), jm.stage(episodes[0])
    n = staged[1]
    n_pad = (staged[0].shape[0] - tm.overlap) // tm.chunk
    B = TM.effective_slab(tm.config, -(-n // tm.chunk))
    static = dict(chunk=tm.chunk, window=tm.window, m=tm.snippet.m,
                  fft_len=tm.fft_len, valid_max=tm.valid,
                  distance=tm.distance_samples, n_peaks=tm.n_peaks,
                  block=tm.config.block, slab=B, n_slabs=n_pad // B)
    want = [np.asarray(a) for a in JM._match_episode_resident(
        JM._joined(j_staged[0]), n, jm._sample_f,
        np.float32(jm.snippet.inv_autocorr), fft_impl="vpu",
        peaks_impl="pallas", **static)]
    st = tm._query_state
    step = resident_match_step(
        tm.chunk, tm.window, tm.fft_len, tm.valid, tm.distance_samples,
        tm.n_peaks, tm.config.block, B, n_pad // B)
    got = step(staged[0][None], torch.tensor([n]), st.t_r, st.t_i,
               st.inv_ac, st.m)
    _assert_raw([a[0, 0] for a in got], want)
    tm.step_graphs = StepGraphs()
    peaks = [tm.match_staged(staged) for _ in range(3)]
    want_peaks = jm.match_staged(j_staged)
    for got_peaks in peaks:
        assert [p.position for p in got_peaks] == [
            p.position for p in want_peaks]
        for a, b in zip(got_peaks, want_peaks):
            assert abs(a.height - b.height) <= TOL
            assert abs(a.prominence - b.prominence) <= TOL
    assert tm.step_graphs.stats["hits"] == 1


@pytest.mark.parametrize("wire", ["mulaw8", "int16"])
def test_live_path_groups_replay_one_graph_and_match_jax(wire, stub):
    """The live-progress path (the matcher CLI's) scans each group of
    slabs on its own slice of the episode, so the full groups of every
    episode of one slab share one key: a matcher reused across episodes
    replays them. Its peaks equal the JAX matcher's live path (within
    TOL) and the port's one-call eager path (exactly); every window gets
    its "start" and "finish"."""
    snippets, episodes = _inputs()
    long = [np.concatenate([e] * 3) for e in episodes]  # 20 and 15 windows
    kw = dict(chunk_secs=1.0, distance_secs=1.0, transfer_dtype=wire,
              slab=4, slab_auto=False, progress_slabs_per_dispatch=2)
    jm = JM.SnippetMatcher(snippets[0], SR, JaxConfig(
        fft_impl="vpu", peaks_impl="pallas", **kw))
    tm = SnippetMatcher(snippets[0], SR, MatchConfig(**kw), device="cpu")
    eager = SnippetMatcher(snippets[0], SR, MatchConfig(**kw), device="cpu",
                           graphs=False)
    for ep in long + long:
        events = []
        got = tm.match_staged(tm.stage(ep),
                              progress=lambda p, k: events.append((p, k)))
        n_windows = -(-len(ep) // tm.chunk)
        for phase in ("start", "finish"):
            assert sorted(k for p, k in events if p == phase) == list(
                range(n_windows))
        assert got == eager.match_staged(eager.stage(ep))
        want = jm.match_staged(jm.stage(ep), progress=lambda p, k: None)
        assert [p.position for p in got] == [p.position for p in want]
        for a, b in zip(got, want):
            assert abs(a.height - b.height) <= TOL
            assert abs(a.prominence - b.prominence) <= TOL
    # 20 windows: groups of 8, 8, 4; 15 → 16: 8, 8. Two keys: the full
    # group's (first, capture, 5 hits) and the last (first, capture, hit)
    assert dict(tm.step_graphs.stats) == {"first": 2, "captures": 2,
                                          "hits": 6}


def _harmonic_snippet(secs):
    """test_torch_spectrogram.py's harmonic-rich snippet."""
    t = np.arange(int(secs * SR)) / SR
    x = sum(np.sin(2 * np.pi * f * t + p)
            for f, p in [(220, 0.1), (523, 1.0), (1397, 2.0)])
    env = np.minimum(1.0, 10 * t) * np.minimum(1.0, 10 * (secs - t))
    return (0.2 * x * env).astype(np.float32)


def test_spectrogram_step_on_tensors_matches_jax(stub):
    """``spectrogram_step`` with the row lengths and the queries' frame
    counts as tensors, the JAX scanner's query fingerprints and a stub
    graph: the JAX spectrogram scanner's peaks (test_torch_spectrogram.py's
    scan inputs, its first two episodes)."""
    rng = np.random.default_rng(42)
    snippets = [_harmonic_snippet(3.0), _harmonic_snippet(2.0)[::-1].copy()]
    episodes = []
    for secs, at in ((40, [(0, 6.0), (1, 19.0), (0, 30.0)]),
                     (25, [(1, 3.0), (0, 15.5)])):
        x = (rng.standard_normal(int(secs * SR)) * 0.05).astype(np.float32)
        for q, t in at:
            x[int(t * SR) : int(t * SR) + len(snippets[q])] += snippets[q]
        episodes.append(
            x + (rng.standard_normal(len(x)) * 0.05).astype(np.float32))
    kw = dict(distance_secs=10.0, transfer_dtype="int16", min_score=0.2)
    js = JaxSpecScanner(snippets, SR, JaxSpecConfig(**kw), make_mesh(1))
    want = js.scan_resident(episodes)
    cfg = SpectrogramConfig(**kw)
    scanner = ShardedSpectrogramScanner(snippets, SR, cfg, device="cpu",
                                        query_fps=js._snip_fps)
    rows, ns, n_real = scanner.stage_resident(episodes)
    fb, fps, widths = scanner._queries_on(rows.device)
    assert widths.dtype == torch.int64
    n_frames_pad = 1 + (rows.shape[1] - cfg.n_fft) // cfg.hop
    n_peaks = min((n_frames_pad - min(scanner.t_ss) + 1)
                  // scanner.distance_frames + 2, 64)
    step = spectrogram_step(cfg.n_fft, cfg.hop, scanner.t_ss,
                            scanner.distance_frames, n_peaks)
    raw = step(rows, torch.from_numpy(ns.astype(np.int64)), fb, fps, widths)
    scanner.step_graphs = StepGraphs()
    runs = [scanner._peaks([a.numpy() for a in raw], ns, n_real)] + [
        scanner.scan_resident(episodes) for _ in range(3)]
    for got in runs:
        for g_e, w_e in zip(got, want):
            for g, w in zip(g_e, w_e):
                assert [p.position for p in g] == [p.position for p in w]
                for a, b in zip(g, w):
                    assert abs(a.height - b.height) <= TOL_SPEC
                    assert abs(a.prominence - b.prominence) <= TOL_SPEC
    assert any(abs(p.position - 15.5 * SR) <= cfg.hop for p in want[1][0])
    assert scanner.step_graphs.stats["hits"] == 1
