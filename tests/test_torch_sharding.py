"""The port's sharded scans, sweep and dry run against the JAX package's, on
meshes of 2, 4 and 8.

JAX runs on conftest's virtual CPU devices (Pallas in interpret mode),
the port on ``make_mesh(n, "cpu")`` with every kernel's plain version.
Shapes as ``tests/test_sharding.py``: sr 1000, 1 s chunks (8 s for
``vpu``, ``fft_len`` 2^14). The JAX package pads a group's rows to a
multiple of the mesh with silence; the port scans only the real rows, so
batches the mesh does not divide (3 episodes on 2 shards, 5 on 4) are
among the cases. Positions identical; heights and prominences within
1.2e-5 (2e-4 in spectrogram mode); label and ``.done.txt`` files equal
byte for byte. A sharded scan of the port equals its one-device scan
exactly.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audio_matcher_tpu.hostio.labels import (  # noqa: E402
    timelabel_from_peaks as jax_labels,
    write_labels as jax_write,
)
from audio_matcher_tpu.models.matcher import MatchConfig as JaxConfig  # noqa: E402
from audio_matcher_tpu.models.spectrogram import (  # noqa: E402
    SpectrogramConfig as JaxSpecConfig,
)
from audio_matcher_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from audio_matcher_tpu.parallel.sweep import (  # noqa: E402
    ShardedScanner as JaxScanner,
    ShardedSpectrogramScanner as JaxSpecScanner,
    sweep_archive as jax_sweep,
)

from audio_matcher_tpu_torch.hostio.decode import write_wav  # noqa: E402
from audio_matcher_tpu_torch.hostio.labels import (  # noqa: E402
    timelabel_from_peaks,
    write_labels,
)
from audio_matcher_tpu_torch.models.matcher import (  # noqa: E402
    MatchConfig,
    quantize_wire,
)
from audio_matcher_tpu_torch.models.spectrogram import SpectrogramConfig  # noqa: E402
from audio_matcher_tpu_torch.parallel import sweep as sweep_mod  # noqa: E402
from audio_matcher_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from audio_matcher_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from audio_matcher_tpu_torch.parallel.sweep import (  # noqa: E402
    ShardedRows,
    ShardedScanner,
    ShardedSpectrogramScanner,
    sweep_archive,
)

SR = 1000
TOL = 1.2e-5
TOL_SPEC = 2e-4


def _snippets(n_queries, seed=1234):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(m) * 0.2).astype(np.float32)
            for m in (SR // 2, SR // 4, 2 * SR // 5)[:n_queries]]


def _plant(e, secs):
    """Where episode ``e`` of ``secs`` s holds its plant, in samples: off
    the chunk seams."""
    return int(round(((1 + e % 3) * secs / 5 + 0.25) * SR))


def _episodes(snippets, n, secs, seed=99):
    """``n`` episodes of noise, episode e with query (e % Q) planted at
    :func:`_plant`."""
    rng = np.random.default_rng(seed)
    out = []
    for e in range(n):
        x = (rng.standard_normal(int(secs * SR)) * 0.05).astype(np.float32)
        snip = snippets[e % len(snippets)]
        x[_plant(e, secs) : _plant(e, secs) + len(snip)] = snip
        out.append(x)
    return out


def _assert_same(got, want, tol=TOL):
    """peaks[episode][query]: identical positions, scores within tol."""
    assert len(got) == len(want)
    for e, (ge, we) in enumerate(zip(got, want)):
        assert len(ge) == len(we)
        for q, (g, w) in enumerate(zip(ge, we)):
            assert [p.position for p in g] == [p.position for p in w], (e, q)
            for a, b in zip(g, w):
                assert abs(a.height - b.height) <= tol, (e, q)
                assert abs(a.prominence - b.prominence) <= tol, (e, q)


# fft_impl, peaks_impl, queries, wire, mesh size, episodes
RESIDENT = [
    ("vpu", "pallas", 3, "mulaw8", 8, 5),
    ("vpu", "pallas", 3, "int16", 2, 3),
    ("vpu", "pallas", 1, "int16", 4, 5),
    ("vpu", "pallas", 1, "mulaw8", 2, 3),
    ("xla_packed", "pallas", 2, "int16", 4, 5),
    ("xla", "jnp", 2, "mulaw8", 8, 3),
]


@pytest.mark.parametrize(
    "fft_impl,peaks_impl,n_q,wire,n_dev,n_ep", RESIDENT,
    ids=[f"{a}-{b}-q{c}-{d}-mesh{e}-e{f}" for a, b, c, d, e, f in RESIDENT])
def test_scan_resident_on_a_mesh_matches_jax(fft_impl, peaks_impl, n_q, wire,
                                             n_dev, n_ep):
    snippets = _snippets(n_q)
    episodes = [quantize_wire(x, wire)
                for x in _episodes(snippets, n_ep, 20.0)]
    kw = dict(chunk_secs=8.0, distance_secs=2.0, slab=2, block=256,
              transfer_dtype=wire, fft_impl=fft_impl, peaks_impl=peaks_impl)
    js = JaxScanner(snippets, SR, JaxConfig(**kw), mesh=jax_mesh(n_dev))
    assert js.fft_impl == fft_impl
    want = js.scan_resident(episodes)
    port_mesh = make_mesh(n_dev, "cpu")
    sharded = ShardedScanner(snippets, SR, MatchConfig(**kw),
                             device=port_mesh)
    staged = sharded.stage_resident(episodes)
    rows = staged[0]
    assert isinstance(rows, ShardedRows)
    per = -(-n_ep // n_dev)  # ceil(E / n) rows a shard, none to fill it
    assert [(a, b.shape[0]) for a, b in rows.blocks] == [
        (a, min(per, n_ep - a)) for a in range(0, n_ep, per)]
    got = sharded.scan_staged(staged)
    _assert_same(got, want)
    one = ShardedScanner(snippets, SR, MatchConfig(**kw), device="cpu")
    assert got == one.scan_resident(episodes)  # exactly the one-device scan
    for e in range(n_ep):  # the plants are found
        assert _plant(e, 20.0) in [p.position for p in got[e][e % n_q]]


def test_windows_scan_matches_jax_on_the_4x2_mesh():
    """The legacy windows path: [E, C, W] windows, E padded to the data
    extent and C to the seq extent, block (i, j) on devices[i][j]."""
    snippets = _snippets(2)
    episodes = _episodes(snippets, 5, 6.0)
    kw = dict(chunk_secs=1.0, distance_secs=2.0, block=256)
    mesh8 = make_mesh(8, "cpu")
    assert mesh8.shape == (4, 2)
    want = JaxScanner(snippets, SR, JaxConfig(**kw),
                      mesh=jax_mesh(8)).scan(episodes)
    scanner = ShardedScanner(snippets, SR, MatchConfig(**kw), device=mesh8)
    got = scanner.scan(episodes)
    _assert_same(got, want)
    one = ShardedScanner(snippets, SR, MatchConfig(**kw), device="cpu")
    assert one.scan(episodes) == got  # exactly the one-device scan
    _assert_same(scanner.scan(episodes, scale=False),
                 JaxScanner(snippets, SR, JaxConfig(**kw),
                            mesh=jax_mesh(8)).scan(episodes, scale=False))
    for e in range(5):
        assert _plant(e, 6.0) in [
            p.position for p in got[e][e % 2] if p.height > 0.5]


def test_spectrogram_scanner_on_a_mesh_matches_jax():
    snippets = _snippets(2)
    episodes = [quantize_wire(x, "int16")
                for x in _episodes(snippets, 5, 6.0)]
    kw = dict(n_fft=128, hop=32, n_mels=16, distance_secs=2.0,
              min_score=0.3, transfer_dtype="int16")
    want = JaxSpecScanner(snippets, SR, JaxSpecConfig(**kw),
                          mesh=jax_mesh(4)).scan_resident(episodes)
    sharded = ShardedSpectrogramScanner(snippets, SR, SpectrogramConfig(**kw),
                                        device=make_mesh(4, "cpu"))
    got = sharded.scan_resident(episodes)
    _assert_same(got, want, TOL_SPEC)
    one = ShardedSpectrogramScanner(snippets, SR, SpectrogramConfig(**kw),
                                    device="cpu")
    assert got == one.scan_resident(episodes)


def _archive(root, n_files, secs=6.0):
    snippets = _snippets(2, seed=5)
    paths = []
    for e, x in enumerate(_episodes(snippets, n_files, secs, seed=6)):
        paths.append(root / f"ep{e}.wav")
        write_wav(paths[-1], SR, x)
    return snippets, paths


def _sink(out_dir, labels_fn, write_fn):
    out_dir.mkdir(exist_ok=True)

    def sink(path, q, peaks):
        write_fn(labels_fn(peaks, SR, 7.0, "Segment #"),
                 out_dir / f"{path.stem}.q{q}.txt")

    return sink


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_sweep_on_a_mesh_matches_jax_with_resume(tmp_path):
    """Seven files on a mesh of 4 (groups of 4, a tail of 3): the JAX
    sweep's peaks, labels and ``.done.txt``; then a resume from a store
    that holds the first group rewrites the rest byte for byte."""
    snippets, paths = _archive(tmp_path, 7)
    kw = dict(chunk_secs=1.0, distance_secs=2.0, block=256,
              transfer_dtype="int16", fft_impl="xla_packed",
              peaks_impl="jnp")
    want = jax_sweep(paths, snippets, SR, JaxConfig(**kw), mesh=jax_mesh(4),
                     progress_path=tmp_path / "jax.done.txt",
                     write_labels_for=_sink(tmp_path / "jax", jax_labels,
                                            jax_write))

    def port(sink_dir):
        return sweep_archive(
            paths, snippets, SR, MatchConfig(**kw),
            device=make_mesh(4, "cpu"),
            progress_path=tmp_path / "port.done.txt",
            write_labels_for=_sink(sink_dir, timelabel_from_peaks,
                                   write_labels))

    got = port(tmp_path / "port")
    assert list(got) == list(want) == [str(p) for p in paths]
    for k in want:
        _assert_same([got[k]], [want[k]])
    done = (tmp_path / "port.done.txt").read_bytes()
    assert done == (tmp_path / "jax.done.txt").read_bytes()
    labels = _files(tmp_path / "port")
    assert labels == _files(tmp_path / "jax") and len(labels) == 14
    (tmp_path / "port.done.txt").write_bytes(
        b"".join(done.splitlines(keepends=True)[:4]))
    again = port(tmp_path / "resumed")
    assert list(again) == [str(p) for p in paths[4:]]
    assert (tmp_path / "port.done.txt").read_bytes() == done
    assert _files(tmp_path / "resumed") == {
        k: v for k, v in labels.items() if int(k[2]) >= 4}
    assert port(tmp_path / "resumed") == {}


def test_sweep_groups_fill_whole_mesh(tmp_path, monkeypatch):
    """Groups default to the mesh's size and an explicit size rounds up
    to a multiple of it: 8 files on 8 shards are one group; on 4 shards
    ``group_size=3`` gives groups of 4."""
    snippets, paths = _archive(tmp_path, 8, secs=4.0)
    batches = []
    orig = sweep_mod.ShardedScanner.stage_resident

    def spying(self, episodes, pad_to=None):
        batches.append(len(episodes))
        return orig(self, episodes, pad_to)

    monkeypatch.setattr(sweep_mod.ShardedScanner, "stage_resident", spying)
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, block=256,
                      fft_impl="xla_packed", peaks_impl="jnp")
    got = sweep_archive(paths, snippets, SR, cfg, device=make_mesh(8, "cpu"))
    assert batches == [8]
    batches.clear()
    again = sweep_archive(paths, snippets, SR, cfg,
                          device=make_mesh(4, "cpu"), group_size=3)
    assert batches == [4, 4]
    assert again == got
    for e, p in enumerate(paths):
        assert _plant(e, 4.0) in [pk.position for pk in got[str(p)][e % 2]]


def test_sweep_splits_files_over_processes(tmp_path, monkeypatch):
    """In a cluster of 2 each process sweeps every other file, from the
    path list alone, and resumes from its own store only what it owns:
    together they give the one-process sweep, no file twice."""
    snippets, paths = _archive(tmp_path, 5, secs=4.0)
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, block=256,
                      fft_impl="xla_packed", peaks_impl="jnp")
    whole = sweep_archive(paths, snippets, SR, cfg, device="cpu")
    monkeypatch.setattr(sweep_mod, "process_count", lambda: 2)
    merged = {}
    for rank in (0, 1):
        monkeypatch.setattr(sweep_mod, "process_index", lambda: rank)
        store = tmp_path / f"rank{rank}.done.txt"
        store.write_text(f"{paths[rank]} Done\n")  # an earlier run's first
        part = sweep_archive(paths, snippets, SR, cfg, device="cpu",
                             progress_path=store)
        assert list(part) == [str(p) for p in paths[rank + 2 :: 2]]
        assert not set(part) & set(merged)
        merged.update(part)
        assert store.read_text().splitlines() == [
            f"{p} Done" for p in paths[rank::2]]
    assert merged == {k: v for k, v in whole.items()
                      if k not in (str(paths[0]), str(paths[1]))}


@pytest.mark.parametrize("n_devices", [2, 8])
def test_dryrun_multichip(n_devices, capsys):
    line = dryrun_multichip(n_devices, "cpu")
    assert line.startswith("dryrun_multichip OK: mesh ")
    assert line in capsys.readouterr().out


def test_launch_counter_loses_no_update_across_threads():
    """A mesh's shards launch from a host thread each: the kernels' launch
    counts must not lose an increment (16 threads, a tiny switch
    interval)."""
    import sys
    import threading

    from audio_matcher_tpu_torch import _build

    class Kernel:
        launches = 0

    n_threads, n = 16, 2000

    def launch():
        for _ in range(n):
            _build.count_launch(Kernel)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert Kernel.launches == n_threads * n
