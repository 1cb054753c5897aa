"""The port's archive sweep and its staging against the JAX package's, on
the CPU.

``stage_resident`` (with and without ``pad_to``) stages the JAX scanner's
array under each of its staging options; ``scale=False`` gives the JAX
scanner's unscaled peaks; ``sweep_archive`` over a wav archive (mixed
durations, groups of 2 with a tail, one corrupt file, one file at another
rate with and without ``resample_mismatched``) gives the JAX sweep's
results, label files and ``.done.txt`` byte for byte, and each file's
peaks equal a scan of that file alone; each group stages exactly its
decoded rows. A sweep stopped after its first
group resumes to the uninterrupted run's files. Shapes: sr 1000, 2 s
chunks on ``xla_packed`` + ``jnp`` (what ``auto`` picks on the CPU); one
sweep on the fused path (JAX: ``vpu`` + ``pallas`` in interpret mode, the
port: the kernels' plain versions) at sr 8000, ``fft_len`` 2^14.
Positions identical; heights and prominences within 1.2e-5.
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
from audio_matcher_tpu.models.matcher import StagingArena as JaxArena  # noqa: E402
from audio_matcher_tpu.models.matcher import _joined  # noqa: E402
from audio_matcher_tpu.parallel.mesh import make_mesh  # noqa: E402
from audio_matcher_tpu.parallel.sweep import ShardedScanner as JaxScanner  # noqa: E402
from audio_matcher_tpu.parallel.sweep import sweep_archive as jax_sweep  # noqa: E402

from audio_matcher_tpu_torch.hostio.decode import read_audio, write_wav  # noqa: E402
from audio_matcher_tpu_torch.hostio.labels import (  # noqa: E402
    timelabel_from_peaks,
    write_labels,
)
from audio_matcher_tpu_torch.models.matcher import (  # noqa: E402
    MatchConfig,
    quantize_wire,
)
from audio_matcher_tpu_torch.parallel.sweep import (  # noqa: E402
    ShardedScanner,
    sweep_archive,
)

SR = 1000
TOL = 1.2e-5
KW = dict(chunk_secs=2.0, distance_secs=2.0, fft_impl="xla_packed",
          peaks_impl="jnp")


def _snippets(rng, sr=SR):
    return [(rng.standard_normal(m) * 0.2).astype(np.float32)
            for m in (sr // 2, sr // 3)]


def _episode(rng, secs, snippets, at, sr=SR):
    x = (rng.standard_normal(int(secs * sr)) * 0.05).astype(np.float32)
    for q, t in at:
        i = int(t * sr)
        x[i : i + len(snippets[q])] = snippets[q]
    return x


def _assert_same(got, want, scale=(1.0, 1.0)):
    """peaks[query] lists: identical positions, values within TOL (after
    ``scale`` per query, for unscaled correlations)."""
    assert len(got) == len(want)
    for q, (g, w) in enumerate(zip(got, want)):
        assert [p.position for p in g] == [p.position for p in w], (q, g, w)
        for a, b in zip(g, w):
            assert abs(a.height - b.height) * scale[q] <= TOL
            assert abs(a.prominence - b.prominence) * scale[q] <= TOL


def _archive(tmp_path):
    """Mixed durations, one corrupt file and one at 500 Hz, in sorted order:
    with groups of 2 the corrupt file shares a group and the tail is one
    file."""
    rng = np.random.default_rng(77)
    snippets = _snippets(rng)
    plans = {
        "e0": (9.0, [(0, 1.0), (1, 3.5), (0, 6.2)]),
        "e1": (4.5, [(1, 0.7), (0, 2.9)]),
        "e2": (13.0, [(0, 2.0), (0, 8.0), (1, 11.1)]),
        "e3": (6.0, [(0, 1.99), (1, 4.0)]),  # a plant across a chunk seam
        "e5": (7.0, [(1, 1.5), (0, 5.0)]),
    }
    paths = []
    for name, (secs, at) in plans.items():
        write_wav(tmp_path / f"{name}.wav", SR, _episode(rng, secs, snippets,
                                                          at))
        paths.append(tmp_path / f"{name}.wav")
    (tmp_path / "e4_corrupt.wav").write_bytes(rng.bytes(3000))
    slow = _episode(rng, 6.0, [s[::2] for s in snippets], [(0, 2.0)], 500)
    write_wav(tmp_path / "e6_500hz.wav", 500, slow)
    paths.insert(4, tmp_path / "e4_corrupt.wav")
    paths.append(tmp_path / "e6_500hz.wav")
    return snippets, paths


def _label_sink(out_dir, labels_fn, write_fn):
    out_dir.mkdir(exist_ok=True)

    def sink(path, q, peaks):
        write_fn(labels_fn(peaks, SR, 7.0, "Segment #"),
                 out_dir / f"{path.stem}.q{q}.txt")

    return sink


@pytest.mark.parametrize("resample", [False, True])
@pytest.mark.parametrize("wire", ["int16", "mulaw8", "float32"])
def test_sweep_matches_jax(tmp_path, wire, resample):
    snippets, paths = _archive(tmp_path)
    kw = dict(KW, transfer_dtype=wire)
    want = jax_sweep(
        paths, snippets, SR, JaxConfig(**kw), mesh=make_mesh(1),
        progress_path=tmp_path / "jax.done.txt",
        write_labels_for=_label_sink(tmp_path / "jax", jax_labels, jax_write),
        resample_mismatched=resample, group_size=2,
    )
    got = sweep_archive(
        paths, snippets, SR, MatchConfig(**kw), device="cpu",
        progress_path=tmp_path / "port.done.txt",
        write_labels_for=_label_sink(tmp_path / "port", timelabel_from_peaks,
                                     write_labels),
        resample_mismatched=resample, group_size=2,
    )
    assert list(got) == list(want)
    assert ("e6_500hz" in "".join(got)) == resample
    assert not any("corrupt" in k for k in got)
    for k in want:
        _assert_same(got[k], want[k])
    assert ((tmp_path / "port.done.txt").read_bytes()
            == (tmp_path / "jax.done.txt").read_bytes())
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(files) == 2 * len(want)
    for name in files:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    # a group padded to its longest episode scans each file as alone
    scanner = ShardedScanner(snippets, SR, MatchConfig(**kw), device="cpu")
    for p in paths[:4]:
        if p.name != "e4_corrupt.wav":
            alone = scanner.scan_resident([read_audio(p)[1]])[0]
            _assert_same(got[str(p)], alone)
    assert [pk.position for pk in got[str(paths[3])][0]] == [1990]


def test_sweep_resumes_after_an_interruption(tmp_path):
    """A sweep stopped inside its second group's collection (its label sink
    raises there) leaves the first group Done; the rerun scans the rest,
    and its labels and ``.done.txt`` equal an uninterrupted run's."""
    snippets, paths = _archive(tmp_path)
    cfg = MatchConfig(**KW, transfer_dtype="int16")
    done = tmp_path / ".done.txt"
    out = tmp_path / "labels"

    def run(sink):
        return sweep_archive(paths, snippets, SR, cfg, device="cpu",
                             progress_path=done, write_labels_for=sink,
                             group_size=2)

    sink = _label_sink(out, timelabel_from_peaks, write_labels)
    full = run(sink)
    want = {p.name: p.read_bytes() for p in out.iterdir()}
    want_done = done.read_bytes()
    assert len(full) == 5 and want_done.count(b"Done") == 5
    done.unlink()
    for p in out.iterdir():
        p.unlink()

    class Stop(Exception):
        pass

    def stopping(path, q, peaks):
        if path.name == "e2.wav":  # the first file of the second group
            raise Stop
        sink(path, q, peaks)

    with pytest.raises(Stop):
        run(stopping)
    assert done.read_text().splitlines() == [
        f"{paths[0]} Done", f"{paths[1]} Done"]
    assert sorted(p.name for p in out.iterdir()) == [
        "e0.q0.txt", "e0.q1.txt", "e1.q0.txt", "e1.q1.txt"]
    rest = run(sink)
    assert set(rest) == set(full) - {str(paths[0]), str(paths[1])}
    assert done.read_bytes() == want_done
    assert {p.name: p.read_bytes() for p in out.iterdir()} == want
    assert run(sink) == {}  # everything Done: nothing is scanned


def test_sweep_on_the_fused_path_matches_jax(tmp_path):
    """``vpu`` + ``pallas`` (JAX in interpret mode) at fft_len 2^14: three
    files in groups of 2, mulaw8."""
    sr = 8000
    rng = np.random.default_rng(8)
    snippets = [(rng.standard_normal(m) * 0.2).astype(np.float32)
                for m in (4000, 3600)]
    paths = []
    for e, (secs, at) in enumerate(((3.5, [(0, 0.4), (1, 2.2)]),
                                    (2.5, [(1, 1.1)]),
                                    (3.0, [(0, 1.5)]))):
        write_wav(tmp_path / f"f{e}.wav", sr,
                  _episode(rng, secs, snippets, at, sr))
        paths.append(tmp_path / f"f{e}.wav")
    kw = dict(chunk_secs=1.0, transfer_dtype="mulaw8")
    jcfg = JaxConfig(fft_impl="vpu", peaks_impl="pallas", **kw)
    assert JaxScanner(snippets, sr, jcfg, mesh=make_mesh(1)).fft_len == 1 << 14
    want = jax_sweep(paths, snippets, sr, jcfg, mesh=make_mesh(1),
                     group_size=2)
    got = sweep_archive(paths, snippets, sr, MatchConfig(**kw),
                        device="cpu", group_size=2)
    assert list(got) == list(want) == [str(p) for p in paths]
    for k in want:
        _assert_same(got[k], want[k])
    assert [p.position for p in got[str(paths[1])][1]] == [int(1.1 * sr)]


def test_sweep_refuses_what_is_not_ported(tmp_path):
    snippets, paths = _archive(tmp_path)
    with pytest.raises(NotImplementedError, match="P5"):
        sweep_archive(paths, snippets, SR, device="cpu", mode="spectrogram")
    with pytest.raises(NotImplementedError, match="P7"):
        sweep_archive(paths, snippets, SR, device=["cpu", "cpu"])
    cfg = MatchConfig(**KW, resample_impl="device")
    with pytest.raises(NotImplementedError, match="P6"):
        sweep_archive(paths[-1:], snippets, SR, cfg, device="cpu",
                      resample_mismatched=True)


def _stage_inputs(wire):
    rng = np.random.default_rng(12)
    snippets = _snippets(rng)
    episodes = [quantize_wire(_episode(rng, secs, snippets, [(0, 1.0)]), wire)
                for secs in (9.0, 4.5, 7.25)]
    return snippets, episodes


@pytest.mark.parametrize("wire", ["int16", "mulaw8", "float32"])
def test_stage_resident_matches_jax(wire):
    """With and without ``pad_to``, for a longer and then a shorter group:
    the JAX scanner's staged array and ``ns`` under each of its staging
    options (both ``pad_rows``, fresh and through a reused arena, which
    all stage the same array)."""
    snippets, episodes = _stage_inputs(wire)
    kw = dict(KW, transfer_dtype=wire)
    js = JaxScanner(snippets, SR, JaxConfig(**kw), mesh=make_mesh(1))
    scanner = ShardedScanner(snippets, SR, MatchConfig(**kw), device="cpu")
    jax_arena = JaxArena(wire)
    for group, pad_to in ((episodes, None), (episodes[:2], 4),
                          (episodes[1:2], 4), (episodes, 5)):
        rows, ns, n_real = scanner.stage_resident(group, pad_to)
        assert n_real == len(group)
        for pad_rows in ("host", "device"):
            for arena in (None, jax_arena):
                want_dev, want_ns, want_real = js.stage_resident(
                    group, arena, pad_to, pad_rows)
                want = np.asarray(_joined(want_dev, rows=len(want_ns)))
                assert rows.numpy().dtype == want.dtype
                np.testing.assert_array_equal(rows.numpy(), want)
                np.testing.assert_array_equal(ns, np.asarray(want_ns))
                assert want_real == n_real


def test_sweep_stages_only_the_decoded_rows(tmp_path, monkeypatch):
    """Groups of 2 over the archive (a corrupt file in the second group, a
    tail of one): each group stages its decoded rows and no silence row,
    and every staged row is scanned as a real episode."""
    snippets, paths = _archive(tmp_path)
    staged_rows = []
    dispatch = ShardedScanner.scan_dispatch

    def spying(self, staged, scale=True):
        rows, ns, n_real = staged
        staged_rows.append((rows.shape[0], len(ns), n_real))
        return dispatch(self, staged, scale)

    monkeypatch.setattr(ShardedScanner, "scan_dispatch", spying)
    got = sweep_archive(paths, snippets, SR,
                        MatchConfig(**KW, transfer_dtype="int16"),
                        device="cpu", group_size=2)
    assert len(got) == 5
    assert staged_rows == [(2, 2, 2), (2, 2, 2), (1, 1, 1)]


@pytest.mark.parametrize("impl", ["xla_packed", "vpu"])
def test_unscaled_peaks_match_jax(impl):
    """``scale=False`` on ``scan_staged`` and ``scan_resident``: the JAX
    scanner's unscaled peaks (compared after the inverse autocorrelation,
    so that the tolerance means what it means on scaled scores)."""
    rng = np.random.default_rng(21)
    if impl == "vpu":  # the fused path at fft_len 2^14
        sr, kw = 8000, dict(chunk_secs=1.0, peaks_impl="pallas")
        snippets = [(rng.standard_normal(m) * 0.2).astype(np.float32)
                    for m in (4000, 3600)]
    else:
        sr, kw = SR, dict(KW)
        snippets = _snippets(rng)
    kw["fft_impl"] = impl
    episodes = [_episode(rng, 5.0, snippets, [(0, 1.0), (1, 3.1)], sr),
                _episode(rng, 3.0, snippets, [(1, 0.5)], sr)]
    js = JaxScanner(snippets, sr, JaxConfig(**kw), mesh=make_mesh(1))
    want = js.scan_resident(episodes, scale=False)
    scanner = ShardedScanner(snippets, sr, MatchConfig(**kw), device="cpu")
    got = scanner.scan_staged(scanner.stage_resident(episodes), scale=False)
    inv = [q.inv_autocorr for q in scanner.queries]
    for e in range(len(episodes)):
        _assert_same(got[e], want[e], scale=inv)
    assert got == scanner.scan_resident(episodes, scale=False)
    assert int(3.1 * sr) in [p.position for p in got[0][1]]
