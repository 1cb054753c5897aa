"""The port's spectrogram mode (BASELINE config #4) against the JAX
package's, on the CPU.

``SpectrogramMatcher``: positions equal, heights and prominences within
2e-4 (the NCC tolerance of the JAX package's ``tests/test_spectrogram.py``);
a short episode gives no match. ``ShardedSpectrogramScanner`` on 4
episodes with each staging wire, with the JAX scanner's query fingerprints
carried across and with its own: positions equal, heights within 2e-4; its
staged width is ``spectrogram_pad_width``, the JAX function's on the JAX
package's cases. ``sweep_archive(mode="spectrogram")`` (groups of 2, a
corrupt file, one at another rate resampled) and both CLIs with ``--mode
spectrogram``: label files and ``.done.txt`` byte for byte, a resume too.
Shapes: sr 8000 (16000 for the matcher), n_fft 1024, hop 256, 64 mels.
"""

import logging
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audio_matcher_tpu.cli import matcher_cli as jax_matcher_cli  # noqa: E402
from audio_matcher_tpu.cli import sweep_cli as jax_sweep_cli  # noqa: E402
from audio_matcher_tpu.hostio.labels import (  # noqa: E402
    timelabel_from_peaks as jax_labels,
    write_labels as jax_write,
)
from audio_matcher_tpu.models import spectrogram as jspec  # noqa: E402
from audio_matcher_tpu.parallel import sweep as jsweep  # noqa: E402
from audio_matcher_tpu.parallel.mesh import make_mesh  # noqa: E402

from audio_matcher_tpu_torch.cli import matcher_cli, sweep_cli  # noqa: E402
from audio_matcher_tpu_torch.hostio.decode import write_wav  # noqa: E402
from audio_matcher_tpu_torch.hostio.labels import (  # noqa: E402
    timelabel_from_peaks,
    write_labels,
)
from audio_matcher_tpu_torch.models.spectrogram import (  # noqa: E402
    SpectrogramConfig,
    SpectrogramMatcher,
)
from audio_matcher_tpu_torch.parallel.sweep import (  # noqa: E402
    ShardedSpectrogramScanner,
    spectrogram_pad_width,
    sweep_archive,
)

TOL = 2e-4
SR = 8000


def make_snippet(sr, secs=3.0):
    """A harmonic-rich snippet, so that its mel fingerprint is
    distinctive (the JAX package's test snippet)."""
    t = np.arange(int(secs * sr)) / sr
    x = sum(np.sin(2 * np.pi * f * t + p)
            for f, p in [(220, 0.1), (523, 1.0), (1397, 2.0)])
    env = np.minimum(1.0, 10 * t) * np.minimum(1.0, 10 * (secs - t))
    return (0.2 * x * env).astype(np.float32)


def _episode(rng, secs, snippets, at, sr=SR):
    """Noise with snippets added at (query, seconds), then more noise."""
    x = (rng.standard_normal(int(secs * sr)) * 0.05).astype(np.float32)
    for q, t in at:
        i = int(t * sr)
        x[i : i + len(snippets[q])] += snippets[q]
    return x + (rng.standard_normal(len(x)) * 0.05).astype(np.float32)


def _same(got, want):
    assert [p.position for p in got] == [p.position for p in want], (
        got, want)
    for a, b in zip(got, want):
        assert abs(a.height - b.height) <= TOL
        assert abs(a.prominence - b.prominence) <= TOL


def test_matcher_matches_jax():
    sr = 16000
    rng = np.random.default_rng(1234)
    snippet = make_snippet(sr)
    episode = _episode(rng, 60, [snippet], [(0, 20.0), (0, 41.5)], sr)
    cfg = dict(distance_secs=10.0, min_score=0.1)
    want = jspec.SpectrogramMatcher(snippet, sr, jspec.SpectrogramConfig(
        **cfg)).match(episode)
    matcher = SpectrogramMatcher(snippet, sr, SpectrogramConfig(**cfg),
                                 device="cpu")
    got = matcher.match(episode)
    assert len(got) >= 2
    _same(got, want)
    best = sorted(got, key=lambda p: -p.height)[:2]
    assert sorted(abs(p.position - int(t * sr)) <= 256
                  for p, t in zip(sorted(best, key=lambda p: p.position),
                                  (20.0, 41.5))) == [True, True]
    assert matcher.match(episode[: len(snippet) // 2]) == []


def _scan_inputs():
    rng = np.random.default_rng(42)
    snippets = [make_snippet(SR, 3.0), make_snippet(SR, 2.0)[::-1].copy()]
    episodes = [_episode(rng, secs, snippets, at) for secs, at in (
        (40, [(0, 6.0), (1, 19.0), (0, 30.0)]), (25, [(1, 3.0), (0, 15.5)]),
        (33, [(0, 20.0)]), (12, [(1, 2.0)]))]
    return snippets, episodes


@pytest.mark.parametrize("wire", ["float32", "int16", "mulaw8"])
def test_scanner_matches_jax(wire):
    snippets, episodes = _scan_inputs()
    kw = dict(distance_secs=10.0, transfer_dtype=wire, min_score=0.2)
    js = jsweep.ShardedSpectrogramScanner(
        snippets, SR, jspec.SpectrogramConfig(**kw), make_mesh(1))
    want = js.scan_resident(episodes)
    cfg = SpectrogramConfig(**kw)
    carried = ShardedSpectrogramScanner(snippets, SR, cfg, device="cpu",
                                        query_fps=js._snip_fps)
    own = ShardedSpectrogramScanner(snippets, SR, cfg, device="cpu")
    rows, ns, n_real = own.stage_resident(episodes)
    assert rows.shape == (4, spectrogram_pad_width(40 * SR, 1024))
    assert n_real == 4 and list(ns) == [len(e) for e in episodes]
    for scanner in (carried, own):
        got = scanner.scan_resident(episodes)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            for gq, wq in zip(g, w):
                _same(gq, wq)
    assert [p.position // 256 for p in got[1][0]] == [
        p.position // 256 for p in want[1][0]]
    assert any(abs(p.position - 15.5 * SR) <= 256 for p in got[1][0])


def test_spectrogram_pad_width_matches_jax():
    cases = [(4000, 1024), (0, 128), (8 * (1 << 22) - 1000, 1024),
             (300 * 44100, 1024), (1, 1 << 20), (1800 * 44100, 1024),
             (3600 * 44100, 1024), ((1 << 18) + 1, 1024)]
    for n, n_fft in cases:
        assert spectrogram_pad_width(n, n_fft) == (
            jsweep.spectrogram_pad_width(n, n_fft)), (n, n_fft)
    assert spectrogram_pad_width(4000, 1024) == 1 << 18


def _archive(root):
    """Four episodes, a corrupt file and one at 4 kHz, in sorted order."""
    rng = np.random.default_rng(77)
    snippets = [make_snippet(SR, 3.0), make_snippet(SR, 2.0)[::-1].copy()]
    paths = []
    for name, secs, at in (("e0", 30, [(0, 4.0), (1, 20.0)]),
                           ("e1", 22, [(1, 6.5)]),
                           ("e2", 35, [(0, 2.0), (0, 18.0), (1, 27.0)]),
                           ("e4", 18, [(0, 9.0)])):
        write_wav(root / f"{name}.wav", SR, _episode(rng, secs, snippets, at))
        paths.append(root / f"{name}.wav")
    (root / "e3_corrupt.wav").write_bytes(rng.bytes(3000))
    paths.insert(3, root / "e3_corrupt.wav")
    slow = _episode(rng, 16, [s[::2] for s in snippets], [(0, 5.0)], SR // 2)
    write_wav(root / "e5_4k.wav", SR // 2, slow)
    paths.append(root / "e5_4k.wav")
    return snippets, paths


class _Stop(Exception):
    pass


def _sink(out_dir, labels_fn, write_fn, stop_at=None):
    out_dir.mkdir(exist_ok=True)

    def sink(path, q, peaks):
        if path.name == stop_at:
            raise _Stop
        write_fn(labels_fn(peaks, SR, 7.0, "Segment #"),
                 out_dir / f"{path.stem}.q{q}.txt")

    return sink


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_sweep_matches_jax_and_resumes(tmp_path):
    snippets, paths = _archive(tmp_path)
    kw = dict(distance_secs=8.0, transfer_dtype="int16")
    want = jsweep.sweep_archive(
        paths, snippets, SR, mesh=make_mesh(1), mode="spectrogram",
        spectrogram_config=jspec.SpectrogramConfig(**kw),
        progress_path=tmp_path / "jax.done.txt",
        write_labels_for=_sink(tmp_path / "jax", jax_labels, jax_write),
        resample_mismatched=True, group_size=2,
    )

    def port(stop_at=None):
        return sweep_archive(
            paths, snippets, SR, device="cpu", mode="spectrogram",
            spectrogram_config=SpectrogramConfig(**kw),
            progress_path=tmp_path / "port.done.txt",
            write_labels_for=_sink(tmp_path / "port", timelabel_from_peaks,
                                   write_labels, stop_at),
            resample_mismatched=True, group_size=2,
        )

    got = port()
    assert list(got) == list(want) and len(got) == 5
    for k in want:
        for g, w in zip(got[k], want[k]):
            _same(g, w)
    assert ((tmp_path / "port.done.txt").read_bytes()
            == (tmp_path / "jax.done.txt").read_bytes())
    labels = _files(tmp_path / "jax")
    assert _files(tmp_path / "port") == labels and len(labels) == 10
    assert "Segment 1" in labels["e2.q0.txt"].decode()

    # stopped inside the second group's collection: the first group is
    # Done, the rerun scans the rest to the same files
    (tmp_path / "port.done.txt").unlink()
    shutil.rmtree(tmp_path / "port")
    with pytest.raises(_Stop):
        port(stop_at="e2.wav")
    assert len((tmp_path / "port.done.txt").read_text().splitlines()) == 2
    rest = port()
    assert set(rest) == set(want) - {str(paths[0]), str(paths[1])}
    assert ((tmp_path / "port.done.txt").read_bytes()
            == (tmp_path / "jax.done.txt").read_bytes())
    assert _files(tmp_path / "port") == labels


@pytest.fixture
def cli_fixtures(tmp_path):
    """intro.wav and two episodes with the intro twice, in ``jax/`` and
    ``port/``."""
    rng = np.random.default_rng(99)
    snippet = make_snippet(SR)
    src = tmp_path / "src"
    src.mkdir()
    write_wav(src / "intro.wav", SR, snippet)
    for name, at in (("episode", (4.0, 21.0)), ("second", (9.5, 30.0))):
        write_wav(src / f"{name}.wav", SR,
                  _episode(rng, 40, [snippet], [(0, t) for t in at]))
    for side in ("jax", "port"):
        shutil.copytree(src, tmp_path / side)
    return tmp_path


def test_clis_match_jax(cli_fixtures, caplog):
    root = cli_fixtures
    runs = {}
    for side, matcher, sweeper, extra in (
            ("jax", jax_matcher_cli, jax_sweep_cli, []),
            ("port", matcher_cli, sweep_cli, ["--device", "cpu"])):
        d = root / side
        caplog.clear()
        with caplog.at_level(logging.INFO):
            rc_m = matcher.run(matcher.build_parser().parse_args([
                str(d / "episode.wav"), str(d / "second.wav"), "--snippet",
                str(d / "intro.wav"), "--mode", "spectrogram", "--distance",
                "10"] + extra))
        offsets = [r.getMessage().split(" with ")[0] for r in caplog.records
                   if r.getMessage().startswith("Offset")]
        (d / "sweep").mkdir()
        for name in ("episode.wav", "second.wav"):
            shutil.copy(d / name, d / "sweep" / name)
        ns = sweeper.build_parser().parse_args([
            str(d / "sweep" / "*.wav"), "--snippet", str(d / "intro.wav"),
            "--mode", "spectrogram", "--distance", "10", "--progress-file",
            str(d / "sweep" / ".done.txt")] + (extra or ["--devices", "1"]))
        runs[side] = (rc_m, offsets, sweeper.run(ns), sweeper.run(ns))
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == 0 and len(runs["port"][1]) == 4
    for name in ("episode.txt", "second.txt", "sweep/episode.txt",
                 "sweep/second.txt"):
        assert ((root / "port" / name).read_bytes()
                == (root / "jax" / name).read_bytes()), name
    assert (root / "port" / "episode.txt").read_text().startswith("11.")
    done = {side: (root / side / "sweep" / ".done.txt").read_text().replace(
        str(root / side), "") for side in ("jax", "port")}
    assert done["port"] == done["jax"] == (
        "/sweep/episode.wav Done\n/sweep/second.wav Done\n")
