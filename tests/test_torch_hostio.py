"""The port's host modules against the JAX package's, on the CPU.

Labels, decode (wav in Python; mp3 and opus through each package's own
build of ``native/am_native.cpp``, where it builds and the codecs load),
the duration tag cache, the scipy resampler, the prefetching decoder, the
``.done.txt`` progress store, the staging fill, durations and the
progress bar: the same inputs through both packages give equal arrays and
byte-equal files. A test that writes into a media file (the tag cache)
gives each package its own copy.
"""

import io
import shutil
import threading
import time
import wave

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audio_matcher_tpu.hostio import decode as jdecode  # noqa: E402
from audio_matcher_tpu.hostio import labels as jlabels  # noqa: E402
from audio_matcher_tpu.hostio import prefetch as jprefetch  # noqa: E402
from audio_matcher_tpu.meta import progress as jprogress  # noqa: E402
from audio_matcher_tpu.meta import tagger as jtagger  # noqa: E402
from audio_matcher_tpu.models.matcher import (  # noqa: E402
    StagingArena as JaxArena,
)
from audio_matcher_tpu.ops.peaks import Peak as JaxPeak  # noqa: E402
from audio_matcher_tpu.utils import durations as jdurations  # noqa: E402
from audio_matcher_tpu.utils import progressbar as jprogressbar  # noqa: E402

from audio_matcher_tpu_torch.hostio import decode, labels, prefetch  # noqa: E402
from audio_matcher_tpu_torch.meta import progress, tagger  # noqa: E402
from audio_matcher_tpu_torch.models import matcher  # noqa: E402
from audio_matcher_tpu_torch.models.matcher import (  # noqa: E402
    fill_plan,
    fill_wire_rows,
    quantize_wire,
    wire_buffer,
    wire_silence,
)
from audio_matcher_tpu_torch.ops.peaks import Peak  # noqa: E402
from audio_matcher_tpu_torch.utils import (  # noqa: E402
    durations,
    progressbar,
    spans,
)
from torch.profiler import ProfilerActivity, profile  # noqa: E402

WIRES = ["float32", "int16", "mulaw8"]


def _codecs(*what):
    """Skip unless both packages' native libraries load these codecs."""
    for w in what:
        if not (jdecode.native_available(w) and decode.native_available(w)):
            pytest.skip(f"native {w} unavailable")


def test_labels_match_jax(tmp_path, capsys):
    """timelabel_from_peaks (n peaks → n-1 labels, 7 s delay, '#' numbered,
    peaks closer than the delay never inverted), the written bytes, the
    read-back (spectral-selection lines skipped) and the dry run."""
    spots = [(100, 1.0, 0.5), (300, 0.9, 0.4), (900, 0.8, 0.7),
             (905, 0.7, 0.2)]
    sr = 10
    got = labels.timelabel_from_peaks([Peak(*s) for s in spots], sr, 7.0,
                                      "Segment #")
    want = jlabels.timelabel_from_peaks([JaxPeak(*s) for s in spots], sr,
                                        7.0, "Segment #")
    assert [lb.to_line() for lb in got] == [lb.to_line() for lb in want]
    assert got[-1].start == got[-1].end == 90.5  # clamped, not inverted
    got.append(labels.TimeLabel(1.25, 2.5, None))
    want.append(jlabels.TimeLabel(1.25, 2.5, None))
    labels.write_labels(got, tmp_path / "port.txt")
    jlabels.write_labels(want, tmp_path / "jax.txt")
    text = (tmp_path / "jax.txt").read_bytes()
    assert (tmp_path / "port.txt").read_bytes() == text
    assert labels.read_labels(tmp_path / "port.txt") == got
    spectral = tmp_path / "spec.txt"
    spectral.write_text("1.0\t2.0\tseg\n\\\t400.0\t800.0\n3.0\t4.0\n")
    assert ([vars(lb) for lb in labels.read_labels(spectral)]
            == [vars(lb) for lb in jlabels.read_labels(spectral)])
    labels.write_labels(got, tmp_path / "dry.txt", dry_run=True)
    port_out = capsys.readouterr().out
    jlabels.write_labels(want, tmp_path / "dry.txt", dry_run=True)
    assert port_out == capsys.readouterr().out
    assert not (tmp_path / "dry.txt").exists()


def _write_wav(path, sr, frames, channels):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.asarray(frames, "<i2").tobytes())


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_decode_matches_jax(tmp_path, channels):
    """read_wav, read_audio and read_audio_int16 on mono and stereo 16-bit
    wav (stereo with distinct channels, so that the int16 downmix rounds
    odd sums); write_wav's bytes."""
    rng = np.random.default_rng(channels)
    frames = rng.integers(-20000, 20000, 3001 * channels)
    path = tmp_path / "x.wav"
    _write_wav(path, 8000, frames, channels)
    for fn in ("read_wav", "read_audio", "read_audio_int16"):
        sr, got = getattr(decode, fn)(path)
        want_sr, want = getattr(jdecode, fn)(path)
        assert sr == want_sr == 8000 and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    mono = decode.read_wav(path)[1]
    decode.write_wav(tmp_path / "p.wav", 8000, mono)
    jdecode.write_wav(tmp_path / "j.wav", 8000, mono)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    with pytest.raises(FileNotFoundError):
        decode.read_audio(tmp_path / "missing.mp3")
    bad = tmp_path / "bad.wav"
    with wave.open(str(bad), "wb") as w:  # 8-bit: refused like JAX
        w.setnchannels(1)
        w.setsampwidth(1)
        w.setframerate(8000)
        w.writeframes(bytes(100))
    with pytest.raises(decode.DecodeError, match="16-bit"):
        decode.read_audio(bad)


def test_mp3_decode_and_tag_cache_match_jax(tmp_path):
    """mp3 through each package's native build: the encoder's bytes, the
    f32 and int16 decodes, the frame-header duration probe, and the
    duration tag cache (cold: probe, then write-back; warm: the tag),
    with byte-equal files after the write-back."""
    _codecs("mp3", "mp3_encode", "mp3_duration")
    rng = np.random.default_rng(7)
    mono = (rng.standard_normal(44100 * 3) * 0.1).astype(np.float32)
    jdecode.encode_audio(tmp_path / "j.mp3", 44100, mono)
    decode.encode_audio(tmp_path / "p.mp3", 44100, mono)
    assert (tmp_path / "p.mp3").read_bytes() == (tmp_path / "j.mp3").read_bytes()
    for fn in ("read_audio", "read_audio_int16"):
        sr, got = getattr(decode, fn)(tmp_path / "p.mp3")
        want_sr, want = getattr(jdecode, fn)(tmp_path / "j.mp3")
        assert sr == want_sr and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (decode.mp3_duration_probe(tmp_path / "p.mp3")
            == jdecode.mp3_duration_probe(tmp_path / "j.mp3"))
    shutil.copy(tmp_path / "j.mp3", tmp_path / "jf.mp3")
    shutil.copy(tmp_path / "j.mp3", tmp_path / "pf.mp3")
    for _ in range(2):  # cold, then warm
        assert (decode.audio_duration(tmp_path / "p.mp3")
                == jdecode.audio_duration(tmp_path / "j.mp3"))
        assert (decode.audio_duration(tmp_path / "pf.mp3", fallback=2.75)
                == jdecode.audio_duration(tmp_path / "jf.mp3", fallback=2.75))
        for a, b in (("p", "j"), ("pf", "jf")):
            assert ((tmp_path / f"{a}.mp3").read_bytes()
                    == (tmp_path / f"{b}.mp3").read_bytes())
    assert tagger.TaggedFile.from_path(tmp_path / "pf.mp3").get(
        tagger.Length) == 2.0  # whole seconds
    # a file tagged before (text, chapters, a comment frame): the
    # write-back keeps every frame and renders the tag as JAX does
    tag = jtagger.TaggedFile.from_path(tmp_path / "j.mp3")
    tag.set(jtagger.Title, "Folge 12")
    tag.set(jtagger.Length, None)
    tag.set_chapter(0, 0.0, "Intro")
    tag.set_chapter(1, 1.25, None)
    tag._inner.other_frames.append(("COMM", 0, b"\x03deu\x00notiz"))
    tag.save_changes()
    for name in ("jt", "pt"):
        shutil.copy(tmp_path / "j.mp3", tmp_path / f"{name}.mp3")
    assert (decode.audio_duration(tmp_path / "pt.mp3", fallback=2.5)
            == jdecode.audio_duration(tmp_path / "jt.mp3", fallback=2.5))
    assert ((tmp_path / "pt.mp3").read_bytes()
            == (tmp_path / "jt.mp3").read_bytes())
    assert jtagger.TaggedFile.from_path(tmp_path / "pt.mp3").get(
        jtagger.Title) == "Folge 12"


def test_opus_decode_and_tags_match_jax(tmp_path):
    """opus: the decode, and the duration hint written into a file that
    carries other comments (kept), byte for byte."""
    _codecs("opus")
    t = np.arange(48000) / 48000
    sig = (0.1 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    jdecode.encode_audio(tmp_path / "j.opus", 48000, sig)
    tag = jtagger.TaggedFile.from_path(tmp_path / "j.opus", True)
    tag.set(jtagger.Title, "Kapitel 3")
    tag.set(jtagger.Artist, "Sprecherin")
    tag.set(jtagger.Length, None)
    tag.save_changes()
    shutil.copy(tmp_path / "j.opus", tmp_path / "p.opus")
    sr, got = decode.read_audio(tmp_path / "p.opus")
    want_sr, want = jdecode.read_audio(tmp_path / "j.opus")
    assert sr == want_sr == 48000
    np.testing.assert_array_equal(got, want)
    for _ in range(2):  # cold, then warm
        assert (decode.audio_duration(tmp_path / "p.opus")
                == jdecode.audio_duration(tmp_path / "j.opus"))
        assert ((tmp_path / "p.opus").read_bytes()
                == (tmp_path / "j.opus").read_bytes())
    assert tagger.TaggedFile.from_path(tmp_path / "p.opus").get(
        tagger.Length) is not None
    assert jtagger.TaggedFile.from_path(tmp_path / "p.opus").get(
        jtagger.Artist) == "Sprecherin"


@pytest.mark.parametrize("wire_int16", [False, True])
def test_scipy_resample_matches_jax(wire_int16):
    """resample on f32 and on the int16 wire, up and down: ``scipy`` and
    ``auto`` (no device, or the CPU: scipy) equal JAX's scipy path;
    ``device`` on the CPU runs the torch polyphase, within 2e-6 of JAX's
    device path (the int16 wire within 1); an unknown impl raises."""
    rng = np.random.default_rng(11)
    f32 = (rng.standard_normal(3001) * 0.1).astype(np.float32)
    for samples in (f32, quantize_wire(f32, "int16")):
        for sr_from, sr_to in ((8000, 6000), (22050, 44100), (8000, 8000)):
            want = jdecode.resample(samples, sr_from, sr_to, "scipy",
                                    wire_int16)
            for impl, device in (("scipy", None), ("auto", None),
                                 ("auto", "cpu")):
                got = decode.resample(samples, sr_from, sr_to, impl,
                                      wire_int16, device=device)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
            want = jdecode.resample(samples, sr_from, sr_to, "device",
                                    wire_int16)
            got = decode.resample(samples, sr_from, sr_to, "device",
                                  wire_int16, device="cpu")
            assert got.dtype == want.dtype and got.shape == want.shape
            diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
            assert diff.max() <= (1 if wire_int16 else 2e-6)
    with pytest.raises(ValueError, match="impl"):
        decode.resample(f32, 8000, 6000, "fftw")


@pytest.mark.parametrize("wire", [None] + WIRES)
def test_prefetch_matches_jax(tmp_path, wire):
    """decode_prefetched: order, a missing file's error, a file at another
    rate (left int16 on the compressed wire), each wire dtype, and the
    byte budget with a deep queue."""
    rng = np.random.default_rng(3)
    paths = []
    for i, sr in enumerate((8000, 8000, 4000, 8000, 8000)):
        p = tmp_path / f"f{i}.wav"
        decode.write_wav(p, sr, (rng.standard_normal(900 + 50 * i) * 0.1)
                         .astype(np.float32))
        paths.append(p)
    paths.insert(1, tmp_path / "missing.wav")
    for kw in (dict(depth=2), dict(depth=8, workers=1, max_bytes=3000)):
        got = list(prefetch.decode_prefetched(
            paths, wire_dtype=wire, expect_sr=8000, **kw))
        want = list(jprefetch.decode_prefetched(
            paths, wire_dtype=wire, expect_sr=8000, **kw))
        assert [d.path for d in got] == [d.path for d in want] == paths
        for g, w in zip(got, want):
            assert (g.error is None) == (w.error is None)
            assert g.sr == w.sr and g.samples.dtype == w.samples.dtype
            np.testing.assert_array_equal(g.samples, w.samples)
        assert got[1].error is not None
        if wire == "mulaw8":
            assert got[3].samples.dtype == np.int16  # the 4000 Hz file


def test_progress_store_bytes_match_jax(tmp_path):
    """The ``.done.txt`` store after the same operations: appends (new
    entry, the last entry's state changed in place, an earlier entry moved
    to the end), set + save, remove, truncate, and a reload of a file with
    garbage and duplicate lines — the file's bytes after every step."""
    stores = {}
    for name, mod in (("port", progress), ("jax", jprogress)):
        stores[name] = (mod, mod.Progress(tmp_path / f"{name}.done.txt"))

    def step(fn):
        for mod, store in stores.values():
            fn(mod, store)
        assert ((tmp_path / "port.done.txt").read_bytes()
                == (tmp_path / "jax.done.txt").read_bytes())

    step(lambda m, s: s.append("a.mp3", m.State.LOADED))
    step(lambda m, s: s.append("b dir/b.mp3", m.State.NAMED))
    step(lambda m, s: s.append("b dir/b.mp3", m.State.DONE))
    step(lambda m, s: s.append("a.mp3", m.State.DONE))
    step(lambda m, s: s.append("line\nbreak.mp3", m.State.DONE))
    step(lambda m, s: (s.set("c.mp3", m.State.NAMED), s.save()))
    step(lambda m, s: (s.remove("a.mp3"), s.save()))
    step(lambda m, s: s.truncate(2))
    raw = "x.mp3 Done\ngarbage\ny.mp3 named\nx.mp3 loaded\n z \n"
    for name in stores:
        (tmp_path / f"{name}.done.txt").write_text(raw)
    for name, (mod, _) in list(stores.items()):
        stores[name] = (mod, mod.Progress(tmp_path / f"{name}.done.txt"))
    assert ([(n, str(s)) for n, s in stores["port"][1].content]
            == [(n, str(s)) for n, s in stores["jax"][1].content])
    step(lambda m, s: s.append("y.mp3", m.State.DONE))
    step(lambda m, s: s.append("z.mp3", m.State.DONE))
    assert stores["port"][1].get("x.mp3") == progress.State.LOADED


@pytest.mark.parametrize("wire", WIRES)
def test_staging_fill_matches_jax(wire):
    """Fresh buffers filled row by row for groups long → short → long, then
    with fewer episodes than rows: the same buffer as JAX's arena reused
    across those groups (it re-silences stale tails), silence past each
    row's episode."""
    rng = np.random.default_rng(5)
    jax_arena = JaxArena(wire)
    rows, width = 3, 700
    for lengths in ((700, 650, 690), (120, 30, 0), (680, 700, 10), (500,)):
        eps = [quantize_wire((rng.standard_normal(n) * 0.1)
                             .astype(np.float32), wire) for n in lengths]
        jax_arena.get(rows, width)
        for i in range(rows):
            jax_arena.write_row(rows, width, i, eps[i] if i < len(eps)
                                else eps[0][:0])
        got = fill_wire_rows(eps, width, wire, rows).numpy()
        want = jax_arena.get(rows, width)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        for i, n in enumerate(lengths):
            assert (got[i, n:] == wire_silence(wire)).all()
    assert (fill_wire_rows([], 50, wire, 2).numpy()
            == wire_silence(wire)).all()
    with pytest.raises(ValueError, match="longer than the staged width"):
        fill_wire_rows(eps, 400, wire, rows)


SPLIT_WIDTH = 40_000  # with 8 KiB parts: 4-19 parts a row on every wire


@pytest.fixture
def split(monkeypatch):
    """Fills cut into 8 KiB parts, on a fresh pool of 4 threads (shut
    down after the test), whatever the CPUs of this machine."""
    monkeypatch.setattr(matcher, "FILL_PART_BYTES", 8 << 10)
    monkeypatch.setattr(matcher._FillPool, "threads", 4)
    monkeypatch.setattr(matcher._FillPool, "pool", None)
    yield
    if matcher._FillPool.pool is not None:
        matcher._FillPool.pool.shutdown()


def _one_thread_fill(eps, rows, width, wire):
    want = wire_buffer((rows, width), wire)
    for i, ep in enumerate(eps):
        want[i, : len(ep)] = ep if ep.dtype == want.dtype else (
            quantize_wire(ep, wire))
    return want


SPLIT_CASES = {
    "lengths": (3, (SPLIT_WIDTH, SPLIT_WIDTH - 777, SPLIT_WIDTH // 3), True),
    "empty episode": (3, (SPLIT_WIDTH - 5, 0, 12_345), True),
    "fewer episodes than rows": (5, (SPLIT_WIDTH, 9_999), True),
    "float32 episodes": (3, (SPLIT_WIDTH, 31_000, 1), False),
    "no episodes": (3, (), True),
}


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("wire", WIRES)
def test_split_fill_equals_one_thread(split, wire, case):
    """A fill cut into several parts a row, on several threads, gives the
    bytes of the one-thread fill; float32 episodes are quantized part by
    part onto the int16 and μ-law wires."""
    rows, lengths, in_wire = SPLIT_CASES[case]
    rng = np.random.default_rng(len(lengths) + rows)
    eps = [(rng.standard_normal(n) * 0.1).astype(np.float32)
           for n in lengths]
    if in_wire:
        eps = [quantize_wire(ep, wire) for ep in eps]
    want = _one_thread_fill(eps, rows, SPLIT_WIDTH, wire)
    plan = fill_plan(rows, SPLIT_WIDTH, want.itemsize)
    assert len(plan) >= 3 * rows
    assert plan[0][0] == 0 and plan[-1][1] == rows * SPLIT_WIDTH
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    got = fill_wire_rows(eps, SPLIT_WIDTH, wire, rows).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_a_split_fill_refuses_a_long_episode_before_any_part(
        split, monkeypatch):
    ran = []
    monkeypatch.setattr(matcher, "_fill_range",
                        lambda *args: ran.append(args))
    eps = [np.zeros(SPLIT_WIDTH, np.int16), np.zeros(SPLIT_WIDTH + 1,
                                                     np.int16)]
    with pytest.raises(ValueError, match="episode 1 is longer than the "
                       "staged width"):
        fill_wire_rows(eps, SPLIT_WIDTH, "int16", 3)
    assert ran == []


def test_an_error_in_a_part_reaches_the_caller_after_every_part(
        split, monkeypatch):
    """The failing part raises in the caller; the fill returns (raising)
    only after the other parts, a slow one among them, are done."""
    fill_range = matcher._fill_range
    done = []

    def failing(out, eps, start, stop, transfer):
        if start == 0:
            raise RuntimeError("part failed")
        if stop == out.size:
            time.sleep(0.2)
        fill_range(out, eps, start, stop, transfer)
        done.append(start)

    monkeypatch.setattr(matcher, "_fill_range", failing)
    eps = [np.ones(SPLIT_WIDTH, np.int16)] * 3
    with pytest.raises(RuntimeError, match="part failed"):
        fill_wire_rows(eps, SPLIT_WIDTH, "int16", 3)
    assert len(done) == len(fill_plan(3, SPLIT_WIDTH, 2)) - 1


@pytest.mark.parametrize("wire", WIRES)
def test_a_fill_of_one_part_runs_on_the_callers_thread(monkeypatch, wire):
    threads = []
    fill_range = matcher._fill_range

    def recording(*args):
        threads.append(threading.get_ident())
        fill_range(*args)

    monkeypatch.setattr(matcher, "_fill_range", recording)
    eps = [quantize_wire(np.full(700, 0.1, np.float32), wire)]
    assert len(fill_plan(3, 1000, eps[0].itemsize)) == 1
    got = fill_wire_rows(eps, 1000, wire, 3).numpy()
    np.testing.assert_array_equal(got, _one_thread_fill(eps, 3, 1000, wire))
    assert threads == [threading.get_ident()]


def test_split_fill_parts_are_spans_of_the_callers_group(split):
    """Under a profiler each part is a ``stage.fill.part`` record in the
    calling thread's store, with the group of its ``stage`` span, on a
    pool thread, inside the ``stage.fill`` span; off, none is written."""
    eps = [np.ones(SPLIT_WIDTH, np.int16), np.ones(123, np.int16)]
    plan = fill_plan(3, SPLIT_WIDTH, 2)
    with spans.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("stage", 5):
            fill_wire_rows(eps, SPLIT_WIDTH, "int16", 3)
    recs = spans.records()
    parts = [r for r in recs if r.name == "stage.fill.part"]
    (fill,) = [r for r in recs if r.name == "stage.fill"]
    here = threading.get_ident()
    assert len(parts) == len(plan) > 1
    assert {r.group for r in parts} == {fill.group} == {5}
    assert {r.parent for r in parts} == {None}
    assert here not in {r.thread for r in parts}
    assert all(fill.t0_ns <= r.t0_ns <= r.t1_ns <= fill.t1_ns
               for r in parts)
    fill_wire_rows(eps, SPLIT_WIDTH, "int16", 3)  # off
    assert spans.records() == recs


def _recording_fill(monkeypatch, slow_stop=None, fail_start=None,
                    gate=None):
    """``_fill_range`` that records each range it has written (after the
    bytes), holds the range ending at ``slow_stop`` back (until ``gate``
    is set, else 0.2 s) and raises in the one starting at
    ``fail_start``."""
    fill_range, written = matcher._fill_range, []

    def recording(out, eps, start, stop, transfer):
        if start == fail_start:
            raise RuntimeError("part failed")
        if stop == slow_stop:
            if gate is None:
                time.sleep(0.2)
            else:
                assert gate.wait(30)
        fill_range(out, eps, start, stop, transfer)
        written.append((start, stop))

    monkeypatch.setattr(matcher, "_fill_range", recording)
    return written


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("wire", WIRES)
def test_split_fill_hands_each_range_over_once_in_order(split, monkeypatch,
                                                        wire, case):
    """``written`` gets each range of the plan once, in plan order, on the
    caller's thread, after that range and every one before it are
    written: the ranges tile the buffer and hold their final bytes."""
    rows, lengths, in_wire = SPLIT_CASES[case]
    rng = np.random.default_rng(len(lengths) + rows)
    eps = [(rng.standard_normal(n) * 0.1).astype(np.float32)
           for n in lengths]
    if in_wire:
        eps = [quantize_wire(ep, wire) for ep in eps]
    want = _one_thread_fill(eps, rows, SPLIT_WIDTH, wire).reshape(-1)
    plan = fill_plan(rows, SPLIT_WIDTH, want.itemsize)
    written = _recording_fill(monkeypatch, slow_stop=plan[-1][1])
    handed, here = [], threading.get_ident()

    def hand(buf, start, stop):
        assert threading.get_ident() == here
        assert set(plan[: len(handed) + 1]) <= set(written)
        np.testing.assert_array_equal(buf.numpy().reshape(-1)[start:stop],
                                      want[start:stop])
        handed.append((start, stop))

    got = fill_wire_rows(eps, SPLIT_WIDTH, wire, rows, written=hand)
    assert handed == plan and len(plan) > 1
    assert handed[0][0] == 0 and handed[-1][1] == want.size
    assert all(a[1] == b[0] for a, b in zip(handed, handed[1:]))
    np.testing.assert_array_equal(got.numpy().reshape(-1), want)


@pytest.mark.parametrize("wire", WIRES)
def test_a_fill_of_one_part_hands_the_whole_buffer_over_after_it(
        monkeypatch, wire):
    """A plan of one range: one hand-over, of the whole buffer, after the
    fill (the single copy)."""
    written = _recording_fill(monkeypatch)
    eps = [quantize_wire(np.full(700, 0.1, np.float32), wire)]
    handed = []

    def hand(buf, start, stop):
        handed.append((start, stop, list(written)))

    fill_wire_rows(eps, 1000, wire, 3, written=hand)
    assert handed == [(0, 3000, [(0, 3000)])]


def test_no_range_is_handed_over_from_a_failed_part_on(split, monkeypatch):
    """A middle part fails: the ranges before it are handed over, none
    from it on; the error reaches the caller after every other part, the
    slow last one among them, has been written."""
    plan = fill_plan(3, SPLIT_WIDTH, 2)
    k = len(plan) // 2
    written = _recording_fill(monkeypatch, slow_stop=plan[-1][1],
                              fail_start=plan[k][0])
    handed = []
    eps = [np.ones(SPLIT_WIDTH, np.int16)] * 3
    with pytest.raises(RuntimeError, match="part failed"):
        fill_wire_rows(eps, SPLIT_WIDTH, "int16", 3,
                       written=lambda buf, a, b: handed.append((a, b)))
    assert handed == plan[:k]
    assert sorted(written) == plan[:k] + plan[k + 1:]


def _staging_counts():
    return (matcher.STAGING_STATS["staged_bytes"],
            matcher.STAGING_STATS["early_bytes"])


@pytest.mark.parametrize("hand", ["handed over", "not for a device",
                                  "one part"])
@pytest.mark.parametrize("wire", WIRES)
def test_staging_stats_count_staged_and_early_bytes(split, monkeypatch,
                                                    wire, hand):
    """A fill handed over adds its bytes: split, with its last part held
    back until the range before it is handed over, every range but the
    last early; of one part, none early. A fill neither pinned nor handed
    over (the CPU's staging) adds nothing."""
    width = SPLIT_WIDTH if hand != "one part" else 100
    itemsize = np.dtype(matcher.WIRE_DTYPES[wire]).itemsize
    plan = fill_plan(3, width, itemsize)
    gate = threading.Event()
    if hand != "handed over":
        gate.set()
    _recording_fill(monkeypatch, slow_stop=plan[-1][1], gate=gate)
    eps = [quantize_wire(np.full(width - 3, 0.1, np.float32), wire)]
    staged, early = _staging_counts()

    def hand_over(buf, start, stop):
        if len(plan) > 1 and stop == plan[-2][1]:
            gate.set()

    fill_wire_rows(eps, width, wire, 3, written=(
        None if hand == "not for a device" else hand_over))
    got = _staging_counts()
    assert got[0] - staged == (0 if hand == "not for a device"
                               else 3 * width * itemsize)
    want = 0
    if hand == "handed over":
        want = (plan[-1][0] - plan[0][0]) * itemsize
        assert want > 0
    assert got[1] - early == want


@pytest.mark.parametrize("where,width", [
    ("cuda", 1000), ("cuda", SPLIT_WIDTH), ("cpu", SPLIT_WIDTH),
], ids=["cuda-one-range", "cuda-split", "cpu-split"])
def test_stage_rows_host_copies_while_filling_only_to_cuda(
        split, monkeypatch, where, width):
    """To a CUDA device every fill goes to ``upload_while_filling`` (a fill
    of one range is handed over whole after it, one copy); for the CPU
    the buffer is filled whole, unpinned, and then handed to ``upload``."""
    calls = []
    fill = matcher.fill_wire_rows

    def filled(eps, n_pad, transfer, rows, pinned=False, written=None):
        calls.append(("fill", pinned, written))
        return fill(eps, n_pad, transfer, rows)

    monkeypatch.setattr(matcher, "fill_wire_rows", filled)
    monkeypatch.setattr(matcher, "upload", lambda host, device: calls.append(
        ("upload", host.shape)) or host)
    monkeypatch.setattr(matcher, "upload_while_filling",
                        lambda *args: calls.append(("in parts", args[1:]))
                        or "staged")
    eps = [np.ones(width - 7, np.int16)]
    staged, ns_pad, n = matcher.stage_rows_host(
        eps, [width - 7], width, "int16", 3, torch.device(where))
    assert list(ns_pad) == [width - 7, 0, 0] and n == 1
    if where == "cuda":
        assert calls == [("in parts", (width, "int16", 3,
                                       torch.device(where)))]
        assert staged == "staged"
    else:
        assert calls == [("fill", False, None), ("upload", (3, width))]


def test_durations_and_progress_bar_match_jax():
    for text in ("17", "58sec", "1m", "100ms", "1hour1m1s", "2h30m", "5s250ms"):
        assert durations.parse_duration(text) == jdurations.parse_duration(text)
    for bad in ("", "1s1m", "abc"):
        with pytest.raises(ValueError):
            durations.parse_duration(bad)
    for secs in (0.0, 59.999, 3725.5, 86399.4):
        assert durations.fmt_hms(secs) == jdurations.fmt_hms(secs)
        assert durations.fmt_hmsm(secs) == jdurations.fmt_hmsm(secs)
    outs = []
    for mod in (progressbar, jprogressbar):
        for fancy in (False, True):
            stream = io.StringIO()
            bar = mod.Progress(7, fancy=fancy, stream=stream, enabled=True)
            bar.max_len = 60
            for i in range(9):  # overshoots the estimated total
                bar.start(i)
                if i % 2:
                    bar.finish(i)
            bar.close()
            outs.append(stream.getvalue())
    assert outs[:2] == outs[2:]
