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
from audio_matcher_tpu_torch.models.matcher import (  # noqa: E402
    fill_wire_rows,
    quantize_wire,
    wire_silence,
)
from audio_matcher_tpu_torch.ops.peaks import Peak  # noqa: E402
from audio_matcher_tpu_torch.utils import durations, progressbar  # noqa: E402

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
    """resample on f32 and on the int16 wire, up and down; ``auto`` is
    scipy until ROADMAP P6, and ``device`` raises naming it."""
    rng = np.random.default_rng(11)
    f32 = (rng.standard_normal(3001) * 0.1).astype(np.float32)
    for samples in (f32, quantize_wire(f32, "int16")):
        for sr_from, sr_to in ((8000, 6000), (22050, 44100), (8000, 8000)):
            want = jdecode.resample(samples, sr_from, sr_to, "scipy",
                                    wire_int16)
            for impl in ("scipy", "auto"):
                got = decode.resample(samples, sr_from, sr_to, impl,
                                      wire_int16)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError, match="P6"):
        decode.resample(f32, 8000, 6000, "device")
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
