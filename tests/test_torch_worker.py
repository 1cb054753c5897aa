"""The port's worker tools against the JAX package's, on the CPU.

The whole tagger (every field, chapters, ``fill_all_from``, ``reload``,
``reload_empty``, ``file_moved`` and save-on-drop) on mp3 files with ID3v2.2,
v2.3 and v2.4 tags or none, and on opus files; ``calc_merged_offsets``;
the Audacity scripting-pipe dialect across the packages (each client
against the other's fake server); worker sessions of
``run_worker`` / ``old_flow`` through each package against its own
``FakeAudacity``; and ``audio-worker-torch`` (``cli.worker_cli``) against
``audio-worker``. Each package gets its own copy of every tree, and the
final trees must be equal: every relative path and every file's bytes
(label files, ``.done.txt``, the tagged and moved chapter files, configs).
Every FIFO read has its timeout, and every fake server is stopped in a
``finally``.
"""

import dataclasses
import gc
import io
import os
import shutil
import struct
import sys
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from audio_matcher_tpu.cli import common as jcommon  # noqa: E402
from audio_matcher_tpu.cli import worker_cli as jworker_cli  # noqa: E402
from audio_matcher_tpu.hostio import decode as jdecode  # noqa: E402
from audio_matcher_tpu.hostio import labels as jlabels  # noqa: E402
from audio_matcher_tpu.meta import progress as jprogress  # noqa: E402
from audio_matcher_tpu.meta import tagger as jtagger  # noqa: E402
from audio_matcher_tpu.worker import audacity as jaudacity  # noqa: E402
from audio_matcher_tpu.worker import fake_audacity as jfake  # noqa: E402
from audio_matcher_tpu.worker import pipeline as jpipeline  # noqa: E402
from audio_matcher_tpu.worker import rename as jrename  # noqa: E402

from audio_matcher_tpu_torch.cli import common, worker_cli  # noqa: E402
from audio_matcher_tpu_torch.hostio import decode, labels  # noqa: E402
from audio_matcher_tpu_torch.meta import progress, tagger  # noqa: E402
from audio_matcher_tpu_torch.worker import (  # noqa: E402
    audacity,
    fake_audacity,
    pipeline,
    rename,
)

JAX = types.SimpleNamespace(
    name="jax", audacity=jaudacity, fake=jfake, pipeline=jpipeline,
    rename=jrename, common=jcommon, labels=jlabels, progress=jprogress,
    tagger=jtagger, cli=jworker_cli)
PORT = types.SimpleNamespace(
    name="port", audacity=audacity, fake=fake_audacity, pipeline=pipeline,
    rename=rename, common=common, labels=labels, progress=progress,
    tagger=tagger, cli=worker_cli)
PKGS = (JAX, PORT)
PIPE_TIMEOUT = 5  # seconds, every client's FIFO wait

# an MPEG frame header and a zero payload: what the tagger needs of an
# mp3, no codec involved (417 bytes)
MP3_STUB = b"\xff\xfb\x90\x00" + bytes(413)


def _codecs(*what):
    for w in what:
        if not (jdecode.native_available(w) and decode.native_available(w)):
            pytest.skip(f"no native {w} codec")


def tree(root, skip=("pipes",)):
    """Every file under ``root`` but the pipe directory: path → bytes."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and p.relative_to(root).parts[0] not in skip}


# --------------------------------------------------------------- tagger
def _id3(major, frames, unsync=False):
    """An ID3v2.{2,3} tag from (id, payload) pairs, as tests/test_tagger.py
    assembles them."""
    body = b""
    for fid, payload in frames:
        if major == 2:
            body += fid + len(payload).to_bytes(3, "big") + payload
        else:
            body += fid + struct.pack(">I", len(payload)) + b"\x00\x00" + payload
    if unsync:
        body = body.replace(b"\xff", b"\xff\x00")
    size = len(body)
    ss = bytes([(size >> 21) & 0x7F, (size >> 14) & 0x7F,
                (size >> 7) & 0x7F, size & 0x7F])
    return b"ID3" + bytes([major, 0, 0x80 if unsync else 0]) + ss + body


def _utf16(text):
    return b"\x01" + text.encode("utf-16")


def _v24_input(tmp_path):
    """A v2.4 tag the JAX writer rendered: fields, chapters, a comment."""
    path = tmp_path / "v24_src.mp3"
    path.write_bytes(MP3_STUB)
    tag = jtagger.TaggedFile.new_empty(path)
    for field, value in ((jtagger.Title, "Vier"), (jtagger.Artist, "Ärzte"),
                         (jtagger.Album, "Alb"), (jtagger.Year, 2004),
                         (jtagger.Track, 4), (jtagger.TotalDisks, 3),
                         (jtagger.Length, 61.9)):
        tag.set(field, value)
    tag.set_chapter(1, 0.0, "Part 1")
    tag.set_chapter(2, 12.3456, None)
    tag._inner.other_frames.append(("COMM", 0, b"\x03deu\x00notiz"))
    tag.save_changes()
    data = path.read_bytes()
    del tag
    return data


def _mp3_input(kind, tmp_path):
    pic = b"\x00PNG\x03" + b"c\x00" + b"\xff\xe0IMAGE"
    if kind == "none":
        return MP3_STUB
    if kind == "v22":
        return _id3(2, [
            (b"TT2", b"\x00v22 titel"), (b"TP1", b"\x00Sprecher"),
            (b"TAL", b"\x00Album"), (b"TCO", b"\x00H\xf6rspiel"),
            (b"TYE", b"\x001987"), (b"TRK", b"\x003/9"), (b"TPA", b"\x00/2"),
            (b"TLE", b"\x0095000"), (b"PIC", pic),
            (b"COM", b"\x00engd\x00kommentar")]) + MP3_STUB
    if kind == "v23":
        return _id3(3, [
            (b"TIT2", _utf16("Tïtel \u00ff\u00e0")), (b"TPE1", _utf16("Ärtist")),
            (b"TRCK", b"\x0012"), (b"TPOS", b"\x00x/y"),
            (b"TYER", b"\x00abc"), (b"TXXX", b"\x03k\x00v"),
            (b"APIC", b"\x00image/png\x00\x03c\x00" + bytes(range(256)))],
            unsync=True) + MP3_STUB
    return _v24_input(tmp_path)


def _opus_input(kind, tmp_path):
    t = np.arange(9600) / 48000
    sig = (0.1 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    path = tmp_path / f"opus_{kind}.opus"
    jdecode.encode_audio(path, 48000, sig)
    if kind == "aliases":
        tag = jtagger.TaggedFile.from_path(path, True)
        tag._inner.comments += [
            ("AUTHOR", "Autorin"), ("DISCNUMBER", "2"),
            ("TRACKNUMBER", "3/9"), ("TITLE", "Alias"), ("YEAR", "x"),
            ("CHAPTER001", "00:00:01.500"), ("CHAPTER001NAME", "Eins"),
            ("CHAPTER1000", "00:00:02.000")]
        tag.save_changes(True)
        del tag
    return path.read_bytes()


def _field_values(mod, seed):
    rng = np.random.default_rng(seed)
    letters = list("abcxyzÄöüß \"'\\/-é€")
    text = lambda: "".join(rng.choice(letters, size=int(rng.integers(1, 12))))
    return [(mod.Title, text()), (mod.Artist, text()), (mod.Album, text()),
            (mod.Genre, "Hörbuch"), (mod.Year, int(rng.integers(1900, 2030))),
            (mod.Track, int(rng.integers(1, 40))),
            (mod.TotalTracks, int(rng.integers(1, 40))),
            (mod.Disk, int(rng.integers(1, 5))),
            (mod.TotalDisks, int(rng.integers(1, 5))),
            (mod.Length, float(rng.uniform(0, 4000)))]


def _tag_session(mod, root, ext, seed):
    """The same tag operations through one package's tagger; returns what it
    read at each step (the files stay under ``root``)."""
    seen = []
    path = root / f"in.{ext}"

    def look(tag):
        seen.append([tag.get(f) for f in mod.ALL_FIELDS]
                    + [tag._inner.get_chapters(), tag.ext, tag.was_changed])

    try:
        tag = mod.TaggedFile.from_path(path)
    except mod.TagError as exc:
        seen.append(("from_path", type(exc).__name__, str(exc)))
        tag = mod.TaggedFile.from_path(path, default_empty=True)
    look(tag)
    other = mod.TaggedFile.new_empty(root / f"other.{ext}")
    look(other)
    for field, value in _field_values(mod, seed):
        tag.set(field, value)
    tag.set_chapter(1, 0.0, "Part 1")
    tag.set_chapter(2, 1234.5678, "Part 2 \u00e9")
    tag.set_chapter(3, 7.25, None)
    look(tag)
    seen.append(tag.save_changes())
    seen.append(tag.save_changes())  # not dirty any more
    tag.reload()
    look(tag)
    tag.set(mod.Title, None)
    tag.set(mod.TotalTracks, None)
    tag.save_changes()
    tag.reload_empty()  # nothing to fill back: they were removed on disk
    look(tag)
    # fill a fresh handle from the tagged one, save it on drop
    shutil.copy(path, root / f"copy.{ext}")
    fresh = mod.TaggedFile.from_path(root / f"copy.{ext}")
    fresh.set(mod.Artist, None)
    fresh.set(mod.Year, None)
    fresh.save_changes()
    fresh.fill_all_from(mod.TaggedFile.from_path(root / f"in.{ext}"))
    look(fresh)
    del fresh  # save-on-drop
    gc.collect()
    # move the file under a handle with pending changes: the drop saves
    # them at the new place
    (root / "moved").mkdir()
    shutil.move(str(path), str(root / "moved" / path.name))
    tag.file_moved(root / "moved" / path.name)
    tag.set(mod.Genre, "Krimi")
    tag.set_chapter(4, 99.0, "Part 4")
    del tag
    gc.collect()
    # dropped changes are never written
    doomed = mod.TaggedFile.from_path(root / "moved" / path.name)
    doomed.set(mod.Title, "verworfen")
    doomed.drop_changes()
    del doomed
    gc.collect()
    again = mod.TaggedFile.from_path(root / "moved" / path.name)
    look(again)
    del again
    return seen


TAG_INPUTS = [("mp3", k) for k in ("none", "v22", "v23", "v24")] + [
    ("opus", k) for k in ("plain", "aliases")]


@pytest.mark.parametrize("ext,kind", TAG_INPUTS)
def test_tagger_session_matches_jax(tmp_path, ext, kind):
    if ext == "opus":
        _codecs("opus")
        raw = _opus_input(kind, tmp_path)
    else:
        raw = _mp3_input(kind, tmp_path)
    seen, trees = {}, {}
    for pkg in PKGS:
        root = tmp_path / pkg.name
        root.mkdir()
        (root / f"in.{ext}").write_bytes(raw)
        seen[pkg.name] = _tag_session(pkg.tagger, root, ext, seed=len(kind))
        trees[pkg.name] = tree(root)
    assert seen["port"] == seen["jax"]
    assert trees["port"] == trees["jax"]
    assert set(trees["port"]) == {f"copy.{ext}", f"moved/in.{ext}"}
    back = tagger.TaggedFile.from_path(tmp_path / "port" / "moved" / f"in.{ext}")
    assert back.get(tagger.Genre) == "Krimi"  # saved on drop after the move
    assert back.get(tagger.Title) is None


def test_tagger_errors_match_jax(tmp_path):
    (tmp_path / "x.flac").write_bytes(b"fLaC")
    (tmp_path / "stub.mp3").write_bytes(MP3_STUB)
    (tmp_path / "bad.opus").write_bytes(b"OggS broken")
    for name in ("x.flac", "stub.mp3", "bad.opus", "missing.mp3"):
        got = want = None
        for mod in (tagger, jtagger):
            try:
                mod.TaggedFile.from_path(tmp_path / name)
                result = "ok"
            except Exception as exc:  # noqa: BLE001 — compared
                result = (type(exc).__name__, str(exc))
            got, want = want, result
        assert got == want, name
    assert [f.key for f in tagger.ALL_FIELDS] == [
        f.key for f in jtagger.ALL_FIELDS]


# ------------------------------------------------------ merged offsets
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calc_merged_offsets_match_jax(seed):
    rng = np.random.default_rng(seed)
    groups, t = [], float(rng.uniform(0, 100))
    for _ in range(int(rng.integers(1, 6))):
        group = []
        for _ in range(int(rng.integers(0, 5))):
            start = t + float(rng.uniform(0, 30))
            t = start + float(rng.uniform(1, 900))
            group.append((start, t))
        groups.append(group)
    got = pipeline.calc_merged_offsets(
        [[labels.TimeLabel(s, e) for s, e in g] for g in groups])
    want = jpipeline.calc_merged_offsets(
        [[jlabels.TimeLabel(s, e) for s, e in g] for g in groups])
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        assert np.allclose(g, w, rtol=0, atol=1e-9)


# ------------------------------------------------------- wire dialect
HOSTILE = ['she said "hi"', "back\\slash", 'mix "of\\" both',
           "  spaces  and\ttabs ", "Ω unicode — ümläut", "a\nb\rc",
           "Serie 7.1 \"Die \\\"Rache\\\"\""]


def _client_session(client, tmp_path):
    """The scripting calls the worker makes, with hostile names; returns
    every answer."""
    api = client.audacity.AudacityApi(timeout=PIPE_TIMEOUT)
    try:
        out = []
        weird = tmp_path / 'ep "1" back\\slash.mp3'
        api.import_audio(weird)
        out.append([dataclasses.astuple(t) for t in api.get_track_info()])
        api.write_assume_empty("NewLabelTrack:")
        for i, name in enumerate(HOSTILE):
            api.select_time(float(i), float(i) + 0.5)
            api.write_assume_empty("AddLabel:")
            api.set_label(i, name)
        lab = tmp_path / "extra.txt"
        lab.write_text("5.0\t6.0\tb\n1.0\t2.0\ta \"q\"\n")
        api.import_labels_from(lab)
        track = api.add_label_track("merged \"x\"")
        out.append(api.add_label(client.labels.TimeLabel(3.0, 4.0, "neu"), track))
        api.write_assume_empty("SelAllTracks:")
        api.select_time(1.0, 2.0)
        api.write_assume_empty("Delete:")
        api.select_time(0.0, 0.6)
        api.write_assume_empty("SplitDelete:")
        api.zoom_to(2.0)
        api.zoom_to()
        api.select_tracks([0, 2])
        out.append({k: [dataclasses.astuple(lb) for lb in v]
                    for k, v in api.get_label_info().items()})
        out.append(api.get_first_label_track_nr())
        api.export_all_labels_to(tmp_path / "all.txt")
        out.append((tmp_path / "all.txt").read_bytes())
        api.export_audio(tmp_path / "exp" / 'k "1".mp3')
        out.append(sorted(p.name for p in (tmp_path / "exp").iterdir()))
        try:
            api.do("Bogus: X=1")
        except client.audacity.AudacityError as exc:
            out.append(("failed", str(exc)))
        with pytest.raises(ValueError):
            api.do("SetLabel: Label=0 Text=\"a\nb\"")
        return out
    finally:
        api.close()


def _run_against(client, server, tmp_path, monkeypatch):
    """``client``'s session against ``server``'s FakeAudacity, in a pipe
    directory of its own → (answers, the server's command log)."""
    pipes = tmp_path / "pipes"
    monkeypatch.setenv("AUDACITY_PIPE_DIR", str(pipes))
    monkeypatch.delenv("AUDACITY_PIPE_ESCAPES", raising=False)
    srv = server.fake.FakeAudacity(pipes)
    try:
        answers = _client_session(client, tmp_path)
        # every command is logged before its answer; stop() may log one
        # more of its own
        log = list(srv.command_log)
    finally:
        srv.stop()
    return answers, [c.replace(str(tmp_path), "<tmp>") for c in log]


@pytest.mark.parametrize("client,server", [(PORT, JAX), (JAX, PORT),
                                           (PORT, PORT)],
                         ids=["port-on-jax", "jax-on-port", "port-on-port"])
def test_scripting_pipe_dialect_matches_jax(tmp_path, monkeypatch, client,
                                            server):
    """Each client against each fake server gives the answers and the
    command lines of the JAX client against the JAX server."""
    (tmp_path / "want").mkdir()
    (tmp_path / "got").mkdir()
    want = _run_against(JAX, JAX, tmp_path / "want", monkeypatch)
    got = _run_against(client, server, tmp_path / "got", monkeypatch)
    assert got == want
    assert 'Text="she said \\"hi\\""' in " ".join(got[1])


QUOTE_ENVS = ["real", "escapes_on", "escapes_off", "marker_live",
              "marker_stale", "marker_empty"]


@pytest.mark.parametrize("env", QUOTE_ENVS)
def test_quote_param_dialects_match_jax(tmp_path, monkeypatch, env):
    monkeypatch.delenv("AUDACITY_PIPE_DIR", raising=False)
    monkeypatch.delenv("AUDACITY_PIPE_ESCAPES", raising=False)
    marker = tmp_path / f"audacity_fake_server.{os.getuid()}"
    if env.startswith("escapes"):
        monkeypatch.setenv("AUDACITY_PIPE_ESCAPES",
                           "1" if env == "escapes_on" else "0")
    elif env.startswith("marker"):
        monkeypatch.setenv("AUDACITY_PIPE_DIR", str(tmp_path))
        marker.write_text({"marker_live": str(os.getpid()),
                           "marker_stale": "999999999",
                           "marker_empty": ""}[env])
    values = HOSTILE + ["C:\\Users\\x\\ep.mp3", "", 12, Path("/a b/c")]
    got = [audacity.quote_param(v) for v in values]
    assert got == [jaudacity.quote_param(v) for v in values]
    assert (audacity._escapes_enabled() == jaudacity._escapes_enabled()
            == (env in ("escapes_on", "marker_live")))
    assert audacity.pipe_paths() == jaudacity.pipe_paths()


# ----------------------------------------------------- worker sessions
def _episode_dir(root, ext, with_index=True):
    """test_worker.py's fixture: an episode with four matcher labels, an
    index folder with one two-chapter series, and the "exported" chapter
    files (the user's Ctrl+Shift+E)."""
    work = root / "work"
    work.mkdir(parents=True)
    audio = work / "radio-2024_01_06.mp3"
    audio.write_bytes(b"\xff\xfbdummy")
    jlabels.write_labels(
        [jlabels.TimeLabel(10.0, 600.0, "Segment #1"),
         jlabels.TimeLabel(610.0, 1200.0, "Segment #2"),
         jlabels.TimeLabel(1210.0, 1800.0, "Segment #3"),
         jlabels.TimeLabel(1810.0, 2400.0, "Segment #4")],
        audio.with_suffix(".txt"))
    serie = root / "archive" / "Serie"
    serie.mkdir(parents=True)
    if with_index:
        (serie / "index.txt").write_text("Kapitel Eins\nKapitel Zwei\n")
    (root / "serie.txt").write_text("Erste Folge\nZweite Folge\n")
    names = (("Serie 1 Kapitel Eins", "Serie 2 Kapitel Zwei") if with_index
             else ("Meine Serie 1 Erste Folge", "Meine Serie 2 Zweite Folge"))
    if ext == "opus":
        tone = (np.random.default_rng(0).standard_normal(4800) * 0.05).astype(
            np.float32)
        for name in names:
            jdecode.encode_audio(work / f"{name}.opus", 48000, tone)
    else:
        for name in names:
            (work / f"{name}.{ext}").write_bytes(MP3_STUB)
    return audio


FANCY_SCRIPT = ["", "Serie 1", "Serie 1", "Serie 2", "Serie 2", "", ""]


def _session_full(pkg, root, ext):
    audio = _episode_dir(root, ext)
    pkg.pipeline.run_worker(
        pkg.pipeline.WorkerArgs(audio_paths=[audio],
                                index_folder=root / "archive",
                                export_ext=ext),
        inputs=pkg.common.Inputs(script=list(FANCY_SCRIPT)))


def _session_old_flow_worker(pkg, root, ext):
    """No index folder: old_flow, adjust_labels, merge, tag, move."""
    audio = _episode_dir(root, ext, with_index=False)
    script = ["", "Meine Serie", "serie.txt", "1", "2", "2", "", "", "", "",
              "", "", ""]
    pkg.pipeline.run_worker(
        pkg.pipeline.WorkerArgs(audio_paths=[audio], export_ext=ext),
        inputs=pkg.common.Inputs(script=script))


def _episode_labels(root):
    work = root / "work"
    work.mkdir(parents=True)
    audio = work / "radio-2024_02_03.mp3"
    audio.write_bytes(b"\xff\xfbdata")
    jlabels.write_labels(
        [jlabels.TimeLabel(0.0, 10.0, "Serie 1.1 Kap"),
         jlabels.TimeLabel(20.0, 30.0, "Serie 1.2 Kap")],
        audio.with_suffix(".txt"))
    (work / "Serie 1 Kap.mp3").write_bytes(MP3_STUB)
    return audio


def _session_named_state(pkg, root, ext):
    audio = _episode_labels(root)
    pre = pkg.audacity.AudacityApi(timeout=PIPE_TIMEOUT)
    pkg.pipeline.prepare_project(pre, audio, audio.with_suffix(".txt"))
    pre.close()
    pkg.progress.Progress(audio.parent / ".done.txt").append(
        audio.name, pkg.progress.State.NAMED)
    pkg.pipeline.run_worker(
        pkg.pipeline.WorkerArgs(audio_paths=[audio], skip_load=True),
        inputs=pkg.common.Inputs(script=[""]))


def _session_skip_name(pkg, root, ext):
    audio = _episode_labels(root)
    pkg.pipeline.run_worker(
        pkg.pipeline.WorkerArgs(audio_paths=[audio], skip_name=True,
                                dry_run=True),
        inputs=pkg.common.Inputs(script=[""]))


def _session_done_and_sub(pkg, root, ext):
    audio = _episode_labels(root)
    sub = audio.parent / "radio-2024_02_03(1).mp3"
    sub.write_bytes(b"x")
    pkg.progress.Progress(audio.parent / ".done.txt").append(
        audio.name, pkg.progress.State.DONE)
    pkg.pipeline.run_worker(
        pkg.pipeline.WorkerArgs(audio_paths=[audio, sub]),
        inputs=pkg.common.Inputs(script=[]))


def _session_old_flow(pkg, root, ext):
    """test_rename_old_flow.py's flows on four labels, one after another."""
    api = pkg.audacity.AudacityApi(timeout=PIPE_TIMEOUT)
    try:
        for script in (["Meine Serie", "serie.txt", "1", "2", "2", "2"],
                       ["#Direkt", "5", "Kapitel A", "4"],
                       ["Serie", "nope.txt", "serie.txt", "7", "0", "7",
                        "9"]):
            api.write_assume_empty("New:")
            api.write_assume_empty("NewLabelTrack:")
            for start in range(4):
                api.select_time(float(start * 100), float(start * 100 + 90))
                api.write_assume_empty("AddLabel:")
            (root / "serie.txt").write_text("Erste Folge\nZweite Folge\n")
            inputs = pkg.common.Inputs(script=script)
            pkg.rename.old_flow(None, api, inputs)
            assert inputs.script == []
            api.export_all_labels_to(root / f"{script[0]}.txt")
    finally:
        api.close()


SESSIONS = {
    "full_mp3": (_session_full, "mp3"),
    "full_opus": (_session_full, "opus"),
    "old_flow_worker": (_session_old_flow_worker, "mp3"),
    "named_state": (_session_named_state, "mp3"),
    "skip_name": (_session_skip_name, "mp3"),
    "done_and_sub": (_session_done_and_sub, "mp3"),
    "old_flow": (_session_old_flow, "mp3"),
}


def run_session(pkg, root, session, monkeypatch):
    """One session through ``pkg``'s worker against its own FakeAudacity
    in ``root/pipes`` → the server's command log (paths relative)."""
    fn, ext = SESSIONS[session]
    root.mkdir(parents=True)
    monkeypatch.chdir(root)
    monkeypatch.setenv("AUDACITY_PIPE_DIR", str(root / "pipes"))
    monkeypatch.delenv("AUDACITY_PIPE_ESCAPES", raising=False)
    srv = pkg.fake.FakeAudacity(root / "pipes")
    try:
        fn(pkg, root, ext)
        log = list(srv.command_log)  # before stop(), which may log "Exit:"
    finally:
        srv.stop()
    return [c.replace(str(root), "<root>") for c in log]


@pytest.mark.parametrize("session", sorted(SESSIONS))
def test_worker_session_matches_jax(tmp_path, monkeypatch, session):
    if SESSIONS[session][1] == "opus":
        _codecs("opus")
    logs, trees = {}, {}
    for pkg in PKGS:
        root = tmp_path / pkg.name
        logs[pkg.name] = run_session(pkg, root, session, monkeypatch)
        trees[pkg.name] = tree(root)
    assert logs["port"] == logs["jax"]
    assert trees["port"] == trees["jax"]
    got = trees["port"]
    if session.startswith("full"):
        ext = SESSIONS[session][1]
        assert got["work/.done.txt"].decode().strip().endswith("Done")
        assert f"archive/Serie/Serie 2 Kapitel Zwei.{ext}" in got
        assert b"Serie 2.2 Kapitel Zwei" in got["work/radio-2024_01_06.txt"]
        moved = tagger.TaggedFile.from_path(
            tmp_path / "port" / "archive" / "Serie" /
            f"Serie 1 Kapitel Eins.{ext}")
        assert (moved.get(tagger.Title), moved.get(tagger.TotalTracks),
                moved.get(tagger.Genre)) == ("Kapitel Eins", 2, "Hörbuch")
        assert (1, "00:00:00.000", "Part 1") in moved._inner.get_chapters()
    if session == "done_and_sub":
        assert logs["port"] == ["Exit:"]


# ------------------------------------------------------------------ CLI
CLI_CASES = {
    "consent_yes": (["work/missing.mp3", "--index-folder", "archive",
                     "--config", "w.toml", "-y", "--silent"], "", False),
    "consent_no": (["work/missing.mp3", "--index-folder", "archive",
                    "--config", "w.toml", "-n"], "", False),
    "consent_prompt": (["work/missing.mp3", "--index-folder", "archive",
                        "--config", "w.toml"], "vielleicht\nja\n", False),
    "session": (["work/radio-2024_01_06.mp3", "--index-folder", "archive",
                 "--config", "w.toml", "-n", "--silent", "--timeout", "5s"],
                "\n" + "\n".join(FANCY_SCRIPT[1:]) + "\n", True),
    "session_from_config": (["work/radio-2024_01_06.mp3", "--config",
                             "cfg.toml", "--timeout", "5", "-y", "-v"],
                            "\n" + "\n".join(FANCY_SCRIPT[1:]) + "\n", True),
    "stdin_runs_out": (["work/radio-2024_01_06.mp3", "--index-folder",
                        "archive", "--config", "w.toml", "-n",
                        "--timeout", "5"], "\nSerie 1\n", True),
    "skip_load_two": (["a.mp3", "b.mp3", "--skip-load", "--config", "w.toml",
                       "--silent"], "", False),
    "bad_timeout": (["a.mp3", "--timeout", "5 m"], "", False),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_worker_cli_matches_jax(tmp_path, monkeypatch, capsys, case):
    """``audio-worker-torch`` and ``audio-worker`` with the same argv and
    stdin: the same exit code, stdout and final tree. Without a fake
    server (no pipes, no ``audacity`` on PATH) both fail at the CLI's error
    boundary after the config step."""
    argv, stdin, server = CLI_CASES[case]
    results = {}
    for pkg in PKGS:
        root = tmp_path / pkg.name
        _episode_dir(root, "mp3")
        (root / "cfg.toml").write_text('index_folder = "archive"\n')
        monkeypatch.chdir(root)
        monkeypatch.setenv("XDG_CONFIG_HOME", str(root / "xdg"))
        monkeypatch.setenv("AUDACITY_PIPE_DIR", str(root / "pipes"))
        monkeypatch.setenv("PATH", str(root / "no_bin"))
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        srv = pkg.fake.FakeAudacity(root / "pipes") if server else None
        try:
            rc = ("rc", pkg.cli.main(list(argv)))
        except SystemExit as exc:
            rc = ("exit", exc.code)
        finally:
            if srv is not None:
                srv.stop()
        results[pkg.name] = (rc, capsys.readouterr().out, tree(root))
    assert results["port"] == results["jax"]
    if case.startswith("session"):
        assert results["port"][0] == ("rc", 0)
        assert "archive/Serie/Serie 1 Kapitel Eins.mp3" in results["port"][2]


def test_worker_parser_surface_matches_jax():
    argv = ["a.mp3", "b.mp3", "--index-folder", "/idx", "--timeout",
            "3h5m17s", "--export-ext", "opus", "--skip-load", "--skip-name",
            "--dry-run", "-y", "--config", "c.toml", "--overwrite-config"]
    assert vars(worker_cli.build_parser().parse_args(argv)) == vars(
        jworker_cli.build_parser().parse_args(argv))
    assert worker_cli.DEFAULT_GENRE == jworker_cli.DEFAULT_GENRE
    assert "--device" not in worker_cli.build_parser().format_help()


def test_scripted_inputs_never_fall_through_to_stdin(monkeypatch):
    """A script that runs out raises EOFError instead of reading stdin."""
    monkeypatch.setattr(sys, "stdin", io.StringIO("from stdin\n"))
    for mod in (common, jcommon):
        inputs = mod.Inputs(script=["eins"])
        assert inputs.read("?") == "eins"
        with pytest.raises(EOFError):
            inputs.read("?")
        with pytest.raises(EOFError):
            inputs.read_with_suggestion("?", "x", None)
    assert sys.stdin.read() == "from stdin\n"
