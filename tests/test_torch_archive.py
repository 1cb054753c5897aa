"""The port's archive tools against the JAX package's, on the CPU.

``utils.strmetric``, ``utils.config``, ``meta.index``, the label-name
grammar and the archive model of ``archive.data``, the REPL of
``archive.repl`` and ``archive-scroller-torch`` (``cli.archive_cli``)
against their JAX originals: the same inputs, made from seeds, through both
packages give equal values, equal error classes, equal stdout, equal exit
codes and byte-equal files (configs, rewritten label files). A test that
writes files gives each package its own copy of the tree.
"""

import dataclasses
import io
import logging
import random
import string
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from audio_matcher_tpu.archive import data as jdata  # noqa: E402
from audio_matcher_tpu.archive import repl as jrepl  # noqa: E402
from audio_matcher_tpu.cli import archive_cli as jarchive_cli  # noqa: E402
from audio_matcher_tpu.meta import index as jindex  # noqa: E402
from audio_matcher_tpu.utils import config as jconfig  # noqa: E402
from audio_matcher_tpu.utils import strmetric as jstrmetric  # noqa: E402

from audio_matcher_tpu_torch.archive import data, repl  # noqa: E402
from audio_matcher_tpu_torch.cli import archive_cli  # noqa: E402
from audio_matcher_tpu_torch.hostio.labels import (  # noqa: E402
    TimeLabel,
    write_labels,
)
from audio_matcher_tpu_torch.meta import index  # noqa: E402
from audio_matcher_tpu_torch.utils import config, strmetric  # noqa: E402

SIDES = ("jax", "port")


def plain(x):
    """A value with each package's dataclasses turned into (class name,
    fields), so that the two packages' results compare equal."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def outcome(fn, *args, **kwargs):
    """("ok", plain result) or ("raised", error class name, message)."""
    try:
        return ("ok", plain(fn(*args, **kwargs)))
    except Exception as exc:  # noqa: BLE001 — the class is compared
        return ("raised", type(exc).__name__, str(exc))


def tree(root):
    """Every file under ``root``: relative path → bytes."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# ------------------------------------------------------------ strmetric
@pytest.mark.parametrize("ignore_case", [True, False])
def test_levenshtein_and_sort_with_match_jax(ignore_case):
    rng = np.random.default_rng(11)
    alphabet = list("abcABCxyzäöß -17")
    words = ["".join(rng.choice(alphabet, size=int(rng.integers(0, 14))))
             for _ in range(80)]
    for a, b in zip(words, words[1:] + words[:1]):
        assert strmetric.levenshtein(a, b) == jstrmetric.levenshtein(a, b)
    metric = strmetric.Levenshtein(ignore_case)
    jmetric = jstrmetric.Levenshtein(ignore_case)
    for query in words[:12]:
        assert ([metric.similarity(w, query) for w in words]
                == [jmetric.similarity(w, query) for w in words])
        assert (strmetric.sort_with(metric, words, query)
                == jstrmetric.sort_with(jmetric, words, query))
        pairs = list(enumerate(words))
        assert (strmetric.sort_with(metric, pairs, query, key=lambda t: t[1])
                == jstrmetric.sort_with(jmetric, pairs, query,
                                        key=lambda t: t[1]))


# --------------------------------------------------------------- config
CONFIGS = [
    {"version": 1, "path": "/archiv/Hörbücher/Ärger"},
    {"genre": "Hörbuch", "index_folder": 'C:\\idx "zitiert"\tTab\nNL\x01\x7f',
     "n": 3, "f": 0.25, "flag": True, "off": False, "none": None},
    {"list": [1, "zwei", 3.5, False, ["x"]],
     "tbl": {"a": "ä", "b": None, "c": [1, 2]}, "after": "\r\\"},
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=["plain", "escapes", "tables"])
def test_config_bytes_match_jax(tmp_path, monkeypatch, cfg):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "xdg"))
    assert config.config_dir() == jconfig.config_dir()
    assert (config.default_config_path("worker")
            == jconfig.default_config_path("worker"))
    assert config.dumps_toml(cfg) == jconfig.dumps_toml(cfg)
    got = config.save_config("worker", cfg, tmp_path / "port.toml")
    want = jconfig.save_config("worker", cfg, tmp_path / "jax.toml")
    assert got.read_bytes() == want.read_bytes()
    # DEL (0x7f) stays unescaped in both, so that file does not load in
    # either (the same error class)
    assert (outcome(config.load_config, "worker", got)
            == outcome(jconfig.load_config, "worker", want))
    # the default path under XDG_CONFIG_HOME: the same file for both
    default = config.save_config("archive", cfg)
    port_bytes = default.read_bytes()
    assert jconfig.save_config("archive", cfg) == default
    assert default.read_bytes() == port_bytes
    assert (outcome(config.load_config, "archive")
            == outcome(jconfig.load_config, "archive"))
    assert config.load_config("missing") == jconfig.load_config("missing")
    for mod in (config, jconfig):
        with pytest.raises(TypeError):
            mod.dumps_toml({"bad": {1, 2}})


# ---------------------------------------------------------------- index
INDEX_FILES = {
    "toml": ("index.toml",
             'artist = "Erzähler"\nrelease = 1999\nurl = "http://x"\n'
             '[chapters]\nmain = ["Eins", ["Zwei", "Andere"], '
             '["Drei", 2001], ["Vier", "A", 1979-05-27], ""]\n'
             'extra = ["Bonus"]\n'),
    "subseries": ("index.toml",
                  'artist = "B"\n[[subseries]]\nname = "Teil A"\n'
                  'chapters = ["a1", ""]\n[[subseries]]\nname = "Teil B"\n'
                  'chapters = [["b1", "X"]]\n'),
    "full_txt": ("index_full.txt",
                 "Titel eins - Autor\n# Kommentar\nTitel - mit - Strich - B\n"),
    "txt": ("index.txt", "Kapitel Eins\n\n  # c\nKapitel - Zwei\n"),
    "bad_toml": ("index.toml", "chapters = [\n"),
    "bad_entry": ("index.toml", '[chapters]\nmain = [["a", "b", 1, 2]]\n'),
    "bad_full": ("index_full.txt", "kein Autor hier\n"),
    "no_file": None,
}


def _index_view(idx):
    out = {"main_len": idx.main_len(), "empty": idx.is_empty(),
           "artist": idx.artist, "release": idx.release, "url": idx.url,
           "extra": plain(idx.extra), "subseries": plain(idx.subseries)}
    out["chapters"] = plain(list(idx.chapter_iter()))
    out["get"] = [outcome(idx.try_get, nr) for nr in range(0, 7)]
    out["years"] = [e.release_year() for e in idx.chapter_iter()]
    return out


def _read_index(mod, folder, series):
    return outcome(lambda: _index_view(
        mod.Index.try_read_index(folder, series)))


@pytest.mark.parametrize("case", sorted(INDEX_FILES))
def test_index_matches_jax(tmp_path, case):
    folder = tmp_path / "idx"
    (folder / case).mkdir(parents=True)
    if INDEX_FILES[case] is not None:
        name, text = INDEX_FILES[case]
        (folder / case / name).write_text(text)
        path = folder / case / name
        assert (outcome(lambda: _index_view(
                    index.Index.try_read_from_path(path)))
                == outcome(lambda: _index_view(
                    jindex.Index.try_read_from_path(path))))
    assert (_read_index(index, folder, case)
            == _read_index(jindex, folder, case))
    assert (_read_index(index, folder, "Unbekannt")
            == _read_index(jindex, folder, "Unbekannt")
            == ("raised", "SeriesNotFound", ""))
    for suffix in (".md", ".toml"):
        path = tmp_path / f"elsewhere{suffix}"
        assert (outcome(index.Index.try_read_from_path, path)
                == outcome(jindex.Index.try_read_from_path, path))


def test_multi_index_matches_jax(tmp_path, caplog):
    caplog.set_level(logging.WARNING)  # whatever an earlier CLI set
    folder = tmp_path / "idx"
    for case, spec in INDEX_FILES.items():
        (folder / case).mkdir(parents=True)
        if spec is not None:
            (folder / case / spec[0]).write_text(spec[1])
    (folder / "txt" / "index_full.txt").write_text("Vorrang - Hat\n")
    (folder / "Solo.txt").write_text("Nur - Einer\nZwei\n")
    (folder / "Solo2.toml").write_text('[chapters]\nmain = ["x"]\n')
    (folder / "notes.md").write_text("ignored")
    views, logs = [], []
    for mod in (index, jindex):
        caplog.clear()
        m = mod.MultiIndex(folder)
        keys = m.get_possible()
        views.append((keys, [_index_view(m.get_index(k)) for k in keys],
                      [m.has_index(k) for k in keys + ["nope"]],
                      outcome(lambda: _index_view(m.get_index("no_file"))),
                      m.path))
        m.reload()
        assert m.get_possible() == keys
        logs.append([r.getMessage() for r in caplog.records])
    assert views[0] == views[1]
    assert logs[0] == logs[1] and logs[0]  # the bad files warned alike
    assert index.split_pattern("a/*.{toml, txt}") == jindex.split_pattern(
        "a/*.{toml, txt}")


# -------------------------------------------------------------- grammar
def _grammar_inputs(kind):
    """The cases of tests/test_grammar_fuzz.py, and seeded random names."""
    if kind == "printable":
        rng = random.Random(0)
        return ["".join(rng.choice(string.printable)
                        for _ in range(rng.randint(0, 40)))
                for _ in range(2000)]
    if kind == "built":
        rng = random.Random(1)
        out = []
        for _ in range(500):
            series = "".join(
                rng.choice(string.ascii_letters + " ")
                for _ in range(rng.randint(1, 12))).strip() or "S"
            nr = (rng.randint(1, 999), rng.random() < 0.3, rng.random() < 0.3)
            part = rng.choice([None, rng.randint(1, 9)])
            chapter = rng.choice([None, "Kapitel X", "Mit 3 Zahlen 7"])
            out.append((series, nr, part, chapter))
        return out
    if kind == "chapter_number":
        rng = random.Random(2)
        return [(rng.randint(0, 10_000), rng.random() < 0.5,
                 rng.random() < 0.5) for _ in range(500)]
    rng = np.random.default_rng(3)  # kind == "numpy_names"
    pieces = ["Serie", "Die drei ???", "7", "3?", "12-", "4?-", ".2", " ",
              "Kapitel", "#", "ä", "1.1", "Folge 9", "-", "?", "x.y"]
    return ["".join(rng.choice(pieces, size=int(rng.integers(1, 7))))
            for _ in range(1500)]


def _grammar_run(mod, kind, inputs):
    out = []
    for item in inputs:
        if kind in ("printable", "numpy_names"):
            out.append(outcome(mod.parse_line, item))
            out.append(outcome(mod.ChapterNumber.parse, item))
        elif kind == "built":
            series, (n, maybe, partial), part, chapter = item
            nr = mod.ChapterNumber(n, maybe, partial)
            name = mod.build_timelabel_name(series, nr, part, chapter)
            out.append((name, plain(mod.parse_line(name)),
                        mod.build_timelabel_name(None, nr, None, None)))
        else:
            nr = mod.ChapterNumber(*item)
            out.append((str(nr), plain(mod.ChapterNumber.parse(str(nr))),
                        nr.display((5, True), True), nr.display((3, False)),
                        plain(nr.next()), nr < mod.ChapterNumber(500)))
    return out


@pytest.mark.parametrize(
    "kind", ["printable", "built", "chapter_number", "numpy_names"])
def test_grammar_matches_jax(kind):
    inputs = _grammar_inputs(kind)
    assert _grammar_run(data, kind, inputs) == _grammar_run(jdata, kind,
                                                            inputs)


# -------------------------------------------------------------- archive
SERIES = ["Grusel", "Die drei ???", "Krimi Klassiker", "Serie 7", "Ärger"]


def make_archive(root, seed=5):
    """Label files named ``{station}-{YYYY_MM_DD}.txt`` with seeded label
    names (markers, parts, chapters, comments, unparsable names), one in a
    subfolder, and a file whose name is not a source."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "sub").mkdir()
    for day in range(1, 8):
        labels, t = [], 0.0
        for _ in range(int(rng.integers(2, 8))):
            nr = jdata.ChapterNumber(int(rng.integers(0, 12)),
                                     bool(rng.random() < 0.2),
                                     bool(rng.random() < 0.2))
            name = jdata.build_timelabel_name(
                SERIES[int(rng.integers(len(SERIES)))], nr,
                [None, 1, 2][int(rng.integers(3))],
                [None, "Kapitel X", "Die Rache"][int(rng.integers(3))])
            labels.append(TimeLabel(t, t + 5.0, name))
            t += 10.0
        labels += [TimeLabel(t, t + 1.0, "# Kommentar"),
                   TimeLabel(t + 2.0, t + 3.0, "unlesbar"),
                   TimeLabel(t + 4.0, t + 5.0, None)]
        folder = root / "sub" if day == 7 else root
        station = "radio" if day % 2 else "welle"
        write_labels(labels, folder / f"{station}-2024_01_{day:02}.txt")
    (root / "notizen.txt").write_text("keine Quelle\n")
    (root / "welle-2024_13_40.txt").write_text("1.0\t2.0\tSerie 1\n")
    return root


def test_archive_model_matches_jax(tmp_path, caplog):
    caplog.set_level(logging.WARNING)  # whatever an earlier CLI set
    root = make_archive(tmp_path / "arch")
    views, logs = [], []
    for mod in (data, jdata):
        caplog.clear()
        archive = mod.Archive.read(root)
        view = [archive.display(indent, pi, pa, pm)
                for indent in ("\t", "  ") for pi in (False, True)
                for pa in (False, True) for pm in (False, True)]
        for ident in ("1", "2", "2.3", "3.0", "4.99", "9", "Grusel", "x",
                      "1.5?", "Ärger"):
            found = archive.get_element(ident)
            view.append((ident, type(found).__name__, getattr(
                found, "name", None), str(getattr(found, "nr", ""))))
            view.append(type(archive.get_element(ident, True)).__name__)
        for series in archive.data:
            view.append((series.name, len(series), [
                (str(nr), name) for nr, name in series.chapter_iter()],
                [series.get(ch.nr) for ch in series.chapters]))
            view += [(ch.display(), ch.sort_key() == ch.sort_key(),
                      sorted((str(s), n) for s, n in ch.parts.items()))
                     for ch in series.chapters]
        views.append(view)
        logs.append([r.getMessage() for r in caplog.records])
    assert views[0] == views[1]
    assert logs[0] == logs[1]
    for text in ("radio-2024_01_06", "kein-trenner", "radio", "a-2024_02_30"):
        assert (outcome(lambda: str(data.Source.parse(text)))
                == outcome(lambda: str(jdata.Source.parse(text))))


REPL_SCRIPTS = {
    "list": "list\nlist -c\nlist '  ' -c -m\nlist -h\nexit\nlist\n",
    "rename": ("list -c -m\nrename 1 'Neue Serie' --dry-run\n"
               "rename 2.3 'Neuer Titel'\nlist -c\nreload\nlist -c\n"),
    "errors": ("rename Grusel Schauer\nlist -c\nrename 1.99 x\nbogus\n"
               "list \"offen\n\nrename 'Serie 7' '#Kommentar'\n"
               "rename 1 'Endet 9'\nrename 2.4? Fragezeichen\nlist -c\n"),
    "reload_path": "reload sub\nlist -c -m\nrename 1 Neu\nreload\nlist -c\n",
}


@pytest.mark.parametrize("script", sorted(REPL_SCRIPTS))
@pytest.mark.parametrize("dry_run", [False, True])
def test_repl_session_matches_jax(tmp_path, monkeypatch, capsys, caplog,
                                  script, dry_run):
    """One scripted REPL session through each package's ``Holder``: the
    same stdout, the same warnings and the same label files after it."""
    caplog.set_level(logging.WARNING)  # whatever an earlier CLI set
    results = {}
    for side, mod in zip(SIDES, (jrepl, repl)):
        root = make_archive(tmp_path / side)
        monkeypatch.chdir(root)
        monkeypatch.setattr(sys, "stdin", io.StringIO(REPL_SCRIPTS[script]))
        caplog.clear()
        holder = mod.Holder(Path("."), dry_run=dry_run)
        holder.repl()
        holder.list_all()
        results[side] = (capsys.readouterr().out,
                         [r.getMessage() for r in caplog.records], tree(root))
    assert results["port"] == results["jax"]
    if script == "rename" and not dry_run:
        assert "renamed" in results["port"][0]


def test_repl_parser_matches_jax():
    for line in ("list", "list -c -m", "list '  '", "reload", "reload x",
                 "rename 1 neu -n", "rename 'a b' 'c d'", "exit"):
        assert vars(repl.parse_command(line)) == vars(
            jrepl.parse_command(line))
    for line in ("bogus", "list \"offen", "rename", "list --nope"):
        got = outcome(repl.parse_command, line)
        want = outcome(jrepl.parse_command, line)
        assert got[:2] == want[:2] == ("raised", "CommandError")


# ------------------------------------------------------------------- CLI
CLI_CASES = {
    "save_yes": (["arch", "--config", "cfg.toml", "-y", "--silent"], ""),
    "no": (["arch", "--config", "cfg.toml", "-n"], ""),
    "prompt_consent": (["arch", "--config", "cfg.toml"], "vielleicht\nja\n"),
    "ask_path": (["--config", "cfg.toml", "--silent"], "arch\n"),
    "ask_path_eof": (["--config", "cfg.toml", "-n"], ""),
    "interactive_dry": (["arch", "--config", "cfg.toml", "-i", "-y",
                         "--dry-run"], "list -c\nrename 1 Neu\nlist\nexit\n"),
    "interactive": (["arch", "-i", "-n", "--silent"],
                    "rename 2 Umbenannt\nlist -c -m\n"),
    "overwrite": (["arch", "--config", "old.toml", "--overwrite-config",
                   "-y"], ""),
    "from_config": (["--config", "old.toml", "-v"], ""),
    "xdg_default": (["arch", "-y", "--silent"], ""),
    "bad_flag": (["arch", "--bogus"], ""),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_archive_cli_matches_jax(tmp_path, monkeypatch, capsys, case):
    """``archive-scroller-torch`` and ``archive-scroller`` with the same
    argv and stdin: equal exit codes (or the same exception), equal stdout
    and byte-equal trees (configs, label files)."""
    argv, stdin = CLI_CASES[case]
    results = {}
    for side, mod in zip(SIDES, (jarchive_cli, archive_cli)):
        root = tmp_path / side
        make_archive(root / "arch")
        (root / "old.toml").write_text('version = 1\npath = "arch"\n')
        monkeypatch.chdir(root)
        monkeypatch.setenv("XDG_CONFIG_HOME", str(root / "xdg"))
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        try:
            rc = ("rc", mod.main(list(argv)))
        except SystemExit as exc:
            rc = ("exit", exc.code)
        except EOFError as exc:
            rc = ("raised", type(exc).__name__)
        out = capsys.readouterr().out
        results[side] = (rc, out, tree(root))
    assert results["port"] == results["jax"]
    if case in ("save_yes", "from_config", "interactive"):
        assert results["port"][0] == ("rc", 0) and "Kapitel X" in results[
            "port"][1]


def test_archive_parser_surface_matches_jax():
    argv = ["arch", "-i", "--dry-run", "--config", "c.toml",
            "--overwrite-config", "-y", "-vv"]
    assert vars(archive_cli.build_parser().parse_args(argv)) == vars(
        jarchive_cli.build_parser().parse_args(argv))
    assert "--device" not in archive_cli.build_parser().format_help()
