"""Series index catalogs (L4 metadata): Index + MultiIndex (the port's
copy of the JAX package's ``meta.index``).

Parity: reference src/worker/index.rs — a per-series chapter catalog read
from ``index.toml`` (chapter entries are ``title`` | ``[title, artist]`` |
``[title, date]`` | ``[title, artist, date]``, with series-level
artist/release defaults and an optional ``subseries`` layout),
``index_full.txt`` (``"title - artist"`` lines) or ``index.txt`` (title
only); ``#``-comment lines are skipped; empty titles become
``"{series} N"``. ``MultiIndex`` scans a directory tree with the
brace-expanded glob ``**/*.{toml, txt}``, flattens subseries into
``"main: sub"`` keys and lazily loads/caches per-series indexes with the
toml → full.txt → txt precedence (index.rs:219-241).
"""

from __future__ import annotations

import dataclasses
import datetime
import glob as globmod
import logging
import tomllib
from pathlib import Path
from typing import Iterable

log = logging.getLogger("audio_matcher_torch.index")

SUBSERIES_DELIMITER = ": "


class IndexReadError(RuntimeError):
    pass


class SeriesNotFound(IndexReadError):
    pass


class NoIndexFile(IndexReadError):
    pass


class NotSupportedFile(IndexReadError):
    def __init__(self, ext):
        super().__init__(f"only supporting .toml and .txt, but got {ext}")


class ParseError(IndexReadError):
    def __init__(self, line, parser):
        super().__init__(f"failed to parse {line!r} with {parser}")


@dataclasses.dataclass(frozen=True)
class ChapterEntry:
    title: str
    artist: str | None = None
    release: int | datetime.date | None = None

    def release_year(self) -> int | None:
        if isinstance(self.release, int):
            return self.release
        if isinstance(self.release, (datetime.date, datetime.datetime)):
            return self.release.year
        return None

    def filled(self, artist, release) -> "ChapterEntry":
        return ChapterEntry(
            title=self.title,
            artist=self.artist if self.artist is not None else artist,
            release=self.release if self.release is not None else release,
        )


def _parse_txt_line(line: str, with_artist: str) -> ChapterEntry:
    """with_artist: 'no' | 'yes' | 'try' (the reference's three Txt parsers)."""
    if with_artist == "no":
        return ChapterEntry(title=line)
    head, sep, tail = line.rpartition(" - ")
    if sep:
        return ChapterEntry(title=head, artist=tail)
    if with_artist == "try":
        return ChapterEntry(title=line)
    raise ParseError(line, "WithArtist")


def _entry_from_toml(value) -> ChapterEntry:
    if isinstance(value, str):
        return ChapterEntry(title=value)
    if isinstance(value, list):
        if len(value) == 2:
            title, second = value
            if isinstance(second, (int, datetime.date, datetime.datetime)):
                return ChapterEntry(title=title, release=second)
            return ChapterEntry(title=title, artist=second)
        if len(value) == 3:
            title, artist, release = value
            return ChapterEntry(title=title, artist=artist, release=release)
    raise IndexReadError(f"invalid chapter entry {value!r}")


class Index:
    """One series' chapters (optionally split into named subseries)."""

    def __init__(
        self,
        chapters: list[ChapterEntry] | None = None,
        extra: list[ChapterEntry] | None = None,
        subseries: list[tuple[str, list[ChapterEntry]]] | None = None,
        artist: str | None = None,
        release=None,
        url: str | None = None,
    ):
        self.chapters = chapters if chapters is not None else []
        self.extra = extra or []
        self.subseries = subseries
        self.artist = artist
        self.release = release
        self.url = url

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_toml_str(cls, content: str, name: str) -> "Index":
        try:
            data = tomllib.loads(content)
        except tomllib.TOMLDecodeError as exc:
            raise IndexReadError(str(exc)) from exc
        idx = cls(
            artist=data.get("artist"),
            release=data.get("release"),
            url=data.get("url"),
        )
        if "subseries" in data:
            idx.subseries = [
                (
                    sub.get("name", ""),
                    [_entry_from_toml(c) for c in sub.get("chapters", [])],
                )
                for sub in data["subseries"]
            ]
            idx.chapters = []
            for sub_name, chs in idx.subseries:
                _rename_empty(chs, sub_name)
        else:
            chapters = data.get("chapters", {})
            idx.chapters = [
                _entry_from_toml(c) for c in chapters.get("main", [])
            ]
            idx.extra = [_entry_from_toml(c) for c in chapters.get("extra", [])]
            _rename_empty(idx.chapters, name)
        return idx

    @classmethod
    def from_lines(
        cls, lines: Iterable[str], name: str, with_artist: str
    ) -> "Index":
        chapters = [
            _parse_txt_line(line, with_artist)
            for line in lines
            if not line.lstrip().startswith("#")
        ]
        _rename_empty(chapters, name)
        return cls(chapters=chapters)

    @classmethod
    def try_read_from_path(cls, path) -> "Index":
        path = Path(path)
        ext = path.suffix.lower()
        if ext == ".toml":
            parser = "toml"
        elif ext == ".txt":
            parser = "try"
        else:
            raise NotSupportedFile(ext or None)
        if not path.exists():
            raise NoIndexFile()
        return cls._read(path, parser)

    @classmethod
    def try_read_index(cls, folder, series) -> "Index":
        """toml → full.txt → txt precedence within ``folder/series``."""
        base = Path(folder) / str(series)
        if not base.exists():
            raise SeriesNotFound()
        for fname, parser in (
            ("index.toml", "toml"),
            ("index_full.txt", "yes"),
            ("index.txt", "no"),
        ):
            path = base / fname
            if path.exists():
                return cls._read(path, parser)
        raise NoIndexFile()

    @classmethod
    def _read(cls, path: Path, parser: str) -> "Index":
        content = path.read_text()
        name = path.stem
        if parser == "toml":
            return cls.from_toml_str(content, name)
        return cls.from_lines(content.splitlines(), name, parser)

    # -- queries ---------------------------------------------------------
    def _all_main(self) -> list[ChapterEntry]:
        if self.subseries is not None:
            return [c for _, chs in self.subseries for c in chs]
        return self.chapters

    def main_len(self) -> int:
        return len(self._all_main())

    def is_empty(self) -> bool:
        if self.subseries is not None:
            return all(not chs for _, chs in self.subseries)
        return not self.chapters and not self.extra

    def chapter_iter(self) -> Iterable[ChapterEntry]:
        for entry in self._all_main():
            yield self._fill(entry)

    def try_get(self, nr: int) -> ChapterEntry | None:
        """1-based chapter lookup (ChapterNumber.nr semantics)."""
        if self.subseries is not None:
            raise NotImplementedError("need more info to get chapter")
        if 1 <= nr <= len(self.chapters):
            return self._fill(self.chapters[nr - 1])
        return None

    def get(self, nr: int) -> ChapterEntry:
        entry = self.try_get(nr)
        if entry is None:
            raise KeyError(f"can't find chapter {nr}")
        return entry

    def _fill(self, entry: ChapterEntry) -> ChapterEntry:
        return entry.filled(self.artist, self.release)


def _rename_empty(chapters: list[ChapterEntry], series: str) -> None:
    for i, ch in enumerate(chapters, start=1):
        if ch.title == "":
            chapters[i - 1] = dataclasses.replace(ch, title=f"{series} {i}")


def split_pattern(pattern: str) -> list[str]:
    """Expand the first ``a{b1, b2}c`` into ``[ab1c, ab2c]`` (the
    reference's custom brace glob, index.rs:485-510; options split on
    ``", "`` including the space)."""
    start = pattern.find("{")
    if start == -1:
        return [pattern]
    end = pattern.find("}", start)
    if end == -1:
        return [pattern]
    pre, opts, post = pattern[:start], pattern[start + 1 : end], pattern[end + 1 :]
    return [f"{pre}{opt}{post}" for opt in opts.split(", ")]


def glob_expanded(pattern: str) -> list[Path]:
    out: list[Path] = []
    for pat in split_pattern(pattern):
        out.extend(Path(p) for p in globmod.glob(pat, recursive=True))
    return out


class MultiIndex:
    """Directory-wide registry of series indexes."""

    SUBSERIES_DELIMITER = SUBSERIES_DELIMITER

    def __init__(self, folder):
        self.folder = Path(folder)
        self.data: dict[str, Index] = {}
        self._scan()

    def _scan(self) -> None:
        self.data = {}
        rank = {"index.toml": 0, "index_full.txt": 1, "index.txt": 2}
        paths = glob_expanded(str(self.folder / "**" / "*.{toml, txt}"))
        # deterministic precedence per series dir: toml → full.txt → txt
        # (matches try_read_index) — raw glob order is filesystem-
        # arbitrary, so index_full.txt vs index.txt would be a coin flip
        for path in sorted(paths, key=lambda p: (rank.get(p.name, 3), str(p))):
            name = path.stem
            if name in ("index", "index_full"):
                name = path.parent.name
            if name in self.data:
                continue  # keep the first (highest-precedence) hit
            try:
                # same parser modes as try_read_index: full.txt lines are
                # "title - artist" (yes), index.txt titles may contain
                # " - " verbatim (no); only standalone files use "try"
                if path.name == "index_full.txt":
                    index = Index._read(path, "yes")
                elif path.name == "index.txt":
                    index = Index._read(path, "no")
                else:
                    index = Index.try_read_from_path(path)
            except IndexReadError as exc:
                log.warning("failed to open index at %s because %s", path, exc)
                continue
            self._absorb(name, index)

    def _absorb(self, name: str, index: "Index") -> None:
        """Register an index under ``name``, flattening subseries layouts
        into ``"main: sub"`` keys (the container itself is never cached —
        its ``try_get`` can't serve chapters without the sub name)."""
        if index.subseries is not None:
            for sub_name, chapters in index.subseries:
                flat = Index(
                    chapters=chapters,
                    artist=index.artist,
                    release=index.release,
                    url=index.url,
                )
                self.data.setdefault(
                    f"{name}{SUBSERIES_DELIMITER}{sub_name}", flat
                )
        else:
            self.data[name] = index

    def reload(self) -> None:
        self._scan()

    def get_possible(self) -> list[str]:
        return sorted(self.data.keys())

    @property
    def path(self) -> Path:
        return self.folder

    def has_index(self, series: str) -> bool:
        return series in self.data

    def get_known_index(self, series: str) -> Index | None:
        return self.data.get(series)

    def get_index(self, series: str) -> Index:
        """Cached lookup, falling back to a per-series directory read."""
        if series not in self.data:
            index = Index.try_read_index(self.folder, series)
            self._absorb(series, index)
            if series not in self.data:
                # subseries container: return it uncached (its try_get
                # raises until the caller names the "main: sub" key) —
                # caching it would corrupt has_index/get_possible
                return index
        return self.data[series]
