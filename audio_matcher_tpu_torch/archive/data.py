"""Archive model + label-name grammar (L5), the port's copy of the JAX
package's ``archive.data``; its label files go through the port's
``hostio.labels``.

Parity: reference src/archive/data.rs — scans an archive directory of
Audacity label files named ``{station}-{YYYY_MM_DD}.txt`` (``Source``),
parses each label name with the grammar
``"{series} {nr}[.{part}] [{chapter}]"`` where ``nr = \\d+\\??-?``
(``?`` = uncertain, ``-`` = partial), and aggregates into a
Series → Chapter → parts-per-Source tree with padded/missing-chapter
renderers and a numeric ``"{series_idx}[.{chapter_nr}]"`` search.
"""

from __future__ import annotations

import dataclasses
import datetime
import glob as globmod
import logging
import math
import re
from pathlib import Path

log = logging.getLogger("audio_matcher_torch.archive")

_NR_PATTERN = r"\d+\??\-?"
_LINE_RE = re.compile(
    rf"^(?P<series>.+?) (?P<nr>{_NR_PATTERN})"
    r"(?:\.(?P<part>\d+))?(?: (?P<chapter>.+))?$"
)
_SEARCH_RE = re.compile(r"(?P<series>\d+)(?:\.(?P<chapter>\d+\??))?")


# --------------------------------------------------------- ChapterNumber
@dataclasses.dataclass(frozen=True, order=True)
class ChapterNumber:
    nr: int
    is_maybe: bool = False
    is_partial: bool = False

    def next(self) -> "ChapterNumber":
        return dataclasses.replace(self, nr=self.nr + 1)

    @classmethod
    def parse(cls, s: str) -> "ChapterNumber":
        """``"3"``, ``"3?"``, ``"003?-"``, ``" 3- "`` → ChapterNumber.

        Suffix order is number, then ``?``, then ``-`` (data.rs:589-600).
        """
        value = s.strip()
        is_partial = value.endswith("-")
        if is_partial:
            value = value[:-1]
        is_maybe = value.endswith("?")
        if is_maybe:
            value = value[:-1]
        return cls(nr=int(value), is_maybe=is_maybe, is_partial=is_partial)

    def display(
        self,
        r_just: tuple[int, bool] | None = None,
        l_just: bool = False,
    ) -> str:
        """Render with optional right-justification (width, zero_pad) and
        left-space-padding for the ``?``/``-`` marker columns."""
        if r_just is None:
            out = str(self.nr)
        elif r_just[1]:
            out = str(self.nr).rjust(r_just[0], "0")
        else:
            out = str(self.nr).rjust(r_just[0])
        if self.is_maybe:
            out += "?"
        elif l_just:
            out += " "
        if self.is_partial:
            out += "-"
        elif l_just:
            out += " "
        return out

    def __str__(self) -> str:
        return self.display()


# ----------------------------------------------------------------- names
def build_timelabel_name(
    series_name: str | None,
    nr: ChapterNumber,
    part: int | None = None,
    chapter_name: str | None = None,
) -> str:
    """``"{series} {nr}[.{part}][ {chapter}]"`` (data.rs:63-85)."""
    out = ""
    if series_name is not None:
        out += f"{series_name} "
    out += str(nr)
    if part is not None:
        out += f".{part}"
    if chapter_name is not None:
        out += f" {chapter_name}"
    return out


def parse_line(line: str):
    """Label name → (series, ChapterNumber, part|None, chapter|None), or
    None if the grammar doesn't match (data.rs:135-157)."""
    m = _LINE_RE.match(line)
    if m is None:
        return None
    nr = ChapterNumber.parse(m.group("nr"))
    part = int(m.group("part")) if m.group("part") else None
    return (m.group("series"), nr, part, m.group("chapter"))


# ---------------------------------------------------------------- Source
@dataclasses.dataclass(frozen=True, order=True)
class Source:
    station: str
    date: datetime.date

    FILE_DATE_FMT = "%Y_%m_%d"
    DISPLAY_DATE_FMT = "%Y-%m-%d"

    class InvalidSeparator(ValueError):
        pass

    class InvalidDate(ValueError):
        pass

    @classmethod
    def parse(cls, s: str) -> "Source":
        station, sep, datestr = s.partition("-")
        if not sep:
            raise cls.InvalidSeparator(f"the name didn't contain a '-': {s!r}")
        try:
            date = datetime.datetime.strptime(datestr, cls.FILE_DATE_FMT).date()
        except ValueError as exc:
            raise cls.InvalidDate(f"the date couldn't be parsed: {s!r}") from exc
        return cls(station=station, date=date)

    @classmethod
    def from_path(cls, path) -> "Source":
        return cls.parse(Path(path).stem)

    def to_file_name(self) -> str:
        return f"{self.station}-{self.date.strftime(self.FILE_DATE_FMT)}"

    def __str__(self) -> str:
        return f"{self.station} - {self.date.strftime(self.DISPLAY_DATE_FMT)}"


# -------------------------------------------------------- Chapter/Series
class Chapter:
    def __init__(self, nr: ChapterNumber, name: str | None = None):
        self.nr = nr
        self.name = name
        self.parts: dict[Source, int] = {}

    def __eq__(self, other):
        return (
            isinstance(other, Chapter)
            and self.nr == other.nr
            and self.name == other.name
        )

    def sort_key(self):
        return (self.nr, self.name or "")

    def display(
        self, r_just: tuple[int, bool] | None = None, l_just: bool = False
    ) -> str:
        out = f"{self.nr.display(r_just, l_just)} - "
        if self.name is not None:
            out += f"{self.name} "
        sources = ", ".join(str(s) for s in sorted(self.parts.keys()))
        return out + f"[{sources}]"


class Series:
    def __init__(self, name: str):
        self.name = name
        self.chapters: list[Chapter] = []

    def display(
        self, indent: str, print_chapters: bool, print_missing: bool
    ) -> str:
        out = self.name
        if print_chapters and self.chapters:
            max_nr = self.chapters[-1].nr.nr
            nr_len = math.ceil(math.log10(max_nr + 1)) if max_nr > 0 else 1
            contains_extra = any(
                ch.nr.is_maybe or ch.nr.is_partial for ch in self.chapters
            )
            it = iter(self.chapters)
            pending = next(it, None)
            i = 0
            while pending is not None:
                i += 1
                found_some = False
                # consume nr < i too (a '0' chapter would otherwise never
                # advance and spin this loop forever)
                while pending is not None and pending.nr.nr <= i:
                    if pending.nr.nr == i:
                        found_some = True
                    out += f"\n{indent}{pending.display((nr_len, False), contains_extra)}"
                    pending = next(it, None)
                if not found_some and print_missing:
                    ghost = Chapter(ChapterNumber(i))
                    out += f"\n{indent}{ghost.display((nr_len, False), contains_extra)}"
        return out

    # chapter-list protocol for autocompletion (worker/mod.rs:592-599)
    def __len__(self) -> int:
        return len(self.chapters)

    def get(self, nr: ChapterNumber) -> str | None:
        for ch in self.chapters:
            if ch.nr == nr:
                return ch.name if ch.name is not None else "<unnamed>"
        return None

    def chapter_iter(self):
        for ch in self.chapters:
            yield (ch.nr, ch.name if ch.name is not None else "<unnamed>")


# --------------------------------------------------------------- Archive
class Archive:
    def __init__(self, series: list[Series] | None = None):
        self.data = series or []

    @staticmethod
    def _iter_label_files(path):
        """Yield ``(file, Source, labels)`` for every archive-named label
        file under ``path`` (shared by :meth:`read` and
        :meth:`rename_element`): non-archive filenames warn and are
        skipped, unreadable files are skipped silently."""
        from ..hostio.labels import read_labels

        for file in sorted(
            globmod.glob(str(Path(path) / "**" / "*.txt"), recursive=True)
        ):
            try:
                source = Source.from_path(file)
            except ValueError as exc:
                log.warning(
                    "failed to parse source %r from filename because %s",
                    file, exc,
                )
                continue
            try:
                labels = read_labels(file)
            except (OSError, ValueError):
                continue
            yield file, source, labels

    @classmethod
    def read(cls, path) -> "Archive":
        entries = [
            (source, labels)
            for _, source, labels in cls._iter_label_files(path)
        ]
        return cls.from_labels(entries)

    @classmethod
    def from_labels(cls, entries) -> "Archive":
        archive = cls()
        for source, labels in entries:
            for label in labels:
                name = label.name
                if name is not None and name.startswith("#"):
                    log.debug("skipping %r", name)
                    continue
                parsed = parse_line(name) if name is not None else None
                if parsed is None:
                    log.warning(
                        "name %r in %s couldn't be parsed to Series",
                        name, source,
                    )
                    continue
                series_name, ch_nr, _part, chapter_name = parsed
                series = archive._find_or_push_series(series_name)
                chapter = None
                for ch in series.chapters:
                    if ch.nr == ch_nr:
                        chapter = ch
                        break
                if chapter is None:
                    chapter = Chapter(ch_nr, chapter_name)
                    series.chapters.append(chapter)
                chapter.parts[source] = chapter.parts.get(source, 0) + 1
        archive.data.sort(key=lambda s: s.name)
        for series in archive.data:
            series.chapters.sort(key=Chapter.sort_key)
        return archive

    def _find_or_push_series(self, name: str) -> Series:
        for s in self.data:
            if s.name == name:
                return s
        s = Series(name)
        self.data.append(s)
        return s

    def get_series_by_name(self, identifier: str) -> Series | None:
        for s in self.data:
            if s.name == identifier:
                return s
        return None

    def get_element(self, identifier: str, just_series: bool = False):
        """``"{series_idx}[.{chapter_nr}]"`` numeric search or series name
        → Series | Chapter | None (data.rs:224-264)."""
        m = _SEARCH_RE.search(identifier)
        if m is None:
            return self.get_series_by_name(identifier)
        series_nr = int(m.group("series"))
        if not 1 <= series_nr <= len(self.data):
            return None
        found = self.data[series_nr - 1]
        chapter_str = m.group("chapter")
        if chapter_str is not None and not just_series:
            chapter_nr = int(chapter_str.rstrip("?"))
            for ch in found.chapters:
                if ch.nr.nr == chapter_nr:
                    return ch
            log.debug(
                "couldn't find Chapter with nr %s in series %r",
                chapter_nr, found.name,
            )
            return None
        return found

    def rename_element(
        self, root, identifier: str, new_name: str, dry_run: bool = False
    ) -> tuple[int, int]:
        """Rename across the whole archive on disk — BEYOND-reference
        capability (the reference's ``rename`` command is a stub,
        archive/mod.rs:60 "comming soon").

        ``identifier`` resolves an EXACT series name first (so a series
        literally named ``"Folge 7"`` is never re-interpreted as the
        numeric selector ``7``), then as a numeric ``"s[.c]"`` selector —
        which, unlike :meth:`get_element`'s read-path ``search`` (reference
        parity), must match the WHOLE identifier: ``"folge 7"`` raises
        instead of silently rewriting series #7 on disk. A chapter
        selector re-titles exactly that chapter — ``?``/``-`` marker
        variants of the same number are distinct chapters, addressable as
        ``"s.c?"``/``"s.c-"``/``"s.c?-"``; a bare ``"s.c"`` prefers the
        unmarked chapter and falls back to the first variant with that
        number. The new name is validated
        by re-parsing a probe label before anything is written — names the
        grammar would mis-split (e.g. a series ending in digits) raise
        ``ValueError``. Unparsable and ``#``-skipped labels are untouched;
        files are rewritten only when a label actually changed, and a file
        that fails to write is logged and skipped (the rest proceed).
        Returns (changed_labels, changed_files); ``dry_run`` counts
        without writing.
        """
        from ..hostio.labels import write_labels

        target = self.get_series_by_name(identifier)
        series = target
        if target is None:
            m = re.fullmatch(
                rf"(?P<series>\d+)(?:\.(?P<chapter>{_NR_PATTERN}))?",
                identifier.strip(),
            )
            if m is not None and 1 <= int(m.group("series")) <= len(self.data):
                series = self.data[int(m.group("series")) - 1]
                if m.group("chapter") is None:
                    target = series
                else:
                    want = ChapterNumber.parse(m.group("chapter"))
                    target = next(
                        (ch for ch in series.chapters if ch.nr == want), None
                    )
                    if target is None and not (
                        want.is_maybe or want.is_partial
                    ):
                        # bare number: fall back to the first marker variant
                        target = next(
                            (
                                ch
                                for ch in series.chapters
                                if ch.nr.nr == want.nr
                            ),
                            None,
                        )
        if target is None:
            raise ValueError(f"no series or chapter matches {identifier!r}")

        def validate(probe_label, expect):
            if probe_label.lstrip().startswith("#"):
                # the probe re-parses fine, but archive readers treat the
                # rewritten labels as comments — the series would vanish
                raise ValueError(
                    f"{new_name!r} would turn every label into a "
                    "'#' comment — refusing to rewrite the archive"
                )
            got = parse_line(probe_label)
            if got != expect:
                raise ValueError(
                    f"{new_name!r} does not survive the label grammar "
                    f"(probe {probe_label!r} re-parses as {got!r}) — "
                    "refusing to rewrite the archive"
                )

        if isinstance(target, Series):
            old_series = target.name
            probe_nr = ChapterNumber(1)
            validate(
                build_timelabel_name(new_name, probe_nr, None, "t"),
                (new_name, probe_nr, None, "t"),
            )

            def rewrite(series_name, nr, part, chapter):
                if series_name != old_series:
                    return None
                return build_timelabel_name(new_name, nr, part, chapter)
        else:
            validate(
                build_timelabel_name(series.name, target.nr, None, new_name),
                (series.name, target.nr, None, new_name),
            )

            def rewrite(series_name, nr, part, chapter):
                # full ChapterNumber equality: "3", "3?" and "3-" are
                # distinct chapters in the tree — only the selected one
                # is re-titled
                if series_name != series.name or nr != target.nr:
                    return None
                return build_timelabel_name(series_name, nr, part, new_name)

        changed_labels = 0
        changed_files = 0
        for file, _source, labels in self._iter_label_files(root):
            dirty = 0
            out = []
            for lb in labels:
                name = lb.name
                repl = None
                if name is not None and not name.startswith("#"):
                    parsed = parse_line(name)
                    if parsed is not None:
                        repl = rewrite(*parsed)
                if repl is not None and repl != name:
                    lb = dataclasses.replace(lb, name=repl)
                    dirty += 1
                out.append(lb)
            if dirty:
                if not dry_run:
                    try:
                        write_labels(out, file)
                    except OSError as exc:
                        log.warning(
                            "rename: failed to write %r (%s) — skipped",
                            file, exc,
                        )
                        continue
                changed_files += 1
                changed_labels += dirty
        return changed_labels, changed_files

    def display(
        self,
        indent: str = "\t",
        print_index: bool = False,
        print_all: bool = False,
        print_missing: bool = False,
    ) -> str:
        lines = []
        pad_len = (
            math.ceil(math.log10(len(self.data) + 1)) if print_index else None
        )
        pad = " " * (pad_len + 3) if pad_len is not None else ""
        for i, series in enumerate(self.data):
            prefix = f"[{i + 1:0{pad_len}}] " if pad_len is not None else ""
            lines.append(
                prefix
                + series.display(f"{pad}{indent}", print_all, print_missing)
            )
        return "\n".join(lines)
