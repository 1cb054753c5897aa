"""Label-renaming UX: completers + the two renaming flows (L4), the port's
copy of the JAX package's ``worker.rename``.

Parity: reference src/worker/mod.rs ``rename_labels`` module — the ``old``
flow (prompt the series once, then per label a chapter number + part count
with ``EXPECTED_PARTS`` expectations) and the ``FancyNamer`` (per-label
free-form ``"series nr chapter"`` input parsed by the archive grammar with
auto part increment and in-loop commands ``reload_index`` /
``reload_label`` / ``resize`` / ``join``), both zooming Audacity onto each
label gap and autocompleting with a Levenshtein metric.
"""

from __future__ import annotations

import logging

from ..archive.data import ChapterNumber, build_timelabel_name, parse_line
from ..cli.common import Inputs
from ..meta.index import IndexReadError, MultiIndex
from ..utils.strmetric import Levenshtein, sort_with
from .audacity import AudacityApi

log = logging.getLogger("audio_matcher_torch.rename")

# expected part count by total label count (worker/mod.rs:786)
EXPECTED_PARTS = [0, 1, 2, 3, 4, 3, 3, 4, 4, 3, 5, 4, 4]
COMMAND_PREFIX = "> "
COMMANDS = ("reload_index", "reload_label", "resize", "join")

ASK_ALL_MSG = "Which episode is next:"
ASK_PARTS_MSG = "How many parts does the next episode have"
ASK_NUMBER_MSG = "Which number does the next episode have"
ASK_SERIES_MSG = "Which series is up today:"


class _IndexChapters:
    """Adapter: ``meta.index.Index`` (try_get(int) → entry with .title)."""

    def __init__(self, index):
        self._index = index

    def __len__(self) -> int:
        return self._index.main_len()

    def title(self, nr: ChapterNumber) -> str | None:
        entry = self._index.try_get(nr.nr)
        return None if entry is None else entry.title

    def items(self):
        for i, entry in enumerate(self._index.chapter_iter(), start=1):
            yield (ChapterNumber(i), entry.title)


class _SeriesChapters:
    """Adapter: ``archive.data.Series`` (get(ChapterNumber) → name,
    chapter_iter() → (nr, name))."""

    def __init__(self, series):
        self._series = series

    def __len__(self) -> int:
        return len(self._series)

    def title(self, nr: ChapterNumber) -> str | None:
        return self._series.get(nr)

    def items(self):
        yield from self._series.chapter_iter()


def _adapt_chapter_source(provider):
    """Explicit provider dispatch — a new chapter-list provider must be
    given an adapter here rather than half-matching by accident."""
    if hasattr(provider, "title") and hasattr(provider, "items"):
        return provider  # already an adapter (or adapter-compatible)
    if hasattr(provider, "try_get"):
        return _IndexChapters(provider)
    if hasattr(provider, "chapter_iter") and hasattr(provider, "get"):
        return _SeriesChapters(provider)
    raise TypeError(
        f"unsupported chapter-list provider {type(provider).__name__!r}: "
        "pass an Index, a Series, or an adapter with title()/items()/len()"
    )


class ChapterCompleter:
    """Suggest chapters of one series (worker/mod.rs:563-659).

    Numeric input lists chapter numbers starting with those digits; text
    input ranks chapters by string similarity.
    """

    def __init__(self, chapter_list, metric: Levenshtein | None = None):
        self.index = _adapt_chapter_source(chapter_list)
        self.metric = metric or Levenshtein(True)

    def get_suggestions(self, text: str) -> list[str]:
        try:
            number = ChapterNumber.parse(text)
        except ValueError:
            ranked = sort_with(
                self.metric, list(self.index.items()), text,
                key=lambda t: t[1],
            )
            return [f"{nr} {name}" for nr, name in ranked]
        if number.is_maybe or number.is_partial:
            name = self.index.title(number)
            return [f"{number} {name}"] if name is not None else []
        # iterate the ACTUAL chapters: an archive Series is sparse and
        # marker-numbered, so range(1, len+1) would miss every entry
        out = []
        for nr, name in self.index.items():
            if str(nr.nr).startswith(str(number.nr)) and name is not None:
                out.append(f"{nr} {name}")
        return out


class FullNameCompleter:
    """Suggest ``"{series} {chapter...}"`` full names plus `> commands`
    (worker/mod.rs:684-772)."""

    def __init__(self, m_index: MultiIndex, metric: Levenshtein | None = None):
        self.m_index = m_index
        self.metric = metric or Levenshtein(True)
        self.series: str | None = None

    def get_suggestions(self, text: str) -> list[str]:
        if text.startswith(COMMAND_PREFIX):
            cmd = text[len(COMMAND_PREFIX):]
            ranked = sort_with(self.metric, COMMANDS, cmd)
            return [f"{COMMAND_PREFIX}{c}" for c in ranked]
        if self.series and text.startswith(self.series + " "):
            chapter_part = text[len(self.series) + 1 :]
            index = self.m_index.get_known_index(self.series)
            if index is None:
                return []
            inner = ChapterCompleter(index, self.metric)
            return [
                f"{self.series} {s}"
                for s in inner.get_suggestions(chapter_part)
            ]
        self.series = None
        ranked = sort_with(self.metric, self.m_index.get_possible(), text)
        return ranked


def get_labels(api: AudacityApi):
    """Exactly one label track expected (worker/mod.rs:792-800)."""
    info = api.get_label_info()
    if len(info) != 1:
        raise RuntimeError(
            f"expecting one label track, but got {len(info)}"
        )
    return next(iter(info.values()))


def zoom_to_gap(api: AudacityApi, prev_end: float, next_start: float) -> None:
    # parity: zoom_to_label (worker/mod.rs:1136-1154): ±10 s context
    api.zoom_to(max(prev_end - 10.0, 0.0), next_start + 10.0)


def _gap_bounds(labels, i: int) -> tuple[float, float]:
    """The inter-label gap presented for label i (open-border pairs)."""
    if not labels:
        return 0.0, 10.0
    if i == 0:
        lb = labels[0]
        return lb.start, lb.start + 10.0
    if i >= len(labels):
        lb = labels[-1]
        return lb.end, lb.end + 10.0
    return labels[i - 1].end, labels[i].start


def old_flow(args, api: AudacityApi, inputs: Inputs) -> None:
    """The non-index renaming flow (worker/mod.rs:852-920)."""
    labels = get_labels(api)
    series = inputs.read(ASK_SERIES_MSG)
    index = None
    if series.startswith("#"):
        series = series[1:]
    else:
        from ..meta.index import Index

        while True:
            path = inputs.read(
                "which index file do you want to use? (empty for none): ", ""
            )
            if not path:
                break
            try:
                index = Index.try_read_from_path(path)
                break
            except IndexReadError:
                print("couldn't find requested index, try again")

    expected_next: ChapterNumber | None = None
    i = 0
    while i < len(labels):
        number = inputs.try_read(
            f"{ASK_NUMBER_MSG}"
            + (f", expecting {expected_next}" if expected_next else "")
            + ": ",
            expected_next,
            lambda s: _try_parse_nr(s),
        )
        if number is None:
            raise ValueError("need a chapter number")
        expected_next = number.next()

        if index is not None:
            entry = index.try_get(number.nr)
            # None, not "": build_timelabel_name would append a trailing
            # space the archive grammar can never re-parse
            chapter_name = entry.title if entry is not None else None
        else:
            chapter_name = (
                inputs.read("What is the next episode called: ") or None
            )

        remaining = len(labels) - i
        expected_parts = min(
            EXPECTED_PARTS[len(labels)] if len(labels) < len(EXPECTED_PARTS) else 4,
            remaining,
        )
        count = inputs.try_read(
            f"{ASK_PARTS_MSG}, expecting {expected_parts}: ",
            expected_parts,
            lambda s: int(s) if s.isdigit() else None,
        )
        # `count or ...` would discard an explicit 0 answer
        count = min(
            count if count is not None else expected_parts, remaining
        )
        if count <= 0:
            continue  # re-prompt from the chapter number
        for j in range(count):
            name = build_timelabel_name(series, number, j + 1, chapter_name)
            api.set_label(i + j, name, selected=False)
        i += count


def _try_parse_nr(s: str):
    try:
        return ChapterNumber.parse(s.split(" ")[0])
    except ValueError:
        return None


class FancyNamer:
    """Per-label free-form renaming with commands (worker/mod.rs:964-1119)."""

    def __init__(self, api: AudacityApi, m_index: MultiIndex, inputs: Inputs):
        self.api = api
        self.m_index = m_index
        self.inputs = inputs
        self.labels = get_labels(api)
        self.last_read: tuple[str, ChapterNumber, int, str] | None = None
        self.i = 0

    def rename(self) -> None:
        while self.i < len(self.labels):
            zoom_to_gap(self.api, *_gap_bounds(self.labels, self.i))
            parsed = self._read_one()
            if parsed is None:
                continue
            series, nr, chapter, part = parsed
            name = build_timelabel_name(series, nr, part, chapter)
            self.api.set_label(self.i, name, selected=False)
            self.i += 1
        zoom_to_gap(self.api, *_gap_bounds(self.labels, len(self.labels)))
        self.inputs.read(
            "Press Enter when you are ready for the next step", ""
        )

    def _read_one(self):
        initial = None
        if self.last_read is not None:
            series, nr, _part, chapter = self.last_read
            if self.m_index.has_index(series) or chapter is None:
                initial = f"{series} {nr}"
            else:
                initial = f"{series} {nr} {chapter}"
        completer = FullNameCompleter(self.m_index)
        if self.last_read is not None:
            completer.series = self.last_read[0]
        res = self.inputs.read_with_suggestion(ASK_ALL_MSG, initial, completer)

        if res.startswith(COMMAND_PREFIX):
            cmd = res[len(COMMAND_PREFIX):]
            if cmd in COMMANDS:
                self.run_command(cmd)
            else:
                print(f"unknown command {cmd!r}")
            return None

        parsed = parse_line(res)
        if parsed is None:
            print(f"couldn't parse {res}")
            return None
        series, nr, _part, chapter = parsed
        if chapter is None:
            try:
                index = self.m_index.get_index(series)
                entry = index.try_get(nr.nr)
                chapter = entry.title if entry is not None else None
            except (IndexReadError, NotImplementedError):
                # NotImplementedError: a subseries-layout index needs the
                # "main: sub" key — fall through to the manual prompt
                chapter = None
            if chapter is None:
                chapter = (
                    self.inputs.read("What is the next episode called: ")
                    or None
                )
        if (
            self.last_read is not None
            and self.last_read[0] == series
            and self.last_read[1] == nr
        ):
            part = self.last_read[2] + 1
        else:
            part = 1
        self.last_read = (series, nr, part, chapter)
        return series, nr, chapter, part

    def run_command(self, command: str) -> None:
        if command == "reload_index":
            self.m_index.reload()
        elif command == "reload_label":
            old = self.labels[self.i] if self.i < len(self.labels) else None
            self.labels = get_labels(self.api)
            if old is not None and self.i < len(self.labels):
                if self.labels[self.i] != old:
                    for j, lb in enumerate(self.labels):
                        if lb == old:
                            self.i = j
                            break
        elif command == "resize":
            self.i = 0
            self.last_read = None
            self.labels = get_labels(self.api)
        elif command == "join":
            if self.i == 0:
                log.warning("can't join first")
                return
            gone = self.labels.pop(self.i)
            self.api.select_time(gone.start, gone.end)
            # the REAL label track — track 1 is only the standard
            # import-audio-then-labels layout; SplitDelete on a wave
            # track would cut audio instead of removing the label
            track = self.api.get_first_label_track_nr()
            self.api.select_tracks([track if track is not None else 1])
            self.api.write_assume_empty("SplitDelete:")
            self.api.set_label(self.i - 1, end=gone.end)
            # keep the local copy in step for the next gap zoom
            self.labels[self.i - 1].end = gone.end


def adjust_labels(api: AudacityApi, inputs: Inputs) -> None:
    """Walk every label gap for manual boundary adjustment
    (worker/mod.rs:1121-1135)."""
    labels = [
        lb for track in sorted(api.get_label_info())
        for lb in api.get_label_info()[track]
    ]
    for i in range(len(labels) + 1):
        zoom_to_gap(api, *_gap_bounds(labels, i))
        inputs.read("Press Enter when you are ready for the next step", "")
