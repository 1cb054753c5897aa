"""Resumable progress store (the worker's checkpoint/resume mechanism).

Parity: reference src/worker/mod.rs:105-394 (``progress`` module): a
line-oriented ``"{name} {State}"`` file with ordered states
Loaded < Named < Done; reads tolerate garbage lines and duplicates
(last occurrence wins, with a warning); ``append`` optimizes the common
case by appending a line (or truncating + rewriting just the last line
when only the final entry's state changed); state names parse
case-insensitively but are written capitalized (``build_line`` uses Rust's
``{:?}`` Debug format, mod.rs:334-336).
"""

from __future__ import annotations

import enum
import logging
import os
from pathlib import Path

log = logging.getLogger("audio_matcher_torch.progress")


class State(enum.IntEnum):
    LOADED = 0
    NAMED = 1
    DONE = 2

    @classmethod
    def parse(cls, text: str) -> "State | None":
        try:
            return cls[text.upper()]
        except KeyError:
            return None

    def __str__(self) -> str:  # file format: capitalized Debug-style
        return self.name.capitalize()


def _build_line(name: str, state: State) -> str:
    return f"{_safe_name(name)} {state}\n"


def _safe_name(name: str) -> str:
    """The store is line-oriented: a newline in a name would split into
    bogus entries on reload (and an empty name parses to nothing) —
    normalize once so the in-memory key and the persisted key agree."""
    safe = name.replace("\n", " ").replace("\r", " ").strip()
    return safe or "<unnamed>"


class Progress:
    """In-memory mirror of the ``.done.txt`` file with append optimization."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.content: list[tuple[str, State]] = []
        self._need_save = False
        self._load()

    def _load(self) -> None:
        self.content = []
        if not self.path.exists():
            self.path.touch()
            return
        for i, line in enumerate(self.path.read_text().splitlines()):
            head, _, tail = line.rpartition(" ")
            state = State.parse(tail) if head else None
            if not head or state is None:
                log.warning("can't parse %d:%r, will ignore", i, line)
                continue
            existing = next(
                (j for j, (n, _) in enumerate(self.content) if n == head), None
            )
            if existing is not None:
                log.warning(
                    "duplicate entry %r at line %d, forgetting old one", head, i
                )
                del self.content[existing]
            self.content.append((head, state))

    # -- queries ---------------------------------------------------------
    def get(self, name: str) -> State | None:
        name = _safe_name(name)
        for n, s in self.content:
            if n == name:
                return s
        return None

    # -- mutations -------------------------------------------------------
    def set(self, name: str, state: State) -> None:
        """In-memory update; persisted on :meth:`save`."""
        name = _safe_name(name)
        for i, (n, _) in enumerate(self.content):
            if n == name:
                self.content[i] = (n, state)
                self._need_save = True
                return
        self.content.append((name, state))
        self._need_save = True

    def remove(self, name: str) -> tuple[str, State] | None:
        name = _safe_name(name)
        for i, (n, s) in enumerate(self.content):
            if n == name:
                del self.content[i]
                self._need_save = True
                return (n, s)
        return None

    def append(self, name: str, state: State) -> None:
        """Update + persist with the reference's append optimization:
        if ``name`` is the LAST entry, truncate that line and rewrite it;
        if it's an earlier entry, move it to the end (full rewrite);
        otherwise append one line."""
        name = _safe_name(name)
        idx = next(
            (i for i, (n, _) in enumerate(self.content) if n == name), None
        )
        if idx is None:
            self.content.append((name, state))
            if not self._need_save:
                with open(self.path, "a") as f:
                    f.write(_build_line(name, state))
                return
        elif idx == len(self.content) - 1:
            self.content[idx] = (name, state)
            if not self._need_save:
                self._truncate_last_lines(1)
                with open(self.path, "a") as f:
                    f.write(_build_line(name, state))
                return
        else:
            del self.content[idx]
            self.content.append((name, state))
            self._need_save = True
        self.save()

    def truncate(self, lines: int) -> None:
        self.content = self.content[:lines]
        if not self._need_save:
            text = "".join(_build_line(n, s) for n, s in self.content)
            self.path.write_text(text)

    def save(self) -> None:
        if not self._need_save:
            return
        self.path.write_text(
            "".join(_build_line(n, s) for n, s in self.content)
        )
        self._need_save = False

    def delete(self) -> None:
        if self.path.exists():
            log.debug("deleting progress file")
            self.path.unlink()

    def _truncate_last_lines(self, count: int) -> None:
        """Drop the last ``count`` lines of the file in place."""
        if not self.path.exists():
            return
        data = self.path.read_bytes()
        end = len(data)
        for _ in range(count):
            cut = data.rfind(b"\n", 0, end - 1 if end else 0)
            end = cut + 1 if cut != -1 else 0
        with open(self.path, "r+b") as f:
            f.truncate(end)
            f.seek(0, os.SEEK_END)
