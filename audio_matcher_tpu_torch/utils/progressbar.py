"""Terminal progress bar with a two-segment arrow.

Parity: the reference's first-party ``progress_bar`` crate (SURVEY.md §2.16):
a bounded bar over the chunk iterator whose per-item *start* and *finish*
callbacks drive a two-segment arrow (segment 1 = chunks dispatched,
segment 2 = chunks finished), with a ``Simple`` ASCII arrow and a ``Fancy``
glyph arrow (``--fancy-bar``), clamped to the terminal width.
"""

from __future__ import annotations

import os
import shutil
import sys
import threading


class Arrow:
    """Renders two progress fractions into one arrow body."""

    head = ">"
    seg_chars = ("=", "-")
    bracket = ("[", "]")

    def render(self, fracs: tuple[float, float], width: int) -> str:
        inner = max(width - 2, 1)
        done2 = int(fracs[1] * inner)  # finished
        done1 = int(fracs[0] * inner)  # dispatched (>= finished)
        done1 = max(done1, done2)
        body = self.seg_chars[0] * done2 + self.seg_chars[1] * (done1 - done2)
        if len(body) < inner:
            body += self.head
        body = body[:inner].ljust(inner)
        return f"{self.bracket[0]}{body}{self.bracket[1]}"


class FancyArrow(Arrow):
    head = "➤"
    seg_chars = ("█", "▒")
    bracket = ("┤", "├")


class Progress:
    """Bounded progress over ``total`` items with 2-phase callbacks.

    ``start(i)`` marks item *i* dispatched, ``finish(i)`` marks it complete.
    Thread-safe so parallel workers can report like the reference's rayon
    chunks did.
    """

    def __init__(
        self,
        total: int,
        prefix: str = "Progress: ",
        fancy: bool = False,
        stream=None,
        enabled: bool | None = None,
    ):
        self.total = max(total, 1)
        self.prefix = prefix
        self.arrow = FancyArrow() if fancy else Arrow()
        self.stream = stream if stream is not None else sys.stderr
        self._started = 0
        self._finished = 0
        self._closed = False
        self._lock = threading.Lock()
        if enabled is None:
            enabled = hasattr(self.stream, "isatty") and self.stream.isatty()
        self.enabled = enabled
        try:
            # width of the TTY the bar actually writes to (stderr);
            # shutil's default consults COLUMNS/stdout
            self.max_len = os.get_terminal_size(self.stream.fileno()).columns
        except (OSError, ValueError, AttributeError):
            self.max_len = shutil.get_terminal_size(fallback=(80, 24)).columns

    def start(self, _i: int | None = None) -> None:
        with self._lock:
            self._started += 1
            self._draw()

    def finish(self, _i: int | None = None) -> None:
        with self._lock:
            self._finished += 1
            self._draw()

    def _draw(self) -> None:
        if not self.enabled:
            return
        # the total is an ESTIMATE (duration metadata × sr): clamp the
        # fractions and counter so overshoot renders as a full bar, and
        # terminate the line exactly once (not once per extra finish)
        done = min(self._finished, self.total)
        fracs = (
            min(self._started / self.total, 1.0), done / self.total,
        )
        counter = f" {done}/{self.total}"
        width = max(self.max_len - len(self.prefix) - len(counter) - 1, 4)
        bar = self.arrow.render(fracs, width)
        self.stream.write(f"\r{self.prefix}{bar}{counter}")
        if self._finished >= self.total and not self._closed:
            self._closed = True
            self.stream.write("\n")
        self.stream.flush()

    def close(self) -> None:
        """Terminate the bar line if it hasn't reached its (estimated)
        total — an over-estimate would otherwise glue the next log line
        onto the live bar."""
        with self._lock:
            if self.enabled and not self._closed and self._finished > 0:
                self._closed = True
                self.stream.write("\n")
                self.stream.flush()

    def wrap(self, iterable):
        """Iterate while reporting both phases around each item."""
        for item in iterable:
            self.start()
            yield item
            self.finish()
        self.close()
