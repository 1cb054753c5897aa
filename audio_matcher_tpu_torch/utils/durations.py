"""Duration parsing/formatting.

Parity: reference src/args.rs:80-121 (``parse_duration``) and the
hh:mm:ss offset logging format of src/matcher/mod.rs:110-125.
"""

from __future__ import annotations

import re

_DURATION_RE = re.compile(
    r"^(?:(?:(?P<hour>\d+)h(?:ours?)?)?"
    r"(?:(?P<min>\d+)m(?:in)?)?"
    r"(?:(?P<sec>\d+)s(?:ec)?)?)"
    r"(?:(?P<msec>\d+)ms(?:ec)?)?$"
)


class NoMatchError(ValueError):
    """Raised when a duration string can't be parsed."""

    def __init__(self, arg: str):
        super().__init__(f"couldn't find duration in {arg!r}")
        self.arg = arg


def parse_duration(arg: str) -> float:
    """Parse ``"17"``, ``"58sec"``, ``"1m"``, ``"100ms"``, ``"1hour1m1s"`` → seconds.

    Bare integers are whole seconds. Unit order must be h, m, s, ms; empty
    strings and out-of-order unit strings fail (same grammar as the
    reference's regex parser).
    """
    if not arg:
        raise NoMatchError(arg)
    if arg.isdecimal():
        return float(int(arg))
    m = _DURATION_RE.match(arg)
    if m is None:
        raise NoMatchError(arg)
    ms = 0
    if m.group("hour"):
        ms += int(m.group("hour"))
    ms *= 60
    if m.group("min"):
        ms += int(m.group("min"))
    ms *= 60
    if m.group("sec"):
        ms += int(m.group("sec"))
    ms *= 1000
    if m.group("msec"):
        ms += int(m.group("msec"))
    return ms / 1000.0


def fmt_hms(seconds: float) -> str:
    """Format whole seconds as zero-padded ``hh:mm:ss`` (truncating sub-second)."""
    total = int(seconds)
    h, rem = divmod(total, 3600)
    m, s = divmod(rem, 60)
    return f"{h:02}:{m:02}:{s:02}"


def fmt_hmsm(seconds: float) -> str:
    """``hh:mm:ss.mmm`` — used for opus CHAPTERxxx comments."""
    total_ms = round(seconds * 1000.0)
    total, ms = divmod(total_ms, 1000)
    h, rem = divmod(total, 3600)
    m, s = divmod(rem, 60)
    return f"{h:02}:{m:02}:{s:02}.{ms:03}"
