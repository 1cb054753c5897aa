"""Audacity label-track files ("TimeLabel"), over the port's ``Peak``.

One ``start<TAB>end<TAB>name`` line per label, seconds with 6 decimals, as
the JAX package's ``hostio/labels.py`` writes them (the reference's
``audacity`` crate format). ``timelabel_from_peaks`` turns consecutive peak
pairs into labels [start + delay, next start), named by a ``#``-substituted
pattern numbered from 1.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterable, Sequence

from ..ops.peaks import Peak


@dataclasses.dataclass
class TimeLabel:
    start: float  # seconds
    end: float
    name: str | None = None

    def to_line(self) -> str:
        name = self.name or ""
        return f"{self.start:.6f}\t{self.end:.6f}\t{name}"

    @classmethod
    def from_line(cls, line: str) -> "TimeLabel":
        parts = line.rstrip("\n").split("\t")
        if len(parts) < 2:
            raise ValueError(f"not a label line: {line!r}")
        name = parts[2] if len(parts) > 2 and parts[2] != "" else None
        return cls(float(parts[0]), float(parts[1]), name)


def read_labels(path: str | Path) -> list[TimeLabel]:
    out = []
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        if line.startswith("\\"):
            # Audacity's spectral-selection line ("\\<lo>\t<hi>") belongs
            # to the label before it; it is not a label
            continue
        out.append(TimeLabel.from_line(line))
    return out


def write_labels(
    labels: Iterable[TimeLabel], path: str | Path, dry_run: bool = False
) -> None:
    text = "".join(lb.to_line() + "\n" for lb in labels)
    if dry_run:
        print(f"[dry-run] would write labels to {path}:\n{text}", end="")
        return
    Path(path).write_text(text)


def timelabel_from_peaks(
    peaks: Sequence[Peak],
    sr: int,
    delay_start_secs: float = 7.0,
    name_pattern: str = "Segment #",
) -> list[TimeLabel]:
    """Labels spanning consecutive peaks, starts delayed by ``delay_start``:
    n peaks → n-1 labels; label i (from 1) runs from peak_i + delay to
    peak_{i+1}, and '#' in the pattern becomes i. Peaks closer than the
    delay give a zero-length label, never an inverted one (Audacity
    rejects start > end)."""
    starts = [p.start_secs(sr) for p in peaks]
    return [
        TimeLabel(
            start=min(a + delay_start_secs, b),
            end=b,
            name=name_pattern.replace("#", str(i)),
        )
        for i, (a, b) in enumerate(zip(starts, starts[1:]), start=1)
    ]
