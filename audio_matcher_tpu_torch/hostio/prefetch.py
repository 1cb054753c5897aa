"""Pipelined host decode: decode files ahead of the device's scan.

A small thread pool decodes up to ``depth`` files ahead into a bounded
queue, so host decoding overlaps the scan of the previous group. With
``wire_dtype`` set, the workers emit samples already in the staging wire
format (int16 from the decoder, μ-law companded in the worker), and the
sweep's critical path is left with a row copy and the upload.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import logging
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from ..models.matcher import quantize_wire
from .decode import read_audio, read_audio_int16

log = logging.getLogger("audio_matcher_torch.prefetch")


@dataclasses.dataclass
class DecodedFile:
    path: Path
    sr: int
    samples: np.ndarray
    error: Exception | None = None


def _decode_wire(
    path: Path, wire_dtype: str, expect_sr: int | None
) -> DecodedFile:
    """Decode to the staging wire format. A sample-rate mismatch leaves the
    samples on the int16 grid (not companded): the resample path takes
    int16 or f32, and staging encodes to the wire dtype."""
    if wire_dtype == "float32":
        sr, samples = read_audio(path)
        return DecodedFile(path, sr, samples)
    sr, wire = read_audio_int16(path)
    if wire_dtype == "mulaw8" and (expect_sr is None or sr == expect_sr):
        wire = quantize_wire(wire, "mulaw8")
    return DecodedFile(path, sr, wire)


def decode_prefetched(
    paths: Iterable[str | Path],
    depth: int = 2,
    workers: int = 2,
    wire_dtype: str | None = None,
    expect_sr: int | None = None,
    max_bytes: int | None = None,
) -> Iterator[DecodedFile]:
    """Yield decoded files in order while decoding ``depth`` ahead; a file
    that fails to decode is yielded with its ``error`` set.

    ``wire_dtype``: emit samples in this staging wire format (float32,
    int16 or mulaw8) instead of f32 PCM. ``expect_sr``: the scan's rate;
    files at another rate stay int16 for the resampler. ``max_bytes``:
    queue no new decode once the finished but unconsumed results exceed
    this budget; at most ``workers`` unfinished decodes are submitted then
    (their sizes are unknown until they finish), so a deep ``depth`` never
    holds several long episodes of host RAM at once.
    """
    paths = [Path(p) for p in paths]

    def job(path: Path) -> DecodedFile:
        try:
            if wire_dtype is not None:
                return _decode_wire(path, wire_dtype, expect_sr)
            sr, samples = read_audio(path)
            return DecodedFile(path, sr, samples)
        except Exception as exc:  # noqa: BLE001 — handed to the consumer
            return DecodedFile(path, 0, np.zeros(0, np.float32), exc)

    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        pending: list[cf.Future] = []
        it = iter(paths)

        def queued_bytes() -> int:
            return sum(
                f.result().samples.nbytes for f in pending if f.done()
            )

        def refill() -> None:
            while len(pending) < depth:
                if max_bytes is not None:
                    undone = sum(1 for f in pending if not f.done())
                    if (
                        undone >= max(workers, 1)
                        or queued_bytes() >= max_bytes
                    ):
                        return
                nxt = next(it, None)
                if nxt is None:
                    return
                pending.append(pool.submit(job, nxt))

        refill()
        while pending:
            fut = pending.pop(0)
            refill()
            yield fut.result()
            refill()
