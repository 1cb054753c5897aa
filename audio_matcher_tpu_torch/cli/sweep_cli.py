"""``audio-sweep-torch`` — archive scanning on the PyTorch port.

The JAX package's ``audio-sweep``, flag for flag: scan many recordings
against one or more query snippets in groups, with prefetched decode and a
resumable ``.done.txt`` store, writing one Audacity label file per
(recording, query): ``<file>.txt`` for one snippet, ``<file>.q{i}.txt``
for several. ``--device`` (default ``cuda``) names the torch device that
scans; ``--devices`` above 1 is ROADMAP P7.

    python -m audio_matcher_tpu_torch.cli.sweep_cli 'archive/**/*.mp3' \\
        --snippet intro.mp3 --progress-file .done.txt --device cpu
"""

from __future__ import annotations

import argparse
import glob as globmod
import logging
import sys
from pathlib import Path

from .. import __version__
from ..hostio.decode import RESAMPLE_IMPLS, read_audio
from ..hostio.labels import timelabel_from_peaks, write_labels
from ..models.matcher import (
    DEFAULT_CHUNK_SECS,
    DEFAULT_DISTANCE_SECS,
    DEFAULT_PROMINENCE,
    FFT_IMPLS,
    PEAKS_IMPLS,
    MatchConfig,
)
from ..parallel.sweep import sweep_archive
from ..utils.durations import parse_duration
from . import common

log = logging.getLogger("audio_matcher_torch.sweep_cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="audio-sweep-torch",
        description="scan a whole archive for query snippets on a CUDA GPU "
        "(PyTorch port)",
    )
    p.add_argument(
        "--version", action="version", version=f"%(prog)s {__version__}"
    )
    p.add_argument(
        "within", nargs="*", metavar="FILE_OR_GLOB",
        help="recordings (files or globs) to scan",
    )
    p.add_argument(
        "--snippet", type=Path, action="append", required=True,
        metavar="FILE", help="query snippet (repeatable)",
    )
    p.add_argument(
        "-p", "--prominence", type=float, default=DEFAULT_PROMINENCE
    )
    p.add_argument(
        "--distance", type=parse_duration, default=DEFAULT_DISTANCE_SECS,
        metavar="SECONDS",
    )
    p.add_argument(
        "--chunk-size", type=parse_duration, default=DEFAULT_CHUNK_SECS,
        metavar="SECONDS",
    )
    p.add_argument(
        "--progress-file", type=Path, metavar="FILE",
        help="resume state (reference .done.txt line format)",
    )
    p.add_argument(
        "--devices", type=int, metavar="N",
        help="devices to scan on (default 1; more is ROADMAP P7)",
    )
    p.add_argument(
        "--group-size", type=int, metavar="N",
        help="episodes per device dispatch (default 8). Host memory scales "
        "with group size x episode length — pass 1 for very long episodes "
        "on small hosts",
    )
    p.add_argument("--no-out", action="store_true")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument(
        "--resample", action="store_true",
        help="resample recordings whose rate differs from the snippets",
    )
    p.add_argument(
        "--resample-impl", choices=RESAMPLE_IMPLS,
        default="auto", metavar="IMPL",
        help="resampler: scipy = host polyphase; device is ROADMAP P6; "
        "auto = scipy",
    )
    p.add_argument(
        "--transfer", choices=("float32", "int16", "mulaw8"),
        default="int16", metavar="DTYPE",
        help="staging wire format (default int16: lossless vs 16-bit source)",
    )
    p.add_argument(
        "--fft-impl", choices=("auto",) + FFT_IMPLS,
        default="auto", metavar="IMPL",
        help="correlation FFT implementation (auto = the two-factor FFT "
        "kernels on CUDA, xla_packed (torch.fft) on the CPU; mxu: matmul "
        "four-step FFT)",
    )
    p.add_argument(
        "--peaks-impl", choices=("auto",) + PEAKS_IMPLS, default="auto",
        metavar="IMPL",
        help="peak-pick implementation (pallas: the single-read block "
        "reduction; auto = pallas on CUDA, jnp on the CPU)",
    )
    p.add_argument(
        "--mode", choices=("pcm", "spectrogram"), default="pcm",
        help="matching domain (spectrogram is ROADMAP P5)",
    )
    p.add_argument(
        "--device", default="cuda", metavar="DEVICE",
        help="torch device that scans (default cuda; cpu runs the "
        "kernels' plain versions)",
    )
    common.add_output_level_args(p)
    return p


def run(args: argparse.Namespace) -> int:
    paths: list[Path] = []
    for pattern in args.within:
        hits = sorted(globmod.glob(pattern, recursive=True))
        if hits:
            paths.extend(Path(h) for h in hits)
        else:
            paths.append(Path(pattern))
    if not paths:
        log.error("no input files")
        return 1
    if args.mode == "spectrogram":
        raise NotImplementedError("spectrogram mode is ROADMAP P5")
    if args.devices is not None and args.devices > 1:
        raise NotImplementedError("sweeping over several devices is ROADMAP P7")
    device = common.resolve_device(args.device)

    snippets = []
    sr = None
    for snip_path in args.snippet:
        s_sr, s = read_audio(snip_path)
        if sr is None:
            sr = s_sr
        elif s_sr != sr:
            log.error(
                "query snippets have different samplerates (%s, %s)", sr, s_sr
            )
            return 1
        snippets.append(s)

    config = MatchConfig(
        chunk_secs=float(args.chunk_size),
        distance_secs=float(args.distance),
        prominence=args.prominence,
        transfer_dtype=args.transfer,
        fft_impl=common.resolve_fft_impl(args.fft_impl, device),
        peaks_impl=common.resolve_peaks_impl(args.peaks_impl, device),
        resample_impl=args.resample_impl,
    )

    def write_result(path: Path, q: int, peaks) -> None:
        if args.no_out:
            return
        suffix = f".q{q}.txt" if len(snippets) > 1 else ".txt"
        out = path.with_suffix(suffix)
        write_labels(
            timelabel_from_peaks(peaks, sr, 7.0, "Segment #"),
            out, dry_run=args.dry_run,
        )
        log.info("%s → %d peaks → %s", path.name, len(peaks), out.name)

    results = sweep_archive(
        paths,
        snippets,
        sr,
        config,
        device=device,
        progress_path=args.progress_file,
        write_labels_for=write_result,
        resample_mismatched=args.resample,
        mode=args.mode,
        group_size=args.group_size,
    )
    log.info("scanned %d file(s) on %s", len(results), device)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    common.init_logger(args)
    try:
        return run(args)
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        log.error("Program error :'%s'", exc)
        return 1


if __name__ == "__main__":
    sys.exit(main())
