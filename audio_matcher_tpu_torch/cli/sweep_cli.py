"""``audio-sweep-torch`` — archive scanning on the PyTorch port.

The JAX package's ``audio-sweep``, flag for flag: scan many recordings
against one or more query snippets in groups, with prefetched decode and a
resumable ``.done.txt`` store, writing one Audacity label file per
(recording, query): ``<file>.txt`` for one snippet, ``<file>.q{i}.txt``
for several. ``--device`` (default ``cuda``) names the torch device that
scans and ``--devices N`` a mesh of N of its kind (N cards, or N shards of
the CPU); ``--mode spectrogram`` scans log-mel fingerprints (torch ops on
the device); ``--resample-impl auto`` resamples on a CUDA device and with
scipy on the CPU; ``--xprof DIR`` writes a ``torch.profiler`` chrome trace
of the whole sweep, with the port's spans (stage, dispatch, collect and
their parts, the step graphs') as ``audio_matcher.*`` ranges.

Several processes sweep one archive together when each is started with
``AM_COORDINATOR`` (``host:port`` of process 0), ``AM_NUM_PROCESSES`` and
its own ``AM_PROCESS_ID``: each scans every N-th file on its own devices
(all it sees, unless ``--devices`` says how many) and writes its own
labels; give each its own ``--progress-file``, or one shared by all.

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
from ..models.spectrogram import SpectrogramConfig
from ..parallel.mesh import (
    init_distributed,
    make_mesh,
    process_index,
    shutdown_distributed,
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
        help="the first N devices of --device's kind to scan on, as a mesh "
        "(default 1; in a cluster, all of this process's)",
    )
    p.add_argument(
        "--group-size", type=int, metavar="N",
        help="episodes per dispatch (default 8 on one device, the mesh's size "
        "on several; rounded up to a multiple of it). Host memory scales "
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
        help="resampler: scipy = host polyphase, device = polyphase on "
        "--device; auto = device on CUDA, scipy on the CPU",
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
        help="matching domain (spectrogram = noise-robust log-mel NCC)",
    )
    p.add_argument(
        "--device", default="cuda", metavar="DEVICE",
        help="torch device that scans (default cuda; cpu runs the "
        "kernels' plain versions)",
    )
    p.add_argument(
        "--xprof", type=Path, metavar="DIR",
        help="write a torch.profiler chrome trace of the sweep to DIR "
        "(sweep.trace.json; sweep.<process>.trace.json in a cluster)",
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

    spectrogram_config = None
    if args.mode == "spectrogram":
        spectrogram_config = SpectrogramConfig(
            distance_secs=float(args.distance),
            transfer_dtype=args.transfer,
            resample_impl=args.resample_impl,
        )
    # join a configured cluster (from AM_*; a no-op otherwise), then the
    # devices: the first N of --device's kind, or in a cluster all of this
    # process's own
    joined = init_distributed()
    try:
        scan_on = device
        if args.devices is not None or joined:
            mesh = make_mesh(args.devices, device)
            if mesh.size > 1:
                scan_on = mesh
        name = f"sweep.{process_index()}" if joined else "sweep"
        with common.profiled(args.xprof, device, name):
            results = sweep_archive(
                paths,
                snippets,
                sr,
                config,
                device=scan_on,
                progress_path=args.progress_file,
                write_labels_for=write_result,
                resample_mismatched=args.resample,
                mode=args.mode,
                spectrogram_config=spectrogram_config,
                group_size=args.group_size,
            )
    finally:
        if joined:
            shutdown_distributed()
    where = scan_on.describe() if scan_on is not device else str(device)
    log.info("scanned %d file(s) on %s", len(results), where)
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
