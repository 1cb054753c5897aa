"""``audio-worker-torch`` — interactive Audacity episode pipeline CLI (L7).

The port's copy of ``audio-worker``, with its flags exactly. It has no
``--device``: nothing on its path touches a device (the matcher CLI that
writes its label files has one).

Parity: reference src/bin/audio-worker.rs + src/worker/args.rs: audio file
paths, ``--index-folder`` (persisted to the ``worker`` config with a
consent prompt), ``--timeout``, ``--export-ext`` (default mp3),
``--skip-load``, ``--skip-name``, ``--dry-run``.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from ..utils import config as cfgmod
from ..utils.durations import parse_duration
from ..worker.pipeline import WorkerArgs, run_worker
from . import common
from .. import __version__

log = logging.getLogger("audio_matcher_torch.cli")

SUB_CONFIG = "worker"
DEFAULT_GENRE = "Hörbuch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="audio-worker-torch",
        description="interactive Audacity-driven episode cutting/tagging",
    )
    p.add_argument(
        "--version", action="version",
        version=f"%(prog)s {__version__}",
    )
    p.add_argument(
        "audio_paths", nargs="*", type=Path, metavar="FILE",
        help="path to audio file",
    )
    p.add_argument(
        "--index-folder", type=Path, metavar="FILE",
        help="path to index folder",
    )
    p.add_argument(
        "--timeout", type=parse_duration, metavar="DURATION",
        help="timeout, can be just seconds, or something like 3h5m17s",
    )
    p.add_argument(
        "--export-ext", default="mp3", metavar="FORMAT",
        help="expected format of exported files",
    )
    p.add_argument(
        "--skip-load", action="store_true",
        help="skips loading of data, assumes project is set up",
    )
    p.add_argument(
        "--skip-name", action="store_true",
        help="skips naming and exporting of labels",
    )
    p.add_argument("--dry-run", action="store_true")
    p.add_argument(
        "--config", type=Path, metavar="FILE", help="use this config file"
    )
    p.add_argument(
        "--overwrite-config", action="store_true",
        help="writes path into config",
    )
    common.add_inputs_args(p)
    common.add_output_level_args(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    common.init_logger(args)
    inputs = common.Inputs.from_args(args)

    cfg = cfgmod.load_config(SUB_CONFIG, args.config)
    cfg.setdefault("genre", DEFAULT_GENRE)
    if (
        not cfg.get("index_folder")
        and args.index_folder is not None
        and inputs.ask_consent(
            f"do you want to save the index folder "
            f"{str(args.index_folder)!r} in the config?"
        )
    ):
        cfg["index_folder"] = str(args.index_folder)
        cfgmod.save_config(SUB_CONFIG, cfg, args.config)

    index_folder = args.index_folder or (
        Path(cfg["index_folder"]) if cfg.get("index_folder") else None
    )
    worker_args = WorkerArgs(
        audio_paths=list(args.audio_paths),
        index_folder=index_folder,
        timeout=args.timeout,
        export_ext=args.export_ext,
        skip_load=args.skip_load,
        skip_name=args.skip_name,
        dry_run=args.dry_run,
        genre=cfg["genre"],
    )
    try:
        run_worker(worker_args, inputs=inputs)
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        log.error("Program error :'%s'", exc)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
