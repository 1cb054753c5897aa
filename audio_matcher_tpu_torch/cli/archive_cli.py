"""``archive-scroller-torch`` — browse the label archive (L7).

The port's copy of ``archive-scroller``, with its flags exactly. It has no
``--device``: nothing on its path touches a device.

Parity: reference src/bin/archive-scroller.rs + src/archive/args.rs:
positional archive path (persisted to the ``archive`` config with a consent
prompt on first use), ``-i`` interactive REPL, default = list everything.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from ..archive.repl import Holder
from ..utils import config as cfgmod
from . import common
from .. import __version__

CONFIG_NAME = "archive"
log = logging.getLogger("audio_matcher_torch.cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="archive-scroller-torch", description="browse the episode label archive"
    )
    p.add_argument(
        "--version", action="version",
        version=f"%(prog)s {__version__}",
    )
    p.add_argument(
        "archive", nargs="?", type=Path, metavar="FILE",
        help="path to folder of archive",
    )
    p.add_argument("-i", "--interactive", action="store_true")
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

    cfg = cfgmod.load_config(CONFIG_NAME, args.config)
    cfg.setdefault("version", 1)
    changed = False
    if not cfg.get("path") or args.overwrite_config:
        if args.archive is not None and inputs.ask_consent(
            f"should the path {str(args.archive)!r} be saved to the config"
        ):
            cfg["path"] = str(args.archive)
            changed = True
        elif args.archive is None:
            cfg["path"] = inputs.read(
                "please input the path to the archive: "
            )
            changed = True
    if changed:
        if args.dry_run:
            log.info("[dry-run] would save config %s", cfg)
        else:
            cfgmod.save_config(CONFIG_NAME, cfg, args.config)

    archive_path = args.archive or (Path(cfg["path"]) if cfg.get("path") else None)
    if archive_path is None:
        print("need at least one path, either as argument or in config",
              file=sys.stderr)
        return 1

    holder = Holder(archive_path, dry_run=args.dry_run)
    if args.interactive:
        holder.repl()
    else:
        holder.list_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
