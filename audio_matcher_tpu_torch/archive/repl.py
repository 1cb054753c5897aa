"""Archive REPL + command loop (L5/L7), the port's copy of the JAX
package's ``archive.repl``.

Parity: reference src/archive/mod.rs — non-interactive default prints the
whole archive (``List`` with tab indent, chapters on, missing off); ``-i``
starts a ``$>`` loop whose commands are parsed shell-words-style by the
same parser that defines the CLI (``exit``, ``reload [path]``,
``list [indent] [-c] [-m]``, ``rename``). Unlike the reference — which
stubs ``rename`` — this one is REAL: series rename / chapter re-title
across every label file on disk, with ``--dry-run``.
"""

from __future__ import annotations

import argparse
import logging
import shlex
from pathlib import Path

from .data import Archive

log = logging.getLogger("audio_matcher_torch.archive")


class CommandError(ValueError):
    pass


class _Parser(argparse.ArgumentParser):
    def error(self, message):  # don't sys.exit inside the REPL
        raise CommandError(message)


def command_parser() -> argparse.ArgumentParser:
    p = _Parser(prog="", add_help=True, exit_on_error=False)
    sub = p.add_subparsers(dest="command", required=True)
    sub.add_parser("exit")
    reload_p = sub.add_parser("reload")
    reload_p.add_argument("path", nargs="?", type=Path)
    list_p = sub.add_parser("list")
    list_p.add_argument("indent", nargs="?", default="\t")
    list_p.add_argument(
        "-c", "--print-chapters", dest="print_all", action="store_true"
    )
    list_p.add_argument(
        "-m", "--print-missing", dest="print_missing", action="store_true"
    )
    rename_p = sub.add_parser("rename")
    rename_p.add_argument(
        "which",
        help="series (name or index) or chapter (\"series.chapter\")",
    )
    rename_p.add_argument("new_name", help="replacement name/title")
    rename_p.add_argument(
        "-n", "--dry-run", action="store_true",
        help="report what would change without writing",
    )
    return p


def parse_command(line: str) -> argparse.Namespace:
    try:
        words = shlex.split(line)
    except ValueError as exc:  # e.g. unmatched quote — warn, don't crash
        raise CommandError(str(exc)) from exc
    try:
        return command_parser().parse_args(words)
    except argparse.ArgumentError as exc:
        raise CommandError(str(exc)) from exc
    except SystemExit as exc:
        # argparse already printed help/usage; exit code 0 (help) needs
        # no extra warning line
        raise CommandError(
            "" if exc.code in (0, None) else str(exc)
        ) from exc


class Holder:
    """Archive + path pair driving the command loop (archive/mod.rs:30-64)."""

    def __init__(self, path: Path, dry_run: bool = False):
        self.path = Path(path)
        self.dry_run = dry_run  # session-wide: forces rename dry-run
        self.archive = Archive.read(self.path)

    def work_command(self, ns: argparse.Namespace) -> bool:
        """Execute one command; returns False when the loop should stop."""
        if ns.command == "exit":
            return False
        if ns.command == "reload":
            # adopt the new path so later commands (rename writes!) target
            # the directory the user is actually looking at
            if ns.path:
                self.path = Path(ns.path)
            self.archive = Archive.read(self.path)
        elif ns.command == "list":
            print(
                self.archive.display(
                    indent=ns.indent,
                    print_index=False,
                    print_all=ns.print_all,
                    print_missing=ns.print_missing,
                )
            )
        elif ns.command == "rename":
            # the reference stubs this ("comming soon", archive/mod.rs:60);
            # here it renames a series / re-titles a chapter across every
            # label file on disk, then reloads the archive
            dry = ns.dry_run or self.dry_run
            try:
                labels, files = self.archive.rename_element(
                    self.path, ns.which, ns.new_name, dry_run=dry
                )
            except ValueError as exc:
                log.warning("%s", exc)
                return True
            verb = "would rename" if dry else "renamed"
            print(f"{verb} {labels} label(s) across {files} file(s)")
            if not dry and files:
                self.archive = Archive.read(self.path)
        return True

    def repl(self) -> None:
        while True:
            try:
                line = input("$> ")
            except EOFError:
                return
            if not line.strip():
                continue
            try:
                ns = parse_command(line)
            except CommandError as exc:
                if str(exc):  # help exits carry no message
                    log.warning("%s", exc)
                continue
            if not self.work_command(ns):
                return

    def list_all(self) -> None:
        self.work_command(
            argparse.Namespace(
                command="list", indent="\t", print_all=True, print_missing=False
            )
        )
