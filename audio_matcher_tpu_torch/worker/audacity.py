"""Audacity mod-script-pipe client (L4 external-process boundary), the
port's copy of the JAX package's ``worker.audacity``: the same wire
dialect byte for byte, so either package's client talks to either
package's fake server.

Parity: the reference's first-party ``audacity`` crate surface actually used
by the worker (SURVEY.md §2.12): launch/connect, raw menu commands
(New/Close/Exit/Delete/SplitDelete/RemoveTracks/SelAllTracks), audio/label
import-export, track/label queries, label edits, selection and zoom.

Protocol: Audacity's mod-script-pipe exposes two FIFOs
(``audacity_script_pipe.to.{uid}`` / ``.from.{uid}``); commands are single
text lines, responses end with ``BatchCommand finished: OK`` (or
``... Failed!``). The pipe directory is overridable via
``AUDACITY_PIPE_DIR`` so tests can run against the bundled fake server —
coverage the reference never had (its Audacity layer tests are all
``#[ignore]``d interactive ones, SURVEY.md §4).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import subprocess
import time
from pathlib import Path

log = logging.getLogger("audio_matcher_torch.audacity")


class AudacityError(RuntimeError):
    pass


class LaunchError(AudacityError):
    pass


class ConnectionTimeout(AudacityError):
    pass


def pipe_paths() -> tuple[Path, Path]:
    base = Path(os.environ.get("AUDACITY_PIPE_DIR", "/tmp"))
    uid = os.getuid()
    return (
        base / f"audacity_script_pipe.to.{uid}",
        base / f"audacity_script_pipe.from.{uid}",
    )


@dataclasses.dataclass
class TrackInfo:
    kind: str
    name: str
    focused: bool = False
    selected: bool = False


class RelativeTo:
    PROJECT_START = "ProjectStart"
    PROJECT = "Project"
    PROJECT_END = "ProjectEnd"
    SELECTION_START = "SelectionStart"


def _escapes_enabled() -> bool:
    """Quoting dialect. Our fake server's parser unescapes ``\\"`` and
    ``\\\\``; REAL Audacity's long-format tokenizer takes quoted text
    verbatim (no escape processing — embedded quotes are unrepresentable
    in the protocol, and backslashes, e.g. Windows paths, must pass
    through untouched). Default: escape only when the fake server's
    dialect marker file sits next to the pipes (a real Audacity at a
    custom ``AUDACITY_PIPE_DIR`` keeps the verbatim dialect);
    ``AUDACITY_PIPE_ESCAPES=0/1`` overrides either way."""
    env = os.environ.get("AUDACITY_PIPE_ESCAPES")
    if env is not None:
        return env not in ("0", "", "false", "no")
    base = Path(os.environ.get("AUDACITY_PIPE_DIR", "/tmp"))
    marker = base / f"audacity_fake_server.{os.getuid()}"
    # memoize the marker READ per file identity (bulk flows quote one
    # parameter per label); the liveness kill(pid, 0) stays per-call so a
    # crashed server's stale marker never keeps the fake dialect on
    global _marker_pid_cache
    try:
        st = marker.stat()
        key = (str(marker), st.st_mtime_ns, st.st_size)
    except OSError:
        return False
    if _marker_pid_cache is not None and _marker_pid_cache[0] == key:
        pid = _marker_pid_cache[1]
    else:
        try:
            pid = int(marker.read_text().strip())
        except (OSError, ValueError):
            pid = None
        _marker_pid_cache = (key, pid)
    if pid is None:
        return False
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


_marker_pid_cache: tuple | None = None


def quote_param(value) -> str:
    """Quote a string parameter for a scripting command.

    Commands are single text lines; interpolating user data (label names,
    paths) unescaped corrupts the command when it contains ``"``.
    Newlines flatten to spaces (a raw newline would
    terminate the command mid-way). In the fake-server dialect
    (:func:`_escapes_enabled`) backslashes and quotes are escaped and
    round-trip exactly; against a real Audacity, backslashes pass through
    verbatim and embedded double quotes degrade to apostrophes — the
    command line stays intact, unlike the reference's raw interpolation
    (its crate sends ``Text="{text}"`` unescaped).
    """
    s = str(value)
    s = s.replace("\r", " ").replace("\n", " ")
    if _escapes_enabled():
        s = s.replace("\\", "\\\\").replace('"', '\\"')
    else:
        s = s.replace('"', "'")
    return f'"{s}"'


class AudacityApi:
    """Synchronous scripting-pipe session."""

    def __init__(self, timeout: float | None = None):
        self.timeout = timeout if timeout is not None else 10.0
        to_path, from_path = pipe_paths()
        deadline = time.monotonic() + self.timeout
        while not (to_path.exists() and from_path.exists()):
            if time.monotonic() > deadline:
                raise ConnectionTimeout(
                    f"scripting pipes not found at {to_path}"
                )
            time.sleep(0.1)
        # opening FIFOs blocks until the peer opens its end — a stale
        # pipe from a crashed Audacity would hang forever, so the writer
        # end opens non-blocking (ENXIO while no reader is live) under
        # the same deadline
        while True:
            try:
                wfd = os.open(to_path, os.O_WRONLY | os.O_NONBLOCK)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise ConnectionTimeout(
                        f"no Audacity listening on {to_path}"
                    )
                time.sleep(0.1)
        os.set_blocking(wfd, True)
        self._to = os.fdopen(wfd, "w")
        # read side: the nonblocking open always succeeds, but reading
        # before the peer opens its writer end returns instant EOF — poll
        # until the writer appears (POLLHUP = no writer) under the same
        # deadline
        import select

        rfd = os.open(from_path, os.O_RDONLY | os.O_NONBLOCK)
        poller = select.poll()
        poller.register(rfd, select.POLLIN)
        while True:
            events = poller.poll(100)
            if not any(fl & select.POLLHUP for _, fl in events):
                break  # writer connected (or data already buffered)
            if time.monotonic() > deadline:
                os.close(rfd)
                self._to.close()
                raise ConnectionTimeout(
                    f"no Audacity writing to {from_path}"
                )
        os.set_blocking(rfd, True)
        self._from = os.fdopen(rfd, "r")

    @staticmethod
    def launch(executable: str | None = None) -> subprocess.Popen:
        """Start an Audacity instance (parity: AudacityApiGeneric::launch)."""
        exe = executable or shutil.which("audacity")
        if exe is None:
            raise LaunchError("audacity executable not found on PATH")
        return subprocess.Popen(
            [exe], stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL
        )

    def close(self) -> None:
        try:
            self._to.close()
            self._from.close()
        except OSError:
            pass

    # -- protocol core ---------------------------------------------------
    def do(self, command: str) -> str:
        """Send one scripting command, return its response payload."""
        if "\n" in command or "\r" in command:
            raise ValueError(
                "scripting commands are single lines; pass user data "
                "through quote_param()"
            )
        log.log(5, "-> %s", command)
        self._to.write(command + "\n")
        self._to.flush()
        lines: list[str] = []
        while True:
            line = self._from.readline()
            if line == "":
                raise AudacityError("pipe closed while awaiting response")
            line = line.rstrip("\n")
            if line.startswith("BatchCommand finished:"):
                status = line.split(":", 1)[1].strip()
                payload = "\n".join(lines).strip()
                log.log(5, "<- %s (%s)", payload[:200], status)
                if status.startswith("OK"):
                    return payload
                raise AudacityError(
                    f"command {command!r} failed: {payload or status}"
                )
            if line:
                lines.append(line)

    def write_assume_empty(self, command: str) -> None:
        payload = self.do(command)
        if payload:
            log.debug("expected empty response for %r, got %r", command, payload)

    # -- queries ---------------------------------------------------------
    def get_track_info(self) -> list[TrackInfo]:
        raw = self.do("GetInfo: Type=Tracks Format=JSON")
        tracks = json.loads(raw) if raw else []
        return [
            TrackInfo(
                kind=t.get("kind", ""),
                name=t.get("name", ""),
                focused=bool(t.get("focused", 0)),
                selected=bool(t.get("selected", 0)),
            )
            for t in tracks
        ]

    def get_label_info(self) -> dict[int, list]:
        """→ {label_track_nr: [TimeLabel, ...]} (crate: get_label_info)."""
        from ..hostio.labels import TimeLabel

        raw = self.do("GetInfo: Type=Labels Format=JSON")
        data = json.loads(raw) if raw else []
        out: dict[int, list[TimeLabel]] = {}
        for track_nr, labels in data:
            out[int(track_nr)] = [
                TimeLabel(start=lb[0], end=lb[1], name=lb[2] or None)
                for lb in labels
            ]
        return out

    def get_first_label_track_nr(self) -> int | None:
        info = self.get_label_info()
        return min(info.keys()) if info else None

    # -- edits -----------------------------------------------------------
    def import_audio(self, path) -> None:
        self.write_assume_empty(
            f"Import2: Filename={quote_param(Path(path).absolute())}"
        )

    def import_labels_from(self, path, track_name=None) -> None:
        """Create a label track populated from an Audacity label file."""
        del track_name  # accepted for crate-surface parity
        from ..hostio.labels import read_labels

        labels = read_labels(path)
        self.write_assume_empty("NewLabelTrack:")
        if not labels:
            return
        # route AddLabel to the NEW track explicitly — a stale selection
        # on an older label track would otherwise capture the labels
        self.select_tracks([len(self.get_track_info()) - 1])
        for lb in labels:
            self.select_time(lb.start, lb.end)
            self.write_assume_empty("AddLabel:")
        # SetLabel indices are GLOBAL across label tracks, and Audacity
        # time-sorts within a track — name by sorted order at the new
        # track's offset (file order would misname unsorted files or any
        # project that already had a label track)
        info = self.get_label_info()
        track_nr = max(info) if info else 0
        offset = sum(len(info[t]) for t in sorted(info) if t < track_nr)
        for i, lb in enumerate(
            sorted(labels, key=lambda l: (l.start, l.end))
        ):
            self.set_label(offset + i, lb.name, selected=False)

    def export_audio(self, path) -> None:
        """Best-effort scripted export (``Export2``).

        The reference's pipeline could not script the export dialog
        (worker/mod.rs:491-493 — its ExportAudio attempt is commented out
        with "wurde nicht erkannt") and falls back to asking the user to
        press Ctrl+Shift+E. Callers should catch :class:`AudacityError`
        and fall back to the same manual prompt.
        """
        self.write_assume_empty(
            f"Export2: Filename={quote_param(Path(path).absolute())}"
        )

    def export_all_labels_to(self, path, dry_run: bool = False) -> None:
        from ..hostio.labels import write_labels

        info = self.get_label_info()
        labels = [lb for track in sorted(info) for lb in info[track]]
        write_labels(labels, path, dry_run=dry_run)

    def set_label(
        self, i: int, text=None, start=None, end=None, selected=None
    ) -> None:
        parts = [f"SetLabel: Label={i}"]
        if text is not None:
            parts.append(f"Text={quote_param(text)}")
        if start is not None:
            parts.append(f"Start={start}")
        if end is not None:
            parts.append(f"End={end}")
        if selected is not None:
            parts.append(f"Selected={1 if selected else 0}")
        self.write_assume_empty(" ".join(parts))

    def add_label(self, label, track_hint: int | None = None) -> int:
        """Add a label on the (hinted) label track; returns its index."""
        if track_hint is not None:
            self.select_tracks([track_hint])
        self.select_time(label.start, label.end)
        self.write_assume_empty("AddLabel:")
        info = self.get_label_info()
        track_nr = (
            track_hint
            if track_hint is not None and track_hint in info
            else (max(info.keys()) if info else 0)
        )
        labels = info.get(track_nr, [])
        if not labels:  # server reported nothing to name
            return sum(len(info[t]) for t in sorted(info) if t < track_nr)
        idx = next(
            (
                j
                for j, lb in enumerate(labels)
                # float-tolerant: the echoed start need not repr-equal
                # the value sent in Select
                if lb.name is None and abs(lb.start - label.start) < 1e-6
            ),
            None,
        )
        if idx is None:
            # labels are time-sorted, so "last" is wrong for a label
            # inserted mid-list — take the closest start instead
            idx = min(
                range(len(labels)),
                key=lambda j: abs(labels[j].start - label.start),
            )
        # index is global across label tracks in SetLabel terms
        offset = sum(
            len(info[t]) for t in sorted(info) if t < track_nr
        )
        if label.name:
            self.set_label(offset + idx, label.name)
        return offset + idx

    def add_label_track(self, name: str | None = None) -> int:
        self.write_assume_empty("NewLabelTrack:")
        tracks = self.get_track_info()
        nr = len(tracks) - 1
        if name is not None:
            self.write_assume_empty(
                f"SetTrackStatus: Name={quote_param(name)}"
            )
        return nr

    # -- selection / view ------------------------------------------------
    def select_all(self) -> None:
        self.write_assume_empty("SelectAll:")

    def select_time(
        self, start: float, end: float, relative_to: str = RelativeTo.PROJECT_START
    ) -> None:
        self.write_assume_empty(
            f"Select: Start={start} End={end} RelativeTo={relative_to}"
        )

    def select_tracks(self, tracks) -> None:
        first = True
        for t in tracks:
            mode = "Set" if first else "Add"
            self.write_assume_empty(f"SelectTracks: Track={t} Mode={mode}")
            first = False

    def zoom_to(self, start=None, end=None) -> None:
        """Zoom the view to a time range (or everything)."""
        if start is None:
            self.select_all()
        else:
            # a lone start would interpolate End=None into the command
            self.select_time(start, start if end is None else end)
        self.write_assume_empty("ZoomSel:")


class LazyApi:
    """Launch-and-connect on first use (parity: worker/mod.rs LazyApi)."""

    def __init__(self, timeout: float | None = None):
        self.timeout = timeout
        self._api: AudacityApi | None = None

    def get(self) -> AudacityApi:
        if self._api is None:
            to_path, _ = pipe_paths()
            if not to_path.exists():
                AudacityApi.launch()
            self._api = AudacityApi(self.timeout)
        return self._api
