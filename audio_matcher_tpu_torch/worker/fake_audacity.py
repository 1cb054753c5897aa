"""In-process fake Audacity scripting-pipe server (the port's copy of the
JAX package's ``worker.fake_audacity``).

The reference's Audacity layer is entirely untested (all its tests are
``#[ignore]``d interactive ones — SURVEY.md §4 explicitly calls for a fake
pipe server in the rebuild). This serves the mod-script-pipe protocol over
real FIFOs against an in-memory project model: tracks, label tracks with
time-sorted labels, a time selection, ripple ``Delete`` vs gapless
``SplitDelete``, and JSON ``GetInfo`` for tracks/labels.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
from pathlib import Path

log = logging.getLogger("audio_matcher_torch.fake_audacity")

# quoted values may contain \" and \\ escapes (see audacity.quote_param)
_KV_RE = re.compile(r'(\w+)=("(?:\\.|[^"\\])*"|\S+)')


def parse_command(line: str) -> tuple[str, dict[str, str]]:
    name, _, rest = line.partition(":")
    params = {}
    for m in _KV_RE.finditer(rest):
        value = m.group(2)
        if value.startswith('"') and value.endswith('"'):
            value = value[1:-1]
            value = value.replace('\\"', '"').replace("\\\\", "\\")
        params[m.group(1)] = value
    return name.strip(), params


class _Track:
    def __init__(self, kind: str, name: str):
        self.kind = kind  # "wave" | "label"
        self.name = name
        self.labels: list[list] = []  # [start, end, text]
        self.selected = False


class FakeAudacity:
    """Serve the scripting protocol on FIFOs in ``pipe_dir``."""

    def __init__(self, pipe_dir: str | Path):
        self.pipe_dir = Path(pipe_dir)
        self.pipe_dir.mkdir(parents=True, exist_ok=True)
        uid = os.getuid()
        self.to_path = self.pipe_dir / f"audacity_script_pipe.to.{uid}"
        self.from_path = self.pipe_dir / f"audacity_script_pipe.from.{uid}"
        for p in (self.to_path, self.from_path):
            if p.exists():
                p.unlink()
            os.mkfifo(p)
        # dialect marker: audacity.quote_param escapes \" and \\ only when
        # this file announces our parser (real Audacity takes quoted text
        # verbatim — a pipe-dir heuristic alone would corrupt commands to
        # a real instance at a custom AUDACITY_PIPE_DIR). The marker holds
        # this server's PID so a crashed server's leftover marker reads as
        # stale (audacity._escapes_enabled checks liveness) instead of
        # permanently flipping later real-Audacity sessions.
        self.marker_path = self.pipe_dir / f"audacity_fake_server.{uid}"
        self.marker_path.write_text(str(os.getpid()))
        self.tracks: list[_Track] = []
        self.selection: tuple[float, float] = (0.0, 0.0)
        self.command_log: list[str] = []
        self.exported: dict[str, str] = {}
        self._shutdown = False
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    # -- lifecycle -------------------------------------------------------
    def stop(self) -> None:
        self._shutdown = True
        # unblock BOTH opens the serve loop may be parked in: the to-pipe
        # read needs a writer, and the from-pipe write-open needs a
        # reader (else an idle stop leaks the thread after a full 2 s
        # join timeout)
        try:
            fd = os.open(self.to_path, os.O_WRONLY | os.O_NONBLOCK)
            os.write(fd, b"Exit:\n")
            os.close(fd)
        except OSError:
            pass
        try:
            rfd = os.open(self.from_path, os.O_RDONLY | os.O_NONBLOCK)
        except OSError:
            rfd = None
        self._thread.join(timeout=2)
        if rfd is not None:
            os.close(rfd)
        for p in (self.to_path, self.from_path, self.marker_path):
            try:
                p.unlink()
            except OSError:
                pass

    def _serve(self) -> None:
        while not self._shutdown:
            try:
                with open(self.to_path, "r") as incoming, open(
                    self.from_path, "w"
                ) as outgoing:
                    for line in incoming:
                        line = line.strip()
                        if not line:
                            continue
                        self.command_log.append(line)
                        try:
                            payload, ok = self.handle(line)
                        except Exception as exc:  # noqa: BLE001
                            payload, ok = f"{type(exc).__name__}: {exc}", False
                        if payload:
                            outgoing.write(payload + "\n")
                        outgoing.write(
                            "BatchCommand finished: "
                            + ("OK" if ok else "Failed!")
                            + "\n"
                        )
                        outgoing.flush()
                        if line.startswith("Exit"):
                            self._shutdown = True
                            return
            except OSError:
                return

    # -- model helpers ---------------------------------------------------
    def _label_tracks(self):
        return [
            (i, t) for i, t in enumerate(self.tracks) if t.kind == "label"
        ]

    def _global_labels(self):
        """(track_idx, label) pairs in global SetLabel index order."""
        out = []
        for i, t in self._label_tracks():
            for lb in t.labels:
                out.append((i, lb))
        return out

    # -- command dispatch ------------------------------------------------
    def handle(self, line: str) -> tuple[str, bool]:
        name, p = parse_command(line)
        fn = getattr(self, f"_cmd_{name.lower()}", None)
        if fn is None:
            return f"unknown command {name!r}", False
        return fn(p)

    def _cmd_new(self, p):
        self.tracks = []
        self.selection = (0.0, 0.0)
        return "", True

    _cmd_close = _cmd_new

    def _cmd_exit(self, p):
        return "", True

    def _cmd_import2(self, p):
        path = p.get("Filename", "")
        self.tracks.append(_Track("wave", Path(path).stem))
        return "", True

    def _cmd_newlabeltrack(self, p):
        self.tracks.append(_Track("label", ""))
        return "", True

    def _cmd_settrackstatus(self, p):
        if self.tracks and "Name" in p:
            self.tracks[-1].name = p["Name"]
        return "", True

    def _cmd_select(self, p):
        start = float(p.get("Start", 0))
        end = float(p.get("End", start))
        self.selection = (start, end)
        return "", True

    def _cmd_selectall(self, p):
        for t in self.tracks:
            t.selected = True
        ends = [lb[1] for t in self.tracks for lb in t.labels]
        self.selection = (0.0, max(ends) if ends else 0.0)
        return "", True

    def _cmd_selalltracks(self, p):
        for t in self.tracks:
            t.selected = True
        return "", True

    def _cmd_selecttracks(self, p):
        track = int(float(p.get("Track", 0)))
        mode = p.get("Mode", "Set")
        if mode == "Set":
            for t in self.tracks:
                t.selected = False
        if 0 <= track < len(self.tracks):
            self.tracks[track].selected = True
        return "", True

    def _cmd_zoomsel(self, p):
        return "", True

    def _cmd_addlabel(self, p):
        targets = [
            (i, t) for i, t in self._label_tracks() if t.selected
        ] or self._label_tracks()
        if not targets:
            return "no label track", False
        _, track = targets[-1]
        start, end = self.selection
        track.labels.append([start, end, ""])
        track.labels.sort(key=lambda lb: (lb[0], lb[1]))
        return "", True

    def _cmd_setlabel(self, p):
        idx = int(float(p.get("Label", -1)))
        pairs = self._global_labels()
        if not 0 <= idx < len(pairs):
            return f"no label {idx}", False
        _, lb = pairs[idx]
        if "Text" in p:
            lb[2] = p["Text"]
        if "Start" in p:
            lb[0] = float(p["Start"])
        if "End" in p:
            lb[1] = float(p["End"])
        return "", True

    def _cmd_removetracks(self, p):
        self.tracks = [t for t in self.tracks if not t.selected]
        return "", True

    def _cmd_delete(self, p):
        """Ripple delete: remove the selected span, shift later content."""
        start, end = self.selection
        span = end - start
        if span <= 0:
            return "", True
        for t in self.tracks:
            if not t.selected or t.kind != "label":
                continue
            new_labels = []
            for s, e, text in t.labels:
                if s >= start and e <= end:
                    continue  # swallowed
                if s >= end:
                    s, e = s - span, e - span
                elif e > start:
                    # overlap: clip against the removed span
                    s = min(s, start)
                    e = start + max(e - end, 0)
                new_labels.append([s, e, text])
            t.labels = sorted(new_labels, key=lambda lb: (lb[0], lb[1]))
        return "", True

    def _cmd_splitdelete(self, p):
        """Gapless delete: clear the span without shifting anything."""
        start, end = self.selection
        for t in self.tracks:
            if not t.selected or t.kind != "label":
                continue
            t.labels = [
                lb for lb in t.labels if not (lb[0] >= start and lb[1] <= end)
            ]
        return "", True

    def _cmd_export2(self, p):
        """Export-dialog flow: write a placeholder file so pipelines that
        script the export (instead of the reference's manual Ctrl+Shift+E
        prompt) can be driven end-to-end."""
        path = p.get("Filename", "")
        if not path:
            return "Export2 requires Filename", False
        out = Path(path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(b"")
        self.exported[str(out)] = "Export2"
        return "", True

    def _cmd_getinfo(self, p):
        kind = p.get("Type", "")
        if kind == "Tracks":
            return (
                json.dumps(
                    [
                        {
                            "kind": t.kind,
                            "name": t.name,
                            "selected": int(t.selected),
                        }
                        for t in self.tracks
                    ]
                ),
                True,
            )
        if kind == "Labels":
            return (
                json.dumps(
                    [
                        [i, [[lb[0], lb[1], lb[2]] for lb in t.labels]]
                        for i, t in self._label_tracks()
                    ]
                ),
                True,
            )
        return f"unsupported GetInfo type {kind!r}", False
