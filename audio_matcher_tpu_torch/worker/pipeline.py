"""The interactive episode-cutting worker pipeline (L4), the port's copy
of the JAX package's ``worker.pipeline``.

Parity: reference src/worker/mod.rs ``run`` — per audio file a resumable
state machine (Loaded < Named < Done, persisted in ``.done.txt``):

  1. load audio + matcher labels into Audacity (``prepare_project``)
  2. user-assisted label renaming (see rename.py) + label export
  3. merge multi-part labels, ripple-delete the gaps, compute chapter
     offsets, build tags, let the user export, retag + move files into the
     archive layout (``merge_parts`` / ``calc_merged_offsets`` /
     ``move_results``)

Sub-files matching ``(N).ext`` are skipped; Audacity gets ``Close`` after
each file and ``Exit`` after the last.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import shutil
from pathlib import Path

from ..archive.data import build_timelabel_name, parse_line
from ..cli.common import Inputs
from ..meta.index import MultiIndex, IndexReadError
from ..meta.progress import Progress, State
from ..meta.tagger import (
    Album,
    Artist,
    Genre,
    TaggedFile,
    Title,
    TotalTracks,
    Track,
    Year,
)
from .audacity import AudacityApi, LazyApi

log = logging.getLogger("audio_matcher_torch.worker")

# intent of the reference's sub-file filter (worker/mod.rs:410; the original
# regex lacks the digit escape — a latent bug we do not reproduce)
_SUB_FILE_RE = re.compile(r"\(\d+\)(\.[a-zA-Z0-9]+)?$")


@dataclasses.dataclass
class WorkerArgs:
    """Parity: worker/args.rs Parameter + Config."""

    audio_paths: list[Path]
    index_folder: Path | None = None
    timeout: float | None = None
    export_ext: str = "mp3"
    skip_load: bool = False
    skip_name: bool = False
    dry_run: bool = False
    genre: str = "Hörbuch"

    @property
    def tmp_path(self) -> Path:
        if not self.audio_paths:
            raise ValueError("no paths")
        return self.audio_paths[0].parent


def calc_merged_offsets(grouped_labels) -> list[list[float]]:
    """Chapter offsets (seconds) per merged group after the inter-part gaps
    are ripple-deleted. Parity: worker/mod.rs:1326-1354 — ``deleted``
    accumulates across groups; each group's offsets are its parts' post-
    deletion end times relative to the group's post-deletion start, with no
    entry for the final part.

    Groups MUST be passed in chronological order: the running ``deleted``
    total assumes earlier groups' gaps were already removed. (The reference
    feeds this from a HashMap's arbitrary iteration order — a latent
    nondeterminism; merge_parts here groups in label order, which is
    chronological, matching the reference's own unit-test expectation.)"""
    deleted = 0.0
    out = []
    for labels in grouped_labels:
        labels = list(labels)
        if not labels:
            out.append([])
            continue
        point_zero = labels[0].start - deleted
        last_end = labels[0].start
        offsets = []
        for i, label in enumerate(labels):
            deleted += label.start - last_end
            if i < len(labels) - 1:
                last_end = label.end
                offsets.append(label.end - point_zero - deleted)
        out.append(offsets)
    return out


def prepare_project(api: AudacityApi, audio_path: Path, label_path: Path):
    """Fresh project with the episode audio + matcher labels
    (worker/mod.rs:543-561)."""
    log.log(5, "opened audacity")
    if api.get_track_info():
        api.write_assume_empty("New:")
        log.log(5, "opened new project")
    else:
        log.log(5, "no need to open new project")
    api.import_audio(audio_path)
    log.log(5, "loaded audio")
    if label_path.exists():
        api.import_labels_from(label_path)


def merge_parts(
    args: WorkerArgs,
    api: AudacityApi,
    m_index: MultiIndex | None,
    label_track_nr: int | None = None,
) -> list[TaggedFile]:
    """Merge per-part labels into chapters (worker/mod.rs:1201-1324)."""
    if label_track_nr is None:
        label_track_nr = api.get_first_label_track_nr()
        if label_track_nr is None:
            raise RuntimeError("no label track found")
    labels = api.get_label_info().get(label_track_nr)
    if labels is None:
        raise RuntimeError(f"couldn't get track with number {label_track_nr}")
    api.select_tracks([label_track_nr])
    api.write_assume_empty("RemoveTracks:")

    # group parts by (series, nr, chapter)
    grouped: dict[tuple, list] = {}
    for label in labels:
        parsed = parse_line(label.name or "")
        if parsed is None:
            raise ValueError(f"couldn't parse {label.name!r}")
        series, nr, _part, chapter = parsed
        grouped.setdefault((series, nr, chapter), []).append(label)

    merged_track = api.add_label_track("merged")
    from ..hostio.labels import TimeLabel

    for (series, nr, chapter), group in grouped.items():
        if len(group) <= 1:
            continue
        name = f"{series} {nr}"
        if chapter is not None:
            name += f" {chapter}"
        api.add_label(
            TimeLabel(group[0].start, group[-1].end, name), merged_track
        )

    api.write_assume_empty("SelAllTracks:")
    # delete inter-part gaps, latest gap first GLOBALLY. The reference
    # orders by group key descending (worker/mod.rs:1249-1266), which is
    # only correct while key order matches time order — ripple deletes
    # shift everything to their right, so an earlier-keyed group recorded
    # later would be cut at stale coordinates. Descending start time is
    # the invariant the coordinates actually need.
    gaps = [
        (earlier.end, later.start)
        for group in grouped.values()
        for earlier, later in zip(group[-2::-1], group[::-1])
    ]
    for start, end in sorted(gaps, reverse=True):
        api.select_time(start, end)
        api.write_assume_empty("Delete:")

    keys = list(grouped.keys())
    offsets_per_group = calc_merged_offsets(grouped.values())
    tags: list[TaggedFile] = []
    for (series, nr, chapter), offsets in zip(keys, offsets_per_group):
        # chapter=None passes through: a chapterless label exports as
        # "Serie 3.ext" — building the path with "" would add a trailing
        # space and never match the exported file (the reference panics
        # on None here, tagger.rs:207-209; we degrade gracefully)
        path = args.tmp_path / (
            build_timelabel_name(series, nr, None, chapter)
            + f".{args.export_ext}"
        )
        tag = TaggedFile.new_empty(path)
        tags.append(tag)
        tag.set(Title, chapter if chapter is not None else "")
        tag.set(Album, series)
        tag.set(Genre, args.genre)
        tag.set(Track, nr.nr)
        if m_index is not None:
            try:
                index = m_index.get_index(series)
            except IndexReadError:
                index = None
            if index is not None:
                entry = index.try_get(nr.nr)
                tag.set(TotalTracks, index.main_len())
                if entry is not None:
                    if entry.artist is not None:
                        tag.set(Artist, entry.artist)
                    year = entry.release_year()
                    if year is not None:
                        tag.set(Year, year)
        if offsets:
            # both tag formats carry chapters here (ID3 CHAP / Vorbis
            # CHAPTERxxx) — the reference's opus panic (tagger.rs:207-209)
            # has no analogue
            for i, offset in enumerate([0.0, *offsets], start=1):
                tag.set_chapter(i, offset, f"Part {i}")
    return tags


def move_results(tags, from_dir: Path, to_dir: Path, dry_run: bool) -> None:
    """Move exported chapter files into the archive layout
    (worker/mod.rs:1164-1199): ``{to}/{album[/subseries]}/{album track
    title}.{ext}``."""
    for tag in tags:
        album = tag.get(Album)
        # the handle's path IS the exported file (merge_parts built it
        # from the parsed label) — rebuilding the name from tag fields
        # would lose the ChapterNumber's ?/- markers (Track stores only
        # the number) and crash the move on such episodes
        src = Path(from_dir) / tag.path.name
        dst = Path(to_dir)
        if album:
            main, sep, sub = album.partition(MultiIndex.SUBSERIES_DELIMITER)
            dst = dst / main
            if sep:
                dst = dst / sub
        if dry_run:
            log.info("[dry-run] would move %s -> %s", src, dst)
            continue
        dst.mkdir(parents=True, exist_ok=True)
        shutil.move(str(src), str(dst / src.name))


def run_worker(
    args: WorkerArgs,
    inputs: Inputs | None = None,
    api: AudacityApi | None = None,
) -> None:
    """The per-file state machine (worker/mod.rs:396-541)."""
    from . import rename

    inputs = inputs or Inputs()
    if args.skip_load and len(args.audio_paths) != 1:
        raise ValueError("skipping only allowed with single audio")
    lazy = LazyApi(args.timeout)
    if api is not None:
        lazy._api = api
    m_index = (
        MultiIndex(args.index_folder) if args.index_folder is not None else None
    )
    progress = Progress(args.tmp_path / ".done.txt")

    paths = args.audio_paths
    # Exit must go to the last file Audacity actually sees — when the
    # final path is a skipped sub-file, keying on raw position would
    # leave Audacity running
    real = [
        i for i, p in enumerate(paths) if not _SUB_FILE_RE.search(p.name)
    ]
    last_real = real[-1] if real else -1
    for pos, audio_path in enumerate(paths):
        name = audio_path.name
        if _SUB_FILE_RE.search(name):
            log.info("skipping sub file")
            continue
        label_path = audio_path.with_suffix(".txt")
        api = lazy.get()
        state = progress.get(name)

        if not args.skip_load and (state is None or state < State.LOADED):
            prepare_project(api, audio_path, label_path)
            progress.append(name, State.LOADED)
        else:
            log.debug("skipping load")

        if not args.skip_name and (state is None or state < State.NAMED):
            api.zoom_to()
            inputs.read("press enter when you are ready to start renaming", "")
            if m_index is not None:
                rename.FancyNamer(api, m_index, inputs).rename()
            else:
                rename.old_flow(args, api, inputs)
                rename.adjust_labels(api, inputs)
            api.zoom_to()
            api.export_all_labels_to(label_path, args.dry_run)
            progress.append(name, State.NAMED)
        else:
            log.debug("skipping naming")

        if state is None or state < State.DONE:
            tags = merge_parts(args, api, m_index)
            inputs.read(
                "remove all labels you don't want to export, then press "
                "Ctrl+Shift+E to export and then press enter to continue",
                "",
            )
            existing = [t for t in tags if t.path.exists()]
            missing = [t for t in tags if not t.path.exists()]
            for t in missing:
                t.drop_changes()
            if not existing:
                log.warning("no files exported, skipping move")
            else:
                for tag in existing:
                    tag.reload_empty()
                    tag.save_changes()
                move_results(
                    existing,
                    args.tmp_path,
                    args.index_folder or args.tmp_path,
                    args.dry_run,
                )
            progress.append(name, State.DONE)
        else:
            log.debug("skipping export")

        if not args.skip_load:
            api.write_assume_empty(
                "Close:" if pos < last_real else "Exit:"
            )
