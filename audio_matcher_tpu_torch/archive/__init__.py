"""The label archive: the label-name grammar, the archive model and its
REPL (host code, no device)."""

from .data import (  # noqa: F401
    Archive,
    Chapter,
    ChapterNumber,
    Series,
    Source,
    build_timelabel_name,
    parse_line,
)
