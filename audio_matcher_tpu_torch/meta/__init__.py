"""The resume store, the tags and the series indexes (copies of the JAX
package's ``meta.progress``, ``meta.tagger`` and ``meta.index``, whose file
formats they keep byte for byte)."""

from .progress import Progress, State  # noqa: F401
from .tagger import (  # noqa: F401
    Album,
    Artist,
    Disk,
    Genre,
    Length,
    TaggedFile,
    Title,
    TotalDisks,
    TotalTracks,
    Track,
    Year,
)
from .index import Index, MultiIndex, ChapterEntry  # noqa: F401
