"""The resume store and the duration tag cache (copies of the JAX
package's ``meta.progress`` and of the part of ``meta.tagger`` that the
duration cache runs, whose file formats they keep byte for byte)."""

from .progress import Progress, State  # noqa: F401
from .tagger import Length, TaggedFile  # noqa: F401
