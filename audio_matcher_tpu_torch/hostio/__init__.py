"""Host IO of the port: decode, label files and the prefetching decoder."""

from .labels import TimeLabel, read_labels, write_labels  # noqa: F401
from .decode import read_audio, audio_duration  # noqa: F401
