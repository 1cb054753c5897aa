"""The Audacity episode worker: the scripting-pipe client, its fake
server, the renaming flows and the pipeline (host code, no device)."""

from .audacity import AudacityApi, AudacityError, LaunchError  # noqa: F401
from .pipeline import WorkerArgs, calc_merged_offsets, run_worker  # noqa: F401
