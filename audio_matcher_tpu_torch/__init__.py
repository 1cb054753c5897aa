"""PyTorch/CUDA port of ``audio_matcher_tpu``'s matchers.

The package mirrors the JAX package's module names. It imports ``torch``
and numpy only (scipy lazily, for one fallback of
``ops.peaks.find_peaks_device``, the scipy resampler and the resampler's
filter design), never ``jax``. Every kernel wrapper runs
its plain PyTorch version on a CPU tensor and its hand-written CUDA kernel
(``csrc/``) on a CUDA tensor, or raises. The entry points run on the
current CUDA device unless the caller passes ``device="cpu"``; nothing
falls back to the CPU. They are :func:`match` and
:class:`~audio_matcher_tpu_torch.models.matcher.SnippetMatcher` (one
query snippet, BASELINE config #2), and
:class:`~audio_matcher_tpu_torch.parallel.sweep.ShardedScanner` (a batch
of episodes against one or more snippets, configs #2 and #3), and
:func:`~audio_matcher_tpu_torch.parallel.sweep.sweep_archive` over files on
disk (config #5); the spectrogram mode (config #4),
:class:`~audio_matcher_tpu_torch.models.spectrogram.SpectrogramMatcher`
and :class:`~audio_matcher_tpu_torch.parallel.sweep.ShardedSpectrogramScanner`,
and the device resampler ``ops.resample.resample_poly_device``. The
scanners and the sweep run on one device or on a mesh of them
(:func:`make_mesh`, :func:`make_local_mesh`), and the sweep over the
processes of a cluster (:func:`init_distributed`). The CLIs ``cli.matcher_cli``
(``audio-matcher-torch``) and ``cli.sweep_cli`` (``audio-sweep-torch``)
drive them from files, with the host modules ``hostio`` (decode, labels,
prefetch), ``meta`` (the resume store, tags and series indexes) and
``utils``. The worker and archive tools are host code around the matcher
and touch no device: ``worker`` (the Audacity scripting-pipe client, its
fake server, the renaming flows and the episode pipeline) behind
``cli.worker_cli`` (``audio-worker-torch``), which cuts, names, tags and
files the episodes whose label files the matcher CLI wrote, and
``archive`` (the label-name grammar, the archive model and its REPL)
behind ``cli.archive_cli`` (``archive-scroller-torch``), which browses
the result.
"""

from .parallel.mesh import init_distributed, make_local_mesh, make_mesh

APP_NAME = "audio-matcher"  # config dir name, as the JAX package's

__version__ = "0.1.0"


def match(snippet, episode, sr, device="cuda", **config_kwargs):
    """One-call library API: find ``snippet`` inside ``episode``.

    Returns the deduped :class:`~audio_matcher_tpu_torch.ops.peaks.Peak`
    list (positions in samples). ``device`` is the torch device that
    stages and scans: by default the current CUDA device, where the CUDA
    kernels run; ``device="cpu"`` runs every kernel's plain version.
    Keyword args go to
    :class:`~audio_matcher_tpu_torch.models.matcher.MatchConfig`.
    """
    from .models.matcher import MatchConfig, SnippetMatcher

    return SnippetMatcher(
        snippet, sr, MatchConfig(**config_kwargs), device=device
    ).match(episode)


def offset_range(rng, offset):
    """Shift a (start, end) index range by ``offset`` samples."""
    return (rng[0] + offset, rng[1] + offset)
