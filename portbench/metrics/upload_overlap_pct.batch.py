"""The share of the staged bytes whose host-to-device copy was issued
while a later part of their fill was still being written, from the
program's ``STAGING_STATS`` over the process (set-up and window): how
often the copy overlaps the fill in the sweep. Nothing where the program
keeps no such counter."""


def read(run):
    if run.mix["driver"] != "batch":
        return None
    try:
        from audio_matcher_tpu_torch.models.matcher import STAGING_STATS
    except ImportError:  # a program that copies only after the fill
        return None
    staged = STAGING_STATS.get("staged_bytes", 0)
    return 100.0 * STAGING_STATS.get("early_bytes", 0) / staged \
        if staged else None
