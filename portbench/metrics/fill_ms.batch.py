"""The program's span ``stage.fill`` (``fill_wire_rows``: the group's wire
rows written into the pinned buffer, on the host): mean per group of the
traced window. Nothing where the program records no spans."""

from portbench.cell import mean_ms


def read(run):
    if run.mix["driver"] != "batch":
        return None
    try:
        from audio_matcher_tpu_torch.utils.spans import records
    except ImportError:  # a program without spans
        return None
    return mean_ms([(r.t1_ns - r.t0_ns) / 1e9 for r in records()
                    if r.name == "stage.fill"])
