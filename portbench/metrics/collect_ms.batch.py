"""Host wall of ``scan_collect`` after the group's ready event was waited
on: read-back, the host's peak rounds and the cross-window dedup; mean per
group of the traced window."""

from portbench.cell import mean_ms


def read(run):
    if run.mix["driver"] != "batch":
        return None
    return mean_ms(run.spans.get("collect"))
