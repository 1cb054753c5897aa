"""Staging: the benchmark's span around the program's staging call
(``stage_resident``), closed when the upload is done on the card; mean
per group of the traced window."""

from portbench.cell import mean_ms


def read(run):
    if run.mix["driver"] != "batch":
        return None
    return mean_ms(run.spans.get("stage"))
