"""Host wall of ``scan_dispatch``: the step cache's lookup, a replay or the
eager launches, and on a mesh the per-card issue threads; mean per group
of the traced window."""

from portbench.cell import mean_ms


def read(run):
    if run.mix["driver"] != "batch":
        return None
    return mean_ms(run.spans.get("dispatch"))
