"""The least time of the correlation work the traced window did (its F
operations and B bytes, ``portbench/work.py``) over the summed device
time of every kernel in the window, on every card: a share of the chip's
roofline, in %."""

from portbench import work


def read(run):
    if run.mix["driver"] != "batch" or run.trace is None:
        return None
    kernel_s = run.trace["kernel_s"]
    if kernel_s <= 0:
        return None
    F = sum(i["F"] for i in run.items)
    B = sum(i["B"] for i in run.items)
    return 100.0 * work.least_seconds(F, B) / kernel_s
