"""The least time of the correlation work the traced window's requests
did (the F operations and B bytes of one episode against one query,
``portbench/work.py``, summed) over the summed device time of every
kernel in the window: a share of the chip's roofline, in %. The
single-query path: the forward pass packs window pairs into each
transform (kernel 6), then the minor passes, product, inverse and the
peak reduction."""

from portbench import work


def read(run):
    if run.mix["driver"] != "serial" or run.trace is None:
        return None
    kernel_s = run.trace["kernel_s"]
    if kernel_s <= 0:
        return None
    F = sum(i["F"] for i in run.items)
    B = sum(i["B"] for i in run.items)
    return 100.0 * work.least_seconds(F, B) / kernel_s
