"""The share of the traced window in which no kernel and no copy ran on
the card (the mean over the cards of a mesh), from the profiler's trace."""


def read(run):
    if run.mix["driver"] != "batch" or run.trace is None:
        return None
    t = run.trace
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
