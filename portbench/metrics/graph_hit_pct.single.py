"""Replays of a captured step over every scan step of the window (first
sights + captures + replays), from the matchers' ``StepGraphs.stats``
before and after the window: two steps a request on the live path."""


def read(run):
    if run.mix["driver"] != "serial":
        return None
    g = run.graph
    n = g.get("first", 0) + g.get("captures", 0) + g.get("hits", 0)
    return 100.0 * g.get("hits", 0) / n if n else None
