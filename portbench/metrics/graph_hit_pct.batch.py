"""Replays of a captured step over every scan step of the window (first
sights + captures + replays), from the scanner's ``StepGraphs.stats``
before and after the window; on a mesh every card's scans together."""


def read(run):
    if run.mix["driver"] != "batch":
        return None
    g = run.graph
    n = g.get("first", 0) + g.get("captures", 0) + g.get("hits", 0)
    return 100.0 * g.get("hits", 0) / n if n else None
