"""Episode hours × queries of every group collected in the window, over
the window's seconds: what an archive sweep feels."""


def read(run):
    if run.mix["driver"] != "batch" or not run.items:
        return None
    return sum(g["pair_hours"] for g in run.items) / run.window_s
