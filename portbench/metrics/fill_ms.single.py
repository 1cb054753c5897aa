"""The program's span ``stage.fill`` (``fill_wire_rows``: a request's
wire row written into the pinned buffer, on the host): ms a request of
the traced window. Nothing where the program records no spans."""


def read(run):
    if run.mix["driver"] != "serial" or not run.items:
        return None
    try:
        from audio_matcher_tpu_torch.utils.spans import records
    except ImportError:  # a program without spans
        return None
    ns = [r.t1_ns - r.t0_ns for r in records() if r.name == "stage.fill"]
    return 1e-6 * sum(ns) / len(run.items) if ns else None
