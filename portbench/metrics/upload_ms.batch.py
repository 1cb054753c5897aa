"""The staged groups' host-to-device copies on the card: the window's
``Memcpy HtoD`` device time in the profiler's trace (every card of a
mesh), over the program's ``stage`` spans, one a staged group; ms per
group. Nothing on the CPU, where the trace holds no copy, nor where the
program records no spans."""


def read(run):
    if run.mix["driver"] != "batch" or run.trace is None:
        return None
    try:
        from audio_matcher_tpu_torch.utils.spans import records
    except ImportError:  # a program without spans
        return None
    groups = sum(r.name == "stage" for r in records())
    h2d_s = sum(s for name, s in run.trace["device_ops"]
                if name.startswith("Memcpy HtoD"))
    return 1e3 * h2d_s / groups if groups and h2d_s else None
