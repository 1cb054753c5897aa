"""A request's host-to-device copy on the card: the traced window's
``Memcpy HtoD`` device time in the profiler's trace, ms a request.
Nothing on the CPU, where the trace holds no copy."""


def read(run):
    if run.mix["driver"] != "serial" or run.trace is None or not run.items:
        return None
    h2d_s = sum(s for name, s in run.trace["device_ops"]
                if name.startswith("Memcpy HtoD"))
    return 1e3 * h2d_s / len(run.items) if h2d_s else None
