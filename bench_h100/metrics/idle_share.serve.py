"""Share of the traced window in which the device ran no kernel, copy or
set: 1 - (union of their intervals) / window, in %, from the profiler's
trace (serving cells)."""
UNIT = "%"


def read(run):
    if run.trace is None or run.outcome.serving is None:
        return None
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
