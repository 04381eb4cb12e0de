"""Images completed per second over the window: every image of every
generate begun in the window, over the time from the window's start to the
last generate's return (host clock, closed-loop cells)."""
UNIT = "images/s"


def read(run):
    o = run.outcome
    if o.serving is not None or not o.completed_in_window:
        return None
    return len(o.completed_in_window) / (o.t1 - o.t0)
