"""The serving engine's mean batch fill over the traced run's untraced
first half: requests over batch slots (`ServingStats` counters,
differenced across that half), in %."""
UNIT = "%"


def read(run):
    s = run.outcome.serving_untraced
    if s is None or run.trace is None:
        return None
    slots = s["requests"] + s["padded_slots"]
    return 100.0 * s["requests"] / slots if slots else None
