"""The serving engine's mean seconds a batch, from batch start to images on
the host, over the traced run's untraced first half
(`ServingStats.total_batch_seconds / batches`, differenced across that
half)."""
UNIT = "s"


def read(run):
    s = run.outcome.serving_untraced
    if s is None or run.trace is None or not s["batches"]:
        return None
    return s["batch_seconds"] / s["batches"]
