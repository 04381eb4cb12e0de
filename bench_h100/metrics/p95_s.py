"""95th percentile of every request's latency, from the time it was due to
its result (host clock, open-loop serving cells). A request with no result
after the drain counts as waiting until the drain ended."""
from bench_h100.harness.loader import BENCH, load_module

UNIT = "s"


def read(run):
    if run.outcome.serving is None:
        return None
    kind = load_module(BENCH / "traffic" / "open_poisson.py")
    return kind.latency_percentile(run.outcome, 95.0)
