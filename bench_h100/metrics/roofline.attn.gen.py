"""The least time of the work of the denoiser's `*.attn1` modules over the
device time of every kernel launched inside them, in %. The work of a call
is the configuration's count from its input's shape (`attn_work` of
`configs/<config>.py`; the SD family's: self-attention, its q, k, v and out
projections and both products); least time is max(operations / 989e12,
bytes / 3.35e12) per call (`harness/counts.py`). Kernels are attributed by
the host launch inside the module's range, whatever implements it."""
from bench_h100.harness import counts

UNIT = "%"
RANGE = "bench.attn1"


def read(run):
    t = run.trace
    if t is None or run.outcome.serving is not None:
        return None
    shapes, device_s = t["calls"].get(RANGE), t["range_device_s"].get(RANGE)
    if not shapes or not device_s:
        return None
    work, least = run.cell.family.attn_work, 0.0
    for shape in shapes:
        least += counts.least_seconds(*work(run.config, shape))
    return 100.0 * least / device_s
