"""The whole generate's share of the card's bf16 peak: the model operations
that the generates completed in the traced run's untraced first half need
(text encoders, every UNet call with the second FF product over the
selected experts only, the VAE decode; counted from shapes by the
configuration) over that half's seconds, over 989 TFLOP/s, in %."""
from bench_h100.harness.counts import PEAK_FLOPS

UNIT = "%"


def read(run):
    o = run.outcome
    if run.trace is None or o.serving is not None or not o.untraced:
        return None
    batch = run.cell.mix["batch"]
    gens = len(o.untraced) // batch
    flops = gens * run.cell.family.generate_flops(run.config, batch, o.steps,
                                                  o.guidance)
    return 100.0 * flops / (o.t_split - o.t0) / PEAK_FLOPS
