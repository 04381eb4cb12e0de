"""The serving engine's mean queue wait over the traced run's untraced
first half: for each request whose batch started in that half, its batch's
start less its submit, from the program's spans (`dmoe.serve.batch` and
`dmoe.serve.request` in `profiling.spans()`, host clock). None where the
program records no such spans."""
UNIT = "s"


def read(run):
    o = run.outcome
    if run.trace is None or o.serving is None or o.t_split is None:
        return None
    try:
        from diffusion_models_moe_tpu_torch.profiling import spans
    except ImportError:
        return None
    lo, hi = o.t0 * 1e9, o.t_split * 1e9
    starts = {s.attrs["batch"]: s.start_ns for s in spans("dmoe.serve.batch")
              if lo <= s.start_ns <= hi}
    # the window's requests are submitted after it opens, so an earlier
    # engine's requests (whose batch ids repeat) are left out
    waits = [starts[r.attrs["batch"]] - r.start_ns
             for r in spans("dmoe.serve.request")
             if r.start_ns >= lo and r.attrs.get("batch") in starts]
    return sum(waits) / len(waits) / 1e9 if waits else None
