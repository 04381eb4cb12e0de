"""The VAE decode's mean device seconds a generate over the traced run's
untraced first half: the program's `dmoe.pipe.decode` spans that began in
that half, each timed by its CUDA events (`Span.device_seconds()`). None
off the card, and where the program records no such spans."""
UNIT = "s"


def read(run):
    o = run.outcome
    if run.trace is None or o.serving is not None or o.t_split is None:
        return None
    try:
        from diffusion_models_moe_tpu_torch.profiling import spans
    except ImportError:
        return None
    lo, hi = o.t0 * 1e9, o.t_split * 1e9
    secs = [s.device_seconds() for s in spans("dmoe.pipe.decode")
            if lo <= s.start_ns <= hi]
    if not secs or None in secs:
        return None
    return sum(secs) / len(secs)
