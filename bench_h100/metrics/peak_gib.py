"""Peak device memory over the warm-up and the window, weights included:
`torch.cuda.max_memory_allocated()` after the set-up's staging copy of the
weights is freed, in GiB."""
UNIT = "GiB"


def read(run):
    return run.memory_peak_bytes / 2 ** 30 if run.memory_peak_bytes else None
