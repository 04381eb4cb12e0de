"""Seconds from the process's start to the window's: imports, CUDA context,
the kernels' library (built on a checkout's first run), the weights made
from the seed and loaded, the warm-up."""
UNIT = "s"


def read(run):
    return run.setup_s
