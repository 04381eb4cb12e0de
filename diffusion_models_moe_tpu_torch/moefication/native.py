"""ctypes bridge to the native exact balanced-assignment solver
(`native/balanced_assign.cpp`) (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/moefication/native.py`, on the same
C++ source, built by the port at first use into the git-ignored
`ops/_build/` (`ops/_build.load_host_library`). Used by
`balanced_kmeans(method="exact")`: a min-cost-flow assignment per Lloyd
iteration.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from diffusion_models_moe_tpu_torch.ops import _build


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load_host_library("balanced_assign")
    lib.balanced_assign.restype = ctypes.c_int
    lib.balanced_assign.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
    return lib


def exact_balanced_assign(cost: np.ndarray, capacity: int) -> np.ndarray:
    """cost: (N, K) float64 -> (N,) int64 labels of least total cost with at
    most `capacity` points a cluster (exactly N / K when capacity = N / K)."""
    lib = _lib()
    cost = np.ascontiguousarray(cost, np.float64)
    n, k = cost.shape
    out = np.empty(n, np.int64)
    rc = lib.balanced_assign(
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, k, capacity,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise RuntimeError(f"balanced_assign failed with code {rc}")
    return out
