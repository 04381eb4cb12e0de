"""Vectorized cross-prompt statistics accumulators (PyTorch port).

A copy of `diffusion_models_moe_tpu/analysis/stats.py`, which is numpy only;
the port cannot import it, as the JAX package loads JAX on import.

Replaces the reference's per-(timestep, layer) dict-of-meters
(`Average`/`StandardDev`/`StatMeter`/`ColumnNormCalculator`/`TimeLayerColumnNorm`,
reference: utils.py:233-370) with Welford accumulation over whole `(T, ...)` arrays:
one `update()` per prompt consumes the stacked tap output of a full traced generation.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


class WelfordArray:
    """Streaming mean/std over array-valued samples (Welford, matching the
    reference's scalar recurrence at utils.py:254-272)."""

    def __init__(self):
        self.n = 0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None

    def update(self, x) -> None:
        x = np.asarray(x, np.float64)
        if self.mean is None:
            self.mean = np.zeros_like(x)
            self.m2 = np.zeros_like(x)
        self.n += 1
        delta = x - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (x - self.mean)

    def variance(self) -> np.ndarray:
        if self.n < 2:
            return np.full_like(self.mean, np.nan)
        return self.m2 / (self.n - 1)

    def std(self) -> np.ndarray:
        return np.sqrt(self.variance())


class TapAccumulator:
    """Accumulates one tap stat over prompts: {layer: WelfordArray over (T, ...)}.

    Equivalent to the reference's StatMeter keyed (t, l) (utils.py:276-313), but each
    layer's (T, H) array is a single vectorized sample.
    """

    def __init__(self):
        self.layers: dict[int, WelfordArray] = {}

    def update(self, per_layer: dict[int, np.ndarray]) -> None:
        for l, arr in per_layer.items():
            self.layers.setdefault(l, WelfordArray()).update(np.asarray(arr))

    def mean(self) -> dict[int, np.ndarray]:
        return {l: w.mean for l, w in self.layers.items()}

    def std(self) -> dict[int, np.ndarray]:
        return {l: w.std() for l, w in self.layers.items()}

    def save(self, path: str) -> None:
        """JSON artifact shaped like the reference's predictivity files:
        {'time_steps': {t: {l: {'avg': [...], 'std': [...]}}}}
        (reference: utils.py:298-313)."""
        out = {"time_steps": {}}
        # std() computes the whole (T, H) array: once per layer, not per t
        means = {l: np.asarray(w.mean) for l, w in self.layers.items()}
        stds = {l: np.asarray(w.std()) for l, w in self.layers.items()}
        t_max = max(m.shape[0] for m in means.values())
        for t in range(t_max):
            out["time_steps"][str(t)] = {}
            for l in sorted(self.layers):
                if t >= means[l].shape[0]:
                    continue   # ragged layers (shorter tap runs) end early
                out["time_steps"][str(t)][str(l)] = {
                    "avg": means[l][t].tolist(),
                    "std": stds[l][t].tolist(),
                }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f)


class PairedDiffStd:
    """Welford std of per-prompt (base - adj) differences — the paired t-test's
    denominator (reference: modularity/modularity_analysis.py:86-104 `diff_std`)."""

    def __init__(self):
        self.w = {}

    def update(self, base: dict[int, np.ndarray], adj: dict[int, np.ndarray]):
        for l in base:
            self.w.setdefault(l, WelfordArray()).update(
                np.asarray(base[l], np.float64) - np.asarray(adj[l], np.float64))

    def std(self) -> dict[int, np.ndarray]:
        return {l: w.std() for l, w in self.w.items()}


class ColumnNormAccumulator:
    """Sum of squared column entries; sqrt on read. Equivalent to the reference's
    incremental norm sqrt(old^2 + new^2) (utils.py:316-334) but associative, so the
    per-step sums can come straight out of the traced scan
    (`TapSpec.ff_out_colnorm_sq`)."""

    def __init__(self):
        self.sq: dict[int, np.ndarray] = {}

    def update(self, colnorm_sq: dict[int, np.ndarray]) -> None:
        for l, arr in colnorm_sq.items():
            arr = np.asarray(arr, np.float64)
            self.sq[l] = self.sq.get(l, 0.0) + arr

    def norms(self) -> dict[int, np.ndarray]:
        """Per-layer (T, H) column norms."""
        return {l: np.sqrt(v) for l, v in self.sq.items()}

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **{str(l): v for l, v in self.norms().items()})


def load_colnorms(path: str) -> dict[int, np.ndarray]:
    with np.load(path) as z:
        return {int(k): z[k] for k in z.files}
