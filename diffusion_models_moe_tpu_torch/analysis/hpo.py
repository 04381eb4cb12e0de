"""Hyperparameter search for removal thresholds (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/analysis/hpo.py`: Optuna-free
studies (grid, random, and a Tree-structured Parzen Estimator over a box
space) with JSON trial logs, and the noise-difference objective that scores
a removal by how far it moves the per-step CFG-combined noise prediction
(the `save_eps` tap) from the unedited model's on the same prompts and
seed.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.taps import TapSpec


@dataclasses.dataclass
class Trial:
    number: int
    params: dict
    value: float


@dataclasses.dataclass
class Study:
    """Minimal study: grid or random sampling, JSON persistence, best-trial query."""
    name: str
    direction: str = "minimize"
    storage_dir: Optional[str] = None
    trials: list[Trial] = dataclasses.field(default_factory=list)

    def optimize_grid(self, objective: Callable[[dict], float],
                      grid: dict[str, Sequence]) -> Trial:
        keys = list(grid)

        def expand(i, current):
            if i == len(keys):
                yield dict(current)
                return
            for v in grid[keys[i]]:
                current[keys[i]] = v
                yield from expand(i + 1, current)

        for combo in expand(0, {}):
            self._run_trial(objective, combo)
        return self.best_trial()

    def optimize_random(self, objective: Callable[[dict], float],
                        space: dict[str, tuple[float, float]], n_trials: int,
                        seed: int = 0) -> Trial:
        rng = np.random.RandomState(seed)
        for _ in range(n_trials):
            params = {k: float(rng.uniform(lo, hi))
                      for k, (lo, hi) in space.items()}
            self._run_trial(objective, params)
        return self.best_trial()

    def optimize_tpe(self, objective: Callable[[dict], float],
                     space: dict[str, tuple[float, float]], n_trials: int,
                     seed: int = 0, n_startup: int = 5, gamma: float = 0.25,
                     n_candidates: int = 24) -> Trial:
        """Tree-structured Parzen Estimator over a box space (the reference's
        Optuna studies use TPESampler by default). After `n_startup` random
        trials, completed trials split into the best gamma-quantile ("good")
        and the rest; candidates are drawn from the good Parzen mixture and
        ranked by log l(x) - log g(x), independently per dimension."""
        rng = np.random.RandomState(seed)

        def bandwidth(centers: np.ndarray, lo: float, hi: float) -> float:
            # Fixed-fraction-of-range bandwidth shrunk by sample count
            # (Optuna-style magic constants not replicated; behavior-equivalent
            # density ranking is what matters here). Shared by the Parzen
            # density and the candidate sampler so they can't drift apart.
            return max((hi - lo) / 5.0 / max(len(centers), 1) ** 0.5, 1e-12)

        def log_kde(x: float, centers: np.ndarray, lo: float, hi: float
                    ) -> float:
            sigma = bandwidth(centers, lo, hi)
            z = (x - centers) / sigma
            return float(np.log(np.mean(np.exp(-0.5 * z * z)) /
                                (sigma * np.sqrt(2 * np.pi)) + 1e-300))

        for _ in range(n_trials):
            if len(self.trials) < n_startup:
                params = {k: float(rng.uniform(lo, hi))
                          for k, (lo, hi) in space.items()}
            else:
                ordered = sorted(self.trials, key=lambda t: t.value,
                                 reverse=(self.direction == "maximize"))
                n_good = max(1, int(np.ceil(gamma * len(ordered))))
                good, bad = ordered[:n_good], ordered[n_good:] or ordered
                params = {}
                for k, (lo, hi) in space.items():
                    g_centers = np.asarray([t.params[k] for t in good])
                    b_centers = np.asarray([t.params[k] for t in bad])
                    sigma = bandwidth(g_centers, lo, hi)
                    cands = np.clip(
                        g_centers[rng.randint(len(g_centers), size=n_candidates)]
                        + rng.randn(n_candidates) * sigma, lo, hi)
                    scores = [log_kde(c, g_centers, lo, hi)
                              - log_kde(c, b_centers, lo, hi) for c in cands]
                    params[k] = float(cands[int(np.argmax(scores))])
            self._run_trial(objective, params)
        return self.best_trial()

    def _run_trial(self, objective, params) -> None:
        value = float(objective(params))
        self.trials.append(Trial(len(self.trials), params, value))
        if self.storage_dir:
            os.makedirs(self.storage_dir, exist_ok=True)
            with open(os.path.join(self.storage_dir,
                                   f"{self.name}.json"), "w") as f:
                json.dump([dataclasses.asdict(t) for t in self.trials], f,
                          indent=1)

    def best_trial(self) -> Trial:
        key = (min if self.direction == "minimize" else max)
        return key(self.trials, key=lambda t: t.value)


def noise_diff_objective(pipe, tokenize, prompts: Sequence[str],
                         make_ivs: Callable[[dict], object],
                         seed: int = 0, num_steps: Optional[int] = None
                         ) -> Callable[[dict], float]:
    """Objective(params) = mean over prompts of the mean over steps of
    ||eps_removed - eps_base||, the per-step CFG-combined noise predictions
    of `pipe.generate` with the interventions `make_ivs(params)` and
    without. Every generate starts from the noise of `seeds=[seed]`; the
    negative prompt is all-zero ids. Lower = the removal moves the model
    less."""
    def run(prompt, ivs) -> np.ndarray:
        cond = tokenize([prompt])
        _, taps = pipe.generate(cond, torch.zeros_like(cond), seeds=[seed],
                                num_steps=num_steps, ivs=ivs,
                                tap=TapSpec(save_eps=True), decode=False)
        return taps["eps"][0].float().cpu().numpy()     # (T, B, C, h, w)

    base_eps = [run(p, None) for p in prompts]

    def objective(trial_params: dict) -> float:
        ivs = make_ivs(trial_params)
        diffs = []
        for p, b in zip(prompts, base_eps):
            e = run(p, ivs)
            t = e.shape[0]
            diffs.append(np.mean(np.linalg.norm(
                (e - b).reshape(t, -1), axis=-1)))
        return float(np.mean(diffs))

    return objective
