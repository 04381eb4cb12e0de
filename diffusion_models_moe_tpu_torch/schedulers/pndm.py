"""PNDM scheduler (PLMS path, skip_prk_steps=True), the SD1.x default
(PyTorch port of `diffusion_models_moe_tpu/schedulers/pndm.py`).

T = num_steps + 1 model calls: PLMS repeats the second-highest timestep for
its warm-up half-step. PyTorch runs eagerly, so the step index is a Python
int and the branches are plain `if`s.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.schedulers.common import (NoiseTables, f32,
                                                              spaced_timesteps)


@dataclasses.dataclass
class PNDMState:
    ets: list            # most recent eps first, at most 4
    cur_sample: torch.Tensor | None = None   # x_t stashed at the warm-up step


@dataclasses.dataclass(frozen=True)
class PNDMScheduler:
    tables: NoiseTables
    steps_offset: int = 1
    init_noise_sigma: float = 1.0

    @staticmethod
    def create(num_train_timesteps: int = 1000, **kw) -> "PNDMScheduler":
        return PNDMScheduler(NoiseTables.create(num_train_timesteps), **kw)

    def set_timesteps(self, num_inference_steps: int):
        """Returns (timesteps (T,) int64 numpy, coefficient dict of (T,) f32
        numpy); T = steps + 1, with the warm-up step relabelled."""
        n_train = self.tables.num_train_timesteps
        ratio = n_train // num_inference_steps
        base = spaced_timesteps(n_train, num_inference_steps,
                                self.steps_offset)[::-1].astype(np.int64)
        # [t_{n-1}, t_{n-2}, t_{n-2}, t_{n-3}, ..., t_0]
        plms = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1].copy()
        # effective (t, t_prev) per index: step 1 re-uses (t_{n-1} -> t_{n-2})
        t_eff = plms.copy()
        t_prev = plms - ratio
        if len(plms) > 1:
            t_eff[1] = plms[1] + ratio
            t_prev[1] = plms[1]
        acp = self.tables.alphas_cumprod
        a_t = acp[np.clip(t_eff, 0, n_train - 1)]
        a_prev = np.where(t_prev >= 0, acp[np.clip(t_prev, 0, None)], acp[0])
        denom = a_t * np.sqrt(1 - a_prev) + np.sqrt(a_t * (1 - a_t) * a_prev)
        coeffs = {"c_sample": f32(np.sqrt(a_prev / a_t)),
                  "c_eps": f32((a_prev - a_t) / denom)}
        return plms, coeffs

    def init_state(self) -> PNDMState:
        return PNDMState(ets=[])

    def scale_model_input(self, coeffs: dict, i: int,
                          sample: torch.Tensor) -> torch.Tensor:
        return sample

    def step(self, state: PNDMState, coeffs: dict, eps: torch.Tensor, i: int,
             sample: torch.Tensor) -> tuple[PNDMState, torch.Tensor]:
        """One PLMS step at scan index i; returns (state, x_prev)."""
        ets = state.ets if i == 1 else [eps] + state.ets[:3]
        cur_sample = sample if i == 0 else state.cur_sample
        order = min(i, 4)
        if order == 0:
            eps_p = eps
        elif order == 1:
            eps_p = (eps + ets[0]) / 2.0
        elif order == 2:
            eps_p = (3.0 * ets[0] - ets[1]) / 2.0
        elif order == 3:
            eps_p = (23.0 * ets[0] - 16.0 * ets[1] + 5.0 * ets[2]) / 12.0
        else:
            eps_p = (55.0 * ets[0] - 59.0 * ets[1] + 37.0 * ets[2]
                     - 9.0 * ets[3]) / 24.0
        x = cur_sample if i == 1 else sample
        c_s, c_e = float(coeffs["c_sample"][i]), float(coeffs["c_eps"][i])
        return PNDMState(ets=ets, cur_sample=cur_sample), c_s * x - c_e * eps_p
