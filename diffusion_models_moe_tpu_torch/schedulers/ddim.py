"""DDIM scheduler (eta 0), SD2.x's sampler (PyTorch port of
`diffusion_models_moe_tpu/schedulers/ddim.py`).

One UNet call a step, no history: x_{t-1} = sqrt(a_prev) x0 + sqrt(1 -
a_prev) eps with x0 = (x_t - sqrt(1 - a_t) eps) / sqrt(a_t). The step past
t = 0 lands on alphas_cumprod[0] (`set_alpha_to_one=False`, the SD2.1 and
SD1.x setting).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.schedulers.common import (NoiseTables, f32,
                                                              spaced_timesteps)


@dataclasses.dataclass
class DDIMState:
    pass    # DDIM keeps no history


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    tables: NoiseTables
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    init_noise_sigma: float = 1.0

    @staticmethod
    def create(num_train_timesteps: int = 1000, **kw) -> "DDIMScheduler":
        return DDIMScheduler(NoiseTables.create(num_train_timesteps), **kw)

    def set_timesteps(self, num_inference_steps: int):
        """Returns (timesteps (T,) int32 numpy, coefficient dict of (T,) f32
        numpy); T = steps."""
        n_train = self.tables.num_train_timesteps
        ts = spaced_timesteps(n_train, num_inference_steps, self.steps_offset)
        prev_ts = ts - n_train // num_inference_steps
        acp = self.tables.alphas_cumprod
        final_acp = 1.0 if self.set_alpha_to_one else acp[0]
        a_t = acp[ts]
        a_prev = np.where(prev_ts >= 0, acp[np.clip(prev_ts, 0, None)],
                          final_acp)
        return ts, {"sqrt_a_t": f32(np.sqrt(a_t)),
                    "sqrt_1m_a_t": f32(np.sqrt(1 - a_t)),
                    "sqrt_a_prev": f32(np.sqrt(a_prev)),
                    "sqrt_1m_a_prev": f32(np.sqrt(1 - a_prev))}

    def init_state(self) -> DDIMState:
        return DDIMState()

    def scale_model_input(self, coeffs: dict, i: int,
                          sample: torch.Tensor) -> torch.Tensor:
        return sample

    def step(self, state: DDIMState, coeffs: dict, eps: torch.Tensor, i: int,
             sample: torch.Tensor) -> tuple[DDIMState, torch.Tensor]:
        c = {k: float(v[i]) for k, v in coeffs.items()}
        x0 = (sample - c["sqrt_1m_a_t"] * eps) / c["sqrt_a_t"]
        return state, c["sqrt_a_prev"] * x0 + c["sqrt_1m_a_prev"] * eps
