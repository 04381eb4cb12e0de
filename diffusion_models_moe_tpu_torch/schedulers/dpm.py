"""DPM-Solver++ 2M for eps prediction (PyTorch port of
`diffusion_models_moe_tpu/schedulers/dpm.py`).

The state is the previous step's x0 prediction. Step 0 is first order; from
step 1 on the 2M correction extrapolates x0 from the last two, weighted by
r = h_prev / h in log-SNR; on the last step of runs under 15 steps the
update is first order again (diffusers' `lower_order_final`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.schedulers.common import (NoiseTables, f32,
                                                              spaced_timesteps)

LOWER_ORDER_FINAL_BELOW = 15   # runs shorter than this end first order


@dataclasses.dataclass
class DPMState:
    prev_x0: Optional[torch.Tensor] = None   # the last step's x0 prediction


@dataclasses.dataclass(frozen=True)
class DPMSolverScheduler:
    tables: NoiseTables
    steps_offset: int = 1
    init_noise_sigma: float = 1.0

    @staticmethod
    def create(num_train_timesteps: int = 1000,
               **kw) -> "DPMSolverScheduler":
        return DPMSolverScheduler(NoiseTables.create(num_train_timesteps),
                                  **kw)

    def set_timesteps(self, num_inference_steps: int):
        """Returns (timesteps (T,) int32 numpy, coefficient dict of (T,) f32
        numpy, with the bool `first_order` of the final step of a short run):
        step i goes from the i-th timestep to the next one, the last to
        t = 0."""
        n_train = self.tables.num_train_timesteps
        ts = spaced_timesteps(n_train, num_inference_steps, self.steps_offset)
        acp = self.tables.alphas_cumprod[
            np.clip(np.concatenate([ts, [0]]), 0, n_train - 1)]
        a, s = np.sqrt(acp), np.sqrt(1.0 - acp)
        lam = np.log(a) - np.log(s)
        h = lam[1:] - lam[:-1]
        h_prev = np.concatenate([[np.nan], h[:-1]])
        r = np.where(np.isnan(h_prev), 1.0, h_prev / np.maximum(h, 1e-12))
        first_order = np.zeros(len(ts), bool)
        if len(ts) < LOWER_ORDER_FINAL_BELOW:
            first_order[-1] = True
        return ts, {"sigma_ratio": f32(s[1:] / s[:-1]),
                    "alpha_next": f32(a[1:]),
                    "sigma_cur": f32(s[:-1]), "alpha_cur": f32(a[:-1]),
                    "em1": f32(np.expm1(-h)),            # exp(-h) - 1
                    "r": f32(np.nan_to_num(r, nan=1.0)),
                    "first_order": first_order}

    def init_state(self) -> DPMState:
        return DPMState()

    def scale_model_input(self, coeffs: dict, i: int,
                          sample: torch.Tensor) -> torch.Tensor:
        return sample

    def step(self, state: DPMState, coeffs: dict, eps: torch.Tensor, i: int,
             sample: torch.Tensor) -> tuple[DPMState, torch.Tensor]:
        c = {k: v[i] for k, v in coeffs.items()}
        x0 = (sample - float(c["sigma_cur"]) * eps) / float(c["alpha_cur"])
        if i == 0 or c["first_order"]:
            d = x0
        else:
            # f32 arithmetic on the f32 table entries, as the JAX step does
            inv = np.float32(1.0) / (np.float32(2.0) * c["r"])
            d = float(np.float32(1.0) + inv) * x0 - float(inv) * state.prev_x0
        prev = (float(c["sigma_ratio"]) * sample
                - float(c["alpha_next"] * c["em1"]) * d)
        return DPMState(prev_x0=x0), prev
