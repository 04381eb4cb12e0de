"""Euler discrete scheduler in sigma space, no churn (PyTorch port of
`diffusion_models_moe_tpu/schedulers/euler.py`).

The carried latent is x in sigma space, sqrt(sigma^2 + 1) x_t; the UNet
sees it scaled back by 1 / sqrt(sigma^2 + 1) (`scale_model_input`) and a
step moves it along eps: x + eps (sigma_next - sigma), with a trailing
sigma of 0. Initial latents are N(0, 1) times `init_noise_sigma_for(steps)`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.schedulers.common import (NoiseTables, f32,
                                                              spaced_timesteps)


@dataclasses.dataclass
class EulerState:
    pass    # a step reads eps and the two sigmas only


@dataclasses.dataclass(frozen=True)
class EulerDiscreteScheduler:
    tables: NoiseTables
    steps_offset: int = 1

    @staticmethod
    def create(num_train_timesteps: int = 1000,
               **kw) -> "EulerDiscreteScheduler":
        return EulerDiscreteScheduler(NoiseTables.create(num_train_timesteps),
                                      **kw)

    def _sigmas_full(self) -> np.ndarray:
        acp = self.tables.alphas_cumprod
        return np.sqrt((1 - acp) / acp)

    @property
    def init_noise_sigma(self) -> float:
        """sqrt(max sigma^2 + 1) over the whole training table (about 14.6):
        diffusers' value before `set_timesteps`. A pipeline scales its
        initial latents by `init_noise_sigma_for(num_steps)` instead (about
        13.2 at 50 steps); this one would hand the UNet a first input of std
        about 1.11."""
        acp = self.tables.alphas_cumprod
        max_sigma = float(np.sqrt((1 - acp).max() / acp.min()))
        return float(np.sqrt(max_sigma ** 2 + 1))

    def init_noise_sigma_for(self, num_inference_steps: int) -> float:
        """sqrt(sigma_0^2 + 1) at the first timestep of a run of this many
        steps: the scale of its initial latents."""
        n_train = self.tables.num_train_timesteps
        ts = spaced_timesteps(n_train, num_inference_steps, self.steps_offset)
        s0 = float(np.interp(float(np.max(ts)), np.arange(n_train),
                             self._sigmas_full()))
        return float(np.sqrt(s0 ** 2 + 1.0))

    def set_timesteps(self, num_inference_steps: int):
        """Returns (timesteps (T,) int32 numpy, {"sigmas": (T + 1,) f32
        numpy}), the last sigma 0."""
        n_train = self.tables.num_train_timesteps
        ts = spaced_timesteps(n_train, num_inference_steps, self.steps_offset)
        sigmas = np.interp(ts.astype(np.float64), np.arange(n_train),
                           self._sigmas_full())
        return ts, {"sigmas": f32(np.concatenate([sigmas, [0.0]]))}

    def init_state(self) -> EulerState:
        return EulerState()

    def scale_model_input(self, coeffs: dict, i: int,
                          sample: torch.Tensor) -> torch.Tensor:
        sigma = coeffs["sigmas"][i]
        return sample / float(np.sqrt(sigma * sigma + np.float32(1.0)))

    def step(self, state: EulerState, coeffs: dict, eps: torch.Tensor, i: int,
             sample: torch.Tensor) -> tuple[EulerState, torch.Tensor]:
        sigmas = coeffs["sigmas"]
        # eps prediction: in sigma space the derivative is eps itself
        return state, sample + eps * float(sigmas[i + 1] - sigmas[i])
