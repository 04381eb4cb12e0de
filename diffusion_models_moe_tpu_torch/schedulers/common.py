"""Shared noise-schedule tables (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/schedulers/common.py`: the beta
schedules, the cumulative-product alpha tables every scheduler reads, and
the descending inference timesteps. Tables are float64 numpy, computed on
the host once; each scheduler rounds the coefficients it hands to the step
to f32, as the JAX tables are. (`add_noise` and `snr` of the JAX module
serve training, which is not ported.)
"""
from __future__ import annotations

import dataclasses

import numpy as np


def make_betas(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
               beta_end: float = 0.012, beta_schedule: str = "scaled_linear"
               ) -> np.ndarray:
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                           num_train_timesteps, dtype=np.float64) ** 2
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float64)
    raise ValueError(f"unknown beta schedule {beta_schedule}")


@dataclasses.dataclass(frozen=True)
class NoiseTables:
    """Cumulative-product alpha tables shared by all schedulers."""
    num_train_timesteps: int
    alphas_cumprod: np.ndarray   # (num_train_timesteps,) float64

    @staticmethod
    def create(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
               beta_end: float = 0.012,
               beta_schedule: str = "scaled_linear") -> "NoiseTables":
        betas = make_betas(num_train_timesteps, beta_start, beta_end,
                           beta_schedule)
        return NoiseTables(num_train_timesteps, np.cumprod(1.0 - betas))


def spaced_timesteps(num_train_timesteps: int, num_inference_steps: int,
                     steps_offset: int = 1) -> np.ndarray:
    """Descending inference timesteps (diffusers 'leading' spacing), int32."""
    ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * ratio).round()[::-1]
    return ts.astype(np.int32) + steps_offset


def f32(x) -> np.ndarray:
    """A coefficient table rounded to f32, as the JAX tables are."""
    return np.asarray(x, np.float64).astype(np.float32)
