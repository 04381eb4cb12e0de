"""Shared noise-schedule tables (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/schedulers/common.py` for the
SD1.x schedule ("scaled_linear" betas): the tables are float64 numpy,
computed on the host once.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NoiseTables:
    """Cumulative-product alpha tables shared by all schedulers."""
    num_train_timesteps: int
    alphas_cumprod: np.ndarray   # (num_train_timesteps,) float64

    @staticmethod
    def create(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
               beta_end: float = 0.012) -> "NoiseTables":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps, dtype=np.float64) ** 2
        return NoiseTables(num_train_timesteps, np.cumprod(1.0 - betas))
