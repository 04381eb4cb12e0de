"""Latent Consistency Model scheduler, few-step distilled sampling (PyTorch
port of `diffusion_models_moe_tpu/schedulers/lcm.py`).

The timesteps are a subset of the distillation's origin steps, taken from
the top with a stride. A step maps the x0 prediction through the consistency
boundary scalings (sigma_data 0.5, on the timestep scaled by 10) and, but on
the last step, noises the result back to the next timestep with fresh noise;
the last step returns the denoised sample. The noise comes from one
`torch.Generator` a sample (the counterpart of the JAX package's per-sample
keys), so a sample's noise does not depend on what shares its batch; a
caller may hand the noise in instead (`step(..., noise=)`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.schedulers.common import NoiseTables, f32


@dataclasses.dataclass
class LCMState:
    generators: Sequence[torch.Generator] = ()   # one a sample


@dataclasses.dataclass(frozen=True)
class LCMScheduler:
    tables: NoiseTables
    original_inference_steps: int = 50
    sigma_data: float = 0.5
    timestep_scaling: float = 10.0
    init_noise_sigma: float = 1.0

    @staticmethod
    def create(num_train_timesteps: int = 1000, **kw) -> "LCMScheduler":
        return LCMScheduler(NoiseTables.create(num_train_timesteps), **kw)

    def set_timesteps(self, num_inference_steps: int):
        """Returns (timesteps (T,) int32 numpy, coefficient dict of (T,) f32
        numpy): the origin steps from the top, every skip-th."""
        n_train = self.tables.num_train_timesteps
        k = n_train // self.original_inference_steps
        origin = np.arange(1, self.original_inference_steps + 1) * k - 1
        skip = max(len(origin) // num_inference_steps, 1)
        ts = origin[::-1][::skip][:num_inference_steps].astype(np.int64)
        acp = self.tables.alphas_cumprod
        last = np.arange(len(ts)) == len(ts) - 1
        prev_ts = np.concatenate([ts[1:], [0]])
        # the last step denoises fully: alpha_prev = 1
        a_t, a_prev = acp[ts], np.where(last, 1.0, acp[prev_ts])
        # the boundary scalings on the scaled timestep s = t * scaling
        s = ts.astype(np.float64) * self.timestep_scaling
        sd2 = self.sigma_data ** 2
        return ts.astype(np.int32), {
            "sqrt_a_t": f32(np.sqrt(a_t)),
            "sqrt_1m_a_t": f32(np.sqrt(1 - a_t)),
            "sqrt_a_prev": f32(np.sqrt(a_prev)),
            "sqrt_1m_a_prev": f32(np.sqrt(1 - a_prev)),
            "c_skip": f32(sd2 / (s ** 2 + sd2)),
            "c_out": f32(s / np.sqrt(s ** 2 + sd2)), "is_last": f32(last)}

    def init_state(self, generators: Sequence[torch.Generator] = ()
                   ) -> LCMState:
        return LCMState(generators=tuple(generators))

    def scale_model_input(self, coeffs: dict, i: int,
                          sample: torch.Tensor) -> torch.Tensor:
        return sample

    def step_noise(self, state: LCMState, sample: torch.Tensor
                   ) -> torch.Tensor:
        """N(0, 1) noise shaped like `sample` (B, C, h, w), f32: sample b's
        from the b-th generator, on that generator's device."""
        if len(state.generators) != sample.shape[0]:
            raise ValueError(f"{len(state.generators)} generators for a batch "
                             f"of {sample.shape[0]}: pass one a sample, or "
                             "the noise")
        return torch.stack([
            torch.randn(sample.shape[1:], generator=g, device=g.device)
            for g in state.generators]).to(sample.device)

    def step(self, state: LCMState, coeffs: dict, eps: torch.Tensor, i: int,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None
             ) -> tuple[LCMState, torch.Tensor]:
        """One consistency step; `noise` (B, C, h, w) replaces the draw from
        the state's generators (none is drawn on the last step)."""
        c = {k: float(v[i]) for k, v in coeffs.items()}
        x0 = (sample - c["sqrt_1m_a_t"] * eps) / c["sqrt_a_t"]
        denoised = c["c_out"] * x0 + c["c_skip"] * sample
        if c["is_last"] > 0:
            return state, denoised
        if noise is None:
            noise = self.step_noise(state, sample)
        return state, (c["sqrt_a_prev"] * denoised
                       + c["sqrt_1m_a_prev"] * noise.to(sample))
