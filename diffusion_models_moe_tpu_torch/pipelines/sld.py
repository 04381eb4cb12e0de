"""Safe Latent Diffusion (SLD) guidance (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/pipelines/sld.py`, the reference's
"SD1.4-safe" baseline: a third conditioning, the safety concept, joins the
classifier-free-guidance batch (UNet batch 3B: uncond, cond, safety), and
the safety guidance with momentum is applied inside the step loop. Per
element, with eps_u, eps_c, eps_s the three predictions:

  scale   = clip(|eps_c - eps_s| * s_g, 0, 1)
  mask    = where(eps_c - eps_s >= threshold, 0, scale)
  gamma   = mask * (eps_s - eps_u) + momentum_scale * momentum
  momentum <- beta * momentum + (1 - beta) * gamma
  eps_hat = eps_u + g * ((eps_c - eps_u) - [i >= warmup] * gamma)

As in the JAX package, `eps_hat` goes to the scheduler's step as it is: the
loop has no v -> eps conversion, no LCM guidance embedding and no LCM step
noise, so `sld_denoise` refuses `prediction_type="v_prediction"` and
`scheduler="lcm"`, and the initial latents are scaled by the scheduler's
`init_noise_sigma`. MoE interventions (`ivs`), which the JAX function does
not take, act on every UNet call where given.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from diffusion_models_moe_tpu_torch.taps import Interventions

# the safety concept of the SLD paper and the safe-SD configuration
SAFETY_CONCEPT = (
    "an image showing hate, harassment, violence, suffering, humiliation, harm, "
    "suicide, sexual, nudity, bodily fluids, blood, obscene gestures, illegal "
    "activity, drug use, theft, vandalism, weapons, child abuse, brutality, "
    "cruelty")


@dataclasses.dataclass(frozen=True)
class SLDConfig:
    """The Hyp-Medium defaults of diffusers' StableDiffusionPipelineSafe
    (sld_guidance_scale 1000, sld_threshold 0.01, sld_momentum_scale 0.3,
    sld_mom_beta 0.4, sld_warmup_steps 10); the paper's other presets are
    the classmethods."""
    guidance_scale: float = 1000.0
    threshold: float = 0.01
    momentum_scale: float = 0.3
    momentum_beta: float = 0.4
    warmup_steps: int = 10

    @classmethod
    def weak(cls) -> "SLDConfig":
        return cls(guidance_scale=200.0, threshold=0.0, momentum_scale=0.0,
                   momentum_beta=0.0, warmup_steps=15)

    @classmethod
    def medium(cls) -> "SLDConfig":
        return cls()

    @classmethod
    def strong(cls) -> "SLDConfig":
        return cls(guidance_scale=2000.0, threshold=0.025,
                   momentum_scale=0.5, momentum_beta=0.7, warmup_steps=7)

    @classmethod
    def max(cls) -> "SLDConfig":
        return cls(guidance_scale=5000.0, threshold=1.0, momentum_scale=0.5,
                   momentum_beta=0.7, warmup_steps=0)


def sld_combine(eps_u: torch.Tensor, eps_c: torch.Tensor, eps_s: torch.Tensor,
                momentum: torch.Tensor, i: int, sld: SLDConfig, g: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of SLD's guidance: (eps_hat, the new momentum). The
    momentum term is added to the safety guidance before the EMA consumes
    it, the safe-SD pipeline's order; before `warmup_steps` the safety
    guidance is not applied, but the momentum still accumulates."""
    guidance = eps_c - eps_u
    scale = torch.clamp(torch.abs(eps_c - eps_s) * sld.guidance_scale,
                        0.0, 1.0)
    mask = torch.where(eps_c - eps_s >= sld.threshold,
                       torch.zeros_like(scale), scale)
    safety = mask * (eps_s - eps_u) + sld.momentum_scale * momentum
    momentum = (sld.momentum_beta * momentum
                + (1 - sld.momentum_beta) * safety)
    apply = 1.0 if i >= sld.warmup_steps else 0.0
    return eps_u + g * (guidance - apply * safety), momentum


def _check(pipe) -> None:
    cfg = pipe.config
    if cfg.prediction_type == "v_prediction":
        raise ValueError(
            "SLD feeds the guided prediction to the scheduler as eps, as the "
            "JAX package does; a v-prediction model's output would need the "
            "v -> eps conversion first, which the reference's loop lacks")
    if cfg.scheduler == "lcm":
        raise ValueError(
            "SLD runs classifier-free guidance on a 3B batch; LCM takes its "
            "guidance through the embedding and needs step noise, neither of "
            "which the reference's SLD loop provides")


@torch.no_grad()
def sld_denoise(pipe, context3: torch.Tensor, latents: torch.Tensor,
                num_steps: int, guidance_scale: float, sld: SLDConfig,
                ivs: Optional[Interventions] = None,
                use_kernels: bool = True) -> torch.Tensor:
    """SLD's step loop on a `StableDiffusionPipeline`. context3: (3B, S, D)
    in the order uncond, cond, safety; latents (B, C, h, w): the initial
    noise already scaled by the scheduler's `init_noise_sigma`. Returns the
    final latents in f32. `use_kernels=False` runs the kernels' plain
    versions (for kernel-vs-plain comparisons)."""
    _check(pipe)
    sched = pipe.scheduler
    timesteps, coeffs = sched.set_timesteps(num_steps)
    state = sched.init_state()
    x = latents.to(pipe.device, torch.float32)
    context3 = context3.to(pipe.device)
    momentum = torch.zeros_like(x)
    for i, t in enumerate(timesteps.tolist()):
        lat_in = sched.scale_model_input(coeffs, i, torch.cat([x, x, x]))
        eps = pipe.unet(lat_in, t, context3, ivs=ivs, step_idx=i,
                        use_kernels=use_kernels)
        eps_u, eps_c, eps_s = eps.chunk(3)
        eps_hat, momentum = sld_combine(eps_u, eps_c, eps_s, momentum, i, sld,
                                        guidance_scale)
        state, x = sched.step(state, coeffs, eps_hat, i, x)
    return x


@torch.no_grad()
def sld_generate(pipe, cond_ids: torch.Tensor, uncond_ids: torch.Tensor,
                 safety_ids: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 num_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None,
                 sld: SLDConfig = SLDConfig(),
                 ivs: Optional[Interventions] = None,
                 decode: bool = True, seeds=None) -> torch.Tensor:
    """Safety-guided generation on a `StableDiffusionPipeline`: ids (B, S)
    of the prompt, the negative prompt and the safety concept (one row of
    safety ids is repeated for the batch) -> images (B, 3, 8s, 8s) in
    [0, 1], or the final latents with decode=False. The initial noise comes
    from `generator`, or from each request's own seed (`seeds`), times the
    scheduler's `init_noise_sigma`."""
    _check(pipe)
    cfg = pipe.config
    num_steps = num_steps or cfg.num_inference_steps
    g = cfg.guidance_scale if guidance_scale is None else guidance_scale
    b = cond_ids.shape[0]
    if (generator is None) == (seeds is None):
        raise ValueError("sld_generate takes a generator or seeds, not both")
    if safety_ids.shape[0] == 1:
        safety_ids = safety_ids.expand(b, -1)
    cond, _ = pipe.encode_text(cond_ids)
    uncond, _ = pipe.encode_text(uncond_ids)
    safety, _ = pipe.encode_text(safety_ids)
    latents = (pipe.seeded_noise(seeds) if seeds is not None
               else pipe.initial_noise(b, generator))
    latents = latents.to(pipe.device) * pipe.scheduler.init_noise_sigma
    latents = sld_denoise(pipe, torch.cat([uncond, cond, safety]), latents,
                          num_steps, g, sld, ivs=ivs)
    return pipe.decode(latents) if decode else latents
