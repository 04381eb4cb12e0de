"""Text-to-image Stable Diffusion pipeline (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/pipelines/stable_diffusion.py`:
CLIP encodes the prompt and the negative prompt, PNDM denoises with
classifier-free guidance (off when guidance <= 1) through the MoE-routed
UNet, and the VAE decodes. Latents and images are NCHW. The JAX pipeline
traces the loop into one `lax.scan`; here it is an eager Python loop.

`denoise(use_kernels=False)` runs the plain versions of the hand-written
kernels on CUDA tensors; it exists only for kernel-vs-plain comparisons.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from diffusion_models_moe_tpu_torch.config import PipelineConfig
from diffusion_models_moe_tpu_torch.models.clip_text import CLIPTextEncoder
from diffusion_models_moe_tpu_torch.models.layers import cast_model
from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
from diffusion_models_moe_tpu_torch.models.vae import VAEDecoder
from diffusion_models_moe_tpu_torch.schedulers.pndm import PNDMScheduler
from diffusion_models_moe_tpu_torch.taps import Interventions


class StableDiffusionPipeline:
    """Holds the three modules and the scheduler on one device."""

    def __init__(self, config: PipelineConfig, device="cpu"):
        if config.scheduler != "pndm":
            raise NotImplementedError(
                f"scheduler {config.scheduler!r} is not ported (pndm only)")
        if config.prediction_type != "epsilon":
            raise NotImplementedError("only epsilon prediction is ported")
        self.config = config
        self.device = torch.device(device)
        with torch.device(self.device):
            self.unet = cast_model(UNet2DCondition(config.unet),
                                   config.unet.dtype).eval()
            self.text_encoder = cast_model(CLIPTextEncoder(config.text_encoder),
                                           config.text_encoder.dtype).eval()
            self.vae_decoder = cast_model(VAEDecoder(config.vae),
                                          config.vae.dtype).eval()
        self.scheduler = PNDMScheduler.create()

    # ------------------------------------------------------------------ params
    def modules(self) -> dict[str, nn.Module]:
        return {"unet": self.unet, "text_encoder": self.text_encoder,
                "vae": self.vae_decoder}

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random weights from `generator`, in the JAX package's init scheme:
        lecun-normal weights (std 1/sqrt(fan_in)), zero biases, unit norm
        scales, token embeddings with std 1/sqrt(width), zero position
        embeddings. Parameters are drawn in state-dict order."""
        gdev = generator.device
        for module in self.modules().values():
            for name, p in module.named_parameters():
                if name.endswith("position_embedding.weight") or (
                        name.endswith("bias")):
                    p.zero_()
                    continue
                owner = module.get_submodule(name.rsplit(".", 1)[0])
                if isinstance(owner, (nn.GroupNorm, nn.LayerNorm)):
                    p.fill_(1.0)
                    continue
                fan_in = (p.shape[1] if isinstance(owner, nn.Embedding)
                          else p[0].numel())
                vals = torch.randn(p.shape, generator=generator, device=gdev)
                p.copy_(vals * fan_in ** -0.5)

    def load_state_dicts(self, state_dicts: dict[str, dict]) -> None:
        """Loads {"unet", "text_encoder", "vae"} state dicts (diffusers /
        transformers names, e.g. from `weights/bridge.py`), strictly."""
        for key, module in self.modules().items():
            module.load_state_dict(state_dicts[key], strict=True)

    # ------------------------------------------------------------------ text
    @torch.no_grad()
    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_encoder(input_ids.to(self.device))

    # ------------------------------------------------------------------ core
    @torch.no_grad()
    def denoise(self, context: torch.Tensor, latents: torch.Tensor,
                num_steps: int, guidance_scale: float,
                ivs: Optional[Interventions] = None,
                use_kernels: bool = True) -> torch.Tensor:
        """CFG denoise. context: (2B, S, D) with the unconditional half first
        (B when guidance <= 1); latents: (B, C, h, w) ~ N(0, 1), pre-scaled.
        Returns the final latents (B, C, h, w) in f32."""
        timesteps, coeffs = self.scheduler.set_timesteps(num_steps)
        do_cfg = guidance_scale > 1.0
        state = self.scheduler.init_state()
        lat = latents.to(self.device, torch.float32)
        context = context.to(self.device)
        for i, t in enumerate(timesteps.tolist()):
            lat_in = torch.cat([lat, lat]) if do_cfg else lat
            eps = self.unet(lat_in, t, context, ivs=ivs, step_idx=i,
                            use_kernels=use_kernels)
            if do_cfg:
                eps_u, eps_c = eps.chunk(2)
                eps = eps_u + guidance_scale * (eps_c - eps_u)
            state, lat = self.scheduler.step(state, coeffs, eps, i, lat)
        return lat

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents -> images (B, 3, H, W) in [0, 1]."""
        images = self.vae_decoder(latents)
        return torch.clamp(images / 2.0 + 0.5, 0.0, 1.0)

    # ------------------------------------------------------------------ full
    @torch.no_grad()
    def generate(self, cond_ids: torch.Tensor, uncond_ids: torch.Tensor,
                 generator: torch.Generator, *,
                 num_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None,
                 ivs: Optional[Interventions] = None,
                 decode: bool = True) -> torch.Tensor:
        """Token ids (B, S) -> images (B, 3, 8s, 8s) in [0, 1] (or the final
        latents with decode=False). The initial noise comes from `generator`."""
        cfg = self.config
        num_steps = num_steps or cfg.num_inference_steps
        g = cfg.guidance_scale if guidance_scale is None else guidance_scale
        cond = self.encode_text(cond_ids)
        context = cond if g <= 1.0 else torch.cat(
            [self.encode_text(uncond_ids), cond])
        s = cfg.sample_size
        shape = (cond_ids.shape[0], cfg.unet.sample_channels, s, s)
        latents = torch.randn(shape, generator=generator,
                              device=generator.device).to(self.device)
        latents = latents * self.scheduler.init_noise_sigma
        latents = self.denoise(context, latents, num_steps, g, ivs)
        return self.decode(latents) if decode else latents
