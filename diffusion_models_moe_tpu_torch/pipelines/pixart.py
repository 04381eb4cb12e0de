"""PixArt-alpha text-to-image pipeline (PyTorch port): T5 encode -> DiT
denoise -> VAE decode.

Counterpart of `diffusion_models_moe_tpu/pipelines/pixart.py`, PixArt being
the reference's GELU model variant: its taps are read off the DiT's
non-gated FFs (mean-gate predictivity) and its removal uses the GELU fill
0.0. T5 encodes the caption and the negative caption with their attention
masks; DPM-Solver++ 2M (the default, 20 steps) or DDIM denoises with
classifier-free guidance 4.5 (the context ordered [uncond, cond]; off where
the guidance is <= 1), through the scheduler's `scale_model_input`; the SD
VAE decodes, images clipped to [0, 1]. Latents are NCHW, as in the port's SD
pipelines; the JAX pipeline's one `lax.scan` is an eager loop here.

With a `TapSpec`, `denoise` returns every step's statistics stacked to
(T, ...) by the step index as {stat: {ff_index: tensor}} (and, with
`save_eps`, the CFG-combined eps under {"eps": {0: ...}}); interventions
are indexed by the step. With `mesh=` (`parallel/mesh.py`) every rank
makes the call with the same arguments: the batch splits over dp (the
images and taps gathered) and the DiT and T5 over tp (heads, T5's gated hidden
and the FFs' output projections; the DiT's q/k/v biases kept whole), as in
`StableDiffusionPipeline.generate`.

`denoise(use_kernels=False)` runs the plain versions of the attention
kernels on CUDA tensors; it exists only for kernel-vs-plain comparisons.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from diffusion_models_moe_tpu_torch.config import VAEConfig, resolve_device
from diffusion_models_moe_tpu_torch.models.layers import cast_model
from diffusion_models_moe_tpu_torch.models.pixart import (PixArtConfig,
                                                          PixArtTransformer2D,
                                                          tiny_pixart_config)
from diffusion_models_moe_tpu_torch.models.t5 import (T5Config, T5Encoder,
                                                      T5LayerNorm,
                                                      tiny_t5_config)
from diffusion_models_moe_tpu_torch.models.vae import VAEDecoder
from diffusion_models_moe_tpu_torch.parallel.mesh import (batch_slice,
                                                          gather_batch,
                                                          shard_pipeline)
from diffusion_models_moe_tpu_torch.schedulers.ddim import DDIMScheduler
from diffusion_models_moe_tpu_torch.schedulers.dpm import DPMSolverScheduler
from diffusion_models_moe_tpu_torch.taps import (Interventions, TapSpec,
                                                 gather_taps)

SCHEDULERS = {"dpm": DPMSolverScheduler, "ddim": DDIMScheduler}


@dataclasses.dataclass(frozen=True)
class PixArtPipelineConfig:
    transformer: PixArtConfig = PixArtConfig()
    text_encoder: T5Config = T5Config()
    vae: VAEConfig = VAEConfig()
    sample_size: int = 64                # latents; 64 -> 512 px (PixArt-XL-2-512)
    guidance_scale: float = 4.5
    num_inference_steps: int = 20
    scheduler: str = "dpm"               # "dpm" | "ddim"


def pixart_512_config(dtype: torch.dtype = torch.bfloat16
                      ) -> PixArtPipelineConfig:
    """PixArt-XL-2-512 geometry: DiT 1152 wide, 28 blocks of 16 heads of 72;
    T5 v1.1 XXL (4096 wide, 24 layers, 64 heads of 64, d_ff 10240, 120
    tokens); the SD VAE; 64 x 64 latents."""
    return PixArtPipelineConfig(
        transformer=PixArtConfig(dtype=dtype),
        text_encoder=T5Config(dtype=dtype),
        vae=VAEConfig(dtype=dtype))


def tiny_pixart_pipeline_config(dtype: torch.dtype = torch.float32
                                ) -> PixArtPipelineConfig:
    t5 = tiny_t5_config()
    dit = dataclasses.replace(tiny_pixart_config(), text_in_dim=t5.d_model,
                              dtype=dtype)
    return PixArtPipelineConfig(
        transformer=dit,
        text_encoder=dataclasses.replace(t5, dtype=dtype),
        vae=VAEConfig(block_out_channels=(32, 32, 64, 64), norm_num_groups=8,
                      layers_per_block=1, dtype=dtype),
        sample_size=8, num_inference_steps=2)


@torch.no_grad()
def init_module(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights in the JAX package's init scheme, drawn in state-dict
    order: lecun-normal weights (std 1/sqrt(fan_in)), zero biases, unit norm
    scales, N(0, 1) embeddings (T5's tokens and position buckets) and
    N(0, 0.02^2) adaLN tables."""
    for name, p in module.named_parameters():
        owner = module.get_submodule(name.rpartition(".")[0])
        if name.endswith("bias"):
            p.zero_()
            continue
        if isinstance(owner, (nn.GroupNorm, nn.LayerNorm, T5LayerNorm)):
            p.fill_(1.0)
            continue
        std = (1.0 if isinstance(owner, nn.Embedding)
               else 0.02 if name.endswith("scale_shift_table")
               else p[0].numel() ** -0.5)
        vals = torch.randn(p.shape, generator=generator,
                           device=generator.device)
        p.copy_(vals * std)


class PixArtPipeline:
    """The DiT, the T5 encoder, the VAE decoder and the scheduler on one
    device: the card, unless the caller asks for another (`device="cpu"`).
    The modules are made on that device."""

    def __init__(self, config: PixArtPipelineConfig, device="cuda"):
        if config.scheduler not in SCHEDULERS:
            raise ValueError(f"scheduler {config.scheduler!r}: one of "
                             f"{sorted(SCHEDULERS)}")
        self.config = config
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.transformer = cast_model(PixArtTransformer2D(
                config.transformer, config.sample_size),
                config.transformer.dtype).eval()
            self.text_encoder = cast_model(T5Encoder(config.text_encoder),
                                           config.text_encoder.dtype).eval()
            self.vae_decoder = cast_model(VAEDecoder(config.vae),
                                          config.vae.dtype).eval()
        self.scheduler = SCHEDULERS[config.scheduler].create()

    def modules(self) -> dict[str, nn.Module]:
        return {"transformer": self.transformer,
                "text_encoder": self.text_encoder, "vae": self.vae_decoder}

    def init_params(self, generator: torch.Generator) -> None:
        """Random weights from `generator` (`init_module`), module by
        module; the position table stays the sincos one."""
        for module in self.modules().values():
            init_module(module, generator)

    def load_state_dicts(self, state_dicts: dict[str, dict]) -> None:
        """Loads {"transformer", "text_encoder", "vae"} (diffusers /
        transformers names, from `weights/port_pixart.py` or
        `weights/bridge.py`), strictly."""
        for key, module in self.modules().items():
            module.load_state_dict(state_dicts[key], strict=True)

    @torch.no_grad()
    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """ids (B, L) and a 0/1 mask (B, L) or None -> T5 features (B, L,
        4096) in the encoder's dtype."""
        mask = None if attention_mask is None else attention_mask.to(
            self.device)
        return self.text_encoder(input_ids.to(self.device), mask)

    @torch.no_grad()
    def denoise(self, context: torch.Tensor, latents: torch.Tensor,
                num_steps: int, guidance_scale: float,
                tap: Optional[TapSpec] = None,
                ivs: Optional[Interventions] = None,
                use_kernels: bool = True):
        """CFG denoise. context: T5 features (2B, L, D) with the
        unconditional half first (B where guidance <= 1); latents (B, C, s,
        s), the initial noise already scaled by the scheduler's initial
        sigma. Returns (final latents (B, C, s, s) f32, taps with (T, ...)
        leaves or None)."""
        sched = self.scheduler
        timesteps, coeffs = sched.set_timesteps(num_steps)
        do_cfg = guidance_scale > 1.0
        collect = tap is not None and tap.any()
        state = sched.init_state()
        lat = latents.to(self.device, torch.float32)
        context = context.to(self.device)
        per_step: list[dict] = []
        for i, t in enumerate(timesteps.tolist()):
            lat_in = torch.cat([lat, lat]) if do_cfg else lat
            lat_in = sched.scale_model_input(coeffs, i, lat_in)
            step_taps: dict = {}
            eps = self.transformer(lat_in, t, context, step_idx=i,
                                   tap=tap if collect else None, ivs=ivs,
                                   taps_out=step_taps,
                                   use_kernels=use_kernels)
            if do_cfg:
                eps_u, eps_c = eps.chunk(2)
                eps = eps_u + guidance_scale * (eps_c - eps_u)
            if collect and tap.save_eps:
                step_taps["eps"] = {0: eps}
            per_step.append(step_taps)
            state, lat = sched.step(state, coeffs, eps, i, lat)
        if not collect:
            return lat, None
        return lat, {stat: {l: torch.stack([s[stat][l] for s in per_step])
                            for l in layers}
                     for stat, layers in per_step[0].items()}

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents -> images (B, 3, H, W) in [0, 1]."""
        images = self.vae_decoder(latents)
        return torch.clamp(images / 2.0 + 0.5, 0.0, 1.0)

    def initial_noise(self, batch: int, generator: torch.Generator
                      ) -> torch.Tensor:
        """N(0, 1) latents (B, C, s, s) drawn from `generator` on its own
        device."""
        s = self.config.sample_size
        return torch.randn((batch, self.config.transformer.sample_channels,
                            s, s), generator=generator,
                           device=generator.device)

    def seeded_noise(self, seeds) -> torch.Tensor:
        """Per-request N(0, 1) latents: request i's from a generator on the
        pipeline's device seeded with seeds[i] alone, so they do not depend
        on what shares its batch."""
        return torch.cat([self.initial_noise(
            1, torch.Generator(device=self.device).manual_seed(int(sd)))
            for sd in seeds])

    @torch.no_grad()
    def generate(self, cond_ids: torch.Tensor, uncond_ids: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 cond_mask: Optional[torch.Tensor] = None,
                 uncond_mask: Optional[torch.Tensor] = None,
                 num_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None,
                 tap: Optional[TapSpec] = None,
                 ivs: Optional[Interventions] = None,
                 decode: bool = True, seeds=None, mesh=None):
        """Token ids (B, L) with their 0/1 masks -> (images (B, 3, 8s, 8s) in
        [0, 1], or the final latents with decode=False; taps or None). The
        initial noise comes from `generator`, or with `seeds` (B ints) from
        each request's own seed, times the scheduler's initial sigma. With
        `mesh`, every rank makes the call with the same arguments; B must
        split over dp, and the taps are the whole batch's on every rank."""
        cfg = self.config
        num_steps = num_steps or cfg.num_inference_steps
        g = cfg.guidance_scale if guidance_scale is None else guidance_scale
        b = cond_ids.shape[0]
        if (generator is None) == (seeds is None):
            raise ValueError("generate takes a generator or seeds, not both")
        if seeds is not None and len(seeds) != b:
            raise ValueError(f"{len(seeds)} seeds for {b} requests")
        part = slice(0, b)
        if mesh is not None:
            shard_pipeline(self, mesh)
            part = batch_slice(mesh, b)
        # a generator draws the whole batch's noise, seeds only the part's
        latents = (self.seeded_noise(list(seeds)[part]) if seeds is not None
                   else self.initial_noise(b, generator)[part])
        latents = latents.to(self.device) * self.scheduler.init_noise_sigma

        def take(t):
            return None if t is None else t[part]
        context = self.encode_text(take(cond_ids), take(cond_mask))
        if g > 1.0:
            context = torch.cat([self.encode_text(take(uncond_ids),
                                                  take(uncond_mask)),
                                 context])
        latents, taps = self.denoise(context, latents, num_steps, g, tap, ivs)
        out = self.decode(latents) if decode else latents
        return gather_batch(out, mesh), gather_taps(taps, mesh, g > 1.0)
