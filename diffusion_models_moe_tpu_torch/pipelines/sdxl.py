"""SDXL text-to-image pipeline (PyTorch port): two text towers and the
added conditioning.

Counterpart of `diffusion_models_moe_tpu/pipelines/sdxl.py`. The context is
the concatenation of the penultimate states of CLIP-L (768) and OpenCLIP
bigG (1280), 2048 wide; the added conditioning is bigG's final state at the
EOS position (`argmax` of its ids) through `text_projection_2`, and the six
time ids (h, w, 0, 0, h, w) of the output size. The step loop is
`StableDiffusionPipeline.denoise`, which hands the added conditioning to
every UNet call (full, shallow and tapped); taps, interventions and
DeepCache act on the SDXL UNet's 70 FF layers as on SD1.5's 16. Under LCM
there is no classifier-free guidance: the guidance scale enters through the
embedding, and each request's step noise comes from its own generator
(`step_seed`), as in `StableDiffusionPipeline.generate`. With `mesh=` the
batch splits over dp and the modules over tp (`parallel/mesh.py`), as in
`StableDiffusionPipeline.generate`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from diffusion_models_moe_tpu_torch.config import (PipelineConfig,
                                                   sdxl_text_configs)
from diffusion_models_moe_tpu_torch.models.clip_text import CLIPTextEncoder
from diffusion_models_moe_tpu_torch.models.layers import cast_model
from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
from diffusion_models_moe_tpu_torch.models.vae import VAEDecoder
from diffusion_models_moe_tpu_torch.parallel.mesh import gather_batch
from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import \
    StableDiffusionPipeline
from diffusion_models_moe_tpu_torch.profiling import span
from diffusion_models_moe_tpu_torch.taps import (Interventions, TapSpec,
                                                 gather_taps)

__all__ = ["SDXLPipeline", "sdxl_text_configs"]


class SDXLPipeline(StableDiffusionPipeline):
    """The SDXL UNet, the two text towers with bigG's pooled projection, the
    VAE decoder and the scheduler on one device: the card, unless the
    caller asks for another (`device="cpu"`). `text_configs`: (CLIP-L,
    bigG), by default `sdxl_text_configs` in the UNet's dtype."""

    def __init__(self, config: PipelineConfig, text_configs: Optional[tuple]
                 = None, device="cuda"):
        self.text_configs = (text_configs
                             or sdxl_text_configs(config.unet.dtype))
        super().__init__(config, device)

    def _build_modules(self) -> None:
        config = self.config
        tc1, tc2 = self.text_configs
        self.unet = cast_model(UNet2DCondition(config.unet),
                               config.unet.dtype).eval()
        self.text_encoder = cast_model(CLIPTextEncoder(tc1), tc1.dtype).eval()
        self.text_encoder_2 = cast_model(CLIPTextEncoder(tc2),
                                         tc2.dtype).eval()
        # transformers' CLIPTextModelWithProjection.text_projection
        self.text_projection_2 = nn.Linear(
            tc2.hidden_size, tc2.hidden_size, bias=False).to(tc2.dtype).eval()
        self.vae_decoder = cast_model(VAEDecoder(config.vae),
                                      config.vae.dtype).eval()

    def modules(self) -> dict[str, nn.Module]:
        return {"unet": self.unet, "text_encoder": self.text_encoder,
                "text_encoder_2": self.text_encoder_2,
                "text_projection_2": self.text_projection_2,
                "vae": self.vae_decoder}

    # ------------------------------------------------------------------ text
    @torch.no_grad()
    def encode_prompts(self, ids_1: torch.Tensor, ids_2: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """(context (B, S, 2048): both towers' penultimate states
        concatenated, pooled (B, 1280): bigG's final state at `argmax(ids_2)`
        through `text_projection_2`)."""
        ids_1, ids_2 = ids_1.to(self.device), ids_2.to(self.device)
        _, pen1 = self.text_encoder(ids_1, return_penultimate=True)
        final2, pen2 = self.text_encoder_2(ids_2, return_penultimate=True)
        context = torch.cat([pen1, pen2.to(pen1.dtype)], dim=-1)
        eot = ids_2.argmax(dim=-1)
        pooled = final2[torch.arange(ids_2.shape[0], device=self.device), eot]
        return context, self.text_projection_2(pooled)

    # ------------------------------------------------------------------ full
    @torch.no_grad()
    def generate(self, cond_ids: torch.Tensor, uncond_ids: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 num_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None,
                 size: Optional[tuple] = None,
                 tap: Optional[TapSpec] = None,
                 ivs: Optional[Interventions] = None,
                 decode: bool = True, seeds=None,
                 cond_ids_2: Optional[torch.Tensor] = None,
                 uncond_ids_2: Optional[torch.Tensor] = None, mesh=None):
        """Token ids (B, S) -> (images (B, 3, 8s, 8s) in [0, 1], or the final
        latents with decode=False; taps or None). Noise as in
        `StableDiffusionPipeline.generate` (`generator` or `seeds`).
        `cond_ids_2` / `uncond_ids_2` are the bigG tower's ids (its tokenizer
        pads with 0, `load_sdxl_tokenizers`); they default to the CLIP-L
        ids. `size` (h, w) in pixels sets the time ids, by default the
        config's sample size times 8. `mesh` as in
        `StableDiffusionPipeline.generate`."""
        with span("dmoe.pipe.generate", device=self.device):
            cfg = self.config
            num_steps = num_steps or cfg.num_inference_steps
            g = (cfg.guidance_scale if guidance_scale is None
                 else guidance_scale)
            part = self.mesh_part(mesh, cond_ids.shape[0])
            latents, generators = self.start_latents(
                cond_ids.shape[0], generator, seeds, num_steps, part)
            ids = [None if i is None else i[part]
                   for i in (cond_ids, uncond_ids, cond_ids_2, uncond_ids_2)]
            with span("dmoe.pipe.encode", device=self.device):
                context, added = self.conditioning(ids[0], ids[1], g, size,
                                                   *ids[2:])
            latents, taps = self.denoise(context, latents, num_steps, g, tap,
                                         ivs, generators=generators,
                                         added_cond=added)
            out = self.decode(latents) if decode else latents
            taps = gather_taps(taps, mesh, g > 1.0 and not self.is_lcm)
            return gather_batch(out, mesh), taps

    @torch.no_grad()
    def conditioning(self, cond_ids: torch.Tensor, uncond_ids: torch.Tensor,
                     guidance_scale: float, size: Optional[tuple] = None,
                     cond_ids_2: Optional[torch.Tensor] = None,
                     uncond_ids_2: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, dict]:
        """`generate`'s UNet conditioning: (context, the `denoise` keyword
        `added_cond`: pooled text and time ids). With classifier-free
        guidance (g > 1, not LCM) the unconditional half comes first."""
        cfg = self.config
        px = size or (cfg.sample_size * 8, cfg.sample_size * 8)
        cond_ids_2 = cond_ids if cond_ids_2 is None else cond_ids_2
        uncond_ids_2 = uncond_ids if uncond_ids_2 is None else uncond_ids_2
        context, pooled = self.encode_prompts(cond_ids, cond_ids_2)
        if guidance_scale > 1.0 and not self.is_lcm:
            ctx_u, pool_u = self.encode_prompts(uncond_ids, uncond_ids_2)
            context = torch.cat([ctx_u, context])
            pooled = torch.cat([pool_u, pooled])
        time_ids = torch.tensor([[px[0], px[1], 0, 0, px[0], px[1]]],
                                dtype=torch.float32, device=self.device
                                ).expand(context.shape[0], -1)
        return context, dict(added_text_embeds=pooled,
                             added_time_ids=time_ids)
