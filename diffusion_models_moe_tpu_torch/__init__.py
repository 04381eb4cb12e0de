"""PyTorch port of diffusion_models_moe_tpu for one NVIDIA H100.

This package covers the moefied SD1.5, SD2.1 and SDXL text-to-image slice:
CLIP text encoders (SDXL's two towers and pooled projection), MoE-routed
UNet (SDXL's added conditioning), every scheduler of the JAX package (PNDM,
DDIM, Euler, DPM-Solver++ 2M, LCM with its guidance embedding) with
classifier-free guidance and v-prediction, VAE decoder; PixArt-alpha
(`PixArtPipeline`: the T5 v1.1 XXL encoder, the adaLN-single DiT whose
non-gated GELU FFs carry the taps and interventions); Safe Latent
Diffusion's safety guidance (`pipelines/sld.py`); the taps and
interventions on its FF layers; skill attribution (`analysis/`) and concept
erasure (`erasure/`); the MoEfication front end: diffusers snapshots and
baked checkpoints in and out (`weights/`), the CLIP tokenizer (`data/`),
expert clustering and routers (`moefication/`), HPO studies. Its hot path runs hand-written CUDA kernels
(`ops/csrc/`), built at first use on a CUDA tensor; on the CPU every kernel
takes its plain PyTorch version. It imports neither JAX nor the JAX package,
which stays the reference.
"""
from diffusion_models_moe_tpu_torch.config import (CLIPTextConfig,
                                                   PipelineConfig, UNetConfig,
                                                   VAEConfig, sd15_config,
                                                   sd21_config, sdxl_config,
                                                   sdxl_text_configs,
                                                   tiny_config)
from diffusion_models_moe_tpu_torch.moefication.moefy import \
    build_moe_interventions
from diffusion_models_moe_tpu_torch.pipelines.pixart import (
    PixArtPipeline, PixArtPipelineConfig, pixart_512_config,
    tiny_pixart_pipeline_config)
from diffusion_models_moe_tpu_torch.pipelines.sdxl import SDXLPipeline
from diffusion_models_moe_tpu_torch.pipelines.sld import (SAFETY_CONCEPT,
                                                          SLDConfig,
                                                          sld_generate)
from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import \
    StableDiffusionPipeline
from diffusion_models_moe_tpu_torch.taps import (GEGLU_REMOVAL_FILL,
                                                 LayerIntervention, TapSpec,
                                                 layer_name,
                                                 no_interventions,
                                                 patterns_from_labels,
                                                 routing_mask)

__all__ = [
    "CLIPTextConfig", "GEGLU_REMOVAL_FILL", "LayerIntervention",
    "PipelineConfig", "PixArtPipeline", "PixArtPipelineConfig",
    "SAFETY_CONCEPT", "SDXLPipeline", "SLDConfig",
    "StableDiffusionPipeline", "TapSpec", "UNetConfig", "VAEConfig",
    "build_moe_interventions", "layer_name", "no_interventions",
    "patterns_from_labels", "pixart_512_config", "routing_mask",
    "sd15_config", "sd21_config", "sdxl_config", "sdxl_text_configs",
    "sld_generate", "tiny_config", "tiny_pixart_pipeline_config",
]
