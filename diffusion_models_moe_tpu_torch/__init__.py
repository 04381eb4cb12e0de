"""PyTorch port of diffusion_models_moe_tpu for one NVIDIA H100.

This package covers the moefied SD1.5 and SD2.1 text-to-image slice: CLIP
text encoder, MoE-routed UNet, every scheduler of the JAX package (PNDM,
DDIM, Euler, DPM-Solver++ 2M, LCM with its guidance embedding) with
classifier-free guidance and v-prediction, VAE decoder; the taps and
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
                                                   sd21_config, tiny_config)
from diffusion_models_moe_tpu_torch.moefication.moefy import \
    build_moe_interventions
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
    "PipelineConfig", "StableDiffusionPipeline", "TapSpec", "UNetConfig",
    "VAEConfig", "build_moe_interventions", "layer_name", "no_interventions",
    "patterns_from_labels", "routing_mask", "sd15_config", "sd21_config",
    "tiny_config",
]
