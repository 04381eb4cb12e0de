"""PyTorch port of diffusion_models_moe_tpu for one NVIDIA H100.

This package covers the moefied SD1.5 text-to-image serving slice: CLIP text
encoder, MoE-routed UNet, PNDM with classifier-free guidance, VAE decoder.
Its hot path runs hand-written CUDA kernels (`ops/csrc/`), built at first
use on a CUDA tensor; on the CPU every kernel takes its plain PyTorch
version. It imports neither JAX nor the JAX package, which stays the
reference.
"""
from diffusion_models_moe_tpu_torch.config import (CLIPTextConfig,
                                                   PipelineConfig, UNetConfig,
                                                   VAEConfig, sd15_config,
                                                   tiny_config)
from diffusion_models_moe_tpu_torch.moefication.moefy import \
    build_moe_interventions
from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import \
    StableDiffusionPipeline
from diffusion_models_moe_tpu_torch.taps import (LayerIntervention,
                                                 layer_name,
                                                 patterns_from_labels,
                                                 routing_mask)

__all__ = [
    "CLIPTextConfig", "LayerIntervention", "PipelineConfig",
    "StableDiffusionPipeline", "UNetConfig", "VAEConfig",
    "build_moe_interventions", "layer_name", "patterns_from_labels",
    "routing_mask", "sd15_config", "tiny_config",
]
