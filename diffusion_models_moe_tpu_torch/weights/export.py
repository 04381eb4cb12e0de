"""Write state dicts as safetensors files (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/weights/export.py:save_safetensors`:
how a baked (erased or pruned) UNet leaves the port for the diffusers
ecosystem. The port's state dicts are already in diffusers layout, so the
JAX package's Flax-to-diffusers exporters have no counterpart here.
"""
from __future__ import annotations

import torch

from diffusion_models_moe_tpu_torch.weights import _safetensors


def save_safetensors(sd: dict[str, torch.Tensor], path: str) -> None:
    """Writes a flat state dict of tensors (any device, in their dtypes) to
    `path`, making its directory."""
    _safetensors.write(sd, path)
