"""Write state dicts as safetensors files (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/weights/export.py:save_safetensors`:
how a baked (erased or pruned) UNet leaves the port for the diffusers
ecosystem. The port's state dicts are already in diffusers layout, so the
JAX package's Flax-to-diffusers exporters (`export_unet`, ...,
`export_vae_encoder`) reduce to `save_pipeline_snapshot`, which writes a
snapshot directory that `weights/port.py:load_pipeline_snapshot` reads back.
"""
from __future__ import annotations

import os

import torch

from diffusion_models_moe_tpu_torch.weights import _safetensors


def save_safetensors(sd: dict[str, torch.Tensor], path: str) -> None:
    """Writes a flat state dict of tensors (any device, in their dtypes) to
    `path`, making its directory."""
    _safetensors.write(sd, path)


def save_pipeline_snapshot(snapshot_root: str,
                           state_dicts: dict[str, dict]) -> None:
    """Writes {"unet", "text_encoder", "vae"} state dicts (and optionally
    "vae_encoder", whose tensors go into the same VAE file as the decoder's,
    as in diffusers' AutoencoderKL) as a diffusers snapshot under
    `snapshot_root`: `unet/` and `vae/` `diffusion_pytorch_model.safetensors`,
    `text_encoder/model.safetensors`."""
    vae = dict(state_dicts["vae"])
    vae.update(state_dicts.get("vae_encoder") or {})
    for sub, name, sd in (
            ("unet", "diffusion_pytorch_model", state_dicts["unet"]),
            ("text_encoder", "model", state_dicts["text_encoder"]),
            ("vae", "diffusion_pytorch_model", vae)):
        save_safetensors(sd, os.path.join(snapshot_root, sub,
                                          f"{name}.safetensors"))
