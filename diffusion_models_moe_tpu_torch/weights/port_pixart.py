"""Read diffusers PixArt-alpha snapshots into the port's state dicts
(PyTorch port).

Counterpart of `diffusion_models_moe_tpu/weights/port_pixart.py`. The port's
modules carry the diffusers and transformers names, so a snapshot is read
and handed to `PixArtPipeline.load_state_dicts` with two changes:

  snapshot/
    transformer/diffusion_pytorch_model*.safetensors  (PixArtTransformer2DModel)
    text_encoder/model*.safetensors                   (T5EncoderModel, in shards)
    vae/diffusion_pytorch_model.safetensors           (the SD VAE)

  * the DiT's position table is a fixed sincos buffer that diffusers does
    not save: it is made here (`sincos_pos_embed` with base_size = the
    grid, as the JAX porter makes it) under the port's `pos_embed.pos_embed`;
  * T5's token embedding is `shared.weight`; an export that carries it as
    `encoder.embed_tokens.weight` alone is renamed, and the tied copy is
    dropped where both are present.

fp16 tensors are widened to f32. Files are read by the port's own
safetensors reader (`weights/_safetensors.py`).
"""
from __future__ import annotations

import os

import torch

from diffusion_models_moe_tpu_torch.models.pixart import (PixArtConfig,
                                                          sincos_pos_embed)
from diffusion_models_moe_tpu_torch.weights import _safetensors
from diffusion_models_moe_tpu_torch.weights.port import (
    StateDict, _widen, load_vae_decoder_state_dict)

__all__ = ["load_sharded", "port_pixart_pipeline", "port_pixart_transformer",
           "port_t5_encoder", "sincos_pos_embed"]

_TIED = "encoder.embed_tokens.weight"


def load_sharded(dirpath: str, filename_prefix: str) -> StateDict:
    """All tensors of `{prefix}*.safetensors` under `dirpath` (one file or
    its shards), fp16 widened."""
    files = sorted(f for f in os.listdir(dirpath)
                   if f.startswith(filename_prefix)
                   and f.endswith(".safetensors"))
    out: StateDict = {}
    for f in files:
        out.update(_safetensors.read(os.path.join(dirpath, f)))
    if not out:
        raise FileNotFoundError(
            f"no {filename_prefix}*.safetensors under {dirpath}")
    return _widen(out)


def port_t5_encoder(snapshot_dir: str) -> StateDict:
    """`{snapshot_dir}/text_encoder/model*.safetensors` -> the port's
    `T5Encoder` state dict."""
    sd = load_sharded(os.path.join(snapshot_dir, "text_encoder"), "model")
    tied = sd.pop(_TIED, None)
    if "shared.weight" not in sd:
        if tied is None:
            raise KeyError(f"{snapshot_dir}: the T5 token embedding "
                           f"(shared.weight or {_TIED}) is missing")
        sd["shared.weight"] = tied
    return sd


def port_pixart_transformer(snapshot_dir: str, cfg: PixArtConfig,
                            sample_size: int = 64) -> StateDict:
    """`{snapshot_dir}/transformer/` -> the port's `PixArtTransformer2D`
    state dict, the sincos position table of `sample_size` latents added."""
    sd = load_sharded(os.path.join(snapshot_dir, "transformer"),
                      "diffusion_pytorch_model")
    grid = sample_size // cfg.patch_size
    sd["pos_embed.pos_embed"] = torch.from_numpy(sincos_pos_embed(
        cfg.hidden_size, grid, grid, base_size=grid))[None]
    return sd


def port_pixart_pipeline(snapshot_root: str, config) -> dict[str, StateDict]:
    """A PixArt snapshot -> {"transformer", "text_encoder", "vae"}, as
    `PixArtPipeline.load_state_dicts` takes them."""
    return {
        "transformer": port_pixart_transformer(
            snapshot_root, config.transformer, config.sample_size),
        "text_encoder": port_t5_encoder(snapshot_root),
        "vae": load_vae_decoder_state_dict(os.path.join(snapshot_root, "vae")),
    }
