"""Read transformers CLIP checkpoints into the port's CLIP vision tower and
joint-space projections (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/weights/port_vision.py`. The port's
`CLIPVisionEncoder` carries transformers' names, so the JAX package's
transposes become key mappings: the tower's keys under `vision_model.` (a
`CLIPVisionModelWithProjection`) or `clip.vision_model.` (a wrapped
`CLIPModel`), `pre_layernorm` spelled `pre_layrnorm` as transformers does,
and the top-level `visual_projection.weight`; the `position_ids` buffer is
dropped. Files are read by the port's own safetensors reader.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from diffusion_models_moe_tpu_torch.config import CLIPTextConfig
from diffusion_models_moe_tpu_torch.models.clip_vision import CLIPVisionConfig
from diffusion_models_moe_tpu_torch.weights import _safetensors

StateDict = dict[str, torch.Tensor]


def clip_vision_state_dict(sd: StateDict, cfg: CLIPVisionConfig) -> StateDict:
    """A CLIP checkpoint's tensors -> `CLIPVisionEncoder(cfg)`'s state dict
    (f16 widened to f32)."""
    pre = "vision_model."
    if not any(k.startswith(pre) for k in sd) and any(
            k.startswith("clip.vision_model.") for k in sd):
        pre = "clip.vision_model."
    out = {}
    for k, v in sd.items():
        if not k.startswith(pre) or k.endswith("position_ids"):
            continue
        name = k[len(pre):].replace("pre_layernorm.", "pre_layrnorm.")
        if name.startswith("encoder.layers."):
            if int(name.split(".")[2]) >= cfg.num_layers:
                continue
        out["vision_model." + name] = v
    out["visual_projection.weight"] = sd["visual_projection.weight"]
    return {k: v.float() if v.dtype == torch.float16 else v
            for k, v in out.items()}


def port_clip_vision(snapshot_dir: str, cfg: CLIPVisionConfig) -> StateDict:
    """`model.safetensors` of a CLIPVisionModelWithProjection (or a full
    CLIPModel) snapshot -> `CLIPVisionEncoder(cfg)`'s state dict."""
    return clip_vision_state_dict(
        _safetensors.read(os.path.join(snapshot_dir, "model.safetensors")), cfg)


def clip_b32_text_config() -> CLIPTextConfig:
    """Text-tower geometry of openai/clip-vit-base-patch32 (the reference's
    metric CLIP): 512 wide, 8 heads."""
    return CLIPTextConfig(hidden_size=512, intermediate_size=2048,
                          num_heads=8)


def port_clip_text_projection(snapshot_dir: str) -> Optional[torch.Tensor]:
    """The text_projection of a full CLIPModel snapshot as (hidden, joint),
    ready for `pooled_text_embedding`, or None when the snapshot has only a
    vision tower."""
    sd = _safetensors.read(os.path.join(snapshot_dir, "model.safetensors"))
    for key in ("text_projection.weight", "clip.text_projection.weight"):
        if key in sd:
            return sd[key].float().T.contiguous()
    return None
