"""CLIP vision tower (ViT) and projection, with transformers' names
(PyTorch port): the quantitative judge behind CLIP score, CLIP-IQA, the
CLIP-feature FID and the NSFW checker.

Counterpart of `diffusion_models_moe_tpu/models/clip_vision.py`. Images are
the port's layout, (B, 3, H, W) in [0, 1]. The tower runs in f32; attention
is plain torch, non-causal, as the JAX tower's Flax attention is XLA: there
is no kernel here. The module's state dict is that of transformers'
`CLIPVisionModelWithProjection` (`vision_model.pre_layrnorm` spelled as
there) less its `position_ids` buffer.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from diffusion_models_moe_tpu_torch.config import resolve_device
from diffusion_models_moe_tpu_torch.models.clip_text import quick_gelu
from diffusion_models_moe_tpu_torch.models.layers import (f32_convs,
                                                          layer_norm_f32,
                                                          resize_bilinear)

# OpenAI CLIP preprocessing constants
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32


def tiny_vision_config() -> CLIPVisionConfig:
    return CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=32,
                            intermediate_size=64, num_layers=2, num_heads=4,
                            projection_dim=16)


class _Attention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        hd = c // self.heads

        def split(t):
            return t.view(b, s, self.heads, hd).transpose(1, 2)

        q = split(self.q_proj(x) / hd ** 0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        p = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1)
        out = (p.to(x.dtype) @ v).transpose(1, 2).reshape(b, s, c)
        return self.out_proj(out)


class _MLP(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = _Attention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(layer_norm_f32(self.layer_norm1, x).to(x.dtype))
        return x + self.mlp(layer_norm_f32(self.layer_norm2, x).to(x.dtype))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(n_pos, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.num_layers))


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size,
                                           eps=cfg.layer_norm_eps)


class CLIPVisionEncoder(nn.Module):
    """images (B, 3, H, W) in [0, 1] at `cfg.image_size` -> projected,
    L2-normalized embeddings (B, P) (`normalize=False`: not normalized).

    `feature_layer` (e.g. -2 for LLaVA's penultimate-layer patch features)
    instead returns the (B, 1+P, hidden) hidden states after running
    `num_layers + feature_layer + 1` blocks — transformers'
    `hidden_states[feature_layer]` indexing, where -1 is the full stack —
    with no post-layernorm and no projection; CLS stays at token 0.

    Built on `device` (the card unless the caller asks for another) with
    zero weights: load a state dict (`weights/port_vision.py`)."""

    def __init__(self, cfg: CLIPVisionConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.vision_model = _VisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim,
                                           bias=False)
        self.register_buffer("mean", torch.tensor(CLIP_IMAGE_MEAN).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(CLIP_IMAGE_STD).view(
            1, 3, 1, 1), persistent=False)
        self.to(dev, cfg.dtype).eval()

    @torch.no_grad()
    def forward(self, images: torch.Tensor, normalize: bool = True,
                feature_layer: int | None = None) -> torch.Tensor:
        cfg, vm = self.cfg, self.vision_model
        x = ((images.float() - self.mean.float()) / self.std.float()
             ).to(cfg.dtype)
        with f32_convs():
            patches = vm.embeddings.patch_embedding(x)       # (B, D, h, w)
        b = patches.shape[0]
        patches = patches.flatten(2).transpose(1, 2)
        cls = vm.embeddings.class_embedding.to(cfg.dtype).expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        x = x + vm.embeddings.position_embedding.weight[None].to(cfg.dtype)
        x = layer_norm_f32(vm.pre_layrnorm, x).to(cfg.dtype)
        n_blocks = cfg.num_layers
        if feature_layer is not None:
            # hidden_states[f]: index 0 is the embeddings, f > 0 the output
            # of block f - 1, so f blocks run for f >= 0
            n_blocks = (feature_layer if feature_layer >= 0
                        else cfg.num_layers + feature_layer + 1)
            if not 0 <= n_blocks <= cfg.num_layers:
                raise ValueError(f"feature_layer {feature_layer} out of range "
                                 f"for {cfg.num_layers} layers")
        for layer in vm.encoder.layers[:n_blocks]:
            x = layer(x)
        if feature_layer is not None:
            return x
        pooled = layer_norm_f32(vm.post_layernorm, x[:, 0])
        emb = pooled @ self.visual_projection.weight.float().T
        if normalize:
            emb = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return emb


def resize_for_clip(images: torch.Tensor, image_size: int = 224
                    ) -> torch.Tensor:
    """Bilinear resize (B, 3, H, W) -> CLIP's input size (antialiased where
    it shrinks, as JAX's resize)."""
    return resize_bilinear(images, image_size)
