"""Basic UNet/VAE building blocks (PyTorch port, NCHW).

Counterpart of `diffusion_models_moe_tpu/models/layers.py`. Convolutions and
GroupNorm stay in torch (cuDNN), as the JAX package leaves them to XLA.
Norms run in f32 on f32 parameters and their output is cast to the compute
dtype, as the JAX modules do with `norm_dtype=float32`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def cast_model(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Casts weights to the compute dtype and keeps norm parameters in f32
    (the JAX package keeps every parameter in f32 and casts weights at use,
    norm parameters not at all)."""
    module.to(dtype)
    for m in module.modules():
        if isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.float()
    return module


def group_norm_f32(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm computed in f32; returns f32."""
    return F.group_norm(x.float(), norm.num_groups, norm.weight, norm.bias,
                        norm.eps)


def layer_norm_f32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in f32; returns f32."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers `get_timestep_embedding`), f32."""
    timesteps = torch.atleast_1d(timesteps).float()
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Linear -> SiLU -> Linear on the sinusoidal embedding."""

    def __init__(self, in_dim: int, emb_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, emb_dim)
        self.linear_2 = nn.Linear(emb_dim, emb_dim)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> Conv -> (+time) -> GN -> SiLU -> Conv, with skip."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm_num_groups: int = 32, eps: float = 1e-5,
                 temb_channels: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.GroupNorm(norm_num_groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, 1, 1)
        self.time_emb_proj = (None if temb_channels is None
                              else nn.Linear(temb_channels, out_channels))
        self.norm2 = nn.GroupNorm(norm_num_groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, 1, 1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.conv1.weight.dtype
        h = self.conv1(F.silu(group_norm_f32(self.norm1, x)).to(dt))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        h = self.conv2(F.silu(group_norm_f32(self.norm2, h)).to(dt))
        return h + residual


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
