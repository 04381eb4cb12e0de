"""Basic UNet/VAE building blocks (PyTorch port, NCHW).

Counterpart of `diffusion_models_moe_tpu/models/layers.py`. Convolutions and
GroupNorm stay in torch (cuDNN), as the JAX package leaves them to XLA.
Norms run in f32 on f32 parameters and their output is cast to the compute
dtype, as the JAX modules do with `norm_dtype=float32`. With `conv_chain`
(the JAX package's DMOE_CONV_CHAIN) a resblock's two 3x3 convs run the fused
GN+SiLU -> conv -> bias -> residual kernel (`ops/conv_chain_fused.py`); such
a block keeps its activations and 3x3 weights in `torch.channels_last`
memory format (the same logical NCHW shapes and parameter names).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.ops.conv_chain_fused import (
    CL, chain_ok, conv3x3_chain, gn_scale_shift)


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
    """GN -> SiLU -> Conv -> (+time) -> GN -> SiLU -> Conv, with skip.

    With `conv_chain`, conv1 (GN fold of norm1, the time embedding as extra
    bias) and conv2 (GN fold of norm2, the shortcut as residual) each take
    the fused chain kernel where `chain_ok` admits the shape, and the
    ordinary sequence elsewhere."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm_num_groups: int = 32, eps: float = 1e-5,
                 temb_channels: Optional[int] = None,
                 conv_chain: bool = False):
        super().__init__()
        self.conv_chain = conv_chain
        self.norm1 = nn.GroupNorm(norm_num_groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, 1, 1)
        self.time_emb_proj = (None if temb_channels is None
                              else nn.Linear(temb_channels, out_channels))
        self.norm2 = nn.GroupNorm(norm_num_groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, 1, 1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)
        if conv_chain:
            # the chain kernel reads (Cout, 3, 3, Cin): the weights live in
            # that memory format, so no call rearranges them
            self.conv1.to(memory_format=CL)
            self.conv2.to(memory_format=CL)

    def chain_branches(self, h: int, w: int) -> tuple[bool, bool]:
        """Whether conv1 and conv2 take the chain kernel at an h x w input."""
        c1, c2 = self.conv1, self.conv2
        return (self.conv_chain and chain_ok(h, w, c1.in_channels, c1.out_channels),
                self.conv_chain and chain_ok(h, w, c2.in_channels, c2.out_channels))

    def _chain(self, norm: nn.GroupNorm, conv: nn.Conv2d, x: torch.Tensor,
               extra_bias=None, residual=None, use_kernels: bool = True):
        dt = conv.weight.dtype
        scale, shift = gn_scale_shift(x, norm.weight, norm.bias,
                                      norm.num_groups, norm.eps)
        bt = conv.bias.to(dt).expand(x.shape[0], -1)
        bt = bt.contiguous() if extra_bias is None else bt + extra_bias.to(dt)
        if residual is not None:
            residual = residual.to(dt).contiguous(memory_format=CL)
        return conv3x3_chain(x.to(dt), conv.weight, bt, scale, shift,
                             residual=residual, use_kernels=use_kernels)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                use_kernels: bool = True) -> torch.Tensor:
        dt = self.conv1.weight.dtype
        chain1, chain2 = self.chain_branches(x.shape[2], x.shape[3])
        if chain1 or chain2:
            # no copy when the producer kept the format
            x = x.contiguous(memory_format=CL)
        t = None
        if self.time_emb_proj is not None and temb is not None:
            t = self.time_emb_proj(F.silu(temb))
        if chain1:
            h = self._chain(self.norm1, self.conv1, x, extra_bias=t,
                            use_kernels=use_kernels)
        else:
            h = self.conv1(F.silu(group_norm_f32(self.norm1, x)).to(dt))
            if t is not None:
                h = h + t[:, :, None, None]
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        if chain2:
            return self._chain(self.norm2, self.conv2, h, residual=residual,
                               use_kernels=use_kernels)
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
