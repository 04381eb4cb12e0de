"""SD VAE decoder (PyTorch port, NCHW), with diffusers AutoencoderKL names.

Counterpart of the decoder half of `diffusion_models_moe_tpu/models/vae.py`.
The mid-block attention is one head at d = 512 over h*w tokens, in plain
torch ops (the JAX package leaves it to XLA).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.config import VAEConfig
from diffusion_models_moe_tpu_torch.models.layers import (ResnetBlock2D,
                                                          Upsample2D,
                                                          group_norm_f32)


class VAEAttention(nn.Module):
    def __init__(self, channels: int, norm_num_groups: int = 32):
        super().__init__()
        self.group_norm = nn.GroupNorm(norm_num_groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = group_norm_f32(self.group_norm, x).to(x.dtype)
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        s = (q.float() @ k.float().transpose(1, 2)) * c ** -0.5
        att = (torch.softmax(s, dim=-1) @ v.float()).to(x.dtype)
        y = self.to_out[0](att)
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, norm_num_groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, norm_num_groups, 1e-6),
            ResnetBlock2D(channels, channels, norm_num_groups, 1e-6)])
        self.attentions = nn.ModuleList([VAEAttention(channels, norm_num_groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n_res: int, groups: int,
                 upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if j == 0 else cout, cout, groups, 1e-6)
            for j in range(n_res)])
        self.upsamplers = nn.ModuleList([Upsample2D(cout)] if upsample else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for res in self.resnets:
            x = res(x)
        for up in self.upsamplers:
            x = up(x)
        return x


class _Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, 1, 1)
        self.mid_block = VAEMidBlock(rev[0], g)
        self.up_blocks = nn.ModuleList([
            _UpBlock(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1, g,
                     i < len(rev) - 1)
            for i, ch in enumerate(rev)])
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.in_channels, 3, 1, 1)


class VAEDecoder(nn.Module):
    """Scaled latents (B, 4, h, w) -> images (B, 3, 8h, 8w) in [-1, 1], f32."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                         cfg.latent_channels, 1)
        self.decoder = _Decoder(cfg)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        dt = self.post_quant_conv.weight.dtype
        dec = self.decoder
        z = self.post_quant_conv((latents / self.cfg.scaling_factor).to(dt))
        h = dec.mid_block(dec.conv_in(z))
        for blk in dec.up_blocks:
            h = blk(h)
        h = F.silu(group_norm_f32(dec.conv_norm_out, h)).to(dt)
        return dec.conv_out(h).float()
