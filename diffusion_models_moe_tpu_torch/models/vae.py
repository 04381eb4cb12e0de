"""SD VAE decoder (PyTorch port, NCHW), with diffusers AutoencoderKL names.

Counterpart of the decoder half of `diffusion_models_moe_tpu/models/vae.py`.
The mid-block attention is one head at d = 512 over h*w tokens, in plain
torch ops (the JAX package leaves it to XLA), and is never quantised. Every
conv of the decoder, `post_quant_conv` included, is made by `make_conv` with
the config's `conv_winograd` and `quant_int8` modes.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.config import VAEConfig
from diffusion_models_moe_tpu_torch.models.layers import (ResnetBlock2D,
                                                          Upsample2D,
                                                          group_norm_f32,
                                                          make_conv)


def _modes(cfg: VAEConfig) -> dict:
    return dict(quant=cfg.quant_int8, winograd=cfg.conv_winograd,
                winograd_tile=cfg.winograd_tile)


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
    def __init__(self, channels: int, norm_num_groups: int, modes: dict):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, norm_num_groups, 1e-6, **modes),
            ResnetBlock2D(channels, channels, norm_num_groups, 1e-6, **modes)])
        self.attentions = nn.ModuleList([VAEAttention(channels, norm_num_groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n_res: int, groups: int,
                 upsample: bool, modes: dict):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if j == 0 else cout, cout, groups, 1e-6, **modes)
            for j in range(n_res)])
        self.upsamplers = nn.ModuleList(
            [Upsample2D(cout, **modes)] if upsample else [])

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
        g, modes = cfg.norm_num_groups, _modes(cfg)
        self.conv_in = make_conv(cfg.latent_channels, rev[0], **modes)
        self.mid_block = VAEMidBlock(rev[0], g, modes)
        self.up_blocks = nn.ModuleList([
            _UpBlock(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1, g,
                     i < len(rev) - 1, modes)
            for i, ch in enumerate(rev)])
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = make_conv(rev[-1], cfg.in_channels, **modes)


class VAEDecoder(nn.Module):
    """Scaled latents (B, 4, h, w) -> images (B, 3, 8h, 8w) in [-1, 1], f32."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.post_quant_conv = make_conv(cfg.latent_channels,
                                         cfg.latent_channels, 1, padding=0,
                                         quant=cfg.quant_int8)
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
