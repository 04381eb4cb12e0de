"""SD VAE (PyTorch port, NCHW shapes), with diffusers AutoencoderKL names.

Counterpart of `diffusion_models_moe_tpu/models/vae.py`: the decoder of the
pipeline, and the encoder and `sample_latents` of the training path. The
encoder's convs are plain `nn.Conv2d`s (the serving modes are the decoder's),
its downsamplers pad the bottom and right edge by one and convolve with
stride 2, as diffusers' and the JAX module's do.
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
# group_norm_f32 is not called here; bench_h100/tests/test_bench_faults.py
# drops every GroupNorm's affine by patching that name in each model module
from diffusion_models_moe_tpu_torch.models.layers import (  # noqa: F401
    Downsample2D, ResnetBlock2D, Upsample2D, group_norm, group_norm_f32,
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
        y = group_norm(self.group_norm, x, silu=False)
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
        if self.decoder.mid_block.resnets[0].channels_last:
            # every conv weight once: a conv with a channels-last weight
            # writes channels-last, from post_quant_conv on
            self.to(memory_format=torch.channels_last)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        dt = self.post_quant_conv.weight.dtype
        dec = self.decoder
        z = self.post_quant_conv((latents / self.cfg.scaling_factor).to(dt))
        h = dec.mid_block(dec.conv_in(z))
        for blk in dec.up_blocks:
            h = blk(h)
        h = group_norm(dec.conv_norm_out, h, silu=True)
        return dec.conv_out(h).to(torch.float32,
                                  memory_format=torch.contiguous_format)


class _DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n_res: int, groups: int,
                 downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if j == 0 else cout, cout, groups, 1e-6)
            for j in range(n_res)])
        self.downsamplers = nn.ModuleList(
            [Downsample2D(cout, padding=0)] if downsample else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for res in self.resnets:
            x = res(x)
        for down in self.downsamplers:
            # pad ((0, 1), (0, 1)), then the stride-2 conv without padding
            x = down(F.pad(x, (0, 1, 0, 1)))
        return x


class _Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g = list(cfg.block_out_channels), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, 1, 1)
        self.down_blocks = nn.ModuleList([
            _DownBlock(ch[max(i - 1, 0)], c, cfg.layers_per_block, g,
                       i < len(ch) - 1)
            for i, c in enumerate(ch)])
        self.mid_block = VAEMidBlock(ch[-1], g, {})
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, 1, 1)


class VAEEncoder(nn.Module):
    """Images (B, 3, H, W) in [-1, 1] -> (mean, logvar), each (B, 4, H/8,
    W/8) in f32: the training path's `vae.encode`."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = _Encoder(cfg)
        wide = 2 * cfg.latent_channels
        self.quant_conv = nn.Conv2d(wide, wide, 1)
        self.to(memory_format=torch.channels_last)     # as the decoder's

    def forward(self, images: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        enc = self.encoder
        dt = enc.conv_in.weight.dtype
        h = enc.conv_in(images.to(dt))
        for blk in enc.down_blocks:
            h = blk(h)
        h = enc.mid_block(h)
        h = group_norm(enc.conv_norm_out, h, silu=True)
        h = self.quant_conv(enc.conv_out(h)).to(
            torch.float32, memory_format=torch.contiguous_format)
        mean, logvar = h.chunk(2, dim=1)
        return mean, logvar


def sample_latents(mean: torch.Tensor, logvar: torch.Tensor,
                   noise: torch.Tensor, scaling_factor: float) -> torch.Tensor:
    """The reparameterised sample, scaled for the diffusion model:
    (mean + exp(logvar / 2) * noise) * scaling_factor. `noise` (mean's
    shape) is the caller's draw, e.g. from a `torch.Generator`."""
    std = torch.exp(0.5 * logvar)
    return (mean + std * noise.to(mean)) * scaling_factor
