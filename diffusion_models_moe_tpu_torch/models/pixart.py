"""PixArt-alpha's DiT with adaLN-single conditioning (PyTorch port, NCHW).

Counterpart of `diffusion_models_moe_tpu/models/pixart.py`, with the
parameter names of diffusers' `PixArtTransformer2DModel`:

  * the patch embedding `pos_embed.proj` (a stride-p conv, equal to the JAX
    module's dense layer over each (p, p, C) patch) plus the position table
    `pos_embed.pos_embed` (1, S, D): diffusers' fixed 2-D sincos table,
    which the port keeps in its state dict so that a table from elsewhere
    (the JAX package's parameter) can be loaded;
  * the sinusoidal timestep (256 wide, cos first) through
    `adaln_single.emb.timestep_embedder` gives temb, and
    `adaln_single.linear(silu(temb))` the six shift / scale / gate vectors
    every block adds to its own `scale_shift_table`;
  * the caption MLP `caption_projection.linear_1 -> tanh GELU -> linear_2`
    (T5's 4096 -> 1152);
  * N blocks: the modulated self-attention, gated; the un-modulated
    cross-attention over all the caption positions (pads included, as in
    the JAX module); the modulated non-gated tanh-GELU FF, gated, which is
    the layer the taps and interventions act on (`ff_index` = block);
  * the final modulation by `scale_shift_table + temb` (not the table
    alone), `proj_out` and the unpatchify to eps (B, C, H, W) in f32.

The LayerNorms have no affine parameters, eps 1e-6, and follow flax's op
order (E[x^2] - E[x]^2, `attn_absorb_fused.ln_apply`). Self-attention runs
kernel 2 and cross-attention kernel 3 where `attn_kernel_ok` admits them
(bf16 on the card: D = 72, 120 keys).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.models.attention import (
    Attention, GEGLUFeedForward, TapsOut)
from diffusion_models_moe_tpu_torch.models.layers import (TimestepEmbedding,
                                                          timestep_embedding)
from diffusion_models_moe_tpu_torch.ops.attn_absorb_fused import ln_apply
from diffusion_models_moe_tpu_torch.taps import LayerIntervention, TapSpec

TIMESTEP_DIM = 256


@dataclasses.dataclass(frozen=True)
class PixArtConfig:
    sample_channels: int = 4
    out_channels: int = 4
    patch_size: int = 2
    hidden_size: int = 1152
    num_layers: int = 28
    num_heads: int = 16
    cross_attention_dim: int = 1152   # projected text width (T5 features in)
    text_in_dim: int = 4096           # raw T5 feature width
    ff_mult: int = 4
    dtype: torch.dtype = torch.float32

    @property
    def n_ff_layers(self) -> int:
        return self.num_layers

    def ff_dims(self) -> list[int]:
        return [self.hidden_size] * self.num_layers


def tiny_pixart_config() -> PixArtConfig:
    return PixArtConfig(hidden_size=32, num_layers=3, num_heads=4,
                        cross_attention_dim=32, text_in_dim=48)


def sincos_pos_embed(dim: int, grid_h: int, grid_w: int,
                     base_size: int = 0) -> np.ndarray:
    """diffusers' `get_2d_sincos_pos_embed` (interpolation scale 1): (S, dim)
    f32, the height half first."""
    def one_dim(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gh = np.arange(grid_h, dtype=np.float64)
    gw = np.arange(grid_w, dtype=np.float64)
    if base_size:
        gh = gh / (grid_h / base_size)
        gw = gw / (grid_w / base_size)
    grid = np.meshgrid(gw, gh)  # w goes first (diffusers convention)
    emb_h = one_dim(dim // 2, np.stack(grid)[1])
    emb_w = one_dim(dim // 2, np.stack(grid)[0])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class UnitLayerNorm(nn.Module):
    """LayerNorm without affine parameters, f32 out: `ln_apply` with a unit
    scale and a zero bias (buffers, not in the state dict)."""

    def __init__(self, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.register_buffer("one", torch.ones(()), persistent=False)
        self.register_buffer("zero", torch.zeros(()), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ln_apply(x, self.one, self.zero, self.eps)


class PatchEmbed(nn.Module):
    """`proj`: the stride-p patch conv; `pos_embed`: the (1, S, D) position
    table, the sincos table of the grid at construction."""

    def __init__(self, cfg: PixArtConfig, grid: int):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(cfg.sample_channels, cfg.hidden_size, p, stride=p)
        # torch.tensor (a factory, unlike from_numpy) makes it on the device
        # the module is made on
        self.register_buffer("pos_embed", torch.tensor(sincos_pos_embed(
            cfg.hidden_size, grid, grid, base_size=grid))[None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x).flatten(2).transpose(1, 2)        # (B, S, D)
        return x + self.pos_embed.to(x.dtype)


class CombinedTimestepEmbedding(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.timestep_embedder = TimestepEmbedding(TIMESTEP_DIM, dim)


class AdaLayerNormSingle(nn.Module):
    """`emb.timestep_embedder` (temb) and `linear` (temb -> 6 D)."""

    def __init__(self, dim: int):
        super().__init__()
        self.emb = CombinedTimestepEmbedding(dim)
        self.linear = nn.Linear(dim, 6 * dim)


class CaptionProjection(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.gelu(self.linear_1(x), approximate="tanh"))


class PixArtBlock(nn.Module):
    """adaLN-single block: cond6 + scale_shift_table, the modulated and
    gated self-attention, the un-modulated cross-attention, the modulated
    and gated tanh-GELU FF."""

    def __init__(self, cfg: PixArtConfig, ff_index: int):
        super().__init__()
        d = cfg.hidden_size
        self.scale_shift_table = nn.Parameter(torch.zeros(6, d))
        self.norm1 = UnitLayerNorm(1e-6)
        self.attn1 = Attention(d, cfg.num_heads, qkv_bias=True)
        self.norm2 = UnitLayerNorm(1e-6)
        self.attn2 = Attention(d, cfg.num_heads,
                               context_dim=cfg.cross_attention_dim,
                               qkv_bias=True)
        self.ff = GEGLUFeedForward(d, cfg.ff_mult, "gelu-tanh", ff_index)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                cond6: torch.Tensor, *, step_idx: int = 0,
                tap: Optional[TapSpec] = None,
                iv: Optional[LayerIntervention] = None,
                taps_out: TapsOut = None,
                use_kernels: bool = True) -> torch.Tensor:
        dt = x.dtype
        mods = cond6 + self.scale_shift_table[None].to(dt)       # (B, 6, D)
        shift_sa, scale_sa, gate_sa, shift_ff, scale_ff, gate_ff = mods.unbind(1)
        h = _modulate(self.norm1(x).to(dt), shift_sa, scale_sa)
        x = x + gate_sa[:, None, :] * self.attn1(h, use_kernels=use_kernels)
        x = x + self.attn2(x, context, use_kernels=use_kernels)
        h = _modulate(self.norm2(x).to(dt), shift_ff, scale_ff)
        h = self.ff(h, step_idx=step_idx, tap=tap, iv=iv, taps_out=taps_out,
                    use_kernels=use_kernels)
        return x + gate_ff[:, None, :] * h


class PixArtTransformer2D(nn.Module):
    """latents (B, C, s, s), timestep, T5 features (B, L, text_in_dim) ->
    eps (B, C, s, s) f32. `sample_size` s sets the position table's grid."""

    def __init__(self, cfg: PixArtConfig, sample_size: int = 64):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.hidden_size, cfg.patch_size
        self.pos_embed = PatchEmbed(cfg, sample_size // p)
        self.adaln_single = AdaLayerNormSingle(d)
        self.caption_projection = (
            CaptionProjection(cfg.text_in_dim, cfg.cross_attention_dim)
            if cfg.text_in_dim != cfg.cross_attention_dim else None)
        self.transformer_blocks = nn.ModuleList([
            PixArtBlock(cfg, i) for i in range(cfg.num_layers)])
        self.scale_shift_table = nn.Parameter(torch.zeros(2, d))
        self.norm_out = UnitLayerNorm(1e-6)
        self.proj_out = nn.Linear(d, p * p * cfg.out_channels)

    def forward(self, sample: torch.Tensor, timestep,
                encoder_hidden_states: torch.Tensor, *, step_idx: int = 0,
                tap: Optional[TapSpec] = None,
                ivs: Optional[Sequence[Optional[LayerIntervention]]] = None,
                taps_out: TapsOut = None,
                use_kernels: bool = True) -> torch.Tensor:
        cfg = self.cfg
        dt = self.proj_out.weight.dtype
        b, _, hgt, wid = sample.shape
        p = cfg.patch_size
        gh, gw = hgt // p, wid // p
        x = self.pos_embed(sample.to(dt))
        t = torch.as_tensor(timestep, dtype=torch.float32,
                            device=sample.device).reshape(-1).expand(b)
        temb = self.adaln_single.emb.timestep_embedder(
            timestep_embedding(t, TIMESTEP_DIM).to(dt))
        cond6 = self.adaln_single.linear(F.silu(temb)).reshape(b, 6, -1)
        context = encoder_hidden_states.to(dt)
        if context.shape[-1] != cfg.cross_attention_dim:
            context = self.caption_projection(context)
        for i, block in enumerate(self.transformer_blocks):
            iv = ivs[i] if ivs is not None and i < len(ivs) else None
            x = block(x, context, cond6, step_idx=step_idx, tap=tap, iv=iv,
                      taps_out=taps_out, use_kernels=use_kernels)
        table = self.scale_shift_table.to(dt)
        shift, scale = table[None, 0] + temb, table[None, 1] + temb
        x = _modulate(self.norm_out(x).to(dt), shift, scale)
        x = self.proj_out(x)                         # (B, S, p * p * C)
        x = x.reshape(b, gh, gw, p, p, cfg.out_channels)
        x = x.permute(0, 5, 1, 3, 2, 4).reshape(b, cfg.out_channels, hgt, wid)
        return x.float()
