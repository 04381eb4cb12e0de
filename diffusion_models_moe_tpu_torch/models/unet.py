"""UNet2DCondition for SD1.x, SD2.x and SDXL (PyTorch port, NCHW), with
MoE-routed FFs.

Counterpart of `diffusion_models_moe_tpu/models/unet.py`, with LCM's
guidance embedding (`time_embedding.cond_proj`) and SDXL's added
conditioning: with `addition_embed_dim > 0` the module `add_embedding` maps
the pooled text embedding concatenated with the sinusoidal embeddings of the
six time ids (each `addition_time_embed_dim` wide) to the time embedding's
width, and its output is added to the time embedding. The config's serving modes
(`attn_absorb`, `conv_chain`, `conv_winograd`, `quant_int8`) are handed down
to the transformer blocks, the resblocks and the samplers; `conv_in` and
`conv_out` stay direct convs, as in the JAX module. `forward` also has the
DeepCache pair of the JAX module: the full forward can return the feature
entering the last up block, and the shallow forward splices a cached one and
runs only conv_in, down block 0, the last up block and conv_out. The GEGLU
FF layers are numbered in execution order, down (0-5), mid (6), up (7-15)
for SD1.x: `ivs[i]` acts on FF layer i, and its tap statistics are keyed i.
With `UNetConfig.remat`, a forward that takes a gradient and carries no tap
and no interventions runs each ResnetBlock2D and Transformer2D under
`torch.utils.checkpoint` (non-reentrant): their activations are recomputed in
the backward, the granularity of the JAX module's `nn.remat`.
Parameter names are diffusers'
(`down_blocks.0.attentions.1.transformer_blocks.0.ff.net.2.weight`, ...).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from diffusion_models_moe_tpu_torch.config import ADD_TIME_IDS, UNetConfig
from diffusion_models_moe_tpu_torch.models.attention import Transformer2D
# group_norm_f32 is not called here; bench_h100/tests/test_bench_faults.py
# drops every GroupNorm's affine by patching that name in each model module
from diffusion_models_moe_tpu_torch.models.layers import (  # noqa: F401
    Downsample2D, ResnetBlock2D, TimestepEmbedding, Upsample2D, group_norm,
    group_norm_f32, timestep_embedding)
from diffusion_models_moe_tpu_torch.profiling import annotate
from diffusion_models_moe_tpu_torch.taps import Interventions, TapSpec


class _Block(nn.Module):
    """Holder matching diffusers' down/mid/up block naming."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()
        self.downsamplers = nn.ModuleList()
        self.upsamplers = nn.ModuleList()


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        ch = list(cfg.block_out_channels)
        n = len(ch)
        tdim = ch[0] * 4
        groups = cfg.norm_num_groups
        n_ff = 0                 # FF layers built so far, in execution order

        def transformer(dim, block_idx):
            nonlocal n_ff
            depth = cfg.depth_for_block(block_idx)
            t = Transformer2D(dim, cfg.heads_for_block(block_idx),
                              cfg.cross_attention_dim, depth, groups,
                              cfg.ff_mult, cfg.ff_activation, ff_index=n_ff,
                              attn_absorb=cfg.attn_absorb,
                              quant=cfg.quant_int8)
            n_ff += depth
            return t

        wino = dict(winograd=cfg.conv_winograd,
                    winograd_tile=cfg.winograd_tile)

        def resnet(cin, cout):
            return ResnetBlock2D(cin, cout, groups, 1e-5, tdim,
                                 conv_chain=cfg.conv_chain,
                                 quant=cfg.quant_int8, **wino)

        self.conv_in = nn.Conv2d(cfg.sample_channels, ch[0], 3, 1, 1)
        self.time_embedding = TimestepEmbedding(ch[0], tdim,
                                                cfg.time_cond_proj_dim)
        self.add_embedding = (TimestepEmbedding(
            cfg.addition_embed_dim
            + ADD_TIME_IDS * cfg.addition_time_embed_dim, tdim)
            if cfg.addition_embed_dim > 0 else None)
        self.down_blocks = nn.ModuleList()
        skips = [ch[0]]
        cur = ch[0]
        for i, kind in enumerate(cfg.down_block_types):
            blk = _Block()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(resnet(cur, ch[i]))
                cur = ch[i]
                if kind == "cross":
                    blk.attentions.append(transformer(ch[i], i))
                skips.append(cur)
            if i < n - 1:
                blk.downsamplers.append(Downsample2D(cur, cfg.quant_int8))
                skips.append(cur)
            self.down_blocks.append(blk)
        self.mid_block = _Block()
        self.mid_block.resnets.append(resnet(cur, cur))
        self.mid_block.attentions.append(transformer(cur, n - 1))
        self.mid_block.resnets.append(resnet(cur, cur))
        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        for i, kind in enumerate(cfg.up_block_types):
            blk = _Block()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(resnet(cur + skips.pop(), rev[i]))
                cur = rev[i]
                if kind == "cross":
                    blk.attentions.append(transformer(cur, n - 1 - i))
            if i < n - 1:
                blk.upsamplers.append(Upsample2D(cur, cfg.quant_int8, **wino))
            self.up_blocks.append(blk)
        self.conv_norm_out = nn.GroupNorm(groups, ch[0], eps=1e-5)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, 1, 1)
        if self.mid_block.resnets[0].channels_last:
            # every conv weight once, so that no conv rearranges one per call
            self.to(memory_format=torch.channels_last)

    def forward(self, sample: torch.Tensor, timestep,
                encoder_hidden_states: torch.Tensor, *,
                ivs: Optional[Interventions] = None, step_idx: int = 0,
                tap: Optional[TapSpec] = None,
                taps_out: Optional[dict] = None,
                use_kernels: bool = True,
                deep_feature: Optional[torch.Tensor] = None,
                return_deep: bool = False,
                timestep_cond: Optional[torch.Tensor] = None,
                added_text_embeds: Optional[torch.Tensor] = None,
                added_time_ids: Optional[torch.Tensor] = None):
        """sample: (B, C, H, W) latents; timestep: scalar or (B,);
        encoder_hidden_states: (B, S, D_text); timestep_cond: (B,
        time_cond_proj_dim), LCM's guidance embedding, added through
        `time_embedding.cond_proj` before its first linear;
        added_text_embeds (B, addition_embed_dim) and added_time_ids (B, 6):
        SDXL's added conditioning, through `add_embedding` (ignored by a
        UNet without it, as in the JAX module). Returns the
        predicted noise (B, C, H, W) in f32. With `tap`, each FF layer
        writes its statistics into `taps_out` as {stat: {ff_index: tensor}}.

        DeepCache (Ma et al. 2023): the feature entering the last up block
        changes slowly between adjacent steps. `return_deep=True` runs the
        full forward and returns `(eps, deep)` with that feature;
        `deep_feature=deep` runs the shallow forward: conv_in and down block
        0 (the skips the last up block consumes), the spliced feature, the
        last up block and conv_out, every other block skipped. The two are
        exclusive. The executed FF layers keep their full-forward `ff_index`,
        so interventions address them as before."""
        with annotate("dmoe.unet"):
            cfg = self.cfg
            shallow = deep_feature is not None
            if shallow and return_deep:
                raise ValueError("deep_feature and return_deep are exclusive")
            if (shallow or return_deep) and len(cfg.up_block_types) < 2:
                raise ValueError("deep cache needs >= 2 up blocks")
            dt = self.conv_in.weight.dtype
            b = sample.shape[0]
            t = torch.as_tensor(timestep, device=sample.device).reshape(-1)
            temb = timestep_embedding(t.expand(b), cfg.block_out_channels[0],
                                      cfg.flip_sin_to_cos,
                                      cfg.freq_shift).to(dt)
            temb = self.time_embedding(temb, timestep_cond)
            if (self.add_embedding is not None
                    and added_text_embeds is not None):
                parts = [added_text_embeds.to(dt)]
                if (added_time_ids is not None
                        and cfg.addition_time_embed_dim > 0):
                    ids = torch.as_tensor(added_time_ids, device=sample.device)
                    emb = timestep_embedding(ids.reshape(-1),
                                             cfg.addition_time_embed_dim,
                                             cfg.flip_sin_to_cos,
                                             cfg.freq_shift)
                    parts.append(emb.reshape(ids.shape[0], -1).to(dt))
                temb = temb + self.add_embedding(torch.cat(parts, dim=-1))
            context = encoder_hidden_states.to(dt)
            remat = (cfg.remat and tap is None and ivs is None
                     and torch.is_grad_enabled())

            def run(block, *args, **kwargs):
                if remat:
                    return checkpoint(block, *args, use_reentrant=False,
                                      preserve_rng_state=False, **kwargs)
                return block(*args, **kwargs)

            ivs = tuple(ivs) if ivs is not None else ()
            kw = dict(step_idx=step_idx, tap=tap, taps_out=taps_out,
                      use_kernels=use_kernels)
            ff_index = 0

            def attend(attn, h, block_idx, run_it=True):
                # the numbering advances over skipped blocks too
                nonlocal ff_index
                depth = cfg.depth_for_block(block_idx)
                if run_it:
                    h = run(attn, h, context,
                            ivs=ivs[ff_index:ff_index + depth], **kw)
                ff_index += depth
                return h

            sample = sample.to(dt)
            if self.mid_block.resnets[0].channels_last:
                # the resblocks keep channels-last activations: start so, and
                # every conv, norm, cat and upsample between them keeps the
                # format
                sample = sample.contiguous(memory_format=torch.channels_last)
            h = self.conv_in(sample)
            stack = [h]
            for i, blk in enumerate(self.down_blocks):
                live = not shallow or i == 0
                for j, res in enumerate(blk.resnets):
                    if live:
                        h = run(res, h, temb, use_kernels)
                    if blk.attentions:
                        h = attend(blk.attentions[j], h, i, live)
                    if live:
                        stack.append(h)
                if blk.downsamplers and not shallow:
                    h = blk.downsamplers[0](h)
                    stack.append(h)
            n = len(cfg.block_out_channels)
            if not shallow:
                h = run(self.mid_block.resnets[0], h, temb, use_kernels)
            h = attend(self.mid_block.attentions[0], h, n - 1, not shallow)
            if not shallow:
                h = run(self.mid_block.resnets[1], h, temb, use_kernels)
            deep = None
            for i, blk in enumerate(self.up_blocks):
                last = i == len(self.up_blocks) - 1
                if last and return_deep:
                    deep = h         # the feature entering the last up block
                if last and shallow:
                    h = deep_feature.to(dt)
                live = not shallow or last
                for j, res in enumerate(blk.resnets):
                    if live:
                        h = run(res, torch.cat([h, stack.pop()], dim=1), temb,
                                use_kernels)
                    if blk.attentions:
                        h = attend(blk.attentions[j], h, n - 1 - i, live)
                if blk.upsamplers and not shallow:
                    h = blk.upsamplers[0](h, use_kernels)
            h = group_norm(self.conv_norm_out, h, silu=True,
                           use_kernels=use_kernels)
            eps = self.conv_out(h).to(torch.float32,
                                      memory_format=torch.contiguous_format)
            return (eps, deep) if return_deep else eps
