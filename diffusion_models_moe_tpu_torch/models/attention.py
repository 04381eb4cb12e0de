"""Transformer blocks with MoE-routed GEGLU feed-forwards (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/models/attention.py` on its serving
path: self-attention goes through the flash kernel (`ops/sd_flash.py`),
cross-attention through the one-pass text-token kernel, and the whole
`x + ff(norm3(x))` sub-block through the fused GEGLU-MoE kernel
(`ops/geglu_ff_fused.py`) with norm3 and the residual absorbed, as the JAX
package runs it with DMOE_FF_FUSED=1. Parameter names follow diffusers
(`attn1.to_q`, `attn1.to_out.0`, `ff.net.0.proj`, `ff.net.2`, `norm3`, ...).

`use_kernels=False` runs the plain versions of the kernels on CUDA tensors;
it exists only for kernel-vs-plain comparisons.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from diffusion_models_moe_tpu_torch.models.layers import (group_norm_f32,
                                                          layer_norm_f32)
from diffusion_models_moe_tpu_torch.ops.geglu_ff_fused import geglu_ff_fused
from diffusion_models_moe_tpu_torch.ops.sd_flash import (sd_cross_attention,
                                                         sd_self_attention)
from diffusion_models_moe_tpu_torch.taps import LayerIntervention


class Attention(nn.Module):
    """Multi-head self- or cross-attention on (B, S, C) tokens."""

    def __init__(self, query_dim: int, heads: int = 8,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        kv_dim = context_dim or query_dim
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(kv_dim, query_dim, bias=False)
        self.to_v = nn.Linear(kv_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                use_kernels: bool = True) -> torch.Tensor:
        is_self = context is None
        ctx = x if is_self else context
        b, s, c = x.shape
        d = c // self.heads

        def heads4(t):          # (B, S, C) -> (B, S, H, D) view, no copy
            return t.view(t.shape[0], t.shape[1], self.heads, d)

        q, k, v = heads4(self.to_q(x)), heads4(self.to_k(ctx)), heads4(self.to_v(ctx))
        scale = 1.0 / d ** 0.5
        if is_self:
            out = sd_self_attention(q, k, v, scale, use_kernels=use_kernels)
        else:
            out = sd_cross_attention(q, k, v, scale, ctx.shape[1],
                                     use_kernels=use_kernels)
        return self.to_out[0](out.reshape(b, s, c))


class GEGLU(nn.Module):
    """The GEGLU input projection: `proj` emits (hidden, gate), 2H wide."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * hidden_dim)


class GEGLUFeedForward(nn.Module):
    """GEGLU FF with optional top-k expert routing, run as one fused op.

    `net.0.proj` is W1 (2H, C), `net.1` the (inference-time identity)
    dropout, `net.2` W2 (C, H). `forward(x, ln=...)` returns
    `x + ff(layernorm(x))` with the LayerNorm and residual absorbed."""

    def __init__(self, dim: int, mult: int = 4, activation: str = "geglu"):
        super().__init__()
        if activation not in ("geglu", "geglu-relu"):
            raise NotImplementedError(
                f"ff activation {activation!r} is not ported (geglu, geglu-relu)")
        self.relu = activation == "geglu-relu"
        hidden = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, hidden), nn.Identity(),
                                  nn.Linear(hidden, dim)])

    def forward(self, x: torch.Tensor, *, step_idx: int = 0,
                iv: Optional[LayerIntervention] = None,
                ln: Optional[nn.LayerNorm] = None,
                use_kernels: bool = True) -> torch.Tensor:
        patterns, k = None, 0
        if iv is not None and iv.patterns is not None:
            patterns, k = iv.patterns, iv.k
            if iv.expert_remove is not None:
                rm = iv.expert_remove[step_idx].to(patterns.dtype)     # (E,)
                patterns = patterns * (1.0 - rm)[:, None]
        shape = x.shape
        proj, out = self.net[0].proj, self.net[2]
        y = geglu_ff_fused(
            x.reshape(-1, shape[-1]), proj.weight, proj.bias, out.weight,
            out.bias, patterns, k, relu=self.relu,
            ln_scale=None if ln is None else ln.weight,
            ln_bias=None if ln is None else ln.bias,
            eps=1e-5 if ln is None else ln.eps, use_kernels=use_kernels)
        return y.reshape(shape)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn, LN -> cross-attn, LN -> GEGLU FF, residual each.
    LayerNorm eps is 1e-5, torch's default that diffusers inherits."""

    def __init__(self, dim: int, heads: int, context_dim: int,
                 ff_mult: int = 4, ff_activation: str = "geglu"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, context_dim=context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim, ff_mult, ff_activation)

    def forward(self, x: torch.Tensor, context: torch.Tensor, *,
                step_idx: int = 0, iv: Optional[LayerIntervention] = None,
                use_kernels: bool = True) -> torch.Tensor:
        dt = x.dtype
        x = x + self.attn1(layer_norm_f32(self.norm1, x).to(dt),
                           use_kernels=use_kernels)
        x = x + self.attn2(layer_norm_f32(self.norm2, x).to(dt), context,
                           use_kernels=use_kernels)
        # norm3 and the residual are absorbed into the fused FF
        return self.ff(x, step_idx=step_idx, iv=iv, ln=self.norm3,
                       use_kernels=use_kernels)


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> proj_in -> depth x blocks -> proj_out +
    residual, on NCHW features. Block d owns FF layer `ff_index + d`."""

    def __init__(self, dim: int, heads: int, context_dim: int, depth: int = 1,
                 norm_num_groups: int = 32, ff_mult: int = 4,
                 ff_activation: str = "geglu"):
        super().__init__()
        self.norm = nn.GroupNorm(norm_num_groups, dim, eps=1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(dim, heads, context_dim, ff_mult, ff_activation)
            for _ in range(depth)])
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor, *,
                step_idx: int = 0,
                ivs: Sequence[Optional[LayerIntervention]] = (),
                use_kernels: bool = True) -> torch.Tensor:
        b, c, h, w = x.shape
        y = group_norm_f32(self.norm, x).to(x.dtype)
        y = self.proj_in(y.permute(0, 2, 3, 1).reshape(b, h * w, c))
        for d, block in enumerate(self.transformer_blocks):
            iv = ivs[d] if d < len(ivs) else None
            y = block(y, context, step_idx=step_idx, iv=iv,
                      use_kernels=use_kernels)
        y = self.proj_out(y)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2) + x
