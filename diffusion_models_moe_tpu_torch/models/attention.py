"""Transformer blocks with MoE-routed GEGLU feed-forwards (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/models/attention.py`:
self-attention goes through the flash kernel (`ops/sd_flash.py`),
cross-attention through the one-pass text-token kernel, and the whole
`x + ff(norm3(x))` sub-block through the fused GEGLU-MoE kernel
(`ops/geglu_ff_fused.py`) with norm3 and the residual absorbed, as the JAX
package runs it with DMOE_FF_FUSED=1. Each kernel is taken where its
predicate (`attn_kernel_ok`, `fused_ff_ok`, `route_kernel_ok`) admits the
call; elsewhere on the card (an f32 model, a head dim or an expert count
the kernels do not take) the layer runs the plain version, counted under
`plain:<kernel>` in `ops/_build.LAUNCHES`, as the JAX package falls back to
its library path. Where autograd records a call on the card, kernels 1, 4, 5
and 6 (forward only) give way to their plain versions, counted the same
way; kernels 2 and 3 carry gradients (`ops/sd_flash.py`). An FF call that collects taps or
carries a neuron mask, an output-weight mask or an expert boost takes the
unfused path of the JAX module instead, with its routing in the fused
routing kernel (`ops/routing_kernel.py`) where no expert tap or boost needs
the selection. With `attn_absorb` on (the JAX package's DMOE_ATTN_ABSORB),
`norm1` and the `attn1` residual are delegated to the absorbed-attention
kernels (`ops/attn_absorb_fused.py`) around the flash kernel. With `quant`
(`UNetConfig.quant_int8`) every projection of the block is a `QuantDense`
(the int8 W8A8 dot of `ops/quant.py`), the attention absorb is off and every
FF call takes the unfused path, its routing still in the routing kernel.
Parameter names follow diffusers (`attn1.to_q`, `attn1.to_out.0`, `ff.net.0.proj`,
`ff.net.2`, `norm3`, ...) and do not depend on the mode.

PixArt-alpha's blocks (`models/pixart.py`) take two more forms: `Attention`
with `qkv_bias` (diffusers' `attention_bias=True`) and the non-gated FF
(`activation="gelu"` or `"gelu-tanh"`, diffusers' `GELU` projection), which,
as in the JAX module, never takes the fused FF kernel and routes through the
plain `routing_mask` (both kernels are written for the gated FF).

Tap statistics go into the `taps_out` dict a caller passes down, as
`taps_out[stat][ff_index]`, the layout `denoise` stacks over steps.

Under tensor parallelism (`parallel/mesh.py:shard_module`) `Attention`
takes heads / tp heads a rank (its q/k/v column-parallel, `to_out`
row-parallel) and the FF's `net.2` is row-parallel over the hidden width
while `proj` stays replicated, as in the JAX package's rules. Kernel 1 spans
the whole hidden width in its output GEMM, so it cannot take a shard: an FF
call that would take it runs the unfused path instead (its routing in kernel
4 over the whole width, then the rank's columns against its W2 shard and
the reduce), counted under `tp:geglu_ff_fused`. The absorbed attention
(`BasicTransformerBlock.tp_shard`) and the int8 projections (`QuantDense`,
by `shard_module`) are refused under tp > 1.

`use_kernels=False` runs the plain versions of the kernels on CUDA tensors;
it exists only for kernel-vs-plain comparisons.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

# group_norm_f32 is not called here; bench_h100/tests/test_bench_faults.py
# drops every GroupNorm's affine by patching that name in each model module
from diffusion_models_moe_tpu_torch.models.layers import (  # noqa: F401
    HoistedWeight, group_norm, group_norm_f32, layer_norm_f32)
from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.ops.attn_absorb_fused import (
    absorbed_self_attention, attn_absorb_ok, ln_apply)
from diffusion_models_moe_tpu_torch.ops.geglu_ff_fused import (fused_ff_ok,
                                                               geglu_ff_fused)
from diffusion_models_moe_tpu_torch.ops.quant import (int8_dot,
                                                      quantize_dense_weight)
from diffusion_models_moe_tpu_torch.ops.routing_kernel import (
    fused_route_multiply, route_kernel_ok)
from diffusion_models_moe_tpu_torch.ops.sd_flash import (cross_attention,
                                                         self_attention)
from diffusion_models_moe_tpu_torch.parallel.mesh import (RowParallelLinear,
                                                          copy_to_tp, in_slice,
                                                          linear_out,
                                                          tp_group)
from diffusion_models_moe_tpu_torch.profiling import annotate
from diffusion_models_moe_tpu_torch.taps import (LayerIntervention, TapSpec,
                                                 routing_mask, step_row)

TapsOut = Optional[dict]     # {stat: {ff_index: tensor}}, filled in place


class QuantDense(HoistedWeight, nn.Linear):
    """`nn.Linear` (same parameters) through the int8 W8A8 dot of
    `ops/quant.py`; the weight's quantisation is hoisted."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.weight.dtype
        y = int8_dot(x.to(dt), wq=self.hoisted(quantize_dense_weight))
        return y if self.bias is None else y + self.bias.to(dt)


def make_dense(in_features: int, out_features: int, bias: bool = True,
               quant: bool = False) -> nn.Linear:
    """nn.Linear, or its int8 twin when `quant` (the same parameters)."""
    return (QuantDense if quant else nn.Linear)(in_features, out_features,
                                                bias=bias)


class Attention(nn.Module):
    """Multi-head self- or cross-attention on (B, S, C) tokens."""

    def __init__(self, query_dim: int, heads: int = 8,
                 context_dim: Optional[int] = None, quant: bool = False,
                 qkv_bias: bool = False):
        super().__init__()
        self.heads = heads
        kv_dim = context_dim or query_dim
        self.to_q = make_dense(query_dim, query_dim, qkv_bias, quant)
        self.to_k = make_dense(kv_dim, query_dim, qkv_bias, quant)
        self.to_v = make_dense(kv_dim, query_dim, qkv_bias, quant)
        self.to_out = nn.ModuleList([make_dense(query_dim, query_dim,
                                                quant=quant)])

    def tp_shard(self, tp: int, rank: int) -> None:
        """heads / tp heads a rank (`parallel/mesh.py:shard_module`)."""
        if self.heads % tp:
            raise ValueError(f"{self.heads} heads do not split over tp = {tp}")
        self.heads //= tp

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                use_kernels: bool = True, ln: Optional[nn.LayerNorm] = None,
                absorb: str = "1") -> torch.Tensor:
        """With `ln` (the block's delegated norm1) returns
        `x + to_out(attention(ln(x)))`: through the absorbed-attention
        kernels in mode `absorb` where `attn_absorb_ok` admits the shape
        (and, on the card, the model is bf16), else by applying the same
        LayerNorm here and adding the residual at the end."""
        is_self = context is None
        b, s, c = x.shape
        d = self.to_q.out_features // self.heads
        scale = 1.0 / d ** 0.5
        resid = None
        if ln is not None:
            # the absorbed kernels take bias-free q/k/v projections, as the
            # JAX module's absorb does
            if (is_self and self.to_q.bias is None
                    and attn_absorb_ok(s, c, self.heads)) and (
                    x.device.type == "cpu" or x.dtype == torch.bfloat16):
                out = self.to_out[0]
                wq, wk, wv = self.to_q.weight, self.to_k.weight, self.to_v.weight
                kernels = [name for mode, name in (
                    ("qkv", "ln_qkv_fused"), ("out", "attn_out_residual_fused"))
                    if absorb in ("1", mode)]
                plain = _build.plain_under_grad(
                    kernels, use_kernels, x, wq, wk, wv, out.weight, out.bias,
                    ln.weight, ln.bias)
                return absorbed_self_attention(
                    x, wq, wk, wv, out.weight, out.bias, self.heads, scale,
                    (ln.weight, ln.bias, ln.eps), mode=absorb,
                    use_kernels=use_kernels, absorb_kernels=not plain)
            resid = x
            x = ln_apply(x, ln.weight, ln.bias, ln.eps).to(x.dtype)
        ctx = x if is_self else context

        def heads4(t):          # (B, S, C) -> (B, S, H, D) view, no copy
            return t.view(t.shape[0], t.shape[1], self.heads, d)

        q, k, v = heads4(self.to_q(x)), heads4(self.to_k(ctx)), heads4(self.to_v(ctx))
        if is_self:
            out = self_attention(q, k, v, scale, use_kernels=use_kernels)
        else:
            out = cross_attention(q, k, v, scale, ctx.shape[1],
                                  use_kernels=use_kernels)
        out = self.to_out[0](out.reshape(b, s, -1))
        return out if resid is None else resid + out


class GEGLU(nn.Module):
    """The FF's input projection: `proj` emits (hidden, gate), 2H wide,
    where `gated`; else the gate alone, H wide (diffusers' `GELU`)."""

    def __init__(self, dim: int, hidden_dim: int, quant: bool = False,
                 gated: bool = True):
        super().__init__()
        self.proj = make_dense(dim, (2 if gated else 1) * hidden_dim,
                               quant=quant)


FF_ACTIVATIONS = ("geglu", "geglu-relu", "gelu", "gelu-tanh")


class GEGLUFeedForward(nn.Module):
    """GEGLU FF with optional top-k expert routing, taps and interventions.

    `net.0.proj` is W1 (2H, C), `net.1` the (inference-time identity)
    dropout, `net.2` W2 (C, H). `forward(x, ln=...)` returns
    `x + ff(layernorm(x))` with the LayerNorm and residual absorbed.
    `ff_index` is the layer's place in the canonical FF order. With `quant`
    both projections are int8 dots and no call takes the fused kernel.
    `activation`: "geglu" (exact GELU gate), "geglu-relu" (ReLU gate), or
    the non-gated "gelu" / "gelu-tanh" (PixArt's), whose `net.0.proj` is
    W1 (H, C) and whose activated projection is the gate itself; those take
    the unfused path with its routing by `routing_mask`, as in the JAX
    module."""

    def __init__(self, dim: int, mult: int = 4, activation: str = "geglu",
                 ff_index: int = 0, quant: bool = False):
        super().__init__()
        if activation not in FF_ACTIVATIONS:
            raise NotImplementedError(
                f"ff activation {activation!r} is not ported {FF_ACTIVATIONS}")
        self.activation = activation
        self.gated = activation.startswith("geglu")
        self.relu = activation == "geglu-relu"
        self.ff_index = ff_index
        self.quant = quant
        hidden = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, hidden, quant, self.gated),
                                  nn.Identity(),
                                  make_dense(hidden, dim, quant=quant)])

    def forward(self, x: torch.Tensor, *, step_idx: int = 0,
                tap: Optional[TapSpec] = None,
                iv: Optional[LayerIntervention] = None,
                ln: Optional[nn.LayerNorm] = None, taps_out: TapsOut = None,
                use_kernels: bool = True) -> torch.Tensor:
        collecting = tap is not None and (tap.any_gate_stat()
                                          or tap.any_expert_stat())
        if self.gated and not self.quant and not collecting and (iv is None or (
                iv.neuron_mask is None and iv.out_weight_mask is None
                and iv.expert_boost is None
                and (iv.patterns is None or iv.k > 0))):
            e = 0 if iv is None or iv.patterns is None else iv.patterns.shape[0]
            c = x.shape[-1]
            proj, out = self.net[0].proj, self.net[2]
            if isinstance(out, RowParallelLinear):
                # kernel 1's output GEMM spans the whole hidden width
                _build.LAUNCHES["tp:geglu_ff_fused"] += 1
                return self._unfused(x, step_idx, tap, iv, ln, taps_out,
                                     use_kernels)
            if _build.plain_under_grad(
                    "geglu_ff_fused", use_kernels, x, proj.weight, proj.bias,
                    out.weight, out.bias,
                    *(() if ln is None else (ln.weight, ln.bias))):
                return self._fused(x, step_idx, iv, ln, False)
            if (not use_kernels or x.device.type == "cpu" or fused_ff_ok(
                    x.numel() // c, c, self.net[2].in_features, e, x.dtype)):
                return self._fused(x, step_idx, iv, ln, use_kernels)
            _build.LAUNCHES["plain:geglu_ff_fused"] += 1
        return self._unfused(x, step_idx, tap, iv, ln, taps_out, use_kernels)

    def _fused(self, x, t, iv, ln, use_kernels):
        """The whole FF in the fused GEGLU-MoE kernel."""
        patterns, k = None, 0
        if iv is not None and iv.patterns is not None:
            patterns, k = _step_patterns(iv, t), iv.k
        shape = x.shape
        proj, out = self.net[0].proj, self.net[2]
        y = geglu_ff_fused(
            x.reshape(-1, shape[-1]), proj.weight, proj.bias, out.weight,
            out.bias, patterns, k, relu=self.relu,
            ln_scale=None if ln is None else ln.weight,
            ln_bias=None if ln is None else ln.bias,
            eps=1e-5 if ln is None else ln.eps, use_kernels=use_kernels)
        return y.reshape(shape)

    def _unfused(self, x, t, tap, iv, ln, taps_out, use_kernels):
        """The JAX module's unfused path: LN, the proj GEMM, the activated
        gate, gate taps, the neuron fill, routing, the Wanda tap, W2 under
        its mask, the residual."""
        dt, resid = x.dtype, x
        if ln is not None:
            x = ln_apply(x, ln.weight, ln.bias, ln.eps).to(dt)
        if self.gated:
            hidden, gate = self.net[0].proj(x).chunk(2, dim=-1)
            gate = F.relu(gate) if self.relu else F.gelu(gate)
        else:
            hidden, gate = None, F.gelu(
                self.net[0].proj(x),
                approximate="tanh" if self.activation == "gelu-tanh" else "none")
        hdim = gate.shape[-1]
        sink = {} if taps_out is None else taps_out
        idx = self.ff_index
        if tap is not None and tap.any_gate_stat():
            _gate_stats(gate, tap, iv, sink, idx)
        if iv is not None and iv.neuron_mask is not None:
            gate = gate.masked_fill(step_row(iv.neuron_mask, t),
                                    iv.neuron_fill)
        y = None
        need_sel = tap is not None and tap.any_expert_stat()
        if iv is not None and iv.patterns is not None and iv.k > 0:
            patterns = _step_patterns(iv, t)
            boost = (None if iv.expert_boost is None
                     else step_row(iv.expert_boost, t))
            if self.gated and boost is None and not need_sel and _route_kernel(
                    hidden, gate, patterns, use_kernels):
                y = fused_route_multiply(
                    hidden.reshape(-1, hdim), gate.reshape(-1, hdim),
                    patterns, iv.k, use_kernels=use_kernels
                ).reshape(gate.shape)
            else:
                g2 = gate.reshape(-1, hdim)
                mask2d, sel = routing_mask(g2, patterns, iv.k,
                                           expert_boost=boost)
                gate = gate * mask2d.reshape(gate.shape)
                if need_sel:
                    _expert_stats(g2, sel, gate.shape, tap, iv, sink, idx)
        elif need_sel and iv is not None and iv.patterns is not None:
            # observe only: k < 0 selects top-|k|, k == 0 top-1; the gate
            # stays as it is
            g2 = gate.reshape(-1, hdim)
            _, sel = routing_mask(g2, iv.patterns, abs(iv.k) or 1)
            _expert_stats(g2, sel, gate.shape, tap, iv, sink, idx)
        if y is None:
            y = gate if hidden is None else hidden * gate
        if tap is not None and tap.ff_out_colnorm_sq:
            y2 = y.reshape(-1, hdim).float()
            y2 = y2 / y2.norm(dim=-1, keepdim=True).clamp_min(1e-12)
            sink.setdefault("ff_out_colnorm_sq", {})[idx] = (y2 * y2).sum(0)
        out = self.net[2]
        sl = in_slice(out)
        if tp_group(out) is not None:
            # the rank's hidden columns against its W2 shard
            y = copy_to_tp(y, tp_group(out))[..., sl]
        if iv is not None and iv.out_weight_mask is not None:
            wm = iv.out_weight_mask
            wm = step_row(wm, t) if wm.dim() == 3 else wm          # (D, H)
            w2 = out.weight * (1.0 - wm[..., sl].to(out.weight.dtype))
            # a masked W2 is this step's own: under int8 it is quantised here
            y = (int8_dot(y, w2) + out.bias if self.quant
                 else linear_out(out, y, w2))
        else:
            y = out(y)
        return y if ln is None else resid + y


def _route_kernel(hidden: torch.Tensor, gate: torch.Tensor,
                  patterns: torch.Tensor, use_kernels: bool) -> bool:
    """Whether routing goes through `fused_route_multiply` (its kernel, or
    on the CPU its plain version); where `route_kernel_ok` refuses a CUDA
    call, or autograd records it (kernel 4 has no backward), the caller
    takes `routing_mask`, counted as a plain call."""
    if _build.plain_under_grad("fused_route_multiply", use_kernels, gate,
                               hidden, patterns):
        return False
    if (not use_kernels or gate.device.type == "cpu"
            or route_kernel_ok(gate.shape[-1], patterns.shape[0], gate.dtype)):
        return True
    _build.LAUNCHES["plain:fused_route_multiply"] += 1
    return False


def _step_patterns(iv: LayerIntervention, t: int) -> torch.Tensor:
    """The routing patterns of step t: expert_remove's rows zeroed."""
    patterns = iv.patterns
    if iv.expert_remove is not None:
        rm = step_row(iv.expert_remove, t).to(patterns.dtype)       # (E,)
        patterns = patterns * (1.0 - rm)[:, None]
    return patterns


def _gate_stats(gate, tap: TapSpec, iv, sink: dict, idx: int) -> None:
    g = gate.reshape(-1, gate.shape[-1]).float()
    tm = None
    if iv is not None and iv.token_mask is not None:
        # the token positions of every batch element
        tm = iv.token_mask.repeat(gate.shape[0]).float()[:, None]
    if tap.max_gate:
        gm = g if tm is None else g.masked_fill(tm <= 0, float("-inf"))
        sink.setdefault("max_gate", {})[idx] = gm.max(0).values
    if tap.mean_gate:
        sink.setdefault("mean_gate", {})[idx] = (
            g.mean(0) if tm is None
            else (g * tm).sum(0) / tm.sum().clamp_min(1.0))
    if tap.gate_sparsity:
        sink.setdefault("gate_sparsity", {})[idx] = (g == 0.0).float().mean()
    if tap.save_gate:
        sink.setdefault("save_gate", {})[idx] = gate


def _expert_stats(g2, sel, gate_shape, tap: TapSpec, iv, sink: dict,
                  idx: int) -> None:
    if tap.expert_scores_max:
        score = g2.float() @ iv.patterns.float().t()
        sink.setdefault("expert_scores_max", {})[idx] = score.max(0).values
    if tap.expert_freq:
        # batch element 0 only, weight 1/seq_len
        bsz, seq_len = gate_shape[0], gate_shape[1]
        sel_b = sel.reshape(bsz, seq_len, -1)
        sink.setdefault("expert_freq", {})[idx] = sel_b[0].sum(0) / seq_len
    if tap.expert_sel:
        sink.setdefault("expert_sel", {})[idx] = sel.sum(0)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn, LN -> cross-attn, LN -> GEGLU FF, residual each.
    LayerNorm eps is 1e-5, torch's default that diffusers inherits."""

    def __init__(self, dim: int, heads: int, context_dim: int,
                 ff_mult: int = 4, ff_activation: str = "geglu",
                 ff_index: int = 0, attn_absorb: str = "0",
                 quant: bool = False):
        super().__init__()
        # the absorbed kernels read bf16 weights: int8 switches them off
        self.attn_absorb = "0" if quant else attn_absorb
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, quant=quant)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, context_dim=context_dim,
                               quant=quant)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim, ff_mult, ff_activation, ff_index,
                                   quant)

    def tp_shard(self, tp: int, rank: int) -> None:
        """Refuses the absorbed attention: kernels 5 and 6 take no head
        shard."""
        if self.attn_absorb != "0":
            raise ValueError(f"attn_absorb={self.attn_absorb!r} is not taken "
                             "under tp > 1")

    def forward(self, x: torch.Tensor, context: torch.Tensor, *,
                step_idx: int = 0, tap: Optional[TapSpec] = None,
                iv: Optional[LayerIntervention] = None,
                taps_out: TapsOut = None,
                use_kernels: bool = True) -> torch.Tensor:
        # the ranges `dmoe.unet.attn1` and `dmoe.unet.ff` hold exactly the
        # two module calls
        dt = x.dtype
        if self.attn_absorb != "0":
            # norm1 and the residual are delegated to the absorbed attention
            with annotate("dmoe.unet.attn1"):
                x = self.attn1(x, use_kernels=use_kernels, ln=self.norm1,
                               absorb=self.attn_absorb)
        else:
            h = layer_norm_f32(self.norm1, x).to(dt)
            with annotate("dmoe.unet.attn1"):
                h = self.attn1(h, use_kernels=use_kernels)
            x = x + h
        x = x + self.attn2(layer_norm_f32(self.norm2, x).to(dt), context,
                           use_kernels=use_kernels)
        # norm3 and the residual are absorbed into the FF
        with annotate("dmoe.unet.ff"):
            return self.ff(x, step_idx=step_idx, tap=tap, iv=iv,
                           ln=self.norm3, taps_out=taps_out,
                           use_kernels=use_kernels)


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> proj_in -> depth x blocks -> proj_out +
    residual, on (B, C, H, W) features (channels-last memory on the card).
    Block d owns FF layer `ff_index + d`."""

    def __init__(self, dim: int, heads: int, context_dim: int, depth: int = 1,
                 norm_num_groups: int = 32, ff_mult: int = 4,
                 ff_activation: str = "geglu", ff_index: int = 0,
                 attn_absorb: str = "0", quant: bool = False):
        super().__init__()
        self.norm = nn.GroupNorm(norm_num_groups, dim, eps=1e-6)
        self.proj_in = make_dense(dim, dim, quant=quant)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(dim, heads, context_dim, ff_mult, ff_activation,
                                  ff_index + d, attn_absorb, quant)
            for d in range(depth)])
        self.proj_out = make_dense(dim, dim, quant=quant)

    def forward(self, x: torch.Tensor, context: torch.Tensor, *,
                step_idx: int = 0, tap: Optional[TapSpec] = None,
                ivs: Sequence[Optional[LayerIntervention]] = (),
                taps_out: TapsOut = None,
                use_kernels: bool = True) -> torch.Tensor:
        b, c, h, w = x.shape
        # channels-last from the norm kernel: the token view is no copy, and
        # the closing residual add reads both sides in one layout
        y = group_norm(self.norm, x, silu=False, use_kernels=use_kernels)
        y = self.proj_in(y.permute(0, 2, 3, 1).reshape(b, h * w, c))
        for d, block in enumerate(self.transformer_blocks):
            iv = ivs[d] if d < len(ivs) else None
            y = block(y, context, step_idx=step_idx, tap=tap, iv=iv,
                      taps_out=taps_out, use_kernels=use_kernels)
        y = self.proj_out(y)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2) + x
