"""Absorbed self-attention sub-block: LayerNorm + q/k/v projection before the
flash kernel, output projection + bias + residual after it.

Counterpart of `diffusion_models_moe_tpu/ops/attn_absorb_fused.py`. On CUDA
tensors `ln_qkv_fused` and `attn_out_residual_fused` launch the hand-written
kernels of `csrc/attn_absorb.cu`; on CPU tensors they run the plain PyTorch
versions beside them, which round where the kernels round.

Layouts. The JAX functions hand the TPU flash call (B, H, S, 128-lane)
operands with the head-dim pad folded into the weights; this package's flash
kernel (`ops/sd_flash.py`) reads (B, S, H, D) through strides at the native
head dim, so no pad and no head-major layout is carried over. `ln_qkv_fused`
writes one (B, S, 3C) tensor and returns q, k, v as its column thirds viewed
as (B, S, H, D), strides (S*3C, 3C, D, 1): the flash kernel takes them
without a copy. `attn_out_residual_fused` reads the flash output (B, S, H, D)
by whatever strides it has. Weights use the nn.Linear layout (out, in):
`attn1.to_q.weight`, ..., `attn1.to_out.0.weight`; they are passed as they
are, nothing is concatenated or padded per call.

Inference only: no autograd.Function, no backward.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.ops.sd_flash import self_attention


def attn_absorb_ok(s: int, c: int, heads: int) -> bool:
    """Shapes the two kernels take: whole heads whose dim is a multiple of
    the 16-byte vector (8 bf16). Any sequence length. (The flash kernel
    between them has its own predicate, `attn_kernel_ok`; where it says no
    the plain attention runs between the two kernels.)"""
    d = c // heads
    return s >= 1 and c == d * heads and d % 8 == 0


def ln_apply(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """The absorbed LayerNorm on plain tensors, f32 out: fast variance and
    the rsqrt folded into the scale, flax's op order, as the kernels compute
    it. Used where a delegated LayerNorm meets no kernel."""
    xr = x.float()
    mu = xr.mean(-1, keepdim=True)
    var = ((xr * xr).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (xr - mu) * (torch.rsqrt(var + eps) * g.float()) + b.float()


def _heads4(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, C) -> (B, S, H, D) view, no copy."""
    return t.view(t.shape[0], t.shape[1], heads, t.shape[2] // heads)


def ln_qkv_reference(x, wq, wk, wv, heads: int, ln_scale=None, ln_bias=None,
                     eps: float = 1e-5):
    """Plain PyTorch version: f32 LayerNorm rounded to x.dtype, the three
    projections with f32 accumulation rounded to x.dtype."""
    dt = x.dtype
    xd = x if ln_scale is None else ln_apply(x, ln_scale, ln_bias, eps).to(dt)
    return tuple(_heads4((xd.float() @ w.float().t()).to(dt), heads)
                 for w in (wq, wk, wv))


def ln_qkv_fused(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                 wv: torch.Tensor, heads: int,
                 ln_scale: Optional[torch.Tensor] = None,
                 ln_bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
                 use_kernels: bool = True):
    """x (B, S, C); wq, wk, wv (C, C) in the nn.Linear layout. Returns
    (q, k, v), each (B, S, H, D). With ln_scale/ln_bias (C,) f32 the
    absorbed LayerNorm runs first. On CUDA the three are views of one
    (B, S, 3C) tensor (see the module docstring).

    `use_kernels=False` takes the plain version on CUDA too; it exists only
    for kernel-vs-plain comparisons."""
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("ln_scale and ln_bias go together")
    b, s, c = x.shape
    if not attn_absorb_ok(s, c, heads):
        raise ValueError(f"x {tuple(x.shape)} with {heads} heads: see "
                         "attn_absorb_ok")
    if x.device.type == "cpu" or not use_kernels:
        return ln_qkv_reference(x, wq, wk, wv, heads, ln_scale, ln_bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    dev, bf16 = x.device, torch.bfloat16
    _build.check_cuda_tensor("x", x, bf16, dev)
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv)):
        _build.check_cuda_tensor(name, w, bf16, dev)
        if tuple(w.shape) != (c, c):
            raise ValueError(f"{name} {tuple(w.shape)}: need ({c}, {c})")
    if ln_scale is not None:
        _build.check_cuda_tensor("ln_scale", ln_scale, torch.float32, dev)
        _build.check_cuda_tensor("ln_bias", ln_bias, torch.float32, dev)
        if ln_scale.numel() != c or ln_bias.numel() != c:
            raise ValueError(f"ln_scale/ln_bias need {c} values")
    y = torch.empty((b, s, 3 * c), device=dev, dtype=bf16)
    _build.load_library().call(
        "dmoe_ln_qkv", x.data_ptr(), wq.data_ptr(), wk.data_ptr(),
        wv.data_ptr(), None if ln_scale is None else ln_scale.data_ptr(),
        None if ln_bias is None else ln_bias.data_ptr(), eps, b * s, c,
        y.data_ptr(), _build.stream_ptr(dev))
    _build.LAUNCHES["ln_qkv_fused"] += 1
    return tuple(_heads4(y[..., t * c:(t + 1) * c], heads) for t in range(3))


def attn_out_residual_reference(o, w, bias, residual):
    """Plain PyTorch version: o (B, S, H, D) flattened to rows of H*D, the
    projection and bias in f32, rounded to residual.dtype, plus the residual
    in that dtype."""
    b, s = o.shape[:2]
    y = o.reshape(b, s, -1).float() @ w.float().t() + bias.float()
    return residual + y.to(residual.dtype)


def attn_out_residual_fused(o: torch.Tensor, w: torch.Tensor,
                            bias: torch.Tensor, residual: torch.Tensor,
                            use_kernels: bool = True) -> torch.Tensor:
    """o (B, S, H, D), the flash output, read by its strides; w (C, C) in the
    nn.Linear layout with C = H*D; bias (C,); residual (B, S, C). Returns
    residual + (o w^T + bias), (B, S, C)."""
    b, s, heads, d = o.shape
    c = heads * d
    if tuple(residual.shape) != (b, s, c) or tuple(w.shape) != (c, c) \
            or tuple(bias.shape) != (c,):
        raise ValueError(f"o {tuple(o.shape)}, w {tuple(w.shape)}, bias "
                         f"{tuple(bias.shape)}, residual "
                         f"{tuple(residual.shape)} do not form an output "
                         "projection")
    if o.device.type == "cpu" or not use_kernels:
        return attn_out_residual_reference(o, w, bias, residual)
    if o.device.type != "cuda":
        raise ValueError(f"no kernel for device {o.device}")
    dev, bf16 = o.device, torch.bfloat16
    _build.check_cuda_tensor("o", o, bf16, dev, contiguous=False)
    if d % 8 or o.stride(3) != 1 or any(st % 8 for st in o.stride()[:3]):
        raise ValueError(f"o {tuple(o.shape)} strides {o.stride()}: need "
                         "D % 8 == 0, unit stride in D and 16-byte aligned "
                         "rows")
    for name, t in (("w", w), ("bias", bias), ("residual", residual)):
        _build.check_cuda_tensor(name, t, bf16, dev)
    y = torch.empty((b, s, c), device=dev, dtype=bf16)
    strides = (ctypes.c_longlong * 3)(*o.stride()[:3])
    _build.load_library().call(
        "dmoe_attn_out_residual", o.data_ptr(), strides, w.data_ptr(),
        bias.data_ptr(), residual.data_ptr(), b * s, s, c, d, y.data_ptr(),
        _build.stream_ptr(dev))
    _build.LAUNCHES["attn_out_residual_fused"] += 1
    return y


def absorbed_self_attention(x: torch.Tensor, wq, wk, wv, wo, bo, heads: int,
                            sm_scale: float, ln: tuple, mode: str = "1",
                            use_kernels: bool = True) -> torch.Tensor:
    """The absorbed self-attention sub-block: returns
    `x + to_out(flash(qkv(LN(x))))` for x (B, S, C), `ln` = (scale, bias,
    eps). `mode` is the JAX package's DMOE_ATTN_ABSORB split:

      1     both kernels (prologue and epilogue)
      qkv   `ln_qkv_fused` only; the output projection and the residual add
            in plain torch
      out   LayerNorm and the projections in plain torch;
            `attn_out_residual_fused` only
    """
    if mode not in ("1", "qkv", "out"):
        raise ValueError(f"absorb mode {mode!r}: one of '1', 'qkv', 'out'")
    g, b, eps = ln
    if mode in ("1", "qkv"):
        q, k, v = ln_qkv_fused(x, wq, wk, wv, heads, g, b, eps,
                               use_kernels=use_kernels)
    else:
        xn = ln_apply(x, g, b, eps).to(x.dtype)
        q, k, v = (_heads4(F.linear(xn, w), heads) for w in (wq, wk, wv))
    o = self_attention(q, k, v, sm_scale, use_kernels=use_kernels)
    if mode in ("1", "out"):
        return attn_out_residual_fused(o, wo, bo, x, use_kernels=use_kernels)
    return x + F.linear(o.reshape(x.shape), wo, bo)
