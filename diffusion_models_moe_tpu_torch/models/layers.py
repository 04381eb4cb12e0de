"""Basic UNet/VAE building blocks (PyTorch port, NCHW shapes).

Counterpart of `diffusion_models_moe_tpu/models/layers.py`. Convolutions stay
in torch (cuDNN), as the JAX package leaves them to XLA. Norms run in f32 on
f32 parameters and their output is cast to the compute dtype, as the JAX
modules do with `norm_dtype=float32`; on the card every GroupNorm of the UNet
and the VAE (`group_norm`) is one pass of the hand-written channels-last
kernel of `ops/group_norm_nhwc.py`, bf16 in and out, with the resblock's
time embedding and SiLU fused. With `conv_chain` (the JAX package's
DMOE_CONV_CHAIN) a resblock's two 3x3 convs run the fused GN+SiLU -> conv ->
bias -> residual kernel (`ops/conv_chain_fused.py`). A resblock keeps its
activations and conv weights in `torch.channels_last` memory format (the
same logical NCHW shapes and parameter names), unless its 3x3 convs are the
plain Winograd formulation, which writes NCHW.

`make_conv` is the one dispatcher over the direct conv, `WinoConv`
(`conv_winograd`: `ops/winograd.py`, or with `"fused"` the F(2x2, 3x3)
kernel of `ops/winograd_fused.py`) and `QuantConv` (`quant_int8`:
`ops/quant.py`), with the JAX package's precedence: Winograd takes the
stride-1 3x3 padding-1 convs, int8 the rest when both are set. All three are
`nn.Conv2d`s with the same parameters. What they derive from their weight
once (the transformed filter, the int8 weight and its scales) is hoisted by
`HoistedWeight` and follows the weight; where a gradient is taken the
Winograd filter is transformed at each call instead. Where autograd records
a call on the card, kernels 7 and 8 (forward only) give way to their plain
versions, counted under `plain:<kernel>` in `ops/_build.LAUNCHES`.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.ops.conv_chain_fused import (
    CL, chain_ok, conv3x3_chain, gn_scale_shift)
from diffusion_models_moe_tpu_torch.ops.group_norm_nhwc import (
    group_norm_nhwc, group_norm_ok)
from diffusion_models_moe_tpu_torch.ops.quant import (int8_conv,
                                                      quantize_conv_weight)
from diffusion_models_moe_tpu_torch.ops.winograd import (transform_filter,
                                                         winograd_conv3x3)
from diffusion_models_moe_tpu_torch.ops.winograd_fused import (
    fused_filter, fused_ok, winograd3x3_fused)


def cast_model(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Casts weights to the compute dtype and keeps norm parameters in f32
    (the JAX package keeps every parameter in f32 and casts weights at use,
    norm parameters not at all), and those of every module whose class sets
    `F32_PARAMS` (T5's RMSNorm and its position-bias table)."""
    module.to(dtype)
    for m in module.modules():
        if isinstance(m, (nn.GroupNorm, nn.LayerNorm)) or getattr(
                m, "F32_PARAMS", False):
            m.float()
    return module


def group_norm_f32(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm computed in f32; returns f32. A call that autograd records
    runs on NCHW memory: the CPU's channels-last GroupNorm crashes in a
    backward that wants the affine's gradient alone (torch 2.13), and CUDA's
    GroupNorm copies to NCHW anyway."""
    fmt = (torch.contiguous_format
           if _build.grad_through(x, norm.weight, norm.bias)
           else torch.preserve_format)
    return F.group_norm(x.to(torch.float32, memory_format=fmt),
                        norm.num_groups, norm.weight, norm.bias, norm.eps)


def group_norm(norm: nn.GroupNorm, x: torch.Tensor, *, silu: bool,
               bias: Optional[torch.Tensor] = None,
               use_kernels: bool = True) -> torch.Tensor:
    """silu?(norm(x + bias)) in x's dtype; bias (B, C) or None, added in
    x's dtype. On the card the channels-last kernel where `group_norm_ok`
    admits the call (its output channels-last), elsewhere on the card the
    plain sequence below, counted under `plain:group_norm_nhwc`; on the CPU
    and with `use_kernels=False` the plain sequence."""
    if use_kernels and _build.on_card(x):
        if group_norm_ok(x, norm.num_groups, norm.weight, norm.bias, bias):
            return group_norm_nhwc(x, norm.weight, norm.bias, norm.num_groups,
                                   norm.eps, silu=silu, bias=bias)
        _build.LAUNCHES["plain:group_norm_nhwc"] += 1
    if bias is not None:
        x = x + bias[:, :, None, None]
    h = group_norm_f32(norm, x)
    return (F.silu(h) if silu else h).to(x.dtype)


def layer_norm_f32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in f32; returns f32."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps)


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size, size), bilinear with half-pixel centres,
    antialiased where it shrinks: what `jax.image.resize(..., "bilinear")`
    gives (it widens its kernel by the scale when it downsamples)."""
    h, w = images.shape[-2:]
    if (h, w) == (size, size):
        return images
    return F.interpolate(images, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=h > size or w > size)


_F32_CONVS_LOCK = threading.Lock()
_f32_convs_open = 0          # blocks of f32_convs open, over all threads
_f32_convs_before = True     # cuDNN's TF32 flag as the first block found it


@contextlib.contextmanager
def f32_convs():
    """cuDNN convolutions in full f32 (no TF32) while the block runs, as the
    judges take them. Matmuls stay as PyTorch's
    `torch.backends.cuda.matmul.allow_tf32` says (full f32 by default).

    cuDNN's flag is process-wide: the first block to open saves it and
    switches TF32 off, the last to close restores it, counted under a lock,
    so that blocks overlapping on several threads leave the process's
    setting as they found it. While a block is open, an f32 convolution on
    another thread runs in full f32 too (more precise, never less); bf16
    and f16 convolutions, which every pipeline the port serves on the card
    runs, do not read the flag."""
    global _f32_convs_open, _f32_convs_before
    cudnn = torch.backends.cudnn
    with _F32_CONVS_LOCK:
        if _f32_convs_open == 0:
            _f32_convs_before = cudnn.allow_tf32
            cudnn.allow_tf32 = False
        _f32_convs_open += 1
    try:
        yield
    finally:
        with _F32_CONVS_LOCK:
            _f32_convs_open -= 1
            if _f32_convs_open == 0:
                cudnn.allow_tf32 = _f32_convs_before


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
    """Linear -> SiLU -> Linear on the sinusoidal embedding. With `cond_dim`
    > 0 (LCM's guidance embedding), a bias-free `cond_proj` of the
    conditioning is added to the sinusoidal embedding first (diffusers'
    `time_embedding.cond_proj`)."""

    def __init__(self, in_dim: int, emb_dim: int, cond_dim: int = 0):
        super().__init__()
        self.cond_proj = (nn.Linear(cond_dim, in_dim, bias=False)
                          if cond_dim > 0 else None)
        self.linear_1 = nn.Linear(in_dim, emb_dim)
        self.linear_2 = nn.Linear(emb_dim, emb_dim)

    def forward(self, emb: torch.Tensor,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        if cond is not None:
            if self.cond_proj is None:
                raise ValueError("a timestep condition was given to a UNet "
                                 "without cond_proj (time_cond_proj_dim 0)")
            emb = emb + self.cond_proj(cond.to(emb.dtype))
        return self.linear_2(F.silu(self.linear_1(emb)))


class HoistedWeight(nn.Module):
    """Mixin for a module with a `weight`: tensors derived from the weight
    alone are made once and kept in non-persistent buffers (never in the
    state dict). They follow the weight: an in-place change
    (`load_state_dict`, `copy_`) or a replaced parameter is seen at the next
    call, and a conversion of the module (`to`, `cuda`, `float`,
    `cast_model`) drops them."""
    _hoist_key = None
    _hoist_n = 0

    def hoisted(self, make) -> tuple:
        """`make(weight)`'s tuple of tensors, remade when the weight changed."""
        w = self.weight
        key = (w.data_ptr(), w._version)
        if self._hoist_key != key:
            made = tuple(make(w))
            for i, t in enumerate(made):
                self.register_buffer(f"hoisted_{i}", t, persistent=False)
            self._hoist_key, self._hoist_n = key, len(made)
        return tuple(getattr(self, f"hoisted_{i}") for i in range(self._hoist_n))

    def _apply(self, fn, recurse=True):
        for i in range(self._hoist_n):
            delattr(self, f"hoisted_{i}")
        self._hoist_key, self._hoist_n = None, 0
        return super()._apply(fn, recurse)


class QuantConv(HoistedWeight, nn.Conv2d):
    """`nn.Conv2d` (same parameters) through the int8 W8A8 convolution of
    `ops/quant.py`; the weight's quantisation is hoisted."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.weight.dtype
        y = int8_conv(x.to(dt), stride=self.stride[0], padding=self.padding[0],
                      kernel_size=self.kernel_size[0],
                      wq=self.hoisted(quantize_conv_weight))
        return y + self.bias.to(dt)[:, None, None]


class WinoConv(HoistedWeight, nn.Conv2d):
    """Stride-1 SAME 3x3 `nn.Conv2d` (same parameters) as Winograd. `mode`
    "1": the formulation of `ops/winograd.py` at `tile`. `mode` "fused": the
    F(2x2, 3x3) kernel where `fused_ok` admits the shape and the direct conv
    elsewhere, never the plain formulation. The transformed filter is made
    in f32, rounded to the model dtype and hoisted."""

    def __init__(self, in_channels: int, out_channels: int, mode: str = "1",
                 tile: int = 2):
        super().__init__(in_channels, out_channels, 3, 1, 1)
        self.mode, self.tile = mode, tile

    def takes_kernel(self, h: int, w: int) -> bool:
        """Whether an h x w input goes through the fused kernel."""
        return self.mode == "fused" and fused_ok(h, w, self.in_channels,
                                                 self.out_channels)

    def forward(self, x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        dt = self.weight.dtype
        x = x.to(dt)
        # under grad the filter is transformed at each call, so that the
        # weight's gradient flows through it (a hoisted one would carry none)
        grad = _build.grad_through(x, self.weight, self.bias)
        if self.mode == "fused":
            if not self.takes_kernel(x.shape[2], x.shape[3]):
                return F.conv2d(x, self.weight, self.bias, padding=1)
            if grad:
                _build.plain_under_grad("winograd3x3_fused", use_kernels, x,
                                        self.weight, self.bias)
                return winograd3x3_fused(x, fused_filter(self.weight),
                                         self.bias, use_kernels=False)
            (u,) = self.hoisted(lambda w: (fused_filter(w),))
            # no copy inside a block that keeps the format
            return winograd3x3_fused(x.contiguous(memory_format=CL), u,
                                     self.bias, use_kernels=use_kernels)
        make = lambda w: (transform_filter(w, self.tile).to(w.dtype),)  # noqa: E731
        (u,) = make(self.weight) if grad else self.hoisted(make)
        y = winograd_conv3x3(x, u=u, tile=self.tile)
        return y + self.bias.to(dt)[:, None, None]


def make_conv(in_channels: int, out_channels: int, kernel_size: int = 3, *,
              stride: int = 1, padding: int = 1, quant: bool = False,
              winograd: str = "0", winograd_tile: int = 2) -> nn.Conv2d:
    """nn.Conv2d, or its Winograd or int8 twin (the same parameters either
    way). `winograd` applies only to stride-1 3x3 padding-1 convs; combined
    with `quant`, Winograd takes those and int8 the rest (1x1 shortcuts,
    stride-2 downsamples)."""
    if winograd != "0" and (kernel_size, stride, padding) == (3, 1, 1):
        return WinoConv(in_channels, out_channels, winograd, winograd_tile)
    cls = QuantConv if quant else nn.Conv2d
    return cls(in_channels, out_channels, kernel_size, stride, padding)


def run_conv(conv: nn.Conv2d, x: torch.Tensor, use_kernels: bool) -> torch.Tensor:
    """`conv(x)`; only a `WinoConv` has a kernel to switch off."""
    if isinstance(conv, WinoConv):
        return conv(x, use_kernels=use_kernels)
    return conv(x)


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> Conv -> (+time) -> GN -> SiLU -> Conv, with skip.

    With `conv_chain`, conv1 (GN fold of norm1, the time embedding as extra
    bias) and conv2 (GN fold of norm2, the shortcut as residual) each take
    the fused chain kernel where `chain_ok` admits the shape, and the
    ordinary sequence elsewhere. `quant` or `winograd` switch the chain off
    and make the convs through `make_conv`."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm_num_groups: int = 32, eps: float = 1e-5,
                 temb_channels: Optional[int] = None,
                 conv_chain: bool = False, quant: bool = False,
                 winograd: str = "0", winograd_tile: int = 2):
        super().__init__()
        self.conv_chain = conv_chain and not quant and winograd == "0"
        modes = dict(quant=quant, winograd=winograd,
                     winograd_tile=winograd_tile)
        self.norm1 = nn.GroupNorm(norm_num_groups, in_channels, eps=eps)
        self.conv1 = make_conv(in_channels, out_channels, **modes)
        self.time_emb_proj = (None if temb_channels is None
                              else nn.Linear(temb_channels, out_channels))
        self.norm2 = nn.GroupNorm(norm_num_groups, out_channels, eps=eps)
        self.conv2 = make_conv(out_channels, out_channels, **modes)
        self.conv_shortcut = (
            make_conv(in_channels, out_channels, 1, padding=0, quant=quant)
            if in_channels != out_channels else None)
        # the one place that decides the block's memory format: the
        # GroupNorm kernel writes channels-last, the chain and the fused
        # Winograd kernels read a pixel's Cin values contiguously and cuDNN
        # and the int8 conv read and write either format at no cost, so the
        # block's activations and its conv weights (the chain reads them as
        # (Cout, 3, 3, Cin)) live channels-last and no call rearranges them;
        # the plain Winograd formulation writes NCHW, so its block stays so
        self.channels_last = winograd != "1"
        if self.channels_last:
            self.to(memory_format=CL)

    def chain_branches(self, h: int, w: int) -> tuple[bool, bool]:
        """Whether conv1 and conv2 take the chain kernel at an h x w input."""
        c1, c2 = self.conv1, self.conv2
        return (self.conv_chain and chain_ok(h, w, c1.in_channels, c1.out_channels),
                self.conv_chain and chain_ok(h, w, c2.in_channels, c2.out_channels))

    def _chain(self, norm: nn.GroupNorm, conv: nn.Conv2d, x: torch.Tensor,
               extra_bias=None, residual=None, use_kernels: bool = True):
        if _build.plain_under_grad("conv3x3_chain", use_kernels, x,
                                   conv.weight, conv.bias, norm.weight,
                                   norm.bias, extra_bias, residual):
            use_kernels = False
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
        chain1, chain2 = self.chain_branches(x.shape[2], x.shape[3])
        if self.channels_last:
            # no copy when the producer kept the format
            x = x.contiguous(memory_format=CL)
        t = None
        if self.time_emb_proj is not None and temb is not None:
            t = self.time_emb_proj(F.silu(temb))
        if chain1:
            h = self._chain(self.norm1, self.conv1, x, extra_bias=t,
                            use_kernels=use_kernels)
            t = None         # the chain took the time embedding as a bias
        else:
            h = run_conv(self.conv1, group_norm(self.norm1, x, silu=True,
                                                use_kernels=use_kernels),
                         use_kernels)
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        if chain2:
            if t is not None:
                h = h + t[:, :, None, None]
            return self._chain(self.norm2, self.conv2, h, residual=residual,
                               use_kernels=use_kernels)
        # the time embedding joins conv1's output inside norm2
        h = group_norm(self.norm2, h, silu=True, bias=t,
                       use_kernels=use_kernels)
        return run_conv(self.conv2, h, use_kernels) + residual


class Downsample2D(nn.Module):
    def __init__(self, channels: int, quant: bool = False, padding: int = 1):
        super().__init__()
        self.conv = make_conv(channels, channels, stride=2, padding=padding,
                              quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int, quant: bool = False,
                 winograd: str = "0", winograd_tile: int = 2):
        super().__init__()
        self.conv = make_conv(channels, channels, quant=quant,
                              winograd=winograd, winograd_tile=winograd_tile)

    def forward(self, x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        return run_conv(self.conv,
                        F.interpolate(x, scale_factor=2.0, mode="nearest"),
                        use_kernels)
