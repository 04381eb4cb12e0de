"""Fused resblock conv chain: GroupNorm-affine + SiLU prologue, 3x3 stride-1
SAME convolution, bias (+ time embedding) and residual epilogue.

Counterpart of `diffusion_models_moe_tpu/ops/conv_chain_fused.py`. On CUDA
tensors `conv3x3_chain` launches the hand-written implicit-GEMM kernel of
`csrc/conv_chain.cu` (wgmma products, the weights by TMA, a producer/consumer
pipeline on mbarriers); on CPU tensors it runs the plain PyTorch version
beside it, which rounds where the kernel rounds. How a launch is cut into
blocks is decided here, in `chain_plan`, a pure function of the shape and
the card's SM count that the CPU tests reach. As in the JAX package the
GroupNorm statistics are a plain reduction outside the kernel
(`gn_scale_shift`), folded with the affine into a per-(sample, channel)
scale and shift.

Layouts. Tensors have this package's logical shapes, x (B, Cin, H, W) and
w (Cout, Cin, 3, 3) as `nn.Conv2d` holds it. The kernel wants the Cin values
of a pixel contiguous, so on CUDA x, the residual and w must be in
`torch.channels_last` memory format (NHWC strides, the same logical shape),
and the output is channels-last too: a resblock that keeps its activations
and conv weights in that format pays no layout copy. The band stacking, halo
gather and `variant` of the JAX function are Mosaic's needs and have no
counterpart: the kernel reads its halo from x itself.

Forward only: no autograd.Function, no backward. Where autograd records a
call on the card (`_build.grad_through`), the model takes the plain version,
which is differentiable, and counts the call under `plain:conv3x3_chain`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.ops import _build

CL = torch.channels_last
# the kernel's tiling (csrc/conv_chain.cu: C_TH, C_BN, C_BK)
TILE_H = 8          # output rows of a block's pixel rectangle
COUT_TILE = 160     # output channels a block (divides 320, 640, 1280)
CIN_CHUNK = 64      # input channels a depth chunk; all 9 taps inside a chunk
# The depth is split over several blocks only where the unsplit grid has at
# most this many blocks an SM: a split pays an f32 round trip of the output
# through a scratch, which a grid near one wave does not earn back.
SPLIT_BELOW_BLOCKS_PER_SM = 0.5


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """How one launch of the conv-chain kernel is cut into blocks. A block
    takes a rectangle of `TILE_H` x `tile_w` output pixels of one image
    (`tiles_y` x `tiles_x` rectangles cover an image, masked past its edge),
    `COUT_TILE` output channels (`cout_tiles` of them), and `chunks_per_split`
    consecutive Cin chunks of `CIN_CHUNK` channels, with all 9 taps of each:
    split `s` takes chunks [s * chunks_per_split, (s + 1) * chunks_per_split)
    of the `chunks`. With `split` > 1 the blocks write f32 partial sums and a
    second kernel adds them in the order s = 0, 1, ..."""
    tile_w: int
    tiles_y: int
    tiles_x: int
    cout_tiles: int
    chunks: int
    split: int
    chunks_per_split: int

    def blocks(self, batch: int) -> int:
        return batch * self.tiles_y * self.tiles_x * self.cout_tiles * self.split


def split_depth(blocks: int, chunks: int, sms: int, blocks_per_sm: int):
    """(split, chunks_per_split) for a grid of `blocks` blocks over `chunks`
    depth chunks: 1 split unless the grid is at most
    SPLIT_BELOW_BLOCKS_PER_SM blocks an SM; then as many splits as keep the
    grid within `blocks_per_sm` resident blocks an SM, every split non-empty."""
    if blocks > SPLIT_BELOW_BLOCKS_PER_SM * sms:
        return 1, chunks
    want = min(chunks, max(1, blocks_per_sm * sms // blocks))
    per = -(-chunks // want)
    return -(-chunks // per), per


@functools.lru_cache(maxsize=None)
def chain_plan(b: int, h: int, w: int, cin: int, cout: int, sms: int) -> ChainPlan:
    """The plan of `conv3x3_chain` at this shape on a card with `sms` SMs: a
    pure function of its arguments. Rectangles are 8 x 16 pixels (two
    consumer warpgroups, one block an SM) from 16 columns up and 8 x 8 below
    (one warpgroup, two blocks an SM)."""
    tile_w = 16 if w >= 16 else 8
    tiles_y, tiles_x = -(-h // TILE_H), -(-w // tile_w)
    cout_tiles, chunks = -(-cout // COUT_TILE), -(-cin // CIN_CHUNK)
    split, per = split_depth(b * tiles_y * tiles_x * cout_tiles, chunks, sms,
                             blocks_per_sm=1 if tile_w == 16 else 2)
    return ChainPlan(tile_w, tiles_y, tiles_x, cout_tiles, chunks, split, per)


def chain_ok(h: int, w: int, cin: int, cout: int) -> bool:
    """Shapes the kernel takes: channel counts that are multiples of the
    16-byte vector (8 bf16). Any spatial size."""
    return h >= 1 and w >= 1 and cin % 8 == 0 and cout % 8 == 0


def gn_scale_shift(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   groups: int, eps: float):
    """Folds GroupNorm statistics and affine into per-(sample, channel)
    scale and shift: (x - mean) * rstd * gamma + beta == x * scale + shift
    with scale = rstd * gamma, shift = beta - mean * scale. x (B, C, H, W) in
    any memory format; statistics in f32 over (C/G, H, W). Returns two
    (B, C) f32 tensors."""
    b, c = x.shape[:2]
    xg = x.float().view(b, groups, c // groups, *x.shape[2:])
    var, mean = torch.var_mean(xg, dim=(2, 3, 4), correction=0)     # (B, G)
    rstd = torch.rsqrt(var + eps)
    # per channel by broadcasting over (B, G, C/G): the same products as
    # repeating rstd and mean per channel, in fewer launches
    per_group = (groups, c // groups)
    scale = rstd[:, :, None] * gamma.float().view(per_group)
    shift = beta.float().view(per_group) - mean[:, :, None] * scale
    return scale.view(b, c), shift.view(b, c)


def conv3x3_chain_reference(x, w, bt, scale=None, shift=None, residual=None,
                            prologue: bool = True) -> torch.Tensor:
    """Plain PyTorch version: the prologue in f32 rounded to x.dtype, the
    convolution in f32 (zero padding after the prologue; cuDNN's TF32 path
    switched off, so the products are full f32 on every device) rounded to
    x.dtype, then + bt and + residual in x.dtype."""
    dt = x.dtype
    xn = x
    if prologue:
        xn = F.silu(x.float() * scale[:, :, None, None]
                    + shift[:, :, None, None]).to(dt)
    with torch.backends.cudnn.flags(allow_tf32=False):
        y = F.conv2d(xn.float(), w.float(), padding=1).to(dt)
    y = y + bt.to(dt)[:, :, None, None]
    return y if residual is None else y + residual.to(dt)


def conv3x3_chain(x: torch.Tensor, w: torch.Tensor, bt: torch.Tensor,
                  scale: Optional[torch.Tensor] = None,
                  shift: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  prologue: bool = True,
                  use_kernels: bool = True) -> torch.Tensor:
    """Fused [GN-affine + SiLU ->] 3x3 SAME conv -> + bt [-> + residual].

    x (B, Cin, H, W); w (Cout, Cin, 3, 3); bt (B, Cout), the conv bias plus
    the optional time-embedding projection, per sample; scale, shift
    (B, Cin) f32 from `gn_scale_shift` (required with `prologue`); residual
    (B, Cout, H, W) optional. Returns (B, Cout, H, W), channels-last on CUDA.

    `use_kernels=False` takes the plain version on CUDA too; it exists only
    for kernel-vs-plain comparisons."""
    b, cin, h, wd = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 3, 3) or tuple(bt.shape) != (b, cout):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}, bt "
                         f"{tuple(bt.shape)} do not form a 3x3 conv chain")
    if prologue and (scale is None or shift is None):
        raise ValueError("the prologue needs scale and shift")
    if not chain_ok(h, wd, cin, cout):
        raise ValueError(f"conv {cin}->{cout} at {h}x{wd}: see chain_ok")
    if x.device.type == "cpu" or not use_kernels:
        return conv3x3_chain_reference(x, w, bt, scale, shift, residual,
                                       prologue)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    dev, bf16 = x.device, torch.bfloat16
    acts = [("x", x), ("w", w)]
    if residual is not None:
        if tuple(residual.shape) != (b, cout, h, wd):
            raise ValueError(f"residual {tuple(residual.shape)}: need "
                             f"{(b, cout, h, wd)}")
        acts.append(("residual", residual))
    for name, t in acts:
        _build.check_cuda_tensor(name, t, bf16, dev, contiguous=False)
        if not t.is_contiguous(memory_format=CL):
            raise ValueError(f"{name} must be in channels_last memory format")
    _build.check_cuda_tensor("bt", bt, bf16, dev)
    if prologue:
        for name, t in (("scale", scale), ("shift", shift)):
            _build.check_cuda_tensor(name, t, torch.float32, dev)
            if tuple(t.shape) != (b, cin):
                raise ValueError(f"{name} {tuple(t.shape)}: need ({b}, {cin})")
    y = torch.empty((b, cout, h, wd), device=dev, dtype=bf16, memory_format=CL)
    plan = chain_plan(b, h, wd, cin, cout, _build.sm_count(dev))
    partial = None
    if plan.split > 1:
        partial = torch.empty((plan.split, b, h, wd, cout), device=dev,
                              dtype=torch.float32)
    _build.load_library().call(
        "dmoe_conv3x3_chain", x.data_ptr(),
        scale.data_ptr() if prologue else None,
        shift.data_ptr() if prologue else None, w.data_ptr(), bt.data_ptr(),
        None if residual is None else residual.data_ptr(), b, h, wd, cin,
        cout, plan.tile_w, plan.tiles_x, plan.tiles_y, plan.split,
        plan.chunks_per_split, y.data_ptr(),
        None if partial is None else partial.data_ptr(),
        _build.stream_ptr(dev))
    _build.LAUNCHES["conv3x3_chain"] += 1
    return y
