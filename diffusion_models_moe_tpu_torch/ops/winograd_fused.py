"""Fused Winograd F(2x2, 3x3) convolution: input transform, the 16 tensor-core
products and the inverse transform in one kernel, one read of x and one write
of y.

Counterpart of `diffusion_models_moe_tpu/ops/winograd_fused.py`. On CUDA
tensors `winograd3x3_fused` launches the hand-written kernel of
`csrc/winograd.cu` (a producer warpgroup that transforms the input while two
consumer warpgroups run wgmma products; x and the filter by TMA); how a
launch is cut into blocks is decided here, in `fused_plan`, a pure function
of the shape and the card's SM count that the CPU tests reach. On CPU
tensors it runs the plain PyTorch version beside it,
`winograd3x3_reference`, which repeats the kernel's arithmetic: the
transforms in f32, V and U rounded to the model dtype, f32 accumulation, the
result rounded to the model dtype, then the bias added in the model dtype.

Layouts. Tensors have this package's logical shapes, x (B, Cin, H, W) and
y (B, Cout, H, W). The kernel wants the Cin values of a pixel contiguous, so
on CUDA x must be in `torch.channels_last` memory format, and y comes out in
it. The filter goes in already transformed, `u` (16, Cout, Cin) from
`transform_filter` rounded to the model dtype: it is loop-invariant, and the
caller hoists it (`models/layers.py:WinoConv`). The even/odd column
de-interleave, the band stacking, the four output planes with their
transpose and the block plan of the JAX function are Mosaic's needs and have
no counterpart: the kernel reads each 4 x 4 input tile with its halo from x
itself and writes the 2 x 2 output pixels in place.

Forward only: no autograd.Function, no backward. Where autograd records a
call on the card (`_build.grad_through`), the model takes the plain version,
which is differentiable, and counts the call under `plain:winograd3x3_fused`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.ops.conv_chain_fused import split_depth
from diffusion_models_moe_tpu_torch.ops.winograd import (transform_filter,
                                                         winograd_conv3x3)

CL = torch.channels_last
# the kernel's tiling (csrc/winograd.cu: 2 * W_SIDE, W_BN, W_BK)
SQUARE = 16         # output pixels along a side of a block: 8 x 8 tiles of 2 x 2
COUT_TILE = 128     # output channels a block
CIN_CHUNK = 32      # input channels a depth chunk


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """How one launch of the fused Winograd kernel is cut into blocks. A
    block takes a square of `SQUARE` x `SQUARE` output pixels of one image
    (`blocks_y` x `blocks_x` squares cover an image, masked past its edge),
    `COUT_TILE` output channels (`cout_tiles` of them) and
    `chunks_per_split` consecutive Cin chunks of `CIN_CHUNK` channels: split
    `s` takes chunks [s * chunks_per_split, (s + 1) * chunks_per_split) of the
    `chunks`. With `split` > 1 the blocks write f32 partial planes and a
    second kernel adds them in the order s = 0, 1, ..."""
    blocks_y: int
    blocks_x: int
    cout_tiles: int
    chunks: int
    split: int
    chunks_per_split: int

    def blocks(self, batch: int) -> int:
        return (batch * self.blocks_y * self.blocks_x * self.cout_tiles
                * self.split)


@functools.lru_cache(maxsize=None)
def fused_plan(b: int, h: int, w: int, cin: int, cout: int, sms: int) -> FusedPlan:
    """The plan of `winograd3x3_fused` at this shape on a card with `sms`
    SMs: a pure function of its arguments (one block an SM; the split rule is
    the conv chain's, `split_depth`)."""
    blocks_y, blocks_x = -(-h // SQUARE), -(-w // SQUARE)
    cout_tiles, chunks = -(-cout // COUT_TILE), -(-cin // CIN_CHUNK)
    split, per = split_depth(b * blocks_y * blocks_x * cout_tiles, chunks, sms,
                             blocks_per_sm=1)
    return FusedPlan(blocks_y, blocks_x, cout_tiles, chunks, split, per)


def fused_ok(h: int, w: int, cin: int, cout: int) -> bool:
    """Shapes the kernel takes: the JAX kernel's scope (even H and W of at
    least 16, Cin >= 16, Cout >= 128), and channel counts that are multiples
    of the 16-byte vector (8 bf16)."""
    return (h % 2 == 0 and w % 2 == 0 and h >= 16 and w >= 16
            and cin >= 16 and cout >= 128 and cin % 8 == 0 and cout % 8 == 0)


def fused_filter(w: torch.Tensor) -> torch.Tensor:
    """w (Cout, Cin, 3, 3) -> u (16, Cout, Cin): the F(2x2) filter transform
    in f32, rounded to w's dtype."""
    return transform_filter(w, 2).to(w.dtype).contiguous()


def winograd3x3_reference(x: torch.Tensor, u: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: `ops/winograd.py`'s F(2x2)
    formulation on the hoisted filter."""
    y = winograd_conv3x3(x, u=u, tile=2)
    return y if bias is None else y + bias.to(y.dtype)[:, None, None]


def winograd3x3_fused(x: torch.Tensor, u: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      use_kernels: bool = True) -> torch.Tensor:
    """Stride-1 SAME 3x3 convolution as Winograd F(2x2, 3x3) [+ bias].

    x (B, Cin, H, W) with `fused_ok(H, W, Cin, Cout)`; u (16, Cout, Cin) from
    `fused_filter`; bias (Cout,) optional. Returns (B, Cout, H, W),
    channels-last on CUDA.

    `use_kernels=False` takes the plain version on CUDA too; it exists only
    for kernel-vs-plain comparisons."""
    b, cin, h, wd = x.shape
    cout = u.shape[1]
    if tuple(u.shape) != (16, cout, cin):
        raise ValueError(f"x {tuple(x.shape)} and u {tuple(u.shape)} do not "
                         "form an F(2x2, 3x3) convolution")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias {tuple(bias.shape)}: need ({cout},)")
    if not fused_ok(h, wd, cin, cout):
        raise ValueError(f"conv {cin}->{cout} at {h}x{wd}: see fused_ok")
    if x.device.type == "cpu" or not use_kernels:
        return winograd3x3_reference(x, u, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    dev, bf16 = x.device, torch.bfloat16
    _build.check_cuda_tensor("x", x, bf16, dev, contiguous=False)
    if not x.is_contiguous(memory_format=CL):
        raise ValueError("x must be in channels_last memory format")
    _build.check_cuda_tensor("u", u, bf16, dev)
    if bias is not None:
        _build.check_cuda_tensor("bias", bias, bf16, dev)
    y = torch.empty((b, cout, h, wd), device=dev, dtype=bf16, memory_format=CL)
    plan = fused_plan(b, h, wd, cin, cout, _build.sm_count(dev))
    partial = None
    if plan.split > 1:
        partial = torch.empty((plan.split, b, h, wd, cout), device=dev,
                              dtype=torch.float32)
    _build.load_library().call(
        "dmoe_winograd3x3", x.data_ptr(), u.data_ptr(),
        None if bias is None else bias.data_ptr(), b, h, wd, cin, cout,
        plan.blocks_x, plan.blocks_y, plan.split, plan.chunks_per_split,
        y.data_ptr(), None if partial is None else partial.data_ptr(),
        _build.stream_ptr(dev))
    _build.LAUNCHES["winograd3x3_fused"] += 1
    return y
