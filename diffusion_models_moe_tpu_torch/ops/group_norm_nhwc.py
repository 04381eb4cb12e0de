"""GroupNorm of a channels-last bf16 activation in one hand-written pass:
bf16 in and out, f32 statistics, the resblock's time bias added before it
and SiLU after it, fused.

No counterpart in the JAX package, which leaves GroupNorm to XLA. In PyTorch
the same sequence (`models/layers.py:group_norm`'s plain path: + bias in the
activation dtype, `F.group_norm` on an f32 copy, SiLU in f32, the cast back)
is five passes over the tensor, and its NCHW output costs cuDNN a transpose
in front of every conv that reads it. On CUDA tensors `group_norm_nhwc`
launches the kernel of `csrc/group_norm.cu` (a statistics pass and an apply
pass: one read of x, one more read and one write, 6 bytes an element); its
output is channels-last, so the resblocks, `Transformer2D` and the VAE keep
their activations in that format from `conv_in` to `conv_out`. On CPU
tensors, and with `use_kernels=False`, it runs the plain version beside it,
`group_norm_nhwc_reference`. How a launch is cut into blocks is decided here,
in `gn_plan`, a pure function of an image's pixel count and the channel
count that the CPU tests reach: a sample's result does not depend on the
batch it is in.

Forward only: no autograd.Function, no backward. `group_norm_ok` says no
where autograd records the call (`_build.grad_through`), and the model takes
the plain version, which is differentiable.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.ops import _build

CL = torch.channels_last
VEC = 8              # bf16 channels a 16-byte vector (csrc: GN_VEC)
THREADS = 512        # most threads a block (csrc: GN_THREADS)
MAX_GROUPS = 512     # csrc: GN_MAX_GROUPS
MAX_PARTS = 4096     # tiles x groups an image (csrc: GN_MAX_PARTS)
# A block's share of an image: about this many elements (256 KB of bf16:
# fewer, larger blocks pay the fixed costs of a block less often), at most
# MAX_TILES tiles an image and MAX_PARTS partials (every block of the apply
# pass merges its image's tiles x groups), and at least MIN_TILES where the
# image has the pixels (so that small images still spread over the card).
# Times of the alternatives on the card: PERF.md, section 6.
BLOCK_ELEMS = 131072
MAX_TILES = 64
MIN_TILES = 16


@dataclasses.dataclass(frozen=True)
class GNPlan:
    """How one launch is cut into blocks: an image's `hw` pixels are
    `tiles` tiles of `pixels` consecutive pixels (the last one shorter), a
    block each; a block of `rows` x C/8 threads takes `rows` pixels at a
    time, a 16-byte vector of 8 channels a thread."""
    rows: int
    pixels: int
    tiles: int


@functools.lru_cache(maxsize=None)
def gn_plan(hw: int, c: int, groups: int) -> GNPlan:
    """The plan at an image of `hw` pixels and `c` channels in `groups`
    groups: a pure function of its arguments, never of the batch."""
    rows = max(1, THREADS // (c // VEC))
    tiles = max(-(-hw * c // BLOCK_ELEMS), MIN_TILES)
    tiles = max(1, min(tiles, MAX_TILES, MAX_PARTS // groups,
                       -(-hw // rows)))
    pixels = -(-hw // tiles)
    return GNPlan(rows, pixels, -(-hw // pixels))


def group_norm_ok(x: torch.Tensor, groups: int, *params) -> bool:
    """Whether the kernel takes GroupNorm of x in `groups` groups: a bf16
    (B, C, H, W) tensor on the card, C a multiple of `groups` and of the
    16-byte vector, a pixel's channels in one row of a block (C <= 4096),
    at most MAX_GROUPS groups, and no gradient recorded through x or
    `params` (the affine, the bias)."""
    if not (_build.on_card(x) and x.dtype == torch.bfloat16 and x.dim() == 4):
        return False
    c = x.shape[1]
    return (c % groups == 0 and c % VEC == 0 and c <= VEC * THREADS
            and groups <= MAX_GROUPS and not _build.grad_through(x, *params))


def group_norm_nhwc_reference(x, gamma, beta, groups: int, eps: float, *,
                              silu: bool, bias=None) -> torch.Tensor:
    """Plain PyTorch version: x + bias in x's dtype, GroupNorm in f32 on f32
    parameters, SiLU in f32, rounded to x's dtype once."""
    if bias is not None:
        x = x + bias[:, :, None, None]
    h = F.group_norm(x.float(), groups, gamma, beta, eps)
    return (F.silu(h) if silu else h).to(x.dtype)


def group_norm_nhwc(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    groups: int, eps: float, *, silu: bool,
                    bias: Optional[torch.Tensor] = None,
                    use_kernels: bool = True) -> torch.Tensor:
    """silu?(GroupNorm(x + bias)) in x's dtype.

    x (B, C, H, W); gamma, beta (C,) f32; bias (B, C) in x's dtype or None,
    added to x before the statistics (the resblock's time embedding). On
    CUDA x is taken in any memory format (channels-last reads it without a
    copy) and y comes out channels-last. Raises on what the kernel does not
    take; the model asks `group_norm_ok` first.

    `use_kernels=False` takes the plain version on CUDA too; it exists only
    for kernel-vs-plain comparisons."""
    if x.device.type == "cpu" or not use_kernels:
        return group_norm_nhwc_reference(x, gamma, beta, groups, eps,
                                         silu=silu, bias=bias)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    b, c, h, w = x.shape
    if c % groups or c % VEC or c > VEC * THREADS or groups > MAX_GROUPS:
        raise ValueError(f"{c} channels in {groups} groups: see group_norm_ok")
    dev, bf16 = x.device, torch.bfloat16
    x = x.contiguous(memory_format=CL)
    _build.check_cuda_tensor("x", x, bf16, dev, contiguous=False)
    for name, t in (("gamma", gamma), ("beta", beta)):
        _build.check_cuda_tensor(name, t, torch.float32, dev)
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} {tuple(t.shape)}: need ({c},)")
    if bias is not None:
        _build.check_cuda_tensor("bias", bias, bf16, dev)
        if tuple(bias.shape) != (b, c):
            raise ValueError(f"bias {tuple(bias.shape)}: need ({b}, {c})")
    plan = gn_plan(h * w, c, groups)
    part = b * groups * plan.tiles * 4
    buf, (mean, m2) = _build.scratch(dev, (part, part))
    y = torch.empty((b, c, h, w), device=dev, dtype=bf16, memory_format=CL)
    _build.load_library().call(
        "dmoe_group_norm_nhwc", x.data_ptr(),
        None if bias is None else bias.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), b, h * w, c, groups, plan.rows, plan.pixels,
        plan.tiles, float(eps), int(silu), mean, m2, y.data_ptr(),
        _build.stream_ptr(dev))
    _build.LAUNCHES["group_norm_nhwc"] += 1
    return y
