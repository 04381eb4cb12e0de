"""Fused MoE routing: score -> top-k select -> mask -> gate multiply.

Counterpart of `diffusion_models_moe_tpu/ops/routing_kernel.py`. The FF
layer takes it on its unfused path (taps collecting, neuron masks, output
weight masks), where hidden and the activated gate exist as tensors:

    score = gate @ patterns^T            (f32 accumulation)
    sel_e = |{e' : score_e' > score_e}| < k   (ties kept)
    out   = hidden * gate * (sel @ patterns)

On a CUDA tensor `fused_route_multiply` launches the hand-written kernels of
`csrc/geglu_ff.cu` (`dmoe_route_multiply`: the routing stage of the fused
FF, with hidden and the gate read as bf16): the scores `gate @ patterns^T` as
a wgmma GEMM, the selection 8 or 32 lanes a row, the mask `sel @ patterns` by
wgmma beside the product. How the launches are cut into blocks is decided
here, in `route_plan`, a pure function of the shape and the card's SM count
that the CPU tests reach. On a CPU tensor it runs `route_multiply_reference`,
the plain PyTorch version.

Inference only: no autograd.Function, no backward.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.taps import routing_mask


ROWS = 64           # rows a block of the score kernel
MASK_ROWS = 128     # rows a block of the mask kernel (two warpgroups)
DEPTH_CHUNK = 64    # hidden columns a stage of the score kernel's ring
MASK_TILE = 64      # hidden columns a tile of the mask kernel
EXPERT_TILE = 64    # experts a product of the score kernel


def spread(row_tiles: int, pieces: int, sms: int) -> tuple[int, int]:
    """(parts, per): `pieces` consecutive pieces (depth chunks or column
    tiles) dealt to `parts` blocks of each row tile, `per` to a block, the
    last part possibly shorter but never empty. One part while the row tiles
    alone give more than half the SMs a block; otherwise enough parts that
    the row tiles times the parts reach `sms`, where the pieces allow it."""
    if 2 * row_tiles > sms:
        return 1, pieces
    per = max(1, pieces // -(-sms // row_tiles))
    return -(-pieces // per), per


@dataclasses.dataclass(frozen=True)
class RoutePlan:
    """How the routing stage is cut into blocks. Scores: a block takes ROWS
    rows (`row_tiles` of them), all experts (`e_tiles` products of
    EXPERT_TILE, so E is padded to `epad`) and `chunks_per_split` of the
    `chunks` depth chunks of DEPTH_CHUNK; `split` parts are written apart and
    added in the order 0, 1, ... by the selection (8 or 32 lanes a row).
    Mask: a block takes MASK_ROWS rows (`mask_row_tiles` of them) and
    `tiles_per_group` of the `col_tiles` tiles of MASK_TILE hidden columns,
    `groups` blocks a row tile."""
    row_tiles: int
    e_tiles: int
    chunks: int
    split: int
    chunks_per_split: int
    mask_row_tiles: int
    col_tiles: int
    groups: int
    tiles_per_group: int

    @property
    def epad(self) -> int:
        return EXPERT_TILE * self.e_tiles

    @property
    def score_blocks(self) -> int:
        return self.row_tiles * self.split

    @property
    def mask_blocks(self) -> int:
        return self.mask_row_tiles * self.groups


MASK_BLOCK_COST = 1  # a mask block's set-up, in column tiles


def in_rounds(row_tiles: int, pieces: int, sms: int,
              slots: int) -> tuple[int, int]:
    """(parts, per) as `spread` gives them, for a kernel of which `slots`
    blocks run at once on `sms` SMs: the run of `per` pieces a block that
    takes the fewest rounds x (pieces + set-up) a block; among those, the
    one that gives the most SMs a block, then the fewest rounds."""
    best = None
    for per in range(1, pieces + 1):
        parts = -(-pieces // per)
        blocks = row_tiles * parts
        rounds = -(-blocks // slots)
        key = (rounds * (per + MASK_BLOCK_COST), -min(blocks, sms), rounds)
        if best is None or key < best[0]:
            best = (key, parts, per)
    return best[1], best[2]


def mask_blocks_per_sm(e: int) -> int:
    """Blocks of the mask kernel an SM holds (csrc/geglu_ff.cu: MaskCfg):
    two at E <= 64, one otherwise."""
    return 2 if e <= EXPERT_TILE else 1


@functools.lru_cache(maxsize=None)
def route_plan(n: int, hdim: int, e: int, sms: int) -> RoutePlan:
    """The plan of the routing stage (kernel 4, and launch 2 of the fused FF)
    for N rows, H = hdim hidden columns and `e` experts on a card with `sms`
    SMs: a pure function of its arguments. The score split depends on N, so
    a row's scores (and where two experts nearly tie, its selection) may
    differ in their last bits between two N; at one N they do not depend on
    the other rows."""
    row_tiles = -(-n // ROWS)
    chunks = hdim // DEPTH_CHUNK
    split, per = spread(row_tiles, chunks, sms)
    mask_rows = -(-n // MASK_ROWS)
    col_tiles = hdim // MASK_TILE
    groups, tiles = in_rounds(mask_rows, col_tiles, sms,
                              sms * mask_blocks_per_sm(e))
    return RoutePlan(row_tiles, -(-e // EXPERT_TILE), chunks, split, per,
                     mask_rows, col_tiles, groups, tiles)


def route_scratch_bytes(n: int, plan: RoutePlan) -> tuple[int, int]:
    """Bytes of the f32 score parts (split, N, epad) and of the selection
    (N, epad) bf16."""
    return 4 * plan.split * n * plan.epad, 2 * n * plan.epad


def route_kernel_ok(hidden: int, e: int,
                    dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the kernel takes H = hidden neurons and `e` experts in
    `dtype`: bf16, E <= 256, H % 64 == 0. Asked by the model before
    `fused_route_multiply` on a CUDA tensor."""
    return dtype == torch.bfloat16 and 1 <= e <= 256 and hidden % 64 == 0


def route_multiply_reference(hidden: torch.Tensor, gate: torch.Tensor,
                             patterns: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version: scores in f32 over the gate as given, threshold
    selection, and `hidden * gate` rounded to the gate's dtype before the
    0/1 mask, as the JAX kernel rounds it."""
    mask, _ = routing_mask(gate.reshape(-1, gate.shape[-1]), patterns, k)
    return hidden * gate * mask.reshape(gate.shape)


def fused_route_multiply(hidden: torch.Tensor, gate: torch.Tensor,
                         patterns: torch.Tensor, k: int,
                         use_kernels: bool = True) -> torch.Tensor:
    """hidden, gate: (N, H), the gate already activated; patterns: (E, H)
    0/1. Returns hidden * gate * topk_mask (N, H). On CUDA all three must be
    bf16 on one device, with E <= 256 and H % 64 == 0; gate and patterns
    contiguous, hidden with unit column stride (a view of the first half of
    the FF's (N, 2H) projection is read in place).

    `use_kernels=False` takes the plain version on CUDA too; it exists only
    for kernel-vs-plain comparisons."""
    if not 1 <= k <= patterns.shape[0]:
        raise ValueError(f"k={k} outside [1, {patterns.shape[0]}]")
    if hidden.device.type == "cpu" or not use_kernels:
        return route_multiply_reference(hidden, gate, patterns, k)
    if hidden.device.type != "cuda":
        raise ValueError(f"no kernel for device {hidden.device}")
    n, hdim = gate.shape
    e = patterns.shape[0]
    dev, bf16 = hidden.device, torch.bfloat16
    _build.check_cuda_tensor("hidden", hidden, bf16, dev, contiguous=False)
    for name, t in (("gate", gate), ("patterns", patterns)):
        _build.check_cuda_tensor(name, t, bf16, dev)
    if tuple(hidden.shape) != (n, hdim) or tuple(patterns.shape) != (e, hdim):
        raise ValueError(f"hidden {tuple(hidden.shape)}, gate {(n, hdim)}, "
                         f"patterns {tuple(patterns.shape)}: need (N, H), "
                         "(N, H), (E, H)")
    if (hidden.stride(1) != 1 or hidden.stride(0) < hdim
            or hidden.stride(0) % 8):
        raise ValueError(f"hidden strides {hidden.stride()}: need unit "
                         "column stride and rows apart by at least H, a "
                         "multiple of 8 elements (16 bytes)")
    if e > 256 or hdim % 64:
        raise ValueError(f"kernel needs E <= 256 and H % 64 == 0, got E={e}, "
                         f"H={hdim}")
    plan = route_plan(n, hdim, e, _build.sm_count(dev))
    out = torch.empty((n, hdim), device=dev, dtype=bf16)
    buf, (partial, sel) = _build.scratch(dev, route_scratch_bytes(n, plan))
    _build.load_library().call(
        "dmoe_route_multiply", hidden.data_ptr(), hidden.stride(0),
        gate.data_ptr(), patterns.data_ptr(), n, hdim, e, k, plan.split,
        plan.chunks_per_split, plan.tiles_per_group, partial, sel,
        out.data_ptr(), _build.stream_ptr(dev))
    _build.LAUNCHES["fused_route_multiply"] += 1
    return out
