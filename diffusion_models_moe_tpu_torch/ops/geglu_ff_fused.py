"""Fused GEGLU-MoE feed-forward: LayerNorm, GEGLU, top-k expert routing,
masked product, output projection and residual.

Counterpart of `diffusion_models_moe_tpu/ops/geglu_ff_fused.py`. On a CUDA
tensor `geglu_ff_fused` launches the hand-written kernels of
`csrc/geglu_ff.cu`, wgmma GEMMs fed by TMA rings: the LayerNorm pass, the
dual GEMM with its GELU epilogue (`ff_up`), the routing stage of
`routing_kernel.py` (scores, selection, mask), and the output GEMM with its
bias and residual (`ff_down`, its depth split over blocks where the rows are
few). How each launch is cut into blocks is decided here, in `ff_plan`, a
pure function of the shape and the card's SM count that the CPU tests reach.
On a CPU tensor it runs `geglu_ff_reference`, the plain PyTorch version of
the same function. Weights use the nn.Linear layout:
W1 (2H, C) is `ff.net.0.proj.weight`, W2 (C, H) is `ff.net.2.weight`.

Routing semantics are those of the JAX kernel and `taps.routing_mask`:
score[n, e] = sum of the post-GELU gate (rounded to the model dtype) over
expert e's neurons, accumulated in f32; experts with score >= the kth
largest are kept, ties included.

Forward only: no autograd.Function, no backward. Where autograd records a
call on the card (`_build.grad_through`), the model takes the plain version,
which is differentiable, and counts the call under `plain:geglu_ff_fused`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.ops.routing_kernel import (
    DEPTH_CHUNK, RoutePlan, route_plan, route_scratch_bytes)

# the kernels' tiling (csrc/geglu_ff.cu: UP_BN; csrc/down_gemm.cuh: ROWS_WG,
# DOWN_BN, BK)
WG_ROWS = 64        # rows of a consumer warpgroup
UP_COLS = 128       # h and g columns an ff_up block
DOWN_COLS = 160     # output channels an ff_down block


@dataclasses.dataclass(frozen=True)
class FFPlan:
    """How the launches of one `geglu_ff_fused` call are cut into blocks.
    ff_up: tiles of `up_wgs` consumer warpgroups of WG_ROWS rows
    (`up_row_tiles` row tiles) x UP_COLS columns of h and g (`up_col_tiles`),
    the whole C depth, dealt in turn to `up_ctas` persistent blocks. The
    routing stage: `route` (None unrouted).
    ff_down: `down_wgs` warpgroups (`down_row_tiles`) x `down_col_tiles`
    tiles of DOWN_COLS output channels x `down_split` parts of
    `down_chunks_per_split` of the `down_chunks` depth chunks of DEPTH_CHUNK;
    with more than one part, f32 parts added in the order 0, 1, ... by a
    second kernel."""
    up_wgs: int
    up_row_tiles: int
    up_col_tiles: int
    up_ctas: int
    route: Optional[RoutePlan]
    down_wgs: int
    down_row_tiles: int
    down_col_tiles: int
    down_chunks: int
    down_split: int
    down_chunks_per_split: int

    @property
    def up_tiles(self) -> int:
        return self.up_row_tiles * self.up_col_tiles

    @property
    def down_blocks(self) -> int:
        return self.down_row_tiles * self.down_col_tiles * self.down_split


@functools.lru_cache(maxsize=None)
def ff_plan(n: int, c: int, hdim: int, e: int, sms: int) -> FFPlan:
    """The plan of `geglu_ff_fused` for N rows, C channels, H = hdim neurons
    and `e` experts (0: unrouted) on a card with `sms` SMs: a pure function
    of its arguments. ff_up never splits its depth (its epilogue is not
    linear), so its result for a row does not depend on N; the depth splits
    of ff_down and of the routing scores do (they follow N to fill the
    card), so a row's output may differ in its last bits between two N, and
    at one N does not depend on the other rows."""
    # ff_up: two consumer warpgroups a tile (128 rows) where that still
    # gives every SM a tile; ff_down: see down_cut
    up_cols = -(-hdim // UP_COLS)
    up_wgs = 2 if -(-n // (2 * WG_ROWS)) * up_cols >= sms else 1
    chunks = hdim // DEPTH_CHUNK
    down_wgs, down_rows, down_cols, split, per = down_cut(n, c, chunks, sms)
    route = route_plan(n, hdim, e, sms) if e else None
    up_rows = -(-n // (WG_ROWS * up_wgs))
    return FFPlan(up_wgs, up_rows, up_cols, min(up_rows * up_cols, sms), route,
                  down_wgs, down_rows, down_cols, chunks, split, per)


def down_cut(n: int, c: int, chunks: int,
             sms: int) -> tuple[int, int, int, int, int]:
    """How the output GEMM of `csrc/down_gemm.cuh` (ff_down here, kernel 6's
    out projection in `attn_absorb_fused.absorb_plan`) is cut for N rows, C
    output channels and a depth of `chunks` chunks of DEPTH_CHUNK on `sms`
    SMs: (warpgroups a block, row tiles, column tiles of DOWN_COLS, depth
    parts, chunks a part). Two warpgroups wherever there are more than 64
    rows; the depth split only where the blocks leave half the SMs idle,
    and then to one wave at most (a block fills an SM's shared memory)."""
    cols = -(-c // DOWN_COLS)
    wgs = 2 if n > WG_ROWS else 1
    rows = -(-n // (WG_ROWS * wgs))
    blocks, split, per = rows * cols, 1, chunks
    if 2 * blocks <= sms:
        per = -(-chunks // (sms // blocks))
        split = -(-chunks // per)
    return wgs, rows, cols, split, per


def fused_ff_ok(n: int, c: int, hidden: int, e: int = 0,
                dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the kernels take an FF of N rows, C channels and H = hidden
    neurons with `e` experts (0: no routing) in `dtype`: bf16, C % 32 == 0,
    H % 64 == 0, at most 256 experts. The counterpart of JAX's `fused_ff_ok`,
    asked by the model before `geglu_ff_fused` on a CUDA tensor."""
    return (dtype == torch.bfloat16 and n >= 1 and c % 32 == 0
            and hidden % 64 == 0 and 0 <= e <= 256)


def reference_gate(x2d, w1, b1, relu, ln_scale, ln_bias, eps):
    """(h, ga) of the plain version in f32: LN (fast variance, rsqrt folded
    into the scale, output rounded to x2d.dtype), the dual projection and
    the exact-GELU (or ReLU) gate."""
    dt = x2d.dtype
    xd = x2d
    if ln_scale is not None:
        xr = x2d.float()
        mu = xr.mean(-1, keepdim=True)
        var = ((xr * xr).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        mul = torch.rsqrt(var + eps) * ln_scale.float()
        xd = ((xr - mu) * mul + ln_bias.float()).to(dt)
    hdim = w1.shape[0] // 2
    hg = xd.float() @ w1.float().t()
    h = hg[:, :hdim] + b1[:hdim].float()
    g = hg[:, hdim:] + b1[hdim:].float()
    ga = torch.relu(g) if relu else g * 0.5 * (1.0 + torch.erf(g * 2.0 ** -0.5))
    return h, ga


def reference_selection(ga: torch.Tensor, patterns: torch.Tensor, k: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """(N, E) 0/1 experts kept by the plain version: score = gate rounded to
    `dtype` summed over each expert's neurons in f32, kept iff >= kth."""
    s = ga.to(dtype).float() @ patterns.to(dtype).float().t()
    kth = torch.topk(s, k, dim=-1).values[:, -1:]
    return (s >= kth).float()


def geglu_ff_reference(x2d: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                       w2: torch.Tensor, b2: torch.Tensor,
                       patterns: Optional[torch.Tensor] = None, k: int = 0,
                       relu: bool = False,
                       ln_scale: Optional[torch.Tensor] = None,
                       ln_bias: Optional[torch.Tensor] = None,
                       eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: f32 arithmetic, with the kernel's rounding to
    x2d.dtype at the same points (LN output, gate before the expert score,
    the h*gate product, the output, and the residual sum)."""
    dt = x2d.dtype
    h, ga = reference_gate(x2d, w1, b1, relu, ln_scale, ln_bias, eps)
    if patterns is not None:
        ga = ga * (reference_selection(ga, patterns, k, dt) @ patterns.float())
    prod = (h * ga).to(dt)
    y = (prod.float() @ w2.float().t() + b2.float()).to(dt)
    return x2d + y if ln_scale is not None else y


def geglu_ff_fused(x2d: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor,
                   patterns: Optional[torch.Tensor] = None, k: int = 0,
                   relu: bool = False,
                   ln_scale: Optional[torch.Tensor] = None,
                   ln_bias: Optional[torch.Tensor] = None,
                   eps: float = 1e-5, use_kernels: bool = True) -> torch.Tensor:
    """x2d (N, C) -> GEGLU FF (+ top-k routing over `patterns` (E, H)).
    With ln_scale/ln_bias (C,) f32 returns x2d + ff(layernorm(x2d)). On
    CUDA, `patterns` must already be bf16 on x2d's device (see
    `build_moe_interventions(dtype=...)`): the kernel takes it as it is.
    The kernels write the masked product as bf16(bf16(h*ga) * m), the plain
    version's bf16(h*ga*m) bit for bit where each pattern column holds at
    most two ones (every pattern the model builds), within one bf16 unit in
    the last place elsewhere.

    `use_kernels=False` takes the plain version on CUDA too; it exists only
    for kernel-vs-plain comparisons."""
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("ln_scale and ln_bias go together")
    if patterns is not None and not 1 <= k <= patterns.shape[0]:
        raise ValueError(f"k={k} outside [1, {patterns.shape[0]}]")
    if x2d.device.type == "cpu" or not use_kernels:
        return geglu_ff_reference(x2d, w1, b1, w2, b2, patterns, k, relu,
                                  ln_scale, ln_bias, eps)
    if x2d.device.type != "cuda":
        raise ValueError(f"no kernel for device {x2d.device}")
    n, c = x2d.shape
    hdim = w1.shape[0] // 2
    dev, bf16 = x2d.device, torch.bfloat16
    for name, t in (("x2d", x2d), ("w1", w1), ("b1", b1), ("w2", w2),
                    ("b2", b2)):
        _build.check_cuda_tensor(name, t, bf16, dev)
    if (tuple(w1.shape) != (2 * hdim, c) or tuple(b1.shape) != (2 * hdim,)
            or tuple(w2.shape) != (c, hdim) or tuple(b2.shape) != (c,)):
        raise ValueError(f"shapes x{tuple(x2d.shape)} w1{tuple(w1.shape)} "
                         f"b1{tuple(b1.shape)} w2{tuple(w2.shape)} "
                         f"b2{tuple(b2.shape)} do not form a GEGLU FF")
    if c % 32 or hdim % 64:
        raise ValueError(f"kernel needs C % 32 == 0 and H % 64 == 0, got "
                         f"C={c}, H={hdim}")
    if ln_scale is not None:
        _build.check_cuda_tensor("ln_scale", ln_scale, torch.float32, dev)
        _build.check_cuda_tensor("ln_bias", ln_bias, torch.float32, dev)
    plan = ff_plan(n, c, hdim, 0 if patterns is None else patterns.shape[0],
                   _build.sm_count(dev))
    prod, partial = _launch_front(
        x2d, w1, b1, patterns, k, relu, ln_scale, ln_bias, eps, plan,
        4 * plan.down_split * n * c if plan.down_split > 1 else 0)
    y = torch.empty((n, c), device=dev, dtype=bf16)
    _build.load_library().call(
        "dmoe_ff_down", prod.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        x2d.data_ptr() if ln_scale is not None else None, n, c, hdim,
        plan.down_wgs, plan.down_split, plan.down_chunks_per_split, partial,
        y.data_ptr(), _build.stream_ptr(dev))
    _build.LAUNCHES["geglu_ff_fused"] += 1
    return y


def _launch_front(x2d, w1, b1, patterns, k, relu, ln_scale, ln_bias, eps,
                  plan: FFPlan, down_bytes: int = 0) -> tuple[torch.Tensor, int]:
    """The LN pass, ff_up and the routing stage on checked CUDA tensors.
    Every scratch of the call is one allocation; returns prod (N, H), a view
    of it, and the address of `down_bytes` more of it (ff_down's parts)."""
    n, c = x2d.shape
    hdim = w1.shape[0] // 2
    dev, bf16 = x2d.device, torch.bfloat16
    route, e = plan.route, 0
    if patterns is not None:
        e = patterns.shape[0]
        if e > 256 or tuple(patterns.shape) != (e, hdim):
            raise ValueError(f"patterns {tuple(patterns.shape)}: need "
                             f"(E, {hdim}) with E <= 256")
        _build.check_cuda_tensor("patterns", patterns, bf16, dev)
    nh = n * hdim
    sizes = [2 * n * c if ln_scale is not None else 0, 2 * nh, down_bytes]
    if route is not None:
        sizes += [2 * nh, 2 * nh, *route_scratch_bytes(n, route)]
    buf, ptrs = _build.scratch(dev, sizes)
    ptrs += [None] * (7 - len(ptrs))
    xn, prod_at, down, ga, hg, partial, sel = ptrs
    at = prod_at - buf.data_ptr()
    prod = buf[at:at + 2 * nh].view(bf16).view(n, hdim)
    _build.load_library().call(
        "dmoe_ff_front", x2d.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        None if ln_scale is None else ln_scale.data_ptr(),
        None if ln_bias is None else ln_bias.data_ptr(), eps,
        None if patterns is None else patterns.data_ptr(), e, k, n, c, hdim,
        int(relu), plan.up_wgs, plan.up_ctas, route.split if route else 1,
        route.chunks_per_split if route else 1,
        route.tiles_per_group if route else 1, xn, ga, hg, partial, sel,
        prod_at, _build.stream_ptr(dev))
    return prod, down


def kernel_selection(x2d, w1, b1, patterns, k, relu=False, ln_scale=None,
                     ln_bias=None, eps=1e-5) -> torch.Tensor:
    """(N, E) 0/1 experts the CUDA routing stage kept, read back from its
    masked product (an expert counts as kept when any of its neurons is
    nonzero there). For kernel-vs-plain comparisons only: these launches
    are not counted."""
    n, c = x2d.shape
    plan = ff_plan(n, c, w1.shape[0] // 2, patterns.shape[0],
                   _build.sm_count(x2d.device))
    prod, _ = _launch_front(x2d, w1, b1, patterns, k, relu, ln_scale,
                            ln_bias, eps, plan)
    return ((prod != 0).float() @ patterns.float().t() > 0).float()
