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
through a row stride (heads dense, rows evenly spaced: kernel 2's output
and a column third of kernel 5's are). Weights use the nn.Linear layout
(out, in): `attn1.to_q.weight`, ..., `attn1.to_out.0.weight`; they are
passed as they are, nothing is concatenated or padded per call.

How each launch is cut into blocks is decided here, in `absorb_plan`, a
pure function of the shape and the card's SM count that the CPU tests
reach; the kernels (wgmma GEMMs fed by TMA rings, `csrc/attn_absorb.cu`)
take it as it is.

Forward only: no autograd.Function, no backward. Where autograd records a
call on the card (`_build.grad_through`), the model takes the plain version,
which is differentiable, and counts the call under `plain:ln_qkv_fused` and `plain:attn_out_residual_fused`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.ops.geglu_ff_fused import (
    DEPTH_CHUNK, WG_ROWS, down_cut)
from diffusion_models_moe_tpu_torch.ops.sd_flash import self_attention

# kernel 5's layout (csrc/attn_absorb.cu): 160-column output tiles, weight
# tiles of 160 x 64 bf16 through the ring, the epilogue's staging in boxes
# of 64 rows x 32 columns (five a tile), 227 KB of shared memory a block
QKV_COLS = 160
W_TILE_BYTES = QKV_COLS * DEPTH_CHUNK * 2
BOX_BYTES = WG_ROWS * 32 * 2
BOXES = QKV_COLS // 32
SMEM_BUDGET = 232448
MAX_STAGES = 4


def qkv_smem(wgs: int, c: int, stages: int, boxes: int = BOXES) -> int:
    """Shared-memory bytes of a kernel 5 block: the normalised panel of
    64 wgs rows x C (128-byte rows of 64 columns), the weight ring, the
    staging of `boxes` boxes a warpgroup, and 2 KB of barriers and alignment
    (csrc/attn_absorb.cu:qkv_smem)."""
    panel = -(-c // DEPTH_CHUNK) * wgs * WG_ROWS * 128
    return panel + stages * W_TILE_BYTES + wgs * boxes * BOX_BYTES + 2048


def qkv_stages(wgs: int, c: int, boxes: int = BOXES) -> int:
    """The deepest weight ring (at most MAX_STAGES) that fits beside the
    panel of `wgs` warpgroups at C channels and the staging."""
    return min(MAX_STAGES,
               (SMEM_BUDGET - qkv_smem(wgs, c, 0, boxes)) // W_TILE_BYTES)


@dataclasses.dataclass(frozen=True)
class AbsorbPlan:
    """How one launch of kernel 5 (`kind` "qkv") or kernel 6 ("out") is cut
    into blocks. A block has `wgs` consumer warpgroups and owns 64 wgs rows
    (`row_tiles` row tiles); the output columns are `col_tiles` tiles
    (kernel 5: ceil(C / 160) in each of q, k and v; kernel 6: ceil(C / 160)
    of the C channels), of which a block takes a run of `run`; the C depth
    is `chunks` chunks of 64, in `split` parts of `chunks_per_split`
    (kernel 6 only: with more than one part, f32 parts added in the order
    0, 1, ... by a second kernel). `stages`: kernel 5's weight ring, and
    `boxes` the 64 x 32 boxes of its epilogue's staging a warpgroup (all
    five of a tile, or one at a time where five would cost the ring a
    stage); kernel 6's ring is fixed by its warpgroups in
    csrc/down_gemm.cuh (0 and 0 here)."""
    kind: str
    wgs: int
    row_tiles: int
    col_tiles: int
    run: int
    chunks: int
    split: int
    chunks_per_split: int
    stages: int
    boxes: int

    @property
    def rows(self) -> int:
        return WG_ROWS * self.wgs

    @property
    def groups(self) -> int:
        return -(-self.col_tiles // self.run)

    @property
    def blocks(self) -> int:
        return self.row_tiles * self.groups * self.split


@functools.lru_cache(maxsize=None)
def absorb_plan(kind: str, n: int, c: int, sms: int) -> AbsorbPlan:
    """The plan of `ln_qkv_fused` ("qkv") or `attn_out_residual_fused`
    ("out") for N = B*S rows and C channels on a card with `sms` SMs: a pure
    function of its arguments.

    Kernel 5: two warpgroups (128-row panels, each weight tile serving both)
    where there are more than 64 rows and the panel leaves room for a ring
    of three stages (C <= 448), else one; the staging one box at a time
    where all five would leave the ring fewer than three stages (C = 1280);
    where the row panels leave half
    the SMs idle, each panel's 3 ceil(C / 160) column tiles are shared out
    over as many blocks as the SMs hold (the panel loaded and normalised in
    each), else a block takes them all. It never splits its depth, so a
    row's result does not depend on N. Raises where a 64-row panel and a
    two-stage ring do not fit (C > 1408).

    Kernel 6: the cut of `geglu_ff_fused.down_cut`: a depth split where the
    blocks leave half the SMs idle, so a row's bits may depend on N but at
    one N not on the other rows."""
    chunks = -(-c // DEPTH_CHUNK)
    if kind == "out":
        wgs, rows, cols, split, per = down_cut(n, c, chunks, sms)
        return AbsorbPlan(kind, wgs, rows, cols, 1, chunks, split, per, 0, 0)
    if kind != "qkv":
        raise ValueError(f"kind {kind!r}: 'qkv' or 'out'")
    wgs = 2 if n > WG_ROWS and qkv_stages(2, c) >= 3 else 1
    boxes = BOXES if qkv_stages(wgs, c) >= 3 else 1
    stages = qkv_stages(wgs, c, boxes)
    if stages < 2:
        raise ValueError(f"C={c}: a 64-row panel and a two-stage weight ring "
                         "exceed a block's shared memory (the kernel takes "
                         "C <= 1408)")
    rows = -(-n // (WG_ROWS * wgs))
    cols = 3 * -(-c // QKV_COLS)
    run = cols
    if 2 * rows <= sms:
        run = -(-cols // min(cols, sms // rows))
    return AbsorbPlan(kind, wgs, rows, cols, run, chunks, 1, chunks, stages,
                      boxes)


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
    (B, S, 3C) tensor (see the module docstring), and C is at most 1408
    (`absorb_plan`).

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
    plan = absorb_plan("qkv", b * s, c, _build.sm_count(dev))
    y = torch.empty((b, s, 3 * c), device=dev, dtype=bf16)
    _build.load_library().call(
        "dmoe_ln_qkv", x.data_ptr(), wq.data_ptr(), wk.data_ptr(),
        wv.data_ptr(), None if ln_scale is None else ln_scale.data_ptr(),
        None if ln_bias is None else ln_bias.data_ptr(), eps, b * s, c,
        plan.wgs, plan.stages, plan.run, plan.boxes, y.data_ptr(),
        _build.stream_ptr(dev))
    _build.LAUNCHES["ln_qkv_fused"] += 1
    return tuple(_heads4(y[..., t * c:(t + 1) * c], heads) for t in range(3))


def attn_out_residual_reference(o, w, bias, residual):
    """Plain PyTorch version: o (B, S, H, D) flattened to rows of H*D, the
    projection and bias in f32, rounded to residual.dtype, plus the residual
    in that dtype."""
    b, s = o.shape[:2]
    y = o.reshape(b, s, -1).float() @ w.float().t() + bias.float()
    return residual + y.to(residual.dtype)


def row_stride(o: torch.Tensor) -> Optional[int]:
    """The elements between consecutive rows (b, s) of o (B, S, H, D) where
    kernel 6 can read o as C = H*D contiguous values a row at one stride:
    heads dense (strides (., ., D, 1)) and rows evenly spaced (stride(b) =
    S stride(s)), the stride a multiple of 8 and at least C. None
    otherwise."""
    b, s, h, d = o.shape
    st = o.stride()
    if (d > 1 and st[3] != 1) or (h > 1 and st[2] != d):
        return None
    if s > 1:
        ld = st[1]
        if b > 1 and st[0] != s * ld:
            return None
    else:
        ld = st[0] if b > 1 else h * d
    return ld if ld % 8 == 0 and ld >= h * d else None


def attn_out_residual_fused(o: torch.Tensor, w: torch.Tensor,
                            bias: torch.Tensor, residual: torch.Tensor,
                            use_kernels: bool = True) -> torch.Tensor:
    """o (B, S, H, D), the flash output; w (C, C) in the nn.Linear layout
    with C = H*D; bias (C,); residual (B, S, C). Returns
    residual + (o w^T + bias), (B, S, C).

    On CUDA the kernel reads o through one row stride (`row_stride`): the
    heads must be dense and the rows evenly spaced, as kernel 2's output
    and a column third of kernel 5's output are; it raises on another
    layout (the plain attention's output, an einsum's permuted view, is
    not head-dense: `absorbed_self_attention` hands that one over
    contiguous)."""
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
    ld = row_stride(o)
    if d % 8 or ld is None:
        raise ValueError(f"o {tuple(o.shape)} strides {o.stride()}: need "
                         "D % 8 == 0, dense heads and evenly spaced rows "
                         "16 bytes apart (see row_stride)")
    for name, t in (("w", w), ("bias", bias), ("residual", residual)):
        _build.check_cuda_tensor(name, t, bf16, dev)
    n = b * s
    plan = absorb_plan("out", n, c, _build.sm_count(dev))
    y = torch.empty((b, s, c), device=dev, dtype=bf16)
    buf, partial = None, None
    if plan.split > 1:
        buf, (partial,) = _build.scratch(dev, [4 * plan.split * n * c])
    _build.load_library().call(
        "dmoe_attn_out_residual", o.data_ptr(), ld, w.data_ptr(),
        bias.data_ptr(), residual.data_ptr(), n, c, plan.wgs, plan.split,
        plan.chunks_per_split, partial, y.data_ptr(), _build.stream_ptr(dev))
    del buf
    _build.LAUNCHES["attn_out_residual_fused"] += 1
    return y


def absorbed_self_attention(x: torch.Tensor, wq, wk, wv, wo, bo, heads: int,
                            sm_scale: float, ln: tuple, mode: str = "1",
                            use_kernels: bool = True,
                            absorb_kernels: bool = True) -> torch.Tensor:
    """The absorbed self-attention sub-block: returns
    `x + to_out(flash(qkv(LN(x))))` for x (B, S, C), `ln` = (scale, bias,
    eps). `mode` is the JAX package's DMOE_ATTN_ABSORB split:

      1     both kernels (prologue and epilogue)
      qkv   `ln_qkv_fused` only; the output projection and the residual add
            in plain torch
      out   LayerNorm and the projections in plain torch;
            `attn_out_residual_fused` only

    `absorb_kernels=False` runs kernels 5 and 6's plain versions and keeps
    the attention's kernel (the model's choice where a gradient is taken).
    """
    if mode not in ("1", "qkv", "out"):
        raise ValueError(f"absorb mode {mode!r}: one of '1', 'qkv', 'out'")
    g, b, eps = ln
    if mode in ("1", "qkv"):
        q, k, v = ln_qkv_fused(x, wq, wk, wv, heads, g, b, eps,
                               use_kernels=use_kernels and absorb_kernels)
    else:
        xn = ln_apply(x, g, b, eps).to(x.dtype)
        q, k, v = (_heads4(F.linear(xn, w), heads) for w in (wq, wk, wv))
    o = self_attention(q, k, v, sm_scale, use_kernels=use_kernels)
    if mode in ("1", "out"):
        out_kernel = use_kernels and absorb_kernels
        if out_kernel and o.device.type == "cuda" and row_stride(o) is None:
            o = o.contiguous()      # the plain attention's permuted view
        return attn_out_residual_fused(o, wo, bo, x, use_kernels=out_kernel)
    return x + F.linear(o.reshape(x.shape), wo, bo)
