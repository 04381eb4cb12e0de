"""SD-shaped attention: flash self-attention at native head dims and one-pass
cross-attention over the text tokens.

Counterpart of `diffusion_models_moe_tpu/ops/sd_flash.py`. On CUDA tensors
`sd_self_attention` and `sd_cross_attention` launch the hand-written kernels
of `csrc/sd_attention.cu` (wgmma, TMA rings, warp-specialised softmax); on
CPU tensors they run the plain PyTorch versions beside them. q, k, v are
(B, S, H, D), the layout of the JAX functions. The kernels read them through
strides, so a (B, S, C) projection output viewed as (B, S, H, D) needs no
copy.

How a launch is cut into blocks is decided here, in `attn_plan`, a pure
function of the shape and the card's SM count. What the kernels take is
`attn_kernel_ok`; the model calls `self_attention` / `cross_attention`, which
ask it and take the plain version where it says no (an f32 model, a head dim
the kernels are not instantiated for), counting each such call on a CUDA
tensor in `_build.LAUNCHES` under `plain:<kernel>`. The wrappers themselves
raise on what they do not take.

Inference only: no autograd.Function, no backward.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from diffusion_models_moe_tpu_torch.ops import _build

MAX_CROSS_KV = 80
# head dims csrc/sd_attention.cu is instantiated for: SD1.x's 40, 80 and 160
# and SD2.x's 64
KERNEL_HEAD_DIMS = (40, 64, 80, 160)
Q_TILE = 64              # query rows of a consumer warpgroup
STAGES_CROSS = 2         # the cross kernel's ring of query tiles
# resident cross-attention blocks an SM (160 threads, <= 111 KB each)
CROSS_BLOCKS_PER_SM = 2
# shared memory the self kernel's Q tile and K/V ring may take; the ring is
# as deep as fits, at most MAX_STAGES (the loads come from L2 and a deeper
# ring hides their latency)
SELF_SMEM_BUDGET = 220 * 1024
MAX_STAGES = 6


def chunk_bytes(d: int) -> int:
    """Bytes of a chunk row in shared memory (csrc/sd_attention.cu AttnCfg
    ROW): one 128-byte swizzled chunk of 64 values at D <= 64, 64-byte chunks
    of 32 values above."""
    return 128 if d <= 64 else 64


def self_smem(d: int, wgs: int, bkv: int, stages: int) -> int:
    """Shared memory of the self kernel's Q tile and K/V ring."""
    row = chunk_bytes(d)
    nch = -(-d // (row // 2))
    return wgs * nch * Q_TILE * row + 2 * stages * nch * bkv * row


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    """How one launch of an attention kernel is cut into blocks. A block
    takes `run` consecutive query tiles of `rows` rows of one (batch, head)
    (`q_blocks` blocks cover the queries of a (batch, head)); `wgs` consumer
    warpgroups of 64 rows each share a tile. Keys come in tiles of `bkv`
    through a ring of `stages` (self); the cross kernel holds its `bkv` keys
    whole and rings its query tiles."""
    kind: str
    rows: int
    wgs: int
    bkv: int
    stages: int
    run: int
    q_blocks: int

    def blocks(self, batch: int, heads: int) -> int:
        return batch * heads * self.q_blocks


@functools.lru_cache(maxsize=None)
def attn_plan(kind: str, b: int, h: int, s_q: int, s_kv: int, d: int,
              sms: int) -> AttnPlan:
    """The launch plan of `kind` ("self" or "cross") for q (b, s_q, h, d) and
    s_kv keys on a card of `sms` SMs.

    Self: blocks of 128 query rows (two consumer warpgroups) where that grid
    fills the card, else 64-row blocks (S = 256 and 64 at UNet batch 4); keys
    in tiles of 128, or 64 at D > 80 (registers), through a ring as deep as
    SELF_SMEM_BUDGET holds (at most MAX_STAGES). Cross: 64-row query tiles,
    each block walking a run of them so that the grid is about
    CROSS_BLOCKS_PER_SM blocks an SM (K and V are loaded once a block), and
    no fewer blocks than tiles where the tiles are fewer than that."""
    if d not in KERNEL_HEAD_DIMS or min(b, h, s_q, s_kv) < 1:
        raise ValueError(f"no attention plan for B={b} H={h} S_q={s_q} "
                         f"S_kv={s_kv} D={d}")
    tiles = -(-s_q // Q_TILE)
    if kind == "self":
        if s_kv != s_q:
            raise ValueError("self-attention needs S_q == S_kv")
        wgs = 2 if b * h * -(-s_q // (2 * Q_TILE)) >= sms else 1
        rows, bkv = wgs * Q_TILE, 64 if d > 80 else 128
        stages = MAX_STAGES
        while self_smem(d, wgs, bkv, stages) > SELF_SMEM_BUDGET:
            stages -= 1
        return AttnPlan(kind, rows, wgs, bkv, stages, 1, -(-s_q // rows))
    if kind == "cross":
        per_bh = min(tiles, -(-CROSS_BLOCKS_PER_SM * sms // (b * h)))
        run = -(-tiles // per_bh)
        return AttnPlan(kind, Q_TILE, 1, MAX_CROSS_KV, STAGES_CROSS, run,
                        -(-tiles // run))
    raise ValueError(f"kind {kind!r}: 'self' or 'cross'")


def _layout_ok(t: torch.Tensor) -> bool:
    st = t.stride()
    return (st[3] == 1 and st[0] % 8 == 0 and st[1] % 8 == 0 and st[2] % 8 == 0
            and t.data_ptr() % 16 == 0)


def attn_layout_ok(q: torch.Tensor, k: torch.Tensor,
                   kv_valid: Optional[int] = None,
                   v: Optional[torch.Tensor] = None) -> bool:
    """`attn_kernel_ok` less the device: q (B, S_q, H, D) and k (B, S_kv, H,
    D), and v where given (else it is taken to be laid out as k), bf16 with
    D in KERNEL_HEAD_DIMS (so D % 8 == 0), unit stride in D and 16-byte
    aligned rows; for cross-attention (`kv_valid` given) at most
    MAX_CROSS_KV valid keys."""
    if (q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16
            or q.dim() != 4 or k.dim() != 4):
        return False
    qs, ks = q.shape, k.shape
    if (qs[3] not in KERNEL_HEAD_DIMS or ks[0] != qs[0] or ks[2] != qs[2]
            or ks[3] != qs[3] or not (_layout_ok(q) and _layout_ok(k))):
        return False
    if v is not None and (v.dtype != torch.bfloat16 or v.shape != ks
                          or v.device != q.device or not _layout_ok(v)):
        return False
    return kv_valid is None or 1 <= min(kv_valid, ks[1]) <= MAX_CROSS_KV


def attn_kernel_ok(q: torch.Tensor, k: torch.Tensor,
                   kv_valid: Optional[int] = None,
                   v: Optional[torch.Tensor] = None) -> bool:
    """Whether the kernels take q (B, S_q, H, D), k and v: CUDA tensors on
    one device that `attn_layout_ok` admits."""
    return (q.device.type == "cuda" and k.device == q.device
            and attn_layout_ok(q, k, kv_valid, v))


def sd_self_attention_reference(q, k, v, sm_scale: float) -> torch.Tensor:
    """Plain softmax attention in f32; the result in q's dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def sd_cross_attention_reference(q, k, v, sm_scale: float,
                                 kv_valid: int) -> torch.Tensor:
    """Plain softmax attention in f32 with keys at or past `kv_valid`
    masked out; the result in q's dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    keep = torch.arange(k.shape[1], device=q.device) < kv_valid
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _refuse(q, k, v, kv_valid: Optional[int] = None) -> None:
    """Raises with the reason `attn_kernel_ok` refused q, k, v."""
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}: need (B, S, H, D)")
    b, _, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {t.dtype} on {t.device}: the kernel "
                             f"takes bf16 on {q.device}")
        if t.dim() != 4 or t.shape[0] != b or t.shape[2] != h or t.shape[3] != d:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
        if not _layout_ok(t):
            raise ValueError(f"{name} strides {t.stride()}: need unit stride "
                             "in D and 16-byte aligned rows")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if d not in KERNEL_HEAD_DIMS or (
            kv_valid is not None and not 1 <= kv_valid <= MAX_CROSS_KV):
        raise ValueError(f"head dim {d}, kv_valid {kv_valid}: the kernels take "
                         f"D in {KERNEL_HEAD_DIMS} and at most {MAX_CROSS_KV} "
                         "keys (attn_kernel_ok)")
    raise ValueError("attn_kernel_ok refuses these tensors")


def _strides(*ts) -> ctypes.Array:
    """(batch, seq, head) element strides of each tensor, flattened."""
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def sd_self_attention(q, k, v, sm_scale: float,
                      use_kernels: bool = True) -> torch.Tensor:
    """q, k, v: (B, S, H, D) -> (B, S, H, D). Non-causal, D unpadded.

    `use_kernels=False` takes the plain version on CUDA too; it exists only
    for kernel-vs-plain comparisons."""
    if q.device.type == "cpu" or not use_kernels:
        return sd_self_attention_reference(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if k.shape[1] != q.shape[1] or not attn_kernel_ok(q, k, v=v):
        if k.dim() == 4 and k.shape[1] != q.shape[1]:
            raise ValueError("self-attention needs S_q == S_kv")
        _refuse(q, k, v)
    return _launch_self(q, k, v, sm_scale)


def sd_cross_attention(q, k, v, sm_scale: float, kv_valid: int,
                       use_kernels: bool = True) -> torch.Tensor:
    """q: (B, S_q, H, D); k, v: (B, S_kv, H, D) with few keys (text tokens).
    Keys at or past `kv_valid` are masked out. A block holds the keys and
    walks a run of query tiles."""
    kv_valid = min(kv_valid, k.shape[1])
    if q.device.type == "cpu" or not use_kernels:
        return sd_cross_attention_reference(q, k, v, sm_scale, kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if not attn_kernel_ok(q, k, kv_valid, v):
        _refuse(q, k, v, kv_valid)
    return _launch_cross(q, k, v, sm_scale, kv_valid)


def _launch_self(q, k, v, sm_scale: float) -> torch.Tensor:
    b, s, h, d = q.shape
    plan = attn_plan("self", b, h, s, s, d, _build.sm_count(q.device))
    o = torch.empty((b, s, h, d), device=q.device, dtype=q.dtype)
    _build.load_library().call(
        "dmoe_sd_self_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), b, h, s, d, float(sm_scale), plan.wgs, plan.bkv,
        plan.stages, _strides(q, k, v, o), _build.stream_ptr(q.device))
    _build.LAUNCHES["sd_self_attention"] += 1
    return o


def _launch_cross(q, k, v, sm_scale: float, kv_valid: int) -> torch.Tensor:
    b, s, h, d = q.shape
    plan = attn_plan("cross", b, h, s, k.shape[1], d, _build.sm_count(q.device))
    o = torch.empty((b, s, h, d), device=q.device, dtype=q.dtype)
    _build.load_library().call(
        "dmoe_sd_cross_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), b, h, s, k.shape[1], kv_valid, d, float(sm_scale),
        plan.run, _strides(q, k, v, o), _build.stream_ptr(q.device))
    _build.LAUNCHES["sd_cross_attention"] += 1
    return o


def self_attention(q, k, v, sm_scale: float,
                   use_kernels: bool = True) -> torch.Tensor:
    """The model's self-attention: kernel 2 where `attn_kernel_ok` admits
    the tensors, the plain version on the CPU or with `use_kernels=False`,
    and elsewhere the plain version counted under `plain:sd_self_attention`.
    The predicate runs once a call."""
    if q.device.type != "cuda" or not use_kernels:
        return sd_self_attention(q, k, v, sm_scale, use_kernels=use_kernels)
    if k.shape[1] == q.shape[1] and attn_kernel_ok(q, k, v=v):
        return _launch_self(q, k, v, sm_scale)
    _build.LAUNCHES["plain:sd_self_attention"] += 1
    return sd_self_attention_reference(q, k, v, sm_scale)


def cross_attention(q, k, v, sm_scale: float, kv_valid: int,
                    use_kernels: bool = True) -> torch.Tensor:
    """The model's cross-attention, chosen as `self_attention` is; the plain
    version is counted under `plain:sd_cross_attention`."""
    kv_valid = min(kv_valid, k.shape[1])
    if q.device.type != "cuda" or not use_kernels:
        return sd_cross_attention(q, k, v, sm_scale, kv_valid,
                                  use_kernels=use_kernels)
    if attn_kernel_ok(q, k, kv_valid, v):
        return _launch_cross(q, k, v, sm_scale, kv_valid)
    _build.LAUNCHES["plain:sd_cross_attention"] += 1
    return sd_cross_attention_reference(q, k, v, sm_scale, kv_valid)
