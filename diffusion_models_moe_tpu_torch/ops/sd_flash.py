"""SD-shaped attention: flash self-attention at native head dims and one-pass
cross-attention over the text tokens.

Counterpart of `diffusion_models_moe_tpu/ops/sd_flash.py`. On CUDA tensors
`sd_self_attention` and `sd_cross_attention` launch the hand-written kernels
of `csrc/sd_attention.cu`; on CPU tensors they run the plain PyTorch
versions beside them. q, k, v are (B, S, H, D), the layout of the JAX
functions. The kernels read them through strides, so a (B, S, C) projection
output viewed as (B, S, H, D) needs no copy.

Inference only: no autograd.Function, no backward.
"""
from __future__ import annotations

import ctypes

import torch

from diffusion_models_moe_tpu_torch.ops import _build

MAX_CROSS_KV = 80
# head dims padded to 16 that csrc/sd_attention.cu is instantiated for:
# SD1.x's 40, 80 and 160
KERNEL_PADDED_HEAD_DIMS = (48, 80, 160)


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


def _check(q, k, v) -> None:
    dev = q.device
    b, _, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_cuda_tensor(name, t, torch.bfloat16, dev, contiguous=False)
        if t.dim() != 4 or t.shape[0] != b or t.shape[2] != h or t.shape[3] != d:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError(f"{name} strides {t.stride()}: need unit stride "
                             "in D and 16-byte aligned rows")
    if d % 8 or (d + 15) // 16 * 16 not in KERNEL_PADDED_HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes D % 8 == 0 with D "
                         f"padded to 16 in {KERNEL_PADDED_HEAD_DIMS}")


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
    _check(q, k, v)
    if k.shape[1] != q.shape[1]:
        raise ValueError("self-attention needs S_q == S_kv")
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), device=q.device, dtype=q.dtype)
    lib = _build.load_library()
    lib.call("dmoe_sd_self_attention", q.data_ptr(), k.data_ptr(),
             v.data_ptr(), o.data_ptr(), b, h, s, d, float(sm_scale),
             _strides(q, k, v, o), _build.stream_ptr(q.device))
    _build.LAUNCHES["sd_self_attention"] += 1
    return o


def sd_cross_attention(q, k, v, sm_scale: float, kv_valid: int,
                       use_kernels: bool = True) -> torch.Tensor:
    """q: (B, S_q, H, D); k, v: (B, S_kv, H, D) with few keys (text tokens).
    Keys at or past `kv_valid` are masked out. One pass per query tile."""
    kv_valid = min(kv_valid, k.shape[1])
    if q.device.type == "cpu" or not use_kernels:
        return sd_cross_attention_reference(q, k, v, sm_scale, kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v)
    if not 1 <= kv_valid <= MAX_CROSS_KV:
        raise ValueError(f"kv_valid={kv_valid}: the kernel holds at most "
                         f"{MAX_CROSS_KV} keys")
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), device=q.device, dtype=q.dtype)
    lib = _build.load_library()
    lib.call("dmoe_sd_cross_attention", q.data_ptr(), k.data_ptr(),
             v.data_ptr(), o.data_ptr(), b, h, s, kv_valid, d, float(sm_scale),
             _strides(q, k, v, o), _build.stream_ptr(q.device))
    _build.LAUNCHES["sd_cross_attention"] += 1
    return o
