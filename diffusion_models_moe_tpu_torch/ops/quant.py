"""int8 quantised serving primitives (W8A8, symmetric, dynamic).

Counterpart of `diffusion_models_moe_tpu/ops/quant.py`. Dynamic activation
scales (per token for dots, per sample for convs: no reduction crosses a
batch row, so co-batched requests cannot couple), per-output-channel weight
scales, symmetric (zero-point 0, so zero padding stays exact), round half to
even onto [-127, 127], int32 accumulation, dequantisation in f32. This is an
opt-in serving mode (`UNetConfig.quant_int8`): outputs differ from the
model-dtype path by about 1e-2 relative L2 a layer.

The integer products go through `torch._int_mm` (int8 x int8 -> int32, exact
on the CPU and on CUDA), which is plain PyTorch outside any kernel, as the
JAX package leaves its int8 `dot_general` and convolution to XLA. PyTorch has
no int8 convolution on CUDA, and an f32 accumulation of up to 9 x 2560
products of size <= 127^2 is not exact, so `int8_conv` is one `_int_mm` over
the taps' channels-last rows laid side by side.

Layouts are this package's: weights as `nn.Linear` (N, K) and `nn.Conv2d`
(Cout, Cin, kh, kw) hold them, activations (..., K) and (B, Cin, H, W). The
weight quantisation is loop-invariant: `quantize_dense_weight` and
`quantize_conv_weight` return it for a caller that hoists it
(`models/layers.py`), and both functions take it back as `wq`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_EPS = 1e-8


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric round-half-even onto [-127, 127]."""
    return torch.clamp(torch.round(x.float() / scale), -127.0, 127.0
                       ).to(torch.int8)


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    return absmax.float().clamp_min(_EPS) / 127.0


def quantize_dense_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w (N, K) -> (int8 (N, K), f32 scales (N,)): one scale per output
    column, its absmax over K."""
    sw = _scale(w.abs().amax(dim=1))
    return _quantize(w, sw[:, None]), sw


def quantize_conv_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w (Cout, Cin, kh, kw) -> (int8 (Cout, kh*kw*Cin) with each tap's Cin
    values side by side, f32 scales (Cout,)): one scale per output channel,
    its absmax over (Cin, kh, kw)."""
    sw = _scale(w.abs().amax(dim=(1, 2, 3)))
    wq = _quantize(w, sw[:, None, None, None])
    return wq.permute(0, 2, 3, 1).reshape(w.shape[0], -1).contiguous(), sw


def _int_mm(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """int8 a (M, K) @ bt (N, K)^T -> int32 (M, N), exact. On CUDA
    `torch._int_mm` wants M > 16 and K, N multiples of 8: zero rows and
    columns (exact under the symmetric scheme) pad up to that."""
    m, k = a.shape
    n = bt.shape[0]
    if a.device.type != "cuda":
        return torch._int_mm(a.contiguous(), bt.t())
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        bt = F.pad(bt, (0, kp - k, 0, np_ - n))
    return torch._int_mm(a.contiguous(), bt.t())[:m, :n]


def int8_dot(x: torch.Tensor, w: Optional[torch.Tensor] = None,
             per_token: bool = True,
             wq: Optional[tuple] = None) -> torch.Tensor:
    """x (..., K) @ w (N, K)^T with W8A8 int8 products.

    Weight scales are per output column; activation scales are per token
    (absmax over K of each row), or one for the tensor with
    `per_token=False`. `wq` is `quantize_dense_weight(w)` from a caller that
    hoists it. Returns x.dtype."""
    wq_i8, sw = quantize_dense_weight(w) if wq is None else wq
    if per_token:
        sx = _scale(x.abs().amax(dim=-1, keepdim=True))            # (..., 1)
    else:
        sx = _scale(x.abs().max())
    xq = _quantize(x, sx)
    y = _int_mm(xq.reshape(-1, x.shape[-1]), wq_i8)
    y = y.reshape(*x.shape[:-1], wq_i8.shape[0])
    return (y.float() * (sx * sw)).to(x.dtype)


def int8_conv(x: torch.Tensor, w: Optional[torch.Tensor] = None,
              stride: int = 1, padding: int = 1, kernel_size: int = 3,
              per_sample: bool = True,
              wq: Optional[tuple] = None) -> torch.Tensor:
    """x (B, Cin, H, W) * w (Cout, Cin, k, k) int8 convolution with
    symmetric zero padding `padding` and stride `stride`.

    Weight scales are per output channel. Activation scales are per sample
    (absmax over C, H, W of each batch row: a conv never mixes batch
    elements, so with per-token dot scales the whole int8 UNet is free of
    co-batching coupling), or one for the tensor with `per_sample=False`.
    `wq` is `quantize_conv_weight(w)` (then `kernel_size` says k). Returns
    (B, Cout, Ho, Wo) in x.dtype."""
    if w is not None:
        kernel_size = w.shape[-1]
    wq_i8, sw = quantize_conv_weight(w) if wq is None else wq
    b, cin, h, wd = x.shape
    k, cout = kernel_size, wq_i8.shape[0]
    if wq_i8.shape[1] != k * k * cin:
        raise ValueError(f"weight {tuple(wq_i8.shape)} does not fit x "
                         f"{tuple(x.shape)} at kernel size {k}")
    if per_sample:
        sx = _scale(x.abs().amax(dim=(1, 2, 3), keepdim=True))     # (B,1,1,1)
    else:
        sx = _scale(x.abs().max())
    # channels-last rows: each tap's (B, Ho, Wo, Cin) slice of the padded
    # integers, side by side along the depth in the weight's (ky, kx, Cin) order
    xq = F.pad(_quantize(x, sx).permute(0, 2, 3, 1),
               (0, 0, padding, padding, padding, padding))
    ho = (h + 2 * padding - k) // stride + 1
    wo = (wd + 2 * padding - k) // stride + 1
    taps = [xq[:, ky:ky + stride * (ho - 1) + 1:stride,
               kx:kx + stride * (wo - 1) + 1:stride]
            for ky in range(k) for kx in range(k)]
    rows = taps[0] if len(taps) == 1 else torch.cat(taps, dim=-1)
    y = _int_mm(rows.reshape(b * ho * wo, k * k * cin), wq_i8)
    y = y.reshape(b, ho, wo, cout).permute(0, 3, 1, 2)
    scale = sx * sw[:, None, None]            # (B, Cout, 1, 1) or (Cout, 1, 1)
    return (y.float() * scale).to(x.dtype)
