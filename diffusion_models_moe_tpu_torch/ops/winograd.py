"""Winograd F(m x m, 3 x 3) convolution for the stride-1 SAME 3x3 convs.

Counterpart of `diffusion_models_moe_tpu/ops/winograd.py`: each m x m output
tile comes from (m + 2)^2 multiplies instead of 9 m^2 (Lavin & Gray, 2015),

    Y = A^T [ (G g G^T) .* (B^T d B) ] A,

with the (m + 2)^2 per-position products as one batched matrix product
`(a^2, B*tiles, Cin) @ (a^2, Cin, Cout)`. This is the plain formulation
(`conv_winograd="1"`): the Winograd-domain tensors go through device memory
and the product is a `torch.bmm`, as it is a `dot_general` outside any
Pallas kernel in the JAX package. The fused kernel that keeps them on the
chip is `ops/winograd_fused.py`.

Numerics as in the JAX module: the transforms run in f32, only the batched
product runs on operands rounded to the model dtype, with f32 accumulation
and an f32 result. The output differs from the direct convolution at the
model dtype's rounding scale, so this is an opt-in serving mode.

Layouts are this package's: x (B, Cin, H, W) in any memory format, w
(Cout, Cin, 3, 3) as `nn.Conv2d` holds it, y (B, Cout, H, W). The
transformed filter is (a^2, Cout, Cin): one output column a row, Cin
contiguous, which is what the fused kernel reads.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# F(2x2, 3x3) transform matrices (Lavin & Gray 2015, eq. 10-11)
_BT2 = ((1, 0, -1, 0),
        (0, 1, 1, 0),
        (0, -1, 1, 0),
        (0, 1, 0, -1))
_G2 = ((1, 0, 0),
       (0.5, 0.5, 0.5),
       (0.5, -0.5, 0.5),
       (0, 0, 1))
_AT2 = ((1, 1, 1, 0),
        (0, 1, -1, -1))

# F(4x4, 3x3) (Lavin & Gray 2015, section 4.1): 6x6 tiles, stride 4. G has
# 1/6, 1/12, 1/24 entries (not exact in binary), so the error is somewhat
# larger than F(2x2)'s.
_BT4 = ((4, 0, -5, 0, 1, 0),
        (0, -4, -4, 1, 1, 0),
        (0, 4, -4, -1, 1, 0),
        (0, -2, -1, 2, 1, 0),
        (0, 2, -1, -2, 1, 0),
        (0, 4, 0, -5, 0, 1))
_G4 = ((1 / 4, 0, 0),
       (-1 / 6, -1 / 6, -1 / 6),
       (-1 / 6, 1 / 6, -1 / 6),
       (1 / 24, 1 / 12, 1 / 6),
       (1 / 24, -1 / 12, 1 / 6),
       (0, 0, 1))
_AT4 = ((1, 1, 1, 1, 1, 0),
        (0, 1, -1, 2, -2, 0),
        (0, 1, 1, 4, 4, 0),
        (0, 1, -1, 8, -8, 1))

_MATS = {2: (_BT2, _G2, _AT2), 4: (_BT4, _G4, _AT4)}
STACK_BUDGET_MB = 512.0


def _mats(tile: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if tile not in _MATS:
        raise ValueError(f"winograd tile must be one of {sorted(_MATS)}, "
                         f"got {tile}")
    return tuple(torch.tensor(m, dtype=torch.float32, device=device)
                 for m in _MATS[tile])


def transform_filter(w: torch.Tensor, tile: int = 2) -> torch.Tensor:
    """w (Cout, Cin, 3, 3) -> the Winograd filter U ((m+2)^2, Cout, Cin) in
    f32: U[4 xi + nu] = (G w G^T)[xi, nu]."""
    if tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"winograd filter must be 3x3, got {tuple(w.shape[2:])}")
    g = _mats(tile, w.device)[1]
    u = torch.einsum("xr,ys,oirs->xyoi", g, g, w.float())
    return u.reshape((tile + 2) ** 2, w.shape[0], w.shape[1])


def _winograd_band(xp: torch.Tensor, u: torch.Tensor, bt, at, m: int, th: int,
                   tw: int, dtype: torch.dtype) -> torch.Tensor:
    """One band of tile rows: padded input (B, Cin, m*th + 2, m*tw + 2) ->
    output (B, Cout, m*th, m*tw) in f32. The same arithmetic whether the
    image comes as one band or as many: tiles are independent."""
    a = m + 2
    b, cin = xp.shape[:2]
    cout = u.shape[1]
    # a x a tiles as a^2 strided slices: d[r, s][b, c, i, j] = xp[b, c, m i + r, m j + s]
    d = torch.stack([torch.stack(
        [xp[:, :, r:r + m * th:m, s:s + m * tw:m] for s in range(a)])
        for r in range(a)]).float()                       # (a, a, B, C, th, tw)
    v = torch.einsum("xr,ys,rsbcij->xybijc", bt, bt, d)
    v = v.reshape(a * a, b * th * tw, cin).to(dtype)
    # the a^2 Winograd-domain products: operands in the model dtype, f32
    # accumulation, f32 result (on the card the tensor cores take the bf16
    # operands as they are; elsewhere the rounded operands are widened)
    if v.device.type == "cuda" and dtype != torch.float32:
        prod = torch.bmm(v, u.transpose(1, 2), out_dtype=torch.float32)
    else:
        prod = torch.bmm(v.float(), u.float().transpose(1, 2))
    prod = prod.reshape(a, a, b, th, tw, cout)
    y = torch.einsum("px,qy,xybijc->bcipjq", at, at, prod)
    return y.reshape(b, cout, m * th, m * tw)


def winograd_conv3x3(x: torch.Tensor, w: Optional[torch.Tensor] = None,
                     tile: int = 2, u: Optional[torch.Tensor] = None,
                     stack_budget_mb: float = STACK_BUDGET_MB) -> torch.Tensor:
    """Stride-1 SAME 3x3 convolution via Winograd F(m x m, 3 x 3).

    x (B, Cin, H, W); w (Cout, Cin, 3, 3), or its transformed filter `u` from
    `transform_filter(w, tile)` rounded to x.dtype, for a caller that hoists
    it. Sizes that are no multiple of m are padded and cropped. The image is
    processed in bands of tile rows so that the f32 Winograd-domain tensors
    of a band stay within `stack_budget_mb` (the VAE decoder's 512 x 512
    convs would otherwise build stacks of several GB); tiles are
    independent, so banding equals single-shot to float rounding. Returns
    (B, Cout, H, W) in x.dtype, without a bias."""
    if (w is None) == (u is None):
        raise ValueError("winograd_conv3x3 takes w or u, not both")
    m = tile
    bt, _, at = _mats(m, x.device)
    a = m + 2
    b, cin, h, wd = x.shape
    if u is None:
        u = transform_filter(w, m).to(x.dtype)
    if tuple(u.shape[::2]) != (a * a, cin):
        raise ValueError(f"filter {tuple(u.shape)} does not fit x "
                         f"{tuple(x.shape)} at tile {m}")
    cout = u.shape[1]
    th, tw = math.ceil(h / m), math.ceil(wd / m)
    # output tile (i, j) reads padded rows m i .. m i + a - 1: one zero
    # row and column before, enough after for the last tile
    xp = F.pad(x, (1, m * tw + 1 - wd, 1, m * th + 1 - h))
    # f32 bytes of V for one tile row (the product tensor: the same with Cout)
    band_bytes = a * a * b * tw * max(cin, cout) * 4
    rows = max(1, min(th, int(stack_budget_mb * 2 ** 20) // band_bytes))
    bands = [_winograd_band(xp[:, :, m * i0:m * min(i0 + rows, th) + 2], u, bt,
                            at, m, min(rows, th - i0), tw, x.dtype)
             for i0 in range(0, th, rows)]
    y = bands[0] if len(bands) == 1 else torch.cat(bands, dim=2)
    return y[:, :, :h, :wd].to(x.dtype)
