"""Fused GEGLU-MoE feed-forward: LayerNorm, GEGLU, top-k expert routing,
masked product, output projection and residual.

Counterpart of `diffusion_models_moe_tpu/ops/geglu_ff_fused.py`. On a CUDA
tensor `geglu_ff_fused` launches the hand-written kernels of
`csrc/geglu_ff.cu` (three launches: LN + dual GEMM + GELU, routing, output
GEMM + residual); on a CPU tensor it runs `geglu_ff_reference`, the plain
PyTorch version of the same function. Weights use the nn.Linear layout:
W1 (2H, C) is `ff.net.0.proj.weight`, W2 (C, H) is `ff.net.2.weight`.

Routing semantics are those of the JAX kernel and `taps.routing_mask`:
score[n, e] = sum of the post-GELU gate (rounded to the model dtype) over
expert e's neurons, accumulated in f32; experts with score >= the kth
largest are kept, ties included.

Inference only: no autograd.Function, no backward.
"""
from __future__ import annotations

from typing import Optional

import torch

from diffusion_models_moe_tpu_torch.ops import _build


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
    prod = _launch_up_route(x2d, w1, b1, patterns, k, relu, ln_scale,
                            ln_bias, eps)
    y = torch.empty((n, c), device=dev, dtype=bf16)
    _build.load_library().call(
        "dmoe_ff_down", prod.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        x2d.data_ptr() if ln_scale is not None else None, n, c, hdim,
        y.data_ptr(), _build.stream_ptr(dev))
    _build.LAUNCHES["geglu_ff_fused"] += 1
    return y


def _launch_up_route(x2d, w1, b1, patterns, k, relu, ln_scale, ln_bias,
                     eps) -> torch.Tensor:
    """Launches 1 and 2 on checked CUDA tensors; returns prod (N, H)."""
    n, c = x2d.shape
    hdim = w1.shape[0] // 2
    dev, bf16 = x2d.device, torch.bfloat16
    lib = _build.load_library()
    stream = _build.stream_ptr(dev)
    ln_g = None if ln_scale is None else ln_scale.data_ptr()
    ln_b = None if ln_bias is None else ln_bias.data_ptr()
    prod = torch.empty((n, hdim), device=dev, dtype=bf16)
    if patterns is None:
        lib.call("dmoe_ff_up", x2d.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                 ln_g, ln_b, eps, n, c, hdim, int(relu), 0, None, None,
                 prod.data_ptr(), stream)
        return prod
    e = patterns.shape[0]
    if e > 256 or tuple(patterns.shape) != (e, hdim):
        raise ValueError(f"patterns {tuple(patterns.shape)}: need (E, {hdim})"
                         " with E <= 256")
    _build.check_cuda_tensor("patterns", patterns, bf16, dev)
    ga = torch.empty((n, hdim), device=dev, dtype=bf16)
    hg = torch.empty((n, hdim), device=dev, dtype=torch.float32)
    lib.call("dmoe_ff_up", x2d.data_ptr(), w1.data_ptr(), b1.data_ptr(),
             ln_g, ln_b, eps, n, c, hdim, int(relu), 1, ga.data_ptr(),
             hg.data_ptr(), None, stream)
    lib.call("dmoe_ff_route", ga.data_ptr(), hg.data_ptr(), patterns.data_ptr(),
             n, hdim, e, k, prod.data_ptr(), stream)
    return prod


def kernel_selection(x2d, w1, b1, patterns, k, relu=False, ln_scale=None,
                     ln_bias=None, eps=1e-5) -> torch.Tensor:
    """(N, E) 0/1 experts the CUDA routing kernel kept, read back from its
    masked product (an expert counts as kept when any of its neurons is
    nonzero there). For kernel-vs-plain comparisons only: these launches
    are not counted."""
    prod = _launch_up_route(x2d, w1, b1, patterns, k, relu, ln_scale,
                            ln_bias, eps)
    return ((prod != 0).float() @ patterns.float().t() > 0).float()
