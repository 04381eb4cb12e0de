"""Fused MoE routing: score -> top-k select -> mask -> gate multiply.

Counterpart of `diffusion_models_moe_tpu/ops/routing_kernel.py`. The FF
layer takes it on its unfused path (taps collecting, neuron masks, output
weight masks), where hidden and the activated gate exist as tensors:

    score = gate @ patterns^T            (f32 accumulation)
    sel_e = |{e' : score_e' > score_e}| < k   (ties kept)
    out   = hidden * gate * (sel @ patterns)

On a CUDA tensor `fused_route_multiply` launches the hand-written kernel of
`csrc/geglu_ff.cu` (`dmoe_route_multiply`, the routing stage of the fused
FF with hidden read as bf16); on a CPU tensor it runs
`route_multiply_reference`, the plain PyTorch version.

Inference only: no autograd.Function, no backward.
"""
from __future__ import annotations

import torch

from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.taps import routing_mask


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
    if hidden.stride(1) != 1 or hidden.stride(0) < hdim:
        raise ValueError(f"hidden strides {hidden.stride()}: need unit "
                         "column stride and rows apart by at least H")
    if e > 256 or hdim % 64:
        raise ValueError(f"kernel needs E <= 256 and H % 64 == 0, got E={e}, "
                         f"H={hdim}")
    out = torch.empty((n, hdim), device=dev, dtype=bf16)
    _build.load_library().call(
        "dmoe_route_multiply", hidden.data_ptr(), hidden.stride(0),
        gate.data_ptr(), patterns.data_ptr(), n, hdim, e, k, out.data_ptr(),
        _build.stream_ptr(dev))
    _build.LAUNCHES["fused_route_multiply"] += 1
    return out
