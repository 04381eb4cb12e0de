"""Seeded weights, made by the benchmark on the device in one draw.

The parameter names and shapes are the reference's (diffusers' and
transformers' names, which the program loads too). Every parameter is
drawn from the seed, so that the comparison sees each part of the model:
weights lecun-normal (std 1 / sqrt(fan_in)), token and position embeddings
with std 1 / sqrt(width), biases and norm shifts 0.1 N(0, 1), norm scales
1 + 0.1 N(0, 1). All normal draws come from one `torch.randn` of a
generator on the device, in the served dtype, and are scaled per tensor in
place; the state dicts are views of that buffer, the norms' parameters
float32 copies. Made twice from one seed they are equal to the bit, which
is how the reference gets the weights the program served, without taking
them from the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from bench_h100.harness.inputs import stream

_WEIGHTS = 0
AFFINE_STD = 0.1    # of biases, norm shifts and norm scales about 1


def _rule(module: nn.Module, name: str, shape, norms: tuple) -> tuple:
    """(std, offset, float32?) of the parameter's draw; a parameter of one
    of the module classes `norms` draws as a norm's."""
    owner = module.get_submodule(name.rpartition(".")[0])
    if isinstance(owner, norms):
        return AFFINE_STD, 1.0 if name.endswith("weight") else 0.0, True
    if name.endswith("bias"):
        return AFFINE_STD, 0.0, False
    if isinstance(owner, nn.Embedding):
        return shape[1] ** -0.5, 0.0, False
    fan_in = 1
    for s in shape[1:]:
        fan_in *= s
    return fan_in ** -0.5, 0.0, False


def plan(modules: dict, norms: tuple) -> list:
    """[(group, name, shape, (std, offset, float32?))] of every parameter
    of the skeleton `modules` ({group: nn.Module}), in draw order."""
    return [(group, name, tuple(p.shape), _rule(module, name, tuple(p.shape),
                                                 norms))
            for group, module in modules.items()
            for name, p in module.named_parameters()]


def make(modules: dict, seed: int, device, dtype=torch.bfloat16, *,
         norms: tuple) -> dict:
    """{group: {name: tensor}} for the skeleton `modules` ({group:
    nn.Module}, any device, meta included): draws in `dtype`, the
    parameters of `norms` (the family's `NORMS`) in float32 as the program
    keeps its norms."""
    steps = plan(modules, norms)
    total = sum(math.prod(shape) for _, _, shape, _ in steps)
    gen_seed = int(stream(seed, _WEIGHTS).integers(0, 2 ** 62))
    g = torch.Generator(device=device).manual_seed(gen_seed)
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    out: dict = {group: {} for group in modules}
    at = 0
    for group, name, shape, (std, offset, f32) in steps:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if f32:
            t = t.float().mul_(std).add_(offset)
        else:
            t.mul_(std)
        out[group][name] = t
    return out
