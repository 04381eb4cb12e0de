"""Routing interventions for GEGLU FF layers (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/taps.py`. This slice covers the
MoE serving path: top-k expert routing over 0/1 `patterns` with optional
per-step `expert_remove`. Tap collection and the other interventions
(`expert_boost`, `neuron_mask`, `out_weight_mask`, `token_mask`) are not
ported yet; setting one raises `NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

_UNPORTED = ("expert_boost", "neuron_mask", "out_weight_mask", "token_mask")


@dataclasses.dataclass(frozen=True)
class LayerIntervention:
    """Tensors mutating one FF layer's forward pass.

    patterns:      (E, H) 0/1 expert membership; row e marks expert e's neurons.
    k:             top-k expert count; k > 0 routes (masks the gate).
    expert_remove: (T, E) bool; zero these experts' pattern rows at step t
                   before routing.
    """
    patterns: Optional[torch.Tensor] = None
    k: int = 0
    expert_remove: Optional[torch.Tensor] = None
    expert_boost: Optional[torch.Tensor] = None
    neuron_mask: Optional[torch.Tensor] = None
    out_weight_mask: Optional[torch.Tensor] = None
    token_mask: Optional[torch.Tensor] = None

    def __post_init__(self):
        for name in _UNPORTED:
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"LayerIntervention.{name} is not ported to the torch "
                    "package yet")
        if self.patterns is not None and self.k <= 0:
            raise NotImplementedError(
                "k <= 0 only observes routing for taps, which are not ported")


Interventions = Tuple[Optional[LayerIntervention], ...]


def layer_name(idx: int) -> str:
    """Canonical FF layer key used in label dicts and artifacts."""
    return f"ff_{idx:02d}"


def routing_mask(gate2d: torch.Tensor, patterns: torch.Tensor, k: int,
                 exact_k: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k expert routing: returns (neuron mask (N, H), selected (N, E)).

    score[n, e] is the sum of the post-activation gate over expert e's
    neurons, accumulated in f32. By default selection is `score >= kth`
    (threshold semantics): on exact ties more than k experts are kept.
    `exact_k=True` keeps exactly k, lower expert index first on ties, as
    `jax.lax.top_k` orders them."""
    score = gate2d.float() @ patterns.float().t()              # (N, E)
    if exact_k:
        idx = torch.sort(score, dim=-1, descending=True, stable=True)[1][:, :k]
        sel = torch.zeros_like(score).scatter_(1, idx, 1.0)
    else:
        kth = torch.topk(score, k, dim=-1).values[:, -1:]
        sel = (score >= kth).float()
    mask = sel @ patterns.float()                              # (N, H) 0/1
    return mask.to(gate2d.dtype), sel


def patterns_from_labels(labels, n_experts: int) -> torch.Tensor:
    """(H,) cluster labels -> (E, H) f32 0/1 membership matrix."""
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64)
    return (labels[None, :] == torch.arange(n_experts)[:, None]).float()
