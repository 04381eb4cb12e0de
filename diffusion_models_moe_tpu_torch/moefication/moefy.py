"""MoE routing interventions from expert labels (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/moefication/moefy.py`. Only
`build_moe_interventions` is ported; clustering (`moefy_unet`) stays in the
JAX package for now.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.taps import (Interventions,
                                                 LayerIntervention,
                                                 layer_name,
                                                 patterns_from_labels)


def build_moe_interventions(labels: dict[str, np.ndarray], topk_ratio: float,
                            n_layers: Optional[int] = None,
                            expert_remove: Optional[dict] = None,
                            device=None,
                            dtype: torch.dtype = torch.float32) -> Interventions:
    """labels -> per-layer routing interventions with
    k = max(int(E * topk_ratio), 1). `n_layers` defaults to covering every
    labelled layer; `expert_remove` maps layer names to (T, E) bool arrays.
    Patterns are made once, on `device` in `dtype` (the model's: the CUDA
    kernel takes them as they are)."""
    if n_layers is None:
        n_layers = 1 + max(
            (int(k.rsplit("_", 1)[1]) for k in labels), default=15)
    ivs = []
    for idx in range(n_layers):
        name = layer_name(idx)
        if name not in labels:
            ivs.append(None)
            continue
        lab = np.asarray(labels[name])
        n_experts = int(lab.max()) + 1
        k = max(int(n_experts * topk_ratio), 1)
        rm = None if expert_remove is None else expert_remove.get(name)
        ivs.append(LayerIntervention(
            patterns=patterns_from_labels(lab, n_experts).to(device, dtype),
            k=k,
            expert_remove=None if rm is None else torch.as_tensor(
                np.asarray(rm), dtype=torch.bool, device=device)))
    return tuple(ivs)
