"""MoE routing interventions from expert labels (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/moefication/moefy.py`: the routing
interventions, the AddExperts boost, the labels artifact, and the FF layers'
state-dict prefixes. Clustering (`moefy_unet`) stays in the JAX package for
now.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.config import UNetConfig, resolve_device
from diffusion_models_moe_tpu_torch.taps import (Interventions,
                                                 LayerIntervention,
                                                 layer_name,
                                                 patterns_from_labels)


def ff_param_paths(cfg: UNetConfig) -> list[str]:
    """State-dict prefix of each FF layer of the UNet, in canonical order
    (list index == FF layer index), e.g.
    `down_blocks.0.attentions.0.transformer_blocks.0.ff`."""
    paths: list[str] = []

    def add(prefix: str, block_idx: int):
        for d in range(cfg.depth_for_block(block_idx)):
            paths.append(f"{prefix}.transformer_blocks.{d}.ff")

    for i, kind in enumerate(cfg.down_block_types):
        if kind == "cross":
            for j in range(cfg.layers_per_block):
                add(f"down_blocks.{i}.attentions.{j}", i)
    add("mid_block.attentions.0", len(cfg.block_out_channels) - 1)
    rev = list(range(len(cfg.block_out_channels)))[::-1]
    for i, kind in enumerate(cfg.up_block_types):
        if kind == "cross":
            for j in range(cfg.layers_per_block + 1):
                add(f"up_blocks.{i}.attentions.{j}", rev[i])
    assert len(paths) == cfg.n_ff_layers, (len(paths), cfg.n_ff_layers)
    return paths


def load_labels(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def build_add_experts_boost(avg_scores: np.ndarray, skilled: np.ndarray,
                            scale: float = 5.0) -> np.ndarray:
    """AddExperts boost: (T, E) average expert scores and the (E,) or (T, E)
    skilled experts -> the (T, E) additive routing boost, `scale` x the
    average score on skilled experts and 0 elsewhere. The AddExperts recipe
    also routes fewer experts while boosting: pass `topk_ratio * 0.8` to
    `build_moe_interventions` beside this boost."""
    av = np.asarray(avg_scores, np.float32)
    sk = np.asarray(skilled, bool)
    if sk.ndim == 1:
        sk = np.broadcast_to(sk[None, :], av.shape)
    return np.where(sk, scale * av, 0.0).astype(np.float32)


def build_moe_interventions(labels: dict[str, np.ndarray], topk_ratio: float,
                            n_layers: Optional[int] = None,
                            expert_remove: Optional[dict] = None,
                            expert_boost: Optional[dict] = None,
                            device="cuda",
                            dtype: torch.dtype = torch.float32) -> Interventions:
    """labels -> per-layer routing interventions with
    k = max(int(E * topk_ratio), 1). `n_layers` defaults to covering every
    labelled layer; `expert_remove` maps layer names to (T, E) bool arrays,
    `expert_boost` to (T, E) float arrays. Patterns are made once, on
    `device` (the card by default) in `dtype` (the model's: the CUDA kernels take them as they
    are)."""
    device = resolve_device(device)
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
        boost = None if expert_boost is None else expert_boost.get(name)
        ivs.append(LayerIntervention(
            patterns=patterns_from_labels(lab, n_experts).to(device, dtype),
            k=k,
            expert_remove=None if rm is None else torch.as_tensor(
                np.asarray(rm), dtype=torch.bool, device=device),
            expert_boost=None if boost is None else torch.as_tensor(
                np.asarray(boost), dtype=torch.float32, device=device)))
    return tuple(ivs)
