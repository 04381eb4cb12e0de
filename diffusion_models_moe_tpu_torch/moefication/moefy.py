"""MoEfication: cluster every GEGLU gate into experts, and build the MoE
routing interventions from the expert labels (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/moefication/moefy.py`: the gates'
rows (`gate_weights`), their clustering into equal-size experts
(`moefy_unet`, `moefication/cluster.py`) with its `param_split.npz`
artifact, the routing interventions, the AddExperts boost, and the FF
layers' state-dict prefixes.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.config import UNetConfig, resolve_device
from diffusion_models_moe_tpu_torch.moefication.cluster import (
    balanced_kmeans, random_split_labels)
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


def gate_weights(unet_state: dict, cfg: UNetConfig) -> list[np.ndarray]:
    """The gate half of each FF's up-projection, rows = neurons: rows
    [H:2H] of `ff.net.0.proj.weight` ((2H, D) in torch layout), as (H, D)
    float64 arrays, in FF order."""
    out = []
    for path in ff_param_paths(cfg):
        w = unet_state[f"{path}.net.0.proj.weight"].detach()
        out.append(w[w.shape[0] // 2:].to("cpu", torch.float64).numpy())
    return out


def moefy_unet(unet_state: dict, cfg: UNetConfig, expert_size: int = 20,
               method: str = "sinkhorn", seed: int = 0,
               save_path: Optional[str] = None, random_split: bool = False,
               device="cuda") -> dict[str, np.ndarray]:
    """Cluster every FF layer's gate rows into experts of `expert_size`
    neurons: {layer_name: (H,) int64 labels}, saved as one `.npz` at
    `save_path` where given. `device` is where the Sinkhorn plans run (the
    card unless the caller names another); `random_split` gives the
    contiguous control split instead."""
    labels = {}
    for idx, w in enumerate(gate_weights(unet_state, cfg)):
        h = w.shape[0]
        labels[layer_name(idx)] = (
            random_split_labels(h, expert_size) if random_split
            else balanced_kmeans(w, h // expert_size, seed=seed,
                                 method=method, device=device))
    if save_path is not None:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        np.savez(save_path, **labels)
    return labels


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
