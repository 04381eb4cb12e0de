"""Concept-erasure masks: storage, unions, removal interventions, and baking
into a pruned UNet state dict (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/erasure/masks.py`. Masks are dense
boolean numpy arrays keyed by FF layer index. Removal interventions are the
port's `LayerIntervention`s, made on `device`; the bake functions act on the
port's UNet state dict: W2 is `ff.net.2.weight` (D, H), the gate half of the
up-projection is rows H:2H of `ff.net.0.proj.weight` (2H, D) and its bias.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.config import resolve_device
from diffusion_models_moe_tpu_torch.moefication.moefy import (
    build_moe_interventions, ff_param_paths)
from diffusion_models_moe_tpu_torch.taps import (GEGLU_REMOVAL_FILL,
                                                 Interventions,
                                                 LayerIntervention, layer_name)

MaskDict = dict[int, np.ndarray]   # layer index -> (T, ...) bool


# --------------------------------------------------------------------- storage
def save_masks(path: str, masks: MaskDict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{str(l): np.asarray(m, bool)
                                 for l, m in masks.items()})


def load_masks(path: str) -> MaskDict:
    with np.load(path) as z:
        return {int(k): z[k] for k in z.files}


def union_masks(mask_sets: Sequence[MaskDict]) -> MaskDict:
    """OR of masks across concepts, layer by layer."""
    out: MaskDict = {}
    for masks in mask_sets:
        for l, m in masks.items():
            out[l] = (out[l] | np.asarray(m, bool)) if l in out else np.asarray(m, bool)
    return out


def union_over_timesteps(masks: MaskDict, select_ratio: float) -> MaskDict:
    """Collapse (T, ...) masks to one static mask per layer: keep entries set
    in more than `select_ratio * T` timesteps."""
    out = {}
    for l, m in masks.items():
        m = np.asarray(m, bool)
        out[l] = m.sum(axis=0) > (select_ratio * m.shape[0])
    return out


def mask_iou(a: MaskDict, b: MaskDict) -> float:
    """Intersection over union of two mask sets."""
    inter = union = 0
    for l in set(a) | set(b):
        ma = np.asarray(a.get(l, 0), bool)
        mb = np.asarray(b.get(l, 0), bool)
        inter += int(np.sum(ma & mb))
        union += int(np.sum(ma | mb))
    return inter / union if union else 0.0


# -------------------------------------------------------- dynamic interventions
def _n_layers_for(masks: MaskDict, n_layers: Optional[int]) -> int:
    """Cover every masked layer, and at least SD1.x's 16."""
    if n_layers is not None:
        return n_layers
    return max(1 + max((int(l) for l in masks), default=15), 16)


def _windowed(m: np.ndarray, max_timestep: Optional[int]) -> np.ndarray:
    """Apply the exclusive removal window t < max_timestep to a (T, ...) or
    static (...) mask. Steps read per-step masks clamped to the last row
    (`taps.step_row`), so a static mask under a window becomes
    (max_timestep + 1, ...) with an all-False last row, which every step
    past the window reads."""
    if max_timestep is None:
        return m
    if m.ndim >= 2 and m.shape[0] > 1:
        m = m.copy()
        m[max_timestep:] = False
        return m
    static = m[0] if m.ndim >= 2 else m
    rows = np.repeat(static[None], max_timestep, axis=0)
    return np.concatenate([rows, np.zeros_like(static[None])], axis=0)


def neuron_removal_interventions(
        masks: MaskDict, n_layers: Optional[int] = None,
        fill: float = GEGLU_REMOVAL_FILL, max_timestep: Optional[int] = None,
        device="cuda") -> Interventions:
    """(T, H) or (H,) skilled-neuron masks -> RemoveNeurons interventions.
    `fill` is -0.17 for GEGLU, 0.0 for the GELU path; removal is active for
    t < `max_timestep` (exclusive) when it is given."""
    device = resolve_device(device)
    ivs = []
    for l in range(_n_layers_for(masks, n_layers)):
        if l not in masks:
            ivs.append(None)
            continue
        m = _windowed(np.asarray(masks[l], bool), max_timestep)
        if m.ndim == 1:
            m = m[None, :]
        ivs.append(LayerIntervention(
            neuron_mask=torch.as_tensor(m, device=device), neuron_fill=fill))
    return tuple(ivs)


def expert_removal_interventions(
        expert_masks: MaskDict, labels: dict[str, np.ndarray],
        topk_ratio: float, n_layers: Optional[int] = None,
        max_timestep: Optional[int] = 20, device="cuda",
        dtype: torch.dtype = torch.float32) -> Interventions:
    """(T, E) or (E,) skilled-expert masks + cluster labels -> RemoveExperts
    routing interventions; experts are removed for t < `max_timestep`
    (exclusive). Patterns are made on `device` in `dtype`."""
    remove = {}
    for l, m in expert_masks.items():
        rm = _windowed(np.asarray(m, bool), max_timestep)
        if rm.ndim == 1:
            rm = rm[None, :]
        remove[layer_name(l)] = rm
    if n_layers is None:
        n_layers = max(_n_layers_for(expert_masks, None),
                       1 + max((int(k.rsplit("_", 1)[1]) for k in labels),
                               default=15))
    return build_moe_interventions(labels, topk_ratio, n_layers=n_layers,
                                   expert_remove=remove, device=device,
                                   dtype=dtype)


def wanda_removal_interventions(masks_dh: MaskDict,
                                n_layers: Optional[int] = None,
                                device="cuda") -> Interventions:
    """Wanda (D, H) or (T, D, H) masks, in the (out, in) orientation that
    `wanda_pipeline` emits -> out_weight_mask interventions. The port's
    `out_weight_mask` keeps that orientation, W2's nn.Linear layout."""
    device = resolve_device(device)
    ivs = []
    for l in range(_n_layers_for(masks_dh, n_layers)):
        if l not in masks_dh:
            ivs.append(None)
            continue
        ivs.append(LayerIntervention(out_weight_mask=torch.as_tensor(
            np.asarray(masks_dh[l], bool), device=device)))
    return tuple(ivs)


# ------------------------------------------------------------------ mask baking
def bake_wanda_masks(unet_state: dict, cfg, masks_dh: MaskDict) -> dict:
    """Statically prune the FF output projections, W2 *= (1 - mask), with
    static (D, H) masks. Returns a new state dict; the input is not
    changed."""
    state = dict(unet_state)
    paths = ff_param_paths(cfg)
    for l, mask in masks_dh.items():
        key = f"{paths[l]}.net.2.weight"
        w = state[key]                                          # (D, H)
        keep = 1.0 - torch.as_tensor(np.asarray(mask, np.float32),
                                     device=w.device)
        state[key] = (w.float() * keep).to(w.dtype)
    return state


def bake_gate_masks(unet_state: dict, cfg, masks_h: MaskDict) -> dict:
    """Statically prune gate neurons: rows H:2H of `ff.net.0.proj.weight`
    and the same entries of its bias are zeroed where the (H,) mask is set
    (the bias too, so a pruned neuron does not emit gelu(bias) * hidden).
    Returns a new state dict; the input is not changed."""
    state = dict(unet_state)
    paths = ff_param_paths(cfg)
    for l, mask in masks_h.items():
        wkey, bkey = f"{paths[l]}.net.0.proj.weight", f"{paths[l]}.net.0.proj.bias"
        w, b = state[wkey], state[bkey]                         # (2H, D), (2H,)
        h = w.shape[0] // 2
        keep = torch.ones(2 * h, device=w.device)
        keep[h:] = 1.0 - torch.as_tensor(np.asarray(mask, np.float32),
                                         device=w.device)
        state[wkey] = (w.float() * keep[:, None]).to(w.dtype)
        state[bkey] = (b.float() * keep).to(b.dtype)
    return state
