"""Memorization evaluation: similarity of generations to memorized LAION
images (PyTorch port of `diffusion_models_moe_tpu/benchmarks/memorization.py`).

Protocol from the reference (benchmarks/inference_mem.py:46-83,117-168): for 500
memorized prompts, generate with/without erasure and measure (a) SSCD copy-detection
similarity against the LAION ground-truth image and (b) CLIP score against the prompt.

The embedder is injected (`embed(images) -> (B, D)`, images (B, 3, H, W) in
[0, 1]): SSCD's own torchscript file (`load_sscd`), the port's ResNet-50 +
GeM + projection on its weights (`make_native_sscd`), or a CLIP featurizer
as a copy-detection proxy with the same cosine aggregation.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.config import resolve_device
from diffusion_models_moe_tpu_torch.models.backbones import preprocess_imagenet

Embedder = Callable[[torch.Tensor], np.ndarray]


def load_sscd(path: str, device="cuda") -> Embedder:
    """SSCD's torchscript model on `device`: ImageNet-normalized images in,
    L2-normalized (B, D) numpy embeddings out."""
    dev = resolve_device(device)
    model = torch.jit.load(path, map_location=dev).eval()

    def embed(images) -> np.ndarray:
        x = torch.as_tensor(images, dtype=torch.float32).to(dev)
        with torch.no_grad():
            emb = model(preprocess_imagenet(x)).float().cpu().numpy()
        return emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True),
                                1e-12)

    return embed


def make_native_sscd(weights_path: str, batch: int = 32,
                     device="cuda") -> Embedder:
    """The port's SSCD judge on `device`: ResNet-50 trunk + GeM(p=3) +
    projection (`models/backbones.py:sscd_embed`) from SSCD's torchscript or
    a plain state dict (.pt, or .npz of the same keys), in place of the
    reference's torchscript call (benchmarks/inference_mem.py:46-68)."""
    from diffusion_models_moe_tpu_torch.models.backbones import (ResNetConfig,
                                                                 SSCD,
                                                                 sscd_embed)
    from diffusion_models_moe_tpu_torch.weights.port_torchvision import (
        load_state_dict, sscd_state_dict)
    dev = resolve_device(device)
    sd = sscd_state_dict(load_state_dict(weights_path), ResNetConfig())
    model = SSCD(ResNetConfig(), dims=sd["embeddings.weight"].shape[0],
                 device=dev)
    model.load_state_dict(sd)

    def embed(images) -> np.ndarray:
        images = torch.as_tensor(images, dtype=torch.float32)
        outs = [sscd_embed(model, preprocess_imagenet(
            images[s:s + batch].to(dev))).cpu().numpy()
            for s in range(0, len(images), batch)]
        return np.concatenate(outs)

    return embed


def _l2n(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, np.float64)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def similarity_matrix(emb_a, emb_b) -> np.ndarray:
    """Cosine similarity matrix (embeddings normalized defensively — SSCD
    outputs are unit-norm but injected featurizers may not be)."""
    return _l2n(emb_a) @ _l2n(emb_b).T


def memorization_scores(gen_embs, gt_embs) -> dict:
    """Pairwise generation-vs-ground-truth similarity stats
    (reference: benchmarks/inference_mem.py:46-68 measure_SSCD_similarity)."""
    sims = np.sum(_l2n(gen_embs) * _l2n(gt_embs), axis=-1)
    return {
        "mean_similarity": float(sims.mean()),
        "max_similarity": float(sims.max()),
        "frac_above_0.5": float((sims > 0.5).mean()),
        "per_prompt": sims.tolist(),
    }
