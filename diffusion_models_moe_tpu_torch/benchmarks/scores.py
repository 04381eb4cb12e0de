"""Directory-pair scoring: FID + LPIPS between baseline and removed image
sets (PyTorch port of `diffusion_models_moe_tpu/benchmarks/scores.py`).

Rebuild of the reference's UCE-protocol scorer (reference:
benchmarks/calculate_scores.py:70-79): given two directories of generated images
(sd_*.png vs removed_*.png from the eval runner), compute FID with a
featurizer of the port's and LPIPS either with the port's own AlexNet +
heads (`load_native_lpips`) or through the lpips package where it is
installed (`load_lpips`), both on the card unless the caller passes
device="cpu"; CLIP-feature distance is the clearly-labeled
fallback. Images are loaded as (B, 3, H, W) f32 tensors in [0, 1] on the CPU;
each featurizer moves them to its device.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.benchmarks.fid import (FeatureStats,
                                                           frechet_distance)


def list_image_pairs(a_dir: str, b_dir: str, a_prefix: str = "sd_",
                     b_prefix: str = "removed_") -> list[tuple[str, str]]:
    pairs = []
    for f in sorted(os.listdir(a_dir)):
        if not f.startswith(a_prefix):
            continue
        mate = f.replace(a_prefix, b_prefix, 1)
        if os.path.exists(os.path.join(b_dir, mate)):
            pairs.append((os.path.join(a_dir, f), os.path.join(b_dir, mate)))
    return pairs


def load_images(paths: Sequence[str], size: Optional[int] = 224
                ) -> torch.Tensor:
    """PNG/JPEG files -> (B, 3, H, W) f32 in [0, 1] (PIL's resize to
    `size` x `size` first where `size` is given)."""
    from PIL import Image
    out = []
    for p in paths:
        img = Image.open(p).convert("RGB")
        if size:
            img = img.resize((size, size))
        out.append(np.asarray(img, np.float32) / 255.0)
    return torch.from_numpy(np.stack(out)).permute(0, 3, 1, 2).contiguous()


def fid_between_dirs(a_dir: str, b_dir: str, featurize: Callable,
                     batch: int = 32, **pair_kw) -> float:
    """Streaming FID over directory pairs with the given (B, 3, H, W) ->
    (B, D) featurizer (reference protocol: benchmarks/calculate_scores.py
    FID)."""
    pairs = list_image_pairs(a_dir, b_dir, **pair_kw)
    sa, sb = FeatureStats(), FeatureStats()
    for start in range(0, len(pairs), batch):
        chunk = pairs[start:start + batch]
        sa.update(featurize(load_images([a for a, _ in chunk])))
        sb.update(featurize(load_images([b for _, b in chunk])))
    return frechet_distance(*sa.finalize(), *sb.finalize())


def load_native_lpips(alexnet_path: str, lins_path: str,
                      device="cuda") -> Callable:
    """The port's LPIPS (`models/backbones.py:lpips_distance`) on `device`:
    AlexNet features + learned linear heads from torch state dicts
    (torchvision alexnet + the lpips package's lin weights) or .npz of the
    same keys; only the weight files are external."""
    from diffusion_models_moe_tpu_torch.models.backbones import (LPIPS,
                                                                 make_lpips_fn)
    from diffusion_models_moe_tpu_torch.weights.port_torchvision import (
        load_state_dict, lpips_state_dict)
    model = LPIPS(device=device)
    model.load_state_dict(lpips_state_dict(load_state_dict(alexnet_path),
                                           load_state_dict(lins_path)))
    return make_lpips_fn(model)


def load_lpips(net: str = "alex", device="cuda") -> Callable:
    """The lpips package's LPIPS on `device`, where the package and its
    weights are installed (the JAX package's host-side judge). Returns
    fn(img_a, img_b) -> (B,) numpy distances."""
    from diffusion_models_moe_tpu_torch.config import resolve_device
    dev = resolve_device(device)
    try:
        import lpips  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "LPIPS is not available in this environment. Pass a custom "
            "perceptual distance fn(img_a, img_b) -> (B,) or use "
            "load_native_lpips / clip_perceptual_distance.") from e
    model = lpips.LPIPS(net=net).to(dev).eval()

    def dist(a, b) -> np.ndarray:
        ta = torch.as_tensor(a, dtype=torch.float32).to(dev)
        tb = torch.as_tensor(b, dtype=torch.float32).to(dev)
        with torch.no_grad():
            out = model(ta * 2 - 1, tb * 2 - 1)
        return out.float().cpu().numpy().reshape(-1)

    dist.metric_name = f"lpips_{net}"
    return dist


def clip_perceptual_distance(featurize: Callable) -> Callable:
    """Built-in perceptual-distance fallback: 1 - cosine in CLIP feature space."""
    def dist(a, b) -> np.ndarray:
        fa = torch.as_tensor(featurize(a)).double().cpu().numpy()
        fb = torch.as_tensor(featurize(b)).double().cpu().numpy()
        fa /= np.maximum(np.linalg.norm(fa, axis=-1, keepdims=True), 1e-12)
        fb /= np.maximum(np.linalg.norm(fb, axis=-1, keepdims=True), 1e-12)
        return 1.0 - np.sum(fa * fb, axis=-1)

    # NOT LPIPS: label the metric so downstream numbers can't be confused
    dist.metric_name = "clip_cosine_distance"
    return dist


def perceptual_between_dirs(a_dir: str, b_dir: str, dist: Callable,
                            batch: int = 16, **pair_kw) -> dict:
    pairs = list_image_pairs(a_dir, b_dir, **pair_kw)
    vals = []
    for start in range(0, len(pairs), batch):
        chunk = pairs[start:start + batch]
        vals.append(np.asarray(dist(load_images([a for a, _ in chunk]),
                                    load_images([b for _, b in chunk]))))
    vals = np.concatenate(vals) if vals else np.zeros(0)
    return {"metric": getattr(dist, "metric_name", "perceptual_distance"),
            "mean": float(vals.mean()) if vals.size else float("nan"),
            "n": int(vals.size)}
