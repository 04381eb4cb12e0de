"""Shared host-side image coercion for the judge preprocessors (PyTorch
port; a copy of `diffusion_models_moe_tpu/imaging.py`)."""
from __future__ import annotations

import numpy as np


def to_uint8_rgb(image) -> np.ndarray:
    """Any judge input (PIL image, HWC/HW array, float [0,255] or uint8) ->
    (H, W, 3) uint8. Shared by the NudeNet, LLaVA, and Qwen2-VL
    preprocessors so input-handling fixes land once."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img, np.float32), 0, 255).astype(np.uint8)
    return img[..., :3]
