"""Object erasure evaluation: classification accuracy on erase vs keep prompt
sets (PyTorch port of `diffusion_models_moe_tpu/benchmarks/object_erase.py`).

Rebuild of the reference's imagenette protocol (reference:
benchmarks/object_erase.py:18-100, 52-75 CustomDatasetErasure): generate
images for the erased object's prompts and for the other (keep) objects'
prompts, classify each image, and report top-1/top-5 accuracy on both
splits: erasure succeeds when erase accuracy drops and keep accuracy holds.

The classifier is pluggable, `classify(images) -> (B, n_classes) logits`
with images (B, 3, H, W) in [0, 1]: zero-shot CLIP over the class names
(`make_clip_zero_shot_classifier`), the port's ResNet-50 on torchvision
weights (`make_resnet_classifier`, on the card), or torchvision's own model
where that package is installed (`load_torchvision_classifier`).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.benchmarks.clip_metrics import _np
from diffusion_models_moe_tpu_torch.data.prompts import IMAGENETTE


def erase_keep_prompts(target: str,
                       classes: Sequence[str] = tuple(IMAGENETTE),
                       per_class: int = 10) -> tuple[list, list, list]:
    """(erase_prompts, keep_prompts, keep_labels): photo prompts per class
    (reference prompt format: benchmarks/object_erase.py)."""
    erase = [f"a photo of a {target}"] * per_class
    keep, keep_labels = [], []
    for ci, c in enumerate(classes):
        if c == target:
            continue
        keep += [f"a photo of a {c}"] * per_class
        keep_labels += [ci] * per_class
    return erase, keep, keep_labels


def topk_accuracy(logits: np.ndarray, labels: Sequence[int],
                  k: int = 1) -> float:
    logits = _np(logits)
    labels = np.asarray(labels)
    topk = np.argsort(-logits, axis=-1)[:, :k]
    return float(np.mean([l in t for l, t in zip(labels, topk)]))


def make_clip_zero_shot_classifier(image_encode: Callable,
                                   class_text_embs: np.ndarray) -> Callable:
    """images -> logits over classes via CLIP similarities (native judge)."""
    def classify(images) -> np.ndarray:
        emb = _np(image_encode(images))
        return 100.0 * emb @ _np(class_text_embs).T

    return classify


def object_erasure_scores(classify: Callable,
                          erased_images, keep_images,
                          target_idx: int, keep_labels: Sequence[int]) -> dict:
    """Erase/keep accuracy table (reference result shape:
    benchmarks/object_erase.py top-1/top-5 on both splits)."""
    er_logits = classify(erased_images)
    kp_logits = classify(keep_images)
    return {
        "erase_top1": topk_accuracy(er_logits,
                                    [target_idx] * len(er_logits), 1),
        "erase_top5": topk_accuracy(er_logits,
                                    [target_idx] * len(er_logits), 5),
        "keep_top1": topk_accuracy(kp_logits, keep_labels, 1),
        "keep_top5": topk_accuracy(kp_logits, keep_labels, 5),
    }


def word_match_accuracy(logits: np.ndarray, categories: Sequence[str],
                        labels: Sequence[str], k: int = 5) -> float:
    """The reference's ACTUAL erasure accuracy metric, carried verbatim
    (reference: benchmarks/object_erase.py:248-295): for each image, take the
    top-k predicted category NAMES and count the image correct (0/1) if any
    prediction shares a whole word with the true label — e.g. label
    "french horn" matches prediction "French horn" via "horn" even though the
    case-differing "French" does not. Quirks reproduced on purpose:

      - predictions keep the category list's ORIGINAL case while the label is
        lowercased; the reference computes a lowercased `all_categories` and
        a validity gate but both are commented out / unused (:249-250,
        :269-272), so every image counts in the denominator;
      - word containment is exact membership of a prediction word in the
        label's word list (first matching prediction wins, then break).

    `categories` maps class index -> name; with the native zero-shot CLIP
    judge this is the imagenette class list, with a ported ResNet-50 judge it
    is the ImageNet-1k name list the weights shipped with (injected — the
    reference pulls it from torchvision `weights.meta["categories"]`).
    Returns acc = mean over images (reference: results['acc'], :292-295).
    """
    logits = _np(logits)
    topk = np.argsort(-logits, axis=-1)[:, :k]
    hits = 0
    for row, label in zip(topk, labels):
        label_words = str(label).strip().lower().split(" ")
        for idx in row:
            pred_words = str(categories[idx]).split(" ")
            if any(w in label_words for w in pred_words):
                hits += 1
                break
    return float(hits / len(topk)) if len(topk) else 0.0


def erasure_word_match_protocol(classify: Callable, images,
                                labels: Sequence[str],
                                categories: Sequence[str],
                                k: int = 5) -> dict:
    """Reference result shape for one erase/keep split: classify the stack,
    word-match the top-k names against each image's true label string, return
    {"acc": ...} exactly as the reference writes to results.json
    (benchmarks/object_erase.py:292-298)."""
    logits = classify(images)
    return {"acc": word_match_accuracy(logits, categories, labels, k=k)}


def make_resnet_classifier(weights_path: str, num_classes: int = 1000,
                           batch: int = 64, device="cuda") -> Callable:
    """The port's ResNet-50 judge on `device` (the card unless the caller
    asks for another) from a torchvision-layout state dict (.pt/.pth, or
    .npz of the same keys), `models/backbones.py` in place of the
    reference's torchvision model (benchmarks/object_erase.py:77-100)."""
    from diffusion_models_moe_tpu_torch.models.backbones import (
        ResNet, preprocess_imagenet, resnet50_config, resnet_logits)
    from diffusion_models_moe_tpu_torch.weights.port_torchvision import (
        load_state_dict, resnet_state_dict)

    cfg = resnet50_config(num_classes)
    model = ResNet(cfg, device=device)
    model.load_state_dict(resnet_state_dict(load_state_dict(weights_path),
                                            cfg))
    dev = model.conv1.weight.device

    def classify(images) -> np.ndarray:
        images = torch.as_tensor(images, dtype=torch.float32)
        outs = [resnet_logits(model, preprocess_imagenet(
            images[s:s + batch].to(dev))).cpu().numpy()
            for s in range(0, len(images), batch)]
        return np.concatenate(outs)

    return classify


def load_torchvision_classifier(arch: str = "resnet50",
                                weights_path: Optional[str] = None,
                                device="cuda") -> Callable:
    """torchvision's own model on `device` where that package and the
    weights exist locally (the reference's ResNet-50/ViT-H judges;
    reference: benchmarks/object_erase.py:77-100)."""
    from diffusion_models_moe_tpu_torch.config import resolve_device
    dev = resolve_device(device)
    import torchvision.models as tvm  # type: ignore

    from diffusion_models_moe_tpu_torch.models.backbones import \
        preprocess_imagenet
    model = getattr(tvm, arch)()
    if weights_path:
        model.load_state_dict(torch.load(weights_path, map_location="cpu",
                                         weights_only=True))
    model = model.to(dev).eval()

    def classify(images) -> np.ndarray:
        x = torch.as_tensor(images, dtype=torch.float32).to(dev)
        with torch.no_grad():
            return model(preprocess_imagenet(x)).cpu().numpy()

    return classify
