"""Art-style removal scoring with a style classifier + CLIP image similarity
(PyTorch port of `diffusion_models_moe_tpu/benchmarks/art_removal.py`).

Reference: benchmarks/art_removal.py — walks per-concept folders of paired
`sd*.png` / `removed*.png` images (the eval runner's own naming), asks a
129-class painting-style classifier whether the artist's style label is still
among the top-k predictions of the removed image, and reports CLIP
image-image cosine similarity between each pair. Per-concept `results.json`
plus an overall `results.json` with `all_acc_mean` / `all_sim_mean` match the
reference's outputs (art_removal.py:108-153).

The reference's classifier is an external fine-tuned ViT checkpoint
(`--style_classifer_path`, Diffusion-MU-Attack); here the judge is an
injected `classify_ranked(images) -> list[list[str]]` callable (full ranked
label lists, batched: one call per folder per split) over images (N, 3, H,
W) in [0, 1]. `make_zero_shot_style_ranker` builds a native weightless
judge from the CLIP towers.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.benchmarks.clip_metrics import _np
from diffusion_models_moe_tpu_torch.benchmarks.memorization import _l2n

# Carried verbatim from the reference (art_removal.py:10-26): the mapping from
# concept-folder names to the style classifier's label ids, and the per-artist
# top-k membership window used on the REMOVED image (the pre-image always uses
# top-10, art_removal.py:90).
ART_STYLE_LABELS: dict[str, str] = {
    "Van Gogh": "vincent-van-gogh",
    "Monet": "claude-monet",
    "Pablo Picasso": "pablo-picasso",
    "Leonardo Da Vinci": "leonardo-da-vinci",
    "Salvador Dali": "salvador-dali",
    "Rembrandt": "rembrandt",
}
ART_STYLE_TOPK: dict[str, int] = {
    "Van Gogh": 3,
    "Monet": 3,
    "Pablo Picasso": 3,
    "Leonardo Da Vinci": 3,
    "Salvador Dali": 1,
    "Rembrandt": 3,
}


def style_label(concept: str,
                labels_map: Optional[Mapping[str, str]] = None) -> str:
    """Folder name -> classifier label id; unknown artists slugify
    (lower-case, spaces to dashes), matching the wikiart label convention the
    reference table uses."""
    table = ART_STYLE_LABELS if labels_map is None else labels_map
    if concept in table:
        return table[concept]
    return concept.strip().lower().replace(" ", "-")


def _png(path: str) -> torch.Tensor:
    from PIL import Image
    arr = np.asarray(Image.open(path), np.float32) / 255.0
    return torch.from_numpy(arr).permute(2, 0, 1)


def _load_pairs(path: str) -> tuple[list[str], torch.Tensor, torch.Tensor]:
    """sd*/removed* paired PNGs in one folder -> (names, pre, post) stacks
    (N, 3, H, W) in [0, 1]."""
    files = sorted(f for f in os.listdir(path)
                   if f.startswith("sd") and f.endswith(".png"))
    pre = [_png(os.path.join(path, f)) for f in files]
    post = [_png(os.path.join(path, f.replace("sd", "removed", 1)))
            for f in files]
    return files, torch.stack(pre), torch.stack(post)


def art_style_scores(classify_ranked: Callable[[torch.Tensor],
                                                Sequence[Sequence[str]]],
                     featurize: Callable[[torch.Tensor], np.ndarray],
                     pre: torch.Tensor, post: torch.Tensor, concept: str,
                     labels_map: Optional[Mapping[str, str]] = None,
                     top_k: Optional[Mapping[str, int]] = None,
                     top_k_pre: int = 10) -> dict:
    """Score one concept's (N, 3, H, W) pre/post stacks.

    Semantics carried verbatim from the reference (art_removal.py:78-122):
      - `acc` appends the REMOVED image's top-k style membership for EVERY
        pair, regardless of whether the pre-image was classified correctly —
        the reference's validity gate is commented out in the original; pairs
        whose pre-image misses top-10 are only COUNTED in `num_invalid`.
      - `sim` is the CLIP image-image cosine of each pre/post pair.
    A LOWER mean_acc means better style removal.
    """
    label = style_label(concept, labels_map)
    k = (ART_STYLE_TOPK if top_k is None else top_k).get(concept, 3)
    ranked_pre = classify_ranked(pre)
    ranked_post = classify_ranked(post)
    acc = [1 if label in list(r)[:k] else 0 for r in ranked_post]
    num_invalid = sum(1 for r in ranked_pre if label not in list(r)[:top_k_pre])

    sim = np.sum(_l2n(featurize(pre)) * _l2n(featurize(post)), axis=-1)
    return {"acc": acc, "sim": [float(s) for s in sim],
            "mean_acc": float(np.mean(acc)) if acc else 0.0,
            "mean_sim": float(sim.mean()) if len(sim) else 0.0,
            "num_invalid": int(num_invalid)}


def art_removal_score_protocol(root_dir: str,
                               classify_ranked: Callable,
                               featurize: Callable,
                               concepts: Optional[Sequence[str]] = None,
                               labels_map: Optional[Mapping[str, str]] = None,
                               top_k: Optional[Mapping[str, int]] = None
                               ) -> dict:
    """Walk `root_dir`'s per-concept folders (reference: art_removal.py:60-153),
    score each with `art_style_scores`, write per-concept `results.json` and an
    overall `{all_acc_mean, all_sim_mean}` at the root. Returns the overall
    dict plus per-concept results under "concepts"."""
    if concepts is None:
        concepts = sorted(d for d in os.listdir(root_dir)
                          if os.path.isdir(os.path.join(root_dir, d)))
    per_concept = {}
    for concept in concepts:
        path = os.path.join(root_dir, concept)
        _, pre, post = _load_pairs(path)
        res = art_style_scores(classify_ranked, featurize, pre, post, concept,
                               labels_map=labels_map, top_k=top_k)
        with open(os.path.join(path, "results.json"), "w") as f:
            json.dump(res, f)
        per_concept[concept] = res
    overall = {
        "all_acc_mean": float(np.mean([r["mean_acc"]
                                       for r in per_concept.values()])),
        "all_sim_mean": float(np.mean([r["mean_sim"]
                                       for r in per_concept.values()])),
    }
    with open(os.path.join(root_dir, "results.json"), "w") as f:
        json.dump(overall, f)
    overall["concepts"] = per_concept
    return overall


def make_zero_shot_style_ranker(image_encode: Callable,
                                class_text_embs: np.ndarray,
                                class_labels: Sequence[str]) -> Callable:
    """Native weightless stand-in for the reference's fine-tuned style
    classifier: rank style labels by CLIP similarity of the image against
    per-style text embeddings (e.g. "a painting in the style of X" through
    `fid.make_clip_text_featurizer`). Returns images -> ranked label lists."""
    embs = _np(class_text_embs).astype(np.float64)
    embs = embs / np.maximum(np.linalg.norm(embs, axis=-1, keepdims=True),
                             1e-12)
    labels = list(class_labels)

    def classify_ranked(images) -> list[list[str]]:
        emb = _np(image_encode(images)).astype(np.float64)
        emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True),
                               1e-12)
        order = np.argsort(-(emb @ embs.T), axis=-1)
        return [[labels[j] for j in row] for row in order]

    return classify_ranked
