"""COCO caption sampling for FID/eval protocols (PyTorch port; a copy of
`diffusion_models_moe_tpu/data/coco.py`).

Mirrors the reference's loader semantics (reference: utils.py:140-150
`coco_dataset`): sample N (caption, image path) pairs from a COCO-2014 style
annotations JSON with a fixed seed so eval sets are reproducible.
"""
from __future__ import annotations

import json
import os

import numpy as np


def coco_dataset(data_root: str, n_samples: int = 10000, seed: int = 0,
                 split: str = "val2014") -> tuple[list[str], list[str]]:
    """Returns (captions, image_paths), seeded sample without replacement."""
    ann_path = os.path.join(data_root, "annotations", f"captions_{split}.json")
    with open(ann_path) as f:
        data = json.load(f)
    id_to_file = {img["id"]: img["file_name"] for img in data["images"]}
    anns = data["annotations"]
    rng = np.random.RandomState(seed)
    idx = rng.choice(len(anns), size=min(n_samples, len(anns)), replace=False)
    captions, paths = [], []
    for i in idx:
        a = anns[int(i)]
        captions.append(a["caption"].strip())
        paths.append(os.path.join(data_root, split, id_to_file[a["image_id"]]))
    return captions, paths


def load_prompt_csv(path: str, prompt_col: str = "prompt",
                    seed_col: str = "evaluation_seed"):
    """Concept-removal CSVs with per-prompt seeds (the artist/I2P datasets'
    format; reference: benchmarks/artist_removal.py:59-70)."""
    import csv
    prompts, seeds = [], []
    with open(path) as f:
        for row in csv.DictReader(f):
            prompts.append(row[prompt_col])
            seeds.append(int(float(row.get(seed_col, 0) or 0)))
    return prompts, seeds
