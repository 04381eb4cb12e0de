"""MIMIC-CXR image/report dataset for ReLUfication fine-tuning (PyTorch
port: a copy of the numpy-only `diffusion_models_moe_tpu/data/mimic_cxr.py`,
which the port may not import).

Rebuild of the reference's chest-X-ray training branch
(reference: get_dataset_mimic_cxr.py:10+, wired into train_relufied_sd.py:538-578):
a CSV of (image path, report text) pairs, center-cropped/resized images in [-1, 1],
and tokenized captions. Pure-numpy batching, images NHWC as
`training/trainer.py` takes them.
"""
from __future__ import annotations

import csv
import os
from typing import Callable, Iterator, Optional

import numpy as np


class MimicCXRDataset:
    def __init__(self, csv_path: str, image_root: str,
                 image_col: str = "path", text_col: str = "report",
                 resolution: int = 512):
        self.rows = []
        with open(csv_path) as f:
            for row in csv.DictReader(f):
                self.rows.append((row[image_col], row[text_col]))
        self.image_root = image_root
        self.resolution = resolution

    def __len__(self):
        return len(self.rows)

    def load_image(self, rel_path: str) -> np.ndarray:
        from PIL import Image
        img = Image.open(os.path.join(self.image_root, rel_path)).convert("RGB")
        w, h = img.size
        side = min(w, h)
        img = img.crop(((w - side) // 2, (h - side) // 2,
                        (w + side) // 2, (h + side) // 2))
        img = img.resize((self.resolution, self.resolution))
        return np.asarray(img, np.float32) / 127.5 - 1.0

    def batches(self, batch_size: int, tokenize: Callable, seed: int = 0,
                epochs: Optional[int] = None) -> Iterator[dict]:
        if len(self.rows) < batch_size:
            # drop-last batching would yield nothing and an epochs=None loop
            # would spin forever without producing a batch
            raise ValueError(f"dataset has {len(self.rows)} rows < "
                             f"batch_size {batch_size}")
        rng = np.random.RandomState(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(self.rows))
            for start in range(0, len(order) - batch_size + 1, batch_size):
                idx = order[start:start + batch_size]
                images = np.stack([self.load_image(self.rows[i][0])
                                   for i in idx])
                ids = tokenize([self.rows[i][1] for i in idx])
                yield {"images": images, "input_ids": np.asarray(ids)}
            epoch += 1
