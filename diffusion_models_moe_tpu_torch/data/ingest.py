"""Generic image+caption dataset ingestion for the training loop (PyTorch
port: a copy of the numpy-only `diffusion_models_moe_tpu/data/ingest.py`,
which the port may not import).

The reference trains through HuggingFace `datasets` — either a hub dataset or a
local imagefolder with an `image_column`/`caption_column` pair, center-crop /
random-crop + random-flip transforms, shuffled each epoch
(reference: train_relufied_sd.py:788-898). This module reproduces that path
without the `datasets` dependency: a metadata file (csv or jsonl, the
imagefolder convention: a `file_name` column plus a caption column) or parallel
lists feed an epoch-shuffled batch iterator whose dicts match
`training.trainer.train_relufied`'s contract:
``{'images': (B, H, W, 3) float32 in [-1, 1], 'input_ids': (B, S) int32}``.

Every batch is exactly `batch_size` (the tail of each epoch is dropped, as
drop_last=True dataloaders do), as in the JAX package. Images stay NHWC
numpy here; `training/trainer.py` moves them to the device as NCHW.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def read_metadata(root: str, caption_col: str = "text",
                  file_col: str = "file_name") -> Tuple[List[str], List[str]]:
    """(image paths, captions) from `root`/metadata.{csv,jsonl} — the HF
    imagefolder layout the reference's `--train_data_dir` consumes."""
    csv_path = os.path.join(root, "metadata.csv")
    jsonl_path = os.path.join(root, "metadata.jsonl")
    rows: List[dict] = []
    if os.path.exists(csv_path):
        with open(csv_path) as f:
            rows = list(csv.DictReader(f))
    elif os.path.exists(jsonl_path):
        with open(jsonl_path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    else:
        raise FileNotFoundError(
            f"no metadata.csv or metadata.jsonl under {root!r}")
    paths = [os.path.join(root, r[file_col]) for r in rows]
    captions = [str(r[caption_col]) for r in rows]
    return paths, captions


def _load_image(path: str, resolution: int, center_crop: bool,
                rng: np.random.RandomState) -> np.ndarray:
    """Resize shorter side to `resolution`, crop to square, scale to [-1, 1]
    (the reference's Resize + CenterCrop/RandomCrop + Normalize([0.5],[0.5]),
    train_relufied_sd.py:826-838)."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    w, h = img.size
    scale = resolution / min(w, h)
    img = img.resize((max(resolution, round(w * scale)),
                      max(resolution, round(h * scale))), Image.BILINEAR)
    w, h = img.size
    if center_crop:
        x0, y0 = (w - resolution) // 2, (h - resolution) // 2
    else:
        x0 = rng.randint(0, w - resolution + 1)
        y0 = rng.randint(0, h - resolution + 1)
    img = img.crop((x0, y0, x0 + resolution, y0 + resolution))
    arr = np.asarray(img, np.float32) / 127.5 - 1.0
    return arr


def image_caption_batches(
        paths: Sequence[str], captions: Sequence[str],
        tokenize: Callable[[Sequence[str]], np.ndarray],
        batch_size: int, resolution: int = 512, epochs: Optional[int] = None,
        seed: int = 0, center_crop: bool = False,
        random_flip: bool = True) -> Iterator[dict]:
    """Epoch-shuffled {'images', 'input_ids'} batches from image files.

    `epochs=None` streams forever (the trainer's `max_steps` bounds the run,
    with resume-time skipping handled there). Tail batches smaller than
    `batch_size` are dropped."""
    if len(paths) != len(captions):
        raise ValueError("paths and captions must be parallel lists")
    if len(paths) < batch_size:
        raise ValueError(
            f"need at least batch_size={batch_size} samples, got {len(paths)}")
    rng = np.random.RandomState(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(paths))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            imgs = np.stack([_load_image(paths[j], resolution, center_crop,
                                         rng) for j in idx])
            if random_flip:
                flip = rng.rand(batch_size) < 0.5
                imgs[flip] = imgs[flip, :, ::-1]
            ids = np.asarray(tokenize([captions[j] for j in idx]), np.int32)
            yield {"images": imgs.astype(np.float32), "input_ids": ids}
        epoch += 1


def prefetch(batches: Iterator[dict], depth: int = 2) -> Iterator[dict]:
    """Overlap host-side decode/augment with device compute: a daemon thread
    keeps up to `depth` batches ready while the train step runs (the
    role of the reference's multi-worker torch DataLoader,
    train_relufied_sd.py:898). Exceptions from the producer re-raise at the
    consumer's next pull."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for b in batches:
                q.put(b)
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True,
                     name="dmoe-ingest-prefetch").start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def imagefolder_batches(root: str, tokenize, batch_size: int,
                        caption_col: str = "text", prefetch_depth: int = 2,
                        **kw) -> Iterator[dict]:
    """`image_caption_batches` over an imagefolder (metadata.{csv,jsonl}),
    prefetched so PIL decode overlaps the train step (`prefetch_depth=0`
    disables)."""
    paths, captions = read_metadata(root, caption_col=caption_col)
    it = image_caption_batches(paths, captions, tokenize, batch_size, **kw)
    return prefetch(it, prefetch_depth) if prefetch_depth > 0 else it
