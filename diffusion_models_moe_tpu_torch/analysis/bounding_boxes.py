"""Bounding-box grounded attribution: image-space boxes -> per-layer token
masks (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/analysis/bounding_boxes.py`: a
grounding model answers "Frame the location of the <object>" with
`<box>(x1,y1),(x2,y2)</box>` in 1000-normalised coordinates (or the bare
pair); the box is projected into each FF layer's latent token grid and
becomes the boolean `LayerIntervention.token_mask` that restricts the tap
statistics to those tokens. The grounding model is any callable
`ground(image, prompt) -> reply`.
"""
from __future__ import annotations

import math
import re
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.config import resolve_device
from diffusion_models_moe_tpu_torch.taps import LayerIntervention

_BOX_RE = re.compile(r"<box>\((\d+),(\d+)\),\((\d+),(\d+)\)</box>")
_BARE_BOX_RE = re.compile(r"\((\d+),\s*(\d+)\)\s*,\s*\((\d+),\s*(\d+)\)")


def parse_box(text: str, coord_scale: float = 0.5) -> Optional[tuple]:
    """Extract (x1, y1, x2, y2) from a grounding reply. The reference halves the
    model's 1000-normalized coordinates for its 512px images
    (reference: bounding_boxes/bb_utils.py:24-35). Accepts Qwen-VL-Chat's
    `<box>(..),(..)</box>` and the bare `(x1,y1),(x2,y2)` left after a
    decoder strips Qwen2-VL's box marker tokens."""
    m = _BOX_RE.search(text) or _BARE_BOX_RE.search(text)
    if not m:
        return None
    x1, y1, x2, y2 = (int(g) * coord_scale for g in m.groups())
    return (x1, y1, x2, y2)


def layer_token_mask(box: tuple, seq_len: int, image_size: int = 512
                     ) -> np.ndarray:
    """Project an image-space box into one layer's flattened latent token grid.

    The layer's grid is sqrt(seq_len) x sqrt(seq_len); image coordinates divide by
    image_size / grid, and (x, y) swap into (row, col)
    (reference: bounding_boxes/save_bb.py:44-94)."""
    grid = int(math.isqrt(seq_len))
    if grid * grid != seq_len:
        raise ValueError(f"seq_len {seq_len} is not a square grid")
    scale = image_size / grid
    x1, y1, x2, y2 = box
    c1, c2 = int(x1 / scale), min(int(math.ceil(x2 / scale)), grid)
    r1, r2 = int(y1 / scale), min(int(math.ceil(y2 / scale)), grid)
    mask = np.zeros((grid, grid), bool)
    mask[r1:max(r2, r1 + 1), c1:max(c2, c1 + 1)] = True
    return mask.reshape(-1)


def unet_layer_seq_lens(sample_size: int = 64) -> list[int]:
    """Per-FF-layer latent token counts in canonical order for SD1.x geometry:
    down [4096,4096,1024,1024,256,256], mid [64], up [256,256,256, 1024x3, 4096x3]
    (reference: bounding_boxes/save_bb.py:122)."""
    s = sample_size
    down = [s * s, s * s, (s // 2) ** 2, (s // 2) ** 2,
            (s // 4) ** 2, (s // 4) ** 2]
    mid = [(s // 8) ** 2]
    up = ([(s // 4) ** 2] * 3 + [(s // 2) ** 2] * 3 + [s * s] * 3)
    return down + mid + up


def boxes_to_interventions(box: tuple, seq_lens: Sequence[int],
                           image_size: int = 512, device="cuda") -> tuple:
    """One image-space box -> per-layer token_mask interventions, their
    masks on `device` (the card unless the caller names another)."""
    device = resolve_device(device)
    return tuple(LayerIntervention(token_mask=torch.as_tensor(
        layer_token_mask(box, seq, image_size), device=device))
        for seq in seq_lens)


def make_chat_grounder(vqa: Callable,
                       warmup: str = "what is this?") -> Callable:
    """The two-turn grounding chat: 'what is this?', then the framing
    request, where `vqa` has a multi-turn `.chat`; a plain single-turn
    callable is used as it is."""
    chat = getattr(vqa, "chat", None)
    if chat is None:
        return vqa

    def ground(image, prompt: str) -> str:
        return chat(image, [warmup, prompt])[-1]

    return ground


def make_grounded_masks(ground: Callable[[object, str], str], image,
                        object_name: str, seq_lens: Sequence[int],
                        image_size: int = 512, coord_scale: float = 0.5,
                        device="cuda") -> Optional[tuple]:
    """Full grounding flow: query the grounding model, parse, project.
    Returns interventions (masks on `device`), or None if the model gave no
    box."""
    reply = ground(image, f"Frame the location of the {object_name}")
    box = parse_box(reply, coord_scale)
    if box is None:
        return None
    return boxes_to_interventions(box, seq_lens, image_size, device)
