"""Native CLIP-IQA: image quality / concept probability via prompt-pair
softmax (PyTorch port of `diffusion_models_moe_tpu/benchmarks/clip_iqa.py`).

The reference scores removal experiments with torchmetrics'
CLIPImageQualityAssessment (reference: modularity/clip_score.py:85-140 with
prompts ("quality", "noisiness", "sharpness", user pair);
benchmarks/gender_dataset.py:28 with ("quality", ("photo of a woman", "photo of
a man"))). The metric's math: embed the image and both prompts of each
(positive, negative) pair with CLIP, take the softmax of the logit-scaled
cosine similarities, and report the probability mass on the positive prompt.
Here that runs through the port's CLIP towers (`models/clip_vision.py`,
`models/clip_text.py`) on their device; there is no torchmetrics
dependency.

Built-in prompt-pair names mirror torchmetrics' table so reference configs
translate verbatim; user tuples are keyed ``user_defined_{i}`` in pair order,
also matching torchmetrics.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch

PromptSpec = Union[str, Tuple[str, str]]

# torchmetrics CLIPImageQualityAssessment built-in pairs (positive, negative).
BUILTIN_PROMPTS: Dict[str, Tuple[str, str]] = {
    "quality": ("Good photo.", "Bad photo."),
    "brightness": ("Bright photo.", "Dark photo."),
    "noisiness": ("Clean photo.", "Noisy photo."),
    "colorfullness": ("Colorful photo.", "Dull photo."),
    "sharpness": ("Sharp photo.", "Blurry photo."),
    "contrast": ("High contrast photo.", "Low contrast photo."),
    "complexity": ("Complex photo.", "Simple photo."),
    "natural": ("Natural photo.", "Synthetic photo."),
    "happy": ("Happy photo.", "Sad photo."),
    "scary": ("Scary photo.", "Peaceful photo."),
    "new": ("New photo.", "Old photo."),
    "warm": ("Warm photo.", "Cold photo."),
    "real": ("Real photo.", "Abstract photo."),
    "beautiful": ("Beautiful photo.", "Ugly photo."),
    "lonely": ("Lonely photo.", "Sociable photo."),
    "relaxing": ("Relaxing photo.", "Stressful photo."),
}


def resolve_prompt_pairs(
        prompts: Sequence[PromptSpec]) -> Dict[str, Tuple[str, str]]:
    """Named pairs for a mixed tuple of builtin names and (pos, neg) tuples.

    User-defined tuples are keyed ``user_defined_{i}`` in order of appearance
    (torchmetrics naming, which the reference indexes as e.g.
    ``clip_iqa_base['user_defined_0']``, modularity/clip_score.py:111)."""
    out: Dict[str, Tuple[str, str]] = {}
    n_user = 0
    for p in prompts:
        if isinstance(p, str):
            if p not in BUILTIN_PROMPTS:
                raise ValueError(f"unknown CLIP-IQA prompt name: {p!r}")
            out[p] = BUILTIN_PROMPTS[p]
        else:
            pos, neg = p
            out[f"user_defined_{n_user}"] = (str(pos), str(neg))
            n_user += 1
    return out


def design_test_prompt(adjective: str) -> Tuple[Tuple[str, str], int]:
    """The reference's per-concept user pair + t-test dof table
    (modularity/clip_score.py:17-27).

    NOTE: Monet / Pablo Picasso / manga deliberately share Van Gogh's prompt
    pair — that is the reference's own table verbatim (clip_score.py:21-22
    lists all four under one branch), carried over for score parity even
    though it measures Van-Gogh-ness for those concepts; pass an explicit
    pair to ClipIQA to score the true concept instead."""
    table = {
        "naked": (("not naked", "naked"), 17),
        "Van Gogh": (("photo", "a painting in the style of Van Gogh"), 19),
        "Monet": (("photo", "a painting in the style of Van Gogh"), 19),
        "Pablo Picasso": (("photo", "a painting in the style of Van Gogh"), 19),
        "manga": (("photo", "a painting in the style of Van Gogh"), 19),
        "gender": (("photo of a woman", "photo of a man"), 9),
        "bloody red": (("peaceful photo", "scary photo"), 14),
        "scene_removal_cat": (("a scene", "photo of a cat"), 11),
    }
    if adjective not in table:
        raise KeyError(f"no CLIP-IQA test prompt for concept {adjective!r}")
    return table[adjective]


def clip_iqa_probs(image_embs, pos_embs, neg_embs,
                   logit_scale: float = 100.0) -> torch.Tensor:
    """(B, D) x (P, D) x (P, D) -> (B, P) probability of the positive prompt,
    in f32 on the image embeddings' device.

    softmax over the pair of logit-scaled cosine similarities — exactly
    torchmetrics' CLIPImageQualityAssessment scoring."""
    img = torch.as_tensor(image_embs)
    dev = img.device

    def norm(x):
        x = torch.as_tensor(x).to(dev, torch.float32)
        return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    img, pos, neg = norm(img), norm(pos_embs), norm(neg_embs)
    lp = logit_scale * img @ pos.T                      # (B, P)
    ln = logit_scale * img @ neg.T
    m = torch.maximum(lp, ln)
    ep, en = torch.exp(lp - m), torch.exp(ln - m)
    return ep / (ep + en)


class ClipIQA:
    """CLIP-IQA scorer over the port's towers.

    `image_featurizer`: (B, 3, H, W) images in [0, 1] -> (B, D) embeddings
    (e.g. `fid.make_clip_featurizer`; normalization is re-applied here).
    `text_featurizer`: list[str] -> (N, D) embeddings in the same joint space
    (e.g. `fid.make_clip_text_featurizer` with the ported text projection).
    Scores come back as numpy arrays, one (B,) per prompt pair.
    """

    def __init__(self, image_featurizer: Callable, text_featurizer: Callable,
                 prompts: Sequence[PromptSpec] = ("quality",),
                 logit_scale: float = 100.0):
        self.pairs = resolve_prompt_pairs(prompts)
        self.image_featurizer = image_featurizer
        self.logit_scale = logit_scale
        texts = [t for pair in self.pairs.values() for t in pair]
        embs = torch.as_tensor(text_featurizer(texts))
        self.pos_embs = embs[0::2]
        self.neg_embs = embs[1::2]

    def __call__(self, images) -> Dict[str, np.ndarray]:
        embs = self.image_featurizer(images)
        probs = clip_iqa_probs(embs, self.pos_embs, self.neg_embs,
                               self.logit_scale).cpu().numpy()
        return {name: probs[:, i] for i, name in enumerate(self.pairs)}


def removal_quality_report(scores_base: Dict[str, np.ndarray],
                           scores_concept: Dict[str, np.ndarray],
                           scores_removed: Dict[str, np.ndarray],
                           concept_key: str = "user_defined_0") -> dict:
    """The reference's per-conf-sweep aggregation (modularity/clip_score.py:
    30-48,105-135): per split, mean CLIP-IQA 'quality' and mean concept
    probability (the user-defined pair). Any other scored pairs (the
    reference also embeds 'noisiness'/'sharpness') are averaged under their
    own names so the compute isn't silently discarded."""
    def agg(scores):
        out = {"quality": float(np.mean(scores["quality"])),
               "concept_sim": float(np.mean(scores[concept_key]))}
        for name, vals in scores.items():
            if name not in ("quality", concept_key):
                out[name] = float(np.mean(vals))
        return out
    return {"base": agg(scores_base), "concept": agg(scores_concept),
            "concept_removal": agg(scores_removed)}
