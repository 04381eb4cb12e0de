"""NSFW safety checking as an explicit, opt-in pipeline policy (PyTorch
port of `diffusion_models_moe_tpu/safety.py`).

The reference ships with the diffusers safety checker ON and monkey-patches it
off in ~8 places to study NSFW concepts (reference: base_receiver.py:7-8,20-23,
benchmarks/eval_coco.py:19-23), plus a blur-if-nsfw output policy
(reference: modularity/remove_experts.py:17-22). Here the policy is explicit:

  * `CLIPNSFWChecker` — cosine similarity of CLIP image embeddings against
    unsafe-concept TEXT embeddings (built from the port's own CLIP towers;
    no extra checker weights needed)
  * `apply_safety_policy` — blur (or black out) flagged images
  * `checked_generate` — wraps a pipeline's `generate`, honoring
    `PipelineConfig.safety_check` / `blur_nsfw`

Images are the port's (B, 3, H, W) in [0, 1]; flags are numpy bools.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.benchmarks.clip_metrics import \
    pooled_text_embedding
from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import \
    blur_images

# Unsafe concept phrases (the SLD safety-concept categories, split into
# per-phrase checker anchors; reference: sld pipeline safety concept string)
UNSAFE_CONCEPTS = (
    "nudity", "sexual content", "nsfw, explicit image",
    "violence, blood, gore", "hate symbols", "self-harm",
)


@dataclasses.dataclass
class CLIPNSFWChecker:
    """Flags images whose CLIP embedding is close to any unsafe concept.

    featurize: (B, 3, H, W) floats in [0, 1] -> (B, P) image embeddings
               (e.g. `benchmarks.fid.make_clip_featurizer` of a ported
               `CLIPVisionEncoder`)
    concept_embs: (C, P) unsafe-concept text embeddings
    threshold: cosine threshold (diffusers' checker uses per-concept learned
               thresholds around 0.2-0.3; a fixed 0.26 is the standard proxy)

    The cosines are taken on the host in f32, as the JAX checker does."""
    featurize: Callable
    concept_embs: object
    threshold: float = 0.26

    def __call__(self, images) -> np.ndarray:
        emb = torch.as_tensor(self.featurize(images)).float().cpu().numpy()
        emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True),
                               1e-12)
        c = torch.as_tensor(self.concept_embs).float().cpu().numpy()
        c = c / np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-12)
        sims = emb @ c.T                                # (B, C)
        return (sims > self.threshold).any(axis=1)


def unsafe_concept_embeddings(text_encoder_apply: Callable,
                              tokenize: Callable,
                              concepts: Sequence[str] = UNSAFE_CONCEPTS,
                              text_projection=None) -> torch.Tensor:
    """(C, P) pooled unsafe-concept embeddings from the port's own text
    tower, f32 on its device: each phrase encoded
    (`text_encoder_apply(ids) -> (C, S, D)`, e.g.
    `lambda ids: pipe.encode_text(ids)[0]`), the EOS-pooled hidden state
    taken through the CLIP text projection where given ((D, P); needed to
    compare with vision-tower embeddings; identity otherwise)."""
    ids = torch.as_tensor(tokenize(list(concepts)))
    hidden = text_encoder_apply(ids).float()
    if text_projection is None:
        text_projection = torch.eye(hidden.shape[-1])
    return pooled_text_embedding(hidden, ids, torch.as_tensor(text_projection))


def apply_safety_policy(images: torch.Tensor, nsfw_flags,
                        blur: bool = True, sigma: float = 7.0) -> torch.Tensor:
    """Blur (reference policy: remove_experts.py:17-22) or black out the
    flagged images; unflagged images pass through bit-identical."""
    flags = np.asarray(nsfw_flags, bool)
    if not flags.any():
        return images
    replaced = (blur_images(images, sigma=sigma) if blur
                else torch.zeros_like(images))
    keep = torch.as_tensor(flags, device=images.device)[:, None, None, None]
    return torch.where(keep, replaced, images)


def checked_generate(pipe, cond_ids, uncond_ids, generator=None, *,
                     checker: Optional[CLIPNSFWChecker] = None, **kw):
    """`pipe.generate(cond_ids, uncond_ids, generator, **kw)` (its `seeds=`
    too) honoring `PipelineConfig.safety_check` / `blur_nsfw`.

    With safety_check=True a checker must be provided (matching the reference,
    where disabling the checker is the explicit deviation, not the default).
    Returns (images, taps, nsfw_flags)."""
    cfg = pipe.config
    images, taps = pipe.generate(cond_ids, uncond_ids, generator, **kw)
    if not getattr(cfg, "safety_check", False):
        return images, taps, np.zeros((images.shape[0],), bool)
    if checker is None:
        raise ValueError(
            "PipelineConfig.safety_check=True requires a CLIPNSFWChecker "
            "(build one with unsafe_concept_embeddings + a CLIP vision "
            "featurizer)")
    flags = np.asarray(checker(images), bool)
    images = apply_safety_policy(images, flags,
                                 blur=getattr(cfg, "blur_nsfw", True))
    return images, taps, flags
