"""Frechet Inception/CLIP Distance (PyTorch port of
`diffusion_models_moe_tpu/benchmarks/fid.py`).

The reference computes FID with torchmetrics (InceptionV3 features;
benchmarks/eval_coco.py:16,25-29) and a CLIP-feature variant for the sparsity path
(reference: sparsity/eval_coco.py:18-37,41-70). Here FID is a function over
feature batches: the featurizers run the port's Inception-v3 or CLIP vision
tower on their device, and the Gaussian statistics accumulate in f64 on the
host, streamingly, so 30k-image protocols never hold features in memory.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import scipy.linalg
import torch


@dataclasses.dataclass
class FeatureStats:
    """Streaming mean/covariance accumulator for one image distribution."""
    n: int = 0
    sum: np.ndarray | None = None
    outer: np.ndarray | None = None

    def update(self, feats) -> None:
        if isinstance(feats, torch.Tensor):
            feats = feats.detach().cpu().numpy()
        feats = np.asarray(feats, np.float64)
        if self.sum is None:
            d = feats.shape[-1]
            self.sum = np.zeros(d)
            self.outer = np.zeros((d, d))
        self.n += feats.shape[0]
        self.sum += feats.sum(0)
        self.outer += feats.T @ feats

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        mu = self.sum / self.n
        cov = (self.outer - self.n * np.outer(mu, mu)) / max(self.n - 1, 1)
        return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """FD = |mu1-mu2|^2 + tr(C1 + C2 - 2 sqrt(C1 C2)); where the square root
    of the product is not finite, it is taken again with eps added to both
    diagonals."""
    diff = mu1 - mu2
    with warnings.catch_warnings():
        # scipy warns (LinAlgWarning) on singular products before the
        # eps-offset retry below; only that category is silenced
        warnings.simplefilter("ignore", scipy.linalg.LinAlgWarning)
        covmean = scipy.linalg.sqrtm(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * np.trace(covmean))


def fid_from_features(real, fake) -> float:
    a, b = FeatureStats(), FeatureStats()
    a.update(real)
    b.update(fake)
    return frechet_distance(*a.finalize(), *b.finalize())


def make_inception_featurizer(model):
    """(B, 3, H, W) [0, 1] -> (B, 2048) pool features of the port's FID
    Inception-v3 (`models/inception.py`, on its device) — the reference's
    FID feature space (torchmetrics InceptionV3,
    benchmarks/eval_coco.py:16,25-29)."""
    from diffusion_models_moe_tpu_torch.models.inception import (
        inception_pool_features, preprocess_fid)
    dev = model.fc.weight.device

    def featurize(images):
        images = torch.as_tensor(images, dtype=torch.float32).to(dev)
        return inception_pool_features(model, preprocess_fid(images))

    return featurize


def load_inception_featurizer(weights_path: str, device="cuda"):
    """`make_inception_featurizer` of an `InceptionV3` on `device` with a
    torchvision / torch-fidelity state dict from disk (.pt/.pth or .npz of
    the same keys)."""
    from diffusion_models_moe_tpu_torch.models.inception import InceptionV3
    from diffusion_models_moe_tpu_torch.weights.port_torchvision import (
        inception_state_dict, load_state_dict)
    model = InceptionV3(device=device)
    model.load_state_dict(inception_state_dict(load_state_dict(weights_path)))
    return make_inception_featurizer(model)


def make_clip_text_featurizer(text_encoder, tokenize, text_projection=None):
    """prompts -> (N, D) CLIP text embeddings in the joint space of the
    matching `make_clip_featurizer` vision tower (used by the artist-removal
    accuracy: cos(text, orig) > cos(text, removed); reference:
    benchmarks/artist_removal.py:180-199). `text_encoder` is the port's
    `CLIPTextEncoder` (ids are moved to its device); `text_projection` is
    the full CLIP model's text_projection ((hidden, joint),
    `port_clip_text_projection`); without it the pooled hidden state is
    returned, which is only meaningful against a vision tower in the same
    (unprojected) space."""
    from diffusion_models_moe_tpu_torch.benchmarks.clip_metrics import \
        pooled_text_embedding
    dev = next(text_encoder.parameters()).device

    @torch.no_grad()
    def featurize(prompts):
        ids = torch.as_tensor(tokenize(list(prompts))).to(dev)
        hidden = text_encoder(ids)
        if isinstance(hidden, tuple):
            hidden = hidden[0]
        proj = (torch.as_tensor(text_projection) if text_projection is not None
                else torch.eye(hidden.shape[-1]))
        return pooled_text_embedding(hidden.float(), ids, proj.float())

    return featurize


def make_clip_featurizer(vision_encoder):
    """(B, 3, H, W) [0, 1] -> unnormalized projected features of the port's
    CLIP vision tower, on its device (the CLIP-feature FID variant,
    reference: sparsity/eval_coco.py:18-37)."""
    from diffusion_models_moe_tpu_torch.models.clip_vision import \
        resize_for_clip

    def featurize(images):
        images = torch.as_tensor(images, dtype=torch.float32).to(
            vision_encoder.visual_projection.weight.device)
        images = resize_for_clip(images, vision_encoder.cfg.image_size)
        return vision_encoder(images, normalize=False)

    return featurize
