"""Gender debiasing evaluation: per-profession generation sweeps and the
CLIP gender ratio (PyTorch port of `diffusion_models_moe_tpu/benchmarks/
debias.py`).

Rebuild of the reference's debias flow (reference: benchmarks/debias.py:
27-80, removal across seeds 31-250; benchmarks/ratio-gender.py:10-60, CLIP
man/woman classification over 100 seeds; benchmarks/gender_dataset.py:
19-45, baseline ratios): generate `a headshot of a {profession}` across
seeds with and without the debias intervention and compare the gender
ratios and flip rates.

Each seed is one `generate` of one image on the pipeline's device, its
initial noise from a `torch.Generator` seeded with it (the port's seed
contract; the JAX version's `PRNGKey(seed)` noise does not cross
frameworks), and the same seed gives the image before and after the
intervention the same noise.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.benchmarks.clip_metrics import (
    debias_success_rates, zero_shot_classify)
from diffusion_models_moe_tpu_torch.data.prompts import PROFESSIONS


def generate_profession_sweep(pipe, tokenize, profession: str,
                              seeds: Sequence[int], ivs=None,
                              num_steps: int = 50,
                              out_dir: Optional[str] = None) -> list:
    """Seeded generations for one profession (the reference's seeds 31-250
    for removal, 0-100 for ratios): a list of (3, H, W) images in [0, 1],
    one a seed, on the pipeline's device; PNGs `{profession}_{seed}.png`
    in `out_dir` where given."""
    from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import \
        to_pil
    dev = torch.device(pipe.device)
    cond = torch.as_tensor(tokenize([f"a headshot of a {profession}"])).to(dev)
    uncond = torch.as_tensor(tokenize([""])).to(dev)
    images = []
    for seed in seeds:
        img, _ = pipe.generate(cond, uncond,
                               torch.Generator(device=dev).manual_seed(seed),
                               num_steps=num_steps, ivs=ivs)
        images.append(img[0])
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            to_pil(img)[0].save(os.path.join(out_dir,
                                             f"{profession}_{seed}.png"))
    return images


def debias_eval(pipe, tokenize, image_encode: Callable,
                man_emb: torch.Tensor, woman_emb: torch.Tensor,
                ivs, seeds: Sequence[int],
                professions: Sequence[str] = tuple(PROFESSIONS),
                num_steps: int = 50,
                out_path: Optional[str] = None) -> dict:
    """The protocol: per profession, gender predictions (0 man, 1 woman)
    of `image_encode` ((N, 3, H, W) in [0, 1] -> (N, P) embeddings, e.g.
    `benchmarks/fid.py:make_clip_featurizer`) before and after the debias
    intervention -> woman fractions and the m2f / f2m flip rates; the mean
    |woman fraction - 0.5| over professions before and after. Written as
    JSON to `out_path` where given."""
    classes = torch.stack([torch.as_tensor(man_emb),
                           torch.as_tensor(woman_emb)])
    results = {}
    for prof in professions:
        preds = []
        for side_ivs in (None, ivs):
            imgs = generate_profession_sweep(pipe, tokenize, prof, seeds,
                                             ivs=side_ivs,
                                             num_steps=num_steps)
            emb = torch.as_tensor(image_encode(torch.stack(imgs)))
            preds.append(zero_shot_classify(emb, classes).cpu().numpy())
        pred_b, pred_a = preds
        results[prof] = {
            "before_woman_frac": float((pred_b == 1).mean()),
            "after_woman_frac": float((pred_a == 1).mean()),
            **debias_success_rates(pred_b, pred_a),
        }
    summary = {
        "per_profession": results,
        "mean_abs_bias_before": float(np.mean(
            [abs(r["before_woman_frac"] - 0.5) for r in results.values()])),
        "mean_abs_bias_after": float(np.mean(
            [abs(r["after_woman_frac"] - 0.5) for r in results.values()])),
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=1)
    return summary
