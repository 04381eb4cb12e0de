"""Flagship eval protocols, end-to-end: shipped prompt assets -> batched
generation (resume-by-skip) -> judge -> aggregate (PyTorch port of
`diffusion_models_moe_tpu/benchmarks/protocols.py`).

These tie together what the reference runs as separate argparse scripts:
  i2p_protocol          <- benchmarks/i2p_eval.py:105-258
  memorization_protocol <- benchmarks/inference_mem.py:136-168
  artist_removal_protocol <- benchmarks/artist_removal.py:93-215
  clip_sim_confidence_sweep <- modularity/clip_sim_score.py:17-106
(the style-classifier variant lives in benchmarks/art_removal.py)
Prompt data are the reference's own files (data/datasets/, copied
verbatim); judges (NudeNet / SSCD / CLIP-vision featurizer / classifier)
are injected callables. Generation runs on the port's pipeline (`pipe`, on
its device; no `params`, no `mesh`). Featurizers, embedders and classifiers
get the saved PNGs as (N, 3, H, W) tensors in [0, 1], the port's image
layout; the NudeNet detector gets them as uint8 (H, W, 3) arrays, what its
letterbox reads (the JAX protocol hands it floats in [0, 1], which its
letterbox truncates to 0 and 1).
"""
from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.benchmarks.clip_metrics import _np
from diffusion_models_moe_tpu_torch.benchmarks.memorization import _l2n
from diffusion_models_moe_tpu_torch.benchmarks.runner import (EvalRunConfig,
                                                              run_eval)
from diffusion_models_moe_tpu_torch.data import prompts as P


def _load_uint8(out_dir: str, prefix: str, n: int) -> list[np.ndarray]:
    """`{prefix}_{i}.png` for i < n as uint8 (H, W, 3) arrays."""
    from PIL import Image
    return [np.asarray(Image.open(os.path.join(out_dir, f"{prefix}_{i}.png")))
            for i in range(n)]


def _load_pngs(out_dir: str, prefix: str, n: int) -> torch.Tensor:
    """`{prefix}_{i}.png` for i < n as one (n, 3, H, W) f32 stack in [0, 1]."""
    arr = np.stack(_load_uint8(out_dir, prefix, n)).astype(np.float32) / 255.0
    return torch.from_numpy(arr).permute(0, 3, 1, 2)


def _stack(images) -> torch.Tensor:
    if isinstance(images, torch.Tensor):
        return images
    return torch.stack([torch.as_tensor(i) for i in images])


def i2p_protocol(pipe, tokenize, out_dir: str, detector,
                 variant: str = "", ivs=None, limit: Optional[int] = None,
                 num_steps: int = 50, batch_size: int = 4,
                 generate_fn=None) -> dict:
    """I2P nudity eval at the reference operating point: the shipped
    i2p_prompts_seed_0*.txt prompts, NudeNet 9-label counting at 0.5
    (reference: benchmarks/i2p_eval.py)."""
    from diffusion_models_moe_tpu_torch.benchmarks.nudity import count_harmful

    prompts = P.i2p_prompts(variant)
    if limit:
        prompts = prompts[:limit]
    cfg = EvalRunConfig(out_dir=out_dir, batch_size=batch_size,
                        num_steps=num_steps, save_baseline=False)
    run_eval(pipe, tokenize, prompts, cfg, ivs=ivs, generate_fn=generate_fn)
    result = count_harmful(detector(_load_uint8(out_dir, "removed",
                                                len(prompts))))
    result["n_prompts"] = len(prompts)
    with open(os.path.join(out_dir, "i2p_results.json"), "w") as f:
        json.dump(result, f)
    return result


def memorization_protocol(pipe, tokenize, out_dir: str,
                          embed: Callable[[torch.Tensor], np.ndarray],
                          split: int | str = "", ivs=None,
                          gt_images: Optional[torch.Tensor] = None,
                          limit: Optional[int] = None, num_steps: int = 50,
                          batch_size: int = 4,
                          generate_fn=None) -> dict:
    """Memorization eval: generate the shipped memorized LAION captions and
    score SSCD-style similarity of with-intervention generations against
    baseline generations (or supplied ground-truth images)
    (reference: benchmarks/inference_mem.py:46-83,136-168)."""
    from diffusion_models_moe_tpu_torch.benchmarks.memorization import (
        memorization_scores)

    prompts = P.memorized_captions(split)
    if limit:
        prompts = prompts[:limit]
    cfg = EvalRunConfig(out_dir=out_dir, batch_size=batch_size,
                        num_steps=num_steps, save_baseline=True)
    run_eval(pipe, tokenize, prompts, cfg, ivs=ivs, generate_fn=generate_fn)
    gen = _load_pngs(out_dir, "removed", len(prompts))
    if gt_images is None:
        # no LAION ground truth in-env: baseline generations are the
        # memorization proxy (similarity should DROP under intervention)
        gt_images = _load_pngs(out_dir, "sd", len(prompts))
    result = memorization_scores(_np(embed(gen)), _np(embed(gt_images)))
    result["n_prompts"] = len(prompts)
    with open(os.path.join(out_dir, "memorization_results.json"), "w") as f:
        json.dump(result, f)
    return result


def object_erasure_protocol(pipe, tokenize, out_dir: str,
                            classify: Callable[[torch.Tensor], np.ndarray],
                            target: str,
                            classes: Optional[Sequence[str]] = None,
                            ivs=None, limit: Optional[int] = None,
                            num_steps: int = 50, batch_size: int = 4,
                            generate_fn=None) -> dict:
    """Object erasure at the reference operating point: generate the target
    object's prompts (erase split) and every other imagenette object's prompts
    (keep split) under the intervention, then judge with a classifier over the
    class list — erase accuracy should drop, keep accuracy should hold
    (reference: benchmarks/object_erase.py:18-45,52-100; judge = ResNet-50/ViT
    there, any images->logits callable here, e.g. the native ResNet-50 or the
    zero-shot CLIP judge)."""
    from diffusion_models_moe_tpu_torch.benchmarks.object_erase import (
        object_erasure_scores)

    classes = list(classes or P.erasing_objects())
    target_idx = classes.index(target)
    keep_classes = [c for c in classes if c != target]
    if limit:
        keep_classes = keep_classes[:limit]
    erase_prompts = P.concept_prompts("imagenette", subjects=[target]).concept
    if limit:
        erase_prompts = erase_prompts[:limit]
    keep_prompts = [f"a photo of a {c}" for c in keep_classes]

    for sub, prompts in (("erase", erase_prompts), ("keep", keep_prompts)):
        cfg = EvalRunConfig(out_dir=os.path.join(out_dir, sub),
                            batch_size=batch_size, num_steps=num_steps,
                            save_baseline=False)
        run_eval(pipe, tokenize, prompts, cfg, ivs=ivs, generate_fn=generate_fn)
    erased = _load_pngs(os.path.join(out_dir, "erase"), "removed",
                        len(erase_prompts))
    kept = _load_pngs(os.path.join(out_dir, "keep"), "removed",
                      len(keep_prompts))
    keep_labels = [classes.index(c) for c in keep_classes]
    result = object_erasure_scores(classify, erased, kept, target_idx,
                                   keep_labels)
    result.update(target=target, n_erase=len(erase_prompts),
                  n_keep=len(keep_prompts))
    with open(os.path.join(out_dir, "object_erasure_results.json"), "w") as f:
        json.dump(result, f)
    return result


def artist_removal_protocol(pipe, tokenize, out_dir: str,
                            featurize: Callable[[torch.Tensor], np.ndarray],
                            artists: Optional[Sequence[str]] = None,
                            n_artists: int = 100, part: int = 1, ivs=None,
                            limit: Optional[int] = None, num_steps: int = 50,
                            batch_size: int = 4, seed: int = 0,
                            text_featurize=None,
                            generate_fn=None) -> dict:
    """Artist-style removal: per-artist style prompts from the shipped
    {n}artists lists, CLIP image-image similarity of baseline vs removed and
    removal accuracy (reference: benchmarks/artist_removal.py:59-70,180-210).

    The reference's accuracy is mean(cos(text, orig) > cos(text, removed)) —
    the style prompt should match the BASELINE image better than the removed
    one. That needs prompt text embeddings: pass `text_featurize`
    (prompts -> (N, D) CLIP text embeddings in the same space as `featurize`).
    Without it only the image-image similarity is reported and
    `removal_accuracy` is None (a 1-vs-similarity comparison would read ~1.0
    for ANY intervention that changes pixels, which measures nothing)."""
    from diffusion_models_moe_tpu_torch.benchmarks.clip_metrics import (
        image_image_similarity, removal_accuracy)

    if artists is None:
        artists = P.artist_names(n_artists, part)
    if limit:
        artists = list(artists)[:limit]
    prompts = [f"a painting in the style of {a}" for a in artists]
    cfg = EvalRunConfig(out_dir=out_dir, batch_size=batch_size,
                        num_steps=num_steps, seed=seed, save_baseline=True)
    run_eval(pipe, tokenize, prompts, cfg, ivs=ivs, generate_fn=generate_fn)
    base = _load_pngs(out_dir, "sd", len(prompts))
    removed = _load_pngs(out_dir, "removed", len(prompts))
    fb, fr = _l2n(featurize(base)), _l2n(featurize(removed))
    sim = image_image_similarity(torch.from_numpy(fb),
                                 torch.from_numpy(fr)).numpy()
    acc = None
    if text_featurize is not None:
        ft = _l2n(text_featurize(prompts))
        sim_orig = np.sum(ft * fb, axis=-1)
        sim_removed = np.sum(ft * fr, axis=-1)
        acc = float(removal_accuracy(sim_orig, sim_removed))
    result = {"mean_similarity": float(sim.mean()),
              "removal_accuracy": acc,
              "n_artists": len(prompts)}
    with open(os.path.join(out_dir, "artist_removal_results.json"), "w") as f:
        json.dump(result, f)
    return result


def clip_sim_confidence_sweep(root_template: str,
                              base_prompts: Sequence[str],
                              image_featurize: Callable,
                              text_featurize: Callable,
                              adjective: str,
                              conf_int: Sequence[float] = (0.2, 0.1, 0.05,
                                                           0.02, 0.01, 0.001),
                              image_name: str = "img_{i}_adj.jpg",
                              dof: Optional[int] = None,
                              out_path: Optional[str] = None) -> dict:
    """Per-confidence-interval CLIP similarity sweep over t-test removal runs
    (reference: modularity/clip_sim_score.py:17-106): for each confidence
    level's `remove_neurons` output directory (root_template %
    f"dof_{dof}_conf_{conf}"), score every image against its own base prompt
    and against "a painting in the style of {adjective}". The base-prompt
    similarity should HOLD as conf tightens (fewer neurons removed) while the
    adjective similarity should DROP at the chosen operating point.

    conf_int defaults to the reference's dof_critical_values.csv columns.
    Images reach `image_featurize` as (N, 3, H, W) tensors in [0, 1].
    Returns {"per_prompt": {i: {conf: sim}}, "per_prompt_adj": ...,
    "mean": {conf: m}, "mean_adj": {conf: m}}.
    """
    from PIL import Image

    if dof is None:
        dof = len(base_prompts) - 1
    base_embs = _l2n(text_featurize(list(base_prompts)))
    adj_emb = _l2n(text_featurize(
        [f"a painting in the style of {adjective}"]))[0]
    scores: dict = {i: {} for i in range(len(base_prompts))}
    scores_adj: dict = {i: {} for i in range(len(base_prompts))}
    means, means_adj = {}, {}
    for conf in conf_int:
        root = root_template % f"dof_{dof}_conf_{conf}"
        imgs = np.stack([
            np.asarray(Image.open(os.path.join(root,
                                               image_name.format(i=i))),
                       np.float32) / 255.0
            for i in range(len(base_prompts))])
        img_embs = _l2n(image_featurize(
            torch.from_numpy(imgs).permute(0, 3, 1, 2)))
        sim = np.sum(base_embs * img_embs, axis=-1)
        sim_adj = img_embs @ adj_emb
        for i in range(len(base_prompts)):
            scores[i][conf] = float(sim[i])
            scores_adj[i][conf] = float(sim_adj[i])
        means[conf] = float(sim.mean())
        means_adj[conf] = float(sim_adj.mean())
    result = {"per_prompt": scores, "per_prompt_adj": scores_adj,
              "mean": means, "mean_adj": means_adj}
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump({k: ({str(i): {str(c): x for c, x in d.items()}
                            for i, d in v.items()}
                           if k.startswith("per_") else
                           {str(c): x for c, x in v.items()})
                       for k, v in result.items()}, f)
    return result


def clip_iqa_protocol(images_base, images_concept, images_removed,
                      image_featurizer, text_featurizer, concept: str,
                      out_dir: Optional[str] = None) -> dict:
    """CLIP-IQA quality/concept report over a removal experiment — the
    reference's clip_score.py main loop (modularity/clip_score.py:85-140):
    score base-prompt images, concept-prompt images, and post-removal images
    with prompts ("quality", "noisiness", "sharpness", per-concept test pair),
    report mean quality + mean concept probability per split.

    `images_*` are (N, 3, H, W) tensors in [0, 1], or lists of (3, H, W)
    images (e.g. the runner's saved PNGs through `_load_pngs`); featurizers
    as in `ClipIQA`."""
    from diffusion_models_moe_tpu_torch.benchmarks.clip_iqa import (
        ClipIQA, design_test_prompt, removal_quality_report)

    pair, _dof = design_test_prompt(concept)
    scorer = ClipIQA(image_featurizer, text_featurizer,
                     prompts=("quality", "noisiness", "sharpness", pair))
    report = removal_quality_report(scorer(_stack(images_base)),
                                    scorer(_stack(images_concept)),
                                    scorer(_stack(images_removed)))
    if out_dir is not None:
        with open(os.path.join(out_dir, "clip_iqa_scores.json"), "w") as f:
            json.dump(report, f)
    return report
