"""Batched benchmark generation driver with crash-restartable resume
(PyTorch port of `diffusion_models_moe_tpu/benchmarks/runner.py`).

Rebuilds the reference's eval loops (benchmarks/eval_coco.py:152-287,
i2p_eval.py:105-258, artist_removal.py:93-215): iterate a prompt dataset in
batches, generate baseline and intervened images, save the pairs, and skip
batches whose outputs already exist (resume-by-skip; reference:
eval_coco.py:252-254). Each batch is one `generate` call of the pipeline,
on the pipeline's device. With `mesh=` (`parallel/mesh.py`) every rank runs
`run_eval` with the same arguments and each `generate` splits its batch
over dp: every rank reads the same resume state before any file is
written, and the files (PNGs, `run_summary.json`) are written once, by the
coordinator (rank 0).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional, Sequence

import torch

from diffusion_models_moe_tpu_torch.parallel.distributed import (
    barrier, is_coordinator)


@dataclasses.dataclass
class EvalRunConfig:
    out_dir: str
    batch_size: int = 4
    num_steps: int = 50
    guidance_scale: float = 7.5
    seed: int = 0
    per_prompt_seeds: Optional[Sequence[int]] = None  # artist_removal protocol
    save_baseline: bool = True


def _pad_batch(ids: torch.Tensor, batch: int) -> tuple[torch.Tensor, int]:
    """A short last batch padded with repeats of its last prompt."""
    n = ids.shape[0]
    if n == batch:
        return ids, n
    return torch.cat([ids, ids[-1:].expand(batch - n, -1)]), n


def run_eval(pipe, tokenize: Callable[[Sequence[str]], torch.Tensor],
             prompts: Sequence[str], cfg: EvalRunConfig, ivs=None,
             name_fn: Optional[Callable[[int], str]] = None,
             generate_fn: Optional[Callable] = None, mesh=None) -> dict:
    """Generate images for `prompts`, optionally twice (baseline +
    intervened), saving `{out_dir}/sd_{i}.png` and `{out_dir}/removed_{i}.png`
    pairs (the reference's file naming, benchmarks/eval_coco.py:259-281) and
    `run_summary.json`.

    A baseline and its erased image share their initial noise: each of the
    two calls gets a fresh `torch.Generator` on the pipeline's device seeded
    with `cfg.seed` (the JAX runner reuses one PRNG key), or, with
    `cfg.per_prompt_seeds`, the prompts' own seeds through `generate(seeds=)`
    (padded slots repeat the last real seed). `generate_fn` overrides
    `pipe.generate` with the same contract (`(cond_ids, uncond_ids,
    generator, num_steps=, guidance_scale=, seeds=[, ivs=])`): the hook that
    runs protocols over other samplers (reference: i2p_eval.py:134-194 SLD
    rows); with `mesh` it also gets `mesh=`."""
    from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import \
        to_pil

    os.makedirs(cfg.out_dir, exist_ok=True)
    dev = torch.device(pipe.device)
    uncond = torch.as_tensor(tokenize([""]))
    b = cfg.batch_size
    name_fn = name_fn or (lambda i: str(i))
    gen = generate_fn or pipe.generate
    mesh_kw = {} if mesh is None else {"mesh": mesh}
    write = is_coordinator()
    done = skipped = 0

    def complete(start: int, n: int) -> bool:
        idxs = range(start, start + n)
        outs = [os.path.join(cfg.out_dir, f"removed_{name_fn(i)}.png")
                for i in idxs]
        if cfg.save_baseline:
            # resume-by-skip must also backfill baselines: a rerun with
            # save_baseline on after a run without it would otherwise skip
            # every batch and never produce a single sd_*.png
            outs += [os.path.join(cfg.out_dir, f"sd_{name_fn(i)}.png")
                     for i in idxs]
        return all(os.path.exists(p) for p in outs)

    # every rank reads the resume state before the coordinator writes
    starts = range(0, len(prompts), b)
    finished = {s: complete(s, len(prompts[s:s + b])) for s in starts}
    barrier()
    for start in starts:
        chunk = list(prompts[start:start + b])
        idxs = list(range(start, start + len(chunk)))
        if finished[start]:
            skipped += len(chunk)
            continue
        cond_ids, n_real = _pad_batch(torch.as_tensor(tokenize(chunk)), b)
        cond_ids = cond_ids.to(dev)
        uncond_ids = uncond.expand(b, -1).to(dev)
        seeds = None
        if cfg.per_prompt_seeds is not None:
            # one seed PER PROMPT (the reference's evaluation_seed column,
            # benchmarks/artist_removal.py:59-70)
            seeds = [int(s) for s in
                     cfg.per_prompt_seeds[start:start + len(chunk)]]
            seeds += [seeds[-1]] * (b - n_real)

        def call(**kw):
            generator = (None if seeds is not None else
                         torch.Generator(device=dev).manual_seed(cfg.seed))
            imgs, _ = gen(cond_ids, uncond_ids, generator,
                          num_steps=cfg.num_steps,
                          guidance_scale=cfg.guidance_scale, seeds=seeds,
                          **mesh_kw, **kw)
            return to_pil(imgs[:n_real])

        def save(images, prefix):
            if write:
                for img, i in zip(images, idxs):
                    img.save(os.path.join(cfg.out_dir,
                                          f"{prefix}_{name_fn(i)}.png"))

        if cfg.save_baseline:
            save(call(), "sd")
        save(call(ivs=ivs), "removed")
        done += len(chunk)

    summary = {"n_prompts": len(prompts), "generated": done,
               "skipped": skipped, "out_dir": cfg.out_dir}
    if write:
        with open(os.path.join(cfg.out_dir, "run_summary.json"), "w") as f:
            json.dump(summary, f)
    barrier()       # every rank reads the files from here on
    return summary
