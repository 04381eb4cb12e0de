"""Unified editing: per-prompt concept routing -> multi-concept erasure
(PyTorch port of `diffusion_models_moe_tpu/benchmarks/unified_editing.py`).

Rebuild of the reference's router benchmark (reference:
benchmarks/unified_editing.py:64-136, neuron_receivers/
multi_concept_remover.py:13-99): CLIP-text concept checkers decide which
concepts each prompt fires; the fired concepts' Wanda masks are OR-ed
(`erasure/masks.py:union_masks`) and applied to that prompt's generation
as output-weight masks (`wanda_removal_interventions`, on the pipeline's
device). One intervention set is built per fired combination and reused.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.benchmarks.clip_metrics import \
    MemorizedPromptChecker
from diffusion_models_moe_tpu_torch.erasure.masks import (
    MaskDict, union_masks, wanda_removal_interventions)


@dataclasses.dataclass
class ConceptBank:
    """Per-concept checkers and masks in the reference's Wanda orientation
    ((T|1, D, H) or (D, H): what `wanda_pipeline` emits and the CLI
    stores)."""
    checkers: dict[str, object]   # name -> callable(prompt_embs) -> bool[]
    masks: dict[str, MaskDict]

    def route(self, prompt_embs: np.ndarray,
              prompts: Optional[Sequence[str]] = None
              ) -> list[tuple[str, ...]]:
        """The concepts each prompt fires, sorted by name (reference:
        benchmarks/unified_editing.py routing loop). A
        `MemorizedPromptChecker` reads the raw prompts: without `prompts=`
        it raises."""
        per_concept = {}
        for name, checker in self.checkers.items():
            if isinstance(checker, MemorizedPromptChecker):
                if prompts is None:
                    # a silent [] here would empty the routing table and
                    # drop every prompt from the benchmark
                    raise ValueError(
                        f"checker {name!r} needs the raw prompts: pass "
                        f"route(prompt_embs, prompts=...)")
                per_concept[name] = checker(prompts)
            else:
                per_concept[name] = checker(prompt_embs)
        n = len(next(iter(per_concept.values())))
        return [tuple(sorted(name for name, hits in per_concept.items()
                             if hits[i])) for i in range(n)]


def unified_editing_eval(pipe, tokenize, prompts: Sequence[str],
                         prompt_embs: np.ndarray, bank: ConceptBank,
                         out_dir: str, num_steps: int = 50,
                         seed: int = 0) -> dict:
    """Route every prompt, apply the union of its fired concepts' masks,
    generate (prompt i from a `torch.Generator` seeded with seed + i on the
    pipeline's device). Images land in `{out_dir}/{i}_{concepts}.png`
    (`none` where nothing fires: a clean generate). Returns the routing
    decisions and a summary."""
    from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import \
        to_pil

    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device(pipe.device)
    routes = bank.route(prompt_embs, prompts)
    iv_cache: dict[tuple, object] = {}
    uncond = torch.as_tensor(tokenize([""])).to(dev)
    results = []
    for i, (prompt, fired) in enumerate(zip(prompts, routes)):
        if fired not in iv_cache:
            iv_cache[fired] = (wanda_removal_interventions(
                union_masks([bank.masks[c] for c in fired]), device=dev)
                if fired else None)
        cond = torch.as_tensor(tokenize([prompt])).to(dev)
        img, _ = pipe.generate(cond, uncond,
                               torch.Generator(device=dev).manual_seed(seed + i),
                               num_steps=num_steps, ivs=iv_cache[fired])
        tag = "_".join(fired) if fired else "none"
        to_pil(img)[0].save(os.path.join(out_dir, f"{i}_{tag}.png"))
        results.append({"prompt": prompt, "concepts": list(fired)})
    n_routed = sum(1 for r in results if r["concepts"])
    return {"results": results, "n_prompts": len(prompts),
            "n_routed": n_routed}
