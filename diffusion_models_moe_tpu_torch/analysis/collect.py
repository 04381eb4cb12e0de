"""Skill-attribution collection flows (PyTorch port): run (base, concept)
prompt sets with taps and produce skilled-neuron masks.

Counterpart of `diffusion_models_moe_tpu/analysis/collect.py`, in three
steps:
  1. collect_predictivity  max-gate (or mean-gate) stats of prompt pairs
  2. collect_wanda_norms   column norms of the FF inner output
  3. t_test_pipeline / wanda_pipeline  the skilled masks

Each prompt's generation returns stacked (T, H) stats; accumulation across
prompts is Welford on the host. `pipe` is the port's
`StableDiffusionPipeline` with its weights loaded; `tokenize` maps a list of
prompts to (B, S) ids (e.g. `data.tokenize.hash_tokenize`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.analysis.selectors import (
    t_test_skilled, wanda_skilled)
from diffusion_models_moe_tpu_torch.analysis.stats import (
    ColumnNormAccumulator, PairedDiffStd, TapAccumulator, load_colnorms)
from diffusion_models_moe_tpu_torch.moefication.moefy import ff_param_paths
from diffusion_models_moe_tpu_torch.taps import TapSpec


@dataclasses.dataclass
class PredictivityResult:
    base: TapAccumulator
    adj: TapAccumulator
    diff_std: PairedDiffStd
    n_prompts: int

    def save(self, out_dir: str) -> None:
        """predictivity_{base,adj}.json and diff_std.npz."""
        os.makedirs(out_dir, exist_ok=True)
        self.base.save(os.path.join(out_dir, "predictivity_base.json"))
        self.adj.save(os.path.join(out_dir, "predictivity_adj.json"))
        np.savez(os.path.join(out_dir, "diff_std.npz"),
                 **{str(l): v for l, v in self.diff_std.std().items()})


def _host(per_layer: dict) -> dict[int, np.ndarray]:
    return {l: v.float().cpu().numpy() for l, v in per_layer.items()}


def _run_tapped(pipe, tokenize, prompt: str, seed: int, tap: TapSpec,
                num_steps: Optional[int], ivs=None) -> dict:
    cond = tokenize([prompt])
    _, taps = pipe.generate(cond, torch.zeros_like(cond),
                            torch.Generator().manual_seed(seed),
                            num_steps=num_steps, tap=tap, ivs=ivs,
                            decode=False)
    return taps


def collect_predictivity(pipe, tokenize, base_prompts: Sequence[str],
                         adj_prompts: Sequence[str], seed: int = 0,
                         num_steps: Optional[int] = None,
                         mean_gate: bool = False,
                         ivs=None) -> PredictivityResult:
    """Max-gate (or mean-gate) predictivity over prompt pairs. Every
    generation starts from the noise of the same `seed`, so base and concept
    runs differ only in their prompt."""
    if len(base_prompts) != len(adj_prompts):
        raise ValueError(f"paired prompt lists differ in length: "
                         f"{len(base_prompts)} base vs {len(adj_prompts)} adj")
    tap = TapSpec(max_gate=not mean_gate, mean_gate=mean_gate)
    stat = "mean_gate" if mean_gate else "max_gate"
    base_acc, adj_acc, dstd = TapAccumulator(), TapAccumulator(), PairedDiffStd()
    for bp, ap in zip(base_prompts, adj_prompts):
        b = _host(_run_tapped(pipe, tokenize, bp, seed, tap, num_steps,
                              ivs)[stat])
        a = _host(_run_tapped(pipe, tokenize, ap, seed, tap, num_steps,
                              ivs)[stat])
        base_acc.update(b)
        adj_acc.update(a)
        dstd.update(b, a)
    return PredictivityResult(base_acc, adj_acc, dstd, len(base_prompts))


def collect_wanda_norms(pipe, tokenize, prompts: Sequence[str],
                        seed: int = 0, num_steps: Optional[int] = None
                        ) -> dict[int, np.ndarray]:
    """Per-(t, l) column norms of the row-normalised FF inner output over a
    prompt set. Returns {layer: (T, H)} norms."""
    tap = TapSpec(ff_out_colnorm_sq=True)
    acc = ColumnNormAccumulator()
    for prompt in prompts:
        taps = _run_tapped(pipe, tokenize, prompt, seed, tap, num_steps)
        acc.update(_host(taps["ff_out_colnorm_sq"]))
    return acc.norms()


def w2_abs_weights(unet_state: dict, cfg) -> dict[int, np.ndarray]:
    """|W2| per FF layer, (D, H): `ff.net.2.weight` of the UNet state dict
    (already in the (out, in) orientation of the Wanda masks)."""
    return {l: np.abs(unet_state[f"{path}.net.2.weight"].float().cpu().numpy())
            for l, path in enumerate(ff_param_paths(cfg))}


def wanda_pipeline(pipe, tokenize, base_prompts, adj_prompts,
                   skill_ratio: float, seed: int = 0,
                   num_steps: Optional[int] = None,
                   cache_dir: Optional[str] = None) -> dict[int, np.ndarray]:
    """The Wanda flow -> {layer: (T, D, H) skilled masks} in the (out, in)
    orientation that `wanda_removal_interventions` and `bake_wanda_masks`
    take. Norms are read from `cache_dir` when both files are there, and
    written there otherwise."""
    base_file = cache_dir and os.path.join(cache_dir, "base_norms.npz")
    adj_file = cache_dir and os.path.join(cache_dir, "adj_norms.npz")
    if base_file and os.path.exists(base_file) and os.path.exists(adj_file):
        base_norms, adj_norms = load_colnorms(base_file), load_colnorms(adj_file)
    else:
        base_norms = collect_wanda_norms(pipe, tokenize, base_prompts, seed,
                                         num_steps)
        adj_norms = collect_wanda_norms(pipe, tokenize, adj_prompts, seed,
                                        num_steps)
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            np.savez(base_file, **{str(l): v for l, v in base_norms.items()})
            np.savez(adj_file, **{str(l): v for l, v in adj_norms.items()})
    w2 = w2_abs_weights(pipe.unet.state_dict(), pipe.config.unet)
    return {l: wanda_skilled(w2[l], base_norms[l], adj_norms[l], skill_ratio)
            for l in base_norms}


def t_test_pipeline(pred: PredictivityResult, conf: float = 0.05
                    ) -> dict[int, np.ndarray]:
    """Predictivity stats -> {layer: (T, H) skilled masks}."""
    base_mean, adj_mean = pred.base.mean(), pred.adj.mean()
    dstd = pred.diff_std.std()
    return {l: t_test_skilled(base_mean[l], adj_mean[l], dstd[l],
                              pred.n_prompts, conf)
            for l in base_mean}
