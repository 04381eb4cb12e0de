"""The torch port's SDXL `generate` under LCM (LCM-SDXL, the JAX bench's
`lcm-sdxl` point at tiny width) and under DeepCache, against the JAX
package on the CPU: 2 steps, MoE routing on all 22 FFs, per-request seeds,
f32, the weights of `torch_parity.sdxl_pipelines`.

Noise never crosses frameworks: the port is handed the initial latents JAX
draws from each request's seed and, under LCM, the step noise JAX draws
from each request's `fold_in(PRNGKey(seed), 1)`. Two JAX `generate`s are
compiled in this file; they sit apart from tests/test_torch_sdxl.py's so
that a parallel run spreads the compiles.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from diffusion_models_moe_tpu.moefication.moefy import \
    build_moe_interventions as jax_build_ivs
from diffusion_models_moe_tpu.pipelines.sdxl import SDXLPipeline as JaxSDXL
from diffusion_models_moe_tpu_torch import (SDXLPipeline,
                                            build_moe_interventions)

TOL = 2e-4                 # relative max error, f32
STEPS = 2
SEEDS = [5, 9]


@pytest.fixture(scope="module")
def sx():
    d = tp.sdxl_pipelines()
    tc = d["jax_tc"][0]
    rng = np.random.RandomState(3)
    d["ids"] = rng.randint(0, tc.vocab_size, (2, tc.max_length)).astype(
        np.int32)
    d["labels"] = tp.labels(d["jax_cfg"].unet)
    return d


def _pair(sx, **fields):
    """(JAX pipeline, port pipeline on the same weights) with the
    pipeline-config `fields` replaced in both."""
    jcfg_ = dataclasses.replace(sx["jax_cfg"], **fields)
    pcfg_ = dataclasses.replace(sx["port_cfg"], **fields)
    pipe = SDXLPipeline(pcfg_, sx["port_tc"], device="cpu")
    pipe.load_state_dicts({k: m.state_dict()
                           for k, m in sx["port"].modules().items()})
    return JaxSDXL(jcfg_, text_configs=sx["jax_tc"]), pipe


def _generate(sx, jpipe, pipe, monkeypatch, step_noise=None):
    ids = sx["ids"]
    uncond = np.zeros_like(ids)
    import jax
    ref, _ = jpipe.generate(sx["params"], jnp.asarray(ids),
                            jnp.asarray(uncond), jax.random.PRNGKey(0),
                            num_steps=STEPS,
                            ivs=jax_build_ivs(sx["labels"], 0.3),
                            decode=False, seeds=np.asarray(SEEDS))
    noise = tp.nchw(tp.jax_seeded_noise(SEEDS, sx["jax_cfg"].sample_size))
    monkeypatch.setattr(pipe, "seeded_noise", lambda seeds: noise)
    if step_noise is not None:
        denoise = pipe.denoise
        monkeypatch.setattr(pipe, "denoise", lambda *a, **kw: denoise(
            *a, **dict(kw, step_noise=step_noise)))
    got, _ = pipe.generate(torch.from_numpy(ids).long(),
                           torch.from_numpy(uncond).long(), num_steps=STEPS,
                           ivs=build_moe_interventions(sx["labels"], 0.3,
                                                       device="cpu"),
                           decode=False, seeds=SEEDS)
    assert tp.rel_err(ref, tp.nhwc(noise)) > 0.1
    return tp.nhwc(got), np.asarray(ref)


def test_lcm_sdxl_generate_matches_jax(sx, monkeypatch):
    """LCM-SDXL: no CFG, the config's guidance 7.5 through the embedding,
    each request's step noise from its own key (injected here)."""
    jpipe, pipe = _pair(sx, scheduler="lcm")
    s = sx["jax_cfg"].sample_size
    noise = tp.jax_lcm_noise(tp.jax_seeded_lcm_keys(SEEDS), (2, s, s, 4),
                             STEPS)
    got, ref = _generate(sx, jpipe, pipe, monkeypatch,
                         torch.from_numpy(noise).permute(0, 1, 4, 2, 3))
    assert tp.rel_err(got, ref) < TOL


def test_deep_cache_sdxl_generate_matches_jax(sx, monkeypatch):
    """DeepCache at interval 2 under Euler with CFG: step 1 is a shallow
    call, which carries the added conditioning as the full call does."""
    jpipe, pipe = _pair(sx, deep_cache_interval=2)
    got, ref = _generate(sx, jpipe, pipe, monkeypatch)
    assert tp.rel_err(got, ref) < TOL
