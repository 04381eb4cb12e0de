"""The torch port's Safe Latent Diffusion guidance (`pipelines/sld.py`)
against the JAX package, on the CPU: `sld_combine` at the four presets
across their warm-up boundary with the momentum carried, `sld_generate`
on `tiny_config` in f32 against JAX `sld_generate(decode=False)` on the
same weights and the same initial noise (JAX's, handed to the port), and
the configurations SLD refuses. Two JAX `sld_generate`s are compiled here
(each call of the JAX function traces anew).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu.pipelines import sld as jsld
from diffusion_models_moe_tpu.pipelines.stable_diffusion import \
    StableDiffusionPipeline as JaxPipeline
from diffusion_models_moe_tpu_torch import (SAFETY_CONCEPT, SLDConfig,
                                            StableDiffusionPipeline,
                                            sld_generate, tiny_config)
from diffusion_models_moe_tpu_torch.pipelines.sld import (sld_combine,
                                                          sld_denoise)

TOL = 2e-4                 # relative max error, f32
GUIDANCE = 7.5
PRESETS = ("weak", "medium", "strong", "max")


@pytest.mark.parametrize("preset", PRESETS)
def test_sld_combine_matches_jax(preset):
    """Three steps from warmup - 1 with the momentum carried: eps_hat and
    the momentum equal JAX's; the safety term is off before the warm-up and
    on from it (where the preset's momentum or mask make it non-zero)."""
    ref_cfg, cfg = getattr(jsld.SLDConfig, preset)(), getattr(SLDConfig,
                                                              preset)()
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    rng = np.random.RandomState(PRESETS.index(preset))
    shape = (2, 4, 6, 6)
    mom_r = jnp.zeros(shape, jnp.float32)
    mom_g = torch.zeros(shape)
    for i in range(cfg.warmup_steps - 1, cfg.warmup_steps + 2):
        eps_u = rng.randn(*shape).astype(np.float32)
        eps_c = eps_u + 0.1 * rng.randn(*shape).astype(np.float32)
        # differences around the thresholds and below 1/guidance_scale
        d = rng.randn(*shape).astype(np.float32) * rng.choice(
            [1e-4, 1e-2, 0.5], shape).astype(np.float32)
        eps_s = eps_c - d
        ref, mom_r = jsld.sld_combine(jnp.asarray(eps_u), jnp.asarray(eps_c),
                                      jnp.asarray(eps_s), mom_r, i, ref_cfg,
                                      GUIDANCE)
        got, mom_g = sld_combine(torch.from_numpy(eps_u),
                                 torch.from_numpy(eps_c),
                                 torch.from_numpy(eps_s), mom_g, i, cfg,
                                 GUIDANCE)
        assert tp.rel_err(got.numpy(), ref) < TOL, i
        assert tp.rel_err(mom_g.numpy(), mom_r) < TOL, i
        cfg_only = eps_u + GUIDANCE * (eps_c - eps_u)
        if i < cfg.warmup_steps:
            np.testing.assert_array_equal(got.numpy(), cfg_only)
        elif preset != "weak" or i > cfg.warmup_steps:
            assert tp.rel_err(got.numpy(), cfg_only) > 1e-3, i


@pytest.fixture(scope="module")
def sd():
    cfg = jcfg.tiny_config()
    params, port = tp.pipelines(cfg)
    t = cfg.text_encoder
    rng = np.random.RandomState(4)
    cond = rng.randint(0, t.vocab_size, (2, t.max_length)).astype(np.int32)
    safety = rng.randint(0, t.vocab_size, (1, t.max_length)).astype(np.int32)
    return dict(cfg=cfg, params=params, port=port, cond=cond,
                uncond=np.zeros_like(cond), safety=safety)


# (steps, SLD config): `max()` for one step, where its clip at 5000 x
# |eps_c - eps_s| acts on the first prediction; and 3 steps across the
# warm-up boundary (warm-up 1) with momentum and a guidance scale of 10,
# where the clip's slope does not multiply the two packages' rounding
# differences by thousands (at `max()` they reach 5.5e-4 after 3 steps from
# 8e-8 after one; at this config 6.9e-6 after 3)
CASES = {"max_1_step": (1, dataclasses.asdict(SLDConfig.max())),
         "warmup_1_3_steps": (3, dict(guidance_scale=10.0, threshold=1.0,
                                      momentum_scale=0.5, momentum_beta=0.7,
                                      warmup_steps=1))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sld_generate_matches_jax(sd, monkeypatch, case):
    """`sld_generate(decode=False)`, PNDM, CFG 7.5, on tiny_config, against
    JAX's on the noise JAX draws from its key; the SLD latents differ from
    plain CFG's on the same noise."""
    steps, fields = CASES[case]
    cfg, port = sd["cfg"], sd["port"]
    cond, uncond, safety = sd["cond"], sd["uncond"], sd["safety"]
    key = jax.random.PRNGKey(6)
    ref = jsld.sld_generate(JaxPipeline(cfg), sd["params"], jnp.asarray(cond),
                            jnp.asarray(uncond),
                            jnp.asarray(np.repeat(safety, 2, 0)), key,
                            num_steps=steps, guidance_scale=GUIDANCE,
                            sld=jsld.SLDConfig(**fields), decode=False)
    s = cfg.sample_size
    noise = tp.nchw(np.asarray(jax.random.normal(key, (2, s, s, 4),
                                                 jnp.float32)))
    monkeypatch.setattr(port, "initial_noise", lambda b, g: noise)

    def ids(a):
        return torch.from_numpy(a).long()
    got = sld_generate(port, ids(cond), ids(uncond), ids(safety),
                       torch.Generator(), num_steps=steps,
                       guidance_scale=GUIDANCE, sld=SLDConfig(**fields),
                       decode=False)
    assert tp.rel_err(tp.nhwc(got), ref) < TOL
    assert tp.rel_err(ref, tp.nhwc(noise)) > 0.01       # the run moved them
    context = torch.cat([port.encode_text(ids(uncond))[0],
                         port.encode_text(ids(cond))[0]])
    plain, _ = port.denoise(context, noise * port.scheduler.init_noise_sigma,
                            steps, GUIDANCE)
    assert tp.rel_err(tp.nhwc(plain), ref) > 1e-3


@pytest.mark.parametrize("fields", [
    dict(prediction_type="v_prediction", scheduler="ddim"),
    dict(scheduler="lcm", unet={"time_cond_proj_dim": 32})])
def test_sld_refuses_v_prediction_and_lcm(fields):
    """The reference's SLD loop feeds eps_hat to the scheduler as eps, with
    no LCM embedding or step noise: the port raises rather than run a loop
    whose result would be wrong."""
    fields = dict(fields)
    unet = fields.pop("unet", None)
    cfg = tiny_config()
    if unet:
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet,
                                                                **unet))
    pipe = StableDiffusionPipeline(dataclasses.replace(cfg, **fields),
                                   device="cpu")
    ids = torch.zeros((1, cfg.text_encoder.max_length), dtype=torch.long)
    with pytest.raises(ValueError, match="SLD"):
        sld_generate(pipe, ids, ids, ids, torch.Generator(), num_steps=1)
    with pytest.raises(ValueError, match="SLD"):
        sld_denoise(pipe, torch.zeros(3, 16, 32), torch.zeros(1, 4, 8, 8), 1,
                    GUIDANCE, SLDConfig())
    assert "nudity" in SAFETY_CONCEPT
