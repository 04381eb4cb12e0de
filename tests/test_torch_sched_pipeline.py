"""The torch port's `denoise` under DDIM, Euler, DPM-Solver++ 2M and LCM
against the JAX pipeline's, on the CPU.

`tiny_config` in f32 on the weights of tests/torch_parity.py, MoE routing on
all 16 FFs, CFG 7.5, 3 steps, from JAX-made initial latents (scaled by the
scheduler's initial sigma, as `generate` scales them) and a numpy-made
(uncond, cond) context. LCM runs its own weights (a UNet with
`time_cond_proj_dim` 32) with JAX's step noise handed in. The same with
DeepCache at interval 2: tests/test_torch_sched_deepcache.py, a file of its
own so that the test workers share out the JAX compiles (PNDM's:
tests/test_torch_deepcache.py). Also: the refusals both packages share, and
LCM's per-request step noise under `generate(seeds=)`.
"""
import pytest
import torch

import torch_parity
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from diffusion_models_moe_tpu.pipelines.stable_diffusion import \
    StableDiffusionPipeline as JaxPipeline
from diffusion_models_moe_tpu_torch import StableDiffusionPipeline
from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import (
    SCHEDULERS, step_seed)
from torch_parity import tiny_pair

REL_TOL = 1e-3
STEPS, GUIDANCE = 3, 7.5
LCM_UNET = {"time_cond_proj_dim": 32}


@pytest.fixture(scope="module")
def data():
    return torch_parity.scheduler_data(LCM_UNET)


@pytest.mark.parametrize("scheduler", ["ddim", "euler", "dpm", "lcm"])
def test_denoise_matches_jax(data, scheduler):
    """3 steps with CFG 7.5 (LCM: the guidance embedding, no CFG) and MoE on
    all 16 FFs, the full UNet every step."""
    torch_parity.check_denoise(data, scheduler, 0, LCM_UNET, STEPS, GUIDANCE,
                               REL_TOL)


@pytest.mark.parametrize("fields", [
    dict(scheduler="euler", prediction_type="v_prediction"),
    dict(scheduler="pndm", prediction_type="v_prediction"),
    dict(scheduler="lcm")])
def test_refusals_match_jax(fields):
    """v-prediction with Euler or PNDM, and LCM without the guidance
    embedding, raise ValueError in both packages; the neighbours do not."""
    jax_cfg, port_cfg = tiny_pair(**fields)
    with pytest.raises(ValueError):
        JaxPipeline(jax_cfg)
    with pytest.raises(ValueError):
        StableDiffusionPipeline(port_cfg, device="cpu")
    ok = dict(fields, scheduler="ddim" if "prediction_type" in fields
              else "lcm")
    jax_cfg, port_cfg = tiny_pair(unet=LCM_UNET, **ok)
    JaxPipeline(jax_cfg)
    StableDiffusionPipeline(port_cfg, device="cpu")


def test_every_scheduler_of_the_jax_package_is_ported():
    from diffusion_models_moe_tpu.pipelines import stable_diffusion as jsd
    assert SCHEDULERS.keys() == jsd.SCHEDULERS.keys()
    for name, cls in SCHEDULERS.items():
        assert cls.__name__ == jsd.SCHEDULERS[name].__name__


def test_lcm_request_is_independent_of_its_batch(data):
    """`generate(seeds=)` under LCM: request 0 alone (its batch padded with
    itself, as the serving engine pads) equals request 0 beside another
    prompt and seed, bit for bit; its step noise comes from its own seed
    alone, apart from its initial noise; a guidance scale above 1 runs no
    CFG (the UNet batch stays B)."""
    _, port = data["lcm"]
    _, cfg = tiny_pair(unet=LCM_UNET, scheduler="lcm")
    pipe = StableDiffusionPipeline(cfg, device="cpu")
    pipe.load_state_dicts({k: m.state_dict() for k, m in port.modules().items()})
    t = cfg.text_encoder
    ids = torch.randint(0, t.vocab_size, (2, t.max_length),
                        generator=torch.Generator().manual_seed(2))
    un = torch.zeros_like(ids)
    batches = []
    hook = pipe.unet.register_forward_pre_hook(
        lambda _m, args: batches.append(args[0].shape[0]))
    kw = dict(num_steps=4, guidance_scale=8.0, decode=False)
    alone, _ = pipe.generate(torch.cat([ids[:1]] * 2), un, seeds=[7, 7], **kw)
    crowded, _ = pipe.generate(ids, un, seeds=[7, 9], **kw)
    hook.remove()
    torch.testing.assert_close(alone[0], crowded[0], rtol=0, atol=0)
    torch.testing.assert_close(alone[0], alone[1], rtol=0, atol=0)
    assert (crowded[1] - crowded[0]).abs().max() > 1e-3
    assert batches == [2] * 8
    assert step_seed(7) != 7 and step_seed(7) == step_seed(7)
    g = pipe.step_generators([7])[0]
    assert g.initial_seed() == step_seed(7)
    # a generator: the step-noise seeds are its draws after the initial noise
    out1, _ = pipe.generate(ids, un, torch.Generator().manual_seed(3), **kw)
    out2, _ = pipe.generate(ids, un, torch.Generator().manual_seed(3), **kw)
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)
