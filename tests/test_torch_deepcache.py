"""The torch port's DeepCache serving mode against the JAX package, on the
CPU: the UNet's full forward with the deep feature returned and its shallow
forward on a cached one, `denoise` with `deep_cache_interval` 1, 2 and 3 on
injected latents, and a `ServingEngine` with Winograd, int8 and DeepCache
together. `tiny_config`, f32, weights through tests/torch_parity.py.
"""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu.moefication.moefy import \
    build_moe_interventions as jax_build_ivs
from diffusion_models_moe_tpu.pipelines.stable_diffusion import \
    StableDiffusionPipeline as JaxPipeline
from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline, TapSpec,
                                            build_moe_interventions,
                                            tiny_config)
from diffusion_models_moe_tpu_torch.data.tokenize import \
    per_prompt_hash_tokenize
from diffusion_models_moe_tpu_torch.models.attention import GEGLUFeedForward
from diffusion_models_moe_tpu_torch.serving import ServingEngine
from torch_parity import nchw, nhwc, rel_err

MODEL_TOL = 2e-4    # the limit of the port's model parity tests
SLICE_TOL = 1e-3    # the limit of the port's pipeline parity tests
STEPS, GUIDANCE = 4, 7.5      # 5 entries in PNDM's table


@pytest.fixture(scope="module")
def case():
    """The JAX pipeline and the port at tiny_config with the same weights,
    a CFG context, injected latents and MoE routing on all 16 FFs."""
    cfg = jcfg.tiny_config()
    pipe = JaxPipeline(cfg)
    params, port = torch_parity.pipelines(cfg)
    rng = np.random.RandomState(1)
    t = cfg.text_encoder
    cond = rng.randint(0, t.vocab_size, size=(2, t.max_length)).astype(np.int32)
    latents = rng.randn(2, 8, 8, 4).astype(np.float32)
    labels = torch_parity.labels(cfg.unet)
    emb_c, _ = pipe.encode_text(params, jnp.asarray(cond))
    emb_u, _ = pipe.encode_text(params, jnp.zeros_like(cond))
    context = np.array(jnp.concatenate([emb_u, emb_c]))
    return dict(cfg=cfg, params=params, port=port, latents=latents,
                context=context, jivs=jax_build_ivs(labels, 0.3),
                ivs=build_moe_interventions(labels, 0.3, device="cpu"))


def _with_interval(port, interval):
    """The port's pipeline at another `deep_cache_interval` (same modules)."""
    pipe = copy.copy(port)
    pipe.config = dataclasses.replace(port.config, deep_cache_interval=interval)
    return pipe


def test_full_and_shallow_forwards_match_jax(case):
    """The full forward returns the feature entering the last up block; the
    shallow forward on it runs conv_in, down block 0, the last up block and
    conv_out, its FFs under their full-forward numbers."""
    cfg, params = case["cfg"], case["params"]
    lat4 = np.concatenate([case["latents"]] * 2)
    args = (jnp.asarray(lat4), jnp.asarray([17]), jnp.asarray(case["context"]))
    from diffusion_models_moe_tpu.models.unet import UNet2DCondition as JaxUNet
    model = JaxUNet(cfg.unet)
    kw = dict(step_idx=1, ivs=case["jivs"])
    eps_ref, deep_ref = model.apply({"params": params["unet"]}, *args,
                                    return_deep=True, **kw)
    lat_next = jnp.asarray(lat4 * 0.9 + 0.05)
    shallow_ref = model.apply({"params": params["unet"]}, lat_next, *args[1:],
                              deep_feature=deep_ref, **kw)

    unet = case["port"].unet
    ran = []
    hooks = [m.register_forward_hook(
        lambda mod, *_: ran.append(mod.ff_index))
        for m in unet.modules() if isinstance(m, GEGLUFeedForward)]
    ctx = torch.from_numpy(case["context"])
    with torch.no_grad():
        eps, deep = unet(nchw(lat4), 17, ctx, ivs=case["ivs"], step_idx=1,
                         return_deep=True)
        assert ran == list(range(16))
        ran.clear()
        shallow = unet(nchw(np.asarray(lat_next)), 17, ctx, ivs=case["ivs"],
                       step_idx=1, deep_feature=deep)
    for h in hooks:
        h.remove()
    # down block 0's two FFs and the last up block's three
    assert ran == [0, 1, 13, 14, 15]
    assert tuple(deep.shape) == (4, 64, 8, 8)
    assert rel_err(nhwc(deep), np.asarray(deep_ref)) < MODEL_TOL
    assert rel_err(nhwc(eps), np.asarray(eps_ref)) < MODEL_TOL
    assert rel_err(nhwc(shallow), np.asarray(shallow_ref)) < MODEL_TOL
    assert rel_err(shallow.numpy(), eps.numpy()) > 1e-3


def test_deep_cache_misuse_raises(case):
    unet = case["port"].unet
    lat = torch.zeros(1, 4, 8, 8)
    ctx = torch.zeros(1, 4, 32)
    with pytest.raises(ValueError, match="exclusive"):
        unet(lat, 1, ctx, deep_feature=torch.zeros(1, 64, 8, 8),
             return_deep=True)
    one_up = dataclasses.replace(
        tiny_config().unet, block_out_channels=(32,),
        down_block_types=("cross",), up_block_types=("cross",))
    from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
    with pytest.raises(ValueError, match=">= 2 up blocks"):
        UNet2DCondition(one_up)(lat, 1, ctx, return_deep=True)
    with pytest.raises(ValueError, match="does not support taps"):
        _with_interval(case["port"], 2).denoise(
            ctx.repeat(2, 1, 1), lat, 2, 7.5, tap=TapSpec(max_gate=True))


@pytest.mark.parametrize("interval", [1, 2, 3])
def test_denoise_with_deep_cache_matches_jax(case, interval, monkeypatch):
    cfg = dataclasses.replace(case["cfg"], deep_cache_interval=interval)
    ref, _ = JaxPipeline(cfg).denoise(
        case["params"], jnp.asarray(case["context"]),
        jnp.asarray(case["latents"]), STEPS, GUIDANCE, ivs=case["jivs"])
    port = _with_interval(case["port"], interval)
    kinds = []
    real = port.unet.forward
    monkeypatch.setattr(
        port.unet, "forward",
        lambda *a, **kw: kinds.append("shallow" if kw.get("deep_feature")
                                      is not None else "full")
        or real(*a, **kw))
    ctx = torch.from_numpy(case["context"])
    got, taps = port.denoise(ctx, nchw(case["latents"]), STEPS, GUIDANCE,
                             ivs=case["ivs"])
    assert taps is None
    # the branch is on the index over PNDM's STEPS + 1 entries
    assert kinds == ["full" if i % interval == 0 else "shallow"
                     for i in range(STEPS + 1)]
    assert rel_err(nhwc(got), np.asarray(ref)) < SLICE_TOL
    exact, _ = case["port"].denoise(ctx, nchw(case["latents"]), STEPS,
                                    GUIDANCE, ivs=case["ivs"])
    if interval == 1:
        np.testing.assert_array_equal(got.numpy(), exact.numpy())
    else:
        assert not torch.equal(got, exact)


def test_engine_serves_with_winograd_int8_and_deep_cache():
    """The slice as a whole: a `ServingEngine` over a pipeline with
    Winograd, int8 and DeepCache 2 together serves seeded requests; request
    0 served alone equals request 0 co-batched, bit for bit."""
    cfg = tiny_config(conv_winograd="1", quant_int8=True,
                      deep_cache_interval=2)
    pipe = StableDiffusionPipeline(cfg, device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    tok = per_prompt_hash_tokenize(cfg.text_encoder.vocab_size,
                                   cfg.text_encoder.max_length)
    ivs = build_moe_interventions(torch_parity.labels(cfg.unet), 0.3,
                                  device="cpu")
    kw = dict(batch_size=2, num_steps=3, ivs=ivs)
    with ServingEngine(pipe, tok, max_wait_ms=2000.0, **kw) as eng:
        futs = [eng.submit(f"prompt {i}", seed=i) for i in range(3)]
        imgs = [f.result(timeout=120) for f in futs]
    assert (eng.stats.requests, eng.stats.batches) == (3, 2)
    for im in imgs:
        assert im.dtype == np.uint8 and im.shape == (64, 64, 3) and im.std() > 0
    with ServingEngine(pipe, tok, max_wait_ms=50.0, **kw) as eng:
        alone = eng.submit("prompt 0", seed=0).result(timeout=120)
    np.testing.assert_array_equal(alone, imgs[0])
