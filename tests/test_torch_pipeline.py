"""The torch port's serving slice against the JAX pipeline, on the CPU.

One JAX run (tiny_config, f32): encode the prompt and the negative prompt,
denoise 2 PNDM steps with CFG 7.5 and MoE routing on all 16 FFs from
JAX-made initial latents, decode. The port runs the same weights
(tests/torch_parity.py), ids and initial latents; noise never crosses
frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu.moefication.moefy import \
    build_moe_interventions as jax_build_ivs
from diffusion_models_moe_tpu.pipelines.stable_diffusion import \
    StableDiffusionPipeline as JaxPipeline
from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                            build_moe_interventions,
                                            tiny_config)
from diffusion_models_moe_tpu_torch.ops import _build

REL_TOL = 1e-3
STEPS, GUIDANCE = 2, 7.5
_rel_err = torch_parity.rel_err


@pytest.fixture(scope="module")
def jax_run():
    cfg = jcfg.tiny_config()
    pipe = JaxPipeline(cfg)
    params, port = torch_parity.pipelines(cfg)
    s, t = cfg.sample_size, cfg.text_encoder
    rng = np.random.RandomState(1)
    cond = rng.randint(0, t.vocab_size, size=(2, t.max_length)).astype(np.int32)
    uncond = np.zeros_like(cond)
    latents = jax.random.normal(jax.random.PRNGKey(3), (2, s, s, 4),
                                jnp.float32)
    labels = torch_parity.labels(cfg.unet)
    emb_c, _ = pipe.encode_text(params, jnp.asarray(cond))
    emb_u, _ = pipe.encode_text(params, jnp.asarray(uncond))
    context = jnp.concatenate([emb_u, emb_c])
    final, _ = pipe.denoise(params, context, latents, STEPS, GUIDANCE,
                            ivs=jax_build_ivs(labels, 0.3))
    images = pipe.vae_decoder.apply({"params": params["vae"]}, final)
    images = jnp.clip(images / 2.0 + 0.5, 0.0, 1.0)
    return dict(port=port, cond=cond, uncond=uncond, labels=labels,
                latents=np.array(latents), context=np.array(context),
                final=np.array(final), images=np.array(images))


@pytest.fixture(scope="module")
def port(jax_run):
    return jax_run["port"]


def test_encode_text_matches_jax(jax_run, port):
    emb_c, taps_c = port.encode_text(torch.from_numpy(jax_run["cond"]).long())
    emb_u, taps_u = port.encode_text(torch.from_numpy(jax_run["uncond"]).long())
    assert taps_c is None and taps_u is None
    got = torch.cat([emb_u, emb_c]).numpy()
    assert _rel_err(got, jax_run["context"]) < REL_TOL


def test_denoise_and_decode_match_jax(jax_run, port):
    """encode -> 2 PNDM steps with CFG 7.5 and MoE on all 16 FFs -> decode."""
    ids = [torch.from_numpy(jax_run[k]).long() for k in ("uncond", "cond")]
    context = torch.cat([port.encode_text(i)[0] for i in ids])
    ivs = build_moe_interventions(jax_run["labels"], 0.3, device="cpu")
    assert sum(iv is not None for iv in ivs) == 16
    lat = torch.from_numpy(jax_run["latents"]).permute(0, 3, 1, 2)
    _build.reset_launch_counts()
    final, taps = port.denoise(context, lat, STEPS, GUIDANCE, ivs=ivs)
    assert taps is None
    assert all(v == 0 for v in _build.LAUNCHES.values())   # CPU: plain versions
    got = final.permute(0, 2, 3, 1).numpy()
    assert _rel_err(got, jax_run["final"]) < REL_TOL
    images = port.decode(final).permute(0, 2, 3, 1).numpy()
    assert _rel_err(images, jax_run["images"]) < REL_TOL


def test_denoise_with_the_exact_tier_modes_matches_jax(jax_run, port):
    """The same slice with `attn_absorb` and `conv_chain` on (same state
    dicts): against the port's own `denoise` with the modes off and against
    the JAX pipeline's, from the JAX-made latents."""
    modes_on = StableDiffusionPipeline(
        tiny_config(attn_absorb="1", conv_chain=True), device="cpu")
    modes_on.load_state_dicts({k: m.state_dict()
                               for k, m in port.modules().items()})
    ids = [torch.from_numpy(jax_run[k]).long() for k in ("uncond", "cond")]
    context = torch.cat([port.encode_text(i)[0] for i in ids])
    ivs = build_moe_interventions(jax_run["labels"], 0.3, device="cpu")
    lat = torch.from_numpy(jax_run["latents"]).permute(0, 3, 1, 2)
    on, _ = modes_on.denoise(context, lat, STEPS, GUIDANCE, ivs=ivs)
    off, _ = port.denoise(context, lat, STEPS, GUIDANCE, ivs=ivs)
    assert not torch.equal(on, off)       # the modes' own summation orders
    assert _rel_err(on.numpy(), off.numpy()) < REL_TOL
    assert _rel_err(on.permute(0, 2, 3, 1).numpy(), jax_run["final"]) < REL_TOL


def test_generate_guidance_one_turns_cfg_off(port):
    """guidance <= 1 runs the unconditional-free batch: the result equals a
    denoise on the prompt context alone from the same noise."""
    cfg = port.config
    ids = torch.randint(0, cfg.text_encoder.vocab_size,
                        (2, cfg.text_encoder.max_length),
                        generator=torch.Generator().manual_seed(3))
    out, taps = port.generate(ids, torch.zeros_like(ids),
                              torch.Generator().manual_seed(4),
                              num_steps=STEPS, guidance_scale=1.0,
                              decode=False)
    assert taps is None
    s = cfg.sample_size
    noise = torch.randn((2, cfg.unet.sample_channels, s, s),
                        generator=torch.Generator().manual_seed(4))
    ref, _ = port.denoise(port.encode_text(ids)[0], noise, STEPS, 1.0)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_generate_images_are_finite_in_unit_range(port, jax_run):
    ivs = build_moe_interventions(jax_run["labels"], 0.3, device="cpu")
    cond = torch.from_numpy(jax_run["cond"]).long()
    img, taps = port.generate(cond, torch.zeros_like(cond),
                              torch.Generator().manual_seed(5),
                              num_steps=STEPS, ivs=ivs)
    assert taps is None
    s = port.config.sample_size * 8
    assert img.shape == (2, 3, s, s)
    assert torch.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0


@pytest.mark.parametrize("entry", ["pipeline", "moe", "neuron", "expert",
                                   "wanda"])
def test_entry_points_default_to_the_card(entry):
    """Every entry point that makes tensors runs on the card unless the
    caller asks for the CPU: with no CUDA device the default raises and
    nothing falls back to the CPU."""
    from diffusion_models_moe_tpu_torch.erasure import masks
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    cfg = tiny_config()
    labels = torch_parity.labels(cfg.unet)
    mask = {0: np.zeros(128, bool)}
    calls = {
        "pipeline": lambda **kw: StableDiffusionPipeline(cfg, **kw),
        "moe": lambda **kw: build_moe_interventions(labels, 0.3, **kw),
        "neuron": lambda **kw: masks.neuron_removal_interventions(mask, **kw),
        "expert": lambda **kw: masks.expert_removal_interventions(
            {0: np.zeros(6, bool)}, labels, 0.3, **kw),
        "wanda": lambda **kw: masks.wanda_removal_interventions(
            {0: np.zeros((32, 128), bool)}, **kw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device is present"):
        calls[entry]()
    out = calls[entry](device="cpu")
    dev = (out.device if entry == "pipeline" else
           next(t for t in vars(out[0]).values()
                if isinstance(t, torch.Tensor)).device)
    assert dev.type == "cpu"
