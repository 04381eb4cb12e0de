"""Parity of the torch port's models with the JAX package, on the CPU.

Each JAX model is initialised at `tiny_config` in f32, its params go through
`weights/bridge.py` into the port's module, and both run the same numpy
inputs. The tolerance is the one of the repo's torch mirrors
(tests/test_unet_torch_parity.py: atol = rtol = 2e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu.models.attention import \
    GEGLUFeedForward as JaxFF
from diffusion_models_moe_tpu.models.clip_text import \
    CLIPTextEncoder as JaxCLIP
from diffusion_models_moe_tpu.models.unet import UNet2DCondition as JaxUNet
from diffusion_models_moe_tpu.models.vae import VAEDecoder as JaxVAE
from diffusion_models_moe_tpu.moefication.moefy import \
    build_moe_interventions as jax_build_ivs
from diffusion_models_moe_tpu.schedulers.pndm import \
    PNDMScheduler as JaxPNDM
from diffusion_models_moe_tpu.taps import LayerIntervention as JaxIV
from diffusion_models_moe_tpu.weights.export import (export_unet,
                                                     export_vae_decoder)
from diffusion_models_moe_tpu.weights.port import port_clip_text_state_dict
from diffusion_models_moe_tpu_torch import config as tcfg
from diffusion_models_moe_tpu_torch.models.attention import GEGLUFeedForward
from diffusion_models_moe_tpu_torch.models.clip_text import CLIPTextEncoder
from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
from diffusion_models_moe_tpu_torch.models.vae import VAEDecoder
from diffusion_models_moe_tpu_torch.moefication.moefy import \
    build_moe_interventions
from diffusion_models_moe_tpu_torch.schedulers.pndm import PNDMScheduler
from diffusion_models_moe_tpu_torch.taps import LayerIntervention, layer_name
from diffusion_models_moe_tpu_torch.weights import bridge

TOL = 2e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _labels(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return {layer_name(i): rng.permutation(np.arange(4 * d) % ((4 * d) // 20))
            for i, d in enumerate(cfg.ff_dims())}


@pytest.fixture(scope="module")
def unet_case():
    """One JAX UNet (tiny, f32) with its params and MoE routing on all FFs,
    expert removal on layer 3 at step 1; run once for the module."""
    cfg = jcfg.tiny_config().unet
    rng = np.random.RandomState(0)
    lat = rng.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(2, 6, cfg.cross_attention_dim).astype(np.float32)
    model = JaxUNet(cfg)
    params = _np_tree(model.init(jax.random.PRNGKey(0), jnp.asarray(lat),
                                 jnp.zeros((1,), jnp.int32),
                                 jnp.asarray(ctx))["params"])
    labels = _labels(cfg)
    e3 = int(labels[layer_name(3)].max()) + 1
    remove = np.zeros((2, e3), bool)
    remove[1, :2] = True
    jivs = jax_build_ivs(labels, 0.3, expert_remove={layer_name(3): jnp.asarray(remove)})
    out = np.asarray(model.apply({"params": params}, jnp.asarray(lat),
                                 jnp.asarray([17]), jnp.asarray(ctx),
                                 step_idx=1, ivs=jivs))
    return dict(params=params, lat=lat, ctx=ctx, labels=labels,
                remove={layer_name(3): remove}, out=out)


def test_unet_matches_jax_with_moe_routing(unet_case):
    cfg = tcfg.tiny_config().unet
    unet = UNet2DCondition(cfg).eval()
    unet.load_state_dict(bridge.to_torch(
        bridge.unet_numpy_state_dict(unet_case["params"], cfg)), strict=True)
    ivs = build_moe_interventions(unet_case["labels"], 0.3,
                                  expert_remove=unet_case["remove"],
                                  device="cpu")
    with torch.no_grad():
        out = unet(torch.from_numpy(unet_case["lat"]).permute(0, 3, 1, 2), 17,
                   torch.from_numpy(unet_case["ctx"]), ivs=ivs, step_idx=1)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               unet_case["out"], atol=TOL, rtol=TOL)


def test_bridge_unet_state_dict_equals_export(unet_case):
    """The bridge and weights/export.py map the same params to the same
    diffusers state dict, key for key and bit for bit."""
    ours = bridge.unet_numpy_state_dict(unet_case["params"],
                                        tcfg.tiny_config().unet)
    theirs = export_unet(unet_case["params"], jcfg.tiny_config().unet)
    assert ours.keys() == theirs.keys()
    for key, val in theirs.items():
        np.testing.assert_array_equal(ours[key], val, err_msg=key)


@pytest.fixture(scope="module")
def vae_case():
    cfg = jcfg.tiny_config().vae
    rng = np.random.RandomState(1)
    lat = rng.randn(2, 4, 4, 4).astype(np.float32)
    model = JaxVAE(cfg)
    params = _np_tree(model.init(jax.random.PRNGKey(1), jnp.asarray(lat))["params"])
    out = np.asarray(model.apply({"params": params}, jnp.asarray(lat)))
    return dict(params=params, lat=lat, out=out)


def test_vae_decoder_matches_jax(vae_case):
    cfg = tcfg.tiny_config().vae
    vae = VAEDecoder(cfg).eval()
    vae.load_state_dict(bridge.to_torch(
        bridge.vae_decoder_numpy_state_dict(vae_case["params"], cfg)),
        strict=True)
    with torch.no_grad():
        out = vae(torch.from_numpy(vae_case["lat"]).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), vae_case["out"],
                               atol=TOL, rtol=TOL)


def test_bridge_vae_state_dict_equals_export(vae_case):
    ours = bridge.vae_decoder_numpy_state_dict(vae_case["params"],
                                               tcfg.tiny_config().vae)
    theirs = export_vae_decoder(vae_case["params"], jcfg.tiny_config().vae)
    assert ours.keys() == theirs.keys()
    for key, val in theirs.items():
        np.testing.assert_array_equal(ours[key], val, err_msg=key)


@pytest.fixture(scope="module")
def clip_case():
    cfg = jcfg.tiny_config().text_encoder
    rng = np.random.RandomState(2)
    ids = rng.randint(0, cfg.vocab_size, size=(2, cfg.max_length)).astype(np.int32)
    model = JaxCLIP(cfg)
    params = _np_tree(model.init(jax.random.PRNGKey(2), jnp.asarray(ids))["params"])
    # the init leaves position embeddings at zero; make them count
    params["position_embedding"] = rng.randn(
        *params["position_embedding"].shape).astype(np.float32)
    out = np.asarray(model.apply({"params": params}, jnp.asarray(ids)))
    return dict(params=params, ids=ids, out=out)


def test_clip_text_matches_jax(clip_case):
    cfg = tcfg.tiny_config().text_encoder
    enc = CLIPTextEncoder(cfg).eval()
    enc.load_state_dict(bridge.to_torch(
        bridge.clip_text_numpy_state_dict(clip_case["params"], cfg)),
        strict=True)
    with torch.no_grad():
        out = enc(torch.from_numpy(clip_case["ids"]).long())
    np.testing.assert_allclose(out.numpy(), clip_case["out"], atol=TOL, rtol=TOL)


def test_bridge_clip_state_dict_roundtrips_through_port(clip_case):
    """weights/port.py reads the bridge's CLIP state dict back into the same
    Flax params."""
    cfg = tcfg.tiny_config().text_encoder
    sd = bridge.clip_text_numpy_state_dict(clip_case["params"], cfg)
    back = port_clip_text_state_dict(sd, jcfg.tiny_config().text_encoder)
    flat_a = jax.tree_util.tree_leaves_with_path(clip_case["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, val in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), val)


@pytest.mark.parametrize("step", [0, 1])
def test_ff_module_expert_remove_matches_jax(step):
    """GEGLUFeedForward with patterns, k and per-step expert removal, LN and
    residual absorbed, against the JAX module's path."""
    rng = np.random.RandomState(3)
    dim, e, k = 32, 8, 3
    x = rng.randn(2, 16, dim).astype(np.float32)
    labels = rng.permutation(np.arange(4 * dim) % e)
    pat = (labels[None, :] == np.arange(e)[:, None]).astype(np.float32)
    remove = np.zeros((2, e), bool)
    remove[1, [0, 5]] = True
    g = (1 + 0.1 * rng.randn(dim)).astype(np.float32)
    b = (0.1 * rng.randn(dim)).astype(np.float32)
    jff = JaxFF(dim, 4, dtype=jnp.float32)
    jiv = JaxIV(patterns=jnp.asarray(pat), k=k, expert_remove=jnp.asarray(remove))
    params = _np_tree(jff.init(jax.random.PRNGKey(3), jnp.asarray(x), iv=jiv))
    p = params["params"]
    p["proj"]["bias"] = (0.1 * rng.randn(*p["proj"]["bias"].shape)).astype(np.float32)
    p["out_proj_bias"] = (0.1 * rng.randn(dim)).astype(np.float32)
    ref = np.asarray(jff.apply(params, jnp.asarray(x), step_idx=step, iv=jiv,
                               ln=(jnp.asarray(g), jnp.asarray(b), 1e-5)))
    ff = GEGLUFeedForward(dim, 4).eval()
    ff.load_state_dict({
        "net.0.proj.weight": torch.from_numpy(np.ascontiguousarray(p["proj"]["kernel"].T)),
        "net.0.proj.bias": torch.from_numpy(p["proj"]["bias"]),
        "net.2.weight": torch.from_numpy(np.ascontiguousarray(p["out_proj_kernel"].T)),
        "net.2.bias": torch.from_numpy(p["out_proj_bias"]),
    })
    ln = torch.nn.LayerNorm(dim, eps=1e-5)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(g))
        ln.bias.copy_(torch.from_numpy(b))
        iv = LayerIntervention(patterns=torch.from_numpy(pat), k=k,
                               expert_remove=torch.from_numpy(remove))
        out = ff(torch.from_numpy(x), step_idx=step, iv=iv, ln=ln)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("steps", [4, 50])
def test_pndm_matches_jax(steps):
    """Same timesteps and coefficients, and the same latents after every
    step of a PLMS run on shared random eps."""
    jax_sched, sched = JaxPNDM.create(), PNDMScheduler.create()
    jt, jc, _ = jax_sched.set_timesteps(steps)
    tt, tc = sched.set_timesteps(steps)
    np.testing.assert_array_equal(np.asarray(jt), tt)
    for key in ("c_sample", "c_eps"):
        np.testing.assert_array_equal(np.asarray(jc[key]),
                                      tc[key].astype(np.float32))
    rng = np.random.RandomState(steps)
    x = rng.randn(1, 4, 4, 4).astype(np.float32)
    jstate, state = jax_sched.init_state(x.shape), sched.init_state()
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i in range(min(len(tt), 8)):
        eps = rng.randn(*x.shape).astype(np.float32)
        jstate, jx = jax_sched.step(jstate, jc, jnp.asarray(eps), jnp.asarray(i), jx)
        state, tx = sched.step(state, tc, torch.from_numpy(eps), i, tx)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6, rtol=1e-6)
