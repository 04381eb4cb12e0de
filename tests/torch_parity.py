"""Shared set-up of the torch port's parity tests (tests/test_torch_*.py):
seeded weights at tiny_config in f32 for both packages, random expert
labels, and the error measure.

Weights are drawn with numpy in the port's state-dict layout (diffusers /
transformers names), go into the JAX package through its own porter
(`weights/port.py`), and come back into the port through
`weights/bridge.py`: both run the same numbers, and the round trip is
checked on every set-up.

`one_torch_thread`, imported into a test module, runs that module's torch
work on one intra-op thread.
"""
import dataclasses

import numpy as np
import pytest
import torch

from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu.weights.port import (port_clip_text_state_dict,
                                                   port_unet_state_dict,
                                                   port_vae_decoder)
from diffusion_models_moe_tpu_torch import StableDiffusionPipeline, tiny_config
from diffusion_models_moe_tpu_torch.taps import layer_name
from diffusion_models_moe_tpu_torch.weights import bridge


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The module's tests on one torch intra-op thread, the count restored
    after: the suite runs six pytest workers on the host's cores, and
    torch's default of a thread per core leaves each worker's small ops
    waiting on the others' (tests/test_torch_taps.py 148 s against 70 s
    under six busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-12))


def tiny_pair(unet: dict = None, text_encoder: dict = None, **fields):
    """(the JAX package's tiny_config, the port's tiny_config), both in f32,
    with the same UNet, text-encoder and pipeline fields replaced (e.g.
    `unet={"time_cond_proj_dim": 32}, scheduler="lcm"`)."""
    out = []
    for base in (jcfg.tiny_config(), tiny_config()):
        kw = dict(fields)
        if unet:
            kw["unet"] = dataclasses.replace(base.unet, **unet)
        if text_encoder:
            kw["text_encoder"] = dataclasses.replace(base.text_encoder,
                                                     **text_encoder)
        out.append(dataclasses.replace(base, **kw))
    return tuple(out)


def jax_lcm_noise(key, sample_shape: tuple, steps: int) -> np.ndarray:
    """(steps, *sample_shape) f32: the noise the JAX package's LCM step
    draws at each step from the key it is given (`LCMScheduler.init_state`
    folds the batch index into it; a step splits each sample's key once),
    so that the port can be handed JAX's noise."""
    import jax
    import jax.numpy as jnp
    from diffusion_models_moe_tpu.schedulers.lcm import LCMScheduler
    keys = LCMScheduler.create().init_state(sample_shape, key=key).key
    out = []
    for _ in range(steps):
        split = jax.vmap(jax.random.split)(keys)
        keys, subs = split[:, 0], split[:, 1]
        out.append(np.array(jax.vmap(lambda k: jax.random.normal(
            k, sample_shape[1:], jnp.float32))(subs)))
    return np.stack(out)


def block_state_dict(kind: str, params: dict) -> dict:
    """One block's JAX params -> the port block's torch state dict, through
    the bridge's own per-block mapping. kind: "resnet" (ResnetBlock2D) or
    "transformer_block" (BasicTransformerBlock)."""
    sd: dict = {}
    getattr(bridge, f"_{kind}")(sd, "_", params)
    return bridge.to_torch({k[2:]: v for k, v in sd.items()})


def labels(unet_cfg, seed: int = 0) -> dict:
    """Random balanced 20-neuron expert labels for every FF layer."""
    rng = np.random.RandomState(seed)
    return {layer_name(i): rng.permutation(np.arange(4 * d) % ((4 * d) // 20))
            for i, d in enumerate(unet_cfg.ff_dims())}


def _random_state(module: torch.nn.Module, rng: np.random.RandomState) -> dict:
    """Numpy weights for `module`'s state dict: matrices and kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.01), biases N(0, 0.01)."""
    out = {}
    for name, t in module.state_dict().items():
        shape = tuple(t.shape)
        v = rng.randn(*shape).astype(np.float32)
        if len(shape) == 1:
            v = 0.1 * v + (1.0 if name.endswith("weight") else 0.0)
        else:
            v = v * np.prod(shape[1:]) ** -0.5
        out[name] = v.astype(np.float32)
    return out


def nchw(a) -> torch.Tensor:
    """A JAX-side NHWC array as the port's NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a), (0, 3, 1, 2))))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def oihw(k) -> torch.Tensor:
    """A JAX-side HWIO kernel as the port's OIHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(k), (3, 2, 0, 1))))


def rel_l2(got, ref) -> float:
    """||got - ref|| / ||ref||."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / (np.linalg.norm(ref) + 1e-12))


def pipelines(jax_cfg, seed: int = 0, port_cfg=None):
    """(JAX params as numpy, the port's tiny f32 pipeline), same weights.
    `port_cfg`: the port's config where it differs from `tiny_config()` (its
    serving modes; the parameters are the same)."""
    port = StableDiffusionPipeline(port_cfg or tiny_config(), device="cpu")
    rng = np.random.RandomState(seed)
    sds = {k: _random_state(m, rng) for k, m in port.modules().items()}
    params = {
        "unet": port_unet_state_dict(sds["unet"], jax_cfg.unet),
        "text_encoder": port_clip_text_state_dict(sds["text_encoder"],
                                                  jax_cfg.text_encoder),
        "vae": port_vae_decoder("", jax_cfg.vae, _sd=sds["vae"]),
    }
    back = bridge.pipeline_state_dicts(params, port.config)
    for key, sd in sds.items():
        assert back[key].keys() == sd.keys(), key
        for name, v in sd.items():
            np.testing.assert_array_equal(back[key][name].numpy(), v,
                                          err_msg=name)
    port.load_state_dicts(back)
    return params, port


def weights(**unet):
    """`pipelines` for a tiny UNet with `unet`'s fields replaced: (JAX
    params, the port's pipeline), same weights."""
    jax_cfg, port_cfg = tiny_pair(unet=unet or None)
    return pipelines(jax_cfg, port_cfg=port_cfg)


def denoise_data(jax_cfg=None) -> dict:
    """The inputs of the `denoise` parity cases: random expert labels,
    JAX-made N(0, 1) latents (2, s, s, 4) and a numpy-made (uncond, cond)
    context (4, S, D)."""
    import jax
    import jax.numpy as jnp
    jax_cfg = jax_cfg or jcfg.tiny_config()
    s, t = jax_cfg.sample_size, jax_cfg.text_encoder
    rng = np.random.RandomState(1)
    return dict(
        labels=labels(jax_cfg.unet),
        latents=np.array(jax.random.normal(jax.random.PRNGKey(3),
                                           (2, s, s, 4), jnp.float32)),
        context=rng.randn(4, t.max_length,
                          jax_cfg.unet.cross_attention_dim).astype(np.float32))


def denoise_both(params, port, jax_cfg, port_cfg, data: dict, steps: int,
                 guidance: float, context=None):
    """The JAX pipeline's and the port's `denoise` for one config on the
    same weights (`port`'s state dicts), MoE routing on every FF: (port
    latents NHWC, JAX latents NHWC). The initial latents are scaled by the
    scheduler's initial sigma, as `generate` scales them; under LCM the
    context is its cond half and the port is handed JAX's step noise."""
    import jax
    import jax.numpy as jnp
    from diffusion_models_moe_tpu.moefication.moefy import \
        build_moe_interventions as jax_build_ivs
    from diffusion_models_moe_tpu.pipelines.stable_diffusion import \
        StableDiffusionPipeline as JaxPipeline
    from diffusion_models_moe_tpu_torch import build_moe_interventions
    jpipe = JaxPipeline(jax_cfg)
    pipe = StableDiffusionPipeline(port_cfg, device="cpu")
    pipe.load_state_dicts({k: m.state_dict() for k, m in port.modules().items()})
    lcm = jax_cfg.scheduler == "lcm"
    ctx = data["context"] if context is None else context
    ctx = ctx[ctx.shape[0] // 2:] if lcm else ctx
    scale = getattr(jpipe.scheduler, "init_noise_sigma_for", None)
    scale = scale(steps) if scale else jpipe.scheduler.init_noise_sigma
    lat = data["latents"] * np.float32(scale)
    key = jax.random.PRNGKey(5)
    ref, _ = jpipe.denoise(params, jnp.asarray(ctx), jnp.asarray(lat), steps,
                           guidance, ivs=jax_build_ivs(data["labels"], 0.3),
                           key=key if lcm else None)
    noise = None
    if lcm:
        noise = torch.from_numpy(jax_lcm_noise(key, lat.shape, steps)
                                 ).permute(0, 1, 4, 2, 3)
    got, taps = pipe.denoise(torch.from_numpy(np.asarray(ctx)), nchw(lat),
                             steps, guidance,
                             ivs=build_moe_interventions(data["labels"], 0.3,
                                                         device="cpu"),
                             step_noise=noise)
    assert taps is None and torch.isfinite(got).all()
    return nhwc(got), np.asarray(ref)


def scheduler_data(lcm_unet: dict) -> dict:
    """`denoise_data` and two weight sets: the tiny UNet ("plain") and one
    with `lcm_unet`'s fields ("lcm")."""
    return dict(denoise_data(), plain=weights(), lcm=weights(**lcm_unet))


def check_denoise(data: dict, scheduler: str, interval: int, lcm_unet: dict,
                  steps: int, guidance: float, rel_tol: float) -> None:
    """The port's `denoise` under `scheduler`, with DeepCache at `interval`
    (0: off), within `rel_tol` of JAX's on `scheduler_data`'s inputs, and
    the latents moved by the run."""
    lcm = scheduler == "lcm"
    jax_cfg, port_cfg = tiny_pair(unet=lcm_unet if lcm else None,
                                  scheduler=scheduler,
                                  deep_cache_interval=interval)
    params, port = data["lcm" if lcm else "plain"]
    got, ref = denoise_both(params, port, jax_cfg, port_cfg, data, steps,
                            guidance)
    assert rel_err(got, ref) < rel_tol
    assert rel_err(ref, data["latents"]) > 0.1


def tiny_sdxl(mod, lcm: bool = False):
    """The tiny SDXL geometry of tests/test_sdxl_pipeline.py (copied, not
    imported), in f32, built from the config module `mod` (the JAX
    package's or the port's): (pipeline config, (CLIP-L, bigG) text
    configs). 22 FFs; the two towers 16 and 32 wide make the 48-wide
    context. The UNet always carries LCM's guidance embedding (width 8), so
    one weight set serves Euler, which does not call it, and LCM."""
    unet = mod.UNetConfig(
        block_out_channels=(16, 32, 64),
        down_block_types=("plain", "cross", "cross"),
        up_block_types=("cross", "cross", "plain"),
        transformer_layers_per_block=(0, 2, 2),
        attention_head_dim=(2, 4, 8),
        cross_attention_dim=48,
        norm_num_groups=8,
        addition_embed_dim=32,
        addition_time_embed_dim=8,
        time_cond_proj_dim=8)
    tc1 = mod.CLIPTextConfig(vocab_size=100, hidden_size=16,
                             intermediate_size=32, num_layers=2, num_heads=2,
                             max_length=8)
    tc2 = mod.CLIPTextConfig(vocab_size=100, hidden_size=32,
                             intermediate_size=64, num_layers=2, num_heads=4,
                             max_length=8, hidden_act="gelu")
    cfg = mod.PipelineConfig(
        unet=unet, vae=mod.VAEConfig(block_out_channels=(16, 16, 32, 32),
                                     norm_num_groups=8, layers_per_block=1),
        sample_size=16, scheduler="lcm" if lcm else "euler",
        num_inference_steps=2)
    return cfg, (tc1, tc2)


def sdxl_pipelines(seed: int = 0) -> dict:
    """The tiny SDXL weights in both packages: numpy weights drawn in the
    port's state-dict layout, into JAX through its porters (the bigG
    projection transposed, as `port_sdxl_pipeline` does), back through the
    bridge (checked bit for bit) into the port's pipeline. Returns the JAX
    and port configs and text configs, the JAX params, the numpy state
    dicts and the port's pipeline (Euler)."""
    from diffusion_models_moe_tpu_torch import SDXLPipeline
    from diffusion_models_moe_tpu_torch import config as pcfg
    jax_cfg, jax_tc = tiny_sdxl(jcfg)
    port_cfg, port_tc = tiny_sdxl(pcfg)
    port = SDXLPipeline(port_cfg, port_tc, device="cpu")
    rng = np.random.RandomState(seed)
    sds = {k: _random_state(m, rng) for k, m in port.modules().items()}
    params = {
        "unet": port_unet_state_dict(sds["unet"], jax_cfg.unet),
        "text_encoder": port_clip_text_state_dict(sds["text_encoder"],
                                                  jax_tc[0]),
        "text_encoder_2": port_clip_text_state_dict(sds["text_encoder_2"],
                                                    jax_tc[1]),
        "text_projection_2": np.ascontiguousarray(
            sds["text_projection_2"]["weight"].T),
        "vae": port_vae_decoder("", jax_cfg.vae, _sd=sds["vae"]),
    }
    back = bridge.pipeline_state_dicts(params, port_cfg, port_tc)
    assert back.keys() == sds.keys()
    for key, sd in sds.items():
        assert back[key].keys() == sd.keys(), key
        for name, v in sd.items():
            np.testing.assert_array_equal(back[key][name].numpy(), v,
                                          err_msg=name)
    port.load_state_dicts(back)
    return dict(jax_cfg=jax_cfg, jax_tc=jax_tc, port_cfg=port_cfg,
                port_tc=port_tc, params=params, sds=sds, port=port)


def jax_seeded_noise(seeds, s: int, channels: int = 4) -> np.ndarray:
    """(B, s, s, C) f32: the initial N(0, 1) latents the JAX SDXL and SD
    pipelines draw for `generate(seeds=...)`, one `PRNGKey(seed)` each."""
    import jax
    import jax.numpy as jnp
    return np.array(jax.vmap(lambda sd: jax.random.normal(
        jax.random.PRNGKey(sd), (s, s, channels), jnp.float32))(
            jnp.asarray(seeds, jnp.uint32)))


def jax_seeded_lcm_keys(seeds):
    """The per-request LCM step-noise keys of the JAX pipelines'
    `generate(seeds=...)`: `fold_in(PRNGKey(seed), 1)` each."""
    import jax
    import jax.numpy as jnp
    return jax.vmap(lambda sd: jax.random.fold_in(jax.random.PRNGKey(sd), 1))(
        jnp.asarray(seeds, jnp.uint32))


def pixart_pipelines(root: str, seed: int = 0) -> dict:
    """The tiny PixArt weights in both packages: numpy weights drawn in the
    port's state-dict layout (diffusers / transformers names) are written as
    a diffusers snapshot under `root` by the port's own safetensors writer
    (the T5 weights in two shards); the JAX package reads it through its
    porter (`weights/port_pixart.py`), and the port's state dicts from the
    bridge are checked bit for bit against the numpy weights and against
    what the port's own porter reads from the snapshot. The position table
    is not in a diffusers snapshot: both porters make the sincos table the
    port's module is made with.
    Returns the JAX and port configs, the JAX params, the numpy state dicts
    and the port's pipeline."""
    import os
    from diffusion_models_moe_tpu.pipelines.pixart import \
        tiny_pixart_pipeline_config as jax_tiny
    from diffusion_models_moe_tpu.weights.port_pixart import \
        port_pixart_pipeline as jax_port
    from diffusion_models_moe_tpu_torch import (PixArtPipeline,
                                                tiny_pixart_pipeline_config)
    from diffusion_models_moe_tpu_torch.weights.export import save_safetensors
    from diffusion_models_moe_tpu_torch.weights.port_pixart import \
        port_pixart_pipeline
    jax_cfg, port_cfg = jax_tiny(), tiny_pixart_pipeline_config()
    port = PixArtPipeline(port_cfg, device="cpu")
    rng = np.random.RandomState(seed)
    sds = {k: _random_state(m, rng) for k, m in port.modules().items()}
    del sds["transformer"]["pos_embed.pos_embed"]      # drawn, not used
    t5 = sorted(sds["text_encoder"])
    files = {"transformer/diffusion_pytorch_model": sds["transformer"],
             "text_encoder/model-00001-of-00002": {
                 k: sds["text_encoder"][k] for k in t5[:len(t5) // 2]},
             "text_encoder/model-00002-of-00002": {
                 k: sds["text_encoder"][k] for k in t5[len(t5) // 2:]},
             "vae/diffusion_pytorch_model": sds["vae"]}
    for name, sd in files.items():
        save_safetensors({k: torch.from_numpy(v) for k, v in sd.items()},
                         os.path.join(root, name + ".safetensors"))
    params = jax_port(root, jax_cfg)
    back = bridge.pixart_pipeline_state_dicts(params, port_cfg)
    read = port_pixart_pipeline(root, port_cfg)
    # the table the port's module was made with, which both porters make
    sds["transformer"]["pos_embed.pos_embed"] = (
        port.transformer.pos_embed.pos_embed.numpy().copy())
    for key, sd in sds.items():
        for got in (back[key], read[key]):
            assert got.keys() == sd.keys(), key
            for name, v in sd.items():
                np.testing.assert_array_equal(got[name].numpy(), v,
                                              err_msg=name)
    port.load_state_dicts(back)
    return dict(jax_cfg=jax_cfg, port_cfg=port_cfg, params=params, sds=sds,
                port=port)
