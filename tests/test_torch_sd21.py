"""The torch port's SD2.1 pieces against the JAX package, on the CPU:
`sd21_config`, v-prediction under DDIM and DPM-Solver++ 2M, a tiny
SD2-shaped model (per-block heads (1, 2, 4, 4), an exact-GELU text tower)
through `encode_text` and `denoise`, and the weight bridge of LCM's guidance
embedding.

`denoise` cases as in tests/test_torch_sched_pipeline.py: f32, the weights
of tests/torch_parity.py, MoE routing on all 16 FFs, CFG 7.5, 3 steps,
JAX-made initial latents, within 1e-3 of JAX's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu.pipelines.stable_diffusion import \
    StableDiffusionPipeline as JaxPipeline
from diffusion_models_moe_tpu.weights.export import export_unet
from diffusion_models_moe_tpu.weights.port import port_unet_state_dict
from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                            sd21_config)
from diffusion_models_moe_tpu_torch.weights import bridge
from torch_parity import rel_err, tiny_pair

REL_TOL = 1e-3
STEPS, GUIDANCE = 3, 7.5
# the SD2 geometry at tiny width: a head count a block, exact GELU in CLIP
SD2_UNET = {"attention_head_dim": (1, 2, 4, 4)}
SD2_TEXT = {"hidden_act": "gelu"}
# fields of the JAX package's configs with no counterpart in the port (TPU
# layouts, training, other model families, safety filtering)
JAX_ONLY = {"use_fused_routing", "flash_attention", "remat", "fast_norm",
            "addition_embed_dim", "addition_time_embed_dim", "safety_check",
            "blur_nsfw"}
# the port's serving-mode fields (strings where the JAX package has
# environment variables or booleans)
PORT_ONLY = {"attn_absorb", "conv_chain", "winograd_tile"}


@pytest.fixture(scope="module")
def data():
    return dict(torch_parity.denoise_data(), plain=torch_parity.weights())


@pytest.fixture(scope="module")
def sd2():
    """JAX params and the port's pipeline of the tiny SD2-shaped model, and
    the (uncond, cond) context both text towers make of numpy-made ids."""
    jax_cfg, port_cfg = tiny_pair(unet=SD2_UNET, text_encoder=SD2_TEXT)
    params, port = torch_parity.pipelines(jax_cfg, port_cfg=port_cfg)
    t = jax_cfg.text_encoder
    rng = np.random.RandomState(2)
    ids = np.concatenate([np.zeros((2, t.max_length), np.int32),
                          rng.randint(0, t.vocab_size, (2, t.max_length)
                                      ).astype(np.int32)])
    jpipe = JaxPipeline(jax_cfg)
    ref = np.concatenate([np.asarray(jpipe.encode_text(
        params, jnp.asarray(half))[0]) for half in (ids[:2], ids[2:])])
    return dict(params=params, port=port, ids=ids, context=ref)


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("v_prediction", [True, False])
def test_sd21_config_matches_jax(v_prediction):
    """Every field both packages have is equal, dtype mapped (bf16); the
    port lacks only the JAX package's TPU, training and other-family
    fields."""
    ref = jcfg.sd21_config(jnp.bfloat16, v_prediction=v_prediction)
    got = sd21_config(torch.bfloat16, v_prediction=v_prediction)
    for part in ("unet", "text_encoder", "vae", None):
        r = _fields(getattr(ref, part) if part else ref)
        g = _fields(getattr(got, part) if part else got)
        assert set(r) - set(g) <= JAX_ONLY, part
        assert set(g) - set(r) <= PORT_ONLY, part
        for name in set(r) & set(g):
            if name in ("unet", "text_encoder", "vae"):
                continue
            if name == "dtype":
                assert r[name] == jnp.bfloat16 and g[name] == torch.bfloat16
            elif name == "conv_winograd":       # False there, "0" here
                assert r[name] is False and g[name] == "0"
            else:
                assert r[name] == g[name], (part, name)
    assert got.scheduler == "ddim" and got.text_encoder.hidden_act == "gelu"
    assert got.sample_size == (96 if v_prediction else 64)
    heads = [got.unet.block_out_channels[i] // got.unet.heads_for_block(i)
             for i in range(4)]
    assert heads == [64] * 4 and got.unet.ff_dims().count(320) == 5
    modes = sd21_config(attn_absorb="1", conv_chain=True, conv_winograd="fused",
                        deep_cache_interval=3)
    assert modes.unet.attn_absorb == "1" and modes.unet.conv_chain
    assert modes.vae.conv_winograd == "fused" and modes.deep_cache_interval == 3


@pytest.mark.parametrize("scheduler", ["ddim", "dpm"])
def test_v_prediction_denoise_matches_jax(data, scheduler):
    """v -> eps on the carried latent under DDIM and DPM-Solver++ 2M."""
    jax_cfg, port_cfg = tiny_pair(scheduler=scheduler,
                                  prediction_type="v_prediction")
    params, port = data["plain"]
    got, ref = torch_parity.denoise_both(params, port, jax_cfg, port_cfg,
                                         data, STEPS, GUIDANCE)
    assert rel_err(got, ref) < REL_TOL
    # v-prediction moves the run: the same config with eps differs
    eps_cfg = tiny_pair(scheduler=scheduler)[1]
    pipe = StableDiffusionPipeline(eps_cfg, device="cpu")
    pipe.load_state_dicts({k: m.state_dict() for k, m in port.modules().items()})
    lat = torch_parity.nchw(data["latents"])
    eps_run, _ = pipe.denoise(torch.from_numpy(data["context"]), lat, STEPS,
                              GUIDANCE)
    assert rel_err(torch_parity.nhwc(eps_run), ref) > 0.01


def test_sd2_text_tower_matches_jax(sd2):
    """`encode_text` of the exact-GELU text tower (the SD2.1 tower's
    activation at tiny width) equals JAX's within 1e-3."""
    port = sd2["port"]
    assert port.config.text_encoder.hidden_act == "gelu"
    ids = torch.from_numpy(sd2["ids"]).long()
    got = torch.cat([port.encode_text(ids[:2])[0], port.encode_text(ids[2:])[0]])
    assert rel_err(got.numpy(), sd2["context"]) < REL_TOL


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
def test_sd2_shaped_denoise_matches_jax(sd2, data, prediction):
    """The SD2-shaped model under DDIM (SD2.1's scheduler), epsilon and v,
    on the context its own text tower made."""
    jax_cfg, port_cfg = tiny_pair(unet=SD2_UNET, text_encoder=SD2_TEXT,
                                  scheduler="ddim", prediction_type=prediction)
    assert [port_cfg.unet.heads_for_block(i) for i in range(4)] == [1, 2, 4, 4]
    got, ref = torch_parity.denoise_both(sd2["params"], sd2["port"], jax_cfg,
                                         port_cfg, data, STEPS, GUIDANCE,
                                         context=sd2["context"])
    assert rel_err(got, ref) < REL_TOL


def test_bridge_round_trip_with_cond_proj():
    """The guidance embedding's weight goes port -> JAX through the JAX
    package's porter and back through the bridge unchanged (the round trip
    `torch_parity.pipelines` checks for every key), the bridge equals the
    JAX package's export key for key and bit for bit, and the port's
    pipeline loads it strictly as `time_embedding.cond_proj.weight`."""
    jax_cfg, port_cfg = tiny_pair(unet={"time_cond_proj_dim": 32},
                                  scheduler="lcm")
    params, port = torch_parity.pipelines(jax_cfg, port_cfg=port_cfg)
    assert "time_cond_proj" in params["unet"]
    ours = bridge.unet_numpy_state_dict(params["unet"], port_cfg.unet)
    theirs = export_unet(params["unet"], jax_cfg.unet)
    assert ours.keys() == theirs.keys()
    for key, val in theirs.items():
        np.testing.assert_array_equal(ours[key], val, err_msg=key)
    w = ours["time_embedding.cond_proj.weight"]
    assert w.shape == (32, 32)
    np.testing.assert_array_equal(w, params["unet"]["time_cond_proj"]["kernel"].T)
    back = port_unet_state_dict(ours, jax_cfg.unet)
    np.testing.assert_array_equal(back["time_cond_proj"]["kernel"],
                                  params["unet"]["time_cond_proj"]["kernel"])
    torch.testing.assert_close(port.unet.time_embedding.cond_proj.weight,
                               torch.from_numpy(w), rtol=0, atol=0)
    assert port.unet.time_embedding.cond_proj.bias is None
    # and a UNet without the embedding has no such key
    plain = bridge.unet_numpy_state_dict(
        {k: v for k, v in params["unet"].items() if k != "time_cond_proj"},
        port_cfg.unet)
    assert not any("cond_proj" in k for k in plain)
