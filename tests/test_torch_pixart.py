"""The torch port's PixArt-alpha against the JAX package's, on the CPU: the
config, the position table, the weight bridge and the snapshot porter, one
DiT call, a 2-step DPM-Solver++ `generate` with CFG 4.5, and the same with
the mean-gate tap, a neuron removal (the GELU fill 0.0) and MoE routing on
every FF; the request independence of `seeds=`.

Tiny geometry (`tiny_pixart_pipeline_config`, f32) with the weights of
`torch_parity.pixart_pipelines`: drawn with numpy in diffusers' names,
written as a snapshot by the port's safetensors writer, read into JAX by
its porter and into the port by the bridge and by the port's own porter.
Noise never crosses frameworks: the port is handed the initial latents that
JAX draws. Two JAX programs are compiled in this file (the plain and the
tapped generate); the DiT call runs op by op.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from diffusion_models_moe_tpu.models.pixart import \
    PixArtTransformer2D as JaxDiT
from diffusion_models_moe_tpu.pipelines.pixart import \
    PixArtPipeline as JaxPixArt
from diffusion_models_moe_tpu.pipelines.pixart import \
    pixart_512_config as jax_512
from diffusion_models_moe_tpu.taps import LayerIntervention as JaxIV
from diffusion_models_moe_tpu.taps import TapSpec as JaxTapSpec
from diffusion_models_moe_tpu.weights.port_pixart import \
    sincos_pos_embed as jax_sincos
from diffusion_models_moe_tpu_torch import (LayerIntervention, PixArtPipeline,
                                            TapSpec, layer_name,
                                            pixart_512_config,
                                            tiny_pixart_pipeline_config)
from diffusion_models_moe_tpu_torch.weights.port_pixart import sincos_pos_embed

TOL = 2e-4                 # relative max error, f32
STEPS, GUIDANCE = 2, 4.5
K = 2                      # experts routed of the 6 a tiny FF has


@pytest.fixture(scope="module")
def px(tmp_path_factory):
    d = tp.pixart_pipelines(str(tmp_path_factory.mktemp("pixart")))
    cfg = d["jax_cfg"]
    tc, s = cfg.text_encoder, cfg.sample_size
    rng = np.random.RandomState(3)
    ids = rng.randint(1, tc.vocab_size, (2, tc.max_length)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 9:] = 0
    un_ids, un_mask = np.zeros_like(ids), np.zeros_like(ids)
    un_mask[:, 0] = 1
    key = jax.random.PRNGKey(2)
    noise = np.array(jax.random.normal(key, (2, s, s, 4), jnp.float32))
    jpipe = JaxPixArt(cfg)
    ref, _ = jpipe.generate(d["params"], jnp.asarray(ids), jnp.asarray(un_ids),
                            key, cond_mask=jnp.asarray(mask),
                            uncond_mask=jnp.asarray(un_mask), num_steps=STEPS,
                            guidance_scale=GUIDANCE, decode=False)
    d.update(ids=ids, mask=mask, un_ids=un_ids, un_mask=un_mask, key=key,
             noise=noise, jpipe=jpipe, ref=np.asarray(ref))
    return d


def _port_generate(px, monkeypatch, **kw):
    """The port's generate(decode=False) from JAX's initial latents."""
    pipe = px["port"]
    monkeypatch.setattr(pipe, "initial_noise",
                        lambda b, g: tp.nchw(px["noise"][:b]))
    t = lambda a: torch.from_numpy(a).long()  # noqa: E731
    lat, taps = pipe.generate(t(px["ids"]), t(px["un_ids"]),
                              torch.Generator().manual_seed(0),
                              cond_mask=t(px["mask"]),
                              uncond_mask=t(px["un_mask"]), num_steps=STEPS,
                              guidance_scale=GUIDANCE, decode=False, **kw)
    assert torch.isfinite(lat).all()
    return tp.nhwc(lat), taps


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_pixart_512_config_matches_jax():
    """Every field of the pipeline, DiT, T5 and VAE configs equal, dtype
    mapped; the DiT's heads are 72 wide and T5's caption 120 tokens."""
    ref, got = jax_512(jnp.bfloat16), pixart_512_config(torch.bfloat16)
    for r, g in ((ref, got), (ref.transformer, got.transformer),
                 (ref.text_encoder, got.text_encoder), (ref.vae, got.vae)):
        r, g = _fields(r), _fields(g)
        assert set(r) >= set(g) - {"conv_winograd", "winograd_tile",
                                   "quant_int8"}
        for k in set(r) & set(g):
            if k == "dtype":
                assert jnp.dtype(r[k]).name == str(g[k]).split(".")[-1]
            elif k == "conv_winograd":          # False there, "0" here
                assert r[k] is False and g[k] == "0"
            elif k not in ("transformer", "text_encoder", "vae"):
                assert r[k] == g[k], k
    dit = got.transformer
    assert dit.hidden_size // dit.num_heads == 72
    assert got.text_encoder.max_length == 120


@pytest.mark.parametrize("grid,base", [(4, 4), (32, 32), (8, 16)])
def test_sincos_pos_embed_equals_jax(grid, base):
    np.testing.assert_array_equal(sincos_pos_embed(72, grid, grid, base),
                                  jax_sincos(72, grid, grid, base))


def test_bridge_and_porter_give_the_drawn_weights(px):
    """The port's pipeline holds exactly the numpy weights (with the sincos
    table) after the bridge; `pixart_pipelines` held the bridge and the
    port's snapshot porter to them key by key."""
    for key, module in px["port"].modules().items():
        sd = module.state_dict()
        assert sd.keys() == px["sds"][key].keys(), key
        for name, v in px["sds"][key].items():
            np.testing.assert_array_equal(sd[name].numpy(), v, err_msg=name)


def test_dit_call_matches_jax(px):
    """One DiT call at two timesteps on random latents and T5 features."""
    cfg = px["jax_cfg"]
    rng = np.random.RandomState(4)
    s = cfg.sample_size
    x = rng.randn(2, s, s, 4).astype(np.float32)
    ctx = rng.randn(2, cfg.text_encoder.max_length,
                    cfg.transformer.text_in_dim).astype(np.float32)
    t = np.asarray([10, 500], np.int32)
    ref = JaxDiT(cfg.transformer).apply(
        {"params": px["params"]["transformer"]}, jnp.asarray(x),
        jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got = px["port"].transformer(tp.nchw(x), torch.from_numpy(t),
                                     torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    assert tp.rel_err(tp.nhwc(got), ref) < TOL


def test_generate_matches_jax(px, monkeypatch):
    """T5 with both masks, 2 DPM-Solver++ steps, CFG 4.5: the final latents
    within TOL of JAX's, moved from the initial noise."""
    got, taps = _port_generate(px, monkeypatch)
    assert taps is None
    assert tp.rel_err(got, px["ref"]) < TOL
    assert tp.rel_err(px["ref"], px["noise"]) > 0.1


def test_tapped_removed_routed_generate_matches_jax(px, monkeypatch):
    """The same generate with the mean-gate tap, a per-step neuron removal
    (fill 0.0, the GELU path) and top-2 routing over 6 experts on every FF:
    each layer's (T, H) mean gate and the latents within TOL of JAX's; the
    interventions move the latents."""
    cfg = px["jax_cfg"].transformer
    h = cfg.hidden_size * cfg.ff_mult
    labels = tp.labels(cfg)
    rng = np.random.RandomState(5)
    removed = rng.rand(cfg.num_layers, STEPS, h) < 0.2
    jax_ivs, port_ivs = [], []
    for i in range(cfg.num_layers):
        lab = labels[layer_name(i)]
        pat = (lab[None, :] == np.arange(lab.max() + 1)[:, None]
               ).astype(np.float32)
        jax_ivs.append(JaxIV(patterns=jnp.asarray(pat), k=K,
                             neuron_mask=jnp.asarray(removed[i]),
                             neuron_fill=0.0))
        port_ivs.append(LayerIntervention(
            patterns=torch.from_numpy(pat), k=K,
            neuron_mask=torch.from_numpy(removed[i]), neuron_fill=0.0))
    ref, ref_taps = px["jpipe"].generate(
        px["params"], jnp.asarray(px["ids"]), jnp.asarray(px["un_ids"]),
        px["key"], cond_mask=jnp.asarray(px["mask"]),
        uncond_mask=jnp.asarray(px["un_mask"]), num_steps=STEPS,
        guidance_scale=GUIDANCE, tap=JaxTapSpec(mean_gate=True),
        ivs=tuple(jax_ivs), decode=False)
    got, taps = _port_generate(px, monkeypatch, tap=TapSpec(mean_gate=True),
                               ivs=port_ivs)
    assert sorted(taps) == ["mean_gate"]
    assert sorted(taps["mean_gate"]) == list(range(cfg.num_layers))
    for i in range(cfg.num_layers):
        mg = taps["mean_gate"][i].numpy()
        assert mg.shape == (STEPS, h)
        assert tp.rel_err(mg, ref_taps["mean_gate"][i]) < TOL, i
    assert tp.rel_err(got, ref) < TOL
    assert tp.rel_err(np.asarray(ref), px["ref"]) > 1e-2


def test_seeds_make_each_request_independent(px):
    """Request 0's latents depend only on its own seed (bit for bit);
    request 1's move with its seed."""
    pipe = px["port"]
    t = lambda a: torch.from_numpy(a).long()  # noqa: E731
    runs = [pipe.generate(t(px["ids"]), t(px["un_ids"]), num_steps=STEPS,
                          decode=False, seeds=seeds)[0]
            for seeds in ([7, 3], [7, 1000])]
    assert torch.equal(runs[0][0], runs[1][0])
    assert (runs[0][1] - runs[1][1]).abs().max() > 1e-4
    with pytest.raises(ValueError):
        pipe.generate(t(px["ids"]), t(px["un_ids"]),
                      torch.Generator().manual_seed(0), seeds=[7, 3])


def test_pipeline_without_a_card_raises():
    """Like every entry point of the port it runs on the card unless asked
    for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        PixArtPipeline(tiny_pixart_pipeline_config())
