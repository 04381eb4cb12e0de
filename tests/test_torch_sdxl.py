"""The torch port's SDXL pieces against the JAX package, on the CPU: the
config, the UNet's added conditioning, both text towers through
`encode_prompts`, a 2-step Euler `generate` with MoE routing and taps on
every FF, the weight bridge, the snapshot reader and the tokenizer pair,
MoEfication on the 22 FFs of the tiny SDXL UNet, and the serving engine's
request independence.

The tiny SDXL geometry is tests/test_sdxl_pipeline.py's, in f32, with the
weights of `torch_parity.sdxl_pipelines` (drawn with numpy, into JAX
through its porters). The JAX pipeline's weights are never drawn by its own
`init_params`. Noise never crosses frameworks: the port is handed the
initial latents JAX draws from each request's seed. One JAX `generate` is
compiled in this file.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu.data import tokenizer as jtok
from diffusion_models_moe_tpu.erasure.masks import \
    bake_wanda_masks as jax_bake_wanda
from diffusion_models_moe_tpu.models.unet import UNet2DCondition as JaxUNet
from diffusion_models_moe_tpu.moefication import moefy as jmoefy
from diffusion_models_moe_tpu.pipelines.sdxl import SDXLPipeline as JaxSDXL
from diffusion_models_moe_tpu.pipelines.sdxl import \
    sdxl_text_configs as jax_text_configs
from diffusion_models_moe_tpu.taps import TapSpec as JaxTapSpec
from diffusion_models_moe_tpu.weights import export as jexport
from diffusion_models_moe_tpu.weights import port as jport
from diffusion_models_moe_tpu_torch import (SDXLPipeline, TapSpec,
                                            build_moe_interventions,
                                            sdxl_config, sdxl_text_configs,
                                            tiny_config)
from diffusion_models_moe_tpu_torch.data import tokenizer as ttok
from diffusion_models_moe_tpu_torch.data.tokenize import \
    per_prompt_hash_tokenize
from diffusion_models_moe_tpu_torch.erasure.masks import (bake_gate_masks,
                                                          bake_wanda_masks)
from diffusion_models_moe_tpu_torch.moefication import moefy
from diffusion_models_moe_tpu_torch.serving import ServingEngine
from diffusion_models_moe_tpu_torch.weights import bridge, port
from diffusion_models_moe_tpu_torch.weights.export import save_safetensors

TOL = 2e-4                 # relative max error, f32
STEPS, GUIDANCE = 2, 7.5
SEEDS = [7, 3]
WAIT = 120                 # seconds a test waits for a served request


@pytest.fixture(scope="module")
def sx():
    d = tp.sdxl_pipelines()
    tc1, tc2 = d["jax_tc"]
    rng = np.random.RandomState(1)
    # CLIP-L ids pad with its EOS (the vocabulary's last id), bigG's with 0
    ids_1 = np.full((2, tc1.max_length), tc1.vocab_size - 1, np.int32)
    ids_2 = np.zeros((2, tc2.max_length), np.int32)
    for row, n in enumerate((3, 6)):
        words = rng.randint(1, tc1.vocab_size - 2, n)
        ids_1[row, :n], ids_2[row, :n] = words, words
        ids_1[row, n] = ids_2[row, n] = tc1.vocab_size - 1
    d.update(ids_1=ids_1, ids_2=ids_2, labels=tp.labels(d["jax_cfg"].unet),
             jpipe=JaxSDXL(d["jax_cfg"], text_configs=d["jax_tc"]))
    return d


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("lcm", [False, True])
def test_sdxl_config_matches_jax(lcm):
    """Every field both packages have is equal, dtype mapped; the text
    towers too."""
    ref, got = jcfg.sdxl_config(jnp.bfloat16, lcm=lcm), sdxl_config(
        torch.bfloat16, lcm=lcm)
    pairs = [(getattr(ref, p), getattr(got, p))
             for p in ("unet", "text_encoder", "vae")] + [(ref, got)]
    pairs += list(zip(jax_text_configs(jnp.bfloat16),
                      sdxl_text_configs(torch.bfloat16)))
    for r, g in pairs:
        r, g = _fields(r), _fields(g)
        for k in set(r) & set(g):
            if k == "dtype":
                assert jnp.dtype(r[k]).name == str(g[k]).split(".")[-1]
            elif k == "conv_winograd":          # False there, "0" here
                assert r[k] is False and g[k] == "0"
            elif k not in ("unet", "text_encoder", "vae"):
                assert r[k] == g[k], k
    assert got.unet.n_ff_layers == 70
    assert sorted(set(got.unet.ff_dims())) == [640, 1280]


def test_unet_added_conditioning_matches_jax(sx):
    """The UNet with SDXL's pooled text and time ids against the JAX
    module on the same inputs; the added conditioning moves the output."""
    cfg = sx["jax_cfg"]
    rng = np.random.RandomState(2)
    s = cfg.sample_size
    x = rng.randn(2, s, s, 4).astype(np.float32)
    ctx = rng.randn(2, 8, 48).astype(np.float32)
    pooled = rng.randn(2, 32).astype(np.float32)
    ids = np.asarray([[128, 128, 0, 0, 128, 128], [96, 64, 8, 4, 96, 64]],
                     np.float32)
    ref = jax.jit(lambda p, *a: JaxUNet(cfg.unet).apply(
        {"params": p}, a[0], 481, a[1], added_text_embeds=a[2],
        added_time_ids=a[3]))(sx["params"]["unet"], x, ctx, pooled, ids)
    unet = sx["port"].unet
    with torch.no_grad():
        got = unet(tp.nchw(x), 481, torch.from_numpy(ctx),
                   added_text_embeds=torch.from_numpy(pooled),
                   added_time_ids=torch.from_numpy(ids))
        bare = unet(tp.nchw(x), 481, torch.from_numpy(ctx))
    assert tp.rel_err(tp.nhwc(got), ref) < TOL
    assert tp.rel_err(tp.nhwc(bare), ref) > 1e-3


def test_encode_prompts_matches_jax(sx):
    """Context (both towers' penultimate states, 48 wide) and pooled (bigG
    at argmax(ids_2), projected), with each tower's own pad id."""
    ref_ctx, ref_pool = sx["jpipe"].encode_prompts(
        sx["params"], jnp.asarray(sx["ids_1"]), jnp.asarray(sx["ids_2"]))
    ctx, pool = sx["port"].encode_prompts(torch.from_numpy(sx["ids_1"]).long(),
                                          torch.from_numpy(sx["ids_2"]).long())
    assert ctx.shape == (2, 8, 48) and pool.shape == (2, 32)
    assert tp.rel_err(ctx.numpy(), ref_ctx) < TOL
    assert tp.rel_err(pool.numpy(), ref_pool) < TOL
    # the pad ids matter: bigG fed CLIP-L's ids gives another context
    ctx_1, _ = sx["port"].encode_prompts(
        torch.from_numpy(sx["ids_1"]).long(),
        torch.from_numpy(sx["ids_1"]).long())
    assert tp.rel_err(ctx_1.numpy(), ref_ctx) > 1e-3


def test_generate_euler_moe_taps_match_jax(sx, monkeypatch):
    """generate(seeds=, decode=False), 2 Euler steps, CFG 7.5, MoE routing
    and the gate taps on all 22 FFs, the bigG ids apart from CLIP-L's: the
    latents and every layer's (T, H) statistics within TOL of JAX's."""
    cfg = sx["jax_cfg"]
    ids_1, ids_2 = sx["ids_1"], sx["ids_2"]
    un_1 = np.full_like(ids_1, sx["jax_tc"][0].vocab_size - 1)
    un_1[:, 0] = 0
    un_2 = np.zeros_like(ids_2)
    ref, ref_taps = sx["jpipe"].generate(
        sx["params"], jnp.asarray(ids_1), jnp.asarray(un_1),
        jax.random.PRNGKey(0), num_steps=STEPS, guidance_scale=GUIDANCE,
        tap=JaxTapSpec(max_gate=True, mean_gate=True),
        ivs=jmoefy.build_moe_interventions(sx["labels"], 0.3), decode=False,
        seeds=np.asarray(SEEDS), cond_ids_2=jnp.asarray(ids_2),
        uncond_ids_2=jnp.asarray(un_2))
    pipe = sx["port"]
    noise = tp.nchw(tp.jax_seeded_noise(SEEDS, cfg.sample_size))
    monkeypatch.setattr(pipe, "seeded_noise", lambda seeds: noise)

    def t(a):
        return torch.from_numpy(a).long()
    got, taps = pipe.generate(
        t(ids_1), t(un_1), num_steps=STEPS, guidance_scale=GUIDANCE,
        tap=TapSpec(max_gate=True, mean_gate=True),
        ivs=build_moe_interventions(sx["labels"], 0.3, device="cpu"),
        decode=False, seeds=SEEDS, cond_ids_2=t(ids_2), uncond_ids_2=t(un_2))
    assert tp.rel_err(tp.nhwc(got), ref) < TOL
    assert tp.rel_err(ref, tp.nhwc(noise)) > 0.1
    assert set(taps) == set(ref_taps) == {"max_gate", "mean_gate"}
    for stat, layers in ref_taps.items():
        assert sorted(taps[stat]) == sorted(layers) == list(range(22)), stat
        for l, r in layers.items():
            assert taps[stat][l].shape == r.shape == (STEPS, 4 * cfg.unet
                                                      .ff_dims()[l])
            assert tp.rel_err(taps[stat][l].numpy(), r) < TOL, (stat, l)


def test_bridge_add_embedding_equals_jax_export(sx):
    """The bridge's UNet state dict equals JAX `export_unet`'s, key for key
    and bit for bit, `add_embedding.linear_1/2` and the 22 FFs included."""
    cfg = sx["jax_cfg"]
    ref = jexport.export_unet(sx["params"]["unet"], cfg.unet)
    got = bridge.unet_numpy_state_dict(sx["params"]["unet"], cfg.unet)
    assert got.keys() == ref.keys()
    assert {f"add_embedding.linear_{i}.{p}" for i in (1, 2)
            for p in ("weight", "bias")} <= got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _write_vocab(path: str, pad: str = None) -> None:
    """A byte-level CLIP vocabulary with a few merges; `pad` names the
    snapshot's pad token."""
    b2u = jtok._bytes_to_unicode()
    symbols = list(b2u.values())
    vocab = {s: i for i, s in enumerate(symbols + [s + "</w>" for s in symbols])}
    merges = [("a", "t</w>"), ("c", "at</w>"), ("d", "o"), ("do", "g</w>")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    if pad:
        with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
            json.dump({"pad_token": pad}, f)


def test_sdxl_snapshot_and_tokenizers_equal_the_jax_porter(sx, tmp_path):
    """An SDXL snapshot the test writes: `load_sdxl_snapshot` gives bit for
    bit what JAX `port_sdxl_pipeline` gives through the bridge, and loads
    strictly; the tokenizer pair gives JAX's ids, bigG's padded with '!'
    (id 0). `load_pipeline_snapshot` refuses the SDXL snapshot for an SD
    config, and `load_sdxl_snapshot` an SD snapshot for the SDXL config."""
    root = str(tmp_path / "sdxl")
    jax_cfg, sds, params = sx["jax_cfg"], sx["sds"], sx["params"]
    te2 = dict(sds["text_encoder_2"])
    te2["text_projection.weight"] = sds["text_projection_2"]["weight"]
    files = {"unet": jexport.export_unet(params["unet"], jax_cfg.unet),
             "text_encoder": sds["text_encoder"], "text_encoder_2": te2,
             "vae": jexport.export_vae_decoder(params["vae"], jax_cfg.vae)}
    for sub, sd in files.items():
        name = "model" if sub.startswith("text") else "diffusion_pytorch_model"
        save_safetensors({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()},
                         os.path.join(root, sub, f"{name}.safetensors"))
    ref = bridge.pipeline_state_dicts(
        jport.port_sdxl_pipeline(root, jax_cfg, sx["jax_tc"]),
        sx["port_cfg"], sx["port_tc"])
    got = port.load_sdxl_snapshot(root, sx["port_cfg"])
    assert got.keys() == ref.keys() == sds.keys()
    for part in ref:
        assert got[part].keys() == ref[part].keys(), part
        for k, t in ref[part].items():
            assert torch.equal(got[part][k], t), (part, k)
    SDXLPipeline(sx["port_cfg"], sx["port_tc"], device="cpu"
                 ).load_state_dicts(got)
    with pytest.raises(ValueError, match="add_embedding_in"):
        port.load_pipeline_snapshot(root, tiny_config())
    sd_root = str(tmp_path / "sd")
    for sub in ("unet", "vae"):
        os.makedirs(os.path.join(sd_root, sub))
    os.symlink(os.path.join(root, "text_encoder_2"),
               os.path.join(sd_root, "text_encoder_2"))
    os.symlink(os.path.join(root, "text_encoder"),
               os.path.join(sd_root, "text_encoder"))
    os.symlink(os.path.join(root, "vae", "diffusion_pytorch_model.safetensors"),
               os.path.join(sd_root, "vae", "diffusion_pytorch_model.safetensors"))
    sd_unet = dict(files["unet"])
    for k in [k for k in sd_unet if k.startswith("add_embedding.")]:
        del sd_unet[k]
    save_safetensors({k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in sd_unet.items()},
                     os.path.join(sd_root, "unet",
                                  "diffusion_pytorch_model.safetensors"))
    with pytest.raises(ValueError, match="add_embedding_in"):
        port.load_sdxl_snapshot(sd_root, sx["port_cfg"])

    _write_vocab(os.path.join(root, "tokenizer"))
    _write_vocab(os.path.join(root, "tokenizer_2"), pad="!")
    got_l, got_g = ttok.load_sdxl_tokenizers(root, 8)
    ref_l, ref_g = jtok.load_sdxl_tokenizers(root, 8)
    texts = ["a cat", "dog at cat", "a"]
    for g, r in ((got_l, ref_l), (got_g, ref_g)):
        np.testing.assert_array_equal(g(texts).numpy(), r(texts))
    eos = got_l.eos
    assert got_l(["a"])[0, 3:].tolist() == [eos] * 5
    assert got_g(["a"])[0, 3:].tolist() == [got_g.encoder["!"]] * 5 == [0] * 5


def test_sdxl_moefication_route_and_bake(sx):
    """MoEfication on the 22 FFs of the tiny SDXL UNet, as
    tests/test_sdxl_pipeline.py's route-and-bake case: the FF paths reach
    the inner depth, the gates and the greedy labels equal JAX's, the
    routed generate is finite, and both bakes equal JAX's or zero the right
    rows."""
    cfg = sx["port_cfg"].unet
    state = sx["port"].unet.state_dict()
    paths = moefy.ff_param_paths(cfg)
    assert len(paths) == cfg.n_ff_layers == 22
    assert paths[1] == "down_blocks.1.attentions.0.transformer_blocks.1.ff"
    jparams, jcfg_unet = sx["params"]["unet"], sx["jax_cfg"].unet
    for got, ref in zip(moefy.gate_weights(state, cfg),
                        jmoefy.gate_weights(jparams, jcfg_unet)):
        np.testing.assert_array_equal(got, ref)
    labels = moefy.moefy_unet(state, cfg, expert_size=8, method="greedy",
                              device="cpu")
    ref = jmoefy.moefy_unet(jparams, jcfg_unet, expert_size=8,
                            method="greedy")
    assert labels.keys() == ref.keys() and len(labels) == 22
    for k in ref:
        np.testing.assert_array_equal(labels[k], ref[k], err_msg=k)
    ivs = build_moe_interventions(labels, 0.5, device="cpu")
    assert len(ivs) == 22 and all(iv is not None for iv in ivs)
    ids = torch.from_numpy(sx["ids_1"][:1]).long()
    lat, _ = sx["port"].generate(ids, torch.zeros_like(ids),
                                 torch.Generator().manual_seed(2),
                                 num_steps=STEPS, ivs=ivs, decode=False)
    assert torch.isfinite(lat).all()
    l, d = 21, cfg.ff_dims()[21]
    mask = np.zeros((d, 4 * d), bool)
    mask[:, :4] = True
    baked = bake_wanda_masks(state, cfg, {l: mask})
    ref_b = jexport.export_unet(jax_bake_wanda(jparams, jcfg_unet, {l: mask}),
                                jcfg_unet)
    key = f"{paths[l]}.net.2.weight"
    np.testing.assert_array_equal(baked[key].numpy(), ref_b[key])
    assert (baked[key][:, :4] == 0).all() and not (baked[key][:, 4:] == 0).all()
    gate = np.zeros(4 * d, bool)
    gate[::5] = True
    w = bake_gate_masks(state, cfg, {l: gate})[f"{paths[l]}.net.0.proj.weight"]
    assert (w[4 * d:][gate] == 0).all() and (w[4 * d:][~gate] != 0).all()
    assert torch.equal(w[:4 * d], state[f"{paths[l]}.net.0.proj.weight"][:4 * d])


def test_sdxl_engine_request_is_independent_of_its_batch(sx):
    """A `ServingEngine` over the SDXL pipeline: a request served alone (its
    batch padded with itself) and co-batched give bit-equal latents."""
    pipe = sx["port"]
    tok = per_prompt_hash_tokenize(100, 8)
    ivs = build_moe_interventions(sx["labels"], 0.3, device="cpu")

    def engine(**kw):
        return ServingEngine(pipe, tok, batch_size=2, num_steps=STEPS,
                             ivs=ivs, decode=False, **kw)
    with engine(max_wait_ms=300.0) as eng:
        solo = eng.submit("the probe prompt", seed=42).result(timeout=WAIT)
    with engine(max_wait_ms=2000.0) as eng2:
        futs = [eng2.submit("the probe prompt", seed=42),
                eng2.submit("another prompt", seed=1)]
        crowded, other = (f.result(timeout=WAIT) for f in futs)
    assert eng2.stats.batches == 1 and eng2.stats.padded_slots == 0
    assert solo.shape == (4, 16, 16)
    np.testing.assert_array_equal(solo, crowded)
    assert np.abs(other - crowded).max() > 1e-3


def test_sdxl_pipeline_defaults_to_the_card():
    """`SDXLPipeline` runs on the card unless asked for the CPU: with no
    CUDA device the default raises."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    cfg, tcs = tp.tiny_sdxl(__import__(
        "diffusion_models_moe_tpu_torch.config", fromlist=["x"]))
    with pytest.raises(RuntimeError, match="no CUDA device is present"):
        SDXLPipeline(cfg, tcs)
    assert SDXLPipeline(cfg, tcs, device="cpu").unet.conv_in.weight.device \
        .type == "cpu"
