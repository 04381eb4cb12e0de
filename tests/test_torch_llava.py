"""The port's LLaMA and LLaVA judge against the JAX package's, on the CPU:
`LlamaModel` logits (GQA, q/k/v biases, Qwen2-VL's 3-D RoPE), the KV-cached
greedy decode (right-padded co-batching, EOS then pad, multimodal position
offsets), the int8 projections, LLaVA's `image_features`, `splice_image`,
`generate`, `preprocess_image` and `build_vqa`'s `vqa` / `.batch` /
`.chat`, and `port_llava` on a sharded llava-hf snapshot in both
transformers key layouts.

Weights are seeded numpy in transformers' layout (`LlamaForCausalLM`,
`LlavaForConditionalGeneration`) at `tiny_llama_config` /
`tiny_llava_config`: JAX's porter reads them, the bridge gives JAX's tree
back as the port's state dict bit for bit. JAX runs its modules op by op
and its decode as its own `lax.scan`. Tolerances: logits and features
max |port - JAX| / max |JAX| <= 1e-4; tokens and answers equal; int8
logits within the quant tests' relative L2 of 1e-2.
"""
import dataclasses
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from diffusion_models_moe_tpu.models import llama as jllama
from diffusion_models_moe_tpu.models import llava as jllava
from diffusion_models_moe_tpu.weights import port_llava as jport
from diffusion_models_moe_tpu_torch.benchmarks import vqa as pvqa
from diffusion_models_moe_tpu_torch.models import llama, llava
from diffusion_models_moe_tpu_torch.weights import bridge, port_llava
from diffusion_models_moe_tpu_torch.weights.export import save_safetensors

TOL = 1e-4
INT8_L2 = 1e-2      # tests/test_torch_quant.py MODEL_L2
VOCAB = 128
VARIANTS = {
    "gqa": {},
    "bias": {"attention_bias": True},
    "mrope": {"attention_bias": True, "mrope_section": (2, 1, 1)},
}


def _cfgs(**fields):
    return (dataclasses.replace(jllama.tiny_llama_config(VOCAB), **fields),
            dataclasses.replace(llama.tiny_llama_config(VOCAB), **fields))


def _llama_state(cfg, seed: int = 0) -> dict:
    """Seeded `LlamaForCausalLM` numpy state dict for the port's `cfg`
    (norm scales 1 + N(0, 0.01), embeddings N(0, 1))."""
    sd = tp._random_state(llama.LlamaModel(cfg, device="cpu"),
                          np.random.RandomState(seed))
    sd["model.embed_tokens.weight"] = np.random.RandomState(seed + 1).randn(
        cfg.vocab_size, cfg.hidden_size).astype(np.float32)
    return sd


def _port_llama(cfg, sd: dict) -> llama.LlamaModel:
    model = llama.LlamaModel(cfg, device="cpu")
    model.load_state_dict(port_llava.port_llama_state(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg))
    return model


@pytest.fixture(scope="module")
def llamas():
    """{variant: (JAX cfg, JAX params, the port's model)}, same weights."""
    out = {}
    for name, fields in VARIANTS.items():
        jcfg_, cfg = _cfgs(**fields)
        sd = _llama_state(cfg)
        params = jport.port_llama(sd, jcfg_)
        back = bridge.llama_numpy_state_dict(params, cfg)
        assert back.keys() == sd.keys()
        for k, v in sd.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
        out[name] = (jcfg_, params, _port_llama(cfg, sd))
    return out


def _jax_logits(jcfg_, params, ids, positions=None):
    lp = {k: v for k, v in params.items() if k != "embed_tokens"}
    b, s = ids.shape
    pos = (jnp.broadcast_to(jnp.arange(s), (b, s)) if positions is None
           else jnp.asarray(positions))
    logits, _ = jllama.LlamaModel(jcfg_).apply(
        {"params": lp}, jllama.embed_tokens(params, jnp.asarray(ids)), pos,
        jnp.ones((b, s), bool))
    return np.asarray(logits)


def _mrope_positions(b: int, s: int) -> np.ndarray:
    """(3, B, S) positions as Qwen2-VL gives an image span: t, h, w differ."""
    base = np.arange(s)
    return np.stack([base, base // 2, base % 3 + base // 3]
                    )[:, None].repeat(b, 1).astype(np.int64)


@pytest.mark.parametrize("variant", VARIANTS)
def test_llama_logits_match_jax(llamas, variant):
    jcfg_, params, model = llamas[variant]
    ids = np.random.default_rng(1).integers(0, VOCAB, size=(2, 9))
    positions = _mrope_positions(2, 9) if variant == "mrope" else None
    ref = _jax_logits(jcfg_, params, ids, positions)
    b, s = ids.shape
    pos = (torch.arange(s).expand(b, s) if positions is None
           else torch.from_numpy(positions))
    got, caches = model(llama.embed_tokens(model, torch.from_numpy(ids)), pos,
                        torch.ones((b, s), dtype=torch.bool))
    assert got.dtype == torch.float32 and got.shape == (2, 9, VOCAB)
    assert len(caches) == jcfg_.num_layers
    assert caches[0][0].shape == (2, jcfg_.num_kv_heads, 9, jcfg_.head_dim)
    assert tp.rel_err(got.numpy(), ref) <= TOL


def _decode(model, ids, lengths, steps, eos, prefill_positions=None,
            pos_offset=None) -> np.ndarray:
    return llama.greedy_decode(
        model, llama.embed_tokens(model, torch.from_numpy(ids)),
        torch.as_tensor(lengths), steps, eos,
        prefill_positions=(None if prefill_positions is None
                           else torch.from_numpy(prefill_positions)),
        pos_offset=(None if pos_offset is None
                    else torch.as_tensor(pos_offset))).numpy()


def _jax_decode(jcfg_, params, ids, lengths, steps, eos,
                prefill_positions=None, pos_offset=None) -> np.ndarray:
    return np.asarray(jllama.greedy_decode(
        jllama.LlamaModel(jcfg_), params,
        jllama.embed_tokens(params, jnp.asarray(ids)), jnp.asarray(lengths),
        max_new_tokens=steps, eos_id=eos,
        prefill_positions=(None if prefill_positions is None
                           else jnp.asarray(prefill_positions)),
        pos_offset=None if pos_offset is None else jnp.asarray(pos_offset)))


@pytest.mark.parametrize("variant", ("gqa", "mrope"))
def test_greedy_decode_matches_jax(llamas, variant):
    """Right-padded prompts of lengths 5 and 8 decode the same tokens as
    JAX's scan, each as it does alone (co-batching is sample-exact); under
    3-D RoPE with JAX's position offsets."""
    jcfg_, params, model = llamas[variant]
    rng = np.random.default_rng(3)
    ids = rng.integers(3, VOCAB, size=(2, 8))
    ids[0, 5:] = 0
    lengths = np.asarray([5, 8])
    kw = {}
    if variant == "mrope":
        kw = dict(prefill_positions=_mrope_positions(2, 8),
                  pos_offset=np.asarray([2, -1]))
    got = _decode(model, ids, lengths, 6, -1, **kw)
    np.testing.assert_array_equal(
        got, _jax_decode(jcfg_, params, ids, lengths, 6, -1, **kw))
    for r in range(2):
        solo_kw = {k: (v[:, r:r + 1, :lengths[r]] if k == "prefill_positions"
                       else v[r:r + 1]) for k, v in kw.items()}
        solo = _decode(model, ids[r:r + 1, :lengths[r]], lengths[r:r + 1],
                       6, -1, **solo_kw)
        np.testing.assert_array_equal(solo[0], got[r])


def test_eos_is_emitted_then_pad(llamas):
    """Forcing the second greedy token as EOS: it is emitted, then pad_id;
    the same as JAX."""
    jcfg_, params, model = llamas["gqa"]
    ids = np.random.default_rng(4).integers(3, VOCAB, size=(1, 6))
    free = _decode(model, ids, [6], 5, -1)
    eos = int(free[0, 1])
    got = _decode(model, ids, [6], 5, eos)
    np.testing.assert_array_equal(got, _jax_decode(jcfg_, params, ids, [6],
                                                   5, eos))
    assert got[0, 1] == eos and (got[0, 2:] == 0).all()
    assert got[0, 0] == free[0, 0]


def test_int8_decode_within_quant_tolerance(llamas):
    """quant_int8: every projection through the W8A8 dot, lm_head in f32.
    Logits within the quant tests' relative L2 of JAX's int8 model, greedy
    tokens equal JAX's and deterministic."""
    jcfg_, params, model = llamas["gqa"]
    jq = dataclasses.replace(jcfg_, quant_int8=True)
    cfg = dataclasses.replace(model.cfg, quant_int8=True)
    qmodel = llama.LlamaModel(cfg, device="cpu")
    qmodel.load_state_dict(model.state_dict())
    assert isinstance(qmodel.model.layers[0].self_attn.q_proj,
                      llama.make_dense(4, 4, quant=True).__class__)
    assert not isinstance(qmodel.lm_head,
                          llama.make_dense(4, 4, quant=True).__class__)
    ids = np.random.default_rng(5).integers(3, VOCAB, size=(1, 7))
    ref = _jax_logits(jq, params, ids)
    got, _ = qmodel(llama.embed_tokens(qmodel, torch.from_numpy(ids)),
                    torch.arange(7)[None], torch.ones((1, 7), dtype=torch.bool))
    assert tp.rel_l2(got.numpy(), ref) < INT8_L2
    a = _decode(qmodel, ids, [7], 5, -1)
    np.testing.assert_array_equal(a, _decode(qmodel, ids, [7], 5, -1))
    np.testing.assert_array_equal(a, _jax_decode(jq, params, ids, [7], 5, -1))


def test_llama_entry_point_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        llama.LlamaModel(llama.tiny_llama_config())
    with pytest.raises(RuntimeError):
        llava.LlavaForConditionalGeneration(llava.tiny_llava_config())
    with pytest.raises(RuntimeError):
        pvqa.load_llava_native("/nonexistent", size="7b")


# --------------------------------------------------------------------- LLaVA
def _llava_state(cfg, seed: int = 5) -> dict:
    """Seeded published-layout llava-hf numpy state dict (with the tower's
    position_ids buffer)."""
    model = llava.LlavaForConditionalGeneration(cfg, device="cpu")
    sd = tp._random_state(model, np.random.RandomState(seed))
    sd["language_model.model.embed_tokens.weight"] = np.random.RandomState(
        seed + 1).randn(cfg.text.vocab_size, cfg.text.hidden_size).astype(
        np.float32)
    n_pos = (cfg.vision.image_size // cfg.vision.patch_size) ** 2 + 1
    sd["vision_tower.vision_model.embeddings.position_ids"] = np.arange(
        n_pos)[None]
    return sd


def _new_layout(sd: dict) -> dict:
    """transformers >= 4.52's nesting of the same tensors."""
    out = {}
    for k, v in sd.items():
        if k.startswith("language_model.model."):
            k = "model.language_model." + k[len("language_model.model."):]
        elif k == "language_model.lm_head.weight":
            k = "lm_head.weight"
        else:
            k = "model." + k
        out[k] = v
    return out


def _write_sharded(sd: dict, root: str) -> None:
    keys = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": keys[::2],
              "model-00002-of-00002.safetensors": keys[1::2]}
    weight_map = {}
    for name, ks in shards.items():
        save_safetensors({k: torch.from_numpy(np.ascontiguousarray(sd[k]))
                          for k in ks}, os.path.join(root, name))
        weight_map.update(dict.fromkeys(ks, name))
    with open(os.path.join(root, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)


@pytest.fixture(scope="module")
def llavas(tmp_path_factory):
    cfg, jcfg_ = llava.tiny_llava_config(), jllava.tiny_llava_config()
    sd = _llava_state(cfg)
    root = str(tmp_path_factory.mktemp("llava"))
    _write_sharded(sd, root)
    params = jport.port_llava(root, jcfg_)
    ours = port_llava.port_llava(root, cfg)
    model = llava.LlavaForConditionalGeneration(cfg, device="cpu")
    port_llava.load_llava_state(model, ours)
    return cfg, jcfg_, params, model, sd, ours


@pytest.mark.parametrize("layout", ("published", "nested"))
def test_port_llava_matches_jax(llavas, tmp_path, layout):
    """`port_llava` of a sharded snapshot in either key layout equals the
    bridge of JAX's `port_llava` of it, and the seeded tensors."""
    cfg, jcfg_, params, model, sd, ours = llavas
    if layout == "nested":
        root = str(tmp_path)
        _write_sharded(_new_layout(sd), root)
        params = jport.port_llava(root, jcfg_)
        ours = port_llava.port_llava(root, cfg)
    back = bridge.llava_numpy_state_dict(jax.device_get(params), cfg)
    assert ours.keys() == back.keys() == model.state_dict().keys()
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), back[k], err_msg=k)
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_load_llava_state_takes_what_llava_skips(llavas):
    """A snapshot without the tower's unused last layer and post-layernorm
    loads; one without a used tensor does not."""
    cfg, _, _, model, _, ours = llavas
    last = f"vision_tower.vision_model.encoder.layers.{cfg.vision.num_layers - 1}."
    trimmed = {k: v for k, v in ours.items() if not k.startswith(
        (last, "vision_tower.vision_model.post_layernorm."))}
    fresh = llava.LlavaForConditionalGeneration(cfg, device="cpu")
    port_llava.load_llava_state(fresh, trimmed)
    with pytest.raises(KeyError):
        port_llava.load_llava_state(fresh, {
            k: v for k, v in ours.items()
            if k != "multi_modal_projector.linear_1.bias"})


def _images(n: int, seed: int = 6) -> np.ndarray:
    return np.random.default_rng(seed).random((n, 32, 32, 3), np.float32)


def test_image_features_and_splice_match_jax(llavas):
    cfg, jcfg_, params, model, _, _ = llavas
    img = _images(2)
    ref = np.asarray(jllava.image_features(params, jcfg_, jnp.asarray(img)))
    got = llava.image_features(model, tp.nchw(img))
    assert got.shape == (2, cfg.num_image_tokens, cfg.text.hidden_size)
    assert tp.rel_err(got.numpy(), ref) <= TOL
    ids = np.asarray([1, 3, 120, 9, 11])
    jembeds, jlen = jllava.splice_image(params, jcfg_, ids, jnp.asarray(ref))
    embeds, length = llava.splice_image(model, ids, torch.from_numpy(ref.copy()))
    assert length == jlen == 4 + cfg.num_image_tokens
    np.testing.assert_array_equal(embeds.numpy(), np.asarray(jembeds))
    for bad in ([1, 5], [1, 120, 120]):
        with pytest.raises(ValueError):
            llava.splice_image(model, np.asarray(bad), got)


def test_generate_matches_jax(llavas):
    """Two images on one prompt: the same 6 tokens as JAX's generate."""
    cfg, jcfg_, params, model, _, _ = llavas
    img = _images(2, seed=7)
    ids = np.asarray([1, 3, 7, 120, 9, 11])
    ref = jllava.generate(params, jcfg_, ids, jnp.asarray(img),
                          max_new_tokens=6)
    got = llava.generate(model, ids, tp.nchw(img), max_new_tokens=6)
    np.testing.assert_array_equal(got, ref)


def test_preprocess_image_matches_jax():
    rng = np.random.default_rng(24)
    for shape in ((33, 50, 3), (50, 33, 3), (41, 37, 3), (32, 32, 3)):
        img = (rng.random(shape) * 255).astype(np.uint8)
        np.testing.assert_array_equal(llava.preprocess_image(img, 32),
                                      jllava.preprocess_image(img, 32))
    assert llava.prompt_template("Q?") == jllava.prompt_template("Q?")
    hist = [("a?", "b"), ("c?", "d")]
    assert llava.prompt_template("e?", hist) == jllava.prompt_template(
        "e?", hist)


def _tokenize(text: str) -> np.ndarray:
    ids = [1]
    for tok in text.replace("<image>", " \x00 ").split():
        ids.append(120 if tok == "\x00"
                   else 3 + zlib.crc32(tok.encode()) % 100)
    return np.asarray(ids)


def _detok(ids) -> str:
    return " ".join(f"t{t}" for t in ids)


def test_build_vqa_matches_jax(llavas):
    """`vqa`, `.batch` over 3 images in chunks of 2 (JAX pads the last chunk
    with a zero image and the prompt to a multiple of 16; the port does
    neither) and a two-turn `.chat`: the same answers."""
    cfg, jcfg_, params, model, _, _ = llavas
    vqa = llava.build_vqa(model, _tokenize, _detok, max_new_tokens=4)
    jvqa = jllava.build_vqa(params, jcfg_, _tokenize, _detok,
                            max_new_tokens=4, pad_multiple=16)
    rng = np.random.default_rng(9)
    imgs = [(rng.random(shape) * 255).astype(np.uint8)
            for shape in ((24, 40, 3), (32, 32, 3), (50, 30, 3))]
    q = "Is there a dog? Answer yes or no."
    assert vqa(imgs[0], q) == jvqa(imgs[0], q)
    answers = vqa.batch(imgs, q, batch_size=2)
    assert answers == jvqa.batch(imgs, q, batch_size=2)
    assert answers == [vqa(img, q) for img in imgs]
    turns = ["what is this?", "Frame the location of the cat"]
    assert vqa.chat(imgs[1], turns) == jvqa.chat(imgs[1], turns)


def test_vqa_protocol_helpers_match_jax(llavas):
    """removal_score / vqa_presence_score over the native judge, and the
    parsers, as in JAX (the judge's answers are the tokens' names here, so
    every answer is unparsed: the scores are NaN on both sides)."""
    from diffusion_models_moe_tpu.benchmarks import vqa as jvqa_mod
    cfg, jcfg_, params, model, _, _ = llavas
    vqa = llava.build_vqa(model, _tokenize, _detok, max_new_tokens=3)
    imgs = list((_images(3, seed=10) * 255).astype(np.uint8))
    q = pvqa.object_question("dog")
    assert q == jvqa_mod.object_question("dog")
    score = pvqa.vqa_presence_score(vqa, imgs, q)
    assert score["unparsed"] == 3 and score["n"] == 0
    replies = {"yes": True, "No.": False, "maybe": None, "Yes, a dog": True}
    for text, want in replies.items():
        assert pvqa.parse_yes_no(text) == jvqa_mod.parse_yes_no(text) == want
    fake = lambda img, question: "yes" if img.mean() > 120 else "no"  # noqa
    before, after = imgs, [np.zeros_like(i) for i in imgs]
    assert pvqa.removal_score(fake, before, after, q) == \
        jvqa_mod.removal_score(fake, before, after, q)
    scorer = pvqa.MultipleChoiceScorer(lambda img, q: "2", ["cat", "dog"],
                                       "naked")
    jscorer = jvqa_mod.MultipleChoiceScorer(lambda img, q: "2",
                                            ["cat", "dog"], "naked")
    for s in (scorer, jscorer):
        s.score_images(imgs[:2], label=2, before=True)
    assert json.dumps(scorer.get_results(), sort_keys=True) == json.dumps(
        jscorer.get_results(), sort_keys=True)          # NaN != NaN in a dict
