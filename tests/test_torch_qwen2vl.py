"""The port's Qwen2-VL judge against the JAX package's, on the CPU, at
`tiny_qwen2vl_config`: the vision tower's merged features, `rope_index`
(an image span inside the prompt, opening it, and none), the M-RoPE LM's
logits, `generate` (co-batched = alone, the vocabulary's pad id after EOS),
`smart_resize`, `preprocess_image`, `prompt_ids`, `build_vqa`'s `vqa` /
`.batch` / `.chat`, `port_qwen2vl` on sharded snapshots in both
transformers key layouts and with tied embeddings, the bridge back bit for
bit, and `load_qwen2vl_native` on a snapshot with a byte-level
`tokenizer.json`.

Weights are seeded numpy in transformers' `Qwen2VLForConditionalGeneration`
layout; JAX's porter reads them, the bridge gives JAX's tree back as the
port's state dict bit for bit. Tolerances: features and logits max |port -
JAX| / max |JAX| <= 1e-4 (as `tests/test_torch_llava.py`); positions,
patches' grids, tokens and answers equal; patches within 1e-6.
"""
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
from test_torch_llava import _write_sharded
from diffusion_models_moe_tpu.data import tokenizer as jtok
from diffusion_models_moe_tpu.models import llama as jllama
from diffusion_models_moe_tpu.models import qwen2vl as jqwen
from diffusion_models_moe_tpu.weights import port_qwen2vl as jport
from diffusion_models_moe_tpu_torch.benchmarks import vqa as pvqa
from diffusion_models_moe_tpu_torch.models import llama, qwen2vl
from diffusion_models_moe_tpu_torch.weights import bridge, port_qwen2vl

TOL = 1e-4
VOCAB = 128


def _state(cfg, seed: int = 7) -> dict:
    """Seeded published-layout numpy state dict (`visual.*`, `model.*`,
    `lm_head.weight`), embeddings N(0, 1)."""
    model = qwen2vl.Qwen2VLForConditionalGeneration(cfg, device="cpu")
    sd = tp._random_state(model, np.random.RandomState(seed))
    out = {}
    for k, v in sd.items():
        if k.startswith("language_model."):
            k = k[len("language_model."):]
        out[k] = v
    out["model.embed_tokens.weight"] = np.random.RandomState(seed + 1).randn(
        cfg.text.vocab_size, cfg.text.hidden_size).astype(np.float32)
    return out


def _nested(sd: dict) -> dict:
    """transformers >= 4.52's nesting of the same tensors."""
    out = {}
    for k, v in sd.items():
        if k.startswith("visual."):
            k = "model." + k
        elif k.startswith("model."):
            k = "model.language_model." + k[len("model."):]
        out[k] = v
    return out


def _load(cfg, sd: dict) -> qwen2vl.Qwen2VLForConditionalGeneration:
    model = qwen2vl.Qwen2VLForConditionalGeneration(cfg, device="cpu")
    model.load_state_dict(sd)
    return model


@pytest.fixture(scope="module")
def qwens(tmp_path_factory):
    cfg, jcfg = qwen2vl.tiny_qwen2vl_config(), jqwen.tiny_qwen2vl_config()
    sd = _state(cfg)
    root = str(tmp_path_factory.mktemp("qwen2vl"))
    _write_sharded(sd, root)
    params = jax.device_get(jport.port_qwen2vl(root, jcfg))
    ours = port_qwen2vl.port_qwen2vl(root, cfg)
    return cfg, jcfg, params, _load(cfg, ours), sd, root


@pytest.mark.parametrize("layout", ("published", "nested", "tied"))
def test_port_qwen2vl_matches_jax(qwens, tmp_path, layout):
    """`port_qwen2vl` of a sharded snapshot in either key layout (and
    without `lm_head`, the 2B's tied embeddings) equals the bridge of JAX's
    `port_qwen2vl` of it, and the seeded tensors."""
    cfg, jcfg, params, model, sd, root = qwens
    if layout != "published":
        root = str(tmp_path)
        src = (_nested(sd) if layout == "nested"
               else {k: v for k, v in sd.items() if k != "lm_head.weight"})
        _write_sharded(src, root)
        params = jax.device_get(jport.port_qwen2vl(root, jcfg))
    ours = port_qwen2vl.port_qwen2vl(root, cfg)
    back = bridge.qwen2vl_numpy_state_dict(params, cfg)
    assert ours.keys() == back.keys() == model.state_dict().keys()
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), back[k], err_msg=k)
        src_key = k[len("language_model."):] if k.startswith(
            "language_model.") else k
        if layout == "tied" and src_key == "lm_head.weight":
            src_key = "model.embed_tokens.weight"
        np.testing.assert_array_equal(v.numpy(), sd[src_key], err_msg=k)


def _patches(cfg, h=16, w=24, seed=12):
    img = (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(
        np.uint8)
    return qwen2vl.preprocess_image(img, cfg.vision, min_pixels=1,
                                    max_pixels=10 ** 9)


def test_preprocess_and_smart_resize_match_jax(qwens):
    cfg, jcfg = qwens[:2]
    for h, w in ((224, 224), (480, 640), (37, 1000), (1333, 57), (28, 28),
                 (512, 512)):
        assert qwen2vl.smart_resize(h, w, 28, 56 * 56, 28 * 28 * 1280) == \
            jqwen.smart_resize(h, w, 28, 56 * 56, 28 * 28 * 1280)
    with pytest.raises(ValueError):
        qwen2vl.smart_resize(10, 3000, 28, 1, 10 ** 9)
    rng = np.random.default_rng(16)
    for shape, kw in (((40, 56, 3), dict(min_pixels=1, max_pixels=10 ** 9)),
                      ((33, 49, 3), dict(max_pixels=16 * 16)),
                      ((512, 512, 3), {})):
        img = (rng.random(shape) * 255).astype(np.uint8)
        got, grid = qwen2vl.preprocess_image(img, cfg.vision, **kw)
        ref, jgrid = jqwen.preprocess_image(img, jcfg.vision, **kw)
        assert grid == jgrid and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=1e-6)
    # 512 px at the 7B's patches: 504 x 504, 1296 patches, 324 image tokens
    full = qwen2vl.Qwen2VisionConfig()
    p, grid = qwen2vl.preprocess_image(np.zeros((512, 512, 3), np.uint8),
                                       full, max_pixels=28 * 28 * 576)
    assert grid == (1, 36, 36) and p.shape == (1296, full.patch_dim)


def test_vision_features_match_jax(qwens):
    cfg, jcfg, params, model = qwens[:4]
    patches, grid = _patches(cfg)
    ref = jqwen.Qwen2VisionTower(jcfg.vision, grid).apply(
        {"params": params["vision"]}, jnp.asarray(patches))
    got = qwen2vl.image_features(model, patches, grid)
    assert got.shape == (1, patches.shape[0] // 4, cfg.vision.hidden_size)
    assert tp.rel_err(got[0].numpy(), np.asarray(ref)) <= TOL


def test_rope_index_matches_jax(qwens):
    cfg, jcfg = qwens[:2]
    patches, grid = _patches(cfg)
    n_img = patches.shape[0] // 4
    cases = [
        (np.concatenate([[5, 7], [121], [120] * n_img, [122], [9, 11, 13]]),
         grid),
        (np.concatenate([[120] * 4, [9, 11]]), (1, 4, 4)),     # image first
        (np.asarray([5, 7, 9]), grid),                          # no image
    ]
    for ids, g in cases:
        pos, delta = qwen2vl.rope_index(cfg, ids, g)
        jpos, jdelta = jqwen.rope_index(jcfg, ids, g)
        np.testing.assert_array_equal(pos, jpos)
        assert pos.dtype == np.int32 and delta == jdelta
    with pytest.raises(ValueError):
        qwen2vl.rope_index(cfg, np.asarray([120] * 3), (1, 4, 4))


def test_text_logits_match_jax(qwens):
    """M-RoPE with equal t/h/w positions and q/k/v biases (the text-only
    path)."""
    cfg, jcfg, params, model = qwens[:4]
    ids = np.random.default_rng(13).integers(0, 100, size=(1, 9))
    lp = {k: v for k, v in params["language"].items() if k != "embed_tokens"}
    ref, _ = jllama.LlamaModel(jcfg.text).apply(
        {"params": lp}, jllama.embed_tokens(params["language"],
                                            jnp.asarray(ids)),
        jnp.arange(9)[None], jnp.ones((1, 9), bool))
    lm = model.language_model
    got, _ = lm(llama.embed_tokens(lm, torch.from_numpy(ids)),
                torch.arange(9)[None], torch.ones((1, 9), dtype=torch.bool))
    assert tp.rel_err(got.numpy(), np.asarray(ref)) <= TOL


def test_generate_matches_jax(qwens):
    """A multimodal prompt decodes JAX's tokens; two images co-batched
    decode as each does alone; after a forced EOS the slots carry the
    config's pad id, as JAX's."""
    import dataclasses
    cfg, jcfg, params, model = qwens[:4]
    p1, grid = _patches(cfg, 16, 24, seed=41)
    p2, _ = _patches(cfg, 16, 24, seed=42)
    n_img = p1.shape[0] // 4
    ids = np.concatenate([[5, 7], [121], [120] * n_img, [122], [9, 11]])
    both = qwen2vl.generate(model, ids, np.stack([p1, p2]), grid,
                            max_new_tokens=6)
    np.testing.assert_array_equal(both, jqwen.generate(
        params, jcfg, ids, np.stack([p1, p2]), grid, max_new_tokens=6))
    for r, p in enumerate((p1, p2)):
        np.testing.assert_array_equal(
            qwen2vl.generate(model, ids, p, grid, max_new_tokens=6)[0],
            both[r])
    free = both[0]
    forced = dataclasses.replace(cfg, eos_id=int(free[1]), pad_id=99)
    jforced = dataclasses.replace(jcfg, eos_id=int(free[1]), pad_id=99)
    model.cfg = forced
    try:
        toks = qwen2vl.generate(model, ids, p1, grid, max_new_tokens=5)[0]
    finally:
        model.cfg = cfg
    np.testing.assert_array_equal(toks, jqwen.generate(
        params, jforced, ids, p1, grid, max_new_tokens=5)[0])
    assert toks[1] == forced.eos_id and (toks[2:] == 99).all()
    with pytest.raises(ValueError):            # one image token short
        qwen2vl.generate(model, np.delete(ids, 3), p1, grid)


def _tokenize(text: str) -> np.ndarray:
    return np.asarray([3 + zlib.crc32(t.encode()) % 100
                       for t in text.split()], np.int64)


def _detok(ids) -> str:
    return " ".join(f"t{t}" for t in ids)


def test_build_vqa_matches_jax(qwens):
    """`vqa`, `.batch` over 4 images in two smart-resize grid groups in
    chunks of 2 (JAX pads the last chunk with zero patches and the prompt
    to a multiple of 16; the port does neither) and a two-turn `.chat`
    whose second prompt holds the first answer: the same answers, and
    `prompt_ids` equal."""
    cfg, jcfg, params, model = qwens[:4]
    kw = dict(max_new_tokens=3, max_pixels=16 * 16)
    vqa = qwen2vl.build_vqa(model, _tokenize, _detok, **kw)
    jvqa = jqwen.build_vqa(params, jcfg, _tokenize, _detok, pad_multiple=16,
                           **kw)
    rng = np.random.default_rng(31)
    imgs = [(rng.random((h, w, 3)) * 255).astype(np.uint8)
            for h, w in ((33, 49), (32, 48), (41, 23), (33, 49))]
    q = "Is there a cat?"
    assert vqa(imgs[0], q) == jvqa(imgs[0], q)
    answers = vqa.batch(imgs, q, batch_size=2)
    assert answers == jvqa.batch(imgs, q, batch_size=2)
    assert answers == [vqa(img, q) for img in imgs]
    turns = ["what is this?", "Is this a painting? yes or no"]
    assert vqa.chat(imgs[2], turns) == jvqa.chat(imgs[2], turns)
    hist = [("a?", "b c")]
    np.testing.assert_array_equal(
        qwen2vl.prompt_ids(_tokenize, "q?", 4, cfg, hist),
        jqwen.prompt_ids(_tokenize, "q?", 4, jcfg, hist))


# ------------------------------------------------- load_qwen2vl_native
def tiny_tokenizer_spec() -> dict:
    """A Qwen2-layout byte-level `tokenizer.json` inside the tiny vocabulary:
    the byte alphabet's printable ASCII and the space and newline bytes'
    characters, merges up to 122 pieces, and the chat strings as special
    added tokens after them (<|im_end|> at the tiny config's EOS, 122;
    `tokenizers` numbers added tokens on from the model's vocabulary)."""
    from diffusion_models_moe_tpu_torch.data._native_unigram import \
        QWEN2_SPLIT
    chars = [chr(c) for c in range(33, 127)] + ["Ġ", "Ċ"]
    vocab = {c: i for i, c in enumerate(chars)}
    merges = []
    pairs = [("Ġ", "a"), ("i", "s"), ("Ġ", "is"), ("t", "h"), ("Ġ", "th"),
             ("Ġth", "e"), ("a", "t"), ("Ġ", "c"), ("Ġc", "at")]
    pairs += [("Ġ", c) for c in "bdefghijklmnopqrsuvwxyz"]
    for a, b in pairs:
        if len(vocab) == 122:
            break
        merges.append(f"{a} {b}")
        vocab[a + b] = len(vocab)
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, t in ((122, "<|im_end|>"), (123, "<|im_start|>"),
                          (124, "<|endoftext|>"))]
    bl = {"type": "ByteLevel", "add_prefix_space": False,
          "trim_offsets": False, "use_regex": False}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_SPLIT},
             "behavior": "Isolated", "invert": False}, bl]},
        "post_processor": bl, "decoder": bl,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": False, "vocab": vocab, "merges": merges}}


def test_load_qwen2vl_native_matches_jax(qwens):
    """`load_qwen2vl_native` at the tiny config (`config=`) on the CPU: the
    snapshot's weights and its byte-level tokenizer give JAX's answers
    (JAX: its porter, `load_qwen_tokenizer` on `tokenizers`, `build_vqa`),
    one by one and through `.batch`."""
    cfg, jcfg, params, _, _, root = qwens
    with open(os.path.join(root, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(tiny_tokenizer_spec(), f, ensure_ascii=False)
    vqa = pvqa.load_qwen2vl_native(root, config=cfg, max_new_tokens=4,
                                   device="cpu")
    encode, decode = jtok.load_qwen_tokenizer(root)
    jvqa = jqwen.build_vqa(params, jcfg, encode, decode, max_new_tokens=4)
    rng = np.random.default_rng(51)
    imgs = [(rng.random((64, 80, 3)) * 255).astype(np.uint8)
            for _ in range(3)]
    q = "Is the cat there?"
    assert vqa(imgs[0], q) == jvqa(imgs[0], q)
    assert vqa.batch(imgs, q, batch_size=2) == jvqa.batch(imgs, q,
                                                          batch_size=2)


def test_qwen2vl_entry_point_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device is present"):
        qwen2vl.Qwen2VLForConditionalGeneration(qwen2vl.tiny_qwen2vl_config())
