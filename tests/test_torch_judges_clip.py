"""The port's CLIP judge against the JAX package's, on the CPU: the CLIP
vision tower and its porter, `clip_metrics`, `clip_iqa`, the CLIP
featurizers of `fid`, the NSFW safety checker, the image helpers
(`to_pil`, `blur_images`, `stitch_side_by_side`), and `checked_generate` on
`tiny_config` against JAX's on the same weights and JAX's initial noise.

Weights are seeded numpy in transformers' layout: the vision tower's are
written as a `model.safetensors` that JAX's porter and the port's both
read, and the bridge's JAX-params -> state-dict direction gives them back
bit for bit. JAX runs op by op here, apart from the one `checked_generate`.
Tolerances: model outputs 2e-4 relative (max error over max magnitude),
blurred and resized images 1e-5, flags exact.
"""
import dataclasses
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from diffusion_models_moe_tpu import safety as jsafety
from diffusion_models_moe_tpu.benchmarks import clip_iqa as jiqa
from diffusion_models_moe_tpu.benchmarks import clip_metrics as jcm
from diffusion_models_moe_tpu.benchmarks import fid as jfid
from diffusion_models_moe_tpu.models import clip_vision as jcv
from diffusion_models_moe_tpu.pipelines import stable_diffusion as jsd
from diffusion_models_moe_tpu.weights import port_vision as jpv
from diffusion_models_moe_tpu_torch import safety
from diffusion_models_moe_tpu_torch.benchmarks import clip_iqa, clip_metrics
from diffusion_models_moe_tpu_torch.benchmarks import fid
from diffusion_models_moe_tpu_torch.models import clip_vision as cv
from diffusion_models_moe_tpu_torch.pipelines import stable_diffusion as psd
from diffusion_models_moe_tpu_torch.weights import bridge, port_vision
from diffusion_models_moe_tpu_torch.weights.export import save_safetensors

TOL = 2e-4            # model outputs, relative
IMG_TOL = 1e-5        # blurred and resized images, relative


def write_clip(root: str, cfg, rng, prefix: str = "vision_model.",
               pre_ln: str = "pre_layrnorm", text_width: int = 32) -> dict:
    """Seeded transformers-layout CLIP weights for `cfg` written to
    `root/model.safetensors` (under `prefix`, the pre-LN spelled `pre_ln`,
    with `position_ids` and a `text_projection.weight` (P, text_width)).
    Returns the port module's state dict of the same numbers."""
    sd = tp._random_state(cv.CLIPVisionEncoder(cfg, device="cpu"), rng)
    proj = (rng.randn(cfg.projection_dim, text_width)
            * text_width ** -0.5).astype(np.float32)
    out = {"text_projection.weight": proj}
    for k, v in sd.items():
        name = k
        if k.startswith("vision_model."):
            name = prefix + k[len("vision_model."):].replace(
                "pre_layrnorm", pre_ln)
        out[name] = v
    n_pos = sd["vision_model.embeddings.position_embedding.weight"].shape[0]
    out[prefix + "embeddings.position_ids"] = np.arange(n_pos)[None]
    save_safetensors({k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in out.items()},
                     os.path.join(root, "model.safetensors"))
    return sd


@pytest.fixture(scope="module")
def vision(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("clip"))
    cfg, jcfg_ = cv.tiny_vision_config(), jcv.tiny_vision_config()
    sd = write_clip(root, cfg, np.random.RandomState(0))
    params = jpv.port_clip_vision(root, jcfg_)
    back = bridge.clip_vision_numpy_state_dict(params, cfg)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    enc = cv.CLIPVisionEncoder(cfg, device="cpu")
    enc.load_state_dict(port_vision.port_clip_vision(root, cfg))
    jenc = jcv.CLIPVisionEncoder(jcfg_)
    return dict(root=root, cfg=cfg, sd=sd, params=params, enc=enc,
                japply=lambda x, **kw: jenc.apply({"params": params}, x, **kw))


def images(seed: int, b: int = 2, side: int = 32) -> np.ndarray:
    """(B, H, W, 3) f32 in [0, 1], JAX's layout."""
    return np.random.RandomState(seed).rand(b, side, side, 3).astype(
        np.float32)


def test_vision_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device is present"):
        cv.CLIPVisionEncoder(cv.tiny_vision_config())


@pytest.mark.parametrize("normalize,layer", [(True, None), (False, None),
                                             (True, -2), (True, -1),
                                             (True, 0)])
def test_vision_tower_matches_jax(vision, normalize, layer):
    x = images(1)
    ref = np.asarray(vision["japply"](jnp.asarray(x), normalize=normalize,
                                      feature_layer=layer))
    got = vision["enc"](tp.nchw(x), normalize=normalize, feature_layer=layer)
    assert got.shape == ref.shape
    assert tp.rel_err(got.numpy(), ref) < TOL
    if normalize and layer is None:
        np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("prefix,pre_ln", [
    ("vision_model.", "pre_layernorm"), ("clip.vision_model.", "pre_layrnorm")])
def test_porter_reads_both_prefixes_and_spellings(tmp_path, vision, prefix,
                                                  pre_ln):
    cfg = vision["cfg"]
    sd = write_clip(str(tmp_path), cfg, np.random.RandomState(0), prefix,
                    pre_ln)
    got = port_vision.port_clip_vision(str(tmp_path), cfg)
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    params = jpv.port_clip_vision(str(tmp_path), jcv.tiny_vision_config())
    back = bridge.clip_vision_numpy_state_dict(params, cfg)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_text_projection_and_b32_text_config(vision, tmp_path):
    ref = jpv.port_clip_text_projection(vision["root"])
    got = port_vision.port_clip_text_projection(vision["root"])
    np.testing.assert_array_equal(got.numpy(), ref)
    save_safetensors({"visual_projection.weight": torch.zeros(2, 2)},
                     str(tmp_path / "model.safetensors"))
    assert port_vision.port_clip_text_projection(str(tmp_path)) is None
    assert jpv.port_clip_text_projection(str(tmp_path)) is None
    j, p = jpv.clip_b32_text_config(), port_vision.clip_b32_text_config()
    assert (p.hidden_size, p.intermediate_size, p.num_heads, p.num_layers,
            p.max_length) == (j.hidden_size, j.intermediate_size, j.num_heads,
                              j.num_layers, j.max_length)
    assert cv.CLIP_IMAGE_MEAN == jcv.CLIP_IMAGE_MEAN
    assert cv.CLIP_IMAGE_STD == jcv.CLIP_IMAGE_STD


@pytest.mark.parametrize("src,dst", [(512, 224), (64, 224), (64, 32),
                                     (16, 32)])
def test_resize_for_clip_matches_jax(src, dst):
    """Antialiased where it shrinks, plain bilinear where it grows."""
    x = images(2, b=1, side=src)
    ref = np.asarray(jcv.resize_for_clip(jnp.asarray(x), dst))
    got = cv.resize_for_clip(tp.nchw(x), dst)
    assert tp.rel_err(tp.nhwc(got), ref) < IMG_TOL


# ------------------------------------------------------------ clip_metrics
def test_text_embeddings_and_scores_match_jax():
    rng = np.random.RandomState(3)
    hidden = rng.randn(3, 7, 12).astype(np.float32)
    ids = rng.randint(0, 50, (3, 7)).astype(np.int32)
    proj = rng.randn(12, 5).astype(np.float32)
    for norm in (True, False):
        ref = jcm.pooled_text_embedding(jnp.asarray(hidden), jnp.asarray(ids),
                                        jnp.asarray(proj), normalize=norm)
        got = clip_metrics.pooled_text_embedding(
            torch.from_numpy(hidden), torch.from_numpy(ids).long(),
            torch.from_numpy(proj), normalize=norm)
        assert tp.rel_err(got.numpy(), ref) < TOL
        ref = jcm.mean_token_text_embedding(jnp.asarray(hidden), norm)
        got = clip_metrics.mean_token_text_embedding(torch.from_numpy(hidden),
                                                     norm)
        assert tp.rel_err(got.numpy(), ref) < TOL
    a, b = (rng.randn(4, 5).astype(np.float32) for _ in range(2))
    a[0] = -b[0]                                   # a negative cosine
    for name in ("clip_score", "image_image_similarity"):
        ref = getattr(jcm, name)(jnp.asarray(a), jnp.asarray(b))
        got = getattr(clip_metrics, name)(torch.from_numpy(a),
                                          torch.from_numpy(b))
        assert tp.rel_err(got.numpy(), ref) < TOL, name
    classes = rng.randn(3, 5).astype(np.float32)
    np.testing.assert_array_equal(
        clip_metrics.zero_shot_classify(torch.from_numpy(a),
                                        torch.from_numpy(classes)).numpy(),
        jcm.zero_shot_classify(jnp.asarray(a), jnp.asarray(classes)))
    assert clip_metrics.gender_ratio(
        torch.from_numpy(a), torch.from_numpy(classes[0]),
        torch.from_numpy(classes[1])) == jcm.gender_ratio(
        jnp.asarray(a), jnp.asarray(classes[0]), jnp.asarray(classes[1]))


def test_checker_rules_and_rates_match_jax():
    rng = np.random.RandomState(4)
    embs = rng.randn(5, 6).astype(np.float32)
    np.testing.assert_array_equal(
        clip_metrics.checker_concept_features(torch.from_numpy(embs)),
        jcm.checker_concept_features(embs))
    np.testing.assert_array_equal(clip_metrics.checker_no_concept_anchor(embs),
                                  jcm.checker_no_concept_anchor(embs))
    sims = rng.rand(6, 4)
    snc, sa = rng.rand(6), rng.rand(6)
    np.testing.assert_array_equal(
        clip_metrics.reference_nudity_decision(torch.from_numpy(sims), snc,
                                               sa),
        jcm.reference_nudity_decision(sims, snc, sa))
    names = ["Van Gogh", "Monet", "art", "painting"]
    for thr in (0.55, 0.3):
        assert clip_metrics.reference_art_style_decision(
            sims, names, snc, thr) == jcm.reference_art_style_decision(
            sims, names, snc, thr)
    assert clip_metrics.removal_accuracy(snc, sa) == jcm.removal_accuracy(
        snc, sa)
    before, after = rng.randint(0, 2, 20), rng.randint(0, 2, 20)
    assert clip_metrics.debias_success_rates(
        torch.from_numpy(before), after) == jcm.debias_success_rates(
        before, after)
    b2, a2 = rng.randint(0, 2, 20), rng.randint(0, 2, 20)
    assert clip_metrics.debias_preservation_rates(
        before, after, b2, a2) == jcm.debias_preservation_rates(
        before, after, b2, a2)
    for row in sims:
        assert clip_metrics.zscore_concept_decision(
            row, names) == jcm.zscore_concept_decision(row, names)
    spiky = np.array([0.1, 0.1, 0.1, 0.9])
    assert clip_metrics.zscore_concept_decision(
        spiky, ["naked", "sexy", "hot", "neutral"]) == \
        jcm.zscore_concept_decision(spiky, ["naked", "sexy", "hot", "neutral"])
    assert clip_metrics.ZSCORE_CONCEPT_THRESHOLDS == \
        jcm.ZSCORE_CONCEPT_THRESHOLDS
    dec, lab = rng.rand(12) > 0.5, rng.rand(12) > 0.5
    prompts = [f"p{i}" for i in range(12)]
    assert clip_metrics.routing_confusion(dec, lab, prompts) == \
        jcm.routing_confusion(dec, lab, prompts)


def test_concept_checkers_match_jax():
    rng = np.random.RandomState(5)
    c, a = rng.randn(8).astype(np.float32), rng.randn(8).astype(np.float32)
    prompts = rng.randn(10, 8).astype(np.float32)
    labels = rng.rand(10) > 0.5
    for margin in (0.0, 0.5):
        got = clip_metrics.ConceptChecker("x", torch.from_numpy(c), a, margin)
        ref = jcm.ConceptChecker("x", c, a, margin)
        np.testing.assert_array_equal(got(torch.from_numpy(prompts)),
                                      ref(prompts))
        assert clip_metrics.checker_accuracy(got, prompts, labels) == \
            jcm.checker_accuracy(ref, prompts, labels)
    mem = ["A photo of X ", "y"]
    asked = ["a photo of x", "Y", "z"]
    np.testing.assert_array_equal(
        clip_metrics.MemorizedPromptChecker(mem)(asked),
        jcm.MemorizedPromptChecker(mem)(asked))


# ------------------------------------------------------ towers for the rest
def tokenizer(vocab: int, maxlen: int):
    """Per-prompt seeded ids in [1, vocab - 2], EOS (vocab - 1, the highest
    id, where CLIP pools) after them, pad 0: numpy int32 (JAX's) and the
    same as an int64 tensor (the port's)."""
    def np_tok(texts):
        out = np.zeros((len(texts), maxlen), np.int32)
        for i, t in enumerate(texts):
            rng = np.random.RandomState(zlib.crc32(t.encode()))
            n = 1 + len(t) % (maxlen - 2)
            out[i, :n] = rng.randint(1, vocab - 1, n)
            out[i, n] = vocab - 1
        return out
    return np_tok, lambda texts: torch.from_numpy(np_tok(texts)).long()


@pytest.fixture(scope="module")
def towers(vision):
    """The tiny SD pipeline's CLIP text tower in both packages (same
    weights), the vision tower above, and the text projection of its
    checkpoint."""
    jax_cfg, port_cfg = tp.tiny_pair()
    params, port = tp.pipelines(jax_cfg, port_cfg=port_cfg)
    jpipe = jsd.StableDiffusionPipeline(jax_cfg)
    tc = jax_cfg.text_encoder
    np_tok, pt_tok = tokenizer(tc.vocab_size, tc.max_length)
    proj = port_vision.port_clip_text_projection(vision["root"])
    jvis = jcv.CLIPVisionEncoder(jcv.tiny_vision_config())
    return dict(jax_cfg=jax_cfg, params=params, port=port, jpipe=jpipe,
                np_tok=np_tok, pt_tok=pt_tok, proj=proj, jvis=jvis,
                jtext=lambda ids: jpipe.text_encoder.apply(
                    {"params": params["text_encoder"]}, ids))


def featurizers(vision, towers):
    """((JAX image featurizer, JAX text featurizer), (the port's))."""
    jimg = jfid.make_clip_featurizer(towers["jvis"], vision["params"])
    jtxt = jfid.make_clip_text_featurizer(
        towers["jpipe"].text_encoder, towers["params"]["text_encoder"],
        towers["np_tok"], towers["proj"].numpy())
    pimg = fid.make_clip_featurizer(vision["enc"])
    ptxt = fid.make_clip_text_featurizer(towers["port"].text_encoder,
                                         towers["pt_tok"], towers["proj"])
    return (jimg, jtxt), (pimg, ptxt)


def test_clip_featurizers_match_jax(vision, towers):
    (jimg, jtxt), (pimg, ptxt) = featurizers(vision, towers)
    x = images(6, side=48)                         # resized to 32 first
    assert tp.rel_err(pimg(tp.nchw(x)).numpy(), np.asarray(jimg(x))) < TOL
    prompts = ["a photo of a dog", "a house", "Good photo."]
    got, ref = ptxt(prompts), jtxt(prompts)
    assert got.shape == ref.shape == (3, 16)
    assert tp.rel_err(got.numpy(), ref) < TOL
    # without a projection: the pooled hidden state
    assert tp.rel_err(
        fid.make_clip_text_featurizer(towers["port"].text_encoder,
                                      towers["pt_tok"])(prompts).numpy(),
        jfid.make_clip_text_featurizer(
            towers["jpipe"].text_encoder, towers["params"]["text_encoder"],
            towers["np_tok"])(prompts)) < TOL


# ------------------------------------------------------------------ clip_iqa
def test_prompt_tables_match_jax():
    specs = ("quality", ("photo of a woman", "photo of a man"), "sharpness",
             ("not naked", "naked"))
    assert clip_iqa.resolve_prompt_pairs(specs) == \
        jiqa.resolve_prompt_pairs(specs)
    assert clip_iqa.BUILTIN_PROMPTS == jiqa.BUILTIN_PROMPTS
    for adj in ("naked", "Van Gogh", "gender", "scene_removal_cat"):
        assert clip_iqa.design_test_prompt(adj) == jiqa.design_test_prompt(adj)
    for mod in (clip_iqa, jiqa):
        with pytest.raises(ValueError):
            mod.resolve_prompt_pairs(("no such pair",))
        with pytest.raises(KeyError):
            mod.design_test_prompt("no such concept")


def test_clip_iqa_matches_jax(vision, towers):
    rng = np.random.RandomState(7)
    img, pos, neg = (rng.randn(n, 16).astype(np.float32) for n in (3, 2, 2))
    ref = jiqa.clip_iqa_probs(img, pos, neg)
    got = clip_iqa.clip_iqa_probs(torch.from_numpy(img), pos, neg)
    assert tp.rel_err(got.numpy(), ref) < TOL
    (jimg, jtxt), (pimg, ptxt) = featurizers(vision, towers)
    specs = ("quality", ("photo of a woman", "photo of a man"))
    jq, pq = jiqa.ClipIQA(jimg, jtxt, specs), clip_iqa.ClipIQA(pimg, ptxt,
                                                               specs)
    x = images(8, b=3)
    ref, got = jq(x), pq(tp.nchw(x))
    assert got.keys() == ref.keys() == {"quality", "user_defined_0"}
    for k in ref:
        assert tp.rel_err(got[k], ref[k]) < TOL, k
    report = dict(base=got, concept=pq(tp.nchw(images(9, b=3))),
                  removed=pq(tp.nchw(images(10, b=3))))
    assert clip_iqa.removal_quality_report(*report.values()) == \
        jiqa.removal_quality_report(*report.values())


# ------------------------------------------------------------ image helpers
@pytest.mark.parametrize("sigma", [7.0, 1.5])
def test_blur_images_matches_jax(sigma):
    x = images(11, side=64)
    ref = np.asarray(jsd.blur_images(jnp.asarray(x), sigma))
    got = psd.blur_images(tp.nchw(x), sigma)
    assert tp.rel_err(tp.nhwc(got), ref) < IMG_TOL


def test_to_pil_and_stitch_match_jax():
    x, y = images(12, side=16), images(13, side=16)
    x[0, 0, 0] = (0.0, 1.0, 0.5 / 255)             # rounding edges
    for got, ref in zip(psd.to_pil(tp.nchw(x)), jsd.to_pil(jnp.asarray(x))):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    for got, ref in zip(psd.stitch_side_by_side(tp.nchw(x), tp.nchw(y)),
                        jsd.stitch_side_by_side(jnp.asarray(x),
                                                jnp.asarray(y))):
        assert got.size == ref.size == (32, 16)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


# ------------------------------------------------------------------- safety
def test_safety_config_fields_default_off():
    from diffusion_models_moe_tpu import config as jcfg
    from diffusion_models_moe_tpu_torch import config as pcfg
    for mod in (jcfg, pcfg):
        c = mod.PipelineConfig()
        assert (c.safety_check, c.blur_nsfw) == (False, False)
    assert safety.UNSAFE_CONCEPTS == jsafety.UNSAFE_CONCEPTS


def concept_embeddings(towers):
    proj = towers["proj"]
    ref = jsafety.unsafe_concept_embeddings(towers["jtext"], towers["np_tok"],
                                            text_projection=proj.numpy())
    got = safety.unsafe_concept_embeddings(
        lambda ids: towers["port"].encode_text(ids)[0], towers["pt_tok"],
        text_projection=proj)
    return ref, got


def test_unsafe_concept_embeddings_match_jax(towers):
    ref, got = concept_embeddings(towers)
    assert got.shape == ref.shape == (len(safety.UNSAFE_CONCEPTS), 16)
    assert tp.rel_err(got.numpy(), ref) < TOL
    ref = jsafety.unsafe_concept_embeddings(towers["jtext"], towers["np_tok"])
    got = safety.unsafe_concept_embeddings(
        lambda ids: towers["port"].encode_text(ids)[0], towers["pt_tok"])
    assert tp.rel_err(got.numpy(), ref) < TOL


def test_checker_and_policy_match_jax():
    rng = np.random.RandomState(14)
    feats = rng.randn(4, 6).astype(np.float32)
    concepts = rng.randn(3, 6).astype(np.float32)
    for thr in (0.0, 0.3, 0.6):
        got = safety.CLIPNSFWChecker(lambda _: torch.from_numpy(feats),
                                     torch.from_numpy(concepts), thr)
        ref = jsafety.CLIPNSFWChecker(lambda _: feats, concepts, thr)
        np.testing.assert_array_equal(got(None), ref(None))
    x = images(15, b=3, side=64)
    flags = np.array([True, False, True])
    for blur in (True, False):
        ref = np.asarray(jsafety.apply_safety_policy(jnp.asarray(x), flags,
                                                     blur=blur))
        got = tp.nhwc(safety.apply_safety_policy(tp.nchw(x), flags,
                                                 blur=blur))
        assert tp.rel_err(got, ref) < IMG_TOL
        np.testing.assert_array_equal(got[1], x[1])     # bit-identical
    same = safety.apply_safety_policy(tp.nchw(x), np.zeros(3, bool))
    np.testing.assert_array_equal(tp.nhwc(same), x)


@pytest.fixture(scope="module")
def checked(vision, towers):
    """JAX's and the port's checked_generate of 2 requests, 2 PNDM steps,
    on the same weights and JAX's initial noise, with a checker whose
    threshold lies between the two images' largest concept similarities
    (measured on JAX's unchecked images): one is flagged."""
    jax_cfg, port = towers["jax_cfg"], towers["port"]
    params, jpipe = towers["params"], towers["jpipe"]
    rng = np.random.RandomState(16)
    tc = jax_cfg.text_encoder
    cond = rng.randint(0, tc.vocab_size, (2, tc.max_length)).astype(np.int32)
    uncond = np.zeros_like(cond)
    key = jax.random.PRNGKey(17)
    jimg, _ = jpipe.generate(params, jnp.asarray(cond), jnp.asarray(uncond),
                             key, num_steps=2)
    ref_c, got_c = concept_embeddings(towers)
    jfeat = jfid.make_clip_featurizer(towers["jvis"], vision["params"])
    e = np.array(jfeat(jimg))
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    c = ref_c / np.linalg.norm(ref_c, axis=-1, keepdims=True)
    top = (e @ c.T).max(axis=1)
    threshold = float(top.mean())
    jchecker = jsafety.CLIPNSFWChecker(jfeat, ref_c, threshold)
    pchecker = safety.CLIPNSFWChecker(fid.make_clip_featurizer(vision["enc"]),
                                      got_c, threshold)
    jcfg_on = dataclasses.replace(jax_cfg, safety_check=True, blur_nsfw=True)
    ref = jsafety.checked_generate(jsd.StableDiffusionPipeline(jcfg_on),
                                   params, jnp.asarray(cond),
                                   jnp.asarray(uncond), key, num_steps=2,
                                   checker=jchecker)
    s = jax_cfg.sample_size
    noise = tp.nchw(np.asarray(jax.random.normal(key, (2, s, s, 4),
                                                 jnp.float32)))
    return dict(port=port, cond=torch.from_numpy(cond).long(),
                uncond=torch.from_numpy(uncond).long(), noise=noise,
                pchecker=pchecker, ref=ref, jimg=np.asarray(jimg), top=top,
                threshold=threshold)


def test_checked_generate_matches_jax(checked, monkeypatch):
    port = checked["port"]
    monkeypatch.setattr(port, "initial_noise", lambda b, g: checked["noise"])
    on = dataclasses.replace(port.config, safety_check=True, blur_nsfw=True)
    monkeypatch.setattr(port, "config", on)
    imgs, taps, flags = safety.checked_generate(
        port, checked["cond"], checked["uncond"], torch.Generator(),
        checker=checked["pchecker"], num_steps=2)
    ref_imgs, _, ref_flags = checked["ref"]
    assert taps is None
    np.testing.assert_array_equal(flags, np.asarray(ref_flags))
    assert flags.sum() == 1                       # one flagged, one not
    assert tp.rel_err(tp.nhwc(imgs), np.asarray(ref_imgs)) < TOL
    # the unflagged image is plain generate's, the flagged one its blur
    plain, _ = port.generate(checked["cond"], checked["uncond"],
                             torch.Generator(), num_steps=2)
    keep = int(np.flatnonzero(~flags)[0])
    hit = int(np.flatnonzero(flags)[0])
    assert torch.equal(imgs[keep], plain[keep])
    assert torch.equal(imgs[hit], psd.blur_images(plain)[hit])


def test_checked_generate_off_and_without_a_checker(checked, monkeypatch):
    port = checked["port"]
    monkeypatch.setattr(port, "initial_noise", lambda b, g: checked["noise"])
    imgs, _, flags = safety.checked_generate(
        port, checked["cond"], checked["uncond"], torch.Generator(),
        num_steps=2)
    assert not flags.any() and flags.shape == (2,)
    plain, _ = port.generate(checked["cond"], checked["uncond"],
                             torch.Generator(), num_steps=2)
    assert torch.equal(imgs, plain)
    assert tp.rel_err(tp.nhwc(imgs), checked["jimg"]) < TOL
    monkeypatch.setattr(port, "config", dataclasses.replace(
        port.config, safety_check=True))
    with pytest.raises(ValueError, match="requires a CLIPNSFWChecker"):
        safety.checked_generate(port, checked["cond"], checked["uncond"],
                                torch.Generator(), num_steps=2)
    # blur_nsfw off: the flagged image is blacked out
    imgs, _, flags = safety.checked_generate(
        port, checked["cond"], checked["uncond"], torch.Generator(),
        checker=checked["pchecker"], num_steps=2)
    assert (imgs[np.flatnonzero(flags)] == 0).all()
