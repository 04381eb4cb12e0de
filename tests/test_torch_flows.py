"""The torch port's HPO studies, noise-difference objective and numpy-only
flows (prompts, operating points, COCO sampling, bounding boxes, plots,
image coercion) against the JAX package's, on the same inputs."""
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu import imaging as jimaging
from diffusion_models_moe_tpu.analysis import bounding_boxes as jbb
from diffusion_models_moe_tpu.analysis import hpo as jhpo
from diffusion_models_moe_tpu.analysis import plots as jplots
from diffusion_models_moe_tpu.data import coco as jcoco
from diffusion_models_moe_tpu.data import operating_points as jop
from diffusion_models_moe_tpu.data import prompts as jprompts
from diffusion_models_moe_tpu_torch import build_moe_interventions, imaging
from diffusion_models_moe_tpu_torch.analysis import bounding_boxes as bb
from diffusion_models_moe_tpu_torch.analysis import hpo, plots
from diffusion_models_moe_tpu_torch.data import coco, operating_points, prompts
from diffusion_models_moe_tpu_torch.data.tokenize import hash_tokenize
from diffusion_models_moe_tpu_torch.taps import TapSpec

import torch_parity as tp


def _objective(p: dict) -> float:
    return (p["x"] - 0.3) ** 2 + abs(p.get("y", 0.0) + 0.2)


@pytest.mark.parametrize("direction", ["minimize", "maximize"])
def test_studies_equal_jax(tmp_path, direction):
    """Grid, random and TPE studies: the same trials, best trial and JSON
    trial log as the JAX package's."""
    space = {"x": (0.0, 1.0), "y": (-1.0, 1.0)}
    runs = [("grid", dict(grid={"x": [0.1, 0.3, 0.9], "y": [-0.2, 0.5]})),
            ("random", dict(space=space, n_trials=12, seed=3)),
            ("tpe", dict(space=space, n_trials=20, seed=1))]
    for kind, kw in runs:
        got_dir, ref_dir = tmp_path / f"port_{kind}", tmp_path / f"jax_{kind}"
        got = hpo.Study(kind, direction, str(got_dir))
        ref = jhpo.Study(kind, direction, str(ref_dir))
        best = getattr(got, f"optimize_{kind}")(_objective, **kw)
        ref_best = getattr(ref, f"optimize_{kind}")(_objective, **kw)
        assert [vars(t) for t in got.trials] == [vars(t) for t in ref.trials]
        assert vars(best) == vars(ref_best)
        assert filecmp.cmp(got_dir / f"{kind}.json", ref_dir / f"{kind}.json",
                           shallow=False)


def test_noise_diff_objective_against_the_eps_taps():
    """0 without an intervention; with MoE routing, the mean over prompts
    of the mean over steps of ||eps_routed - eps_base||, computed from the
    port's own `save_eps` taps."""
    _, pipe = tp.pipelines(jcfg.tiny_config())
    cfg = pipe.config
    tok = hash_tokenize(cfg.text_encoder.vocab_size, cfg.text_encoder.max_length)
    prompts_ = ["a dog", "a house"]
    ivs = build_moe_interventions(tp.labels(cfg.unet), 0.3, device="cpu")
    obj = hpo.noise_diff_objective(
        pipe, tok, prompts_, lambda p: ivs if p["route"] else None, seed=5,
        num_steps=2)
    assert obj({"route": False}) == 0.0

    def eps(prompt, iv):
        cond = tok([prompt])
        _, taps = pipe.generate(cond, torch.zeros_like(cond), seeds=[5],
                                num_steps=2, ivs=iv,
                                tap=TapSpec(save_eps=True), decode=False)
        return taps["eps"][0].double()

    diffs = [eps(p, ivs) - eps(p, None) for p in prompts_]
    hand = np.mean([d.reshape(d.shape[0], -1).norm(dim=1).mean().item()
                    for d in diffs])
    got = obj({"route": True})
    assert got > 0 and abs(got - hand) <= 1e-6 * hand


def test_prompts_equal_jax():
    def pairs(p):
        return (p.base, p.concept, p.is_nsfw)
    concepts = ["white", "under a tree", "painting", "naked", "nudity",
                "gender", "memorize", "memorize_3", "violence", "chain saw",
                "gas pump", "tench", "Van Gogh"]
    for c in concepts + ["church"]:
        assert (pairs(prompts.concept_prompts(c))
                == pairs(jprompts.concept_prompts(c))), c
        assert (pairs(prompts.concept_prompts(c, subjects=["cat", "tree"]))
                == pairs(jprompts.concept_prompts(c, subjects=["cat", "tree"]))), c
    assert (pairs(prompts.concept_prompts("memorize", captions=["x y"]))
            == pairs(jprompts.concept_prompts("memorize", captions=["x y"])))
    for c in ("Van Gogh", "naked", "nudity", "Monet"):
        assert (pairs(prompts.validation_prompts(c))
                == pairs(jprompts.validation_prompts(c))), c
    for fn, args in (("memorized_captions", ()), ("memorized_captions", (4,)),
                     ("non_memorized_captions", ()), ("i2p_prompts", ()),
                     ("artist_names", (100, 2)), ("artist_names", (5,)),
                     ("artist_names", (1,)), ("professions", ("female",)),
                     ("professions", ()), ("erasing_objects", ())):
        assert (getattr(prompts, fn)(*args)
                == getattr(jprompts, fn)(*args)), (fn, args)


def test_datasets_copy_is_byte_equal_to_the_original():
    src, dst = jprompts.DATASETS_DIR, prompts.DATASETS_DIR
    assert os.path.realpath(src) != os.path.realpath(dst)
    assert "diffusion_models_moe_tpu_torch" in dst
    names = sorted(os.listdir(src))
    assert names == sorted(os.listdir(dst)) and len(names) == 72
    _, mismatch, errors = filecmp.cmpfiles(src, dst, names, shallow=False)
    assert not mismatch and not errors


def test_combine_prompt_datasets_equals_jax(tmp_path):
    art = tmp_path / "artwork.csv"
    art.write_text("case_number,prompt,evaluation_seed,artist\n"
                   "0,a painting,42,Van Gogh\n1,a sketch,7,Monet\n")
    i2p = tmp_path / "i2p.txt"
    i2p.write_text("bad prompt one\n\nbad prompt two\n")
    n = prompts.combine_prompt_datasets(str(art), str(i2p),
                                        str(tmp_path / "port.csv"))
    assert n == jprompts.combine_prompt_datasets(str(art), str(i2p),
                                                 str(tmp_path / "jax.csv"))
    assert filecmp.cmp(tmp_path / "port.csv", tmp_path / "jax.csv",
                       shallow=False)


def test_operating_points_equal_jax():
    for table in ("WANDA_SKILL_RATIOS_BAKE", "WANDA_SKILL_RATIOS_EVAL",
                  "UNION_SELECT_RATIOS", "BAKED_CHECKPOINT_RATIOS",
                  "MEMORIZED_TRIGGER_PROMPTS", "UCE_MODEL_FILES"):
        assert getattr(operating_points, table) == getattr(jop, table), table
    for c in ("Parachute", "parachute", "PARACHUTE", "van gogh", "nope"):
        for flow in ("bake", "eval"):
            assert (operating_points.wanda_skill_ratio(c, flow, 0.5)
                    == jop.wanda_skill_ratio(c, flow, 0.5))
        assert (operating_points.union_select_ratio(c)
                == jop.union_select_ratio(c))
        assert (operating_points.baked_checkpoint_ratio(c, 0.1)
                == jop.baked_checkpoint_ratio(c, 0.1))
    with pytest.raises(ValueError):
        operating_points.wanda_skill_ratio("naked", "other")


def test_coco_sampling_and_prompt_csv_equal_jax(tmp_path):
    ann = {"images": [{"id": i, "file_name": f"im{i}.jpg"} for i in range(7)],
           "annotations": [{"image_id": i % 7, "caption": f" cap {i} "}
                           for i in range(30)]}
    (tmp_path / "annotations").mkdir()
    (tmp_path / "annotations" / "captions_val2014.json").write_text(
        json.dumps(ann))
    for n, seed in ((10, 0), (50, 3)):
        assert (coco.coco_dataset(str(tmp_path), n, seed)
                == jcoco.coco_dataset(str(tmp_path), n, seed))
    csv = tmp_path / "p.csv"
    csv.write_text("prompt,evaluation_seed\na cat,3\na dog,\nx,4.0\n")
    assert coco.load_prompt_csv(str(csv)) == jcoco.load_prompt_csv(str(csv))


def test_bounding_boxes_equal_jax():
    for reply in ("<box>(100,200),(600,900)</box>", "at (10, 20), (30, 40)",
                  "no box"):
        assert bb.parse_box(reply) == jbb.parse_box(reply)
    box = bb.parse_box("<box>(100,200),(600,900)</box>")
    seq = bb.unet_layer_seq_lens(64)
    assert seq == jbb.unet_layer_seq_lens(64)
    ivs = bb.boxes_to_interventions(box, seq, device="cpu")
    ref = jbb.boxes_to_interventions(box, seq)
    for iv, r in zip(ivs, ref):
        assert iv.token_mask.dtype == torch.bool
        np.testing.assert_array_equal(iv.token_mask.numpy(),
                                      np.asarray(r.token_mask))
    with pytest.raises(ValueError):
        bb.layer_token_mask(box, 1000)

    def ground(image, prompt):
        return "(100,200),(600,900)" if prompt.endswith("cat") else "none"

    got = bb.make_grounded_masks(ground, None, "cat", [64, 256], device="cpu")
    ref = jbb.make_grounded_masks(ground, None, "cat", [64, 256])
    for iv, r in zip(got, ref):
        np.testing.assert_array_equal(iv.token_mask.numpy(),
                                      np.asarray(r.token_mask))
    assert bb.make_grounded_masks(ground, None, "dog", [64], device="cpu") is None

    class Chat:
        def chat(self, image, turns):
            return [t.upper() for t in turns]
    assert (bb.make_chat_grounder(Chat())(None, "frame it")
            == jbb.make_chat_grounder(Chat())(None, "frame it"))


def test_plots_and_census_equal_jax(tmp_path):
    """The figures are written (matplotlib), the image grid is the same PNG,
    the averages and the UNet parameter census (the port's state dict
    against the JAX params tree of the same weights) are equal."""
    rng = np.random.RandomState(0)
    freq = {l: rng.rand(3, 8) for l in range(16)}
    plots.plot_expert_frequency(freq, str(tmp_path / "f1.png"), timestep=1)
    plots.plot_sparsity({str(l): rng.rand(5) for l in range(4)},
                        str(tmp_path / "s.png"))
    plots.plot_metric_vs_threshold([(0.1, 3.0), (0.05, 2.0)],
                                   str(tmp_path / "t.png"))
    plots.plot_metric_vs_confidence({"a": [(0.1, 3.0), (0.05, 2.0)]},
                                    str(tmp_path / "c.png"), title="x")
    for name in ("f1", "s", "t", "c"):
        assert (tmp_path / f"{name}.png").stat().st_size > 1000, name
    imgs = [rng.rand(8, 8, 3), (rng.rand(6, 5) * 255).astype(np.uint8),
            (rng.rand(8, 4, 4) * 255).astype(np.uint8)]
    plots.image_grid(imgs, str(tmp_path / "g_port.png"), n_cols=2)
    jplots.image_grid(imgs, str(tmp_path / "g_jax.png"), n_cols=2)
    assert filecmp.cmp(tmp_path / "g_port.png", tmp_path / "g_jax.png",
                       shallow=False)
    results = [{"a": 0.9, "b": 0.3}, {"a": 0.2, "b": 0.8}]
    assert plots.average_results(results) == jplots.average_results(results)
    params, pipe = tp.pipelines(jcfg.tiny_config())
    assert (plots.unet_parameter_census(pipe.unet.state_dict())
            == jplots.unet_parameter_census(params["unet"]))


def test_to_uint8_rgb_equals_jax():
    rng = np.random.RandomState(0)
    for img in (rng.rand(4, 5) * 300, rng.rand(4, 5, 4) * 255,
                (rng.rand(4, 5, 3) * 255).astype(np.uint8)):
        np.testing.assert_array_equal(imaging.to_uint8_rgb(img),
                                      jimaging.to_uint8_rgb(img))
