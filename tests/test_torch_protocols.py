"""The port's benchmark runners against the JAX package's, on the CPU:
`run_eval` (files, resume-by-skip with baseline backfill, the padded last
batch, per-prompt seeds, `run_summary.json`), every protocol of
`benchmarks/protocols.py`, `benchmarks/art_removal.py` and the helpers of
`benchmarks/object_erase.py`.

Both packages generate through one deterministic stub `generate_fn`: each
image is seeded numpy noise computed from the prompt's ids, the seed (the
JAX key's, the torch generator's, or the prompt's own) and whether the
interventions were passed, so the saved PNGs are compared bit for bit and
no JAX `generate` is compiled. The judges are stubs computed from the
pixels (the port hands them (N, 3, H, W) tensors, JAX (N, H, W, 3) arrays)
and, for I2P, the tiny NudeNet of both packages on the same weights.
Results agree within 1e-5. One port-only `run_eval` on `tiny_config`
shows that a baseline and its erased image share their initial noise.
"""
import json
import os
import sys
import types
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_models_moe_tpu.benchmarks import art_removal as jart
from diffusion_models_moe_tpu.benchmarks import nudity as jnud
from diffusion_models_moe_tpu.benchmarks import object_erase as jobj
from diffusion_models_moe_tpu.benchmarks import protocols as jprot
from diffusion_models_moe_tpu.benchmarks import runner as jrun
from diffusion_models_moe_tpu.benchmarks import vqa as jvqa
from diffusion_models_moe_tpu.imaging import to_uint8_rgb as jto_uint8_rgb
from diffusion_models_moe_tpu.models import yolo as jyolo
from diffusion_models_moe_tpu.weights import port_nudenet as jport
from diffusion_models_moe_tpu_torch import StableDiffusionPipeline, tiny_config
from diffusion_models_moe_tpu_torch.benchmarks import art_removal, nudity
from diffusion_models_moe_tpu_torch.benchmarks import object_erase, protocols
from diffusion_models_moe_tpu_torch.benchmarks import runner, vqa
from diffusion_models_moe_tpu_torch.models import yolo
from diffusion_models_moe_tpu_torch.weights import bridge
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
SIDE = 32
PIPE = types.SimpleNamespace(device="cpu")     # the stub's pipeline


def tokenize(texts):
    """(B, 8) int64 ids from each prompt's crc (numpy: both packages take
    it)."""
    return np.stack([np.random.RandomState(zlib.crc32(t.encode()) % 2 ** 31
                                           ).randint(0, 1000, 8)
                     for t in texts]).astype(np.int64)


def stub_images(ids, seeds, erased: bool) -> np.ndarray:
    out = []
    for row, seed in zip(np.asarray(ids), seeds):
        s = zlib.crc32(row.astype(np.int64).tobytes()) ^ int(seed) ^ (
            977 if erased else 0)
        out.append(np.random.RandomState(s % 2 ** 31).rand(SIDE, SIDE, 3))
    return np.stack(out).astype(np.float32)


def make_generates():
    """(JAX generate_fn, port generate_fn, calls): both record (batch,
    num_steps, guidance, seeds, erased) per call."""
    calls = {"jax": [], "port": []}

    def jgen(params, cond, uncond, key, *, num_steps, guidance_scale,
             mesh=None, seeds=None, ivs=None):
        b = cond.shape[0]
        s = ([int(x) for x in seeds] if seeds is not None
             else [int(np.asarray(key)[-1])] * b)
        calls["jax"].append((b, num_steps, guidance_scale, s, ivs is not None))
        return jnp.asarray(stub_images(cond, s, ivs is not None)), None

    def pgen(cond, uncond, generator, *, num_steps, guidance_scale,
             seeds=None, ivs=None):
        b = cond.shape[0]
        s = (list(seeds) if seeds is not None
             else [generator.initial_seed()] * b)
        calls["port"].append((b, num_steps, guidance_scale, s,
                              ivs is not None))
        imgs = torch.from_numpy(stub_images(cond.numpy(), s, ivs is not None))
        return imgs.permute(0, 3, 1, 2), None

    return jgen, pgen, calls


def pngs(d: str) -> dict:
    return {f: np.asarray(Image.open(os.path.join(d, f)))
            for f in sorted(os.listdir(d)) if f.endswith(".png")}


def same_pngs(a: str, b: str) -> None:
    pa, pb = pngs(a), pngs(b)
    assert pa.keys() == pb.keys() and pa
    for f in pa:
        np.testing.assert_array_equal(pa[f], pb[f], err_msg=f)


def both_run_eval(tmp_path, prompts, **cfg):
    jgen, pgen, calls = make_generates()
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jsum = jrun.run_eval(None, None, tokenize, prompts,
                         jrun.EvalRunConfig(out_dir=jdir, **cfg),
                         ivs="erase", generate_fn=jgen)
    psum = runner.run_eval(PIPE, tokenize, prompts,
                           runner.EvalRunConfig(out_dir=pdir, **cfg),
                           ivs="erase", generate_fn=pgen)
    return jdir, pdir, jsum, psum, calls, (jgen, pgen)


def _no_dir(summary):
    return {k: v for k, v in summary.items() if k != "out_dir"}


def test_run_eval_matches_jax(tmp_path):
    """5 prompts in batches of 2 (the last padded with its last prompt):
    the same sd_/removed_ PNGs bit for bit, the same calls and summaries;
    then a rerun skips everything, and one with a deleted baseline backfills
    its batch, in both packages."""
    prompts = [f"a photo of thing {i}" for i in range(5)]
    jdir, pdir, jsum, psum, calls, (jgen, pgen) = both_run_eval(
        tmp_path, prompts, batch_size=2, num_steps=7, guidance_scale=3.0,
        seed=11)
    same_pngs(jdir, pdir)
    assert calls["jax"] == calls["port"]
    assert [c[0] for c in calls["port"]] == [2] * 6
    assert _no_dir(jsum) == _no_dir(psum) == {"n_prompts": 5, "generated": 5,
                                              "skipped": 0}
    with open(os.path.join(pdir, "run_summary.json")) as f:
        assert json.load(f) == psum
    # erased and baseline differ, baselines hold the stub's seed-11 images
    np.testing.assert_array_equal(
        pngs(pdir)["sd_0.png"],
        np.round(stub_images(tokenize(prompts[:1]), [11], False)[0] * 255))
    for d, fn, mod in ((jdir, jgen, jrun), (pdir, pgen, runner)):
        args = (None, None) if mod is jrun else (PIPE,)
        again = mod.run_eval(*args, tokenize, prompts, mod.EvalRunConfig(
            out_dir=d, batch_size=2, num_steps=7, seed=11), ivs="erase",
            generate_fn=fn)
        assert (again["generated"], again["skipped"]) == (0, 5)
        os.remove(os.path.join(d, "sd_3.png"))
        again = mod.run_eval(*args, tokenize, prompts, mod.EvalRunConfig(
            out_dir=d, batch_size=2, num_steps=7, seed=11), ivs="erase",
            generate_fn=fn)
        assert (again["generated"], again["skipped"]) == (2, 3)
    same_pngs(jdir, pdir)
    assert calls["jax"] == calls["port"]


def test_per_prompt_seeds_match_jax(tmp_path):
    """One seed a prompt through `generate(seeds=)`, the padded slot
    repeating the last; no baseline saved."""
    prompts = ["a cat", "a dog", "a car"]
    jdir, pdir, jsum, psum, calls, _ = both_run_eval(
        tmp_path, prompts, batch_size=2, num_steps=3,
        per_prompt_seeds=[5, 6, 7], save_baseline=False)
    same_pngs(jdir, pdir)
    assert calls["jax"] == calls["port"]
    assert [c[3] for c in calls["port"]] == [[5, 6], [7, 7]]
    assert [c[4] for c in calls["port"]] == [True, True]
    assert not any(f.startswith("sd_") for f in os.listdir(pdir))


@pytest.fixture(scope="module")
def detectors():
    """The tiny NudeNet of both packages on the same seeded weights; JAX's
    gets uint8 images back from the [0, 1] floats its protocol hands it."""
    jcfg_, cfg = jyolo.tiny_yolo_config(), yolo.tiny_yolo_config()
    rng = np.random.RandomState(0)
    fused = {}
    for name, (cout, cin, k, _) in yolo.conv_shapes(cfg).items():
        fused[f"{name}.weight"] = (rng.randn(cout, cin, k, k) * (
            2.0 / (cin * k * k)) ** 0.5).astype(np.float32)
        fused[f"{name}.bias"] = (0.1 * rng.randn(cout)).astype(np.float32)
    params = jport.port_yolo_from_torch(fused, jcfg_)
    model = yolo.YOLOv8(cfg, device="cpu")
    model.load_state_dict(bridge.to_torch(bridge.yolo_numpy_state_dict(params)))
    labels = ["FEMALE_BREAST_EXPOSED", "FEET_EXPOSED", "FACE_MALE"]
    det = nudity.make_native_detector(model, labels=labels)
    jdet = jnud.make_native_detector(params, jcfg_, labels=labels,
                                     batch_size=4)

    def jdet_uint8(images):
        return jdet([np.round(np.asarray(i) * 255).astype(np.uint8)
                     for i in images])
    return det, jdet_uint8


def test_i2p_protocol_matches_jax(tmp_path, detectors):
    det, jdet = detectors
    jgen, pgen, calls = make_generates()
    jres = jprot.i2p_protocol(None, None, tokenize, str(tmp_path / "jax"),
                              jdet, ivs="erase", limit=5, num_steps=2,
                              batch_size=4, generate_fn=jgen)
    pres = protocols.i2p_protocol(PIPE, tokenize, str(tmp_path / "port"),
                                  det, ivs="erase", limit=5, num_steps=2,
                                  batch_size=4, generate_fn=pgen)
    same_pngs(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert pres == jres and pres["n_prompts"] == 5
    assert pres["total_exposed_labels"] > 0
    with open(tmp_path / "port" / "i2p_results.json") as f:
        assert json.load(f) == pres


def test_i2p_detector_inputs_jax_floats_port_uint8(tmp_path):
    """What each package's `i2p_protocol` hands its detector, pinned down:
    JAX's gives the PNGs as float32 in [0, 1], which its own `letterbox`
    (through `imaging.to_uint8_rgb`) truncates to 0s and 1s; the port's
    gives the PNGs' uint8 pixels, equal to JAX's floats times 255."""
    jgen, pgen, _ = make_generates()
    seen = {"jax": [], "port": []}

    def recorder(key):
        def detect(images):
            seen[key].extend(np.asarray(i) for i in images)
            return [[] for _ in images]
        return detect

    jprot.i2p_protocol(None, None, tokenize, str(tmp_path / "jax"),
                       recorder("jax"), ivs="erase", limit=3, num_steps=2,
                       batch_size=4, generate_fn=jgen)
    protocols.i2p_protocol(PIPE, tokenize, str(tmp_path / "port"),
                           recorder("port"), ivs="erase", limit=3,
                           num_steps=2, batch_size=4, generate_fn=pgen)
    assert len(seen["jax"]) == len(seen["port"]) == 3
    for jimg, pimg in zip(seen["jax"], seen["port"]):
        assert jimg.dtype == np.float32 and 0 <= jimg.min() <= jimg.max() <= 1
        assert set(np.unique(jto_uint8_rgb(jimg))) <= {0, 1}
        assert pimg.dtype == np.uint8 and pimg.max() > 1
        np.testing.assert_array_equal(
            pimg, np.round(jimg * 255).astype(np.uint8))


def _stub_module(monkeypatch, name: str, **attrs) -> types.ModuleType:
    mod = types.ModuleType(name)
    for k, v in attrs.items():
        setattr(mod, k, v)
    monkeypatch.setitem(sys.modules, name, mod)
    return mod


class _StubNudeDetector:
    """The nudenet package's `NudeDetector` surface: records how it was
    built and detects from the pixels."""
    built = []

    def __init__(self, model_path=None, providers=None):
        self.built.append({"model_path": model_path, "providers": providers})

    def detect(self, img):
        m = float(np.asarray(img, np.float64).mean())
        return [{"class": "FEET_EXPOSED", "score": m / 255.0,
                 "box": [0, 0, 1, 1]},
                {"class": "FACE_MALE", "score": 1 - m / 255.0,
                 "box": [1, 1, 2, 2]}]


def _stub_nudenet(monkeypatch, providers=("CPUExecutionProvider",)):
    _StubNudeDetector.built = []
    _stub_module(monkeypatch, "nudenet", NudeDetector=_StubNudeDetector)
    _stub_module(monkeypatch, "onnxruntime",
                 get_available_providers=lambda: list(providers))


def _stub_transformers(monkeypatch) -> list:
    """A `transformers` module whose pipeline records how it was built and
    echoes the question before its answer (the belt-and-braces path)."""
    built = []

    def pipeline(task, model=None, device=None):
        built.append({"task": task, "model": model, "device": device})

        def run(images=None, text=None, max_new_tokens=None,
                return_full_text=True):
            m = float(np.asarray(images, np.float64).mean())
            return [{"generated_text": f"{text} {'Yes' if m > 0.5 else 'No'}"
                     f", max {max_new_tokens}"}]
        return run

    _stub_module(monkeypatch, "transformers", pipeline=pipeline)
    return built


def _stub_torchvision(monkeypatch) -> None:
    models = types.ModuleType("torchvision.models")
    models.resnet50 = lambda: torch.nn.Flatten()
    _stub_module(monkeypatch, "torchvision", models=models)
    monkeypatch.setitem(sys.modules, "torchvision.models", models)


@pytest.mark.parametrize("entry", ["nudenet_native", "native_detector",
                                   "nudenet_package", "llava_native",
                                   "transformers_vqa", "resnet_classifier",
                                   "torchvision_classifier"])
def test_entry_points_default_to_the_card(entry, tmp_path, monkeypatch):
    """This slice's judge entry points run on the card unless the caller
    asks for the CPU: with no CUDA device the default raises before any
    file is read, even where the optional package is present (stubs
    here), and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    _stub_nudenet(monkeypatch, ("CUDAExecutionProvider",
                                "CPUExecutionProvider"))
    built = _stub_transformers(monkeypatch)
    _stub_torchvision(monkeypatch)
    path = str(tmp_path / "none")
    calls = {
        "nudenet_native": lambda: nudity.load_nudenet_native(path),
        "native_detector": lambda: nudity.make_native_detector({}),
        "nudenet_package": lambda: nudity.load_nudenet(),
        "llava_native": lambda: vqa.load_llava_native(path, size="7b"),
        "transformers_vqa": lambda: vqa.load_transformers_vqa(path),
        "resnet_classifier": lambda: object_erase.make_resnet_classifier(
            path),
        "torchvision_classifier": lambda:
            object_erase.load_torchvision_classifier(),
    }
    with pytest.raises(RuntimeError, match="no CUDA device is present"):
        calls[entry]()
    assert not built and not _StubNudeDetector.built


def test_transformers_vqa_runs_where_asked_and_matches_jax(monkeypatch):
    """`load_transformers_vqa` through an installed transformers (a stub
    module here): the asked device reaches the pipeline, and the answers
    (the echoed question stripped) equal JAX's loader's."""
    built = _stub_transformers(monkeypatch)
    port = vqa.load_transformers_vqa("snap", device="cpu")
    ref = jvqa.load_transformers_vqa("snap")
    assert built[0] == {"task": "image-text-to-text", "model": "snap",
                        "device": torch.device("cpu")}
    assert built[1]["device"] == -1              # JAX's: the host
    q = jvqa.object_question("cat")
    for img in (np.zeros((8, 8, 3), np.float32),
                np.ones((8, 8, 3), np.float32)):
        assert port(img, q) == ref(img, q)
    assert port(np.ones((8, 8, 3), np.float32), q) == " Yes, max 32"


def test_nudenet_package_runs_where_asked_and_matches_jax(monkeypatch):
    """`load_nudenet` through an installed nudenet (a stub module here):
    onnxruntime gets the asked device's provider, an onnxruntime without it
    is refused, and the detections equal JAX's loader's."""
    _stub_nudenet(monkeypatch)
    imgs = [np.full((16, 16, 3), v, np.uint8) for v in (30, 200)]
    port = nudity.load_nudenet("nn.onnx", device="cpu")
    ref = jnud.load_nudenet("nn.onnx")
    assert _StubNudeDetector.built[0] == {
        "model_path": "nn.onnx", "providers": [("CPUExecutionProvider", {})]}
    assert port(imgs) == ref(imgs)
    assert nudity.count_harmful(port(imgs)) == jnud.count_harmful(ref(imgs))
    _stub_nudenet(monkeypatch, ("CUDAExecutionProvider",))
    with pytest.raises(RuntimeError, match="CPUExecutionProvider"):
        nudity.load_nudenet(device="cpu")


def _nhwc(images) -> np.ndarray:
    """What the JAX judges get, from what the port's get."""
    if isinstance(images, torch.Tensor):
        return images.permute(0, 2, 3, 1).numpy()
    return np.asarray(images)


def embed(images) -> np.ndarray:
    x = _nhwc(images)
    return x.reshape(len(x), -1)[:, ::97][:, :16].astype(np.float64)


def test_memorization_protocol_matches_jax(tmp_path):
    jgen, pgen, _ = make_generates()
    jres = jprot.memorization_protocol(None, None, tokenize,
                                       str(tmp_path / "jax"), embed, split=0,
                                       ivs="erase", limit=3, num_steps=2,
                                       batch_size=2, generate_fn=jgen)
    pres = protocols.memorization_protocol(PIPE, tokenize,
                                           str(tmp_path / "port"), embed,
                                           split=0, ivs="erase", limit=3,
                                           num_steps=2, batch_size=2,
                                           generate_fn=pgen)
    same_pngs(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert pres.keys() == jres.keys() and pres["n_prompts"] == 3
    np.testing.assert_allclose(pres["per_prompt"], jres["per_prompt"],
                               rtol=TOL)
    assert abs(pres["mean_similarity"] - jres["mean_similarity"]) <= TOL


def classify(images) -> np.ndarray:
    x = _nhwc(images)
    feats = x.reshape(len(x), -1)
    w = np.random.RandomState(3).randn(feats.shape[1], 10)
    return feats @ w


def test_object_erasure_protocol_matches_jax(tmp_path):
    jgen, pgen, _ = make_generates()
    kw = dict(target="church", ivs="erase", limit=2, num_steps=2,
              batch_size=2)
    jres = jprot.object_erasure_protocol(None, None, tokenize,
                                         str(tmp_path / "jax"), classify,
                                         generate_fn=jgen, **kw)
    pres = protocols.object_erasure_protocol(PIPE, tokenize,
                                             str(tmp_path / "port"), classify,
                                             generate_fn=pgen, **kw)
    for sub in ("erase", "keep"):
        same_pngs(str(tmp_path / "jax" / sub), str(tmp_path / "port" / sub))
    assert pres == jres


def featurize(images) -> np.ndarray:
    x = _nhwc(images)
    return x.reshape(len(x), -1)[:, ::53][:, :16].astype(np.float64)


def text_featurize(prompts) -> np.ndarray:
    return np.stack([np.random.RandomState(zlib.crc32(p.encode()) % 2 ** 31
                                           ).randn(16) for p in prompts])


def test_artist_removal_protocol_matches_jax(tmp_path):
    jgen, pgen, _ = make_generates()
    kw = dict(n_artists=100, part=1, ivs="erase", limit=3, num_steps=2,
              batch_size=2, seed=4, text_featurize=text_featurize)
    jres = jprot.artist_removal_protocol(None, None, tokenize,
                                         str(tmp_path / "jax"), featurize,
                                         generate_fn=jgen, **kw)
    pres = protocols.artist_removal_protocol(PIPE, tokenize,
                                             str(tmp_path / "port"), featurize,
                                             generate_fn=pgen, **kw)
    same_pngs(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert pres["n_artists"] == jres["n_artists"] == 3
    assert pres["removal_accuracy"] == jres["removal_accuracy"]
    assert abs(pres["mean_similarity"] - jres["mean_similarity"]) <= TOL


def test_clip_sim_sweep_and_iqa_match_jax(tmp_path):
    """The confidence sweep over seeded per-conf image folders, and the
    CLIP-IQA report with stub towers, as in JAX."""
    base = ["a dog", "a house", "a tree"]
    rng = np.random.RandomState(8)
    confs = (0.2, 0.05)
    for conf in confs:
        d = tmp_path / f"dof_2_conf_{conf}"
        d.mkdir()
        for i in range(len(base)):
            Image.fromarray((rng.rand(SIDE, SIDE, 3) * 255).astype(np.uint8)
                            ).save(d / f"img_{i}_adj.jpg", quality=95)
    template = str(tmp_path / "%s")
    jres = jprot.clip_sim_confidence_sweep(template, base, featurize,
                                           text_featurize, "Van Gogh",
                                           conf_int=confs)
    pres = protocols.clip_sim_confidence_sweep(
        template, base, featurize, text_featurize, "Van Gogh",
        conf_int=confs, out_path=str(tmp_path / "sweep.json"))
    for key in ("mean", "mean_adj"):
        for c in confs:
            assert abs(pres[key][c] - jres[key][c]) <= TOL
    assert os.path.exists(tmp_path / "sweep.json")

    def img_feat(images):
        return torch.as_tensor(featurize(images))

    imgs = [rng.rand(3, SIDE, SIDE).astype(np.float32) for _ in range(3)]
    jimgs = [i.transpose(1, 2, 0) for i in imgs]
    pres = protocols.clip_iqa_protocol(
        [torch.from_numpy(i) for i in imgs], imgs, imgs[::-1], img_feat,
        lambda t: torch.as_tensor(text_featurize(t)), "Van Gogh",
        out_dir=str(tmp_path))
    jres = jprot.clip_iqa_protocol(jimgs, jimgs, jimgs[::-1], featurize,
                                   text_featurize, "Van Gogh")
    for split in jres:
        for name, v in jres[split].items():
            assert abs(pres[split][name] - v) <= TOL, (split, name)


def test_art_removal_score_protocol_matches_jax(tmp_path):
    labels = ["vincent-van-gogh", "claude-monet", "rembrandt", "other"]

    def ranked(images):
        logits = _nhwc(images).reshape(len(images), -1)[:, :4]
        return [[labels[j] for j in np.argsort(-row)] for row in logits]

    rng = np.random.RandomState(9)
    for root in ("jax", "port"):
        for concept in ("Van Gogh", "Monet"):
            d = tmp_path / root / concept
            d.mkdir(parents=True)
    for concept in ("Van Gogh", "Monet"):
        for i in range(3):
            for prefix in ("sd", "removed"):
                img = Image.fromarray((rng.rand(SIDE, SIDE, 3) * 255).astype(
                    np.uint8))
                for root in ("jax", "port"):
                    img.save(tmp_path / root / concept / f"{prefix}_{i}.png")
    jres = jart.art_removal_score_protocol(str(tmp_path / "jax"), ranked,
                                           featurize)
    pres = art_removal.art_removal_score_protocol(str(tmp_path / "port"),
                                                  ranked, featurize)
    assert abs(pres["all_acc_mean"] - jres["all_acc_mean"]) <= TOL
    assert abs(pres["all_sim_mean"] - jres["all_sim_mean"]) <= TOL
    for concept, r in jres["concepts"].items():
        assert pres["concepts"][concept]["acc"] == r["acc"]
        np.testing.assert_allclose(pres["concepts"][concept]["sim"], r["sim"],
                                   rtol=TOL)
    embs = text_featurize(labels)
    rank = art_removal.make_zero_shot_style_ranker(featurize, embs, labels)
    jrank = jart.make_zero_shot_style_ranker(featurize, embs, labels)
    x = rng.rand(2, SIDE, SIDE, 3).astype(np.float32)
    assert rank(torch.from_numpy(x).permute(0, 3, 1, 2)) == jrank(x)


def test_object_erase_helpers_match_jax(tmp_path):
    rng = np.random.RandomState(10)
    logits = rng.randn(6, 10)
    labels = rng.randint(0, 10, 6)
    for k in (1, 5):
        assert object_erase.topk_accuracy(torch.from_numpy(logits), labels,
                                          k) == jobj.topk_accuracy(logits,
                                                                   labels, k)
    cats = ["tench", "French horn", "church", "golf ball", "parachute",
            "garbage truck", "gas pump", "chain saw", "cassette player",
            "english springer"]
    names = [cats[i].lower() for i in labels]
    assert object_erase.word_match_accuracy(logits, cats, names) == \
        jobj.word_match_accuracy(logits, cats, names)
    assert object_erase.erase_keep_prompts("church", per_class=2) == \
        jobj.erase_keep_prompts("church", per_class=2)
    embs = rng.randn(10, 16)
    clf = object_erase.make_clip_zero_shot_classifier(
        lambda x: torch.as_tensor(featurize(x)), torch.from_numpy(embs))
    jclf = jobj.make_clip_zero_shot_classifier(featurize, embs)
    x = rng.rand(2, SIDE, SIDE, 3).astype(np.float32)
    np.testing.assert_allclose(clf(torch.from_numpy(x).permute(0, 3, 1, 2)),
                               jclf(x), rtol=TOL)


def test_resnet_classifier_on_the_ports_backbone(tmp_path):
    """`make_resnet_classifier` reads a torchvision-layout .npz into the
    port's ResNet-50 on the CPU and gives `resnet_logits` of the
    ImageNet-normalized images, in chunks; torchvision's own judge needs
    that package."""
    from diffusion_models_moe_tpu_torch.models.backbones import (
        ResNet, preprocess_imagenet, resnet50_config, resnet_logits)
    model = ResNet(resnet50_config(5), device="cpu")
    path = str(tmp_path / "r50.npz")
    np.savez(path, **{k: v.numpy() for k, v in model.state_dict().items()})
    clf = object_erase.make_resnet_classifier(path, num_classes=5, batch=2,
                                              device="cpu")
    x = torch.rand(3, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    ref = resnet_logits(model, preprocess_imagenet(x)).numpy()
    np.testing.assert_allclose(clf(x), ref, rtol=1e-5, atol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            object_erase.make_resnet_classifier(path, num_classes=5)
    try:
        import torchvision  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            object_erase.load_torchvision_classifier(device="cpu")


def test_run_eval_pairs_share_noise_on_the_tiny_pipeline(tmp_path):
    """The port's real pipeline (tiny_config, CPU, 2 PNDM steps): with no
    interventions a baseline and its 'erased' image are bit-equal (each
    call's generator is seeded anew with cfg.seed); with a neuron removal
    they differ."""
    from diffusion_models_moe_tpu_torch.data.tokenize import hash_tokenize
    from diffusion_models_moe_tpu_torch.erasure.masks import \
        neuron_removal_interventions
    cfg = tiny_config()
    pipe = StableDiffusionPipeline(cfg, device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    tok = hash_tokenize(cfg.text_encoder.vocab_size,
                        cfg.text_encoder.max_length)
    run_cfg = dict(batch_size=1, num_steps=2, seed=3)
    same = str(tmp_path / "same")
    runner.run_eval(pipe, tok, ["a dog"], runner.EvalRunConfig(
        out_dir=same, **run_cfg), ivs=None)
    p = pngs(same)
    np.testing.assert_array_equal(p["sd_0.png"], p["removed_0.png"])
    masks = {l: np.random.RandomState(l).rand(2, 4 * d) < 0.5
             for l, d in enumerate(cfg.unet.ff_dims())}
    erased = str(tmp_path / "erased")
    runner.run_eval(pipe, tok, ["a dog"], runner.EvalRunConfig(
        out_dir=erased, **run_cfg),
        ivs=neuron_removal_interventions(masks, device="cpu"))
    q = pngs(erased)
    np.testing.assert_array_equal(q["sd_0.png"], p["sd_0.png"])
    assert not np.array_equal(q["sd_0.png"], q["removed_0.png"])
