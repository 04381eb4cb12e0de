"""The port's debias and unified-editing protocols and its baseline
registry against the JAX package's, on the CPU: `debias_eval` and
`generate_profession_sweep`, `ConceptBank.route` and
`unified_editing_eval` (routes, files, results, one intervention set per
fired combination), `BASELINES`, `load_baseline` (the `config=` override,
an edited UNet, a Concept-Ablation delta, SLD, SD2, the `ValueError`s),
`baseline_generate` and `make_protocol_generate`.

Both packages generate through one deterministic stub, as
`tests/test_torch_protocols.py` does: each image is seeded numpy noise from
the prompt's ids, the seed (the JAX key's or the torch generator's) and the
interventions (how many output weights their masks remove, the same count
in JAX's (H, D) and the port's (D, H) orientation), so the PNGs compare bit
for bit and no JAX `generate` is compiled. `load_baseline` reads one tiny
snapshot, a `.pt` UNet and a `delta.bin` the test writes, in both packages;
JAX's weights come back through the bridge bit for bit. One port-only run
goes through the real `sld_generate` at `tiny_config`.
"""
import dataclasses
import json
import os
import types
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from test_torch_weights_io import _tiny_snapshot
from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu.benchmarks import baselines as jbase
from diffusion_models_moe_tpu.benchmarks import clip_metrics as jclip
from diffusion_models_moe_tpu.benchmarks import debias as jdeb
from diffusion_models_moe_tpu.benchmarks import runner as jrun
from diffusion_models_moe_tpu.benchmarks import unified_editing as juni
from diffusion_models_moe_tpu.pipelines import sld as jsld
from diffusion_models_moe_tpu_torch import StableDiffusionPipeline, tiny_config
from diffusion_models_moe_tpu_torch.benchmarks import baselines, clip_metrics
from diffusion_models_moe_tpu_torch.benchmarks import debias, runner
from diffusion_models_moe_tpu_torch.benchmarks import unified_editing
from diffusion_models_moe_tpu_torch.data.tokenize import hash_tokenize
from diffusion_models_moe_tpu_torch.pipelines import sld
from diffusion_models_moe_tpu_torch.weights import bridge

SIDE = 16


def tokenize(texts):
    """(B, 8) int64 ids from each prompt's crc (numpy: both packages take
    it)."""
    return np.stack([np.random.RandomState(zlib.crc32(t.encode()) % 2 ** 31
                                           ).randint(0, 1000, 8)
                     for t in texts]).astype(np.int64)


def removed(ivs) -> int:
    """Output weights the interventions' masks remove (0 without)."""
    if ivs is None:
        return 0
    return int(sum(np.asarray(iv.out_weight_mask).sum()
                   for iv in ivs if iv is not None))


def stub_images(ids, seeds, n_removed: int) -> np.ndarray:
    out = []
    for row, seed in zip(np.asarray(ids), seeds):
        s = zlib.crc32(row.astype(np.int64).tobytes()) ^ int(seed) ^ (
            977 * n_removed)
        out.append(np.random.RandomState(s % 2 ** 31).rand(SIDE, SIDE, 3))
    return np.stack(out).astype(np.float32)


def stub_pipes():
    """(JAX pipe, port pipe, calls): both record (batch, num_steps, seed,
    removed) per generate."""
    calls = {"jax": [], "port": []}

    def jgen(params, cond, uncond, key, *, num_steps, ivs=None, **kw):
        seed = int(np.asarray(key)[-1])
        calls["jax"].append((cond.shape[0], num_steps, seed, removed(ivs)))
        return jnp.asarray(stub_images(cond, [seed] * cond.shape[0],
                                       removed(ivs))), None

    def pgen(cond, uncond, generator, *, num_steps, ivs=None, **kw):
        seed = generator.initial_seed()
        calls["port"].append((cond.shape[0], num_steps, seed, removed(ivs)))
        imgs = stub_images(cond.numpy(), [seed] * cond.shape[0], removed(ivs))
        return torch.from_numpy(imgs).permute(0, 3, 1, 2), None

    return (types.SimpleNamespace(generate=jgen),
            types.SimpleNamespace(generate=pgen, device="cpu"), calls)


def pngs(d: str) -> dict:
    return {f: np.asarray(Image.open(os.path.join(d, f)))
            for f in sorted(os.listdir(d)) if f.endswith(".png")}


def same_pngs(a: str, b: str) -> None:
    pa, pb = pngs(a), pngs(b)
    assert pa.keys() == pb.keys() and pa
    for f in pa:
        np.testing.assert_array_equal(pa[f], pb[f], err_msg=f)


def wanda_masks(seed: int, layers=(0, 3), d: int = 6, h: int = 10) -> dict:
    rng = np.random.RandomState(seed)
    return {l: rng.rand(d, h) < 0.3 for l in layers}


# ------------------------------------------------------------------ debias
def _encoder(chw: bool):
    """Embeddings from the pixels: per-channel means and the spread; the
    port's images are (N, 3, H, W) tensors, JAX's (N, H, W, 3) arrays."""
    def encode(images):
        x = np.asarray(images, np.float64)
        if chw:
            x = x.transpose(0, 2, 3, 1)
        return np.concatenate([x.mean(axis=(1, 2)), x.std(axis=(1, 2, 3))[:, None]],
                              axis=1).astype(np.float32)
    return encode


def test_debias_eval_matches_jax(tmp_path):
    """Two professions, three seeds, one removal: the same calls (one
    image a seed, before then after), the same summary and JSON file, and
    `generate_profession_sweep`'s PNGs bit for bit."""
    jpipe, ppipe, calls = stub_pipes()
    man = np.asarray([1.0, 0.2, 0.1, 0.5], np.float32)
    woman = np.asarray([0.2, 1.0, 0.4, 0.5], np.float32)
    masks = wanda_masks(1)
    kw = dict(seeds=[31, 32, 33], professions=["doctor", "nurse"],
              num_steps=7)
    ref = jdeb.debias_eval(jpipe, None, tokenize, _encoder(False), man, woman,
                           ivs=_jax_ivs(masks),
                           out_path=str(tmp_path / "jax.json"), **kw)
    got = debias.debias_eval(ppipe, tokenize, _encoder(True),
                             torch.from_numpy(man), torch.from_numpy(woman),
                             ivs=_port_ivs(masks),
                             out_path=str(tmp_path / "port.json"), **kw)
    assert calls["jax"] == calls["port"] and len(calls["port"]) == 12
    assert [c[3] > 0 for c in calls["port"]] == ([False] * 3 + [True] * 3) * 2
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)
    with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
        assert json.load(f) == json.load(g)
    assert set(got["per_profession"]) == {"doctor", "nurse"}
    jdeb.generate_profession_sweep(jpipe, None, tokenize, "chef", [5, 6],
                                   out_dir=str(tmp_path / "jsweep"))
    imgs = debias.generate_profession_sweep(ppipe, tokenize, "chef", [5, 6],
                                            out_dir=str(tmp_path / "psweep"))
    assert len(imgs) == 2 and imgs[0].shape == (3, SIDE, SIDE)
    same_pngs(str(tmp_path / "jsweep"), str(tmp_path / "psweep"))


def _jax_ivs(masks):
    from diffusion_models_moe_tpu.erasure.masks import \
        wanda_removal_interventions
    return wanda_removal_interventions(masks)


def _port_ivs(masks):
    from diffusion_models_moe_tpu_torch.erasure.masks import \
        wanda_removal_interventions
    return wanda_removal_interventions(masks, device="cpu")


# ---------------------------------------------------------- unified editing
PROMPTS = ["a painting by Van Gogh", "a nude figure", "a red car",
           "a starry night in the style of Van Gogh", "a dog",
           "Mona Lisa by Leonardo"]


def _banks():
    """The same bank in both packages: two embedding checkers on seeded
    embeddings and a memorized-prompt checker."""
    rng = np.random.RandomState(4)
    embs = rng.randn(len(PROMPTS), 8).astype(np.float32)
    concept = {"art": (embs[0] + embs[3], rng.randn(8) * 0.1),
               "nudity": (embs[1] * 2, rng.randn(8) * 0.1)}
    memorized = ["Mona Lisa by Leonardo"]
    masks = {"art": wanda_masks(2), "nudity": wanda_masks(3, (1, 3)),
             "memorized": wanda_masks(5, (2,))}
    banks = []
    for mod in (jclip, clip_metrics):
        checkers = {name: mod.ConceptChecker(name, c.astype(np.float32),
                                             a.astype(np.float32), 0.5)
                    for name, (c, a) in concept.items()}
        checkers["memorized"] = mod.MemorizedPromptChecker(memorized)
        banks.append(checkers)
    return (juni.ConceptBank(banks[0], masks),
            unified_editing.ConceptBank(banks[1], masks), embs)


def test_concept_bank_route_matches_jax():
    jbank, bank, embs = _banks()
    routes = bank.route(embs, PROMPTS)
    assert routes == jbank.route(embs, PROMPTS)
    assert () in routes and ("memorized",) in routes
    assert any(len(r) >= 1 for r in routes)
    for b in (jbank, bank):
        with pytest.raises(ValueError, match="memorized"):
            b.route(embs)


def test_unified_editing_eval_matches_jax(tmp_path, monkeypatch):
    """Six prompts, some firing nothing: the same files bit for bit, the
    same results and calls; the port builds one intervention set per fired
    combination."""
    jbank, bank, embs = _banks()
    jpipe, ppipe, calls = stub_pipes()
    ref = juni.unified_editing_eval(jpipe, None, tokenize, PROMPTS, embs,
                                    jbank, str(tmp_path / "jax"),
                                    num_steps=5, seed=3)
    built = []
    real = unified_editing.wanda_removal_interventions

    def counting(masks, **kw):
        built.append(sorted(masks))
        return real(masks, **kw)

    monkeypatch.setattr(unified_editing, "wanda_removal_interventions",
                        counting)
    got = unified_editing.unified_editing_eval(
        ppipe, tokenize, PROMPTS, embs, bank, str(tmp_path / "port"),
        num_steps=5, seed=3)
    assert got == ref
    assert calls["jax"] == calls["port"]
    assert [c[2] for c in calls["port"]] == [3 + i for i in range(6)]
    same_pngs(str(tmp_path / "jax"), str(tmp_path / "port"))
    fired = {tuple(r["concepts"]) for r in got["results"] if r["concepts"]}
    assert len(built) == len(fired)
    assert got["n_routed"] == sum(1 for r in got["results"] if r["concepts"])
    assert any(f.endswith("_none.png") for f in pngs(str(tmp_path / "port")))


# --------------------------------------------------------------- baselines
def test_registry_matches_jax():
    assert baselines.BASELINES.keys() == jbase.BASELINES.keys()
    for name, spec in baselines.BASELINES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            jbase.BASELINES[name]), name


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A tiny diffusers snapshot, a whole edited UNet as `.pt` (prefixed
    `unet.`, fp16 where the publishers store it so) and a Concept-Ablation
    `delta.bin` (part of the UNet, the whole text encoder without its
    `text_model.` prefix), all from seeded weights."""
    root = tmp_path_factory.mktemp("baseline")
    jax_cfg = jcfg.tiny_config()
    params, pipe = tp.pipelines(jax_cfg)
    sds = {k: {n: t.numpy() for n, t in m.state_dict().items()}
           for k, m in pipe.modules().items()}
    _tiny_snapshot(str(root / "snap"), sds, params, jax_cfg)
    rng = np.random.RandomState(9)
    edited = {f"unet.{k}": torch.from_numpy(
        (v * (1 + 0.1 * rng.randn(*v.shape))).astype(np.float32)).half()
        for k, v in sds["unet"].items()}
    torch.save(edited, str(root / "esd.pt"))
    part = {k: torch.from_numpy(v * 1.5) for k, v in sds["unet"].items()
            if "attn2.to_k" in k}
    text = {k[len("text_model."):]: torch.from_numpy(v + 0.01)
            for k, v in sds["text_encoder"].items()}
    torch.save({"unet": part, "text_encoder": text}, str(root / "delta.bin"))
    return str(root), jax_cfg, pipe.config


def _same_weights(pipe, jparams, config) -> None:
    ref = bridge.pipeline_state_dicts(jparams, config)
    for name, module in pipe.modules().items():
        got = module.state_dict()
        assert got.keys() == ref[name].keys(), name
        for k, t in ref[name].items():
            assert torch.equal(got[k], t), (name, k)


@pytest.mark.parametrize("case", ["esd_edited_unet", "concept_ablation_delta",
                                  "sld", "sd2_base", "uce_plain"])
def test_load_baseline_matches_jax(snapshot, case):
    """`load_baseline` with `config=` (tiny) on the test's files: the
    weights JAX's `load_baseline` ports, bit for bit through the bridge, and
    the same generate kwargs."""
    root, jax_cfg, cfg = snapshot
    snap = os.path.join(root, "snap")
    name, kw = {
        "esd_edited_unet": ("esd", {"edited_unet": os.path.join(root,
                                                                "esd.pt")}),
        "concept_ablation_delta": ("concept-ablation", {
            "delta": os.path.join(root, "delta.bin")}),
        "sld": ("sld", {}), "sd2_base": ("sd2-base", {}),
        "uce_plain": ("uce", {}),
    }[case]
    _, jparams, jkw = jbase.load_baseline(name, snap, config=jax_cfg, **kw)
    pipe, got_kw = baselines.load_baseline(name, snap, config=cfg,
                                           device="cpu", **kw)
    assert got_kw == jkw == ({"use_sld": True} if name == "sld" else {})
    assert isinstance(pipe, StableDiffusionPipeline)
    _same_weights(pipe, jparams, cfg)


@pytest.mark.parametrize("name,kw", [
    ("esd", {"edited_unet": "a.pt", "delta": "b.bin"}),
    ("sld", {"edited_unet": "a.pt"}),
    ("sld", {"delta": "b.bin"}),
])
def test_load_baseline_refusals_match_jax(snapshot, name, kw):
    """Both files at once, or a file for a baseline that takes none: the
    same `ValueError` in both packages, before any file is read."""
    root, jax_cfg, cfg = snapshot
    snap = os.path.join(root, "snap")
    with pytest.raises(ValueError) as jerr:
        jbase.load_baseline(name, snap, config=jax_cfg, **kw)
    with pytest.raises(ValueError) as err:
        baselines.load_baseline(name, snap, config=cfg, device="cpu", **kw)
    assert str(err.value) == str(jerr.value)


def _stub_sld(monkeypatch):
    """Deterministic `sld_generate` stubs in both packages recording the
    safety rows they were given."""
    seen = {"jax": [], "port": []}

    def jstub(pipe, params, cond, uncond, safety, key, num_steps=None,
              guidance_scale=None):
        seen["jax"].append((np.asarray(safety).tolist(), num_steps,
                            guidance_scale))
        seed = int(np.asarray(key)[-1])
        return jnp.asarray(stub_images(cond, [seed] * cond.shape[0], 7))

    def pstub(pipe, cond, uncond, safety, generator=None, *, num_steps=None,
              guidance_scale=None, seeds=None, **kw):
        seen["port"].append((safety.tolist(), num_steps, guidance_scale))
        s = (list(seeds) if seeds is not None
             else [generator.initial_seed()] * cond.shape[0])
        return torch.from_numpy(stub_images(cond.numpy(), s, 7)).permute(
            0, 3, 1, 2)

    monkeypatch.setattr(jsld, "sld_generate", jstub)
    monkeypatch.setattr(sld, "sld_generate", pstub)
    return seen


def test_make_protocol_generate_matches_jax(tmp_path, monkeypatch):
    """`run_eval` over 3 prompts in batches of 2 through the SLD baseline's
    generate_fn: the same PNGs and the same safety rows (the tokenized
    safety concept, one a request); None for a stock baseline; `ivs`
    refused by both; `seeds` passed on by the port's (JAX's raises)."""
    seen = _stub_sld(monkeypatch)
    assert baselines.make_protocol_generate(None, {}, tokenize) is None
    assert jbase.make_protocol_generate(None, {}, tokenize) is None
    jgen = jbase.make_protocol_generate("pipe", {"use_sld": True}, tokenize)
    pgen = baselines.make_protocol_generate("pipe", {"use_sld": True},
                                            tokenize)
    prompts = ["a castle", "a violent scene", "a beach"]
    jrun.run_eval(None, None, tokenize, prompts,
                  jrun.EvalRunConfig(out_dir=str(tmp_path / "jax"),
                                     batch_size=2, num_steps=4, seed=5),
                  generate_fn=jgen)
    runner.run_eval(types.SimpleNamespace(device="cpu"), tokenize, prompts,
                    runner.EvalRunConfig(out_dir=str(tmp_path / "port"),
                                         batch_size=2, num_steps=4, seed=5),
                    generate_fn=pgen)
    same_pngs(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert seen["jax"] == seen["port"] and len(seen["port"]) == 4
    row = tokenize([sld.SAFETY_CONCEPT])[0].tolist()
    assert seen["port"][0] == ([row, row], 4, 7.5)
    ids = torch.from_numpy(tokenize(prompts[:2]))
    with pytest.raises(ValueError, match="interventions"):
        pgen(ids, ids, torch.Generator().manual_seed(0), ivs=("x",))
    with pytest.raises(ValueError, match="interventions"):
        jgen(None, ids.numpy(), ids.numpy(), None, ivs=("x",))
    with pytest.raises(ValueError):
        jgen(None, ids.numpy(), ids.numpy(), None, seeds=[1, 2])
    imgs, taps = pgen(ids, ids, None, num_steps=2, seeds=[1, 2])
    assert taps is None and imgs.shape == (2, 3, SIDE, SIDE)


def test_baseline_generate_matches_jax(monkeypatch):
    """The stock path calls `generate`, the SLD path `sld_generate` with
    the safety ids (required: `ValueError` without them, in both)."""
    _stub_sld(monkeypatch)
    jpipe, ppipe, calls = stub_pipes()
    ids = tokenize(["a castle", "a beach"])
    safety = tokenize([sld.SAFETY_CONCEPT])
    key = jnp.asarray([0, 8], jnp.uint32)
    for kwargs in ({}, {"use_sld": True}):
        jimg, _ = jbase.baseline_generate(jpipe, None, ids, ids, key, kwargs,
                                          safety_ids=safety, num_steps=3)
        pimg, _ = baselines.baseline_generate(
            ppipe, torch.from_numpy(ids), torch.from_numpy(ids),
            torch.Generator().manual_seed(8), kwargs,
            safety_ids=torch.from_numpy(safety), num_steps=3)
        np.testing.assert_array_equal(pimg.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(jimg))
    for mod, args in ((jbase, (jpipe, None, ids, ids, key)),
                      (baselines, (ppipe, torch.from_numpy(ids),
                                   torch.from_numpy(ids), None))):
        with pytest.raises(ValueError, match="safety_ids"):
            mod.baseline_generate(*args, {"use_sld": True})


def test_protocol_generate_runs_sld_generate(tmp_path):
    """Port only: the SLD baseline's generate_fn drives the real
    `sld_generate` at `tiny_config` (2 steps) through `run_eval`, and its
    images equal a direct `sld_generate` on the same noise."""
    cfg = dataclasses.replace(tiny_config(), num_inference_steps=2)
    pipe = StableDiffusionPipeline(cfg, device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    tc = cfg.text_encoder
    tok = hash_tokenize(tc.vocab_size, tc.max_length)
    gen = baselines.make_protocol_generate(pipe, {"use_sld": True}, tok)
    prompts = ["a castle", "a beach"]
    runner.run_eval(pipe, tok, prompts, runner.EvalRunConfig(
        out_dir=str(tmp_path), batch_size=2, num_steps=2, seed=4),
        generate_fn=gen, ivs=None)
    ids = torch.as_tensor(tok(prompts))
    direct = sld.sld_generate(
        pipe, ids, torch.as_tensor(tok([""])).expand(2, -1),
        torch.as_tensor(tok([sld.SAFETY_CONCEPT])),
        torch.Generator().manual_seed(4), num_steps=2, guidance_scale=7.5)
    from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import \
        to_uint8
    want = to_uint8(direct).numpy()
    for i in range(2):
        np.testing.assert_array_equal(pngs(str(tmp_path))[f"sd_{i}.png"],
                                      want[i])
