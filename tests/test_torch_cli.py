"""The port's CLI (`diffusion_models_moe_tpu_torch/cli.py`) against the JAX
package's (`diffusion_models_moe_tpu/cli.py`).

* Parser parity: the same 18 subcommands, and for each the same option
  strings, dests, defaults, choices, required flags, types and action kinds.
* Value parity on the same inputs: `_hash_tokenize`, `create-datasets`,
  `check-snapshot` (plain, --deep, --baseline-unet, a wrong --kind) on the
  snapshot `tests/test_cli.py` builds, `moefy` and `bake-union` on the same
  tiny weights (JAX params carried to the port by `weights/bridge.py`,
  handed to both CLIs through each `_load_pipe`).
* Call parity for every other subcommand: both CLIs run the same argv on
  the same weights with the library calls they make replaced by recorders,
  and what each recorded is compared: token ids, prompts, steps, top-k,
  ratios, batch sizes, seeds (JAX's `PRNGKey(seed)` read back to its seed),
  the run configs' fields, masks and interventions by value (JAX's
  `out_weight_mask` is the transpose of the port's), output paths relative
  to their out dirs.
* The port alone, end to end, with --cpu; and without --cpu on this
  CPU-only host, an error that names CUDA.
"""
import csv
import dataclasses
import io
import json
import os
import subprocess
import sys
from concurrent.futures import Future

import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_models_moe_tpu import cli as jcli
from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu.pipelines import stable_diffusion as jsd
from diffusion_models_moe_tpu_torch import cli as pcli
from diffusion_models_moe_tpu_torch import tiny_config
from diffusion_models_moe_tpu_torch.data.tokenize import hash_tokenize
from diffusion_models_moe_tpu_torch.pipelines import stable_diffusion as psd
from diffusion_models_moe_tpu_torch.weights import _safetensors

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAKE_TOL = 2e-4
EMB_TOL = 1e-4


# ------------------------------------------------------------------ set-up
@pytest.fixture(scope="module")
def shared():
    """One JAX pipeline and one port pipeline on the same tiny f32 weights,
    with each CLI's tokenizer."""
    jax_cfg = jcfg.tiny_config()
    params, port = tp.pipelines(jax_cfg)
    jpipe = jsd.StableDiffusionPipeline(jax_cfg)
    tcfg = jax_cfg.text_encoder
    jtok = jcli._hash_tokenize(tcfg.vocab_size, tcfg.max_length)
    ptok = hash_tokenize(tcfg.vocab_size, tcfg.max_length)
    return {"jax": (jpipe, params, jtok), "port": (port, ptok)}


@pytest.fixture
def seams(shared, monkeypatch):
    """Both CLIs' `_load_pipe` return the shared pipelines."""
    monkeypatch.setattr(jcli, "_load_pipe", lambda args: shared["jax"])
    monkeypatch.setattr(pcli, "_load_pipe", lambda args: shared["port"])
    return shared


def both(capsys, argv_jax, argv_port=None):
    """Runs the JAX CLI then the port's; returns the last stdout line of
    each."""
    jcli.main(argv_jax)
    j = capsys.readouterr().out.strip().splitlines()
    pcli.main(argv_port if argv_port is not None else argv_jax)
    p = capsys.readouterr().out.strip().splitlines()
    return (j[-1] if j else ""), (p[-1] if p else "")


def out_dirs(tmp_path, name="out"):
    """A (JAX, port) pair of output directories; recorded paths are taken
    relative to them."""
    return str(tmp_path / "jax" / name), str(tmp_path / "port" / name)


def rel(path, root):
    return None if path is None else os.path.relpath(str(path), root)


# ------------------------------------------------------------ normalizing
def np_of(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ids(x):
    return np_of(x).astype(np.int64)


def key_seed(key):
    """The seed of a JAX `PRNGKey(seed)` (raw uint32 [0, seed])."""
    return int(np.asarray(key).ravel()[-1])


IV_FIELDS = ("patterns", "k", "expert_remove", "expert_boost", "neuron_mask",
             "neuron_fill", "out_weight_mask", "token_mask")


def ivs_value(ivs, jax_side: bool):
    if ivs is None:
        return None
    out = []
    for iv in ivs:
        if iv is None:
            out.append(None)
            continue
        d = {}
        for f in IV_FIELDS:
            v = getattr(iv, f, None)
            if v is None:
                continue
            if f in ("k", "neuron_fill"):
                d[f] = float(v)
                continue
            a = np_of(v).astype(np.float32)
            if f == "out_weight_mask" and jax_side:
                a = np.swapaxes(a, -1, -2)       # flax (H, D) -> (D, H)
            d[f] = a
        out.append(d)
    return out


def tap_value(tap):
    if tap is None:
        return None
    return sorted(f.name for f in dataclasses.fields(tap)
                  if getattr(tap, f.name))


def assert_same(a, b, where="", tol=0.0):
    """Deep equality of recorded values: dicts, sequences, arrays (within
    `tol` relative where given), scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (where, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}", tol)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (where, a.shape, b.shape)
        if tol:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol * (
                np.abs(b).max() if b.size else 1.0), err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]", tol)
    else:
        assert a == b, (where, a, b)


# ------------------------------------------------------------ recorders
class Recorder:
    """Replaces library functions of both packages; each call appends a
    normalized record to `calls[side]`."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        self.calls = {"jax": [], "port": []}

    def patch(self, side, target, name, fn):
        self.mp.setattr(target, name, fn)

    def add(self, side, kind, **kw):
        self.calls[side].append((kind, kw))

    def check(self, tol=0.0):
        assert [k for k, _ in self.calls["jax"]] == [
            k for k, _ in self.calls["port"]], self.calls
        assert_same(self.calls["jax"], self.calls["port"], "calls", tol)
        assert self.calls["jax"], "nothing recorded"


def fake_freq(cfg_unet, steps):
    """Deterministic expert-frequency taps: (T, E) per layer, E at 16
    neurons an expert, T the PNDM scheduler entries."""
    t = steps + 1
    return {l: np.full((t, 4 * d // 16), l + 1.0, np.float32)
            for l, d in enumerate(cfg_unet.ff_dims())}


def patch_generate(rec, roots):
    """Both pipelines' `generate` (class methods, so that a fresh
    pipeline's is recorded too) record cond/uncond ids, seed, steps, tap,
    ivs, decode, the DeepCache interval; they return zero images or
    latents, and expert-frequency taps where asked."""
    def jgen(self, params, cond, uncond, key, *, num_steps=None,
             guidance_scale=None, tap=None, ivs=None, text_ivs=None,
             decode=True, mesh=None, seeds=None):
        rec.add("jax", "generate", cond=ids(cond), uncond=ids(uncond),
                seed=key_seed(key), num_steps=num_steps, tap=tap_value(tap),
                ivs=ivs_value(ivs, True), decode=decode,
                deep_cache=self.config.deep_cache_interval)
        cfg, b = self.config, np.asarray(cond).shape[0]
        s = cfg.sample_size
        out = (np.zeros((b, 8 * s, 8 * s, 3), np.float32) if decode
               else np.zeros((b, s, s, 4), np.float32))
        taps = None
        if tap is not None and tap.expert_freq:
            taps = {"expert_freq": fake_freq(cfg.unet,
                                             num_steps or
                                             cfg.num_inference_steps)}
        return out, taps

    def pgen(self, cond, uncond, generator=None, *, num_steps=None,
             guidance_scale=None, tap=None, ivs=None, text_ivs=None,
             decode=True, seeds=None, mesh=None):
        assert generator is None and len(seeds) == 1
        rec.add("port", "generate", cond=ids(cond), uncond=ids(uncond),
                seed=int(seeds[0]), num_steps=num_steps, tap=tap_value(tap),
                ivs=ivs_value(ivs, False), decode=decode,
                deep_cache=self.config.deep_cache_interval)
        cfg, b = self.config, cond.shape[0]
        s = cfg.sample_size
        out = (torch.zeros((b, 3, 8 * s, 8 * s)) if decode
               else torch.zeros((b, 4, s, s)))
        taps = None
        if tap is not None and tap.expert_freq:
            taps = {"expert_freq": {l: torch.from_numpy(v) for l, v in
                                    fake_freq(cfg.unet, num_steps or
                                              cfg.num_inference_steps
                                              ).items()}}
        return out, taps

    rec.patch("jax", jsd.StableDiffusionPipeline, "generate", jgen)
    rec.patch("port", psd.StableDiffusionPipeline, "generate", pgen)


def run_eval_recorders(rec, roots):
    """`benchmarks/runner.py:run_eval` of both packages: prompts, the
    config's fields (out_dir relative), interventions by value."""
    from diffusion_models_moe_tpu.benchmarks import runner as jrunner
    from diffusion_models_moe_tpu_torch.benchmarks import runner as prunner

    def make(side, n_pre):
        def run_eval(*args, ivs=None, **kw):
            prompts, cfg = args[n_pre], args[n_pre + 1]
            d = dataclasses.asdict(cfg)
            d["out_dir"] = rel(d["out_dir"], roots[side])
            if d["per_prompt_seeds"] is not None:
                d["per_prompt_seeds"] = [int(s) for s in d["per_prompt_seeds"]]
            rec.add(side, "run_eval", prompts=list(prompts), cfg=d,
                    ivs=ivs_value(ivs, side == "jax"),
                    extra=sorted(k for k, v in kw.items() if v is not None))
            return {"n_prompts": len(prompts)}
        return run_eval

    rec.patch("jax", jrunner, "run_eval", make("jax", 3))
    rec.patch("port", prunner, "run_eval", make("port", 2))


def write_masks(path, dims, steps, kind, seed=0):
    """Seeded masks: `kind` "wanda" (T, D, H), "neurons" (T, H)."""
    from diffusion_models_moe_tpu_torch.erasure.masks import save_masks
    rng = np.random.RandomState(seed)
    masks = {l: rng.rand(*((steps, d, 4 * d) if kind == "wanda"
                           else (steps, 4 * d))) < 0.05
             for l, d in enumerate(dims)}
    save_masks(str(path), masks)
    return masks


# ================================================================ parser
def _parser_table(parser):
    sub = next(a for a in parser._subparsers._group_actions)
    table = {}
    for name, sp in sub.choices.items():
        table[name] = {
            a.dest: (tuple(a.option_strings), a.default,
                     tuple(a.choices) if a.choices is not None else None,
                     a.required, a.type, type(a).__name__, a.nargs, a.const)
            for a in sp._actions}
    top = [(a.dest, type(a).__name__, a.required) for a in parser._actions]
    return table, top, (sub.dest, sub.required)


def test_parser_matches_jax():
    """Every subcommand and every action as JAX's: option strings, dest,
    default, choices, required, type, action kind, nargs, const."""
    jt, jtop, jsub = _parser_table(jcli.build_parser())
    pt, ptop, psub = _parser_table(pcli.build_parser())
    assert len(jt) == 18 and list(pt) == list(jt)
    assert (ptop, psub) == (jtop, jsub)
    for name in jt:
        assert pt[name] == jt[name], name


def test_ft_method_choices_match_port_registry():
    """`--ft-method`'s static choices (kept static so --help stays light)
    are the port's `training/train.py:FT_METHODS`."""
    from diffusion_models_moe_tpu_torch.training.train import FT_METHODS
    sub = next(a for a in pcli.build_parser()._subparsers._group_actions)
    ft = next(a for a in sub.choices["train"]._actions
              if a.dest == "ft_method")
    assert set(ft.choices) == set(FT_METHODS)


def test_help_loads_no_jax():
    """`python -m ... cli --help` and `generate --help` exit 0, and the
    interpreter that ran them never loaded JAX or the JAX package."""
    for argv in (["--help"], ["generate", "--help"]):
        proc = subprocess.run(
            [sys.executable, "-m", "diffusion_models_moe_tpu_torch.cli",
             *argv], cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert "usage:" in proc.stdout
        code = (
            "import runpy, sys\n"
            f"sys.argv = ['cli', *{argv!r}]\n"
            "try:\n"
            "    runpy.run_module('diffusion_models_moe_tpu_torch.cli', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'diffusion_models_moe_tpu' or "
            "m.startswith('diffusion_models_moe_tpu.')]\n"
            "assert not bad, bad\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr


# ============================================================ value parity
@pytest.mark.parametrize("texts", [["a cat"], ["a dog", "a painting, Van Gogh"],
                                   [""], ["x" * 300, "é ü"]])
def test_hash_tokenize_equals_jax(texts):
    for vocab, maxlen in ((1000, 16), (49408, 77)):
        got = pcli._hash_tokenize(vocab, maxlen)(texts)
        ref = jcli._hash_tokenize(vocab, maxlen)(texts)
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(hash_tokenize(vocab, maxlen)(
            texts).numpy(), ref)


def test_create_datasets_equals_jax(tmp_path, capsys):
    art = tmp_path / "artwork_prompts.csv"
    with open(art, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["case_number", "prompt",
                                          "evaluation_seed", "artist"])
        w.writeheader()
        w.writerow({"case_number": "0", "prompt": "art by Van Gogh",
                    "evaluation_seed": "7", "artist": "Van Gogh"})
        w.writerow({"case_number": "1", "prompt": "art by Monet, \"quoted\"",
                    "evaluation_seed": "9", "artist": "Monet"})
    i2p = tmp_path / "i2p.txt"
    i2p.write_text("a harmful prompt\n\nanother one, with a comma\n")
    outs = [tmp_path / "jax.csv", tmp_path / "port.csv"]
    j, p = both(capsys, ["create-datasets", "--artwork-csv", str(art),
                         "--i2p-file", str(i2p), "--out", str(outs[0])],
                ["create-datasets", "--artwork-csv", str(art),
                 "--i2p-file", str(i2p), "--out", str(outs[1])])
    assert json.loads(j)["rows"] == json.loads(p)["rows"] == 4
    assert outs[0].read_bytes() == outs[1].read_bytes()


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """tests/test_cli.py:133-222's snapshot: tiny dims, SD1.5 topology, the
    sentinel tensors at real SD1.5 shapes, a dummy text encoder, and a
    UCE-style edited-UNet .pt of the same UNet. The state dicts come from
    the port's modules (their keys are diffusers', as `export_unet`'s: the
    census below holds both CLIPs to them), not from a Flax init."""
    from diffusion_models_moe_tpu_torch.config import VAEConfig
    from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
    from diffusion_models_moe_tpu_torch.models.vae import (VAEDecoder,
                                                           VAEEncoder)
    torch.manual_seed(0)
    root = tmp_path_factory.mktemp("snapshot") / "snap"
    unet_sd = dict(UNet2DCondition(tiny_config().unet).state_dict())
    unet_sd["conv_in.weight"] = torch.zeros((320, 4, 3, 3))
    unet_sd["down_blocks.0.attentions.0.transformer_blocks.0"
            ".attn2.to_k.weight"] = torch.zeros((8, 768))
    _safetensors.write(unet_sd, str(
        root / "unet" / "diffusion_pytorch_model.safetensors"))
    vae_cfg = VAEConfig(block_out_channels=(8, 16, 32, 32),
                        layers_per_block=2, norm_num_groups=4)
    _safetensors.write({**VAEDecoder(vae_cfg).state_dict(),
                        **VAEEncoder(vae_cfg).state_dict()},
                       str(root / "vae" / "diffusion_pytorch_model"
                           ".safetensors"))
    _safetensors.write({"dummy": torch.zeros((1,))},
                       str(root / "text_encoder" / "model.safetensors"))
    (root / "tokenizer").mkdir(parents=True)
    (root / "tokenizer" / "vocab.json").write_text("{}")
    pt = root.parent / "erased-van gogh-method_replace.pt"
    torch.save({k: v.detach().clone().half() for k, v in unet_sd.items()},
               str(pt))
    return root, pt


@pytest.mark.parametrize("form", ["plain", "deep", "baseline_unet",
                                  "baseline_unet_deep", "wrong_kind"])
def test_check_snapshot_report_equals_jax(snapshot, form, capsys):
    """The doctor's report as JAX's, as JSON. The error texts of failed
    readers differ by framework: both must carry one. `ported_params`
    counts entries read: the UNet's and the VAE's are JAX's; the port reads
    every tensor of a state dict, the JAX porter the leaves of its tree,
    and a buffer such as CLIP's `position_ids` would be dropped by both
    (this snapshot's text encoder holds none: it fails in both)."""
    root, pt = snapshot
    extra = {"plain": [], "deep": ["--deep"],
             "baseline_unet": ["--baseline-unet", str(pt)],
             "baseline_unet_deep": ["--baseline-unet", str(pt), "--deep"],
             "wrong_kind": ["--kind", "sd21"]}[form]
    j, p = [], []
    for main, out in ((jcli.main, j), (pcli.main, p)):
        main(["check-snapshot", "--cpu", "--snapshot", str(root), *extra])
        out.append(json.loads(capsys.readouterr().out))
    jrep, prep = j[0], p[0]
    for rep in (jrep, prep):
        for entry in rep["components"].values():
            if "port_error" in entry:
                assert entry["port_ok"] is False and entry["port_error"]
                entry["port_error"] = "<error text>"
    assert prep == jrep
    if form == "wrong_kind":
        assert prep["components"]["unet"]["shapes_ok"] is False
        assert prep["ok"] is False
    if form == "deep":
        comps = prep["components"]
        assert comps["unet"]["port_ok"] and comps["vae"]["port_ok"]
        assert comps["vae_encoder"]["port_ok"]
        assert comps["text_encoder"]["port_ok"] is False
    if form == "baseline_unet_deep":
        entry = prep["components"]["baseline_unet"]
        assert entry["port_ok"] and entry["ported_params"] > 0


def test_check_snapshot_finds_a_missing_key_as_jax(snapshot, tmp_path,
                                                     capsys):
    """A UNet file missing one tensor: the same census diff in both."""
    import shutil
    root, _ = snapshot
    copy = tmp_path / "snap"
    shutil.copytree(root, copy)
    path = copy / "unet" / "diffusion_pytorch_model.safetensors"
    sd = _safetensors.read(str(path))
    sd.pop("conv_out.bias")
    _safetensors.write(sd, str(path))
    reps = []
    for main in (jcli.main, pcli.main):
        main(["check-snapshot", "--cpu", "--snapshot", str(copy)])
        reps.append(json.loads(capsys.readouterr().out))
    assert reps[1] == reps[0]
    assert reps[1]["components"]["unet"]["missing_keys"] == ["conv_out.bias"]


def test_moefy_labels_equal_jax(seams, tmp_path, capsys):
    """Greedy clustering through both CLIs on the same weights: the same
    labels (tests/test_torch_moefy.py's rule: greedy and exact are equal)."""
    outs = [tmp_path / "jax.npz", tmp_path / "port.npz"]
    j, p = both(capsys, ["moefy", "--cpu", "--method", "greedy",
                         "--expert-size", "16", "--out", str(outs[0])],
                ["moefy", "--cpu", "--method", "greedy", "--expert-size",
                 "16", "--out", str(outs[1])])
    assert json.loads(j) == json.loads(p)
    with np.load(outs[0]) as a, np.load(outs[1]) as b:
        assert a.files == b.files and len(a.files) == 16
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_bake_union_equals_jax(seams, tmp_path, capsys):
    """The same (T, D, H) masks baked into the same weights: the same
    pruned counts, and the baked safetensors within BAKE_TOL."""
    from safetensors.numpy import load_file
    masks = tmp_path / "masks.npz"
    write_masks(masks, tiny_config().unet.ff_dims(), 3, "wanda")
    outs = [tmp_path / "jax.safetensors", tmp_path / "port.safetensors"]
    j, p = both(capsys, ["bake-union", "--cpu", "--masks", str(masks),
                         "--ratio", "0.3", "--out", str(outs[0])],
                ["bake-union", "--cpu", "--masks", str(masks), "--ratio",
                 "0.3", "--out", str(outs[1])])
    assert json.loads(j)["pruned"] == json.loads(p)["pruned"]
    ref = load_file(str(outs[0]))
    got = _safetensors.read(str(outs[1]))
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0,
                                   atol=BAKE_TOL * max(np.abs(v).max(), 1.0),
                                   err_msg=k)


# ============================================================= call parity
@pytest.fixture
def labels_file(tmp_path):
    """Seeded expert labels of the tiny UNet (16-neuron experts)."""
    labels = tp.labels(tiny_config().unet)
    path = tmp_path / "labels.npz"
    np.savez(path, **labels)
    return str(path)


@pytest.mark.parametrize("with_labels", [False, True])
def test_generate_calls_equal_jax(seams, tmp_path, capsys, monkeypatch,
                                  labels_file, with_labels):
    rec = Recorder(monkeypatch)
    roots = dict(zip(("jax", "port"), out_dirs(tmp_path)))
    patch_generate(rec, roots)
    extra = ["--labels", labels_file, "--topk", "0.25"] if with_labels else []
    argv = ["generate", "--cpu", "--prompt", "a cat", "--seed", "5",
            "--steps", "3", *extra]
    j, p = both(capsys, argv + ["--out", f"{roots['jax']}/img.png"],
                argv + ["--out", f"{roots['port']}/img.png"])
    assert rel(j, roots["jax"]) == rel(p, roots["port"]) == "img.png"
    rec.check()


class FakeEngine:
    """Stands in for both packages' ServingEngine: records its settings and
    every request (the prompt's ids by the engine's tokenizer), answers
    each with a zero image."""
    rec = side = None

    def __init__(self, pipe, *args, batch_size, num_steps, ivs, max_wait_ms):
        tokenize = args[-1]
        self.tokenize = tokenize
        self.rec.add(self.side, "engine", batch_size=batch_size,
                     num_steps=num_steps, max_wait_ms=max_wait_ms,
                     ivs=ivs_value(ivs, self.side == "jax"))
        self.stats = type("S", (), {"requests": 0, "batches": 1,
                                    "mean_fill": 1.0,
                                    "images_per_second": 1.0})()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def submit(self, prompt, seed=0):
        self.rec.add(self.side, "submit", prompt=prompt, seed=seed,
                     ids=ids(self.tokenize([prompt])))
        self.stats.requests += 1
        fut = Future()
        fut.set_result(np.zeros((8, 8, 3), np.uint8))
        return fut


@pytest.mark.parametrize("with_labels", [False, True])
def test_serve_calls_equal_jax(seams, tmp_path, capsys, monkeypatch,
                               labels_file, with_labels):
    """The engine's settings (steps: 50 where --steps is not given, as
    JAX's), every request's prompt, seed (the line's, else --seed) and ids;
    the PNGs written in submit order; a bad seed line reported."""
    from diffusion_models_moe_tpu import serving as jserving
    from diffusion_models_moe_tpu_torch import serving as pserving
    rec = Recorder(monkeypatch)
    for side, mod in (("jax", jserving), ("port", pserving)):
        cls = type(f"Fake{side}", (FakeEngine,), {"rec": rec, "side": side})
        rec.patch(side, mod, "ServingEngine", cls)
    roots = dict(zip(("jax", "port"), out_dirs(tmp_path)))
    extra = ["--labels", labels_file] if with_labels else []
    outs = {}
    for side, main in (("jax", jcli.main), ("port", pcli.main)):
        monkeypatch.setattr("sys.stdin", io.StringIO(
            "5\ta cat\na dog\nx\ty\n\n7\ta house\n"))
        main(["serve", "--cpu", "--batch", "2", "--seed", "3",
              "--max-wait-ms", "20", "--out-dir", roots[side], *extra])
        lines = capsys.readouterr().out.strip().splitlines()
        # the writer thread prints the paths in submit order; the reader's
        # bad-seed line may fall anywhere among them
        outs[side] = ([rel(l, roots[side]) for l in lines
                       if l.startswith(roots[side])],
                      [l for l in lines if l.startswith("ERROR")],
                      lines[-1])
    assert outs["port"] == outs["jax"]
    assert sorted(os.listdir(roots["port"])) == sorted(
        os.listdir(roots["jax"])) == [f"img_{i:05d}.png" for i in range(3)]
    rec.check()


def test_wanda_calls_equal_jax(seams, tmp_path, capsys, monkeypatch):
    """Prompt pairs, the concept's skill ratio (its operating point), seed,
    steps, cache dir; the masks written as the recorder returned them."""
    from diffusion_models_moe_tpu.analysis import collect as jcollect
    from diffusion_models_moe_tpu_torch.analysis import collect as pcollect
    rec = Recorder(monkeypatch)
    roots = dict(zip(("jax", "port"), out_dirs(tmp_path)))
    dims = tiny_config().unet.ff_dims()
    rng = np.random.RandomState(3)
    masks = {l: rng.rand(3, d, 4 * d) < 0.05 for l, d in enumerate(dims)}

    def make(side):
        def wanda_pipeline(*args, skill_ratio, seed, num_steps, cache_dir):
            rec.add(side, "wanda_pipeline", base=list(args[-2]),
                    adj=list(args[-1]), skill_ratio=skill_ratio, seed=seed,
                    num_steps=num_steps,
                    cache_dir=rel(cache_dir, roots[side]))
            return masks
        return wanda_pipeline

    rec.patch("jax", jcollect, "wanda_pipeline", make("jax"))
    rec.patch("port", pcollect, "wanda_pipeline", make("port"))
    res = {}
    for side, main in (("jax", jcli.main), ("port", pcli.main)):
        main(["wanda", "--cpu", "--concept", "Van Gogh", "--limit", "2",
              "--steps", "2", "--seed", "4", "--cache-dir",
              f"{roots[side]}/cache", "--out", f"{roots[side]}/m.npz"])
        res[side] = json.loads(capsys.readouterr().out.strip().splitlines(
        )[-1])
        res[side]["out"] = rel(res[side]["out"], roots[side])
    assert res["port"] == res["jax"]
    with np.load(f"{roots['jax']}/m.npz") as a, \
            np.load(f"{roots['port']}/m.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    rec.check()


def test_ttest_calls_equal_jax(seams, tmp_path, capsys, monkeypatch):
    from diffusion_models_moe_tpu.analysis import collect as jcollect
    from diffusion_models_moe_tpu_torch.analysis import collect as pcollect
    rec = Recorder(monkeypatch)
    roots = dict(zip(("jax", "port"), out_dirs(tmp_path)))
    dims = tiny_config().unet.ff_dims()
    masks = {l: np.arange(3 * 4 * d).reshape(3, 4 * d) % 7 == 0
             for l, d in enumerate(dims)}

    def make(side):
        class Pred:
            def save(self, path):
                rec.add(side, "save", path=rel(path, roots[side]))

        def collect_predictivity(*args, seed, num_steps):
            rec.add(side, "collect_predictivity", base=list(args[-2]),
                    adj=list(args[-1]), seed=seed, num_steps=num_steps)
            return Pred()

        def t_test_pipeline(pred, conf):
            rec.add(side, "t_test_pipeline", conf=conf)
            return masks
        return collect_predictivity, t_test_pipeline

    for side, mod in (("jax", jcollect), ("port", pcollect)):
        cp, tt = make(side)
        rec.patch(side, mod, "collect_predictivity", cp)
        rec.patch(side, mod, "t_test_pipeline", tt)
    for side, main in (("jax", jcli.main), ("port", pcli.main)):
        main(["ttest", "--cpu", "--concept", "Van Gogh", "--limit", "2",
              "--steps", "2", "--conf", "0.2", "--save-predictivity",
              f"{roots[side]}/pred", "--out", f"{roots[side]}/m.npz"])
    rec.check()


@pytest.mark.parametrize("mode", ["wanda", "neurons"])
def test_remove_calls_equal_jax(seams, tmp_path, capsys, monkeypatch, mode):
    """The concept prompts, EvalRunConfig (steps None where --steps is not
    given, in both) and the removal interventions by value."""
    rec = Recorder(monkeypatch)
    roots = dict(zip(("jax", "port"), out_dirs(tmp_path)))
    run_eval_recorders(rec, roots)
    masks = tmp_path / "masks.npz"
    write_masks(masks, tiny_config().unet.ff_dims(), 3, mode)
    for side, main in (("jax", jcli.main), ("port", pcli.main)):
        main(["remove", "--cpu", "--concept", "Van Gogh", "--limit", "2",
              "--batch", "3", "--seed", "2", "--mode", mode, "--masks",
              str(masks), "--out-dir", f"{roots[side]}/removed"])
    rec.check()


@pytest.mark.parametrize("concept", [None, "Van Gogh"])
def test_sparsity_calls_equal_jax(seams, tmp_path, capsys, monkeypatch,
                                  concept):
    from diffusion_models_moe_tpu.analysis import sparsity as jsp
    from diffusion_models_moe_tpu_torch.analysis import sparsity as psp
    rec = Recorder(monkeypatch)
    roots = dict(zip(("jax", "port"), out_dirs(tmp_path)))

    def make(side):
        def measure_sparsity(*args, seed, num_steps, out_path):
            rec.add(side, "measure_sparsity", prompts=list(args[-1]),
                    seed=seed, num_steps=num_steps,
                    out_path=rel(out_path, roots[side]))
            return {l: np.full(3, 0.1 * l) for l in range(16)}
        return measure_sparsity

    rec.patch("jax", jsp, "measure_sparsity", make("jax"))
    rec.patch("port", psp, "measure_sparsity", make("port"))
    extra = ["--concept", concept, "--limit", "2"] if concept else []
    res = {}
    for side, main in (("jax", jcli.main), ("port", pcli.main)):
        main(["sparsity", "--cpu", "--steps", "2", "--seed", "1",
              "--out", f"{roots[side]}/s.json", *extra])
        res[side] = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(res["port"]) == json.loads(res["jax"])
    rec.check()


def test_expert_freq_calls_equal_jax(seams, tmp_path, capsys, monkeypatch,
                                     labels_file):
    """Each base prompt's generate (zero uncond ids, the expert_freq tap,
    the MoE interventions, undecoded) and the averaged frequencies
    written."""
    rec = Recorder(monkeypatch)
    roots = dict(zip(("jax", "port"), out_dirs(tmp_path)))
    patch_generate(rec, roots)
    for side, main in (("jax", jcli.main), ("port", pcli.main)):
        os.makedirs(roots[side])
        main(["expert-freq", "--cpu", "--concept", "Van Gogh", "--limit",
              "2", "--steps", "2", "--seed", "6", "--topk", "0.5",
              "--labels", labels_file, "--out", f"{roots[side]}/f.json"])
    with open(f"{roots['jax']}/f.json") as a, \
            open(f"{roots['port']}/f.json") as b:
        assert json.load(a) == json.load(b)
    rec.check()


def _coco_root(tmp_path):
    root = tmp_path / "coco"
    (root / "annotations").mkdir(parents=True)
    data = {"images": [{"id": i, "file_name": f"{i}.jpg"} for i in range(6)],
            "annotations": [{"image_id": i % 6, "caption": f" caption {i} "}
                            for i in range(9)]}
    (root / "annotations" / "captions_val2014.json").write_text(
        json.dumps(data))
    return str(root)


@pytest.mark.parametrize("variant", ["concept", "masks_neurons", "csv",
                                     "coco"])
def test_eval_gen_calls_equal_jax(seams, tmp_path, capsys, monkeypatch,
                                  variant):
    """The prompts (concept pairs, a prompt CSV with its seeds, a COCO
    sample), EvalRunConfig (steps 50 where --steps is not given, the
    per-prompt seeds, save_baseline) and the interventions."""
    rec = Recorder(monkeypatch)
    roots = dict(zip(("jax", "port"), out_dirs(tmp_path)))
    run_eval_recorders(rec, roots)
    extra = {"concept": ["--concept", "Van Gogh", "--limit", "2",
                         "--no-baseline"],
             "masks_neurons": ["--concept", "Van Gogh", "--limit", "2",
                               "--masks", str(tmp_path / "m.npz"), "--mode",
                               "neurons", "--steps", "3"],
             "csv": ["--prompts-csv", str(tmp_path / "p.csv")],
             "coco": ["--coco-root", _coco_root(tmp_path), "--n-samples",
                      "4"]}[variant]
    if variant == "masks_neurons":
        write_masks(tmp_path / "m.npz", tiny_config().unet.ff_dims(), 2,
                    "neurons")
    if variant == "csv":
        with open(tmp_path / "p.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["prompt", "evaluation_seed"])
            w.writeheader()
            for i in range(3):
                w.writerow({"prompt": f"prompt {i}",
                            "evaluation_seed": str(10 + i)})
    for side, main in (("jax", jcli.main), ("port", pcli.main)):
        main(["eval-gen", "--cpu", "--seed", "1", "--batch", "2",
              "--out-dir", f"{roots[side]}/eval", *extra])
    rec.check()


@pytest.fixture
def port_cpu(monkeypatch):
    """`score-dirs` has no --cpu (as JAX's): its tiny tower is built on the
    CPU here."""
    monkeypatch.setattr(pcli, "_device", lambda args: torch.device("cpu"))


@pytest.mark.parametrize("lpips", ["none", "both", "one"])
def test_score_dirs_calls_equal_jax(tmp_path, capsys, monkeypatch, port_cpu,
                                    lpips):
    from diffusion_models_moe_tpu.benchmarks import scores as jscores
    from diffusion_models_moe_tpu_torch.benchmarks import scores as pscores
    rec = Recorder(monkeypatch)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    for side, mod in (("jax", jscores), ("port", pscores)):
        def fid(a_dir, b_dir, featurize, side=side):
            rec.add(side, "fid", a=a_dir, b=b_dir)
            return 1.5

        def perc(a_dir, b_dir, dist, side=side):
            rec.add(side, "perceptual", a=a_dir, b=b_dir,
                    dist=getattr(dist, "tag", "clip"))
            return {"mean": 0.25, "n": 2}

        def lp(alex, lins, device=None, side=side):
            rec.add(side, "lpips", alex=alex, lins=lins)
            fn = (lambda x, y: 0.0)
            fn.tag = "lpips"
            return fn
        rec.patch(side, mod, "fid_between_dirs", fid)
        rec.patch(side, mod, "perceptual_between_dirs", perc)
        rec.patch(side, mod, "load_native_lpips", lp)
    extra = {"none": [], "both": ["--lpips-alexnet", "x.pt", "--lpips-lins",
                                  "y.pt"],
             "one": ["--lpips-alexnet", "x.pt"]}[lpips]
    argv = ["score-dirs", "--a-dir", a, "--b-dir", b, *extra]
    if lpips == "one":
        for main in (jcli.main, pcli.main):
            with pytest.raises(SystemExit, match="BOTH"):
                main(argv)
        return
    j, p = both(capsys, argv)
    assert json.loads(j) == json.loads(p)
    rec.check()


PROTOCOLS = {
    "i2p": ("i2p_protocol", ["--judge", "judge.onnx", "--variant", "v1"]),
    "memorize": ("memorization_protocol", ["--split", "3"]),
    "artists": ("artist_removal_protocol", ["--n-artists", "10", "--part",
                                            "2"]),
    "objects": ("object_erasure_protocol", ["--concept", "parachute"]),
    "debias": ("debias_eval", []),
    "unified": ("unified_editing_eval", []),
}


@pytest.mark.parametrize("name", list(PROTOCOLS))
def test_protocol_calls_equal_jax(seams, tmp_path, capsys, monkeypatch,
                                  name):
    """Each protocol's runner gets the same prompts/settings, limit, steps
    (50 where --steps is not given), batch size, the wanda interventions
    of --masks; the zero-shot judges' class-anchor generates (objects,
    debias) are recorded too, and the unified router's concept bank and
    prompt embeddings (within EMB_TOL: the same weights through both text
    towers)."""
    from diffusion_models_moe_tpu.benchmarks import debias as jdeb
    from diffusion_models_moe_tpu.benchmarks import nudity as jnud
    from diffusion_models_moe_tpu.benchmarks import protocols as jproto
    from diffusion_models_moe_tpu.benchmarks import unified_editing as juni
    from diffusion_models_moe_tpu_torch.benchmarks import debias as pdeb
    from diffusion_models_moe_tpu_torch.benchmarks import nudity as pnud
    from diffusion_models_moe_tpu_torch.benchmarks import protocols as pproto
    from diffusion_models_moe_tpu_torch.benchmarks import \
        unified_editing as puni
    rec = Recorder(monkeypatch)
    roots = dict(zip(("jax", "port"), out_dirs(tmp_path)))
    patch_generate(rec, roots)
    dims = tiny_config().unet.ff_dims()
    fn_name, extra = PROTOCOLS[name]
    mods = {"jax": {"proto": jproto, "debias": jdeb, "unified": juni,
                    "nudity": jnud},
            "port": {"proto": pproto, "debias": pdeb, "unified": puni,
                     "nudity": pnud}}
    for side in ("jax", "port"):
        n_pre = 3 if side == "jax" else 2

        def runner(*args, side=side, n_pre=n_pre, **kw):
            rec_kw = {}
            for k, v in kw.items():
                if k == "ivs":
                    rec_kw[k] = ivs_value(v, side == "jax")
                elif k in ("out_path",):
                    rec_kw[k] = rel(v, roots[side])
                elif k == "seeds":
                    rec_kw[k] = list(v)
                elif k in ("text_featurize", "mesh", "generate_fn"):
                    rec_kw[k] = v is None
                else:
                    rec_kw[k] = v
            pos = [rel(a, roots[side]) if isinstance(a, str) else
                   list(a) if isinstance(a, list) and a and
                   isinstance(a[0], str) else None
                   for a in args[n_pre:]]
            if name == "unified":
                prompts, embs, bank = args[n_pre], args[n_pre + 1], \
                    args[n_pre + 2]
                pos = [list(prompts), np.asarray(embs, np.float64),
                       sorted(bank.masks),
                       {c: {l: np.asarray(m) for l, m in ms.items()}
                        for c, ms in bank.masks.items()},
                       rel(args[n_pre + 3], roots[side])]
            rec.add(side, "runner", pos=pos, kw=rec_kw)
            return {"n_prompts": 0}

        target = (mods[side]["debias"] if name == "debias" else
                  mods[side]["unified"] if name == "unified" else
                  mods[side]["proto"])
        rec.patch(side, target, fn_name, runner)
        rec.patch(side, mods[side]["nudity"], "load_nudenet_native",
                  lambda path, *a, side=side, **kw: rec.add(
                      side, "nudenet", path=path) or (lambda imgs: []))
    masks_arg = []
    if name == "unified":
        for c in ("vg", "nk"):
            write_masks(tmp_path / f"{c}.npz", dims, 1, "wanda",
                        seed=len(c) + ord(c[0]))
        masks_arg = ["--masks",
                     f"vg={tmp_path}/vg.npz,nk={tmp_path}/nk.npz"]
    elif name in ("i2p", "memorize", "artists"):
        write_masks(tmp_path / "m.npz", dims, 2, "wanda")
        masks_arg = ["--masks", str(tmp_path / "m.npz")]
    steps = [] if name == "i2p" else ["--steps", "3"]
    for side, main in (("jax", jcli.main), ("port", pcli.main)):
        main(["protocol", name, "--cpu", "--limit", "2", "--batch", "2",
              "--seed", "3", "--out-dir", roots[side], *steps, *extra,
              *masks_arg])
    rec.check(tol=EMB_TOL)


@pytest.mark.parametrize("kind", ["native", "qwen"])
def test_vqa_calls_equal_jax(tmp_path, capsys, monkeypatch, kind):
    """A scripted judge in place of each native loader: the same questions
    of the same images, the same scores."""
    from diffusion_models_moe_tpu.benchmarks import vqa as jvqa
    from diffusion_models_moe_tpu_torch.benchmarks import vqa as pvqa
    rng = np.random.RandomState(1)
    for d in ("before", "after"):
        (tmp_path / d).mkdir()
        for i in range(2):
            Image.fromarray(rng.randint(0, 255, (24, 24, 3), np.uint8)).save(
                str(tmp_path / d / f"img_{i}.png"))
    rec = Recorder(monkeypatch)
    loader = "load_qwen2vl_native" if kind == "qwen" else "load_llava_native"
    for side, mod in (("jax", jvqa), ("port", pvqa)):
        def load(path, side=side, **kw):
            rec.add(side, "load", path=path, quant_int8=kw["quant_int8"],
                    mesh=kw["mesh"])

            def judge(image, question):
                rec.add(side, "ask", image=np.asarray(image), q=question)
                return "1"
            return judge
        rec.patch(side, mod, loader, load)
    outs = [tmp_path / "j.json", tmp_path / "p.json"]
    argv = ["vqa", "--cpu", "--judge", "unused", "--judge-kind", kind,
            "--before-dir", str(tmp_path / "before"), "--after-dir",
            str(tmp_path / "after"), "--objects", "cat,dog", "--concept",
            "Van Gogh", "--int8"]
    j, p = both(capsys, argv + ["--out", str(outs[0])],
                argv + ["--out", str(outs[1])])
    assert json.loads(j) == json.loads(p)
    assert outs[0].read_text() == outs[1].read_text()
    rec.check()


def test_vqa_transformers_judge_without_transformers(tmp_path, monkeypatch):
    """--judge-kind transformers where `transformers` is missing: JAX's
    ImportError, in both."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    argv = ["vqa", "--cpu", "--judge", "unused", "--judge-kind",
            "transformers", "--objects", "cat", "--concept", "Van Gogh"]
    for main in (jcli.main, pcli.main):
        with pytest.raises(ImportError):
            main(argv)


def test_iqa_calls_equal_jax(tmp_path, capsys, monkeypatch):
    """The three directories' images by value (JAX's (H, W, 3) arrays, the
    port's (3, H, W) tensors), the concept, the out dir."""
    from diffusion_models_moe_tpu.benchmarks import protocols as jproto
    from diffusion_models_moe_tpu_torch.benchmarks import protocols as pproto
    rng = np.random.RandomState(0)
    for d in ("base", "concept", "removed"):
        (tmp_path / d).mkdir()
        for i in range(2):
            Image.fromarray(rng.randint(0, 255, (32, 40, 3), np.uint8)).save(
                str(tmp_path / d / f"img_{i}.png"))
    rec = Recorder(monkeypatch)
    for side, mod in (("jax", jproto), ("port", pproto)):
        def iqa(b, c, r, image_f, text_f, concept, out_dir, side=side):
            def hwc(imgs):
                return [np_of(x) if side == "jax" else
                        np.transpose(np_of(x), (1, 2, 0)) for x in imgs]
            rec.add(side, "clip_iqa_protocol", base=hwc(b), concept_imgs=hwc(c),
                    removed=hwc(r), concept=concept, out_dir=out_dir)
            return {"base": {"quality": 0.5}}
        rec.patch(side, mod, "clip_iqa_protocol", iqa)
    j, p = both(capsys, ["iqa", "--cpu", "--base-dir", str(tmp_path / "base"),
                         "--concept-dir", str(tmp_path / "concept"),
                         "--removed-dir", str(tmp_path / "removed"),
                         "--concept", "Van Gogh", "--out-dir",
                         str(tmp_path)])
    assert json.loads(j) == json.loads(p)
    rec.check()


TRAIN_FIELDS = ("learning_rate", "use_ema", "ft_method", "snr_gamma",
                "lr_schedule", "lr_warmup_steps", "max_train_steps",
                "grad_accum_steps", "optimizer", "noise_offset",
                "input_perturbation", "prediction_type")


@pytest.mark.parametrize("variant", ["defaults", "options"])
def test_train_calls_equal_jax(tmp_path, capsys, monkeypatch, variant):
    """The imagefolder's batching (data dir, batch, caption column, the
    tiny resolution, seed, crop), TrainConfig's fields the CLI sets,
    RunConfig (out_dir relative), the validation logger's prompt and dir."""
    from diffusion_models_moe_tpu.data import ingest as jingest
    from diffusion_models_moe_tpu.training import trainer as jtrainer
    from diffusion_models_moe_tpu_torch.data import ingest as pingest
    from diffusion_models_moe_tpu_torch.training import trainer as ptrainer
    rec = Recorder(monkeypatch)
    roots = dict(zip(("jax", "port"), out_dirs(tmp_path)))
    for side, ing, tr in (("jax", jingest, jtrainer),
                          ("port", pingest, ptrainer)):
        def batches(root, tokenize, batch_size, caption_col, resolution,
                    seed, center_crop, side=side):
            rec.add(side, "imagefolder_batches", root=root, batch=batch_size,
                    caption_col=caption_col, resolution=resolution,
                    seed=seed, center_crop=center_crop)
            return iter(())

        def train(*args, validation_fn=None, side=side, **kw):
            tcfg, rcfg = args[1], args[2]
            rc = dataclasses.asdict(rcfg)
            rc["out_dir"] = rel(rc["out_dir"], roots[side])
            rc.pop("n_devices", None)
            rec.add(side, "train_relufied",
                    tcfg={f: getattr(tcfg, f) for f in TRAIN_FIELDS},
                    rcfg=rc, validation=validation_fn is not None)
            return type("State", (), {"step": 0})()

        def logger(pipe, *args, side=side, **kw):
            prompts, out_dir = args[-2], args[-1]
            rec.add(side, "validation_logger", prompts=list(prompts),
                    out_dir=rel(out_dir, roots[side]))
            return lambda *a: None
        rec.patch(side, ing, "imagefolder_batches", batches)
        rec.patch(side, tr, "train_relufied", train)
        rec.patch(side, tr, "make_validation_logger", logger)
    extra = [] if variant == "defaults" else [
        "--lr", "3e-4", "--ema", "--ft-method", "norm_bias",
        "--snr-gamma", "5.0", "--lr-schedule", "cosine", "--warmup-steps",
        "2", "--grad-accum", "2", "--optimizer", "adafactor",
        "--noise-offset", "0.1", "--input-perturbation", "0.05",
        "--prediction-type", "v_prediction", "--validation-every", "3",
        "--validation-prompt", "a cat", "--center-crop", "--no-resume",
        "--caption-col", "caption", "--resolution", "32", "--seed", "9",
        "--batch", "3", "--max-steps", "7", "--checkpoint-every", "3",
        "--log-every", "2"]
    res = {}
    for side, main in (("jax", jcli.main), ("port", pcli.main)):
        main(["train", "--cpu", "--data-dir", "data", "--out-dir",
              f"{roots[side]}/run", *extra])
        res[side] = json.loads(capsys.readouterr().out.strip().splitlines(
        )[-1])
        res[side]["out_dir"] = rel(res[side]["out_dir"], roots[side])
    assert res["port"] == res["jax"]
    rec.check()


@pytest.mark.parametrize("mode", [None, "dc3_pad", "winof_pad"])
def test_parity_run_calls_equal_jax(seams, tmp_path, capsys, monkeypatch,
                                    mode):
    """The acceptance flow's calls in order: moefy (expert size 16 on the
    tiny config, seed), the routing smoke's generate, wanda (the concept's
    skill ratio, steps 4 on the tiny config), run_eval, the bake check's
    two generates, the scores over the image dir, and the serving-mode
    A/B's generate with its DeepCache interval."""
    from diffusion_models_moe_tpu.analysis import collect as jcollect
    from diffusion_models_moe_tpu.benchmarks import scores as jscores
    from diffusion_models_moe_tpu.moefication import moefy as jmoefy
    from diffusion_models_moe_tpu_torch.analysis import collect as pcollect
    from diffusion_models_moe_tpu_torch.benchmarks import scores as pscores
    from diffusion_models_moe_tpu_torch.moefication import moefy as pmoefy
    rec = Recorder(monkeypatch)
    roots = dict(zip(("jax", "port"), out_dirs(tmp_path)))
    patch_generate(rec, roots)
    run_eval_recorders(rec, roots)
    cfg = tiny_config().unet
    labels = tp.labels(cfg)
    rng = np.random.RandomState(5)
    masks = {l: rng.rand(5, d, 4 * d) < 0.05
             for l, d in enumerate(cfg.ff_dims())}
    for side, moe, col, sc in (("jax", jmoefy, jcollect, jscores),
                               ("port", pmoefy, pcollect, pscores)):
        def moefy_unet(state, ucfg, expert_size, seed, save_path,
                       side=side, **kw):
            rec.add(side, "moefy_unet", expert_size=expert_size, seed=seed,
                    save_path=rel(save_path, roots[side]))
            return labels

        def wanda(*args, skill_ratio, seed, num_steps, cache_dir, side=side):
            rec.add(side, "wanda_pipeline", base=list(args[-2]),
                    adj=list(args[-1]), skill_ratio=skill_ratio, seed=seed,
                    num_steps=num_steps,
                    cache_dir=rel(cache_dir, roots[side]))
            return masks

        def fid(a, b, featurize, side=side):
            rec.add(side, "fid", a=rel(a, roots[side]),
                    b=rel(b, roots[side]))
            return 0.0

        def perc(a, b, dist, side=side):
            rec.add(side, "perceptual", a=rel(a, roots[side]),
                    b=rel(b, roots[side]))
            return {"mean": 0.0, "n": 2}
        rec.patch(side, moe, "moefy_unet", moefy_unet)
        rec.patch(side, col, "wanda_pipeline", wanda)
        rec.patch(side, sc, "fid_between_dirs", fid)
        rec.patch(side, sc, "perceptual_between_dirs", perc)
    extra = [] if mode is None else ["--mode", mode]
    reps = {}
    for side, main in (("jax", jcli.main), ("port", pcli.main)):
        main(["parity-run", "--cpu", "--out-dir", roots[side], "--concept",
              "Van Gogh", "--limit", "2", "--batch", "2", "--seed", "2",
              *extra])
        capsys.readouterr()
        with open(os.path.join(roots[side], "parity_run.json")) as f:
            reps[side] = json.load(f)
    rec.check()
    j, p = reps["jax"], reps["port"]
    for k in ("concept", "real_weights", "num_steps", "seed", "acceptance"):
        assert p[k] == j[k], k
    assert p["wanda"]["skilled_entries"] == j["wanda"]["skilled_entries"]
    assert p["bake"]["pruned"] == j["bake"]["pruned"]
    if mode:
        for k in ("mode", "knobs", "deep_cache", "tier_bound", "tier_ok"):
            assert p["serving_mode"][k] == j["serving_mode"][k], k


# =============================================================== port alone
def test_generate_png_is_the_library_generate(tmp_path, capsys):
    """`generate --cpu` on the tiny seeded weights writes the PNG of the
    library `generate` with the same seed, bit for bit."""
    from diffusion_models_moe_tpu_torch import StableDiffusionPipeline
    out = tmp_path / "img.png"
    pcli.main(["generate", "--cpu", "--prompt", "a cat", "--seed", "4",
               "--steps", "2", "--out", str(out)])
    assert capsys.readouterr().out.strip() == str(out)
    pipe = StableDiffusionPipeline(tiny_config(), device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    tcfg = pipe.config.text_encoder
    cond = hash_tokenize(tcfg.vocab_size, tcfg.max_length)(["a cat"])
    images, _ = pipe.generate(cond, torch.zeros_like(cond), seeds=[4],
                              num_steps=2)
    ref = np.asarray(psd.to_pil(images)[0])
    np.testing.assert_array_equal(np.asarray(Image.open(out)), ref)


def test_serve_end_to_end(tmp_path, capsys, monkeypatch):
    """Three stdin lines -> three PNGs and one JSON line with served 3."""
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "5\ta cat\na dog\n9\ta house\n"))
    out = tmp_path / "served"
    pcli.main(["serve", "--cpu", "--batch", "2", "--steps", "2",
               "--max-wait-ms", "200", "--out-dir", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert sorted(os.listdir(out)) == [f"img_{i:05d}.png" for i in range(3)]
    assert lines[:3] == [str(out / f"img_{i:05d}.png") for i in range(3)]
    summary = json.loads(lines[-1])
    assert summary["served"] == 3 and summary["batches"] >= 2


def test_train_runs_and_resumes(tmp_path, capsys):
    """Two ReLUfication steps from an imagefolder (finite losses, a
    checkpoint at 2), then a second call resumes and takes none."""
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(0)
    with open(data / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "text"])
        w.writeheader()
        for i in range(4):
            Image.fromarray(rng.randint(0, 255, (70, 70, 3), np.uint8)).save(
                str(data / f"i{i}.png"))
            w.writerow({"file_name": f"i{i}.png", "text": f"a photo {i}"})
    argv = ["train", "--cpu", "--data-dir", str(data), "--out-dir",
            str(tmp_path / "run"), "--batch", "2", "--max-steps", "2",
            "--log-every", "1", "--checkpoint-every", "2"]
    pcli.main(argv)
    assert json.loads(capsys.readouterr().out.strip())["steps"] == 2
    logs = [json.loads(l) for l in open(tmp_path / "run" / "train_log.jsonl")]
    assert [r["step"] for r in logs] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in logs)
    assert os.listdir(tmp_path / "run" / "checkpoints") == [
        "step_00000002.pt"]
    pcli.main(argv)
    assert json.loads(capsys.readouterr().out.strip())["steps"] == 2
    assert len(open(tmp_path / "run" / "train_log.jsonl").readlines()) == 2


@pytest.mark.parametrize("mode", list(pcli.MODE_KNOBS))
def test_parity_run_end_to_end(tmp_path, capsys, mode):
    """The whole flow on the tiny seeded weights under every --mode name:
    PARITY_RUN.md and parity_run.json with parity_ok; pad_proj A/Bs the
    exact path against itself (relative error 0)."""
    out = tmp_path / "parity"
    pcli.main(["parity-run", "--cpu", "--out-dir", str(out), "--concept",
               "Van Gogh", "--limit", "1", "--steps", "2", "--batch", "1",
               "--mode", mode])
    acc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert acc["pipeline_complete"] and acc["bake_parity_ok"]
    rep = json.loads((out / "parity_run.json").read_text())
    assert rep["bake"]["parity_ok"] and rep["wanda"]["skilled_entries"] > 0
    sm = rep["serving_mode"]
    assert sm["mode"] == mode and sm["tier_ok"]
    assert sm["knobs"] == pcli.MODE_KNOBS[mode][0]
    if mode == "pad_proj":
        assert sm["latent_rel_err_vs_exact"] == 0.0
    if mode.startswith("dc3"):
        assert sm["config_fields"]["deep_cache_interval"] == 3
        assert 0.0 < sm["latent_rel_err_vs_exact"] < sm["tier_bound"]
    md = (out / "PARITY_RUN.md").read_text()
    assert "parity_ok=True" in md and mode in md
    names = sorted(os.listdir(out / "images"))
    assert "sd_0.png" in names and "removed_0.png" in names
    for f in ("labels.npz", "wanda_masks.npz", "baked_unet.safetensors"):
        assert (out / f).exists(), f


def test_mode_fields_map_every_knob():
    """Every mode's knobs onto the port's config fields: the TPU layout
    knobs (DMOE_PAD_PROJ, DMOE_CHAIN_SHAPES) and DMOE_FF_FUSED add
    nothing."""
    fields = {m: pcli._mode_fields(k, dc)
              for m, (k, dc, _) in pcli.MODE_KNOBS.items()}
    assert fields["pad_proj"] == {} and fields["fff_pad"] == {}
    assert fields["chain_pad"] == fields["chain16_pad"] == {
        "conv_chain": True}
    assert fields["winof_pad"] == {"conv_winograd": "fused"}
    assert fields["attnabs_fff_pad"] == {"attn_absorb": "1"}
    assert fields["dc3_attnabs_fff_pad"] == {"attn_absorb": "1",
                                             "deep_cache_interval": 3}
    assert list(pcli.MODE_KNOBS) == [
        "pad_proj", "dc3", "dc3_pad", "fff_pad", "chain_pad", "chain16_pad",
        "winof_pad", "attnabs_pad", "attnabs_fff_pad", "dc3_fff_pad",
        "dc3_attnabs_fff_pad"]


@pytest.mark.parametrize("env,want", [
    ({}, {"conv_winograd": "1", "winograd_tile": 2}),
    ({"DMOE_WINO_TILE": "4"}, {"conv_winograd": "1", "winograd_tile": 4}),
    ({"DMOE_WINO_FUSED": "1"}, {"conv_winograd": "fused"})])
def test_winograd_flag_reads_the_environment_once(monkeypatch, env, want):
    for k in ("DMOE_WINO_FUSED", "DMOE_WINO_TILE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = pcli.build_parser().parse_args(["serve", "--cpu", "--winograd",
                                           "--int8", "--deep-cache", "2"])
    assert pcli._serving_modes(args) == dict(
        want, quant_int8=True, deep_cache_interval=2)


@pytest.mark.parametrize("argv", [
    ["generate", "--prompt", "a cat"],
    ["check-snapshot", "--snapshot", "absent"],
    ["score-dirs", "--a-dir", "a", "--b-dir", "b"]])
def test_without_cpu_raises_naming_cuda(argv):
    """No --cpu on a host without a card: an error that names CUDA, no
    fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pcli.main(argv)
