"""A configuration of a family with no UNet runs through the harness as
files alone: the tiny PixArt family of `pixart_family.py` (a DiT, T5 with
its RMSNorm, non-gated FFs under MoE routing; its configuration dict has no
`unet` key), driven through `run_cell` on the CPU, traced and untraced.
The labels reach the program's routing and the reference's alike, the
noise has the DiT's latent shape, the tracer wraps the DiT's `attn1` and
`ff`, the rooflines count the family's work over the noted shapes, the
family's control reaches `control.py`, and a routing fault fails the
check."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from bench_h100.harness import loader, weights
from bench_h100.harness.cell import run_cell, verdict
from bench_h100.harness.counts import least_seconds
from bench_h100.harness.inputs import Inputs
from bench_h100.harness.trace import RANGES, Tracer
from bench_h100.tests import pixart_family as pixart

SEED = 2 ** 34 + 7
SECONDS = 1.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(family=pixart) -> loader.Cell:
    real = loader.load_cell("sd15-moe.gen-b8")
    kind = loader.load_module(loader.BENCH / "traffic" / "closed_batch.py")
    return loader.Cell(f"{pixart.NAME}.gen-b2", dict(real.entry),
                       json.loads(json.dumps(pixart.CONFIG)), family,
                       dict(pixart.MIX), kind, dict(pixart.CHECK),
                       real.metrics)


def _recording(labels_fault=None):
    """The family, with each program and reference it builds kept, and the
    program's labels passed through `labels_fault`."""
    seen = {"programs": [], "references": [], "noise": []}

    def build(cfg, state_dicts, labels, device, modes=None):
        if labels_fault is not None:
            labels = labels_fault(labels)
        seen["programs"].append(pixart.build(cfg, state_dicts, labels,
                                             device, modes))
        return seen["programs"][-1]

    class Reference(pixart.Reference):
        def generate(self, cond_ids, uncond_ids, noise, *args, **kw):
            seen["noise"].append(noise)
            return super().generate(cond_ids, uncond_ids, noise, *args, **kw)

    def reference(cfg, device):
        seen["references"].append(Reference(cfg, device))
        return seen["references"][-1]

    fam = types.SimpleNamespace(**dict({n: getattr(pixart, n)
                                        for n in loader.FAMILY},
                                       build=build, reference=reference))
    loader.check_family(fam, "pixart_family")
    return fam, seen


@pytest.fixture(scope="module")
def runs():
    out = {}
    for traced in (False, True):
        fam, seen = _recording()
        run, checks = run_cell(_cell(fam), SEED, SECONDS, traced, "cpu")
        out[traced] = run, checks, seen
    return out


def _routed_labels(ivs) -> list:
    return [iv.patterns.float().argmax(0).cpu().numpy() for iv in ivs]


@pytest.mark.parametrize("traced", [False, True])
def test_the_family_runs_correct(runs, traced):
    run, checks, _ = runs[traced]
    assert "unet" not in run.config
    assert verdict(run, checks), checks
    assert run.outcome.requests and not run.outcome.failed


@pytest.mark.parametrize("traced", [False, True])
def test_the_labels_reach_the_program_and_the_reference(runs, traced):
    run, _, seen = runs[traced]
    labels = Inputs(run.config, SEED, pixart).labels()
    t = run.config["transformer"]
    assert [len(lab) for lab in labels] == [4 * t["hidden_size"]] * t["num_layers"]
    (program,), (ref,) = seen["programs"], seen["references"]
    for got in (_routed_labels(program.ivs), _routed_labels(ref.ivs)):
        assert len(got) == len(labels)
        assert all(np.array_equal(g, lab) for g, lab in zip(got, labels))
    k = {iv.k for iv in program.ivs} | {iv.k for iv in ref.ivs}
    assert k == {max(int(len(set(labels[0])) * 0.3), 1)}


def test_the_noise_has_the_dits_latent_shape(runs):
    run, _, seen = runs[False]
    shape = pixart.latent_shape(run.config)
    assert shape == (4, 8, 8)
    assert seen["noise"] and all(z.shape[1:] == shape for z in seen["noise"])
    inputs = Inputs(run.config, SEED, pixart)
    seeds = [inputs.request_seed(i) for i in range(3)]
    (program,) = seen["programs"]
    # the determinism contract: the program's own noise for these seeds
    assert torch.equal(inputs.noise(seeds, "cpu"),
                       program.pipe.seeded_noise(seeds))


def test_the_tracer_wraps_the_dits_attn1_and_ff(runs):
    run, _, seen = runs[True]
    (program,) = seen["programs"]
    tracer = Tracer(program.denoiser, 0.0, "cpu")
    tracer.install()
    layers = run.config["transformer"]["num_layers"]
    assert len(tracer._hooks) == 2 * 2 * layers
    tracer.remove()
    names = [n for n, _ in program.denoiser.named_modules()
             if n.endswith(tuple(RANGES))]
    assert names == [f"transformer_blocks.{i}.{m}" for i in range(layers)
                     for m in ("attn1", "ff")]
    calls = run.trace["calls"]
    s, batch = run.config["sample_size"], run.cell.mix["batch"]
    # classifier-free guidance doubles the batch; 2 x 2 patches a token
    want = (2 * batch, (s // 2) ** 2, run.config["transformer"]["hidden_size"])
    for rng in RANGES.values():
        assert calls[rng] and set(calls[rng]) == {want}
        assert len(calls[rng]) % (layers * run.cell.mix["steps"]) == 0


@pytest.mark.parametrize("metric,work", [("roofline.ff.gen", "ff_work"),
                                         ("roofline.attn.gen", "attn_work")])
def test_the_rooflines_count_the_familys_work(runs, metric, work):
    run, _, _ = runs[True]
    reader = loader.load_module(loader.BENCH / "metrics" / f"{metric}.py")
    shapes = run.trace["calls"][reader.RANGE]
    device_s = 1e-3 * len(shapes)
    trace = dict(run.trace, range_device_s={reader.RANGE: device_s})
    got = reader.read(dataclasses.replace(run, trace=trace))
    fam = getattr(pixart, work)
    want = 100.0 * sum(least_seconds(*fam(run.config, s))
                       for s in shapes) / device_s
    assert got == pytest.approx(want, rel=1e-12)
    # the DiT's count, not the SD family's from the same shapes
    from bench_h100.harness import sd_family
    sd_cfg = dict(run.config, unet={"ff_mult": 4})
    sd = getattr(sd_family, work)(sd_cfg, shapes[0])
    assert fam(run.config, shapes[0]) != sd


def test_mfu_reads_the_familys_generate_count(runs):
    run, _, _ = runs[True]
    reader = loader.load_module(loader.BENCH / "metrics" / "mfu.gen.py")
    o = run.outcome
    gens = len(o.untraced) // run.cell.mix["batch"]
    want = (100.0 * gens * pixart.generate_flops(run.config, 2, 2, 4.5)
            / (o.t_split - o.t0) / 989e12)
    assert gens and reader.read(run) == pytest.approx(want, rel=1e-12)


def test_t5_norms_draw_as_norms():
    plan = weights.plan(pixart.skeleton(pixart.CONFIG), pixart.NORMS)
    t5 = [(name, rule) for group, name, _, rule in plan
          if group == "text_encoder" and "layer_norm" in name]
    assert t5 and all(rule == (weights.AFFINE_STD, 1.0, True)
                      for _, rule in t5)
    drawn = weights.make(pixart.skeleton(pixart.CONFIG), SEED, "cpu",
                         norms=pixart.NORMS)["text_encoder"]
    scale = drawn[t5[0][0]]
    assert scale.dtype == torch.float32
    assert 0.5 < float(scale.mean()) < 1.5 and 0.02 < float(scale.std()) < 0.3


def _shuffled(labels):
    rng = np.random.default_rng(3)
    return [rng.permutation(lab) for lab in labels]


def test_labels_shuffled_in_the_program_are_not_correct():
    fam, seen = _recording(labels_fault=_shuffled)
    run, checks = run_cell(_cell(fam), SEED, SECONDS, False, "cpu")
    assert not verdict(run, checks), checks
    assert checks["img_rel_l2"]["value"] > 10 * pixart.CHECK["limits"][
        "img_rel_l2"]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A checkout of the benchmark with the family added as files alone,
    the port beside it."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(loader.BENCH, root / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(loader.MANIFEST, root / "BENCHMARK.json")
    (root / "diffusion_models_moe_tpu_torch").symlink_to(
        loader.ROOT / "diffusion_models_moe_tpu_torch")
    return root, pixart.add_to_checkout(root)


def _control(root, cell, variant):
    return subprocess.run(
        [sys.executable, "bench_h100/control.py", "--workload", cell,
         "--seconds", "0.5", "--variant", variant, "--seeds", str(SEED),
         "--device", "cpu"], cwd=root, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_the_familys_control_reaches_control_py(checkout):
    root, cell = checkout
    readings = {}
    for variant in ("program", "bf16"):
        out = _control(root, cell, variant)
        assert out.returncode == 0, out.stderr[-3000:]
        readings[variant] = json.loads(
            out.stdout.strip().splitlines()[-1])["checks"]["img_rel_l2"]
    assert readings["program"]["value"] <= readings["program"]["limit"]
    assert readings["bf16"]["value"] > readings["bf16"]["limit"]
    out = _control(root, cell, "int8")
    assert out.returncode == 2 and "'bf16'" in out.stderr


@torch.no_grad()
def test_the_familys_counts_match_the_operation_counter():
    """`generate_flops`'s DiT and T5 parts against torch's counter over the
    port's modules: dense (every expert), less the routing's score sums."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = dict(pixart.CONFIG, moe=dict(pixart.CONFIG["moe"], topk_ratio=1.0))
    pipe = pixart.PixArtPipeline(pixart.port_config(cfg), device="cpu")
    t, b, tokens = cfg["transformer"], 2, 16
    with FlopCounterMode(display=False) as fc:
        pipe.transformer(torch.zeros(b, 4, 8, 8), 500,
                         torch.zeros(b, 16, t["text_in_dim"]))
    hidden = t["ff_mult"] * t["hidden_size"]
    assert fc.get_total_flops() == (pixart._dit(cfg, b)
                                    - t["num_layers"] * b * tokens * hidden)
    with FlopCounterMode(display=False) as fc:
        pipe.text_encoder(torch.zeros(3, 16, dtype=torch.long))
    assert fc.get_total_flops() == pixart._t5(cfg["text_encoders"][0], 3)
