"""The SD family reads the same through the configuration-module interface
as through the harness code it replaced: for `sd15-moe`, `sdxl-moe` and the
tiny geometries, the expert labels, the weight plan (name, shape, std,
offset, float32 of every parameter, on the meta device), the noise of a few
seeds, the rooflines' work and `generate_flops` equal what the harness
computed before: digests and counts recorded from the former code."""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch
import torch.nn as nn

from bench_h100.harness import counts, loader, sd_family, weights
from bench_h100.harness.cell import Run
from bench_h100.harness.inputs import Inputs
from bench_h100.harness.outcome import Outcome
from bench_h100.tests.tiny import TINY, TINY_XL, TinyFamily, TinyXLFamily

SEED = 2 ** 40 + 3
NOISE_SEEDS = [0, SEED]
# recorded from the former harness: sha256 (first 16 hex digits) of the
# labels (int64 bytes, layer after layer), of the noise of NOISE_SEEDS
# (float32 bytes) and of repr() of the weight plan; the plan's length;
# `generate_flops` at (8 images, 50 steps, guidance 7.5) and (4, 20, 1.0);
# the number of routed FFs and the sum of their widths; the latent shape
RECORDED = {
    "sd15-moe": ("6b4be7d73ece0b1e", "38769fb4ff67af3e", "95238a7aa88db7aa",
                 1022, 646478677737472.0, 74621055696896.0, 16, 49920,
                 (4, 64, 64)),
    "sdxl-moe": ("ad60711a10efa0c8", "835a87c4329d6d55", "5186c6607cf34e73",
                 2533, 4966384085303296.0, 530855099138048.0, 70, 332800,
                 (4, 128, 128)),
    "tiny": ("3e7931378d021c84", "11ab309fb26e6491", "8bbb692980fd9024",
             828, 92719655157.76, 11753498378.24, 16, 4992, (4, 8, 8)),
    "tiny-xl": ("9f9ed449e8087040", "11ab309fb26e6491", "df14bfec784ecf54",
                797, 59590492160.0, 8188026880.0, 17, 4352, (4, 8, 8)),
}
# sha256 of the weights drawn on the CPU (group/name/dtype and the bytes of
# each tensor, in draw order), recorded from the former harness
RECORDED_WEIGHTS = {"tiny": "709772a288822180", "tiny-xl": "1c00db8ffd3d0a34"}


def _config(name):
    if name == "tiny":
        return TINY, TinyFamily
    if name == "tiny-xl":
        return TINY_XL, TinyXLFamily
    cell = loader.load_cell({"sd15-moe": "sd15-moe.gen-b8",
                             "sdxl-moe": "sdxl-moe.gen-b4"}[name])
    return cell.config, cell.family


def _digest(chunks) -> str:
    return hashlib.sha256(b"".join(chunks)).hexdigest()[:16]


NAMES = sorted(RECORDED)


@pytest.mark.parametrize("name", NAMES)
def test_labels_are_unchanged(name):
    cfg, fam = _config(name)
    got = Inputs(cfg, SEED, fam).labels()
    assert [len(lab) for lab in got] == fam.ff_widths(cfg)
    assert _digest(lab.astype(np.int64).tobytes() for lab in got) == \
        RECORDED[name][0]


@pytest.mark.parametrize("name", NAMES)
def test_the_weight_plan_is_unchanged(name):
    cfg, fam = _config(name)
    modules = fam.skeleton(cfg)
    got = weights.plan(modules, fam.NORMS)
    assert len(got) == RECORDED[name][3]
    assert hashlib.sha256(repr(got).encode()).hexdigest()[:16] == \
        RECORDED[name][2]


@pytest.mark.parametrize("name", ["tiny", "tiny-xl"])
def test_the_drawn_weights_are_unchanged(name):
    cfg, fam = _config(name)
    got = weights.make(fam.skeleton(cfg), SEED, "cpu", norms=fam.NORMS)
    assert _digest(f"{g}/{k}/{t.dtype}".encode()
                   + t.reshape(-1).view(torch.uint8).numpy().tobytes()
                   for g in got for k, t in got[g].items()) == \
        RECORDED_WEIGHTS[name]


@pytest.mark.parametrize("name", NAMES)
def test_the_noise_is_unchanged(name):
    cfg, fam = _config(name)
    got = Inputs(cfg, SEED, fam).noise(NOISE_SEEDS, "cpu")
    assert tuple(got.shape) == (len(NOISE_SEEDS), *RECORDED[name][8])
    assert _digest([got.numpy().tobytes()]) == RECORDED[name][1]


def _shapes(cfg):
    """(b, s, c) inputs of the FFs and self-attentions of a generate: every
    width at each level's tokens, at CFG batches of 8 and 16."""
    s = cfg["sample_size"]
    dims = sorted(set(sd_family.ff_dims(cfg["unet"])))
    return [(b, (s >> level) ** 2, c) for b in (8, 16)
            for level, c in enumerate(dims)]


@pytest.mark.parametrize("name", NAMES)
def test_the_rooflines_work_is_unchanged(name):
    cfg, fam = _config(name)
    shapes = _shapes(cfg)
    for b, s, c in shapes:
        assert fam.ff_work(cfg, (b, s, c)) == counts.ff(
            b * s, c, cfg["unet"]["ff_mult"], cfg["moe"])
        assert fam.attn_work(cfg, (b, s, c)) == counts.self_attn(b, s, c)
    run = _traced_run(cfg, fam, shapes)
    # the former readers: 100 x the least seconds of the counted work of
    # every noted call over the range's device seconds
    former = {
        "roofline.ff.gen": lambda b, s, c: counts.ff(
            b * s, c, cfg["unet"]["ff_mult"], cfg["moe"]),
        "roofline.attn.gen": counts.self_attn}
    for metric, work in former.items():
        reader = loader.load_module(loader.BENCH / "metrics" / f"{metric}.py")
        least = 0.0
        for shape in shapes:
            least += counts.least_seconds(*work(*shape))
        assert reader.read(run) == 100.0 * least / 0.25


def _traced_run(cfg, fam, shapes):
    """A traced run whose trace noted `shapes` in both ranges, with 0.25 s
    of device time each."""
    cell = dataclasses.replace(loader.load_cell("sd15-moe.gen-b8"),
                               config=cfg, family=fam)
    trace = {"calls": {"bench.ff": shapes, "bench.attn1": shapes},
             "range_device_s": {"bench.ff": 0.25, "bench.attn1": 0.25}}
    return Run(cell, Outcome(0.0, 1.0, [], [], 50, 7.5), 1.0, 0, trace)


@pytest.mark.parametrize("name", NAMES)
def test_generate_flops_are_unchanged(name):
    cfg, fam = _config(name)
    assert fam.generate_flops(cfg, 8, 50, 7.5) == RECORDED[name][4]
    assert fam.generate_flops(cfg, 4, 20, 1.0) == RECORDED[name][5]


@pytest.mark.parametrize("name", NAMES)
def test_the_family_reads_its_widths_and_shape_from_the_unet(name):
    cfg, fam = _config(name)
    widths = fam.ff_widths(cfg)
    assert (len(widths), sum(widths)) == RECORDED[name][6:8]
    assert fam.latent_shape(cfg) == RECORDED[name][8]
    assert fam.NORMS == (nn.GroupNorm, nn.LayerNorm)
    assert fam.CONTROLS == {"int8": {"quant_int8": True}}
