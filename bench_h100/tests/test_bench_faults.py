"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have (the exchange between chips has no place here:
every cell runs on one card): a step that returns its state unchanged; half
of the batch left out and the mean of the rest given in its place; an
answer altered where it is produced (two requests' images swapped); and
parts of the model that a fused kernel could drop: every GroupNorm's scale
and shift, and the bias of every FF's output product. The
run skips the look for a card and drives the rest of a run on the CPU, at
the port's tiny geometry in float32, with each cell's own compared numbers
and limits. The tiny geometry keeps every expert (top-k ratio 1): with its
6 experts a layer and k = 1, a float32 rounding difference between the
port and the reference flips near-tied experts over a sizable share of a
64-pixel image, a scale the cells' limits were not set for; the routing
itself is held to the reference in `test_bench_reference.py`."""
import pytest
import torch
import torch.nn.functional as F

from bench_h100.harness import loader
from bench_h100.harness.cell import run_cell, verdict
from bench_h100.tests.tiny import TINY, TINY_XL, tiny_cell
from diffusion_models_moe_tpu_torch.models import (attention, layers, unet,
                                                  vae)
from diffusion_models_moe_tpu_torch.models.attention import GEGLUFeedForward
from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import \
    StableDiffusionPipeline
from diffusion_models_moe_tpu_torch.pipelines.sdxl import SDXLPipeline
from diffusion_models_moe_tpu_torch.schedulers.euler import \
    EulerDiscreteScheduler
from diffusion_models_moe_tpu_torch.schedulers.pndm import PNDMScheduler

CELLS = {"sd15-moe.gen-b8": ("gen-b8", {"batch": 4, "steps": 3}, 0.5),
         "sdxl-moe.gen-b4": ("gen-b4", {"batch": 4, "steps": 3}, 0.5),
         "sd15-moe.serve-poisson": ("serve-poisson",
                                    {"batch": 4, "steps": 3, "rate_per_s": 4.0,
                                     "max_wait_ms": 200, "drain_s": 30}, 1.5)}


def _cell(name):
    traffic, mix, _ = CELLS[name]
    real = loader.load_cell(name)
    config = TINY_XL if real.config["pipeline"] == "sdxl" else TINY
    config = dict(config, moe=dict(config["moe"], topk_ratio=1.0))
    return tiny_cell(traffic, mix, requests=4, config=config), real.check


def _run(name):
    cell, check = _cell(name)
    cell.check = dict(check, requests=4, reference_batch=4)
    run, checks = run_cell(cell, 2 ** 35 + 9, CELLS[name][2], False, "cpu")
    return verdict(run, checks), checks


def _half_batch(orig):
    def generate(self, cond_ids, uncond_ids, *args, seeds=None, **kw):
        b = cond_ids.shape[0]
        h = max(b // 2, 1)
        out, taps = orig(self, cond_ids[:h], uncond_ids[:h], *args,
                         seeds=None if seeds is None else list(seeds)[:h], **kw)
        rest = out.mean(0, keepdim=True).expand(b - h, *out.shape[1:])
        return torch.cat([out, rest]), taps
    return generate


def _swapped(orig):
    def generate(self, *args, **kw):
        out, taps = orig(self, *args, **kw)
        return out[torch.tensor([1, 0] + list(range(2, out.shape[0])))], taps
    return generate


def _group_norm_without_affine(norm, x):
    return F.group_norm(x.float(), norm.num_groups, None, None, norm.eps)


def _ff_bias_dropped(orig):
    @torch.no_grad()
    def load_state_dicts(self, state_dicts):
        orig(self, state_dicts)
        for m in self.unet.modules():
            if isinstance(m, GEGLUFeedForward):
                m.net[2].bias.zero_()
    return load_state_dicts


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_sound_tiny_run_is_correct(name):
    ok, checks = _run(name)
    assert ok, checks


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "swapped",
                                   "norm_affine_dropped", "ff_bias_dropped"])
def test_a_fault_underneath_is_not_correct(name, fault, monkeypatch):
    if fault == "norm_affine_dropped":
        for module in (layers, unet, vae, attention):
            monkeypatch.setattr(module, "group_norm_f32",
                                _group_norm_without_affine)
    elif fault == "ff_bias_dropped":
        monkeypatch.setattr(StableDiffusionPipeline, "load_state_dicts",
                            _ff_bias_dropped(
                                StableDiffusionPipeline.load_state_dicts))
    elif fault == "state_unchanged":
        for sched in (PNDMScheduler, EulerDiscreteScheduler):
            monkeypatch.setattr(sched, "step",
                                lambda self, state, coeffs, eps, i, sample:
                                (state, sample))
    else:
        wrap = _half_batch if fault == "half_batch" else _swapped
        for pipe in (StableDiffusionPipeline, SDXLPipeline):
            monkeypatch.setattr(pipe, "generate", wrap(pipe.generate))
    ok, checks = _run(name)
    assert not ok, checks
