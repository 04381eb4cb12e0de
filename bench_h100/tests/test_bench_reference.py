"""The frozen reference against the port's plain path, on the port's
`tiny_config` in float32 on the CPU, with the same weights, labels, ids and
noise. Only this test imports both."""
import torch

import diffusion_models_moe_tpu_torch as port
from bench_h100.harness import check, weights
from bench_h100.harness.inputs import Inputs
from bench_h100.harness.sd_family import NORMS, check_port_config, skeleton
from bench_h100.reference.sd_ref import Reference
from bench_h100.tests.tiny import TINY, TINY_XL, TinyFamily, _tiny_xl
from diffusion_models_moe_tpu_torch.taps import layer_name

def _compare(cfg, pipe, seed=11, steps=3):
    inputs = Inputs(cfg, seed, TinyFamily)
    sds = weights.make(skeleton(cfg), seed, "cpu", torch.float32, norms=NORMS)
    pipe.load_state_dicts(sds)
    labels = inputs.labels()
    ivs = port.build_moe_interventions(
        {layer_name(i): lab for i, lab in enumerate(labels)}, 0.3,
        device="cpu")
    cond, uncond = inputs.ids([0, 1])
    seeds = [inputs.request_seed(0), inputs.request_seed(1)]
    served, _ = pipe.generate(cond, uncond, seeds=seeds, num_steps=steps,
                              guidance_scale=7.5, ivs=ivs)
    ref = Reference(cfg)
    ref.load(sds)
    ref.set_routing(labels, 0.3)
    want = ref.generate(cond, uncond, inputs.noise(seeds, "cpu"), steps, 7.5)
    err = (served - want).norm() / want.norm()
    assert float(err) < 2e-5, float(err)
    assert float(want.std()) > 0.01


def test_reference_equals_the_port_sd():
    pipe = port.StableDiffusionPipeline(port.tiny_config(), device="cpu")
    check_port_config(TINY, pipe.config, (pipe.config.text_encoder,))
    _compare(TINY, pipe)


def test_reference_equals_the_port_sdxl():
    cfg, text = _tiny_xl(torch.float32)
    pipe = port.SDXLPipeline(cfg, text, device="cpu")
    check_port_config(TINY_XL, cfg, text)
    _compare(TINY_XL, pipe)


def test_the_floor_run_departs_from_float32_by_rounding_alone():
    inputs = Inputs(TINY, 5, TinyFamily)
    ref = Reference(TINY)
    ref.load(weights.make(skeleton(TINY), 5, "cpu", norms=NORMS))
    ref.set_routing(inputs.labels(), 0.3)
    cond, uncond = inputs.ids([0, 1])
    z = inputs.noise([inputs.request_seed(0), inputs.request_seed(1)], "cpu")
    exact = ref.generate(cond, uncond, z, 2, 7.5)
    floor = ref.generate(cond, uncond, z, 2, 7.5, bf16=True)
    assert floor.dtype == torch.float32
    err = float((floor - exact).norm() / exact.norm())
    assert 1e-4 < err < 0.2, err


def test_the_floor_share_counts_values_beyond_k_floor_rms():
    ref = torch.zeros(2, 3, 4, 4)
    floor = ref + torch.tensor([0.01, 0.02]).view(2, 1, 1, 1)
    served = ref.clone()
    served[0, 0, 0, 0] = 0.05        # beyond 4 x 0.01
    served[1, 0, 0, 0] = 0.05        # within 4 x 0.02
    served[1, 1, 0, 0] = -0.09       # beyond it
    assert check.px_off_floor_share(served, ref, floor, 4) == 2 / 96
