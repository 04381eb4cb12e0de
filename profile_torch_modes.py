"""Where a serving generate's device time goes, with the serving modes off,
with the exact-tier modes on, with the fused Winograd convs, and with W8A8
int8.

Runs the moefied SD1.5 text-to-image path at full width in bf16 (seeded
random weights, MoE top-k 0.3 over 20-neuron experts on all 16 FFs, CFG 7.5)
for 10 PNDM steps under `torch.profiler`, once with every mode off (leg
`off`), once with `attn_absorb` and `conv_chain` on (`exact`), once with
`conv_winograd="fused"` (`fused`, the UNet's and the VAE decoder's) and once
with `quant_int8` (`int8`: every routed FF through the routing kernel), and
prints for each the unprofiled wall time (every leg's before any trace),
the summed device time of all kernels, and the device time by kernel group.
Needs one CUDA card:

    python3 profile_torch_modes.py

The last line is one JSON object with every number printed.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

# kernel-name fragments -> group, first match wins
GROUPS = (
    ("conv chain kernel (kernel 7)", ("conv_chain_kernel",)),
    ("fused Winograd kernel (kernel 8)", ("winograd_kernel",)),
    ("fixed-order finish of a split depth (kernels 1, 6, 7, 8)",
     ("split_finish_kernel",)),
    ("LN + qkv kernel (kernel 5)", ("ln_qkv_kernel",)),
    ("out projection + residual kernel (kernel 6)", ("attn_out_kernel",)),
    ("FF LN pass and GEMM kernels (kernel 1: ln_rows, ff_up, ff_down)",
     ("ln_rows_kernel", "ff_up_kernel", "ff_down_kernel")),
    ("FF routing stage (kernels 1 and 4: route_scores, route_select, "
     "route_mask)", ("route_scores_kernel", "route_select_kernel",
                     "route_mask_kernel")),
    ("self-attention kernel (kernel 2)", ("sd_self_attn_kernel",)),
    ("cross-attention kernel (kernel 3)", ("sd_cross_attn_kernel",)),
    ("cuDNN convolutions and their layout transposes",
     ("cudnn", "fprop", "conv", "nchwToNhwc", "nhwcToNchw", "implicit_gemm")),
    ("GroupNorm, LayerNorm and the GroupNorm fold's reductions",
     ("norm", "RowwiseMoments", "var_mean", "welford", "reduce_kernel")),
    ("cuBLAS GEMMs", ("gemm", "gemv", "cublas", "nvjet", "cutlass")),
)
LEGS = {"off": {}, "exact": dict(attn_absorb="1", conv_chain=True),
        "fused": dict(conv_winograd="fused"), "int8": dict(quant_int8=True)}
TOP = 12        # kernels listed by name, so that the grouping can be checked
BATCH = 2
STEPS = 10


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "elementwise, copies, other"


def leg(modes: dict):
    """A warmed-up 10-step generate of the moefied pipeline with `modes`:
    returns the function that runs it and waits for the card."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                build_moe_interventions,
                                                sd15_config)
    from diffusion_models_moe_tpu_torch.taps import layer_name
    dev, steps = "cuda", STEPS
    cfg = sd15_config(torch.bfloat16, **modes)
    pipe = StableDiffusionPipeline(cfg, device=dev)
    pipe.init_params(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.RandomState(0)
    labels = {layer_name(i): rng.permutation(np.arange(4 * d) % ((4 * d) // 20))
              for i, d in enumerate(cfg.unet.ff_dims())}
    ivs = build_moe_interventions(labels, 0.3, device=dev, dtype=cfg.unet.dtype)
    tcfg = cfg.text_encoder
    cond = torch.randint(0, tcfg.vocab_size, (BATCH, tcfg.max_length),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    uncond = torch.zeros_like(cond)

    def run():
        pipe.generate(cond, uncond, seeds=[3, 4], num_steps=steps, ivs=ivs)
        torch.cuda.synchronize()

    run()                                           # warm-up
    return run


def walls_ms(run) -> list:
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def profile(modes: dict, run, walls: list) -> dict:
    from torch.profiler import ProfilerActivity, profile as torch_profile
    steps = STEPS
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        profiled = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    kernels = []
    for ev in prof.key_averages():
        # rows of device kernels only: aten::* rows repeat their kernels' time
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            g, ms = group_of(ev.key), ev.self_device_time_total / 1e3
            groups[g] = groups.get(g, 0.0) + ms
            kernels.append((ms, ev.count, g, ev.key))
    total = sum(groups.values())
    wall = float(np.median(walls))
    out = dict(modes=modes, steps=steps, unet_calls=steps + 1,
               wall_ms_runs=walls, wall_ms=wall, profiled_wall_ms=profiled,
               kernel_ms=total, busy_share=total / wall,
               groups_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])))
    print(f"modes {modes}: {steps}-step generate of {BATCH} requests "
          f"({steps + 1} UNet calls at batch {2 * BATCH}): unprofiled wall "
          f"{wall:.1f} ms (runs {', '.join(f'{w:.1f}' for w in walls)}), "
          f"profiled {profiled:.1f} ms, kernels {total:.2f} ms, busy share "
          f"{total / wall:.3f} of the unprofiled wall")
    for g, ms in out["groups_ms"].items():
        print(f"  {ms:9.2f} ms  {100 * ms / total:5.1f}%  {g}")
    for ms, count, g, key in sorted(kernels, reverse=True)[:TOP]:
        print(f"    {ms:9.2f} ms  {count:5d} calls  [{g}]  {key[:100]}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_modes: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    # every leg's walls before any trace: once torch.profiler has traced the
    # card, the process's launches stay slower
    runs = [leg(modes) for modes in LEGS.values()]
    walls = [walls_ms(run) for run in runs]
    results = [profile(modes, run, w)
               for modes, run, w in zip(LEGS.values(), runs, walls)]
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "results": results}))


if __name__ == "__main__":
    main()
