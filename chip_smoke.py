#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (diffusion_models_moe_tpu_torch) on
one NVIDIA GPU: the quickest proof that the port builds, is right and runs
its main path on the card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     and the build of the hand-written kernels from ops/csrc/;
  2. each kernel against its plain PyTorch version (f32 math on the same
     bf16 inputs) at the SD1.5 shapes of the main path, with errors and
     CUDA-event times of both; kernel 1 (and 2b: kernel 4) also timed from a
     CUDA graph, cuBLAS on its two products alone as a yardstick, and the
     sums over the 16 FFs of a UNet call (each of its launches apart comes
     last, phase 9); the attention
     kernels also at ragged S, at
     fewer valid keys, on the (B, S, 3C) column thirds of kernel 5, at head
     dim 64, with SDPA as the yardstick and the wrapper's host time;
  2b. the fused MoE routing kernel of the unfused FF path against its plain
     version at the four SD1.5 FF shapes, with errors and times;
  2c. the absorbed-attention kernels (LN + qkv projection, out projection +
     residual) at the four SD1.5 self-attention shapes (from CUDA graphs
     and by events, with the wrappers' host time, each shape's plan and
     cuBLAS on the products alone as a yardstick) and the conv-chain
     kernel at the 14 SD1.5 resblock conv shapes (with the time embedding,
     with and without a residual), against their plain versions; for the
     conv chain also the time of the unfused sequence it replaces
     (group_norm, silu, conv2d, adds), as a yardstick only;
  3. the main path: moefied SD1.5 text-to-image in bf16 (seeded random
     weights, MoE routing on all 16 FFs with topk 0.3), 2 requests at
     512x512 through `generate`, PNDM at the config's 50 steps with CFG 7.5,
     VAE decode; wall time, img/s, peak memory, and the kernels' launch
     counts during that run;
  4. `denoise` for 3 and for 50 steps from the same latents with the
     kernels and with their plain versions: latent relative error, held
     against the bf16-vs-f32 floor of the card (the plain versions in an f32
     copy of the model) and, at 50 steps, below 0.05;
  4b. where the kernels' predicates say no: a 3-step `generate` of that f32
     SD1.5 pipeline and a `tiny_config` `generate` run on the card, launch no
     kernel and hand every attention and FF call to a plain version (the
     `plain:` counters); on every SD1.5 bf16 path those counters stay 0;
  5. skill attribution and neuron erasure: `collect_predictivity` under MoE
     routing over 2 (base, concept) prompt pairs through the hash tokenizer
     (max-gate taps: every FF call takes the routing kernel, none the fused
     FF), the paired t-test's neuron masks, a 2-request 512x512 `generate`
     with those neurons removed under MoE routing, and that erased
     `denoise` with kernels against plain versions and the card's floor;
  6. Wanda erasure: `wanda_pipeline` on the same pairs at WANDA_STEPS PNDM
     steps, a `generate` with the output-weight masks under MoE routing
     (routing kernel), and the masks' union over timesteps baked into the
     UNet weights, then a `generate` on the fused FF kernel.
  7. the serving engine with the exact-tier modes on: a
     `ServingEngine(batch_size=2)` over a pipeline with `attn_absorb="1"`
     and `conv_chain=True` (the same seeded weights) serves 3 seeded requests
     at 50 steps (one full batch, one padded); images uint8 and finite,
     request 0 served alone equals request 0 co-batched, the launch counts
     of the kernels, `denoise` latents with the modes on against the
     modes off within the card's floor, and the same traffic through an
     engine with the modes off;
  2d. (run after 2c) the fused Winograd F(2x2, 3x3) kernel against its plain
     version, the formulation of ops/winograd.py on the same hoisted filter,
     at every distinct shape the UNet (batch 4) and the VAE decoder (batch 2)
     give it, with cuDNN's convolution on the same tensors as the yardstick
     and the count of convs of that shape per call;
  8. the remaining serving modes: a `ServingEngine(batch_size=2)` over a
     pipeline with `conv_winograd="fused"` on the UNet and the VAE serves the
     3 seeded requests of phase 7 (kernel 8's launches per batch and per
     shape held to the tables of phase 2d, the chain kernel at 0, request 0
     alone equal to co-batched, `denoise` latents against the modes-off
     pipeline within the card's floor); then `quant_int8` (a 50-step generate
     of 2 requests: no fused FF, every FF through the routing kernel;
     request 0 equal whatever shares its batch) and `deep_cache_interval=3`
     (full and shallow UNet calls counted through the FF kernel's launches),
     each with its latent error against the exact path, held below
     APPROX_FACTOR of what two unrelated samples differ by on this card;
  2e. (run after 2d) kernels 1, 2, 3, 5, 6 and 7 at every SD2.1-768 shape
     of their kind (UNet batch 4, 96 x 96 latents: 9216 to 144 tokens, 5 to
     20 heads of 64, FFs up to 36 864 rows, convs at 96 to 12 side) against
     their plain versions, with the same times, bounds and yardsticks as at
     SD1.5, and their sums over one SD2.1 UNet call;
  10. the SD2.1-768 path: `sd21_config(torch.bfloat16)` with seeded random
     weights, MoE routing on all 16 FFs, the hash tokenizer, 2 requests,
     DDIM v-prediction at 50 steps with CFG 7.5, decoded to 768 x 768:
     wall, img/s, peak memory, kernels 1-3 at 16 launches a UNet call and
     no plain call; `denoise` latents with kernels against plain versions
     after 3 and SD21_LONG_STEPS steps within the card's own SD2.1
     bf16-vs-f32 floor; the same requests with `attn_absorb="1"` and
     `conv_chain=True` (kernels 5, 6, 7 at their counts, latents against
     the modes-off path within that floor);
  11. the other schedulers on the SD1.5 geometry: Euler at 50 steps,
     DPM-Solver++ 2M at 20 and LCM at 4 (a UNet with the 256-wide guidance
     embedding, guidance 8.0), each a timed 2-request generate with its
     launch counts and its `denoise` latents, kernels against plain
     versions, within its own bf16-vs-f32 floor (LCM's runs on one injected
     step noise); then a `ServingEngine(batch_size=2)` over the LCM
     pipeline serving the 3 seeded requests of phase 7, request 0 alone
     equal to co-batched;
  9. each launch of kernel 1 apart (LN pass, ff_up, routing stage, ff_down)
     at phase 2's shapes, by torch.profiler: last, because launches stay
     slower in a process whose card the profiler has traced.
Every kernel's line carries its bound: the largest of its tensor-core
operations over 989 TFLOP/s (bf16, dense), the bytes it must move over 3.35
TB/s and, for attention, its exponentials over 16 a clock an SM at the
card's maximum SM clock (nvidia-smi clocks.max.sm). Each
phase prints its wall time. It needs CUDA and exits non-zero on any
failure, printing no result. Its second-to-last line is a JSON object
describing each kernel, its last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
FF_REL_TOL = 2e-2        # max |kernel - plain| / max |plain| on agreeing rows
# Least shares of FF routing decisions, and of rows whose whole expert set,
# agree between kernel and plain version: about 5x and 4x the worst
# disagreement measured on an H100 (1 - 0.999996 and 1 - 0.999756).
FF_DECISION_AGREEMENT = 0.99998
FF_ROW_AGREEMENT = 0.999
# Every routing decision on which kernel and plain version disagree is a near
# tie: its expert's plain score lies within this share of its row's k-th
# score. (The gate is rounded to bf16 before the scores, in both; its f32
# products summed in another order round to another bf16 now and then.)
FF_NEAR_TIE = 0.02
ATTN_REL_TOL = 2e-2      # max |kernel - plain| / max |plain|
# ||z_kernels - z_plain|| / ||z_plain||: below FLOOR_FACTOR x the bf16-vs-f32
# floor measured on the card in the same run, and below LATENT_REL_TOL after
# the config's 50 steps (the step count of the TPU's 0.0484 floor). After 3
# steps with CFG 7.5 the MoE routing amplifies any rounding difference: bf16
# against f32 alone differs by ~0.1 there.
FLOOR_FACTOR = 1.5
LATENT_REL_TOL = 0.05
BATCH = 2                # requests, one prompt each; CFG doubles the UNet batch
# (base, concept) prompt pairs of the attribution and erasure phases
BASE = ["a photo of a dog", "a photo of a house"]
ADJ = ["a dog in the style of Van Gogh", "a house in the style of Van Gogh"]
# Wanda ranks each (D, H) slice of every layer at every step on the host;
# 10 PNDM steps keep phase 6 near a minute at full width
WANDA_STEPS = 10
WANDA_SKILL_RATIO = 0.02   # the JAX CLI's bake ratio for "Van Gogh"
UNION_RATIO = 0.0          # its union-over-timesteps ratio for "Van Gogh"
DEV = "cuda"
PEAK_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate (data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM HBM3 rate (data sheet)
# exponentials a second: 16 a clock an SM (ex2 on the special-function
# units of sm_90) x SMs x the maximum SM clock that nvidia-smi reports
EXP_PER_CLOCK_PER_SM = 16
EXP_RATE = [0.0]
# (tokens, channels) of the UNet levels; the UNet batch is 2 x BATCH with CFG
LEVELS = ((4096, 320), (1024, 640), (256, 1280), (64, 1280))
LEVEL_BLOCKS = (5, 5, 5, 1)   # transformer blocks of SD1.5 at each level
# (tokens, channels, heads) of the attention levels: SD1.5 (8 heads of 40,
# 80, 160) and SD2.1-768 (96 x 96 latents; 5, 10, 20, 20 heads of 64), each
# with the same transformer blocks a level
SD15_ATTN = tuple((s, c, 8) for s, c in LEVELS)
SD21_ATTN = ((9216, 320, 5), (2304, 640, 10), (576, 1280, 20), (144, 1280, 20))
# (side, Cin, Cout) of every 3x3 resblock conv of SD1.5, and how many convs
# of a UNet call have that shape
CONV_SHAPES = ((64, 320, 320), (64, 640, 320), (64, 960, 320),
               (32, 320, 640), (32, 640, 640), (32, 960, 640),
               (32, 1280, 640), (32, 1920, 640),
               (16, 640, 1280), (16, 1280, 1280), (16, 1920, 1280),
               (16, 2560, 1280), (8, 1280, 1280), (8, 2560, 1280))
CONV_COUNTS = (7, 2, 1, 1, 6, 1, 1, 1, 1, 6, 1, 2, 11, 3)
# the same convs at SD2.1-768's 96, 48, 24 and 12 side
SD21_CONV_SHAPES = tuple((3 * side // 2, cin, cout)
                         for side, cin, cout in CONV_SHAPES)
RESNETS = 22             # resblocks of the SD1.5 UNet, two 3x3 convs each
# (side, Cin, Cout) of every stride-1 3x3 conv that takes the fused Winograd
# kernel, and how many convs of one call have that shape. UNet (batch
# 2 x BATCH): the 30 resblock convs above 8 x 8 and the 3 upsampler convs.
WINO_UNET = (((64, 320, 320), 7), ((64, 640, 320), 2), ((64, 960, 320), 1),
             ((64, 640, 640), 1), ((32, 320, 640), 1), ((32, 640, 640), 6),
             ((32, 960, 640), 1), ((32, 1280, 640), 1), ((32, 1920, 640), 1),
             ((32, 1280, 1280), 1), ((16, 640, 1280), 1), ((16, 1280, 1280), 7),
             ((16, 1920, 1280), 1), ((16, 2560, 1280), 2))
# VAE decoder (batch BATCH): 4 mid, 24 up and 3 upsampler convs
WINO_VAE = (((64, 512, 512), 10), ((128, 512, 512), 7), ((256, 512, 512), 1),
            ((256, 512, 256), 1), ((256, 256, 256), 5), ((512, 256, 256), 1),
            ((512, 256, 128), 1), ((512, 128, 128), 5))
WINO_UNET_CONVS, WINO_VAE_CONVS = 33, 31
# An approximate serving mode (int8, DeepCache) moves the latents by more
# than rounding. The repo's own yardstick for such modes (quality_modes.py)
# is the "decorrelated" distance: what the same prompts give from other
# initial noise, about 1.1 in relative L2. A mode is held below
# APPROX_FACTOR of that distance as measured on this card in this run: it
# must stay on its own sample's side of the halfway point to an unrelated
# one.
APPROX_FACTOR = 0.5


def implied_row_agreement(e: int) -> float:
    """The least share of rows whose whole expert set agrees that
    FF_DECISION_AGREEMENT implies for E experts: a row disagrees where one
    of its E decisions flips, and a near tie at the k-th score flips two
    (one expert in, one out). The limit of phase 2e's SD2.1 shapes."""
    return 1.0 - e * (1.0 - FF_DECISION_AGREEMENT) / 2


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, exps: float = 0.0) -> dict:
    """The least time the card could take: the largest of the tensor-core
    operations over the bf16 peak, the bytes (each input read once, each
    output written once) over the memory rate, and the exponentials over
    the special-function units' rate (16 a clock an SM at the card's maximum
    SM clock, EXP_RATE, set in main). `bound_by` is "bytes" or "operations"
    (tensor-core or exponential); `binds` says which of the three."""
    times = {"tensor operations": flops / PEAK_FLOPS * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3,
             "exponentials": exps / EXP_RATE[0] * 1e3 if exps else 0.0}
    binds = max(times, key=times.get)
    return dict(bound_ms=times[binds],
                bound_by="bytes" if binds == "bytes" else "operations",
                binds=binds, gflop=flops / 1e9, mbytes=nbytes / 1e6,
                gexp=exps / 1e9)


def per_call(shapes: list, counts: tuple, key: str) -> float:
    """Sum of a per-shape time over the calls one UNet call makes."""
    return sum(n * row[key] for n, row in zip(counts, shapes))


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    diff = (got.float() - ref.float()).abs()
    return diff.max().item(), (diff.max() / ref.float().abs().max()).item()


def labels_for(ff_dims, seed: int = 0) -> dict:
    """Random balanced 20-neuron expert labels per FF layer."""
    from diffusion_models_moe_tpu_torch.taps import layer_name
    rng = np.random.RandomState(seed)
    return {layer_name(i): rng.permutation(np.arange(4 * d) % ((4 * d) // 20))
            for i, d in enumerate(ff_dims)}


# ---------------------------------------------------------------- phase 2
# the launches of kernel 1 by the kernels' names (csrc/geglu_ff.cu)
FF_LAUNCHES = (("ln", ("ln_rows_kernel",)),
               ("ff_up", ("ff_up_kernel",)),
               ("routing", ("route_scores_kernel", "route_select_kernel",
                            "route_mask_kernel")),
               ("ff_down", ("ff_down_kernel", "split_finish_kernel")))


def launch_ms(fn, groups, iters: int = 20) -> dict:
    """Device ms a call of fn() by group of kernel names, from torch.profiler
    over `iters` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys((g for g, _ in groups), 0.0)
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for g, keys in groups:
            if any(k in ev.key for k in keys):
                out[g] += ev.self_device_time_total / 1e3 / iters
    return out


def check_ff(gen: torch.Generator, levels=SD15_ATTN, label: str = "SD1.5",
             row_limit=lambda e: FF_ROW_AGREEMENT) -> tuple[list, list]:
    """Kernel 1 against its plain version at the FF shape of each
    (tokens, channels, heads) level (N = 2 BATCH x tokens rows): routing
    decisions, rows whose expert set agrees (at least `row_limit(E)`),
    disagreements only at near ties, outputs on agreeing rows."""
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.ops import geglu_ff_fused as ffm
    from diffusion_models_moe_tpu_torch.taps import patterns_from_labels
    dev, bf16 = DEV, torch.bfloat16
    shapes, floors, kernels = [], [], []

    def rn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # N = CFG batch (2 x BATCH) x tokens of the UNet level
    for tokens, c, _ in levels:
        n, hdim = 2 * BATCH * tokens, 4 * c
        e = hdim // 20
        k = int(e * 0.3)
        x = rn(n, c)
        w1, b1 = rn(2 * hdim, c, scale=c ** -0.5), rn(2 * hdim, scale=0.1)
        w2, b2 = rn(c, hdim, scale=hdim ** -0.5), rn(c, scale=0.1)
        g = rn(c, scale=0.1, dtype=torch.float32) + 1.0
        bb = rn(c, scale=0.1, dtype=torch.float32)
        lab = np.random.RandomState(c).permutation(np.arange(hdim) % e)
        pat = patterns_from_labels(lab, e).to(dev, bf16)
        args = (x, w1, b1, w2, b2, pat, k)
        ln = dict(ln_scale=g, ln_bias=bb)
        y = ffm.geglu_ff_fused(*args, **ln)
        y_plain = ffm.geglu_ff_fused(*args, **ln, use_kernels=False)
        torch.cuda.synchronize()
        sel_k = ffm.kernel_selection(x, w1, b1, pat, k, **ln)
        _, ga = ffm.reference_gate(x, w1, b1, False, g, bb, 1e-5)
        sel_p = ffm.reference_selection(ga, pat, k, bf16)
        decision_agree = (sel_k == sel_p).float().mean().item()
        rows = (sel_k == sel_p).all(dim=1)
        row_agree = rows.float().mean().item()
        abs_e, rel = rel_err(y[rows], y_plain[rows])
        # how near to its row's k-th plain score each disagreeing decision is
        scores = ga.to(bf16).float() @ pat.float().t()
        kth = torch.topk(scores, k, dim=-1).values[:, -1:]
        gap = ((scores - kth).abs() / kth.abs())[sel_k != sel_p]
        tie_gap = gap.max().item() if gap.numel() else 0.0
        limit = row_limit(e)
        del y_plain, ga, scores
        # this shape's tensors bound now: phase 9 calls it again
        kern = lambda a=args, kw=ln: ffm.geglu_ff_fused(*a, **kw)  # noqa: E731
        ms = graph_ms(kern)
        call_ms = cuda_ms(kern, 20)
        hus = host_us(kern)
        plain_ms = cuda_ms(
            lambda: ffm.geglu_ff_fused(*args, **ln, use_kernels=False), 5)
        # cuBLAS on the two products alone, a yardstick used nowhere in the
        # package: no one library call computes the kernel
        prod = rn(n, hdim)
        cublas_up = graph_ms(lambda: torch.matmul(x, w1.t()))
        cublas_down = graph_ms(lambda: torch.matmul(prod, w2.t()))
        del prod
        plan = ffm.ff_plan(n, c, hdim, e, _build.sm_count(x.device))
        print(f"ff    C={c:4d} N={n:5d} E={e:3d} k={k:2d}: routing decisions "
              f"agree {decision_agree:.6f}, rows agree {row_agree:.6f} (limit "
              f"{limit:.5f}), {int((~rows).sum())} rows differ, each "
              f"disagreeing decision within {tie_gap:.2e} of its row's k-th "
              f"score (limit {FF_NEAR_TIE}); on "
              f"agreeing rows max_abs_err {abs_e:.6g} rel {rel:.3e} "
              f"(tol {FF_REL_TOL:g}); kernel {ms:.4f} ms (back-to-back calls "
              f"{call_ms:.4f}), plain {plain_ms:.4f} ms; host {hus:.1f} us a "
              "call", flush=True)
        check(decision_agree >= FF_DECISION_AGREEMENT,
              f"ff C={c}: routing decisions agree {decision_agree} < "
              f"{FF_DECISION_AGREEMENT}")
        check(row_agree >= limit, f"ff C={c}: rows agree {row_agree} < {limit}")
        check(tie_gap <= FF_NEAR_TIE,
              f"ff C={c}: a disagreeing decision {tie_gap} from the k-th score")
        check(rel <= FF_REL_TOL, f"ff C={c}: rel err {rel} > {FF_REL_TOL}")
        # up GEMM (N, C) x (C, 2H), score and mask GEMMs over E, down GEMM;
        # x and y, W1, W2, biases, patterns (bf16) and the f32 LN pair
        flops = 4 * n * c * hdim + 4 * n * hdim * e + 2 * n * hdim * c
        nbytes = 2 * (2 * n * c + 3 * hdim * c + 2 * hdim + c + e * hdim) + 8 * c
        # the split design's own floor: xn written and read, ga, bf16(h ga)
        # and prod each written and read
        floor = bound(flops, nbytes + 4 * n * c + 12 * n * hdim)
        bd = bound(flops, nbytes)
        print(f"      plan: ff_up {plan.up_tiles} tiles on {plan.up_ctas} "
              f"persistent blocks, {plan.up_wgs} warpgroups; routing scores "
              f"{plan.route.score_blocks} blocks, split {plan.route.split}, "
              f"mask {plan.route.mask_blocks} blocks; ff_down "
              f"{plan.down_blocks} blocks, split {plan.down_split}; cuBLAS x W1^T "
              f"{cublas_up:.4f} + prod W2^T {cublas_down:.4f} ms; bound "
              f"{bd['bound_ms']:.4f} ms by {bd['binds']}, split-design floor "
              f"{floor['bound_ms']:.4f} ms by {floor['binds']}", flush=True)
        shapes.append(dict(shape=f"N={n},C={c},E={e},k={k}", max_abs_err=abs_e,
                           rel_err=rel, ms=ms, call_ms=call_ms, host_us=hus,
                           plain_ms=plain_ms, library_ms=None,
                           cublas_products_ms=cublas_up + cublas_down, **bd,
                           decision_agreement=decision_agree,
                           row_agreement=row_agree, row_limit=limit,
                           near_tie_gap=tie_gap))
        # the floor is worked out, not measured: printed, kept off the
        # kernels line
        floors.append(floor)
        kernels.append(kern)
    sums = {key: per_call(shapes, LEVEL_BLOCKS, key)
            for key in ("ms", "call_ms", "cublas_products_ms", "bound_ms",
                        "plain_ms")}
    sums["split_floor_ms"] = per_call(floors, LEVEL_BLOCKS, "bound_ms")
    print(f"ff ({label}): the 16 launches of a UNet call at batch {2 * BATCH} sum to "
          f"{sums['ms']:.3f} ms in the kernels (back-to-back calls "
          f"{sums['call_ms']:.3f}); cuBLAS on the two products alone "
          f"{sums['cublas_products_ms']:.3f}; bound {sums['bound_ms']:.3f}, "
          f"split-design floor {sums['split_floor_ms']:.3f}; plain "
          f"{sums['plain_ms']:.3f} ms", flush=True)
    return shapes, kernels


def ff_launch_times(shapes: list, kernels: list) -> None:
    """Phase 9: each launch of kernel 1 apart by the profiler at phase 2's
    shapes, into their rows. Last, after every wall: once torch.profiler has
    traced the card, the process's launches stay slower."""
    for row, kern in zip(shapes, kernels):
        per_launch = launch_ms(kern, FF_LAUNCHES)
        row.update(ln_ms=per_launch["ln"], up_ms=per_launch["ff_up"],
                   route_ms=per_launch["routing"],
                   down_ms=per_launch["ff_down"])
        print(f"ff    {row['shape']}: launches (profiler, ms a call): LN "
              f"{row['ln_ms']:.4f}, ff_up {row['up_ms']:.4f}, routing "
              f"{row['route_ms']:.4f}, ff_down {row['down_ms']:.4f}",
              flush=True)
    sums = {key: per_call(shapes, LEVEL_BLOCKS, key)
            for key in ("ln_ms", "up_ms", "route_ms", "down_ms")}
    print(f"ff: kernel 1's launches over the 16 FFs of a UNet call: LN "
          f"{sums['ln_ms']:.3f}, ff_up {sums['up_ms']:.3f}, routing "
          f"{sums['route_ms']:.3f}, ff_down {sums['down_ms']:.3f} ms",
          flush=True)


def check_routing(gen: torch.Generator) -> list:
    """Phase 2b: the routing kernel against its plain version on the gate
    and hidden the FF's projection makes at each SD1.5 FF shape."""
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.ops import geglu_ff_fused as ffm
    from diffusion_models_moe_tpu_torch.ops import routing_kernel as rk
    from diffusion_models_moe_tpu_torch.taps import (patterns_from_labels,
                                                     routing_mask)
    dev, bf16 = DEV, torch.bfloat16
    shapes = []
    for c, tokens in ((320, 4096), (640, 1024), (1280, 256), (1280, 64)):
        n, hdim = 2 * BATCH * tokens, 4 * c
        e = hdim // 20
        k = int(e * 0.3)
        x = torch.randn((n, c), generator=gen, device=dev).to(bf16)
        w1 = (torch.randn((2 * hdim, c), generator=gen, device=dev)
              * c ** -0.5).to(bf16)
        b1 = (torch.randn((2 * hdim,), generator=gen, device=dev) * 0.1).to(bf16)
        h, ga = ffm.reference_gate(x, w1, b1, False, None, None, 1e-5)
        # hidden in place as the first half of the FF's (N, 2H) projection
        hidden = torch.cat([h, ga], dim=1).to(bf16)[:, :hdim]
        gate = ga.to(bf16)
        del h, ga
        lab = np.random.RandomState(c).permutation(np.arange(hdim) % e)
        pat = patterns_from_labels(lab, e).to(dev, bf16)
        out = rk.fused_route_multiply(hidden, gate, pat, k)
        plain = rk.fused_route_multiply(hidden, gate, pat, k, use_kernels=False)
        torch.cuda.synchronize()
        sel_k = ((out != 0).float() @ pat.float().t() > 0).float()
        _, sel_p = routing_mask(gate, pat, k)
        decision_agree = (sel_k == sel_p).float().mean().item()
        rows = (sel_k == sel_p).all(dim=1)
        row_agree = rows.float().mean().item()
        abs_e, rel = rel_err(out[rows], plain[rows])
        kern = lambda: rk.fused_route_multiply(hidden, gate, pat, k)  # noqa: E731
        ms = graph_ms(kern)
        call_ms = cuda_ms(kern, 20)
        hus = host_us(kern)
        plain_ms = cuda_ms(lambda: rk.fused_route_multiply(
            hidden, gate, pat, k, use_kernels=False), 5)
        plan = rk.route_plan(n, hdim, e, _build.sm_count(x.device))
        # hidden, gate in and the product out (bf16), the patterns once; the
        # split design reads the gate twice (scores, mask)
        bd = bound(4 * n * hdim * e, 2 * (3 * n * hdim + e * hdim))
        floor = bound(4 * n * hdim * e, 2 * (4 * n * hdim + e * hdim))
        print(f"route C={c:4d} N={n:5d} E={e:3d} k={k:2d}: routing decisions "
              f"agree {decision_agree:.6f}, rows agree {row_agree:.6f}; on "
              f"agreeing rows max_abs_err {abs_e:.6g} rel {rel:.3e} "
              f"(tol {FF_REL_TOL:g}); kernel {ms:.4f} ms (back-to-back calls "
              f"{call_ms:.4f}), plain {plain_ms:.4f} ms ({plain_ms / ms:.2f}x "
              f"the kernel); host {hus:.1f} us a call; bound {bd['bound_ms']:.4f} ms, split-design floor "
              f"{floor['bound_ms']:.4f}; scores {plan.score_blocks} blocks "
              f"(split {plan.split}), mask {plan.mask_blocks} blocks",
              flush=True)
        check(decision_agree >= FF_DECISION_AGREEMENT,
              f"route C={c}: routing decisions agree {decision_agree} < "
              f"{FF_DECISION_AGREEMENT}")
        check(row_agree >= FF_ROW_AGREEMENT,
              f"route C={c}: rows agree {row_agree} < {FF_ROW_AGREEMENT}")
        check(rel <= FF_REL_TOL, f"route C={c}: rel err {rel} > {FF_REL_TOL}")
        shapes.append(dict(shape=f"N={n},H={hdim},E={e},k={k}",
                           max_abs_err=abs_e, rel_err=rel, ms=ms,
                           call_ms=call_ms, host_us=hus, plain_ms=plain_ms,
                           library_ms=None, **bd,
                           decision_agreement=decision_agree,
                           row_agreement=row_agree))
    return shapes


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of fn() from a CUDA graph of `iters` calls, by CUDA
    events around its replay: what the card takes when the host does not
    pace the launches (a wrapper's Python and ctypes take tens of
    microseconds a call, longer than the smaller attention kernels run)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, n: int = 50) -> float:
    """Host microseconds a call of fn() takes to return (the wrapper's
    checks, plan, tensor-map encodes and launch; the kernels run on)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / n * 1e6


# Extra attention cases, each held to ATTN_REL_TOL beside the four SD1.5
# shapes of each kind: (B, S, D, view, kv_valid) with S no multiple of the
# tiles, q, k, v as the column thirds of kernel 5's (B, S, 3C) tensor, fewer
# valid keys than 77, and SD2.x's head dim 64.
ATTN_EXTRA = ((4, 77, 40, "bsc", 77), (4, 1000, 80, "bsc", 77),
              (4, 4100, 40, "bsc", 77), (4, 4096, 40, "bs3c", 77),
              (4, 1024, 80, "bs3c", 77), (4, 256, 160, "bs3c", 77),
              (4, 4096, 40, "bsc", 40), (4, 1024, 80, "bsc", 1),
              (4, 4096, 64, "bsc", 77), (4, 1024, 64, "bs3c", 77))


def check_attention(gen: torch.Generator, levels=SD15_ATTN,
                    extra=ATTN_EXTRA, label: str = "SD1.5"
                    ) -> tuple[list, list]:
    """Phase 2: kernels 2 and 3 against their plain versions at the four
    shapes of each kind that `levels` gives (with SDPA on the same tensors
    as the yardstick, and the wrapper's host time) and at `extra` (8
    heads)."""
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.ops import sd_flash
    dev = DEV
    out = {}

    def heads4(b, n, d, view, heads):
        # (B, S, C) projection outputs viewed as (B, S, H, D), as the model
        # hands them to the kernels; "bs3c": kernel 5's column thirds
        c = heads * d
        width = 3 * c if view == "bs3c" else c
        t = torch.randn((b, n, width), generator=gen, device=dev).bfloat16()
        return t[..., c:2 * c].reshape(b, n, heads, d) if view == "bs3c" \
            else t.view(b, n, heads, d)

    cases = [(kind, 2 * BATCH, s, heads, c // heads, "bsc", 77, True)
             for kind in ("self", "cross") for s, c, heads in levels]
    cases += [(kind, b, s, 8, d, view, kvv, False)
              for kind in ("self", "cross") for b, s, d, view, kvv in extra
              if kind == "cross" or kvv == 77]
    for kind, b, s, heads, d, view, kv_valid, main in cases:
        shapes = out.setdefault(kind, [])
        s_kv = s if kind == "self" else 77
        q, k, v = (heads4(b, n, d, view, heads) for n in (s, s_kv, s_kv))
        if view == "bs3c":
            assert not q.is_contiguous()
        scale = d ** -0.5
        if kind == "self":
            fn = lambda uk: sd_flash.sd_self_attention(  # noqa: E731
                q, k, v, scale, use_kernels=uk)
        else:
            fn = lambda uk: sd_flash.sd_cross_attention(  # noqa: E731
                q, k, v, scale, kv_valid, use_kernels=uk)
        check(sd_flash.attn_kernel_ok(q, k, None if kind == "self" else kv_valid),
              f"attn_kernel_ok refuses {kind} S={s} D={d} {view}")
        plan = sd_flash.attn_plan(kind, b, heads, s, s_kv, d,
                                  _build.sm_count(q.device))
        o, o_plain = fn(True), fn(False)
        torch.cuda.synchronize()
        abs_e, rel = rel_err(o, o_plain)
        del o_plain
        what = (f"{kind:5s} B={b} S={s:4d} S_kv={s_kv:4d} H={heads:2d} D={d:3d} {view:4s} "
                f"kv_valid={kv_valid if kind == 'cross' else s_kv}")
        check(rel <= ATTN_REL_TOL, f"{what}: rel err {rel}")
        keys = s_kv if kind == "self" else kv_valid
        # products: Q K^T and P V over the valid keys; bytes: q, o and the
        # keys and values, each once; one exponential a valid score
        bd = bound(4 * b * heads * s * keys * d,
                   2 * 2 * b * heads * d * (s + s_kv), b * heads * s * keys)
        row = dict(shape=f"B={b},S={s},S_kv={s_kv},H={heads},D={d},{view},"
                         f"kv_valid={keys}", rows=plan.rows, run=plan.run,
                   blocks=plan.blocks(b, heads), max_abs_err=abs_e,
                   rel_err=rel, **bd)
        if main:
            # device times from CUDA graphs (kernel and SDPA alike); beside
            # them the time of back-to-back calls, which the host paces
            # where a call's host work outlasts the kernel
            ms = graph_ms(lambda: fn(True))
            call_ms = cuda_ms(lambda: fn(True), 20)
            plain_ms = cuda_ms(lambda: fn(False), 5)
            # the library's one call for the same function on the same
            # tensors: a yardstick, used nowhere in the package
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            mask = None
            if kind == "cross" and kv_valid < s_kv:
                mask = torch.arange(s_kv, device=dev) < kv_valid

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask,
                                                      scale=scale)

            library_ms = graph_ms(sdpa)
            row.update(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                       library_ms=library_ms,
                       library_call_ms=cuda_ms(sdpa, 20),
                       host_us=host_us(lambda: fn(True)),
                       library_host_us=host_us(sdpa))
            timing = (f"kernel {ms:.4f} ms (back-to-back calls {call_ms:.4f}), "
                      f"plain {plain_ms:.4f} ms, library SDPA "
                      f"{library_ms:.4f} ms ({row['library_call_ms']:.4f}), "
                      f"host {row['host_us']:.1f} us a call (SDPA "
                      f"{row['library_host_us']:.1f}), ")
        else:
            timing = ""
        print(f"{what}: max_abs_err {abs_e:.6g} rel {rel:.3e} (tol "
              f"{ATTN_REL_TOL:g}); {timing}bound {bd['bound_ms']:.4f} ms by "
              f"{bd['binds']}; {plan.blocks(b, heads)} blocks of {plan.rows} "
              f"rows x {plan.run} tiles", flush=True)
        shapes.append(row)
    for kind, counts in (("self", LEVEL_BLOCKS), ("cross", LEVEL_BLOCKS)):
        rows = out[kind][:4]
        print(f"{kind} ({label}): the 16 launches of a UNet call at batch {2 * BATCH} "
              f"sum to {per_call(rows, counts, 'ms'):.3f} ms in the kernel, "
              f"{per_call(rows, counts, 'library_ms'):.3f} ms in SDPA, bound "
              f"{per_call(rows, counts, 'bound_ms'):.3f} ms", flush=True)
    return out["self"], out["cross"]


# ---------------------------------------------------------------- phase 2c
def check_absorb(gen: torch.Generator, levels=SD15_ATTN,
                 label: str = "SD1.5") -> tuple[list, list]:
    """Phase 2c: the absorbed-attention kernels (LN + q/k/v projection, out
    projection + bias + residual) against their plain versions at the four
    self-attention shapes of `levels` (SD1.5's; 2e: SD2.1-768's), on the
    same bf16 inputs; device times from
    CUDA graphs and by events, the wrappers' host microseconds, each
    shape's plan, and cuBLAS on the products alone as a yardstick (not a
    library call for the same function: `F.linear` of the pre-normalised x
    against [Wq Wk Wv], concatenated once outside the timing, for kernel 5;
    `F.linear(o, Wo, bo)` without the residual for kernel 6)."""
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.ops import attn_absorb_fused as ab
    dev, bf16 = DEV, torch.bfloat16
    b = 2 * BATCH
    qkv_shapes, out_shapes = [], []

    def rn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    for s, c, heads in levels:
        n, d = b * s, c // heads
        x = rn(b, s, c)
        wq, wk, wv, wo = (rn(c, c, scale=c ** -0.5) for _ in range(4))
        bo = rn(c, scale=0.1)
        g = rn(c, scale=0.1, dtype=torch.float32) + 1.0
        bb = rn(c, scale=0.1, dtype=torch.float32)
        o = rn(b, s, heads, d)
        xn = ab.ln_apply(x, g, bb).to(bf16)
        wqkv = torch.cat([wq, wk, wv])
        o2d = o.view(b, s, c)

        def qkv(uk):
            return torch.cat([t.reshape(b, s, c) for t in ab.ln_qkv_fused(
                x, wq, wk, wv, heads, g, bb, use_kernels=uk)], dim=-1)

        def out(uk):
            return ab.attn_out_residual_fused(o, wo, bo, x, use_kernels=uk)

        # LN + one (N, C) x (C, 3C) product; x in, q, k, v out, the weights
        # and the f32 LN pair once
        bd_qkv = bound(2 * n * c * 3 * c,
                       2 * (n * c + 3 * c * c + 3 * n * c) + 8 * c)
        # (N, C) x (C, C); o and the residual in, y out, Wo and the bias once
        bd_out = bound(2 * n * c * c, 2 * (3 * n * c + c * c + c))
        for name, fn, call, cublas, bd, rows in (
                ("ln_qkv", qkv, lambda: ab.ln_qkv_fused(
                    x, wq, wk, wv, heads, g, bb),
                 lambda: F.linear(xn, wqkv), bd_qkv, qkv_shapes),
                ("attn_out", out, lambda: out(True),
                 lambda: F.linear(o2d, wo, bo), bd_out, out_shapes)):
            y, y_plain = fn(True), fn(False)
            torch.cuda.synchronize()
            abs_e, rel = rel_err(y, y_plain)
            del y, y_plain
            ms = graph_ms(call)
            call_ms = cuda_ms(call, 20)
            hus = host_us(call)
            cublas_ms = graph_ms(cublas)
            plain_ms = cuda_ms(lambda: fn(False), 5)
            plan = ab.absorb_plan("qkv" if name == "ln_qkv" else "out", n, c,
                                  _build.sm_count(x.device))
            cut = (f"run {plan.run} of {plan.col_tiles} column tiles, "
                   f"{plan.stages}-stage ring" if name == "ln_qkv" else
                   f"split {plan.split} x {plan.chunks_per_split} chunks")
            print(f"{name:8s} S={s:4d} C={c:4d} D={d:3d}: max_abs_err "
                  f"{abs_e:.6g} rel {rel:.3e} (tol {ATTN_REL_TOL:g}); kernel "
                  f"{ms:.4f} ms (back-to-back calls {call_ms:.4f}), cuBLAS on "
                  f"the product alone {cublas_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
                  f"{bd['bound_by']}; host {hus:.1f} us a call; "
                  f"{plan.blocks} blocks of {plan.wgs} warpgroups, {cut}",
                  flush=True)
            check(rel <= ATTN_REL_TOL, f"{name} S={s} C={c}: rel err {rel}")
            rows.append(dict(shape=f"B={b},S={s},C={c},H={heads},D={d}",
                             max_abs_err=abs_e, rel_err=rel, ms=ms,
                             call_ms=call_ms, host_us=hus,
                             cublas_product_ms=cublas_ms, plain_ms=plain_ms,
                             library_ms=None, blocks=plan.blocks, wgs=plan.wgs,
                             run=plan.run, split=plan.split, **bd))
    for name, rows in (("ln_qkv", qkv_shapes), ("attn_out", out_shapes)):
        sums = {k: per_call(rows, LEVEL_BLOCKS, k)
                for k in ("ms", "call_ms", "cublas_product_ms", "bound_ms",
                          "plain_ms")}
        print(f"{name} ({label}): the 16 launches of a UNet call at batch {b} sum to "
              f"{sums['ms']:.3f} ms in the kernel (back-to-back calls "
              f"{sums['call_ms']:.3f}); cuBLAS on the products alone "
              f"{sums['cublas_product_ms']:.3f}; bound {sums['bound_ms']:.3f}; "
              f"plain {sums['plain_ms']:.3f} ms", flush=True)
    return qkv_shapes, out_shapes


def check_chain(gen: torch.Generator, conv_shapes=CONV_SHAPES,
                label: str = "SD1.5") -> list:
    """Phase 2c: the conv-chain kernel against its plain version at every
    resblock conv shape of `conv_shapes` (SD1.5's; 2e: SD2.1-768's), with
    the time embedding in `bt`, with and
    without a residual. Beside it, as yardsticks only: cuDNN's convolution
    alone on the same tensors, and the unfused sequence the mode replaces
    (group_norm in f32, silu, cast, conv2d + bias, + time embedding,
    + residual) against the chain's own two steps (the GroupNorm fold in
    torch, then the kernel)."""
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.ops import conv_chain_fused as cc
    dev, bf16, cl = DEV, torch.bfloat16, torch.channels_last
    b, groups, eps = 2 * BATCH, 32, 1e-5
    shapes = []

    def rn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    for side, cin, cout in conv_shapes:
        m = b * side * side
        x = rn(b, cin, side, side).contiguous(memory_format=cl)
        res = rn(b, cout, side, side).contiguous(memory_format=cl)
        w = rn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5
               ).contiguous(memory_format=cl)
        bias, temb = rn(cout, scale=0.1), rn(b, cout, scale=0.1)
        gamma = rn(cin, scale=0.1, dtype=torch.float32) + 1.0
        beta = rn(cin, scale=0.1, dtype=torch.float32)
        bt = bias + temb
        scale, shift = cc.gn_scale_shift(x, gamma, beta, groups, eps)
        plan = cc.chain_plan(b, side, side, cin, cout, _build.sm_count(x.device))

        def chain(uk, r=res):
            return cc.conv3x3_chain(x, w, bt, scale, shift, residual=r,
                                    use_kernels=uk)

        def folded():
            sc, sh = cc.gn_scale_shift(x, gamma, beta, groups, eps)
            return cc.conv3x3_chain(x, w, bt, sc, sh, residual=res)

        def unfused():
            h = F.silu(F.group_norm(x.float(), groups, gamma, beta, eps)).to(bf16)
            return F.conv2d(h, w, bias, padding=1) + temb[:, :, None, None] + res

        errs = {}
        for key, r in (("res", res), ("nores", None)):
            y, y_plain = chain(True, r), chain(False, r)
            torch.cuda.synchronize()
            errs[key] = rel_err(y, y_plain)
            check(errs[key][1] <= ATTN_REL_TOL,
                  f"chain {cin}->{cout} at {side} ({key}): rel err "
                  f"{errs[key][1]}")
        check(y.is_contiguous(memory_format=cl), "chain output not channels-last")
        # the chain against the sequence it replaces: bf16 rounding of both
        _, rel_seq = rel_err(folded(), unfused())
        check(rel_seq <= ATTN_REL_TOL,
              f"chain {cin}->{cout} at {side}: against the unfused sequence "
              f"rel err {rel_seq}")
        ms = cuda_ms(lambda: chain(True), 20)
        plain_ms = cuda_ms(lambda: chain(False), 3)
        library_ms = cuda_ms(lambda: F.conv2d(x, w, padding=1), 20)
        folded_ms = cuda_ms(folded, 20)
        unfused_ms = cuda_ms(unfused, 20)
        # 9 tap products of (M, Cin) x (Cin, Cout); x and the residual in, y
        # out, the weight, bt (bf16) and the f32 scale and shift once
        bd = bound(2 * 9 * m * cin * cout,
                   2 * (m * cin + 2 * m * cout + 9 * cin * cout + b * cout)
                   + 8 * b * cin)
        abs_e, rel = max(errs.values())
        print(f"chain {side:2d}x{side:<2d} {cin:4d}->{cout:4d}: max_abs_err "
              f"{abs_e:.6g} rel {rel:.3e} (no residual {errs['nores'][1]:.3e}; "
              f"tol {ATTN_REL_TOL:g}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, cuDNN conv alone {library_ms:.4f} ms, bound "
              f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}; fold + kernel "
              f"{folded_ms:.4f} ms against the unfused sequence "
              f"{unfused_ms:.4f} ms (rel {rel_seq:.3e}); {plan.blocks(b)} "
              f"blocks of 8x{plan.tile_w} pixels, depth split {plan.split}",
              flush=True)
        shapes.append(dict(shape=f"B={b},H=W={side},Cin={cin},Cout={cout}",
                           split=plan.split, blocks=plan.blocks(b),
                           max_abs_err=abs_e, rel_err=rel, ms=ms,
                           plain_ms=plain_ms, library_ms=library_ms, **bd,
                           fold_and_kernel_ms=folded_ms, unfused_ms=unfused_ms))
    check(sum(CONV_COUNTS) == 2 * RESNETS, "CONV_COUNTS")
    sums = {k: per_call(shapes, CONV_COUNTS, k) for k in
            ("ms", "fold_and_kernel_ms", "unfused_ms", "library_ms", "bound_ms")}
    print(f"chain ({label}): the {2 * RESNETS} convs of a UNet call at batch {b} sum to "
          f"{sums['ms']:.3f} ms in the kernel, {sums['fold_and_kernel_ms']:.3f} "
          f"ms with the GroupNorm fold, against {sums['unfused_ms']:.3f} ms "
          f"for the unfused sequence, {sums['library_ms']:.3f} ms for cuDNN's "
          f"convolutions alone and a bound of {sums['bound_ms']:.3f} ms",
          flush=True)
    return shapes


# ---------------------------------------------------------------- phase 2d
def check_winograd(gen: torch.Generator) -> list:
    """Phase 2d: the fused Winograd kernel against its plain version (the
    formulation of ops/winograd.py on the same hoisted, rounded filter) at
    every shape of WINO_UNET (batch 2 x BATCH) and WINO_VAE (batch BATCH),
    with the bias. Beside it, as a yardstick only, cuDNN's convolution on
    the same tensors (it rounds neither V nor U, so it is held to twice the
    limit)."""
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.ops import winograd_fused as wf
    dev, bf16, cl = DEV, torch.bfloat16, torch.channels_last
    shapes = []
    for what, b, table, total in (("unet", 2 * BATCH, WINO_UNET, WINO_UNET_CONVS),
                                  ("vae", BATCH, WINO_VAE, WINO_VAE_CONVS)):
        check(sum(n for _, n in table) == total, f"WINO table of the {what}")
        for (side, cin, cout), n in table:
            check(wf.fused_ok(side, side, cin, cout),
                  f"fused_ok {side} {cin}->{cout}")
            x = (torch.randn((b, cin, side, side), generator=gen, device=dev)
                 ).to(bf16).contiguous(memory_format=cl)
            w = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
                 * (9 * cin) ** -0.5).to(bf16)
            bias = (torch.randn((cout,), generator=gen, device=dev) * 0.1
                    ).to(bf16)
            u = wf.fused_filter(w)
            plan = wf.fused_plan(b, side, side, cin, cout,
                                 _build.sm_count(x.device))

            def conv(uk):
                return wf.winograd3x3_fused(x, u, bias, use_kernels=uk)

            y, y_plain = conv(True), conv(False)
            torch.cuda.synchronize()
            check(y.is_contiguous(memory_format=cl),
                  "winograd output not channels-last")
            abs_e, rel = rel_err(y, y_plain)
            _, rel_lib = rel_err(y, F.conv2d(x, w, bias, padding=1))
            del y, y_plain
            check(rel <= ATTN_REL_TOL,
                  f"winograd {what} {cin}->{cout} at {side}: rel err {rel}")
            check(rel_lib <= 2 * ATTN_REL_TOL,
                  f"winograd {what} {cin}->{cout} at {side}: against cuDNN's "
                  f"convolution rel err {rel_lib}")
            ms = cuda_ms(lambda: conv(True), 10 if side >= 256 else 20)
            plain_ms = cuda_ms(lambda: conv(False), 2)
            library_ms = cuda_ms(lambda: F.conv2d(x, w, bias, padding=1),
                                 10 if side >= 256 else 20)
            tiles = b * (side // 2) ** 2
            # 16 products of (tiles, Cin) x (Cin, Cout); x, u, the bias in
            # and y out once (bf16)
            bd = bound(2 * tiles * 16 * cin * cout,
                       2 * (4 * tiles * (cin + cout) + 16 * cin * cout + cout))
            print(f"wino {what:4s} {side:3d}x{side:<3d} {cin:4d}->{cout:4d} "
                  f"(x{n} a call): max_abs_err {abs_e:.6g} rel {rel:.3e} (tol "
                  f"{ATTN_REL_TOL:g}), against cuDNN rel {rel_lib:.3e}; kernel "
                  f"{ms:.4f} ms, plain (the formulation of ops/winograd.py) "
                  f"{plain_ms:.4f} ms, cuDNN conv {library_ms:.4f} ms, bound "
                  f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}; "
                  f"{plan.blocks(b)} blocks, depth split {plan.split}",
                  flush=True)
            shapes.append(dict(
                shape=f"{what}: B={b},H=W={side},Cin={cin},Cout={cout}",
                convs_per_call=n, split=plan.split, blocks=plan.blocks(b),
                max_abs_err=abs_e, rel_err=rel,
                rel_err_vs_library=rel_lib, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, **bd))
    n_unet = len(WINO_UNET)
    for what, rows, table in (("UNet call at batch 4", shapes[:n_unet], WINO_UNET),
                              ("VAE decode at batch 2", shapes[n_unet:], WINO_VAE)):
        counts = tuple(n for _, n in table)
        sums = {k: per_call(rows, counts, k)
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"wino: the {sum(counts)} convs of a {what} sum to "
              f"{sums['ms']:.3f} ms in the kernel, {sums['plain_ms']:.3f} ms "
              f"in the formulation of ops/winograd.py, {sums['library_ms']:.3f} "
              f"ms in cuDNN's convolutions and a bound of "
              f"{sums['bound_ms']:.3f} ms", flush=True)
    return shapes


# ---------------------------------------------------------------- phase 3/4
def run_slice(card: str) -> tuple:
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                build_moe_interventions,
                                                sd15_config)
    from diffusion_models_moe_tpu_torch.ops import _build
    dev = DEV
    cfg = sd15_config(torch.bfloat16)
    steps = cfg.num_inference_steps
    calls = steps + 1        # PNDM's warm-up takes one extra UNet call
    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline(cfg, device=dev)
    pipe.init_params(torch.Generator(device=dev).manual_seed(0))
    ivs = build_moe_interventions(labels_for(cfg.unet.ff_dims()), 0.3,
                                  device=dev, dtype=cfg.unet.dtype)
    tcfg = cfg.text_encoder
    cond = torch.randint(0, tcfg.vocab_size, (BATCH, tcfg.max_length),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    uncond = torch.zeros_like(cond)
    torch.cuda.synchronize()
    print(f"slice: SD1.5 bf16 pipeline built with seeded random weights in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # warm-up: one 1-step request (cuDNN/cuBLAS set-up), not timed or counted
    pipe.generate(cond, uncond, torch.Generator(device=dev).manual_seed(2),
                  num_steps=1, ivs=ivs)
    torch.cuda.synchronize()

    images, launches = timed_generate(
        pipe, f"slice on {card}", cond, uncond, seed=3, ivs=ivs,
        expect={"geglu_ff_fused": 16 * calls, "sd_self_attention": 16 * calls,
                "sd_cross_attention": 16 * calls, "fused_route_multiply": 0})
    return pipe, ivs, cond, uncond, launches, images


def unet_calls(cfg, steps: int) -> int:
    """UNet calls of a `steps`-step run: PNDM's warm-up takes one more."""
    return steps + (cfg.scheduler == "pndm")


def timed_generate(pipe, what: str, cond, uncond, seed: int, ivs,
                   expect: dict, num_steps=None, guidance_scale=None):
    """One `generate` of len(cond) requests, timed, with the kernels' launch
    counts over it held to `expect`; checks the images."""
    from diffusion_models_moe_tpu_torch.ops import _build
    cfg = pipe.config
    steps = num_steps or cfg.num_inference_steps
    g = cfg.guidance_scale if guidance_scale is None else guidance_scale
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    images, _ = pipe.generate(cond, uncond,
                              torch.Generator(device=DEV).manual_seed(seed),
                              num_steps=num_steps, ivs=ivs, guidance_scale=g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    side, b = 8 * cfg.sample_size, cond.shape[0]
    check(tuple(images.shape) == (b, 3, side, side),
          f"{what}: image shape {tuple(images.shape)}")
    check(bool(torch.isfinite(images).all()), f"{what}: non-finite images")
    check(images.min().item() >= 0.0 and images.max().item() <= 1.0,
          f"{what}: image values outside [0, 1]")
    lcm = cfg.scheduler == "lcm"
    print(f"{what}: generate {b} requests {side}x{side}, {cfg.scheduler} "
          f"{cfg.prediction_type} {steps} steps ({unet_calls(cfg, steps)} UNet "
          f"calls at batch {b if lcm else 2 * b}), "
          f"{'guidance embedding' if lcm else 'CFG'} {g}, MoE topk 0.3 on "
          f"{sum(iv is not None for iv in ivs)} FFs: wall {wall:.3f} s, "
          f"{b / wall:.4f} img/s, peak memory {peak_gib:.2f} GiB; images "
          f"finite in [{images.min().item():.4f}, "
          f"{images.max().item():.4f}]; launches {launches} (expected "
          f"{expect})", flush=True)
    for name, count in expect.items():
        check(launches[name] == count,
              f"{what}: kernel {name} launched {launches[name]} times, "
              f"expected {count}")
    check_no_plain(launches, what)
    return images, launches


def check_no_plain(launches: dict, what: str) -> None:
    """On a bf16 path of SD1.5 or SD2.1 every call the kernels could take
    went to them: the model handed none to a plain version."""
    from diffusion_models_moe_tpu_torch.ops import _build
    plain = {k: launches[k] for k in _build.PLAIN if launches[k]}
    check(not plain, f"{what}: calls handed to plain versions: {plain}")


def kernels_vs_plain(pipe, pipe32, ctx, ctx32, lat, steps: int, g: float,
                     ivs, what: str, **kw) -> tuple[float, float, torch.Tensor]:
    """`denoise` from the same latents with the kernels and with their plain
    versions, and the bf16-vs-f32 floor of this card: the same denoise with
    the plain versions in the f32 copy `pipe32` of the model. Holds the
    kernels' latents within FLOOR_FACTOR x the floor; returns (rel, floor,
    the kernels' latents). `kw` goes to every denoise (LCM's step noise)."""
    z_k, _ = pipe.denoise(ctx, lat, steps, g, ivs=ivs, **kw)
    z_p, _ = pipe.denoise(ctx, lat, steps, g, ivs=ivs, use_kernels=False, **kw)
    z_32, _ = pipe32.denoise(ctx32, lat, steps, g, ivs=ivs, use_kernels=False,
                             **kw)
    check(bool(torch.isfinite(z_k).all()), f"{what}: non-finite latents")
    rel = ((z_k - z_p).norm() / z_p.norm()).item()
    floor = ((z_p - z_32).norm() / z_32.norm()).item()
    print(f"denoise {steps} steps, guidance {g}, {what}: latent rel err "
          f"kernels vs plain {rel:.6f}; floor (plain "
          f"bf16 vs plain f32 on this card) {floor:.6f}", flush=True)
    check(rel <= FLOOR_FACTOR * floor,
          f"{what}, {steps} steps: kernels-vs-plain {rel} > "
          f"{FLOOR_FACTOR} x floor {floor}")
    return rel, floor, z_k


def check_latents(pipe, ivs, cond, uncond):
    """Phase 4: `denoise` from the same latents with the kernels and with
    their plain versions, against the bf16-vs-f32 floor of this card: the
    same denoise with the plain versions in an f32 copy of the model.
    Returns a `compare(ivs, steps, what)` that runs this comparison and
    returns (rel, floor), and what phase 7 holds the serving modes to: the
    context, the initial latents, the kernels' 50-step latents and the
    50-step floor."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                sd15_config)
    dev, cfg = DEV, pipe.config
    pipe32 = StableDiffusionPipeline(sd15_config(torch.float32), device=dev)
    pipe32.init_params(torch.Generator(device=dev).manual_seed(0))
    ctx = torch.cat([pipe.encode_text(uncond)[0], pipe.encode_text(cond)[0]])
    ctx32 = torch.cat([pipe32.encode_text(uncond)[0],
                       pipe32.encode_text(cond)[0]])
    lat = torch.randn((BATCH, 4, cfg.sample_size, cfg.sample_size),
                      generator=torch.Generator(device=dev).manual_seed(4),
                      device=dev)
    g = cfg.guidance_scale

    def compare(ivs, steps: int, what: str) -> tuple[float, float]:
        rel, floor, kept["z_k"] = kernels_vs_plain(
            pipe, pipe32, ctx, ctx32, lat, steps, g, ivs, what)
        return rel, floor

    kept = {}
    for steps in (3, cfg.num_inference_steps):
        rel, floor = compare(ivs, steps, "MoE on 16 FFs")
    # `rel` of the last pass: the config's full step count
    check(rel < LATENT_REL_TOL,
          f"{steps} steps: latent rel err {rel} >= {LATENT_REL_TOL}")
    return compare, dict(ctx=ctx, lat=lat, z_k=kept["z_k"], floor=floor,
                         pipe32=pipe32)


def run_off_kernels(pipe32, cond, uncond, card: str) -> dict:
    """Phase 4b: where the kernels' predicates say no, `generate` runs on the
    card through the plain versions: the f32 SD1.5 pipeline of phase 4 (3
    PNDM steps, 512x512) and a `tiny_config` pipeline (head dims 8 to 32, f32)
    at its 4 steps. No kernel launches; every attention and FF call is
    counted as a plain call."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                tiny_config)
    from diffusion_models_moe_tpu_torch.ops import _build
    tiny = StableDiffusionPipeline(tiny_config(), device=DEV)
    tiny.init_params(torch.Generator(device=DEV).manual_seed(0))
    tcfg = tiny.config.text_encoder
    tcond = torch.randint(0, tcfg.vocab_size, (BATCH, tcfg.max_length),
                          generator=torch.Generator().manual_seed(1)).to(DEV)
    out = {}
    for what, pipe, c, steps in (("f32 SD1.5", pipe32, cond, 3),
                                 ("tiny_config", tiny, tcond, None)):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        images, _ = pipe.generate(c, torch.zeros_like(c),
                                  torch.Generator(device=DEV).manual_seed(3),
                                  num_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        side = 8 * pipe.config.sample_size
        check(tuple(images.shape) == (BATCH, 3, side, side)
              and bool(torch.isfinite(images).all()),
              f"{what}: images {tuple(images.shape)} not finite or misshapen")
        calls = 16 * ((steps or pipe.config.num_inference_steps) + 1)
        ran = {k: launches[k] for k in _build.KERNELS if launches[k]}
        print(f"{what} on {card}: generate {BATCH} requests {side}x{side}, "
              f"{steps or pipe.config.num_inference_steps} PNDM steps: wall "
              f"{wall:.3f} s; kernels launched {ran or 'none'}; plain calls "
              f"{ {k: launches[k] for k in _build.PLAIN} }", flush=True)
        check(not ran, f"{what}: kernels launched {ran}")
        for key in ("plain:sd_self_attention", "plain:sd_cross_attention",
                    "plain:geglu_ff_fused"):
            check(launches[key] == calls,
                  f"{what}: {key} {launches[key]}, expected {calls}")
        out[what] = launches
    return out


def merge(moe, removal, fields):
    """Removal interventions' `fields` merged into the MoE interventions."""
    import dataclasses
    return tuple(m if r is None else dataclasses.replace(
        m, **{f: getattr(r, f) for f in fields}) for m, r in zip(moe, removal))


# ---------------------------------------------------------------- phase 5
def run_attribution(pipe, ivs, compare, card: str) -> dict:
    """Phase 5: predictivity under MoE routing over the prompt pairs, the
    t-test's neuron masks, and a neuron-erased generate of 2 requests."""
    from diffusion_models_moe_tpu_torch.analysis.collect import (
        collect_predictivity, t_test_pipeline)
    from diffusion_models_moe_tpu_torch.data.tokenize import hash_tokenize
    from diffusion_models_moe_tpu_torch.erasure.masks import \
        neuron_removal_interventions
    from diffusion_models_moe_tpu_torch.ops import _build
    cfg = pipe.config
    calls = cfg.num_inference_steps + 1
    tok = hash_tokenize(cfg.text_encoder.vocab_size, cfg.text_encoder.max_length)
    n_gen = 2 * len(BASE)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    pred = collect_predictivity(pipe, tok, BASE, ADJ, seed=0, ivs=ivs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(f"attribution: collect_predictivity over {len(BASE)} prompt pairs "
          f"({n_gen} tapped generates of 1 request, {calls} UNet calls at "
          f"batch 2 each), MoE on 16 FFs: wall {wall:.3f} s; launches "
          f"{launches}", flush=True)
    expect = {"fused_route_multiply": n_gen * 16 * calls, "geglu_ff_fused": 0,
              "sd_self_attention": n_gen * 16 * calls,
              "sd_cross_attention": n_gen * 16 * calls}
    for name, count in expect.items():
        check(launches[name] == count,
              f"attribution: kernel {name} launched {launches[name]} times, "
              f"expected {count} ({16 * calls} per tapped generate)")
    check_no_plain(launches, "attribution")
    for acc in (pred.base, pred.adj):
        for l, d in enumerate(cfg.unet.ff_dims()):
            m = acc.mean()[l]
            check(m.shape == (calls, 4 * d) and bool(np.isfinite(m).all()),
                  f"max-gate stats of layer {l}: shape {m.shape}, finite "
                  f"{bool(np.isfinite(m).all())}")
    masks = t_test_pipeline(pred)
    n_skilled = sum(int(m.sum()) for m in masks.values())
    print(f"attribution: paired t-test (conf 0.05, {pred.n_prompts} pairs): "
          f"{n_skilled} skilled (step, neuron) entries over {len(masks)} "
          f"layers", flush=True)
    erased = merge(ivs, neuron_removal_interventions(masks, device=DEV),
                   ("neuron_mask", "neuron_fill"))
    cond = tok(ADJ).to(DEV)
    _, gen_launches = timed_generate(
        pipe, f"neuron erasure on {card}", cond, torch.zeros_like(cond),
        seed=5, ivs=erased,
        expect={"fused_route_multiply": 16 * calls, "geglu_ff_fused": 0})
    compare(erased, cfg.num_inference_steps, "skilled neurons removed, MoE")
    return launches


# ---------------------------------------------------------------- phase 6
def run_wanda(pipe, ivs, images_before, card: str) -> dict:
    """Phase 6: Wanda masks on the prompt pairs, a generate erasing with
    them under MoE routing, and their union baked into the weights."""
    from diffusion_models_moe_tpu_torch.analysis.collect import wanda_pipeline
    from diffusion_models_moe_tpu_torch.data.tokenize import hash_tokenize
    from diffusion_models_moe_tpu_torch.erasure.masks import (
        bake_wanda_masks, union_over_timesteps, wanda_removal_interventions)
    cfg = pipe.config
    tok = hash_tokenize(cfg.text_encoder.vocab_size, cfg.text_encoder.max_length)
    t0 = time.perf_counter()
    masks = wanda_pipeline(pipe, tok, BASE, ADJ, WANDA_SKILL_RATIO,
                           num_steps=WANDA_STEPS)
    wall = time.perf_counter() - t0
    n_masked = sum(int(m.sum()) for m in masks.values())
    print(f"wanda: wanda_pipeline over {len(BASE)} prompt pairs at "
          f"{WANDA_STEPS} PNDM steps, skill ratio {WANDA_SKILL_RATIO}: wall "
          f"{wall:.3f} s; {n_masked} masked (step, row, column) entries",
          flush=True)
    for l, d in enumerate(cfg.unet.ff_dims()):
        check(masks[l].shape == (WANDA_STEPS + 1, d, 4 * d),
              f"wanda mask of layer {l}: shape {masks[l].shape}")
    calls = WANDA_STEPS + 1
    erased = merge(ivs, wanda_removal_interventions(masks, device=DEV),
                   ("out_weight_mask",))
    cond = tok(ADJ).to(DEV)
    _, launches = timed_generate(
        pipe, f"wanda erasure on {card}", cond, torch.zeros_like(cond), seed=6,
        ivs=erased, num_steps=WANDA_STEPS,
        expect={"fused_route_multiply": 16 * calls, "geglu_ff_fused": 0})
    static = union_over_timesteps(masks, UNION_RATIO)
    pruned = sum(int(m.sum()) for m in static.values())
    baked = bake_wanda_masks(pipe.unet.state_dict(), cfg.unet, static)
    pipe.unet.load_state_dict(baked)
    calls = cfg.num_inference_steps + 1
    tcfg = cfg.text_encoder
    cond = torch.randint(0, tcfg.vocab_size, (BATCH, tcfg.max_length),
                         generator=torch.Generator().manual_seed(1)).to(DEV)
    images, _ = timed_generate(
        pipe, f"baked wanda union on {card}", cond, torch.zeros_like(cond),
        seed=3, ivs=ivs,
        expect={"geglu_ff_fused": 16 * calls, "fused_route_multiply": 0})
    moved = (images - images_before).abs().mean().item()
    print(f"wanda: union over timesteps (ratio {UNION_RATIO}) pruned {pruned} "
          f"W2 entries; mean |image change| against the unbaked phase-3 "
          f"images (same prompts and noise) {moved:.6f}", flush=True)
    check(pruned > 0 and moved > 0, "the baked masks changed nothing")
    return launches


# ---------------------------------------------------------------- phase 7
SERVE_PROMPTS = ("a photo of a dog", "a photo of a house",
                 "a dog in the style of Van Gogh")
SERVE_SEEDS = (11, 12, 13)


def serve(pipe, ivs, what: str, expect_per_batch: dict, num_steps=None,
          guidance_scale=None):
    """The three seeded requests through a `ServingEngine(batch_size=2)`
    over `pipe` (one full batch, one padded), then request 0 again, alone,
    at `num_steps` and `guidance_scale` (the config's by default). Checks
    the images, the stats, that request 0 alone equals request 0
    co-batched, and the kernels' launch counts per batch. Returns the
    launch counts of the three-request run."""
    from diffusion_models_moe_tpu_torch.data.tokenize import \
        per_prompt_hash_tokenize
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.serving import ServingEngine
    cfg = pipe.config
    steps = num_steps or cfg.num_inference_steps
    g = cfg.guidance_scale if guidance_scale is None else guidance_scale
    tok = per_prompt_hash_tokenize(cfg.text_encoder.vocab_size,
                                   cfg.text_encoder.max_length)
    eng = ServingEngine(pipe, tok, batch_size=BATCH, ivs=ivs, max_wait_ms=100.0,
                        num_steps=steps, guidance_scale=g)
    side = 8 * cfg.sample_size
    with eng:
        # warm-up: one request (cuDNN and cuBLAS set-up at this batch shape)
        eng.submit("warm-up", seed=0).result(timeout=600)
        torch.cuda.synchronize()
        warm = eng.stats.total_batch_seconds
        _build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        futs = [eng.submit(p, seed=sd)
                for p, sd in zip(SERVE_PROMPTS, SERVE_SEEDS)]
        images = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        _build.reset_launch_counts()
        alone = eng.submit(SERVE_PROMPTS[0], seed=SERVE_SEEDS[0]
                           ).result(timeout=600)
        alone_launches = dict(_build.LAUNCHES)
    st = eng.stats
    for i, im in enumerate(images + [alone]):
        check(isinstance(im, np.ndarray) and im.dtype == np.uint8
              and im.shape == (side, side, 3),
              f"{what}: image {i} is {type(im).__name__} "
              f"{getattr(im, 'dtype', None)} {getattr(im, 'shape', None)}")
        check(int(im.min()) >= 0 and int(im.max()) <= 255 and im.std() > 0,
              f"{what}: image {i} is out of range or flat")
    check((st.requests, st.batches, st.padded_slots) == (5, 4, 3),
          f"{what}: stats {st}")
    differ = int(np.abs(alone.astype(np.int16)
                        - images[0].astype(np.int16)).max())
    busy = st.total_batch_seconds - warm
    n = len(images) + 1
    print(f"{what}: ServingEngine(batch_size={BATCH}) served {len(images)} "
          f"seeded requests {side}x{side} in 2 batches (one padded), "
          f"{cfg.scheduler} {steps} steps, guidance {g}, MoE "
          f"topk 0.3 on 16 FFs: wall {wall:.3f} s, {len(images) / wall:.4f} "
          f"img/s; with request 0 alone after them {n} requests in "
          f"{busy:.3f} s of batches, {n / busy:.4f} img/s, mean_fill "
          f"{st.mean_fill:.4f} (warm-up included), peak memory "
          f"{peak_gib:.2f} GiB; request 0 alone against co-batched: max "
          f"|diff| {differ} of 255; launches {launches}", flush=True)
    check(differ == 0, f"{what}: request 0 alone differs from request 0 "
          f"co-batched by {differ} of 255")
    check_no_plain(launches, what)
    check_no_plain(alone_launches, f"{what}, request 0 alone")
    for name, per_batch in expect_per_batch.items():
        check(launches[name] == 2 * per_batch
              and alone_launches[name] == per_batch,
              f"{what}: kernel {name} launched {launches[name]} times over 2 "
              f"batches and {alone_launches[name]} over 1, expected "
              f"{per_batch} a batch")
    return launches


def run_serving(pipe, ivs, modes_off: dict, card: str) -> dict:
    """Phase 7: the serving engine over a pipeline with `attn_absorb="1"`
    and `conv_chain=True` on the seeded weights, its `denoise` latents
    against those of the modes-off pipeline (phase 4), and the same traffic
    through an engine with the modes off."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                sd15_config)
    from diffusion_models_moe_tpu_torch.models.layers import ResnetBlock2D
    from diffusion_models_moe_tpu_torch.ops.attn_absorb_fused import \
        attn_absorb_ok
    cfg = sd15_config(torch.bfloat16, attn_absorb="1", conv_chain=True)
    pipe_on = StableDiffusionPipeline(cfg, device=DEV)
    pipe_on.init_params(torch.Generator(device=DEV).manual_seed(0))
    # the gates admit every self-attention level and every resblock conv of
    # SD1.5 (the channel counts decide, not H and W), so the counts below
    # leave no call on the ordinary path
    for tokens, c in LEVELS:
        check(attn_absorb_ok(tokens, c, 8), f"attn_absorb_ok: S={tokens}, C={c}")
    n_chain = sum(sum(m.chain_branches(8, 8)) for m in pipe_on.unet.modules()
                  if isinstance(m, ResnetBlock2D))
    check(n_chain == 2 * RESNETS, f"{n_chain} chain convs of {2 * RESNETS}")
    calls = cfg.num_inference_steps + 1
    attn = 16 * calls
    on = serve(pipe_on, ivs, f"serving, modes on, {card}",
               {"ln_qkv_fused": attn, "attn_out_residual_fused": attn,
                "conv3x3_chain": n_chain * calls, "geglu_ff_fused": attn,
                "sd_self_attention": attn, "sd_cross_attention": attn,
                "fused_route_multiply": 0})
    g, steps = cfg.guidance_scale, cfg.num_inference_steps
    z_on, _ = pipe_on.denoise(modes_off["ctx"], modes_off["lat"], steps, g,
                              ivs=ivs)
    z_off, floor = modes_off["z_k"], modes_off["floor"]
    check(bool(torch.isfinite(z_on).all()), "modes on: non-finite latents")
    rel = ((z_on - z_off).norm() / z_off.norm()).item()
    print(f"denoise {steps} steps, CFG {g}, MoE on 16 FFs: latent rel err "
          f"modes on vs modes off (kernels, same weights, context and "
          f"latents) {rel:.6f}; floor (plain bf16 vs plain f32, phase 4) "
          f"{floor:.6f}", flush=True)
    check(rel <= FLOOR_FACTOR * floor,
          f"modes on vs off {rel} > {FLOOR_FACTOR} x floor {floor}")
    # the same traffic with the modes off, on the same seeded weights (phase
    # 6 baked masks into `pipe`: give it the seeded weights back)
    pipe.load_state_dicts({k: m.state_dict()
                           for k, m in pipe_on.modules().items()})
    serve(pipe, ivs, f"serving, modes off, {card}",
          {"ln_qkv_fused": 0, "attn_out_residual_fused": 0, "conv3x3_chain": 0,
           "geglu_ff_fused": attn, "sd_self_attention": attn,
           "sd_cross_attention": attn, "fused_route_multiply": 0})
    return on


# ---------------------------------------------------------------- phase 8
def seeded_pipeline(**modes):
    """An SD1.5 bf16 pipeline with the serving `modes` on the seeded weights
    of every other phase."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                sd15_config)
    pipe = StableDiffusionPipeline(sd15_config(torch.bfloat16, **modes),
                                   device=DEV)
    pipe.init_params(torch.Generator(device=DEV).manual_seed(0))
    return pipe


def winograd_shapes(pipe, ivs) -> tuple:
    """One UNet call at batch 2 x BATCH and one VAE decode at batch BATCH
    with a hook on every `WinoConv`: the (side, Cin, Cout) of each conv that
    takes the kernel, counted, for the UNet and for the VAE."""
    import collections
    from diffusion_models_moe_tpu_torch.models.layers import WinoConv
    cfg = pipe.config
    seen = collections.Counter()

    def hook(mod, args, _out):
        h, w = args[0].shape[2:]
        if mod.takes_kernel(h, w):
            seen[(h, mod.in_channels, mod.out_channels)] += 1

    out = []
    lat = torch.zeros((BATCH, 4, cfg.sample_size, cfg.sample_size), device=DEV)
    ctx = torch.zeros((2 * BATCH, cfg.text_encoder.max_length,
                       cfg.unet.cross_attention_dim), device=DEV)
    for module, run in ((pipe.unet, lambda: pipe.unet(
            torch.cat([lat, lat]), 500, ctx, ivs=ivs)),
                        (pipe.vae_decoder, lambda: pipe.decode(lat))):
        hooks = [m.register_forward_hook(hook) for m in module.modules()
                 if isinstance(m, WinoConv)]
        seen.clear()
        with torch.no_grad():
            run()
        for h in hooks:
            h.remove()
        out.append(dict(seen))
    return tuple(out)


def approx_mode(pipe, what: str, cond, uncond, ivs, modes_off: dict,
                decorrelated: float, expect: dict, card: str) -> dict:
    """A 50-step generate of BATCH requests through an approximate serving
    mode, its launch counts held to `expect`, and its `denoise` latents
    against the exact path's (phase 4), held below APPROX_FACTOR of the
    decorrelated distance."""
    cfg = pipe.config
    pipe.generate(cond, uncond, torch.Generator(device=DEV).manual_seed(2),
                  num_steps=1, ivs=ivs)                     # warm-up
    torch.cuda.synchronize()
    _, launches = timed_generate(pipe, f"{what} on {card}", cond, uncond,
                                 seed=3, ivs=ivs, expect=expect)
    z, _ = pipe.denoise(modes_off["ctx"], modes_off["lat"],
                        cfg.num_inference_steps, cfg.guidance_scale, ivs=ivs)
    check(bool(torch.isfinite(z).all()), f"{what}: non-finite latents")
    z_off = modes_off["z_k"]
    rel = ((z - z_off).norm() / z_off.norm()).item()
    print(f"denoise {cfg.num_inference_steps} steps, {what}: latent rel err "
          f"against the exact path (kernels, same weights, context and "
          f"latents) {rel:.6f}; limit {APPROX_FACTOR} x the decorrelated "
          f"distance {decorrelated:.6f}; floor (plain bf16 vs plain f32, "
          f"phase 4) {modes_off['floor']:.6f}", flush=True)
    check(rel <= APPROX_FACTOR * decorrelated,
          f"{what}: latent rel err {rel} > {APPROX_FACTOR} x {decorrelated}")
    return launches


def run_remaining_modes(pipe, ivs, cond, uncond, modes_off: dict,
                        card: str) -> dict:
    """Phase 8: the Winograd (fused kernel), int8 and DeepCache serving
    modes at full SD1.5 width, on the seeded weights."""
    cfg = pipe.config
    steps, g = cfg.num_inference_steps, cfg.guidance_scale
    calls = steps + 1
    attn = 16 * calls

    # --- conv_winograd="fused" through the serving engine
    fused = seeded_pipeline(conv_winograd="fused")
    unet_seen, vae_seen = winograd_shapes(fused, ivs)
    check(unet_seen == dict(WINO_UNET),
          f"convs of a UNet call on the kernel: {unet_seen}")
    check(vae_seen == dict(WINO_VAE),
          f"convs of a VAE decode on the kernel: {vae_seen}")
    per_batch = WINO_UNET_CONVS * calls + WINO_VAE_CONVS
    print(f"winograd: {WINO_UNET_CONVS} convs of a UNet call and "
          f"{WINO_VAE_CONVS} of a VAE decode take the kernel: {per_batch} "
          f"launches a served batch", flush=True)
    launches = serve(fused, ivs, f"serving, conv_winograd=fused, {card}",
                     {"winograd3x3_fused": per_batch, "conv3x3_chain": 0,
                      "ln_qkv_fused": 0, "attn_out_residual_fused": 0,
                      "geglu_ff_fused": attn, "sd_self_attention": attn,
                      "sd_cross_attention": attn, "fused_route_multiply": 0})
    z_on, _ = fused.denoise(modes_off["ctx"], modes_off["lat"], steps, g,
                            ivs=ivs)
    z_off, floor = modes_off["z_k"], modes_off["floor"]
    check(bool(torch.isfinite(z_on).all()), "winograd: non-finite latents")
    rel = ((z_on - z_off).norm() / z_off.norm()).item()
    print(f"denoise {steps} steps, CFG {g}, MoE on 16 FFs: latent rel err "
          f"conv_winograd=fused vs modes off (kernels, same weights, context "
          f"and latents) {rel:.6f}; floor (plain bf16 vs plain f32, phase 4) "
          f"{floor:.6f}", flush=True)
    check(rel <= FLOOR_FACTOR * floor,
          f"winograd vs modes off {rel} > {FLOOR_FACTOR} x floor {floor}")
    del fused

    # --- what two unrelated samples differ by on this card: the exact path
    # from other initial noise
    other = torch.randn(modes_off["lat"].shape, device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(5))
    z_other, _ = pipe.denoise(modes_off["ctx"], other, steps, g, ivs=ivs)
    decorrelated = ((z_other - z_off).norm() / z_off.norm()).item()
    print(f"denoise {steps} steps from other initial noise: decorrelated "
          f"latent distance {decorrelated:.6f}", flush=True)

    # --- quant_int8: no fused FF, no absorb; every FF through kernel 4
    quant = seeded_pipeline(quant_int8=True)
    approx_mode(quant, "quant_int8", cond, uncond, ivs, modes_off,
                decorrelated,
                {"geglu_ff_fused": 0, "fused_route_multiply": attn,
                 "sd_self_attention": attn, "sd_cross_attention": attn,
                 "winograd3x3_fused": 0, "conv3x3_chain": 0}, card)
    kw = dict(num_steps=10, ivs=ivs, decode=False)
    other_cond = torch.roll(cond, 1, dims=1)
    a, _ = quant.generate(cond, uncond, seeds=[11, 12], **kw)
    b, _ = quant.generate(torch.cat([cond[:1], other_cond[1:]]), uncond,
                          seeds=[11, 99], **kw)
    differ = (a[0] - b[0]).abs().max().item()
    print(f"quant_int8: request 0 of a 10-step generate against the same "
          f"request beside another prompt and seed: max |latent diff| "
          f"{differ}; the other slot moved by "
          f"{(a[1] - b[1]).abs().max().item():.4f}", flush=True)
    check(differ == 0.0 and not torch.equal(a[1], b[1]),
          f"quant_int8: request 0 depends on its batch ({differ})")
    del quant

    # --- deep_cache_interval=3: the branch is on the index over the
    # scheduler's table
    interval = 3
    full = sum(i % interval == 0 for i in range(calls))
    shallow = calls - full
    deep = seeded_pipeline(deep_cache_interval=interval)
    ffs = 16 * full + 5 * shallow   # the shallow forward runs FFs 0, 1, 13-15
    print(f"deep_cache_interval={interval}: {full} full and {shallow} shallow "
          f"UNet calls over {calls} scheduler entries", flush=True)
    approx_mode(deep, f"deep_cache_interval={interval}", cond, uncond, ivs,
                modes_off, decorrelated,
                {"geglu_ff_fused": ffs, "sd_self_attention": ffs,
                 "sd_cross_attention": ffs, "fused_route_multiply": 0}, card)
    return launches


# ---------------------------------------------------------------- phase 2e
def check_sd21_kernels(gen: torch.Generator) -> dict:
    """Phase 2e: kernels 1, 2, 3, 5, 6 and 7 against their plain versions at
    every SD2.1-768 shape of their kind (UNet batch 2 x BATCH, 96 x 96
    latents, 64-dim heads), with the same times, bounds and yardsticks as
    at SD1.5. Returns {kernel: (rows, sums over one UNet call)}."""
    label = "SD2.1-768"
    ff, _ = check_ff(gen, SD21_ATTN, label, row_limit=implied_row_agreement)
    self_attn, cross_attn = check_attention(gen, SD21_ATTN, (), label)
    ln_qkv, attn_out = check_absorb(gen, SD21_ATTN, label)
    chain = check_chain(gen, SD21_CONV_SHAPES, label)
    out = {}
    for name, rows, counts in (
            ("geglu_ff_fused", ff, LEVEL_BLOCKS),
            ("sd_self_attention", self_attn, LEVEL_BLOCKS),
            ("sd_cross_attention", cross_attn, LEVEL_BLOCKS),
            ("ln_qkv_fused", ln_qkv, LEVEL_BLOCKS),
            ("attn_out_residual_fused", attn_out, LEVEL_BLOCKS),
            ("conv3x3_chain", chain, CONV_COUNTS)):
        sums = {k: per_call(rows, counts, k)
                for k in ("ms", "bound_ms", "plain_ms")}
        for k in ("library_ms", "cublas_products_ms", "cublas_product_ms"):
            if rows[0].get(k) is not None:
                sums[k] = per_call(rows, counts, k)
        out[name] = (rows, sums)
    return out


# ---------------------------------------------------------------- phase 10
SD21_PROMPTS = ["a photo of a dog", "a house in the style of Van Gogh"]
# the longer of phase 10's two kernels-vs-plain runs: the config's 50 steps
SD21_LONG_STEPS = 50


def run_sd21(card: str) -> dict:
    """Phase 10: moefied SD2.1-768 (seeded random weights, MoE routing on all
    16 FFs) through `generate`: 2 requests from the hash tokenizer, DDIM
    v-prediction at 50 steps, CFG 7.5, decoded to 768 x 768; `denoise`
    latents with kernels against plain versions after 3 and
    SD21_LONG_STEPS steps within the card's own SD2.1 floor; and the same
    requests with the exact-tier modes on. Returns the launch counts of the
    modes-off and the modes-on generate."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                build_moe_interventions,
                                                sd21_config)
    from diffusion_models_moe_tpu_torch.data.tokenize import hash_tokenize
    from diffusion_models_moe_tpu_torch.models.layers import ResnetBlock2D
    from diffusion_models_moe_tpu_torch.ops.attn_absorb_fused import \
        attn_absorb_ok
    dev = DEV
    cfg = sd21_config(torch.bfloat16)
    steps, g = cfg.num_inference_steps, cfg.guidance_scale
    calls = unet_calls(cfg, steps)
    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline(cfg, device=dev)
    pipe.init_params(torch.Generator(device=dev).manual_seed(0))
    ivs = build_moe_interventions(labels_for(cfg.unet.ff_dims()), 0.3,
                                  device=dev, dtype=cfg.unet.dtype)
    tcfg = cfg.text_encoder
    tok = hash_tokenize(tcfg.vocab_size, tcfg.max_length)
    cond = tok(SD21_PROMPTS).to(dev)
    uncond = tok([""]).repeat(BATCH, 1).to(dev)
    torch.cuda.synchronize()
    print(f"sd21: SD2.1-768 bf16 pipeline built with seeded random weights in "
          f"{time.perf_counter() - t0:.1f} s ({cfg.sample_size}x"
          f"{cfg.sample_size} latents, heads {cfg.unet.attention_head_dim}, "
          f"{tcfg.num_layers}-layer {tcfg.hidden_act} text tower)", flush=True)
    pipe.generate(cond, uncond, torch.Generator(device=dev).manual_seed(2),
                  num_steps=1, ivs=ivs)                     # warm-up
    torch.cuda.synchronize()
    per_gen = 16 * calls
    _, launches = timed_generate(
        pipe, f"SD2.1-768 on {card}", cond, uncond, seed=3, ivs=ivs,
        expect={"geglu_ff_fused": per_gen, "sd_self_attention": per_gen,
                "sd_cross_attention": per_gen, "fused_route_multiply": 0,
                "ln_qkv_fused": 0, "attn_out_residual_fused": 0,
                "conv3x3_chain": 0})
    # kernels against plain versions, and the card's own SD2.1 floor
    pipe32 = StableDiffusionPipeline(sd21_config(torch.float32), device=dev)
    pipe32.init_params(torch.Generator(device=dev).manual_seed(0))
    ctx = torch.cat([pipe.encode_text(uncond)[0], pipe.encode_text(cond)[0]])
    ctx32 = torch.cat([pipe32.encode_text(uncond)[0],
                       pipe32.encode_text(cond)[0]])
    lat = torch.randn((BATCH, 4, cfg.sample_size, cfg.sample_size),
                      generator=torch.Generator(device=dev).manual_seed(4),
                      device=dev)
    for n in (3, SD21_LONG_STEPS):
        _, floor, z_k = kernels_vs_plain(pipe, pipe32, ctx, ctx32, lat, n, g,
                                         ivs, "SD2.1-768 DDIM v-prediction, "
                                         "MoE on 16 FFs")
    del pipe32
    torch.cuda.empty_cache()
    # the exact-tier modes on the same weights and requests
    cfg_on = sd21_config(torch.bfloat16, attn_absorb="1", conv_chain=True)
    pipe_on = StableDiffusionPipeline(cfg_on, device=dev)
    pipe_on.load_state_dicts({k: m.state_dict()
                              for k, m in pipe.modules().items()})
    del pipe
    for tokens, c, heads in SD21_ATTN:
        check(attn_absorb_ok(tokens, c, heads),
              f"attn_absorb_ok: S={tokens}, C={c}, {heads} heads")
    side = cfg.sample_size // 8          # the innermost level's latents
    n_chain = sum(sum(m.chain_branches(side, side))
                  for m in pipe_on.unet.modules()
                  if isinstance(m, ResnetBlock2D))
    check(n_chain == 2 * RESNETS, f"{n_chain} chain convs of {2 * RESNETS}")
    pipe_on.generate(cond, uncond, torch.Generator(device=dev).manual_seed(2),
                     num_steps=1, ivs=ivs)                  # warm-up
    _, launches_on = timed_generate(
        pipe_on, f"SD2.1-768, exact-tier modes on, on {card}", cond, uncond,
        seed=3, ivs=ivs,
        expect={"ln_qkv_fused": per_gen, "attn_out_residual_fused": per_gen,
                "conv3x3_chain": n_chain * calls, "geglu_ff_fused": per_gen,
                "sd_self_attention": per_gen, "sd_cross_attention": per_gen,
                "fused_route_multiply": 0})
    z_on, _ = pipe_on.denoise(ctx, lat, SD21_LONG_STEPS, g, ivs=ivs)
    check(bool(torch.isfinite(z_on).all()), "SD2.1 modes on: non-finite latents")
    rel = ((z_on - z_k).norm() / z_k.norm()).item()
    print(f"denoise {SD21_LONG_STEPS} steps, SD2.1-768: latent rel err modes "
          f"on vs modes off (kernels, same weights, context and latents) "
          f"{rel:.6f}; floor (plain bf16 vs plain f32) {floor:.6f}",
          flush=True)
    check(rel <= FLOOR_FACTOR * floor,
          f"SD2.1 modes on vs off {rel} > {FLOOR_FACTOR} x floor {floor}")
    del pipe_on
    torch.cuda.empty_cache()
    return dict(serving=launches, modes_on=launches_on)


# ---------------------------------------------------------------- phase 11
# (scheduler, steps) of phase 11 on the SD1.5 geometry; LCM's guidance
# scale, which it embeds (the LCM UNet has a 256-wide guidance embedding,
# as the public LCM_Dreamshaper_v7 checkpoint's)
OTHER_SCHEDULERS = (("euler", 50), ("dpm", 20), ("lcm", 4))
LCM_GUIDANCE = 8.0
LCM_COND_DIM = 256


def sd15_variant(dtype: torch.dtype, scheduler: str):
    """An SD1.5 pipeline under `scheduler` on the seeded weights (LCM: a
    UNet with the guidance embedding, its own seeded weights)."""
    import dataclasses
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                sd15_config)
    cfg = sd15_config(dtype)
    unet = cfg.unet
    if scheduler == "lcm":
        unet = dataclasses.replace(unet, time_cond_proj_dim=LCM_COND_DIM)
    pipe = StableDiffusionPipeline(
        dataclasses.replace(cfg, scheduler=scheduler, unet=unet), device=DEV)
    pipe.init_params(torch.Generator(device=DEV).manual_seed(0))
    return pipe


def run_other_schedulers(ivs, cond, uncond, card: str) -> dict:
    """Phase 11: Euler at 50 steps, DPM-Solver++ 2M at 20 and LCM at 4
    (guidance embedding, LCM_GUIDANCE) on the SD1.5 geometry: a timed
    2-request generate each with its launch counts, `denoise` latents with
    kernels against plain versions within its own bf16-vs-f32 floor (LCM's
    three runs on one injected step noise), then a ServingEngine over the
    LCM pipeline. Returns the launch counts of each generate and the
    engine's."""
    out = {}
    for name, steps in OTHER_SCHEDULERS:
        lcm = name == "lcm"
        pipe = sd15_variant(torch.bfloat16, name)
        cfg = pipe.config
        g = LCM_GUIDANCE if lcm else cfg.guidance_scale
        per_gen = 16 * unet_calls(cfg, steps)
        pipe.generate(cond, uncond, torch.Generator(device=DEV).manual_seed(2),
                      num_steps=1, ivs=ivs, guidance_scale=g)   # warm-up
        torch.cuda.synchronize()
        _, out[name] = timed_generate(
            pipe, f"{name} on {card}", cond, uncond, seed=3, ivs=ivs,
            num_steps=steps, guidance_scale=g,
            expect={"geglu_ff_fused": per_gen, "sd_self_attention": per_gen,
                    "sd_cross_attention": per_gen, "fused_route_multiply": 0})
        pipe32 = sd15_variant(torch.float32, name)
        halves = (cond,) if lcm else (uncond, cond)
        ctx = torch.cat([pipe.encode_text(h)[0] for h in halves])
        ctx32 = torch.cat([pipe32.encode_text(h)[0] for h in halves])
        s = cfg.sample_size
        scale = getattr(pipe.scheduler, "init_noise_sigma_for", None)
        scale = scale(steps) if scale else pipe.scheduler.init_noise_sigma
        lat = torch.randn((BATCH, 4, s, s), device=DEV,
                          generator=torch.Generator(device=DEV).manual_seed(4)
                          ) * scale
        kw = {}
        if lcm:
            kw["step_noise"] = torch.randn(
                (steps, BATCH, 4, s, s), device=DEV,
                generator=torch.Generator(device=DEV).manual_seed(6))
        kernels_vs_plain(pipe, pipe32, ctx, ctx32, lat, steps, g, ivs,
                         f"{name}, MoE on 16 FFs", **kw)
        del pipe32
        if lcm:
            out["lcm_engine"] = serve(
                pipe, ivs, f"serving, LCM, {card}",
                {"geglu_ff_fused": 16 * steps, "sd_self_attention": 16 * steps,
                 "sd_cross_attention": 16 * steps, "fused_route_multiply": 0},
                num_steps=steps, guidance_scale=g)
        del pipe
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs only on "
                         "the GPU")
    if torch.cuda.device_count() != 1:
        raise SystemExit(f"chip_smoke: runs on one card, {torch.cuda.device_count()}"
                         " are visible (set CUDA_VISIBLE_DEVICES)")
    sys.path.insert(0, ROOT)
    from diffusion_models_moe_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    EXP_RATE[0] = EXP_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6
    print(f"max SM clock {clock_mhz:.0f} MHz, {sms} SMs: {EXP_RATE[0] / 1e12:.3f} "
          f"T exponentials/s at {EXP_PER_CLOCK_PER_SM} a clock an SM")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"kernels built from ops/csrc in {lib.build_seconds:.1f} s (load "
          f"{time.perf_counter() - t0:.1f} s): {lib.path.name}")
    for line in lib.compiler_log.splitlines():
        if "registers" in line or ("spill" in line
                                   and " 0 bytes spill stores" not in line):
            print("  ptxas:", line.strip())

    print(f"phase 1 (build) wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    card = smi.splitlines()[0]
    phase_t0 = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal phase_t0
        print(f"phase {name} wall {time.perf_counter() - phase_t0:.1f} s",
              flush=True)
        phase_t0 = time.perf_counter()

    gen = torch.Generator(device=DEV).manual_seed(0)
    ff, ff_kernels = check_ff(gen)
    phase_done("2 (fused FF)")
    route = check_routing(gen)
    phase_done("2b (routing kernel)")
    self_attn, cross_attn = check_attention(gen)
    phase_done("2 (attention)")
    ln_qkv, attn_out = check_absorb(gen)
    chain = check_chain(gen)
    phase_done("2c (attention absorb and conv chain)")
    wino = check_winograd(gen)
    phase_done("2d (fused Winograd)")
    sd21_kernels = check_sd21_kernels(gen)
    phase_done("2e (kernels at SD2.1-768's shapes)")
    pipe, ivs, cond, uncond, launches, images = run_slice(card)
    phase_done("3 (serving slice)")
    compare, modes_off = check_latents(pipe, ivs, cond, uncond)
    phase_done("4 (latents)")
    run_off_kernels(modes_off.pop("pipe32"), cond, uncond, card)
    phase_done("4b (f32 and tiny_config generates on the plain versions)")
    attribution_launches = run_attribution(pipe, ivs, compare, card)
    phase_done("5 (attribution and neuron erasure)")
    wanda_launches = run_wanda(pipe, ivs, images, card)
    phase_done("6 (wanda erasure and bake)")
    serving_launches = run_serving(pipe, ivs, modes_off, card)
    phase_done("7 (serving engine, exact-tier modes)")
    wino_launches = run_remaining_modes(pipe, ivs, cond, uncond, modes_off,
                                        card)
    phase_done("8 (Winograd, int8 and DeepCache serving modes)")
    modes_off.pop("pipe32", None)
    del pipe, compare, modes_off
    torch.cuda.empty_cache()
    sd21_launches = run_sd21(card)
    phase_done("10 (SD2.1-768: DDIM, v-prediction, exact-tier modes)")
    other_launches = run_other_schedulers(ivs, cond, uncond, card)
    phase_done("11 (Euler, DPM-Solver++ 2M, LCM and its serving engine)")
    ff_launch_times(ff, ff_kernels)
    phase_done("9 (kernel 1's launches apart, by the profiler)")
    print("launches by path: " + json.dumps({
        "serving": launches, "attribution": attribution_launches,
        "wanda_erasure": wanda_launches,
        "serving_engine_modes_on": serving_launches,
        "serving_engine_winograd": wino_launches,
        "sd21_serving": sd21_launches["serving"],
        "sd21_modes_on": sd21_launches["modes_on"],
        **{f"sd15_{k}": v for k, v in other_launches.items()}}))

    csrc = "diffusion_models_moe_tpu_torch/ops/csrc"
    rows = [
        ("geglu_ff_fused", f"{csrc}/geglu_ff.cu",
         "diffusion_models_moe_tpu/ops/geglu_ff_fused.py:85", ff, launches),
        ("sd_self_attention", f"{csrc}/sd_attention.cu",
         "diffusion_models_moe_tpu/ops/sd_flash.py:46", self_attn, launches),
        ("sd_cross_attention", f"{csrc}/sd_attention.cu",
         "diffusion_models_moe_tpu/ops/sd_flash.py:142", cross_attn, launches),
        # its path is the attribution run (phase 5): taps force the unfused FF
        ("fused_route_multiply", f"{csrc}/geglu_ff.cu",
         "diffusion_models_moe_tpu/ops/routing_kernel.py:45", route,
         attribution_launches),
        # their path is the serving engine with the modes on (phase 7)
        ("ln_qkv_fused", f"{csrc}/attn_absorb.cu",
         "diffusion_models_moe_tpu/ops/attn_absorb_fused.py:88", ln_qkv,
         serving_launches),
        ("attn_out_residual_fused", f"{csrc}/attn_absorb.cu",
         "diffusion_models_moe_tpu/ops/attn_absorb_fused.py:167", attn_out,
         serving_launches),
        ("conv3x3_chain", f"{csrc}/conv_chain.cu",
         "diffusion_models_moe_tpu/ops/conv_chain_fused.py:76", chain,
         serving_launches),
        # its path is the serving engine with conv_winograd="fused" (phase 8)
        ("winograd3x3_fused", f"{csrc}/winograd.cu",
         "diffusion_models_moe_tpu/ops/winograd_fused.py:76", wino,
         wino_launches),
    ]
    # the top-level numbers are those of the first (largest-N) shape; every
    # shape's own numbers are under "shapes"
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts[name],
                    max_abs_err=m[0]["max_abs_err"], ms=m[0]["ms"],
                    plain_ms=m[0]["plain_ms"], bound_ms=m[0]["bound_ms"],
                    bound_by=m[0]["bound_by"], library_ms=m[0]["library_ms"],
                    shape=m[0]["shape"], shapes=m)
               for name, src, rep, m, counts in rows]
    # phase 2e's shapes and sums over one SD2.1-768 UNet call, and the
    # launches of phase 10's generate (kernels 5-7: with the modes on)
    for k in kernels:
        if k["name"] in sd21_kernels:
            rows_21, sums_21 = sd21_kernels[k["name"]]
            path = ("modes_on" if k["name"] in ("ln_qkv_fused",
                                                "attn_out_residual_fused",
                                                "conv3x3_chain")
                    else "serving")
            k.update(sd21_shapes=rows_21, sd21_unet_call=sums_21,
                     sd21_launches=sd21_launches[path][k["name"]])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
