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
  12. (run after 11) the MoEfication front end on the seeded SD1.5 weights:
     written as a diffusers snapshot in f32 (unet, text_encoder with its
     position_ids buffer, vae with a seeded encoder side, a byte-level CLIP
     vocabulary of 49408 ids), read by `load_pipeline_snapshot` into a fresh
     bf16 pipeline and `load_tokenizer` (native merges), every gate clustered
     by `moefy_unet` (Sinkhorn plans on the card) into exactly balanced
     20-neuron experts, a SNAPSHOT_STEPS-step routed generate of 2 requests on
     those labels (kernels 1-3 at 16 launches a UNet call, no plain call,
     latents bit-equal to the in-memory weights'), then a seeded gate mask
     baked by `bake_gate_masks`, written with `save_safetensors`, held to the
     SD1.5 key fixture by `validate_edited_unet`, read back through
     `load_edited_unet_state_dict` into a fresh pipeline and served bit-equal
     to the in-memory bake; the snapshot lives in a temporary directory
     removed when the phase ends;
  2f. (run after 2e) kernels 1, 2, 3, 5, 6, 7 and 8 at every SDXL shape of
     their kind (UNet batch 4, 128 x 128 latents: 4096 and 1024 tokens, 10
     and 20 heads of 64, FFs of 16 384 rows at E = 128 and 4096 at E = 256,
     whose row agreement is held to what the decision limit implies, 3x3
     convs at 128 to 32 side; kernel 8 also the VAE decoder at 1024 px),
     and kernel 8 at SD2.1-768's UNet convs and 768-px decode, with the
     same times, bounds and yardsticks as at SD1.5 and their sums over one
     SDXL UNet call;
  14. (run after 11) Safe Latent Diffusion on SD1.5: phase 3's seeded
     weights and labels, the safety concept through the hash tokenizer, a
     2-request `sld_generate` at 50 PNDM steps with `SLDConfig.medium()`
     (UNet batch 6), timed, kernels 1-3 at 16 launches a UNet call;
     `sld_denoise` latents with kernels against plain versions within the
     card's floor after 3 steps of `max()` and 50 of `medium()`, and apart
     from CFG alone on the same noise;
  13. (run after 12) SDXL at full width: `sdxl_config(torch.bfloat16)`
     with seeded random weights, MoE routing on all 70 FFs, the hash
     tokenizer, 2 requests at 1024 x 1024, Euler at 50 steps with CFG 7.5:
     wall, img/s, peak memory, kernels 1-3 at 70 launches a UNet call, no
     plain call; `denoise` latents against plain versions after 3 and
     SDXL_LONG_STEPS steps within the card's own SDXL floor; the exact-tier
     modes (kernels 5-7 at their counts, latents within that floor);
     Sinkhorn clustering of one gate of each width (640, 1280; the other
     68 cut for time) and a gate bake, timed; LCM-SDXL
     (`lcm=True`, the JAX bench's `lcm-sdxl` point: 4 steps, batch 2),
     timed, its latents on one injected step noise within its own floor,
     and a ServingEngine(batch_size=2) over it serving phase 7's requests;
  2g. (run after 2f) kernels 2 and 3 at PixArt-512's shapes (DiT batch 4,
     1024 tokens, 16 heads of 72; the cross kernel over T5's 120 keys in its
     128-key tile) and at ragged D = 72 cases (S = 1000 and 77, a strided
     view, 100, 77 and 1 valid keys), with the same times, bounds and
     yardsticks as at SD1.5 and their sums over one DiT call;
  2h. (run after 2g) the channels-last GroupNorm kernel against its plain
     version at SD1.5's, SDXL's and the VAE decoder's shapes (with the time
     bias and SiLU where the resblocks take them), held to 1.5 x the card's
     bf16 floor of the same sequence, bit-equal on a repeat and for a sample
     alone; graph times of kernel and plain version beside its bounds at 4
     and 6 bytes an element;
  15. (run after 13) PixArt-alpha at full width: `pixart_512_config(bf16)`
     (the PixArt-XL-2-512 DiT and T5 v1.1 XXL, built on the card) with seeded
     random weights, 2 captions tokenized by the port's T5 tokenizer
     (`load_t5_tokenizer` on a synthetic 32 100-piece Unigram tokenizer.json
     the phase writes; 22 and 46 of 120 positions tokens, the negative
     caption </s> alone), DPM-Solver++ 2M at 20 steps with CFG 4.5,
     decoded to 512 x 512: wall, img/s, peak memory, kernels 2 and 3 at 28
     launches a DiT call, every other kernel and plain counter at 0;
     `denoise` latents with kernels against plain versions after 3 and 20
     steps within the card's own PixArt floor (an f32 copy of the DiT on the
     bf16 T5 features); a mean-gate tapped generate and a neuron removal at
     the highest mean gates (steps t <= 5), which moves the latents beyond
     that floor; request 0 padded with itself bit-equal to co-batched;
  16. (run after 15) `checked_generate` over the moefied SD1.5 of phase 3
     (its seeded weights and labels, 2 requests by seed, PNDM 50 steps, CFG
     7.5, `safety_check` and `blur_nsfw` on) with a CLIPNSFWChecker on a
     seeded full-width CLIP ViT-L/14 (f32) and the unsafe concepts through
     the pipeline's CLIP-L tower and a seeded 768 x 768 projection, its
     threshold between the two images' largest similarities: one image
     flagged and equal to `blur_images` of plain `generate`'s, the other
     bit-equal to it, kernels 1-3 at 816 launches each and no plain call;
     then the judges of the two images at full width, each on the card and
     on the CPU within JUDGE_TOL: CLIP score and CLIP-IQA on CLIP ViT-B/32
     towers, Inception-v3 pool features and FID against 2 seeded images,
     the CLIP-feature FID, LPIPS (AlexNet) between the flagged image and
     its unblurred self, SSCD (ResNet-50 + GeM, 512-d) memorization scores
     of the images against themselves (diagonal 1 within 1e-5);
  17. (run after 16) the erasure evaluation over the moefied SD1.5 of phase
     3 (its seeded weights and labels) with phase 5's neuron removal: a
     seeded full-width YOLOv8n (NudeNet's 18 classes at 320 px) written as
     an ONNX file by the script's own writer and read by
     `load_nudenet_native`, its boxes, probabilities and detections on the
     card against the same module on the CPU within JUDGE_TOL; `run_eval`
     over the first 4 I2P prompts (batch 4, PNDM 50 steps, CFG 7.5) through
     the CLIP tokenizer of phase 16's vocabulary, the baseline generate
     (MoE) on kernels 1-3 and the erased one (MoE + removal) on kernels 2-4,
     816 launches each and no plain call; with no interventions a baseline
     and its erased image bit-equal (shared noise); `i2p_protocol` over the
     same directory skipping all 4 prompts, its count equal to the
     detector's on the PNGs; a seeded full-width LLaVA-1.5-7B in f32 (CLIP
     ViT-L/14-336, 32 layers of 4096, a hand-written llava-hf-layout
     `tokenizer.json` of 32 000 pieces + <image> read by
     `load_llama_tokenizer`) judging presence before and after through
     `removal_score` (`vqa.batch`, 32 new tokens); its cached greedy tokens
     equal to a teacher-forced forward's argmax, image 0 alone equal to
     co-batched, the vision tower and the LM's embedding, first two layers,
     norm and lm_head on the card against the CPU within JUDGE_TOL; walls of
     the image features, prefill and decode per token, peak memory;
  18. (run after 17) the rest of the evaluation: (a) the port's Qwen2
     tokenizer (`load_qwen_tokenizer`) on a 151 643-piece Qwen2-layout
     byte-level BPE `tokenizer.json` the script writes (the 14 added tokens
     at Qwen2-VL's ids), the chat template and the repo's prompt files
     encoded and decoded back, timed; (b) a seeded full-width Qwen2-VL-7B
     in f32 (its 32-block tower, the 28-layer Qwen2 LM with 3-D RoPE)
     judging phase 17's images through `removal_score` and a
     `MultipleChoiceScorer`, its cached greedy tokens (`.batch`, 4 images,
     32 new tokens) equal to a teacher-forced forward's argmax under the
     3-D positions, image 0 alone equal to co-batched, the tower (on a
     224-px image) and the LM's embedding, first two layers, norm and
     lm_head on the card against the CPU within JUDGE_TOL, walls of the
     image features, prefill and decode per token, peak memory, and
     `load_qwen2vl_native` at a tiny size from a snapshot the script
     writes; (c) `debias_eval` over phase 3's moefied SD1.5 (2 professions
     x 2 seeds, one image a generate, PNDM 50, CFG 7.5; before: MoE on
     kernels 1-3, after: MoE + phase 5's removal on kernels 2-4) with a
     seeded full-width CLIP ViT-L/14 featurizer; (d) `unified_editing_eval`
     of 3 prompts routed by a memorized-prompt and a CLIP-text checker to
     two of phase 6's Wanda mask sets (routed: kernels 2-4; the prompt
     firing none: kernels 1-3); (e) the seeded weights written as a
     snapshot with an ESD-style `.pt` and a Concept-Ablation `delta.bin`,
     `load_baseline` of "esd" and "concept-ablation" (the files' tensors
     in the loaded pipelines, a BASELINE_STEPS-step generate on kernels
     1-3) and of "sld" through `run_eval(generate_fn=
     make_protocol_generate(...))`; every generate's launches held to its
     path, no plain call;
  19. (run after 18) training on the ReLUfied SD1.5 (`sd15_config(bf16,
     relufied=True)`, seeded weights): (a) 4 seeded 512-px images and
     captions through a seeded full-width VAE encoder and the CLIP text
     encoder to scaled latents (`training.trainer.encode_batch`), timed, the
     encoder's f32 copy on the card against the CPU at 64 px within
     JUDGE_TOL; (b) `make_train_step` AdamW steps at batch 4 (f32 masters,
     moments and EMA, the bf16 working copy through kernels 2 and 3), 5
     after a warm-up with `remat` off and 5 with it on: step seconds
     (median), peak memory, the losses, kernels 2 and 3 at 16 launches a
     step (32 with remat: the checkpointed forward runs again in the
     backward), kernel 1's plain version as often (no backward kernel),
     nothing else; (c) one step's gradients through kernels 2 and 3 against
     the plain path's, both bf16, within GRAD_FLOOR_FACTOR x the card's
     floor (plain bf16 against plain f32); (d) at tiny_config on the card:
     an Adafactor step, an accumulation cycle of 2 with the EMA, and
     `train_relufied` for 6 steps with validation images against 4, a
     checkpoint and a resume to 6, bit-equal (cuDNN deterministic);
  20. (run after 19) the parallel layer: (a) `init_multihost()` alone is a
     no-op, then a group of one over NCCL; `create_mesh()` is dp = tp = 1;
     the moefied SD1.5's `generate(mesh=)` (2 requests, 50 PNDM steps)
     bit-equal to `generate()`, kernels 1-3 at 816; one AdamW step of the
     ReLUfied SD1.5 with the mesh bit-equal to the step without it; (b) two
     spawned ranks over gloo on the one card (NCCL takes no two ranks on one
     device), the same seeded full-width models: dp=2 images within the
     50-step floor of (a)'s, tp=2 latents after 3 steps within FLOOR_FACTOR
     x the 3-step floor, kernels 2, 3 and 4 at 4 heads on every call, kernel
     1 counted `tp:` and never launched, no plain call, each rank's wall and
     peak; (c) a dp=2 AdamW step, 2 a rank: its reduced gradients against
     the mean of the two halves' gradients in one process (PAR_EXACT) and
     against the whole batch's within GRAD_FLOOR_FACTOR x the card's floor
     on the same inputs; the kernels line gives `tp_launches` and
     `dp_launches`;
  21. (run after 20) the front door: the seeded SD1.5 weights as an f32
     diffusers snapshot, then `cli.main` in this process: (a)
     `check-snapshot --deep` (every reader ok); (b) `parity-run` at 10 PNDM
     steps over 2 prompt pairs (the launches its generates imply, no plain
     call; the baked weights' latents, run bare, within FLOOR_FACTOR x the
     card's 10-step floor of the dynamic removal's on the same snapshot);
     (c) a 50-step `generate` on (b)'s labels, kernels 1-3 at 816, its PNG
     bit-equal to the library generate's on a pipeline built without the
     CLI's code; (d)
     the same through `python -m diffusion_models_moe_tpu_torch.cli` in a
     subprocess, bit-equal to (c)'s (else within FLOOR_FACTOR x the 50-step
     floor); (e) `serve` of 3 stdin requests at batch 2 (kernels 1-3 at
     1632), `--int8` (kernel 4 at 176), `DMOE_WINO_FUSED=1 --winograd`
     (kernel 8 at 394); (f) `train` 2 steps on a 512-px imagefolder
     (kernels 2, 3 at 32, kernel 1's plain version at 32, a checkpoint at
     2) and a resume that takes none; (g) `profiling.profile_generate` at 10
     steps, each attention kernel counted in the trace as `_build.LAUNCHES`
     counts it; each command's wall and peak; the kernels line gives
     `cli_launches`;
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

import dataclasses
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
# GroupNorms of an SD1.5 UNet call (22 resblocks x 2, 16 Transformer2D,
# conv_norm_out) and of a VAE decode (mid block 5, 12 up resblocks x 2,
# conv_norm_out)
SD15_NORMS, VAE_NORMS = 61, 30
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
# SDXL (sdxl_config, 128 x 128 latents): (tokens, channels, heads) of its two
# attention levels (10 and 20 heads of 64) and the transformer blocks of a
# UNet call at each: 2 x 2 down and 3 x 2 up at 640; 2 x 10 down, 10 mid and
# 3 x 10 up at 1280
SDXL_ATTN = ((4096, 640, 10), (1024, 1280, 20))
SDXL_BLOCKS = (10, 60)
SDXL_FFS = sum(SDXL_BLOCKS)
# (side, Cin, Cout) of every 3x3 resblock conv of the SDXL UNet and how many
# convs of a UNet call have that shape (17 resblocks)
SDXL_CONV_SHAPES = ((128, 320, 320), (128, 640, 320), (128, 960, 320),
                    (64, 320, 640), (64, 640, 640), (64, 960, 640),
                    (64, 1280, 640), (64, 1920, 640),
                    (32, 640, 1280), (32, 1280, 1280), (32, 1920, 1280),
                    (32, 2560, 1280))
SDXL_CONV_COUNTS = (7, 2, 1, 1, 6, 1, 1, 1, 1, 10, 1, 2)
SDXL_RESNETS = 17
# kernel 8 under conv_winograd="fused": every SDXL resblock conv and the two
# upsampler convs (36 a UNet call); the VAE decoder's 31 at 1024 px, and
# SD2.1-768's 33 UNet convs at 96 to 24 side and 31 decoder convs at 768 px
WINO_SDXL_UNET = (tuple(zip(SDXL_CONV_SHAPES, SDXL_CONV_COUNTS))
                  + (((64, 1280, 1280), 1), ((128, 640, 640), 1)))
WINO_SDXL_VAE = tuple(((2 * side, cin, cout), n)
                      for (side, cin, cout), n in WINO_VAE)
WINO_SD21_UNET = tuple(((3 * side // 2, cin, cout), n)
                       for (side, cin, cout), n in WINO_UNET)
WINO_SD21_VAE = tuple(((3 * side // 2, cin, cout), n)
                      for (side, cin, cout), n in WINO_VAE)
# PixArt-512 (pixart_512_config: 64 x 64 latents in 2 x 2 patches): (tokens,
# channels, heads) of its one attention level (16 heads of 72) and the 28
# blocks of a DiT call; the cross keys are T5's 120 caption positions, all
# attended (pads included, as the JAX DiT does)
PIXART_ATTN = ((1024, 1152, 16),)
PIXART_BLOCKS = (28,)
T5_KEYS = 120
# extra cases at D = 72 (8 heads): ragged S, kernel 5's column-third view,
# fewer valid keys (77 of 120 and 1 take the 80-key tile)
ATTN_EXTRA_PIXART = ((4, 1000, 72, "bsc", T5_KEYS), (4, 77, 72, "bsc", T5_KEYS),
                     (4, 1024, 72, "bs3c", T5_KEYS), (4, 1024, 72, "bsc", 100),
                     (4, 1024, 72, "bsc", 77), (4, 1024, 72, "bsc", 1))


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


def device_kernels(fn) -> dict:
    """{device kernel name: (ms, launches)} of one call of fn(), from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key: (ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA}


def launch_ms(fn, groups, iters: int = 20) -> dict:
    """Device ms a call of fn() by group of kernel names, from torch.profiler
    over `iters` calls."""
    fn()
    kernels = device_kernels(lambda: [fn() for _ in range(iters)])
    out = dict.fromkeys((g for g, _ in groups), 0.0)
    for key, (ms, _) in kernels.items():
        for g, keys in groups:
            if any(k in key for k in keys):
                out[g] += ms / iters
    return out


def check_ff(gen: torch.Generator, levels=SD15_ATTN, label: str = "SD1.5",
             row_limit=lambda e: FF_ROW_AGREEMENT, counts=LEVEL_BLOCKS
             ) -> tuple[list, list]:
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
    sums = {key: per_call(shapes, counts, key)
            for key in ("ms", "call_ms", "cublas_products_ms", "bound_ms",
                        "plain_ms")}
    sums["split_floor_ms"] = per_call(floors, counts, "bound_ms")
    print(f"ff ({label}): the {sum(counts)} launches of a UNet call at batch "
          f"{2 * BATCH} sum to "
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
                    extra=ATTN_EXTRA, label: str = "SD1.5",
                    counts=LEVEL_BLOCKS, text_keys: int = 77
                    ) -> tuple[list, list]:
    """Phase 2: kernels 2 and 3 against their plain versions at the shapes
    of each kind that `levels` gives (with SDPA on the same tensors as the
    yardstick, and the wrapper's host time) and at `extra` (8 heads); the
    cross kernel over `text_keys` keys (CLIP's 77, T5's 120), all valid at
    `levels`."""
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

    cases = [(kind, 2 * BATCH, s, heads, c // heads, "bsc", text_keys, True)
             for kind in ("self", "cross") for s, c, heads in levels]
    cases += [(kind, b, s, 8, d, view, kvv, False)
              for kind in ("self", "cross") for b, s, d, view, kvv in extra
              if kind == "cross" or kvv == text_keys]
    for kind, b, s, heads, d, view, kv_valid, main in cases:
        shapes = out.setdefault(kind, [])
        s_kv = s if kind == "self" else text_keys
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
        # the cross kernel's plan takes the valid keys, as its wrapper
        plan = sd_flash.attn_plan(kind, b, heads, s,
                                  s_kv if kind == "self" else kv_valid, d,
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
                   bkv=plan.bkv, blocks=plan.blocks(b, heads),
                   max_abs_err=abs_e, rel_err=rel, **bd)
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
              f"rows x {plan.run} tiles, {plan.bkv}-key tiles", flush=True)
        shapes.append(row)
    for kind in ("self", "cross"):
        rows = out[kind][:len(levels)]
        print(f"{kind} ({label}): the {sum(counts)} launches of a model call "
              f"at batch {2 * BATCH} "
              f"sum to {per_call(rows, counts, 'ms'):.3f} ms in the kernel, "
              f"{per_call(rows, counts, 'library_ms'):.3f} ms in SDPA, bound "
              f"{per_call(rows, counts, 'bound_ms'):.3f} ms", flush=True)
    return out["self"], out["cross"]


# ---------------------------------------------------------------- phase 2c
def check_absorb(gen: torch.Generator, levels=SD15_ATTN,
                 label: str = "SD1.5", counts=LEVEL_BLOCKS
                 ) -> tuple[list, list]:
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
        sums = {k: per_call(rows, counts, k)
                for k in ("ms", "call_ms", "cublas_product_ms", "bound_ms",
                          "plain_ms")}
        print(f"{name} ({label}): the {sum(counts)} launches of a UNet call "
              f"at batch {b} sum to "
              f"{sums['ms']:.3f} ms in the kernel (back-to-back calls "
              f"{sums['call_ms']:.3f}); cuBLAS on the products alone "
              f"{sums['cublas_product_ms']:.3f}; bound {sums['bound_ms']:.3f}; "
              f"plain {sums['plain_ms']:.3f} ms", flush=True)
    return qkv_shapes, out_shapes


def check_chain(gen: torch.Generator, conv_shapes=CONV_SHAPES,
                label: str = "SD1.5", counts=CONV_COUNTS,
                resnets: int = RESNETS) -> list:
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
    check(sum(counts) == 2 * resnets and len(counts) == len(conv_shapes),
          f"{label}: conv counts")
    sums = {k: per_call(shapes, counts, k) for k in
            ("ms", "fold_and_kernel_ms", "unfused_ms", "library_ms", "bound_ms")}
    print(f"chain ({label}): the {2 * resnets} convs of a UNet call at batch {b} sum to "
          f"{sums['ms']:.3f} ms in the kernel, {sums['fold_and_kernel_ms']:.3f} "
          f"ms with the GroupNorm fold, against {sums['unfused_ms']:.3f} ms "
          f"for the unfused sequence, {sums['library_ms']:.3f} ms for cuDNN's "
          f"convolutions alone and a bound of {sums['bound_ms']:.3f} ms",
          flush=True)
    return shapes


# ---------------------------------------------------------------- phase 2d
def check_winograd(gen: torch.Generator, unet=WINO_UNET, vae=WINO_VAE,
                   totals=(WINO_UNET_CONVS, WINO_VAE_CONVS),
                   label: str = "SD1.5") -> list:
    """Phase 2d: the fused Winograd kernel against its plain version (the
    formulation of ops/winograd.py on the same hoisted, rounded filter) at
    every shape of `unet` (batch 2 x BATCH) and `vae` (batch BATCH; SD1.5's
    WINO_UNET and WINO_VAE, 2f: SDXL's and SD2.1-768's), with the bias.
    Beside it, as a yardstick only, cuDNN's convolution on the same tensors
    (it rounds neither V nor U, so it is held to twice the limit). Returns
    the rows, the UNet's first."""
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.ops import winograd_fused as wf
    dev, bf16, cl = DEV, torch.bfloat16, torch.channels_last
    shapes = []
    for what, b, table, total in (("unet", 2 * BATCH, unet, totals[0]),
                                  ("vae", BATCH, vae, totals[1])):
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
    n_unet = len(unet)
    for what, rows, table in (
            (f"{label} UNet call at batch {2 * BATCH}", shapes[:n_unet], unet),
            (f"{label} VAE decode at batch {BATCH}", shapes[n_unet:], vae)):
        counts = tuple(n for _, n in table)
        sums = {k: per_call(rows, counts, k)
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"wino: the {sum(counts)} convs of a {what} sum to "
              f"{sums['ms']:.3f} ms in the kernel, {sums['plain_ms']:.3f} ms "
              f"in the formulation of ops/winograd.py, {sums['library_ms']:.3f} "
              f"ms in cuDNN's convolutions and a bound of "
              f"{sums['bound_ms']:.3f} ms", flush=True)
    return shapes


# (label, (B, C, H, W), SiLU, time bias, eps) of the GroupNorm kernel's
# shapes: SD1.5's UNet at batch 16 (a resblock's norm2 with the time bias, an
# up resblock's norm1 over a skip concatenation, the 8 x 8 concatenation),
# SDXL's Transformer2D norm at batch 8, the VAE decoder's widest norms at
# 512 px batch 8 and at 1024 px batch 4
GN_SHAPES = (("sd15 resblock norm2", (16, 320, 64, 64), True, True, 1e-5),
             ("sd15 up norm1", (16, 960, 64, 64), True, False, 1e-5),
             ("sdxl Transformer2D", (8, 640, 128, 128), False, False, 1e-6),
             ("vae 512 px", (8, 256, 512, 512), True, False, 1e-6),
             ("vae 1024 px", (4, 128, 1024, 1024), True, False, 1e-6),
             ("sd15 up norm1 8x8", (16, 2560, 8, 8), True, True, 1e-5))


def check_group_norm(gen: torch.Generator, groups: int = 32) -> list:
    """Phase 2h: the GroupNorm kernel (ops/group_norm_nhwc.py) at GN_SHAPES
    against its plain version (the same bf16 input, f32 statistics, one
    rounding), on inputs whose channel means are large against their spread
    (what a SiLU leaves). Both are held to the exact f32 result: the kernel
    within FLOOR_FACTOR x the plain version's own distance (its bf16
    rounding), bit-equal on a repeat, and a sample alone equal to the same
    sample in the batch. Returns the rows."""
    from diffusion_models_moe_tpu_torch.ops import group_norm_nhwc as gnm
    dev, bf16, cl = DEV, torch.bfloat16, torch.channels_last
    shapes = []
    for label, (b, c, h, w), silu, with_bias, eps in GN_SHAPES:
        mu = 2.0 + torch.randn((1, c, 1, 1), generator=gen, device=dev)
        x = (mu + 0.5 * torch.randn((b, c, h, w), generator=gen, device=dev)
             ).to(bf16).contiguous(memory_format=cl)
        del mu
        gamma = 1 + 0.1 * torch.randn((c,), generator=gen, device=dev)
        beta = 0.1 * torch.randn((c,), generator=gen, device=dev)
        bias = (torch.randn((b, c), generator=gen, device=dev).to(bf16)
                if with_bias else None)

        def norm(uk, xs=x, bs=bias):
            return gnm.group_norm_nhwc(xs, gamma, beta, groups, eps,
                                       silu=silu, bias=bs, use_kernels=uk)

        y = norm(True)
        torch.cuda.synchronize()
        check(y.is_contiguous(memory_format=cl),
              "group norm output not channels-last")
        same = torch.equal(y, norm(True))
        alone = torch.equal(y[:1], norm(True, x[:1], None if bias is None
                                        else bias[:1]))
        xb = x if bias is None else x + bias[:, :, None, None]
        exact = F.group_norm(xb.float(), groups, gamma, beta, eps)
        del xb
        if silu:
            exact = F.silu(exact)
        y_plain = norm(False)
        _, rel = rel_err(y, y_plain)
        _, err = rel_err(y, exact)
        _, floor = rel_err(y_plain, exact)
        del y, y_plain, exact
        check(err <= FLOOR_FACTOR * floor,
              f"group norm {label}: rel err {err} > {FLOOR_FACTOR} x floor "
              f"{floor}")
        check(same and alone, f"group norm {label}: bit-equal on a repeat "
              f"{same}, sample alone {alone}")
        iters = 5 if b * c * h * w > 2 ** 28 else 20
        ms = graph_ms(lambda: norm(True), iters)
        plain_ms = graph_ms(lambda: norm(False), iters)
        n = b * c * h * w
        bd = bound(0, 4 * n)               # one read of x, one write of y
        design_ms = 6 * n / PEAK_BYTES * 1e3
        plan = gnm.gn_plan(h * w, c, groups)
        print(f"group norm {label} {(b, c, h, w)} silu={silu} "
              f"bias={with_bias}: rel err {err:.3e} against f32 (floor "
              f"{floor:.3e}), {rel:.3e} against plain; bit-equal on a repeat "
              f"and alone; kernel {ms:.4f} ms (graph), plain {plain_ms:.4f} "
              f"ms, bound {bd['bound_ms']:.4f} ms at 4 B an element, "
              f"{design_ms:.4f} ms at 6 B; {b * plan.tiles} blocks of "
              f"{plan.rows * c // 8} threads ({plan.pixels} pixels a tile)",
              flush=True)
        shapes.append(dict(shape=f"{label}: {(b, c, h, w)}", silu=silu,
                           bias=with_bias, rel_err=err, floor=floor,
                           rel_err_vs_plain=rel, ms=ms, plain_ms=plain_ms,
                           design_bound_ms=design_ms, library_ms=None,
                           max_abs_err=None, **bd))
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


def norm_calls(pipe, unet_calls: int, decodes: int = 1) -> int:
    """GroupNorm calls of `unet_calls` UNet calls and `decodes` VAE decodes
    of `pipe` (each GroupNorm of the UNet and of the decoder runs once a
    call; a pipeline without a UNet has none there): what the GroupNorm
    kernel launches, or on a path it does not take, its plain version."""
    def norms(module):
        return sum(isinstance(m, torch.nn.GroupNorm) for m in module.modules())
    unet = getattr(pipe, "unet", None)
    return ((norms(unet) * unet_calls if unet is not None else 0)
            + norms(pipe.vae_decoder) * decodes)


def check_no_plain(launches: dict, what: str) -> None:
    """On a bf16 path of SD1.5 or SD2.1 every call the kernels could take
    went to them: the model handed none to a plain version."""
    from diffusion_models_moe_tpu_torch.ops import _build
    plain = {k: launches[k] for k in _build.PLAIN if launches[k]}
    check(not plain, f"{what}: calls handed to plain versions: {plain}")


def kernels_vs_plain(pipe, pipe32, ctx, ctx32, lat, steps: int, g: float,
                     ivs, what: str, kw32=None, denoise=None,
                     **kw) -> tuple[float, float, torch.Tensor]:
    """`denoise` from the same latents with the kernels and with their plain
    versions, and the bf16-vs-f32 floor of this card: the same denoise with
    the plain versions in the f32 copy `pipe32` of the model. Holds the
    kernels' latents within FLOOR_FACTOR x the floor; returns (rel, floor,
    the kernels' latents). `kw` goes to every denoise (LCM's step noise),
    `kw32` in its place to the f32 copy's where given (SDXL's added
    conditioning, made by each copy's own towers). `denoise(pipe, ctx, lat,
    steps, g, ivs, use_kernels, **kw)` replaces `pipe.denoise` where given
    (SLD's loop)."""
    if denoise is None:
        def denoise(p, c, z, n, g_, ivs_, uk, **kw_):
            return p.denoise(c, z, n, g_, ivs=ivs_, use_kernels=uk, **kw_)[0]
    z_k = denoise(pipe, ctx, lat, steps, g, ivs, True, **kw)
    z_p = denoise(pipe, ctx, lat, steps, g, ivs, False, **kw)
    z_32 = denoise(pipe32, ctx32, lat, steps, g, ivs, False,
                   **(kw if kw32 is None else kw32))
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
    floors = {}
    for steps in (3, cfg.num_inference_steps):
        rel, floors[steps] = compare(ivs, steps, "MoE on 16 FFs")
    # `rel` of the last pass: the config's full step count
    check(rel < LATENT_REL_TOL,
          f"{steps} steps: latent rel err {rel} >= {LATENT_REL_TOL}")
    return compare, dict(ctx=ctx, lat=lat, z_k=kept["z_k"],
                         floor=floors[steps], floor_3=floors[3],
                         pipe32=pipe32)


def run_off_kernels(pipe32, cond, uncond, card: str) -> dict:
    """Phase 4b: where the kernels' predicates say no, `generate` runs on the
    card through the plain versions: the f32 SD1.5 pipeline of phase 4 (3
    PNDM steps, 512x512) and a `tiny_config` pipeline (head dims 8 to 32, f32)
    at its 4 steps. No kernel launches; every attention and FF call is
    counted as a plain call, and so is every GroupNorm."""
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
        norms = norm_calls(pipe, calls // 16)
        check(launches["plain:group_norm_nhwc"] == norms,
              f"{what}: plain:group_norm_nhwc "
              f"{launches['plain:group_norm_nhwc']}, expected {norms}")
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
    t-test's neuron masks, and a neuron-erased generate of 2 requests.
    Returns the launch counts and the neuron-removal interventions."""
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
    removal = neuron_removal_interventions(masks, device=DEV)
    erased = merge(ivs, removal, ("neuron_mask", "neuron_fill"))
    cond = tok(ADJ).to(DEV)
    _, gen_launches = timed_generate(
        pipe, f"neuron erasure on {card}", cond, torch.zeros_like(cond),
        seed=5, ivs=erased,
        expect={"fused_route_multiply": 16 * calls, "geglu_ff_fused": 0})
    compare(erased, cfg.num_inference_steps, "skilled neurons removed, MoE")
    return launches, removal


# ---------------------------------------------------------------- phase 6
def run_wanda(pipe, ivs, images_before, card: str) -> tuple:
    """Phase 6: Wanda masks on the prompt pairs, a generate erasing with
    them under MoE routing, and their union baked into the weights. Returns
    the launch counts and two static (D, H) mask sets (phase 18)."""
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
    # two static mask sets for phase 18's concept routing: the union over
    # timesteps baked above and the last Wanda step's masks
    return launches, {"wanda_union": static,
                      "wanda_last_step": {l: m[-1] for l, m in masks.items()}}


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
          f"topk 0.3 on {sum(iv is not None for iv in ivs)} FFs: wall "
          f"{wall:.3f} s, {len(images) / wall:.4f} "
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
    return {name: (rows, call_sums(rows, counts)) for name, rows, counts in (
        ("geglu_ff_fused", ff, LEVEL_BLOCKS),
        ("sd_self_attention", self_attn, LEVEL_BLOCKS),
        ("sd_cross_attention", cross_attn, LEVEL_BLOCKS),
        ("ln_qkv_fused", ln_qkv, LEVEL_BLOCKS),
        ("attn_out_residual_fused", attn_out, LEVEL_BLOCKS),
        ("conv3x3_chain", chain, CONV_COUNTS))}


def call_sums(rows: list, counts: tuple) -> dict:
    """A kernel's times, bound, plain version and yardstick summed over the
    calls one UNet call (or VAE decode) makes at each shape."""
    sums = {k: per_call(rows, counts, k)
            for k in ("ms", "bound_ms", "plain_ms")}
    for k in ("library_ms", "cublas_products_ms", "cublas_product_ms"):
        if rows[0].get(k) is not None:
            sums[k] = per_call(rows, counts, k)
    return sums


# ---------------------------------------------------------------- phase 2f
def check_sdxl_kernels(gen: torch.Generator) -> tuple[dict, dict]:
    """Phase 2f: kernels 1, 2, 3, 5, 6, 7 and 8 against their plain versions
    at every SDXL shape of their kind (UNet batch 2 x BATCH, 128 x 128
    latents, heads of 64, 4096 and 1024 tokens, FFs of 16 384 and 4096 rows
    at E = 128 and 256; kernel 8 also the VAE decoder at 1024 px), with the
    same times, bounds and yardsticks as at SD1.5, kernel 1's row agreement
    held to what its decision limit implies at E; and kernel 8 at
    SD2.1-768's UNet convs and 768-px decode. Returns ({kernel: (rows, sums
    over one SDXL UNet call)}, {"sd21": kernel 8's SD2.1 rows and sums})."""
    label = "SDXL"
    ff, _ = check_ff(gen, SDXL_ATTN, label, row_limit=implied_row_agreement,
                     counts=SDXL_BLOCKS)
    self_attn, cross_attn = check_attention(gen, SDXL_ATTN, (), label,
                                            SDXL_BLOCKS)
    ln_qkv, attn_out = check_absorb(gen, SDXL_ATTN, label, SDXL_BLOCKS)
    chain = check_chain(gen, SDXL_CONV_SHAPES, label, SDXL_CONV_COUNTS,
                        SDXL_RESNETS)
    out = {name: (rows, call_sums(rows, counts)) for name, rows, counts in (
        ("geglu_ff_fused", ff, SDXL_BLOCKS),
        ("sd_self_attention", self_attn, SDXL_BLOCKS),
        ("sd_cross_attention", cross_attn, SDXL_BLOCKS),
        ("ln_qkv_fused", ln_qkv, SDXL_BLOCKS),
        ("attn_out_residual_fused", attn_out, SDXL_BLOCKS),
        ("conv3x3_chain", chain, SDXL_CONV_COUNTS))}
    wino = {}
    for what, unet, vae in (("SDXL", WINO_SDXL_UNET, WINO_SDXL_VAE),
                            ("SD2.1-768", WINO_SD21_UNET, WINO_SD21_VAE)):
        rows = check_winograd(gen, unet, vae,
                              (sum(n for _, n in unet), sum(n for _, n in vae)),
                              what)
        wino[what] = dict(
            rows=rows,
            unet_call=call_sums(rows[:len(unet)], tuple(n for _, n in unet)),
            vae_decode=call_sums(rows[len(unet):], tuple(n for _, n in vae)))
    out["winograd3x3_fused"] = (wino["SDXL"]["rows"],
                                wino["SDXL"]["unet_call"])
    return out, dict(sdxl_vae=wino["SDXL"]["vae_decode"], sd21=wino["SD2.1-768"])


# ---------------------------------------------------------------- phase 2g
def check_pixart_kernels(gen: torch.Generator) -> dict:
    """Phase 2g: kernels 2 and 3 against their plain versions at PixArt-512's
    shapes (DiT batch 2 x BATCH, 1024 tokens, 16 heads of 72, T5's 120 keys)
    and at ragged D = 72 cases, with the same times, bounds and yardsticks
    as at SD1.5 and their sums over one DiT call. Returns {kernel: (rows,
    sums over one DiT call)}."""
    self_attn, cross_attn = check_attention(gen, PIXART_ATTN,
                                            ATTN_EXTRA_PIXART, "PixArt-512",
                                            PIXART_BLOCKS, T5_KEYS)
    return {name: (rows, call_sums(rows, PIXART_BLOCKS)) for name, rows in (
        ("sd_self_attention", self_attn), ("sd_cross_attention", cross_attn))}


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


# ---------------------------------------------------------------- phase 12
# PNDM steps of phase 12's generates: 11 UNet calls reach every level,
# routing and kernel of the routed path; the config's 50 would add a minute
SNAPSHOT_STEPS = 10
SNAPSHOT_PROMPTS = ["a photo of a dog", "a house in the style of Van Gogh"]
EXPERT_SIZE = 20
BAKE_SHARE = 0.05          # share of each layer's gate neurons baked away


def vae_encoder_shapes(cfg) -> dict:
    """Key -> shape of the encoder side of a diffusers AutoencoderKL
    (`encoder.*`, `quant_conv.*`), which a real snapshot holds and the port
    has no module for."""
    shapes = {}
    ch, wide = cfg.block_out_channels, 2 * cfg.latent_channels

    def conv(p, o, i, k):
        shapes[f"{p}.weight"], shapes[f"{p}.bias"] = (o, i, k, k), (o,)

    def norm(p, c):
        shapes[f"{p}.weight"], shapes[f"{p}.bias"] = (c,), (c,)

    def resnet(p, i, o):
        norm(f"{p}.norm1", i)
        conv(f"{p}.conv1", o, i, 3)
        norm(f"{p}.norm2", o)
        conv(f"{p}.conv2", o, o, 3)
        if i != o:
            conv(f"{p}.conv_shortcut", o, i, 1)

    conv("encoder.conv_in", ch[0], cfg.in_channels, 3)
    c_in = ch[0]
    for i, c in enumerate(ch):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", c_in if j == 0 else c, c)
        c_in = c
        if i < len(ch) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", c, c, 3)
    for j in range(2):
        resnet(f"encoder.mid_block.resnets.{j}", ch[-1], ch[-1])
    a = "encoder.mid_block.attentions.0"
    norm(f"{a}.group_norm", ch[-1])
    for proj in ("to_q", "to_k", "to_v", "to_out.0"):
        shapes[f"{a}.{proj}.weight"] = (ch[-1], ch[-1])
        shapes[f"{a}.{proj}.bias"] = (ch[-1],)
    norm("encoder.conv_norm_out", ch[-1])
    conv("encoder.conv_out", wide, ch[-1], 3)
    conv("quant_conv", wide, wide, 1)
    return shapes


def write_tokenizer(path: str, vocab_size: int) -> None:
    """A byte-level CLIP vocabulary of `vocab_size` ids in CLIP's layout:
    the 256 byte symbols, the same with </w>, one two-symbol token per
    merge (seeded), then <|startoftext|> and <|endoftext|>."""
    from diffusion_models_moe_tpu_torch.data.tokenizer import _bytes_to_unicode
    symbols = list(_bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(symbols + [s + "</w>" for s in symbols])}
    pairs = [(a, b + end) for end in ("", "</w>") for a in symbols
             for b in symbols]
    order = np.random.RandomState(0).permutation(len(pairs))
    merges = [pairs[i] for i in order[:vocab_size - len(vocab) - 2]]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                   "pad_token": "<|endoftext|>", "unk_token": "<|endoftext|>"}, f)


def write_snapshot(pipe, root: str, dtype=torch.float32) -> int:
    """`pipe`'s weights as a diffusers SD1.5 snapshot in `dtype` (f32 by
    default) under `root`: unet/, text_encoder/ (`text_model.` keys and the
    `position_ids` buffer), vae/ (the decoder and a seeded encoder side),
    tokenizer/. Returns the bytes written."""
    from diffusion_models_moe_tpu_torch.weights.export import save_safetensors
    cfg = pipe.config
    gen = torch.Generator().manual_seed(12)
    vae = {k: v.to(dtype) for k, v in pipe.vae_decoder.state_dict().items()}
    for k, shape in vae_encoder_shapes(cfg.vae).items():
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        vae[k] = (torch.randn(shape, generator=gen) * fan_in ** -0.5).to(dtype)
    text = {k: v.to(dtype) for k, v in pipe.text_encoder.state_dict().items()}
    text["text_model.embeddings.position_ids"] = torch.arange(
        cfg.text_encoder.max_length)[None]
    for sub, name, sd in (
            ("unet", "diffusion_pytorch_model",
             {k: v.to(dtype) for k, v in pipe.unet.state_dict().items()}),
            ("text_encoder", "model", text),
            ("vae", "diffusion_pytorch_model", vae)):
        save_safetensors(sd, os.path.join(root, sub, f"{name}.safetensors"))
    write_tokenizer(os.path.join(root, "tokenizer"),
                    cfg.text_encoder.vocab_size)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def routed_latents(pipe, ivs, cond, uncond) -> tuple:
    """A SNAPSHOT_STEPS-step routed generate of the two seeded requests,
    undecoded, with the kernels' launch counts over it: (latents, launches,
    wall s)."""
    from diffusion_models_moe_tpu_torch.ops import _build
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    z, _ = pipe.generate(cond, uncond, seeds=[0, 1], num_steps=SNAPSHOT_STEPS,
                         ivs=ivs, decode=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(bool(torch.isfinite(z).all()), "phase 12: non-finite latents")
    return z, dict(_build.LAUNCHES), wall


def run_snapshot_flow(card: str) -> dict:
    """Phase 12: the seeded SD1.5 weights written as a diffusers snapshot,
    read into a fresh pipeline, every gate clustered on the card into
    EXPERT_SIZE-neuron experts, a routed generate on those labels (bit-equal
    to the in-memory weights'), and a gate-masked UNet baked, written,
    validated, read back and served bit-equal to the in-memory bake.
    Returns the routed generate's launch counts."""
    import tempfile
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                build_moe_interventions,
                                                sd15_config)
    from diffusion_models_moe_tpu_torch.data.tokenizer import load_tokenizer
    from diffusion_models_moe_tpu_torch.erasure.masks import bake_gate_masks
    from diffusion_models_moe_tpu_torch.moefication.moefy import moefy_unet
    from diffusion_models_moe_tpu_torch.taps import layer_name
    from diffusion_models_moe_tpu_torch.weights.export import save_safetensors
    from diffusion_models_moe_tpu_torch.weights.port import (
        load_edited_unet_state_dict, load_pipeline_snapshot, unet_state_dict,
        validate_edited_unet)
    mem = seeded_pipeline()
    cfg = mem.config
    walls = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_snapshot_") as root:
        t0 = time.perf_counter()
        nbytes = write_snapshot(mem, root)
        walls["write"] = time.perf_counter() - t0
        print(f"snapshot: SD1.5 diffusers layout in f32 (unet, text_encoder "
              f"with position_ids, vae with its encoder side, tokenizer of "
              f"{cfg.text_encoder.vocab_size} ids): {nbytes} bytes written in "
              f"{walls['write']:.3f} s", flush=True)

        t0 = time.perf_counter()
        sds = load_pipeline_snapshot(root, cfg)
        pipe = StableDiffusionPipeline(sd15_config(torch.bfloat16), device=DEV)
        pipe.load_state_dicts(sds)
        tok = load_tokenizer(os.path.join(root, "tokenizer"),
                             cfg.text_encoder.max_length)
        torch.cuda.synchronize()
        walls["read"] = time.perf_counter() - t0
        check(tok.merge_loop == "native",
              f"phase 12: the tokenizer runs the {tok.merge_loop} merge loop")
        cond = tok(SNAPSHOT_PROMPTS).to(DEV)
        uncond = tok([""] * len(SNAPSHOT_PROMPTS)).to(DEV)
        check(tuple(cond.shape) == (2, cfg.text_encoder.max_length)
              and int(cond.max()) < cfg.text_encoder.vocab_size,
              f"phase 12: ids {tuple(cond.shape)}, largest {int(cond.max())}")
        print(f"snapshot read into a fresh sd15_config(bf16) pipeline and the "
              f"CLIP tokenizer ({tok.merge_loop} merges) in {walls['read']:.3f} "
              f"s; prompt ids {cond[:, :8].tolist()}", flush=True)

        t0 = time.perf_counter()
        labels = moefy_unet(pipe.unet.state_dict(), cfg.unet,
                            expert_size=EXPERT_SIZE, method="sinkhorn",
                            device=DEV)
        walls["moefy"] = time.perf_counter() - t0
        experts = []
        for i, d in enumerate(cfg.unet.ff_dims()):
            counts = np.bincount(labels[layer_name(i)])
            experts.append(len(counts))
            check(len(counts) == 4 * d // EXPERT_SIZE
                  and (counts == EXPERT_SIZE).all(),
                  f"phase 12: layer {i} clustered into {len(counts)} experts "
                  f"of {counts.min()}..{counts.max()} neurons")
        print(f"moefy_unet (Sinkhorn on the card) of all 16 gates into "
              f"{EXPERT_SIZE}-neuron experts in {walls['moefy']:.3f} s; "
              f"experts by layer {experts}", flush=True)

        ivs = build_moe_interventions(labels, 0.3, device=DEV,
                                      dtype=cfg.unet.dtype)
        z_disk, launches, walls["generate"] = routed_latents(pipe, ivs, cond,
                                                             uncond)
        calls = 16 * unet_calls(cfg, SNAPSHOT_STEPS)
        for name, count in (("geglu_ff_fused", calls),
                            ("sd_self_attention", calls),
                            ("sd_cross_attention", calls),
                            ("fused_route_multiply", 0)):
            check(launches[name] == count, f"phase 12: kernel {name} "
                  f"launched {launches[name]} times, expected {count}")
        check_no_plain(launches, "phase 12")
        z_mem, _, _ = routed_latents(mem, ivs, cond, uncond)
        same = torch.equal(z_disk, z_mem)
        print(f"routed generate on the snapshot's weights and labels: 2 "
              f"requests, {SNAPSHOT_STEPS} PNDM steps, top-k 0.3: wall "
              f"{walls['generate']:.3f} s; launches {launches}; latents "
              f"bit-equal to the in-memory weights': {same}", flush=True)
        check(same, "phase 12: the snapshot's latents differ from the "
              "in-memory weights'")

        t0 = time.perf_counter()
        rng = np.random.RandomState(12)
        masks = {i: rng.rand(4 * d) < BAKE_SHARE
                 for i, d in enumerate(cfg.unet.ff_dims())}
        baked = bake_gate_masks(pipe.unet.state_dict(), cfg.unet, masks)
        path = os.path.join(root, "baked", "unet.safetensors")
        save_safetensors(baked, path)
        walls["bake"] = time.perf_counter() - t0
        with open(os.path.join(ROOT, "tests", "fixtures",
                               "sd15_unet_keys.txt")) as f:
            keys = {line.strip() for line in f if line.strip()}
        report = validate_edited_unet(path, cfg.unet, expected_keys=keys)
        check(report.get("keys_ok") and report.get("shapes_ok"),
              f"phase 12: the baked checkpoint's census {report}")
        pipe.unet.load_state_dict(baked)
        z_bake_mem, _, _ = routed_latents(pipe, ivs, cond, uncond)
        del pipe, mem
        fresh = StableDiffusionPipeline(sd15_config(torch.bfloat16), device=DEV)
        fresh.load_state_dicts(dict(sds, unet=unet_state_dict(
            load_edited_unet_state_dict(path))))
        z_bake_disk, _, _ = routed_latents(fresh, ivs, cond, uncond)
        same_baked = torch.equal(z_bake_disk, z_bake_mem)
        moved = ((z_bake_mem - z_disk).norm() / z_disk.norm()).item()
        print(f"baked {sum(int(m.sum()) for m in masks.values())} gate neurons "
              f"({BAKE_SHARE} of each layer) and wrote the UNet "
              f"({os.path.getsize(path)} bytes) in {walls['bake']:.3f} s; "
              f"census keys_ok {report['keys_ok']} shapes_ok "
              f"{report['shapes_ok']} ({report['n_tensors']} tensors); the "
              f"bake moves the latents by {moved:.6f}; latents of the "
              f"checkpoint read back bit-equal to the in-memory bake's: "
              f"{same_baked}", flush=True)
        check(same_baked, "phase 12: the baked checkpoint serves other "
              "latents than the in-memory bake")
        del fresh, sds
    torch.cuda.empty_cache()
    print(f"phase 12 walls (s): {json.dumps(walls)} on {card}", flush=True)
    return launches


# ---------------------------------------------------------------- phase 13
SDXL_PROMPTS = ["a photo of a dog", "a house in the style of Van Gogh"]
# the longer of phase 13's two kernels-vs-plain runs: the config's 50 steps,
# as SD21_LONG_STEPS
SDXL_LONG_STEPS = 50


def sdxl_pipeline(dtype: torch.dtype, lcm: bool = False, **modes):
    """An SDXL pipeline (`sdxl_config`, LCM-SDXL with `lcm`) with seeded
    random weights."""
    from diffusion_models_moe_tpu_torch import SDXLPipeline, sdxl_config
    pipe = SDXLPipeline(sdxl_config(dtype, lcm=lcm, **modes), device=DEV)
    pipe.init_params(torch.Generator(device=DEV).manual_seed(0))
    return pipe


def sdxl_vs_plain(pipe, pipe32, cond, uncond, steps: int, g: float, ivs,
                  what: str, step_noise=None) -> tuple[float, float, tuple]:
    """`kernels_vs_plain` on an SDXL pipeline and its f32 copy: each copy's
    towers make its own context and added conditioning; the latents are
    N(0, 1) (seeded) times the scheduler's initial sigma at `steps`.
    Returns (rel, floor, (the kernels' latents, context, added conditioning,
    initial latents))."""
    ctx, add = pipe.conditioning(cond, uncond, g)
    ctx32, add32 = pipe32.conditioning(cond, uncond, g)
    s = pipe.config.sample_size
    scale = getattr(pipe.scheduler, "init_noise_sigma_for", None)
    scale = scale(steps) if scale else pipe.scheduler.init_noise_sigma
    lat = torch.randn((BATCH, 4, s, s), device=DEV,
                      generator=torch.Generator(device=DEV).manual_seed(4)
                      ) * scale
    kw = {} if step_noise is None else dict(step_noise=step_noise)
    rel, floor, z_k = kernels_vs_plain(
        pipe, pipe32, ctx, ctx32, lat, steps, g, ivs, what,
        kw32=dict(kw, added_cond=add32), added_cond=add, **kw)
    return rel, floor, (z_k, ctx, add, lat)


def run_sdxl(card: str) -> dict:
    """Phase 13: SDXL at full width (seeded random weights, MoE routing on
    all 70 FFs, the hash tokenizer): 2 requests at 1024 x 1024, Euler at the
    config's 50 steps with CFG 7.5; `denoise` latents with kernels against
    plain versions after 3 and SDXL_LONG_STEPS steps within the card's own
    SDXL bf16-vs-f32 floor; the same requests with the exact-tier modes on
    (kernels 5-7), their latents against the modes-off path within that
    floor; Sinkhorn clustering of the first gate of each width and a gate
    bake on the SDXL weights, timed; then
    LCM-SDXL (`sdxl_config(lcm=True)`, the JAX bench's `lcm-sdxl` point: 4
    steps, batch 2, the config's guidance through the embedding), timed, its
    latents on one injected step noise within its own floor, and a
    ServingEngine(batch_size=2) over it serving phase 7's 3 seeded requests.
    Returns the launch counts of each generate and of the engine."""
    from diffusion_models_moe_tpu_torch import SDXLPipeline, sdxl_config
    from diffusion_models_moe_tpu_torch import build_moe_interventions
    from diffusion_models_moe_tpu_torch.data.tokenize import hash_tokenize
    from diffusion_models_moe_tpu_torch.erasure.masks import bake_gate_masks
    from diffusion_models_moe_tpu_torch.models.layers import ResnetBlock2D
    from diffusion_models_moe_tpu_torch.moefication.cluster import \
        balanced_kmeans
    from diffusion_models_moe_tpu_torch.moefication.moefy import gate_weights
    from diffusion_models_moe_tpu_torch.ops.attn_absorb_fused import \
        attn_absorb_ok
    t0 = time.perf_counter()
    pipe = sdxl_pipeline(torch.bfloat16)
    cfg = pipe.config
    steps, g = cfg.num_inference_steps, cfg.guidance_scale
    calls = unet_calls(cfg, steps)
    dims = cfg.unet.ff_dims()
    ivs = build_moe_interventions(labels_for(dims), 0.3, device=DEV,
                                  dtype=cfg.unet.dtype)
    tcfg = cfg.text_encoder
    tok = hash_tokenize(tcfg.vocab_size, tcfg.max_length)
    cond = tok(SDXL_PROMPTS).to(DEV)
    uncond = tok([""]).repeat(BATCH, 1).to(DEV)
    torch.cuda.synchronize()
    n_params = {k: sum(p.numel() for p in m.parameters())
                for k, m in pipe.modules().items()}
    check(len(dims) == SDXL_FFS and sorted(set(dims)) == [640, 1280],
          f"SDXL FF widths {dims}")
    print(f"sdxl: SDXL bf16 pipeline built with seeded random weights in "
          f"{time.perf_counter() - t0:.1f} s ({cfg.sample_size}x"
          f"{cfg.sample_size} latents, {len(dims)} FFs, parameters "
          f"{json.dumps(n_params)})", flush=True)
    pipe.generate(cond, uncond, torch.Generator(device=DEV).manual_seed(2),
                  num_steps=1, ivs=ivs)                     # warm-up
    torch.cuda.synchronize()
    per_gen = SDXL_FFS * calls
    _, launches = timed_generate(
        pipe, f"SDXL on {card}", cond, uncond, seed=3, ivs=ivs,
        expect={"geglu_ff_fused": per_gen, "sd_self_attention": per_gen,
                "sd_cross_attention": per_gen, "fused_route_multiply": 0,
                "ln_qkv_fused": 0, "attn_out_residual_fused": 0,
                "conv3x3_chain": 0})
    pipe32 = sdxl_pipeline(torch.float32)
    for n in (3, SDXL_LONG_STEPS):
        _, floor, (z_k, ctx, add, lat) = sdxl_vs_plain(
            pipe, pipe32, cond, uncond, n, g, ivs,
            f"SDXL Euler, MoE on {SDXL_FFS} FFs")
    del pipe32
    torch.cuda.empty_cache()
    # the exact-tier modes on the same weights and requests
    pipe_on = SDXLPipeline(sdxl_config(torch.bfloat16, attn_absorb="1",
                                       conv_chain=True), device=DEV)
    pipe_on.load_state_dicts({k: m.state_dict()
                              for k, m in pipe.modules().items()})
    for tokens, c, heads in SDXL_ATTN:
        check(attn_absorb_ok(tokens, c, heads),
              f"attn_absorb_ok: S={tokens}, C={c}, {heads} heads")
    n_chain = sum(sum(m.chain_branches(32, 32))
                  for m in pipe_on.unet.modules()
                  if isinstance(m, ResnetBlock2D))
    check(n_chain == 2 * SDXL_RESNETS,
          f"{n_chain} chain convs of {2 * SDXL_RESNETS}")
    pipe_on.generate(cond, uncond, torch.Generator(device=DEV).manual_seed(2),
                     num_steps=1, ivs=ivs)                  # warm-up
    _, launches_on = timed_generate(
        pipe_on, f"SDXL, exact-tier modes on, on {card}", cond, uncond,
        seed=3, ivs=ivs,
        expect={"ln_qkv_fused": per_gen, "attn_out_residual_fused": per_gen,
                "conv3x3_chain": n_chain * calls, "geglu_ff_fused": per_gen,
                "sd_self_attention": per_gen, "sd_cross_attention": per_gen,
                "fused_route_multiply": 0})
    z_on, _ = pipe_on.denoise(ctx, lat, SDXL_LONG_STEPS, g, ivs=ivs,
                              added_cond=add)
    check(bool(torch.isfinite(z_on).all()), "SDXL modes on: non-finite latents")
    rel = ((z_on - z_k).norm() / z_k.norm()).item()
    print(f"denoise {SDXL_LONG_STEPS} steps, SDXL: latent rel err modes on vs "
          f"modes off (kernels, same weights, context and latents) "
          f"{rel:.6f}; floor (plain bf16 vs plain f32) {floor:.6f}",
          flush=True)
    check(rel <= FLOOR_FACTOR * floor,
          f"SDXL modes on vs off {rel} > {FLOOR_FACTOR} x floor {floor}")
    del pipe_on, z_on, z_k
    torch.cuda.empty_cache()
    # MoEfication and a bake on the SDXL weights: one gate of each width
    # clustered (all 70 took 92-173 s of host time, the script's largest
    # depth; moefy_unet itself runs over SD1.5's 16 gates in phases 12, 21)
    walls = {}
    t0 = time.perf_counter()
    gates = gate_weights(pipe.unet.state_dict(), cfg.unet)
    picked = [dims.index(640), dims.index(1280)]
    for i in picked:
        h = 4 * dims[i]
        counts = np.bincount(balanced_kmeans(
            gates[i], h // EXPERT_SIZE, method="sinkhorn", device=DEV))
        check(len(counts) == h // EXPERT_SIZE
              and (counts == EXPERT_SIZE).all(),
              f"SDXL layer {i} clustered into {len(counts)} experts of "
              f"{counts.min()}..{counts.max()} neurons")
    del gates
    walls["moefy"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rng = np.random.RandomState(13)
    masks = {i: rng.rand(4 * d) < BAKE_SHARE for i, d in enumerate(dims)}
    baked = bake_gate_masks(pipe.unet.state_dict(), cfg.unet, masks)
    torch.cuda.synchronize()
    walls["bake"] = time.perf_counter() - t0
    print(f"SDXL MoEfication: Sinkhorn on the card of gates {picked} of "
          f"{len(dims)} (widths 640, 1280) into {EXPERT_SIZE}-neuron experts "
          f"in {walls['moefy']:.3f} s (128 and 256 experts, every one "
          f"{EXPERT_SIZE} neurons); bake_gate_masks of "
          f"{sum(int(m.sum()) for m in masks.values())} gate neurons in "
          f"{walls['bake']:.3f} s", flush=True)
    del baked, pipe
    torch.cuda.empty_cache()
    # LCM-SDXL: the JAX bench's lcm-sdxl point
    pipe = sdxl_pipeline(torch.bfloat16, lcm=True)
    cfg = pipe.config
    steps, g = cfg.num_inference_steps, cfg.guidance_scale
    per_gen = SDXL_FFS * steps
    pipe.generate(cond, uncond, torch.Generator(device=DEV).manual_seed(2),
                  num_steps=1, ivs=ivs)                     # warm-up
    torch.cuda.synchronize()
    _, launches_lcm = timed_generate(
        pipe, f"LCM-SDXL on {card}", cond, uncond, seed=3, ivs=ivs,
        expect={"geglu_ff_fused": per_gen, "sd_self_attention": per_gen,
                "sd_cross_attention": per_gen, "fused_route_multiply": 0})
    pipe32 = sdxl_pipeline(torch.float32, lcm=True)
    s = cfg.sample_size
    noise = torch.randn((steps, BATCH, 4, s, s), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(6))
    sdxl_vs_plain(pipe, pipe32, cond, uncond, steps, g, ivs,
                  f"LCM-SDXL, MoE on {SDXL_FFS} FFs", step_noise=noise)
    del pipe32
    torch.cuda.empty_cache()
    launches_engine = serve(
        pipe, ivs, f"serving, LCM-SDXL, {card}",
        {"geglu_ff_fused": per_gen, "sd_self_attention": per_gen,
         "sd_cross_attention": per_gen, "fused_route_multiply": 0},
        num_steps=steps, guidance_scale=g)
    del pipe
    torch.cuda.empty_cache()
    print(f"phase 13 walls (s): {json.dumps(walls)} on {card}", flush=True)
    return dict(serving=launches, modes_on=launches_on, lcm=launches_lcm,
                lcm_engine=launches_engine)


# ---------------------------------------------------------------- phase 14
SLD_PROMPTS = ["a photo of a dog", "a house in the style of Van Gogh"]


def run_sld(ivs, card: str) -> dict:
    """Phase 14: Safe Latent Diffusion on SD1.5 (phase 3's seeded weights
    and labels, the safety concept through the hash tokenizer): a 2-request
    `sld_generate` with PNDM at 50 steps, CFG 7.5 and `SLDConfig.medium()`
    (UNet batch 3 x BATCH), timed, with kernels 1-3 at 16 launches a UNet
    call; `sld_denoise` latents with kernels against plain versions within
    the card's floor after 3 steps of `SLDConfig.max()` (warm-up 0: the
    safety term acts from the first step) and 50 of `medium()`; and the
    50-step SLD latents apart from the unguided (CFG only) latents on the
    same noise by more than that floor allows. Returns the launch counts
    of the generate."""
    from diffusion_models_moe_tpu_torch import (SAFETY_CONCEPT, SLDConfig,
                                                StableDiffusionPipeline,
                                                sd15_config, sld_generate)
    from diffusion_models_moe_tpu_torch.data.tokenize import hash_tokenize
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.pipelines.sld import sld_denoise
    pipe = seeded_pipeline()
    cfg = pipe.config
    steps, g = cfg.num_inference_steps, cfg.guidance_scale
    tcfg = cfg.text_encoder
    tok = hash_tokenize(tcfg.vocab_size, tcfg.max_length)
    cond = tok(SLD_PROMPTS).to(DEV)
    uncond = tok([""]).repeat(BATCH, 1).to(DEV)
    safety = tok([SAFETY_CONCEPT]).to(DEV)
    sld_generate(pipe, cond, uncond, safety,
                 torch.Generator(device=DEV).manual_seed(2), num_steps=1,
                 ivs=ivs)                                   # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    images = sld_generate(pipe, cond, uncond, safety,
                          torch.Generator(device=DEV).manual_seed(3),
                          sld=SLDConfig.medium(), ivs=ivs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    side = 8 * cfg.sample_size
    check(tuple(images.shape) == (BATCH, 3, side, side)
          and bool(torch.isfinite(images).all())
          and images.min().item() >= 0.0 and images.max().item() <= 1.0,
          f"SLD: images {tuple(images.shape)} not finite, misshapen or "
          "outside [0, 1]")
    calls = unet_calls(cfg, steps)
    per_gen = 16 * calls
    print(f"SLD on {card}: sld_generate {BATCH} requests {side}x{side}, "
          f"{cfg.scheduler} {steps} steps ({calls} UNet calls at batch "
          f"{3 * BATCH}: uncond, cond, safety), CFG {g}, SLDConfig.medium(), "
          f"MoE topk 0.3 on 16 FFs: wall {wall:.3f} s, {BATCH / wall:.4f} "
          f"img/s, peak memory {peak_gib:.2f} GiB; launches {launches}",
          flush=True)
    for name, count in (("geglu_ff_fused", per_gen),
                        ("sd_self_attention", per_gen),
                        ("sd_cross_attention", per_gen),
                        ("fused_route_multiply", 0)):
        check(launches[name] == count, f"SLD: kernel {name} launched "
              f"{launches[name]} times, expected {count}")
    check_no_plain(launches, "SLD")
    pipe32 = StableDiffusionPipeline(sd15_config(torch.float32), device=DEV)
    pipe32.init_params(torch.Generator(device=DEV).manual_seed(0))
    safety_b = safety.expand(BATCH, -1)
    ctx3, ctx3_32 = (torch.cat([p.encode_text(ids)[0]
                                for ids in (uncond, cond, safety_b)])
                     for p in (pipe, pipe32))
    lat = torch.randn((BATCH, 4, cfg.sample_size, cfg.sample_size),
                      generator=torch.Generator(device=DEV).manual_seed(4),
                      device=DEV) * pipe.scheduler.init_noise_sigma
    for n, name in ((3, "max"), (steps, "medium")):
        sld = getattr(SLDConfig, name)()

        def denoise(p, c, z, n_, g_, ivs_, uk, sld=sld):
            return sld_denoise(p, c, z, n_, g_, sld, ivs=ivs_, use_kernels=uk)

        _, floor, z_sld = kernels_vs_plain(
            pipe, pipe32, ctx3, ctx3_32, lat, n, g, ivs,
            f"SLD {name}(), MoE on 16 FFs", denoise=denoise)
    del pipe32
    z_cfg, _ = pipe.denoise(ctx3[:2 * BATCH], lat, steps, g, ivs=ivs)
    moved = ((z_sld - z_cfg).norm() / z_cfg.norm()).item()
    print(f"denoise {steps} steps: SLD medium() against CFG alone on the same "
          f"weights, noise and prompts (kernels): latent rel diff {moved:.6f}; "
          f"floor (plain bf16 vs plain f32) {floor:.6f}", flush=True)
    check(moved > FLOOR_FACTOR * floor,
          f"SLD moves the latents by {moved}, within {FLOOR_FACTOR} x the "
          f"floor {floor}")
    del pipe
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 15
# caption tokens of PixArt's two requests (the rest of the 120 are pads,
# masked in T5); the negative caption is T5's empty prompt, its EOS alone
# two PixArt captions, tokenized by the port's T5 tokenizer on a synthetic
# T5-sized Unigram vocabulary (no real T5 tokenizer.json is in the
# repository); the negative caption is "", which is </s> alone
PIXART_CAPTIONS = (
    "A small cactus with a happy face in the Sahara desert.",
    "An astronaut riding a green horse across a misty meadow at dawn, "
    "cinematic lighting, highly detailed, 8k, ultra-wide shot, trending on "
    "artstation, soft  focus,\u00a0golden hour")
T5_PIECES = 32100           # T5 v1.1's tokenizer: 32 000 pieces, 100 extra ids
T5_EXTRA_IDS = 100
T5_EOS = 1
# the charsmap's entries: NBSP -> space, full-width Latin -> ASCII, ligatures
T5_CHARSMAP = {"\u00a0": " ", "\ufb01": "fi", "\ufb02": "fl",
               **{chr(0xFF21 + i): chr(0x41 + i) for i in range(26)},
               **{chr(0xFF41 + i): chr(0x61 + i) for i in range(26)}}
# the removal window of the reference's PixArt erasure (steps t <= 5) and the
# share of each layer's neurons it removes, the highest mean gates: the JAX
# CLI's skill ratio, as WANDA_SKILL_RATIO
PIXART_REMOVAL_STEPS = 6
PIXART_REMOVAL_SHARE = WANDA_SKILL_RATIO


def darts_charsmap(mapping: dict) -> bytes:
    """A sentencepiece precompiled charsmap: uint32 trie size in bytes, a
    Darts double array over the keys' UTF-8 bytes (each node at a base of
    its own, the array long enough for any byte from any base), then the
    NUL-terminated replacement strings."""
    import struct
    blob, values = bytearray(), {}
    for src in sorted(mapping):
        values[src] = len(blob)
        blob += mapping[src].encode() + b"\0"
    root: dict = {}
    for src in mapping:
        node = root
        for b in src.encode():
            node = node.setdefault(b, {})
        node[None] = values[src]
    units, bases, queue = {0: 0}, set(), [(0, root)]
    while queue:
        pos, node = queue.pop(0)
        labels = [0 if k is None else k for k in node]
        base = 1
        while base in bases or any((base ^ l) in units or base ^ l == 0
                                   for l in labels):
            base += 1
        bases.add(base)
        units[pos] |= ((pos ^ base) << 10) | ((None in node) << 8)
        for k, child in node.items():
            if k is None:
                units[base] = (1 << 31) | child
            else:
                units[base ^ k] = k
                queue.append((base ^ k, child))
    size = max(max(units), max(b | 0xFF for b in bases)) + 1
    trie = b"".join(struct.pack("<I", units.get(i, 0)) for i in range(size))
    return struct.pack("<I", len(trie)) + trie + bytes(blob)


def write_t5_tokenizer(path: str) -> None:
    """A T5-layout `tokenizer.json` of T5_PIECES pieces: <pad>, </s>, <unk>,
    every printable ASCII character, the captions' words with and without
    the word mark and their prefixes, seeded lowercase pieces to fill, then
    <extra_id_99> .. <extra_id_0>; seeded scores; T5's pipeline (the
    charsmap of T5_CHARSMAP, " {2,}" -> " ", Metaspace, $A </s>)."""
    import base64
    rng = np.random.RandomState(0)
    pieces = dict.fromkeys(["\u2581"] + [chr(c) for c in range(33, 127)])
    for caption in PIXART_CAPTIONS:
        for w in caption.lower().replace(",", " ").split():
            for piece in ("\u2581" + w, w):
                for n in range(2, len(piece) + 1):
                    pieces[piece[:n]] = None
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    n_regular = T5_PIECES - 3 - T5_EXTRA_IDS
    while len(pieces) < n_regular:
        w = "".join(rng.choice(letters, rng.randint(2, 8)))
        pieces["\u2581" + w if rng.rand() < 0.5 else w] = None
    scores = rng.uniform(-14.0, -2.0, n_regular)
    specials = ["<pad>", "</s>", "<unk>"]
    extra = [f"<extra_id_{i}>" for i in reversed(range(T5_EXTRA_IDS))]
    vocab = ([[p, 0.0] for p in specials]
             + [[p, float(sc)] for p, sc in zip(pieces, scores)]
             + [[p, 0.0] for p in extra])
    added = [{"id": i, "content": p, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, (p, _) in enumerate(vocab) if p in specials or p in extra]
    charsmap = base64.b64encode(darts_charsmap(T5_CHARSMAP)).decode("ascii")
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": charsmap},
            {"type": "Replace", "pattern": {"Regex": " {2,}"},
             "content": " "}]},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "\u2581",
                          "prepend_scheme": "always", "split": True},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [], "special_tokens": {"</s>": {
                "id": "</s>", "ids": [T5_EOS], "tokens": ["</s>"]}}},
        "decoder": None,
        "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab,
                  "byte_fallback": False},
    }
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)


def pixart_requests(cfg) -> tuple:
    """The captions' ids and masks (BATCH, 120) and the negative caption's,
    from the port's T5 tokenizer (`load_t5_tokenizer`) on the vocabulary of
    `write_t5_tokenizer`, written to a temporary directory; also the
    captions' valid lengths and the tokenize wall."""
    import tempfile
    from diffusion_models_moe_tpu_torch.data.tokenizer import \
        load_t5_tokenizer
    tc = cfg.text_encoder
    with tempfile.TemporaryDirectory(prefix="chip_smoke_t5_") as root:
        write_t5_tokenizer(root)
        t0 = time.perf_counter()
        tokenize = load_t5_tokenizer(root, tc.max_length)
        ids, mask = tokenize(list(PIXART_CAPTIONS))
        un_ids, un_mask = tokenize([""] * BATCH)
        wall = time.perf_counter() - t0
    lengths = mask.sum(1).tolist()
    check(tuple(ids.shape) == (BATCH, tc.max_length),
          f"T5 ids of shape {tuple(ids.shape)}")
    for i, n in enumerate(lengths):
        check(0 < n < tc.max_length and ids[i, n - 1].item() == T5_EOS
              and bool((ids[i, n:] == 0).all())
              and bool((ids[i, :n - 1] != 2).all()),
              f"T5 caption {i}: {n} tokens, ids {ids[i, :n].tolist()}")
    check(un_mask.sum(1).tolist() == [1] * BATCH
          and bool((un_ids[:, 0] == T5_EOS).all()),
          f"the negative caption's ids {un_ids[:, :2].tolist()}")
    return (tuple(t.to(DEV, torch.long) for t in (ids, mask, un_ids, un_mask)),
            lengths, wall)


def run_pixart(card: str) -> dict:
    """Phase 15: PixArt-alpha at full width (`pixart_512_config(bf16)`:
    PixArt-XL-2-512's DiT, 28 blocks of 16 heads of 72; T5 v1.1 XXL; seeded
    random weights; 2 requests of seeded caption ids with masks, some pads),
    DPM-Solver++ 2M at 20 steps with CFG 4.5, decoded to 512 x 512: wall,
    img/s, peak memory, kernels 2 and 3 at 28 launches a DiT call, every
    other kernel and every plain counter at 0; `denoise` latents with
    kernels against plain versions after 3 and 20 steps within the card's
    own PixArt floor (plain bf16 against an f32 copy of the DiT on the same
    bf16 T5 features: an f32 T5 would take 19 GB); a mean-gate tapped
    generate (28 layers of (T, 4608)); a generate with the highest 2% of
    each layer's mean gates removed (fill 0.0) at steps t <= 5, its latents
    apart from the plain generate's by more than that floor; request 0 in a
    batch padded with itself bit-equal to request 0 co-batched. Returns the
    launch counts of the timed generate."""
    import copy
    from diffusion_models_moe_tpu_torch import (LayerIntervention,
                                                PixArtPipeline, TapSpec,
                                                pixart_512_config)
    from diffusion_models_moe_tpu_torch.models.layers import cast_model
    from diffusion_models_moe_tpu_torch.models.pixart import \
        PixArtTransformer2D
    from diffusion_models_moe_tpu_torch.ops import _build
    t0 = time.perf_counter()
    cfg = pixart_512_config(torch.bfloat16)
    pipe = PixArtPipeline(cfg, device=DEV)
    pipe.init_params(torch.Generator(device=DEV).manual_seed(0))
    steps, g = cfg.num_inference_steps, cfg.guidance_scale
    dit = cfg.transformer
    layers, hdim = dit.num_layers, dit.hidden_size * dit.ff_mult
    (ids, mask, un_ids, un_mask), lengths, tok_wall = pixart_requests(cfg)
    print(f"pixart: {BATCH} captions tokenized by the port's T5 tokenizer "
          f"(a {T5_PIECES}-piece Unigram tokenizer.json read without the "
          f"tokenizers package) in {tok_wall:.3f} s: {lengths} of "
          f"{cfg.text_encoder.max_length} positions tokens", flush=True)
    torch.cuda.synchronize()
    n_params = {k: sum(p.numel() for p in m.parameters())
                for k, m in pipe.modules().items()}
    print(f"pixart: PixArt-512 bf16 pipeline built on the card with seeded "
          f"random weights in {time.perf_counter() - t0:.1f} s (parameters "
          f"{json.dumps(n_params)}; heads of {dit.hidden_size // dit.num_heads}"
          f", {cfg.text_encoder.max_length} caption positions, "
          f"{lengths} of them tokens)", flush=True)

    def gen_(seed=None, cond=(ids, mask), **kw):
        generator = (None if seed is None
                     else torch.Generator(device=DEV).manual_seed(seed))
        return pipe.generate(cond[0], un_ids, generator, cond_mask=cond[1],
                             uncond_mask=un_mask, **kw)

    per_gen = layers * steps
    expect = {k: per_gen if k in ("sd_self_attention", "sd_cross_attention")
              else 0 for k in _build.KERNELS}

    def held(launches: dict, what: str, decodes: int = 1) -> None:
        expect["group_norm_nhwc"] = norm_calls(pipe, 0, decodes)
        for name, count in expect.items():
            check(launches[name] == count,
                  f"{what}: kernel {name} launched {launches[name]} times, "
                  f"expected {count}")
        check_no_plain(launches, what)

    gen_(2, num_steps=1)                                     # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    images, _ = gen_(3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    side = 8 * cfg.sample_size
    check(tuple(images.shape) == (BATCH, 3, side, side),
          f"PixArt image shape {tuple(images.shape)}")
    check(bool(torch.isfinite(images).all()), "PixArt: non-finite images")
    check(images.min().item() >= 0.0 and images.max().item() <= 1.0,
          "PixArt: image values outside [0, 1]")
    print(f"PixArt-512 on {card}: generate {BATCH} requests {side}x{side}, "
          f"{cfg.scheduler} {steps} steps ({steps} DiT calls at batch "
          f"{2 * BATCH}), CFG {g}: wall {wall:.3f} s, {BATCH / wall:.4f} "
          f"img/s, peak memory {peak_gib:.2f} GiB; images finite in "
          f"[{images.min().item():.4f}, {images.max().item():.4f}]; launches "
          f"{launches} (expected {expect})", flush=True)
    held(launches, "PixArt")
    del images

    # kernels against plain versions, and the floor: an f32 copy of the DiT
    with torch.device(DEV):
        dit32 = cast_model(PixArtTransformer2D(
            dataclasses.replace(dit, dtype=torch.float32), cfg.sample_size),
            torch.float32).eval()
    dit32.load_state_dict(pipe.transformer.state_dict())
    pipe32 = copy.copy(pipe)
    pipe32.transformer = dit32
    ctx = torch.cat([pipe.encode_text(un_ids, un_mask),
                     pipe.encode_text(ids, mask)])
    lat = torch.randn((BATCH, dit.sample_channels, cfg.sample_size,
                       cfg.sample_size), device=DEV,
                      generator=torch.Generator(device=DEV).manual_seed(4)
                      ) * pipe.scheduler.init_noise_sigma
    for n in (3, steps):
        _, floor, z_k = kernels_vs_plain(pipe, pipe32, ctx, ctx.float(), lat,
                                         n, g, None, "PixArt-512, DPM")
    del pipe32, dit32
    torch.cuda.empty_cache()

    # the mean-gate tap, then the removal of the highest mean gates
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    z_plain, taps = gen_(3, tap=TapSpec(mean_gate=True), decode=False)
    torch.cuda.synchronize()
    tap_wall = time.perf_counter() - t0
    mg = taps["mean_gate"]
    check(sorted(mg) == list(range(layers)), f"PixArt taps {sorted(mg)}")
    for i, v in mg.items():
        check(tuple(v.shape) == (steps, hdim) and bool(torch.isfinite(v).all()),
              f"PixArt mean gate {i}: {tuple(v.shape)}")
    held(_build.LAUNCHES, "PixArt, mean-gate taps", decodes=0)
    n_rm = int(PIXART_REMOVAL_SHARE * hdim)
    ivs = []
    for i in range(layers):
        top = mg[i][:PIXART_REMOVAL_STEPS].mean(0).topk(n_rm).indices
        nm = torch.zeros((steps, hdim), dtype=torch.bool, device=DEV)
        nm[:PIXART_REMOVAL_STEPS, top] = True
        ivs.append(LayerIntervention(neuron_mask=nm, neuron_fill=0.0))
    z_rm, _ = gen_(3, ivs=ivs, decode=False)
    moved = ((z_rm - z_plain).norm() / z_plain.norm()).item()
    print(f"PixArt mean-gate tapped generate: {layers} layers of {(steps, hdim)}"
          f", wall {tap_wall:.3f} s; removing the highest {n_rm} mean gates of"
          f" each layer at steps t < {PIXART_REMOVAL_STEPS} moves the latents "
          f"{moved:.6f} (floor {floor:.6f})", flush=True)
    check(moved > FLOOR_FACTOR * floor,
          f"PixArt removal moved the latents {moved} <= {FLOOR_FACTOR} x "
          f"floor {floor}")

    # request 0 padded with itself equals request 0 co-batched
    pad = lambda t: t[:1].repeat(BATCH, 1)  # noqa: E731
    z_co, _ = gen_(seeds=[7, 3], decode=False)
    z_alone, _ = gen_(cond=(pad(ids), pad(mask)), seeds=[7, 7], decode=False)
    check(torch.equal(z_co[0], z_alone[0]),
          "PixArt: request 0 alone differs from request 0 co-batched")
    print("PixArt: request 0 padded with itself equals request 0 co-batched, "
          "bit for bit", flush=True)
    del pipe
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 16
JUDGE_SEEDS = (31, 32)       # the two requests' seeds
# every judge on the card against the same module on the CPU, f32 on both
# (cuDNN's TF32 off for the judges' convolutions, matmuls in full f32):
# max |card - cpu| / max |cpu|, stated before the first run on the card
JUDGE_TOL = 1e-4
SSCD_DIAGONAL_TOL = 1e-5
CLIP_PROMPTS = ("a photo of a dog", "a photo of a house")
# the vision tower of openai/clip-vit-base-patch32, the reference's metric
# CLIP: 224 px in patches of 32, 12 layers of 768, 512 joint
CLIP_B32_VISION = dict(patch_size=32, hidden_size=768, intermediate_size=3072,
                       num_layers=12, num_heads=12, projection_dim=512)


def seed_judge(module, seed: int):
    """Seeded weights for a judge, drawn on its device in the CPU tests'
    scheme: kernels N(0, 2/fan_in), matrices N(0, 1/fan_in), 1-d weights
    and running variances U(0.5, 1.5), other vectors N(0, 0.1^2); LPIPS
    heads U(0, 1)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            rn = torch.randn(t.shape, generator=gen, device=DEV)
            if name.startswith("lins."):
                t.copy_(torch.rand(t.shape, generator=gen, device=DEV))
            elif name.endswith("running_var") or (
                    t.dim() == 1 and name.endswith("weight")):
                t.copy_(torch.rand(t.shape, generator=gen, device=DEV) + 0.5)
            elif t.dim() <= 1:
                t.copy_(0.1 * rn)
            else:
                gain = 2.0 if t.dim() == 4 else 1.0
                t.copy_(rn * (gain / t[0].numel()) ** 0.5)
    return module


def on_cpu(module, build):
    """The same judge on the CPU: `build(device="cpu")` with the card
    module's state dict."""
    cpu = build(device="cpu")
    cpu.load_state_dict(module.state_dict())
    return cpu


def judge_wall(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_judges(card: str) -> dict:
    """Phase 16: `checked_generate` over the moefied SD1.5 of phase 3 (its
    seeded weights and labels; 2 requests by their seeds, PNDM 50 steps, CFG
    7.5) with a CLIPNSFWChecker on a full-width CLIP ViT-L/14 vision tower
    (seeded, f32) and the unsafe concepts through the pipeline's CLIP-L text
    tower and a seeded 768 x 768 projection, its threshold between the two
    images' largest similarities: one image flagged and blurred, the other
    bit-equal to plain `generate`'s, kernels 1-3 at 16 launches a UNet call
    and no plain call. Then the judges of the two images at full width,
    each also on the CPU and held to JUDGE_TOL there: CLIP score and
    CLIP-IQA "quality" on CLIP ViT-B/32 towers, Inception-v3 pool features
    and FID against 2 seeded images (and the CLIP-feature FID), LPIPS
    (AlexNet) between the flagged image and its unblurred self, SSCD
    (ResNet-50 + GeM, 512-d) memorization scores of the images against
    themselves. Returns the launch counts of the checked generate."""
    import tempfile
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                build_moe_interventions,
                                                sd15_config)
    from diffusion_models_moe_tpu_torch.benchmarks.clip_iqa import ClipIQA
    from diffusion_models_moe_tpu_torch.benchmarks.clip_metrics import \
        clip_score
    from diffusion_models_moe_tpu_torch.benchmarks.fid import (
        fid_from_features, make_clip_featurizer, make_clip_text_featurizer,
        make_inception_featurizer)
    from diffusion_models_moe_tpu_torch.benchmarks.memorization import \
        memorization_scores
    from diffusion_models_moe_tpu_torch.data.tokenizer import load_tokenizer
    from diffusion_models_moe_tpu_torch.models.backbones import (
        LPIPS, SSCD, ResNetConfig, make_lpips_fn, preprocess_imagenet,
        sscd_embed)
    from diffusion_models_moe_tpu_torch.models.clip_text import \
        CLIPTextEncoder
    from diffusion_models_moe_tpu_torch.models.clip_vision import (
        CLIPVisionConfig, CLIPVisionEncoder, resize_for_clip)
    from diffusion_models_moe_tpu_torch.models.inception import InceptionV3
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import \
        blur_images
    from diffusion_models_moe_tpu_torch.safety import (
        CLIPNSFWChecker, checked_generate, unsafe_concept_embeddings)
    from diffusion_models_moe_tpu_torch.weights.port_vision import \
        clip_b32_text_config
    t0 = time.perf_counter()
    cfg = dataclasses.replace(sd15_config(torch.bfloat16), safety_check=True,
                              blur_nsfw=True)
    pipe = StableDiffusionPipeline(cfg, device=DEV)
    pipe.init_params(torch.Generator(device=DEV).manual_seed(0))
    ivs = build_moe_interventions(labels_for(cfg.unet.ff_dims()), 0.3,
                                  device=DEV, dtype=cfg.unet.dtype)
    tcfg = cfg.text_encoder
    cond = torch.randint(0, tcfg.vocab_size, (BATCH, tcfg.max_length),
                         generator=torch.Generator().manual_seed(1)).to(DEV)
    uncond = torch.zeros_like(cond)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_clip_") as root:
        write_tokenizer(root, tcfg.vocab_size)
        tok = load_tokenizer(root, tcfg.max_length)
    vit_l = seed_judge(CLIPVisionEncoder(CLIPVisionConfig(), device=DEV), 1)
    proj_l = torch.randn((tcfg.hidden_size, vit_l.cfg.projection_dim),
                         device=DEV, generator=torch.Generator(
                             device=DEV).manual_seed(2)) / tcfg.hidden_size ** 0.5
    concepts = unsafe_concept_embeddings(lambda ids: pipe.encode_text(ids)[0],
                                         tok, text_projection=proj_l)
    featurize_l = make_clip_featurizer(vit_l)
    torch.cuda.synchronize()
    print(f"judges: SD1.5 bf16 pipeline (safety_check, blur_nsfw), the "
          f"checker's CLIP ViT-L/14 ({sum(p.numel() for p in vit_l.parameters())}"
          f" parameters, f32) and {len(concepts)} concept embeddings built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    pipe.generate(cond, uncond, torch.Generator(device=DEV).manual_seed(2),
                  num_steps=1, ivs=ivs)                  # warm-up
    plain, _ = pipe.generate(cond, uncond, seeds=JUDGE_SEEDS, ivs=ivs)

    # the threshold between the two images' largest concept similarities
    emb = torch.nn.functional.normalize(featurize_l(plain).float(), dim=-1)
    sims = emb @ torch.nn.functional.normalize(concepts.float(), dim=-1).T
    top = sims.max(dim=1).values.cpu().numpy()
    check(top[0] != top[1], f"the two images' largest similarities tie: {top}")
    threshold = float(top.mean())
    checker = CLIPNSFWChecker(featurize_l, concepts, threshold)

    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    (images, _, flags), wall = judge_wall(lambda: checked_generate(
        pipe, cond, uncond, seeds=JUDGE_SEEDS, ivs=ivs, checker=checker))
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    _, checker_wall = judge_wall(checker, plain)
    calls = unet_calls(cfg, cfg.num_inference_steps)
    expect = {k: 16 * calls if k in ("geglu_ff_fused", "sd_self_attention",
                                     "sd_cross_attention") else 0
              for k in _build.KERNELS}
    expect["group_norm_nhwc"] = norm_calls(pipe, calls)
    print(f"judges: checked_generate of {BATCH} requests (seeds "
          f"{JUDGE_SEEDS}), PNDM {cfg.num_inference_steps} steps, CFG "
          f"{cfg.guidance_scale}, MoE on 16 FFs, checker on CLIP ViT-L/14 "
          f"at threshold {threshold:.6f} (largest similarities {top}): wall "
          f"{wall:.3f} s, peak memory {peak_gib:.2f} GiB, flags "
          f"{flags.tolist()}; the checker alone {checker_wall:.3f} s; "
          f"launches {launches} (expected {expect})", flush=True)
    for name, count in expect.items():
        check(launches[name] == count,
              f"checked generate: kernel {name} launched {launches[name]} "
              f"times, expected {count}")
    check_no_plain(launches, "checked generate")
    check(flags.tolist() == (top > threshold).tolist() and flags.sum() == 1,
          f"flags {flags.tolist()} against similarities {top} at {threshold}")
    hit, keep = int(np.flatnonzero(flags)[0]), int(np.flatnonzero(~flags)[0])
    check(torch.equal(images[keep], plain[keep]),
          "the unflagged image differs from plain generate's")
    check(torch.equal(images[hit], blur_images(plain)[hit]),
          "the flagged image is not blur_images of plain generate's")
    print(f"judges: image {keep} bit-equal to plain generate's on the same "
          f"seeds; image {hit} equal to blur_images of it", flush=True)

    # the judges, each on the card and on the CPU
    rows, cpu_imgs = {}, images.cpu()

    def held(name: str, got, ref, wall: float, extra: str = "") -> None:
        got, ref = torch.as_tensor(got), torch.as_tensor(ref)
        abs_err, rel = rel_err(got.cpu(), ref.cpu())
        rows[name] = dict(wall_s=wall, max_abs_err=abs_err, rel_err=rel)
        print(f"judges: {name}: card wall {wall:.3f} s; card vs CPU max abs "
              f"{abs_err:.3e}, rel {rel:.3e} (tolerance {JUDGE_TOL}){extra}",
              flush=True)
        check(rel <= JUDGE_TOL, f"{name}: card vs CPU rel err {rel} > "
              f"{JUDGE_TOL}")

    cpu_l = on_cpu(vit_l, lambda device: CLIPVisionEncoder(
        CLIPVisionConfig(), device=device))
    got, w = judge_wall(featurize_l, images)
    held("checker CLIP ViT-L/14 features", got,
         make_clip_featurizer(cpu_l)(cpu_imgs), w)
    del cpu_l

    b32 = CLIPVisionConfig(**CLIP_B32_VISION)
    vit_b = seed_judge(CLIPVisionEncoder(b32, device=DEV), 3)
    with torch.device(DEV):
        text_b = seed_judge(CLIPTextEncoder(clip_b32_text_config()).eval(), 4)
    proj_b = torch.randn((512, 512), device=DEV, generator=torch.Generator(
        device=DEV).manual_seed(5)) / 512 ** 0.5
    cpu_vb = on_cpu(vit_b, lambda device: CLIPVisionEncoder(b32, device=device))
    cpu_tb = CLIPTextEncoder(clip_b32_text_config()).eval()
    cpu_tb.load_state_dict(text_b.state_dict())
    card_text = make_clip_text_featurizer(text_b, tok, proj_b)
    cpu_text = make_clip_text_featurizer(cpu_tb, tok, proj_b.cpu())
    got, w = judge_wall(card_text, list(CLIP_PROMPTS))
    held("CLIP ViT-B/32 text embeddings", got, cpu_text(list(CLIP_PROMPTS)), w)
    img_b, w = judge_wall(lambda x: vit_b(resize_for_clip(x, 224)), images)
    ref_b = cpu_vb(resize_for_clip(cpu_imgs, 224))
    held("CLIP ViT-B/32 image embeddings", img_b, ref_b, w)
    score, w = judge_wall(clip_score, img_b, got)
    held("CLIP score", score, clip_score(ref_b, cpu_text(list(CLIP_PROMPTS))),
         w, f"; scores {score.tolist()}")
    iqa = ClipIQA(make_clip_featurizer(vit_b), card_text, ("quality",))
    cpu_iqa = ClipIQA(make_clip_featurizer(cpu_vb), cpu_text, ("quality",))
    q, w = judge_wall(iqa, images)
    held("CLIP-IQA quality", q["quality"], cpu_iqa(cpu_imgs)["quality"], w,
         f"; probabilities {q['quality'].tolist()}")
    others = torch.rand((BATCH, 3, 512, 512), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(6))
    feat_b = make_clip_featurizer(vit_b)
    cpu_feat_b = make_clip_featurizer(cpu_vb)
    (fid_clip, w) = judge_wall(lambda: fid_from_features(
        feat_b(images), feat_b(others)))
    held("CLIP-feature FID (512-d)", fid_clip, fid_from_features(
        cpu_feat_b(cpu_imgs), cpu_feat_b(others.cpu())), w,
        f"; FID {fid_clip:.6f}")
    del vit_b, text_b, cpu_vb, cpu_tb

    inc = seed_judge(InceptionV3(device=DEV), 7)
    cpu_inc = on_cpu(inc, lambda device: InceptionV3(device=device))
    featurize_inc = make_inception_featurizer(inc)
    f_img, w = judge_wall(featurize_inc, images)
    check(tuple(f_img.shape) == (BATCH, 2048) and bool(
        torch.isfinite(f_img).all()), f"Inception features {f_img.shape}")
    held("Inception-v3 pool features (2048)", f_img,
         make_inception_featurizer(cpu_inc)(cpu_imgs), w)
    t1 = time.perf_counter()
    fid_inc = fid_from_features(f_img, featurize_inc(others))
    print(f"judges: Inception FID of the 2 images against 2 seeded images "
          f"{fid_inc:.6f} ({time.perf_counter() - t1:.3f} s, the host's "
          f"sqrtm of 2048 x 2048 included)", flush=True)
    check(np.isfinite(fid_inc) and fid_inc > 0, f"Inception FID {fid_inc}")
    del inc, cpu_inc

    lp = seed_judge(LPIPS(device=DEV), 8)
    cpu_lp = on_cpu(lp, lambda device: LPIPS(device=device))
    pair = (images[hit:hit + 1], plain[hit:hit + 1])
    d, w = judge_wall(make_lpips_fn(lp), *pair)
    same = make_lpips_fn(lp)(plain[keep:keep + 1], images[keep:keep + 1])
    held("LPIPS (AlexNet), flagged vs unblurred", d,
         make_lpips_fn(cpu_lp)(*(t.cpu() for t in pair)), w,
         f"; distance {d.tolist()}, unflagged vs itself {same.tolist()}")
    check(float(d[0]) > 0 and float(same[0]) == 0.0,
          f"LPIPS {d.tolist()}, of an image and itself {same.tolist()}")
    del lp, cpu_lp

    sscd = seed_judge(SSCD(ResNetConfig(), 512, device=DEV), 9)
    cpu_sscd = on_cpu(sscd, lambda device: SSCD(ResNetConfig(), 512,
                                                device=device))
    emb_s, w = judge_wall(lambda x: sscd_embed(sscd, preprocess_imagenet(x)),
                          images)
    mem = memorization_scores(emb_s, emb_s)
    held("SSCD embeddings (512)", emb_s,
         sscd_embed(cpu_sscd, preprocess_imagenet(cpu_imgs)), w,
         f"; self-similarity {mem['per_prompt']}")
    check(all(abs(v - 1.0) <= SSCD_DIAGONAL_TOL for v in mem["per_prompt"]),
          f"SSCD diagonal {mem['per_prompt']}")
    del sscd, cpu_sscd, pipe, vit_l
    torch.cuda.empty_cache()
    print("judges: " + json.dumps({"checked_generate_s": wall,
                                   "checker_s": checker_wall,
                                   "peak_gib": peak_gib, "judges": rows}),
          flush=True)
    return launches


# ---------------------------------------------------------------- phase 17
LLAMA_PIECES = 32000         # Llama's vocabulary; <image> is added at 32000
LLAMA_PRIORITY = "▁etaoinshrdlucmfwypvbgkqjxzETAOINSHRDLUCMFWYPVBGKQJXZ"
EVAL_PROMPTS = 4             # the first I2P prompts, one batch of 4
EVAL_SEED = 0
EVAL_OBJECT = "person"
VQA_NEW_TOKENS = 32
LM_CHECK_TOKENS = 64         # tokens of the LM layers' card-vs-CPU check
PROFILE_NEW_TOKENS = 8       # the profiled decode: its trace costs host time


def write_llama_tokenizer(path: str) -> None:
    """A llava-hf-layout `tokenizer.json` of LLAMA_PIECES pieces: <unk>,
    <s>, </s>, the 256 byte tokens <0x00>..<0xFF> (ids 3-258), the word
    mark and printable ASCII, every pair of those (a merge each), then
    triples (a pair and a character, LLAMA_PRIORITY's characters first) to
    fill; <image> added at LLAMA_PIECES. The legacy pipeline of
    transformers' Llama converter: Prepend("▁") + Replace(" ",
    "▁"), no pre-tokenizer, BPE with byte fallback and fused
    unknowns, "<s> $A", decoder Replace, ByteFallback, Fuse, Strip."""
    specials = ["<unk>", "<s>", "</s>"]
    vocab = {t: i for i, t in enumerate(specials)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    chars = list(dict.fromkeys(LLAMA_PRIORITY + "".join(
        chr(c) for c in range(33, 127))))
    for c in chars:
        vocab[c] = len(vocab)
    merges = []
    for a in chars:
        for b in chars:
            merges.append([a, b])
            vocab[a + b] = len(vocab)
    done = False
    for a in chars:
        for b in chars:
            for c in chars:
                if len(vocab) == LLAMA_PIECES:
                    done = True
                    break
                merges.append([a + b, c])
                vocab[a + b + c] = len(vocab)
            if done:
                break
        if done:
            break
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, t in enumerate(specials + ["<image>"])]
    added[3]["id"] = LLAMA_PIECES
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "},
             "content": "▁"}]},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [], "special_tokens": {"<s>": {
                "id": "<s>", "ids": [1], "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"},
             "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)


def _pb_varint(n: int) -> bytes:
    out = b""
    while True:
        b, n = n & 0x7F, n >> 7
        if not n:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _pb_field(field: int, payload: bytes) -> bytes:
    return _pb_varint(field << 3 | 2) + _pb_varint(len(payload)) + payload


def write_yolo_onnx(sd: dict, cfg, path: str) -> int:
    """The port's YOLOv8 state dict as a fused ONNX export: a ModelProto
    whose graph holds one Conv node per conv in execution order (the DFL
    conv last) and the f32 initializers under their module names (raw
    data). Returns the bytes written."""
    from diffusion_models_moe_tpu_torch.models.yolo import conv_execution_order
    nodes, tensors = [], []
    names = conv_execution_order(cfg) + ["model.22.dfl.conv"]
    for i, name in enumerate(names):
        inputs = [f"t{i}", f"{name}.weight"] + (
            [f"{name}.bias"] if f"{name}.bias" in sd else [])
        nodes.append(b"".join(_pb_field(1, x.encode()) for x in inputs)
                     + _pb_field(2, f"t{i + 1}".encode())
                     + _pb_field(4, b"Conv"))
        for key in inputs[1:]:
            arr = sd[key].detach().cpu().float().numpy()
            tensors.append(
                _pb_field(1, b"".join(_pb_varint(d) for d in arr.shape))
                + _pb_varint(2 << 3) + _pb_varint(1)
                + _pb_field(8, key.encode())
                + _pb_field(9, np.ascontiguousarray(arr, "<f4").tobytes()))
    graph = (b"".join(_pb_field(1, n) for n in nodes)
             + b"".join(_pb_field(5, t) for t in tensors))
    data = _pb_varint(1 << 3) + _pb_varint(8) + _pb_field(7, graph)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def load_uint8(out_dir: str, prefix: str, n: int) -> list:
    from PIL import Image
    return [np.asarray(Image.open(os.path.join(out_dir, f"{prefix}_{i}.png")))
            for i in range(n)]


def lm_layers(lm, ids: torch.Tensor, n_layers: int) -> tuple:
    """The LM's embedding, first `n_layers` decoder layers (causal, all
    keys valid), final norm and lm_head on `ids` (B, S): (hidden, logits)."""
    from diffusion_models_moe_tpu_torch.models.llama import (embed_tokens,
                                                             rope_cos_sin)
    cfg = lm.cfg
    b, s = ids.shape
    pos = torch.arange(s, device=ids.device).expand(b, s)
    cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    mask = torch.ones((b, s), dtype=torch.bool, device=ids.device)
    with torch.no_grad():
        x = embed_tokens(lm, ids).to(cfg.dtype)
        for layer in lm.model.layers[:n_layers]:
            x, _ = layer(x, cos, sin, mask)
        h = lm.model.norm(x)
        return x, lm.lm_head(h.float())


def run_erasure_eval(removal, card: str) -> dict:
    """Phase 17: the erasure evaluation over the moefied SD1.5 of phase 3
    (its seeded weights and labels) with phase 5's neuron removal: NudeNet
    (a seeded full-width YOLOv8n written as ONNX and read by
    `load_nudenet_native`) on the card against the CPU; `run_eval` over the
    first EVAL_PROMPTS I2P prompts (baseline and erased images, shared
    noise), `i2p_protocol` resuming over them; a seeded full-width
    LLaVA-1.5-7B in f32 judging presence before and after through
    `removal_score`, its decode held to a teacher-forced forward and to a
    solo decode, its vision tower and LM layers against the CPU. Returns
    the launch counts of `run_eval` and its baseline and erased images
    (uint8, phase 18's judge reads them)."""
    import tempfile
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                build_moe_interventions,
                                                sd15_config)
    from diffusion_models_moe_tpu_torch.benchmarks.nudity import (
        count_harmful, load_nudenet_native, make_native_detector)
    from diffusion_models_moe_tpu_torch.benchmarks.protocols import \
        i2p_protocol
    from diffusion_models_moe_tpu_torch.benchmarks.runner import (
        EvalRunConfig, run_eval)
    from diffusion_models_moe_tpu_torch.benchmarks.vqa import (
        object_question, removal_score)
    from diffusion_models_moe_tpu_torch.data.prompts import i2p_prompts
    from diffusion_models_moe_tpu_torch.data.tokenizer import (
        load_llama_tokenizer, load_tokenizer)
    from diffusion_models_moe_tpu_torch.models.clip_vision import \
        CLIPVisionEncoder
    from diffusion_models_moe_tpu_torch.models.llama import (
        LlamaModel, embed_tokens, greedy_decode)
    from diffusion_models_moe_tpu_torch.models.llava import (
        LlavaForConditionalGeneration, build_vqa, image_features,
        preprocess_image, prompt_template, splice_image)
    from diffusion_models_moe_tpu_torch.models.yolo import (YOLOv8,
                                                            yolov8n_config)
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.weights.port_llava import \
        llava_7b_config
    from diffusion_models_moe_tpu_torch.weights.port_nudenet import \
        port_yolo_from_onnx
    out: dict = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        # ---- NudeNet: a seeded YOLOv8n through its ONNX file
        ycfg = yolov8n_config()
        yolo_card = seed_judge(YOLOv8(ycfg, device=DEV), 41)
        with torch.no_grad():    # the DFL conv stays the arange
            yolo_card.model[22].dfl.conv.weight.copy_(
                torch.arange(ycfg.reg_max, dtype=torch.float32).view(
                    1, -1, 1, 1))
        onnx_path = os.path.join(root, "320n.onnx")
        n_bytes = write_yolo_onnx(yolo_card.state_dict(), ycfg, onnx_path)
        detector = load_nudenet_native(onnx_path, device=DEV)
        yolo_cpu = YOLOv8(ycfg, device="cpu")
        yolo_cpu.load_state_dict(port_yolo_from_onnx(onnx_path, ycfg))
        x = torch.rand((EVAL_PROMPTS, 3, ycfg.imgsz, ycfg.imgsz),
                       generator=torch.Generator().manual_seed(42))
        _, first = judge_wall(yolo_card, x.to(DEV))      # cuDNN's set-up
        (boxes, probs), w = judge_wall(yolo_card, x.to(DEV))
        ref_boxes, ref_probs = yolo_cpu(x)
        for name, got, ref in (("boxes", boxes, ref_boxes),
                               ("class probabilities", probs, ref_probs)):
            abs_err, rel = rel_err(got.cpu(), ref)
            print(f"eval: NudeNet YOLOv8n ({sum(p.numel() for p in yolo_card.parameters())}"
                  f" parameters, {ycfg.num_anchors} anchors, ONNX "
                  f"{n_bytes} bytes) {name}: card wall {w:.4f} s (first "
                  f"call {first:.3f} s); card vs "
                  f"CPU max abs {abs_err:.3e}, rel {rel:.3e} (tolerance "
                  f"{JUDGE_TOL})", flush=True)
            check(rel <= JUDGE_TOL, f"NudeNet {name}: card vs CPU rel err "
                  f"{rel} > {JUDGE_TOL}")
            out[f"nudenet_{name.split()[-1]}_rel_err"] = rel
        imgs = list((x.permute(0, 2, 3, 1).numpy() * 255).round().astype(
            np.uint8))
        dets, w = judge_wall(detector.full, imgs)
        cpu_dets = make_native_detector(yolo_cpu).full(imgs)
        check([[d["class"] for d in a] for a in dets]
              == [[d["class"] for d in a] for a in cpu_dets],
              "NudeNet detections' labels differ between card and CPU")
        score_err = max((abs(a["score"] - b["score"]) for da, db in
                         zip(dets, cpu_dets) for a, b in zip(da, db)),
                        default=0.0)
        check(score_err <= JUDGE_TOL, f"NudeNet detection scores differ by "
              f"{score_err} > {JUDGE_TOL}")
        print(f"eval: NudeNet detections on {len(imgs)} seeded images: "
              f"{[len(d) for d in dets]} after NMS, labels equal on card and "
              f"CPU, scores within {score_err:.3e}; detector wall {w:.3f} s",
              flush=True)
        del yolo_cpu

        # ---- the generates: baseline (moefied) and erased, shared noise
        cfg = sd15_config(torch.bfloat16)
        pipe = StableDiffusionPipeline(cfg, device=DEV)
        pipe.init_params(torch.Generator(device=DEV).manual_seed(0))
        moe = build_moe_interventions(labels_for(cfg.unet.ff_dims()), 0.3,
                                      device=DEV, dtype=cfg.unet.dtype)
        erased = merge(moe, removal, ("neuron_mask", "neuron_fill"))
        tcfg = cfg.text_encoder
        write_tokenizer(os.path.join(root, "clip"), tcfg.vocab_size)
        tok = load_tokenizer(os.path.join(root, "clip"), tcfg.max_length)
        per_call = []

        def moefied(cond, uncond, generator, ivs=None, **kw):
            """The moefied pipeline's generate: MoE routing unless the
            caller's interventions (MoE + removal) replace it."""
            before = dict(_build.LAUNCHES)
            images, taps = pipe.generate(cond, uncond, generator,
                                         ivs=moe if ivs is None else ivs, **kw)
            torch.cuda.synchronize()
            per_call.append({k: v - before.get(k, 0)
                             for k, v in _build.LAUNCHES.items()})
            return images, taps

        prompts = i2p_prompts()[:EVAL_PROMPTS]
        eval_dir = os.path.join(root, "i2p")
        run_cfg = EvalRunConfig(out_dir=eval_dir, batch_size=EVAL_PROMPTS,
                                seed=EVAL_SEED)
        calls = unet_calls(cfg, run_cfg.num_steps)
        _build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        summary, wall = judge_wall(lambda: run_eval(
            pipe, tok, prompts, run_cfg, ivs=erased, generate_fn=moefied))
        launches = dict(_build.LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"eval: run_eval over {len(prompts)} I2P prompts (batch "
              f"{EVAL_PROMPTS}, PNDM {run_cfg.num_steps} steps, CFG "
              f"{run_cfg.guidance_scale}, seed {EVAL_SEED}): baseline "
              f"(MoE) and erased (MoE + phase 5's removal) generates, wall "
              f"{wall:.3f} s, peak memory {peak_gib:.2f} GiB; summary "
              f"{summary}; launches {launches}; per generate {per_call}",
              flush=True)
        check(summary["generated"] == len(prompts) and summary["skipped"] == 0,
              f"run_eval summary {summary}")
        base_expect = {k: 16 * calls if k in (
            "geglu_ff_fused", "sd_self_attention", "sd_cross_attention")
            else 0 for k in _build.KERNELS}
        erased_expect = {k: 16 * calls if k in (
            "fused_route_multiply", "sd_self_attention",
            "sd_cross_attention") else 0 for k in _build.KERNELS}
        for expect in (base_expect, erased_expect):
            expect["group_norm_nhwc"] = norm_calls(pipe, calls)
        check(len(per_call) == 2, f"{len(per_call)} generate calls")
        for what, got, expect in (("baseline", per_call[0], base_expect),
                                  ("erased", per_call[1], erased_expect)):
            for name, count in expect.items():
                check(got[name] == count, f"{what} generate: kernel {name} "
                      f"launched {got[name]} times, expected {count}")
        check_no_plain(launches, "run_eval")
        out.update(run_eval_s=wall, run_eval_peak_gib=peak_gib)

        # shared noise: with ivs=None both calls take the MoE path alone
        same_dir = os.path.join(root, "same")
        run_eval(pipe, tok, prompts[:1],
                 EvalRunConfig(out_dir=same_dir, batch_size=1,
                               seed=EVAL_SEED), ivs=None,
                 generate_fn=moefied)
        a, b = load_uint8(same_dir, "sd", 1)[0], load_uint8(
            same_dir, "removed", 1)[0]
        check(np.array_equal(a, b), "with ivs=None sd_0 and removed_0 differ")
        base_imgs = load_uint8(eval_dir, "sd", len(prompts))
        erased_imgs = load_uint8(eval_dir, "removed", len(prompts))
        moved = [float(np.abs(p.astype(np.int16) - q).mean())
                 for p, q in zip(base_imgs, erased_imgs)]
        print(f"eval: with ivs=None sd_0 and removed_0 bit-equal (shared "
              f"noise); the removal moves the images by {moved} (mean "
              f"|uint8 diff|)", flush=True)

        # ---- the I2P count: resume skips every prompt
        _build.reset_launch_counts()
        result = i2p_protocol(pipe, tok, eval_dir, detector, ivs=erased,
                              limit=EVAL_PROMPTS, batch_size=EVAL_PROMPTS,
                              generate_fn=moefied)
        with open(os.path.join(eval_dir, "run_summary.json")) as f:
            resumed = json.load(f)
        direct = count_harmful(detector(erased_imgs))
        direct["n_prompts"] = len(prompts)
        print(f"eval: i2p_protocol(limit={EVAL_PROMPTS}) resumed "
              f"{resumed}: {result}; launches {sum(_build.LAUNCHES.values())}",
              flush=True)
        check(resumed["generated"] == 0 and resumed["skipped"] == len(prompts),
              f"i2p_protocol did not skip every prompt: {resumed}")
        check(sum(_build.LAUNCHES.values()) == 0,
              "i2p_protocol launched kernels on a resumed run")
        check(result == direct, f"I2P count {result} != the detector's on "
              f"the PNGs {direct}")
        out["i2p"] = result
        del pipe, moe, erased
        torch.cuda.empty_cache()

        # ---- LLaVA-1.5-7B at full width, f32
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lcfg = llava_7b_config()
        llava = seed_judge(LlavaForConditionalGeneration(lcfg, device=DEV), 43)
        write_llama_tokenizer(os.path.join(root, "llava"))
        encode, decode = load_llama_tokenizer(os.path.join(root, "llava"))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in llava.parameters())
        print(f"eval: LLaVA-1.5-7B ({n_params} parameters, f32) built and "
              f"seeded on the card, tokenizer ({LLAMA_PIECES} pieces + "
              f"<image>) written and read in {time.perf_counter() - t0:.1f} "
              f"s", flush=True)
        vqa = build_vqa(llava, encode, decode, max_new_tokens=VQA_NEW_TOKENS)
        question = object_question(EVAL_OBJECT)
        score, w = judge_wall(removal_score, vqa, base_imgs, erased_imgs,
                              question)
        print(f"eval: removal_score({question!r}) over {len(base_imgs)} "
              f"baseline and {len(erased_imgs)} erased images: {score}; wall "
              f"{w:.3f} s", flush=True)
        out["removal_score"] = score

        ids = encode(prompt_template(question))
        pixels = torch.from_numpy(np.stack([
            preprocess_image(img, lcfg.vision.image_size)
            for img in base_imgs])).permute(0, 3, 1, 2).to(DEV)
        feats, t_feat = judge_wall(image_features, llava, pixels)
        embeds, length = splice_image(llava, ids, feats)
        lengths = torch.full((len(base_imgs),), length, device=DEV)
        lm = llava.language_model
        _, t_prefill = judge_wall(greedy_decode, lm, embeds, lengths, 1,
                                  lcfg.eos_id)
        toks, t_full = judge_wall(greedy_decode, lm, embeds, lengths,
                                  VQA_NEW_TOKENS, lcfg.eos_id)
        answers = vqa.batch(base_imgs, question)
        texts = [decode([int(t) for t in row if int(t) not in
                         (0, lcfg.eos_id)]) for row in toks.tolist()]
        check(answers == texts, f"vqa.batch answers {answers} != the decoded "
              f"tokens {texts}")
        # (a) the cached decode against a teacher-forced full forward
        seq = torch.cat([embeds, embed_tokens(lm, toks[:, :-1]).to(
            embeds.dtype)], dim=1)
        pos = torch.arange(seq.shape[1], device=DEV).expand(len(toks), -1)
        logits, _ = lm(seq, pos, torch.ones(pos.shape, dtype=torch.bool,
                                             device=DEV))
        tail = logits[:, length - 1:]
        forced = tail.argmax(dim=-1)
        top2 = tail.topk(2, dim=-1).values
        margins = []
        for r in range(len(toks)):
            row = toks[r].tolist()
            n = row.index(lcfg.eos_id) + 1 if lcfg.eos_id in row else len(row)
            check(forced[r, :n].tolist() == row[:n],
                  f"image {r}: cached greedy tokens {row[:n]} != the "
                  f"teacher-forced argmax {forced[r, :n].tolist()}")
            margins.append((top2[r, :n, 0] - top2[r, :n, 1]).min().item())
        # (b) image 0 alone decodes as co-batched
        solo = greedy_decode(lm, embeds[:1], lengths[:1], VQA_NEW_TOKENS,
                             lcfg.eos_id)
        check(torch.equal(solo[0], toks[0]), "image 0 alone decodes "
              f"{solo[0].tolist()}, co-batched {toks[0].tolist()}")
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        per_token = (t_full - t_prefill) / (VQA_NEW_TOKENS - 1)
        prompt_len = len(ids)
        print(f"eval: LLaVA decode of {len(toks)} images, prompt {prompt_len}"
              f" ids -> {length} positions with {lcfg.num_image_tokens} image"
              f" tokens, {VQA_NEW_TOKENS} new tokens: image features "
              f"{t_feat:.3f} s, prefill {t_prefill:.3f} s, decode "
              f"{per_token * 1e3:.2f} ms a token; peak memory {peak_gib:.2f} "
              f"GiB; cached tokens equal the teacher-forced argmax (smallest "
              f"top-2 margin {min(margins):.4e}); image 0 alone equal to "
              f"co-batched; answers {answers}", flush=True)
        out.update(llava_params=n_params, image_features_s=t_feat,
                   prefill_s=t_prefill, decode_ms_per_token=per_token * 1e3,
                   llava_peak_gib=peak_gib, min_top2_margin=min(margins))

        # (c) the vision tower and the LM layers against the CPU
        tower = CLIPVisionEncoder(lcfg.vision, device="cpu")
        tower.visual_projection = None
        tower.load_state_dict({k[len("vision_tower."):]: v.cpu() for k, v in
                               llava.state_dict().items()
                               if k.startswith("vision_tower.")})
        got, w = judge_wall(lambda: llava.vision_tower(
            pixels[:1], feature_layer=lcfg.vision_feature_layer))
        ref = tower(pixels[:1].cpu(), feature_layer=lcfg.vision_feature_layer)
        abs_err, rel = rel_err(got.cpu(), ref)
        print(f"eval: LLaVA vision tower (CLIP ViT-L/14-336, penultimate "
              f"layer, 577 tokens) on one image: card wall {w:.3f} s; card "
              f"vs CPU max abs {abs_err:.3e}, rel {rel:.3e} (tolerance "
              f"{JUDGE_TOL})", flush=True)
        check(rel <= JUDGE_TOL, f"LLaVA vision tower: card vs CPU {rel}")
        out["vision_rel_err"] = rel
        del tower
        cpu_lm = LlamaModel(dataclasses.replace(lcfg.text, num_layers=2),
                            device="cpu")
        keep = ("model.embed_tokens.", "model.norm.", "lm_head.",
                "model.layers.0.", "model.layers.1.")
        cpu_lm.load_state_dict({k: v.cpu() for k, v in lm.state_dict().items()
                                if k.startswith(keep)})
        tok_ids = torch.randint(0, LLAMA_PIECES, (1, LM_CHECK_TOKENS),
                                generator=torch.Generator().manual_seed(44))
        (hid, log), w = judge_wall(lm_layers, lm, tok_ids.to(DEV), 2)
        ref_hid, ref_log = lm_layers(cpu_lm, tok_ids, 2)
        for key, name, got, ref in (
                ("lm_layers", "two decoder layers' output", hid, ref_hid),
                ("lm_logits", "lm_head logits", log, ref_log)):
            abs_err, rel = rel_err(got.cpu(), ref)
            print(f"eval: LLaMA-7B embedding + {name} on {LM_CHECK_TOKENS} "
                  f"tokens: card wall {w:.3f} s; card vs CPU max abs "
                  f"{abs_err:.3e}, rel {rel:.3e} (tolerance {JUDGE_TOL})",
                  flush=True)
            check(rel <= JUDGE_TOL, f"LLaMA {name}: card vs CPU {rel}")
            out[f"{key}_rel_err"] = rel
        # (d) a decode token's device time, by the profiler, against its
        # unprofiled wall above: the difference between a 1-token and a
        # PROFILE_NEW_TOKENS-token decode over the same prefill. Last in the
        # phase: a process whose card the profiler has traced launches slower.
        prefill_k = device_kernels(lambda: greedy_decode(
            lm, embeds, lengths, 1, lcfg.eos_id))
        decode_k = device_kernels(lambda: greedy_decode(
            lm, embeds, lengths, PROFILE_NEW_TOKENS, lcfg.eos_id))
        steps = PROFILE_NEW_TOKENS - 1
        per_step = {k: ((ms - prefill_k.get(k, (0.0, 0))[0]) / steps,
                        (n - prefill_k.get(k, (0.0, 0))[1]) / steps)
                    for k, (ms, n) in decode_k.items()}
        dev_ms = sum(ms for ms, _ in per_step.values())
        step_launches = sum(n for _, n in per_step.values())
        if dev_ms > 0:
            top = sorted(per_step.items(), key=lambda kv: -kv[1][0])[:4]
            print(f"eval: LLaVA decode, a token: device {dev_ms:.3f} ms (the "
                  f"profiler) of {per_token * 1e3:.3f} ms of wall, busy share "
                  f"{dev_ms / (per_token * 1e3):.4f}; {step_launches:.1f} "
                  f"launches a token; the most device time: " + "; ".join(
                      f"{k[:60]} {ms:.3f} ms x {n:.1f}"
                      for k, (ms, n) in top), flush=True)
            out.update(decode_device_ms_per_token=dev_ms,
                       decode_busy_share=dev_ms / (per_token * 1e3),
                       decode_launches_per_token=step_launches)
        else:
            print("eval: LLaVA decode, a token: device time not measured "
                  "(the profiler saw no device kernels)", flush=True)
        del cpu_lm, llava, lm, vqa
        torch.cuda.empty_cache()
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    print("eval: " + json.dumps(out), flush=True)
    return launches, (base_imgs, erased_imgs)


# ---------------------------------------------------------------- phase 18
QWEN_PIECES = 151643         # Qwen2's byte-level BPE vocabulary
# Qwen2-VL's added tokens, in its tokenizer.json's order from QWEN_PIECES on
QWEN_ADDED = ("<|endoftext|>", "<|im_start|>", "<|im_end|>",
              "<|object_ref_start|>", "<|object_ref_end|>", "<|box_start|>",
              "<|box_end|>", "<|quad_start|>", "<|quad_end|>",
              "<|vision_start|>", "<|vision_end|>", "<|vision_pad|>",
              "<|image_pad|>", "<|video_pad|>")
# the byte-alphabet characters merged first: space (Ġ), letters by
# frequency, digits, punctuation, newline (Ċ)
QWEN_PRIORITY = ("Ġetaoinshrdlucmfwypvbgkqjxz" "ETAOINSHRDLUCMFWYPVBGKQJXZ"
                 "0123456789.,'!?-:;\"()Ċ")


def write_qwen_tokenizer(path: str) -> None:
    """A Qwen2-layout `tokenizer.json` of QWEN_PIECES byte-level BPE pieces:
    the 256 characters of the byte alphabet (GPT-2's order), every pair of
    them (a merge each, QWEN_PRIORITY's characters first), then triples (a
    pair of priority characters and any character) to fill; QWEN_ADDED as
    special added tokens from QWEN_PIECES on (<|im_end|> 151645,
    <|vision_start|> 151652, <|image_pad|> 151655). The pipeline of Qwen2's
    file: NFC, `Split` on Qwen2's pattern then `ByteLevel`, BPE without an
    unknown token, `ByteLevel` post-processor and decoder."""
    from diffusion_models_moe_tpu_torch.data._native_unigram import \
        QWEN2_SPLIT
    from diffusion_models_moe_tpu_torch.data.tokenizer import \
        _bytes_to_unicode
    alphabet = list(_bytes_to_unicode().values())
    chars = list(dict.fromkeys(list(QWEN_PRIORITY) + alphabet))
    vocab = {c: i for i, c in enumerate(alphabet)}
    merges = []
    for a in chars:
        for b in chars:
            merges.append([a, b])
            vocab[a + b] = len(vocab)
    prio = chars[:len(QWEN_PRIORITY)]
    for a in prio:
        for b in prio:
            for c in chars:
                if len(vocab) == QWEN_PIECES:
                    break
                merges.append([a + b, c])
                vocab[a + b + c] = len(vocab)
    added = [{"id": QWEN_PIECES + i, "content": t, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": True} for i, t in enumerate(QWEN_ADDED)]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": False, "use_regex": False}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_SPLIT},
             "behavior": "Isolated", "invert": False}, byte_level]},
        "post_processor": byte_level, "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": False, "vocab": vocab, "merges": merges},
    }
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)


QWEN_CHECK_TOKENS = 64       # tokens of the LM layers' card-vs-CPU check
# the tower's card-vs-CPU check runs on a 224-px image (256 patches, 64
# merged tokens): the CPU pass over a 512-px image's 1296 would take ~20 s
QWEN_CHECK_PX = 224
MC_OBJECTS = ("person", "cat", "dog", "car")   # image i's ground truth
DEBIAS_PROFESSIONS = ("doctor", "nurse")
DEBIAS_SEEDS = (31, 32)      # the reference's removal sweep starts at 31
UNIFIED_PROMPTS = ("a dog in the style of Van Gogh",
                   "a house in the style of Van Gogh",
                   "a photo of a red car")
BASELINE_STEPS = 10          # the baselines' generates: every kernel shape
BASELINE_PROMPTS = 2         # the first I2P prompts, one batch


class MoefiedPipe:
    """The moefied SD1.5 as the protocols see it: `generate` routes MoE on
    every call and merges a caller's removal into it; each call's kernel
    launches are recorded."""

    def __init__(self, pipe, moe):
        self.pipe, self.moe, self.device = pipe, moe, pipe.device
        self.calls: list = []

    def generate(self, cond, uncond, generator=None, ivs=None, **kw):
        from diffusion_models_moe_tpu_torch.ops import _build
        before = dict(_build.LAUNCHES)
        out = self.pipe.generate(
            cond, uncond, generator,
            ivs=self.moe if ivs is None else merge(self.moe, ivs, (
                "neuron_mask", "neuron_fill", "out_weight_mask")),
            **kw)
        torch.cuda.synchronize()
        self.calls.append({k: v - before.get(k, 0)
                           for k, v in _build.LAUNCHES.items()})
        return out


def expect_calls(calls: list, kinds: list, n_calls: int, what: str) -> dict:
    """Each generate's launches against its kind: "moe" (kernels 1-3),
    "removal" (kernels 2-4, the FF unfused under routing) or "no_moe"
    (kernels 1-3, kernel 1 without routing), 16 a UNet call, and the
    GroupNorm kernel at SD15_NORMS a UNet call and VAE_NORMS a decode; no
    plain version anywhere. Returns the launches summed by kernel."""
    from diffusion_models_moe_tpu_torch.ops import _build
    check(len(calls) == len(kinds), f"{what}: {len(calls)} generates, "
          f"expected {len(kinds)}")
    on = {"moe": ("geglu_ff_fused", "sd_self_attention",
                  "sd_cross_attention"),
          "removal": ("fused_route_multiply", "sd_self_attention",
                      "sd_cross_attention")}
    on["no_moe"] = on["moe"]
    total: dict = {}
    for i, (got, kind) in enumerate(zip(calls, kinds)):
        for name in _build.KERNELS:
            want = 16 * n_calls if name in on[kind] else 0
            if name == "group_norm_nhwc":
                want = SD15_NORMS * n_calls + VAE_NORMS
            check(got.get(name, 0) == want, f"{what}, generate {i} ({kind}):"
                  f" kernel {name} launched {got.get(name, 0)} times, "
                  f"expected {want}")
        check_no_plain({k: got.get(k, 0) for k in _build.PLAIN},
                       f"{what}, generate {i}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    return total


def qwen_lm_layers(lm, ids: torch.Tensor, pos: torch.Tensor,
                   n_layers: int) -> tuple:
    """The Qwen2 LM's embedding, first `n_layers` decoder layers (causal,
    3-D positions `pos` (3, B, S)), final norm and lm_head on `ids`:
    (hidden, logits)."""
    from diffusion_models_moe_tpu_torch.models.llama import (embed_tokens,
                                                             mrope_cos_sin)
    cfg = lm.cfg
    cos, sin = mrope_cos_sin(pos, cfg.head_dim, cfg.rope_theta,
                             cfg.mrope_section)
    mask = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    with torch.no_grad():
        x = embed_tokens(lm, ids).to(cfg.dtype)
        for layer in lm.model.layers[:n_layers]:
            x, _ = layer(x, cos, sin, mask)
        return x, lm.lm_head(lm.model.norm(x).float())


def run_qwen_judge(images: tuple, root: str, card: str) -> dict:
    """Phase 18 (a, b): the Qwen2 tokenizer on a full-size synthetic file
    and a seeded full-width Qwen2-VL-7B in f32 judging phase 17's images
    (`removal_score`, `MultipleChoiceScorer`), its decode held to a
    teacher-forced forward and to a solo decode, its tower and LM layers
    against the CPU; `load_qwen2vl_native` at a tiny size."""
    from PIL import Image
    from diffusion_models_moe_tpu_torch.benchmarks.vqa import (
        MultipleChoiceScorer, load_qwen2vl_native, object_question,
        removal_score)
    from diffusion_models_moe_tpu_torch.data.prompts import (
        artist_names, i2p_prompts, memorized_captions)
    from diffusion_models_moe_tpu_torch.data.tokenizer import \
        load_qwen_tokenizer
    from diffusion_models_moe_tpu_torch.models.llama import (LlamaModel,
                                                             embed_tokens,
                                                             greedy_decode)
    from diffusion_models_moe_tpu_torch.models.qwen2vl import (
        Qwen2VisionTower, Qwen2VLForConditionalGeneration, build_vqa,
        image_features, preprocess_image, prompt_ids, rope_index,
        tiny_qwen2vl_config)
    from diffusion_models_moe_tpu_torch.weights.export import save_safetensors
    from diffusion_models_moe_tpu_torch.weights.port_qwen2vl import \
        qwen2vl_7b_config
    base_imgs, erased_imgs = images
    out: dict = {}

    # ---- (a) the tokenizer
    tok_dir = os.path.join(root, "qwen")
    t0 = time.perf_counter()
    write_qwen_tokenizer(tok_dir)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    encode, decode = load_qwen_tokenizer(tok_dir)
    t_load = time.perf_counter() - t0
    qcfg = qwen2vl_7b_config()
    chat = ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
            "<|im_start|>user\n<|vision_start|><|image_pad|><|vision_end|>"
            "Is there a person in the image?<|im_end|>\n"
            "<|im_start|>assistant\n")
    ids = encode(chat).tolist()
    for want in (151644, 151645, qcfg.vision_start_token_id,
                 qcfg.vision_start_token_id + 1, qcfg.image_token_id):
        check(want in ids, f"Qwen2 tokenizer: id {want} not in the chat "
              f"template's ids {ids}")
    texts = i2p_prompts() + memorized_captions() + artist_names()
    t0 = time.perf_counter()
    encoded = [encode(t) for t in texts]
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = [decode(e) for e in encoded]
    t_dec = time.perf_counter() - t0
    bad = [t for t, d in zip(texts, decoded) if d != t.strip()]
    check(not bad, f"Qwen2 tokenizer round trip differs on {bad[:3]}")
    n_ids = sum(len(e) for e in encoded)
    print(f"qwen: tokenizer.json of {QWEN_PIECES} byte-level BPE pieces + "
          f"{len(QWEN_ADDED)} added written in {t_write:.2f} s, read by "
          f"load_qwen_tokenizer in {t_load:.2f} s; the chat template -> "
          f"{len(ids)} ids with the special ids; {len(texts)} prompts "
          f"(the I2P, memorized and artist files) -> {n_ids} ids: encode "
          f"{t_enc:.3f} s, decode {t_dec:.3f} s, every text back as it "
          f"was", flush=True)
    out.update(tokenizer_load_s=t_load, tokenizer_encode_s=t_enc,
               tokenizer_decode_s=t_dec)

    # ---- (b) Qwen2-VL-7B at full width, f32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = seed_judge(Qwen2VLForConditionalGeneration(qcfg, device=DEV), 45)
    torch.cuda.synchronize()
    n_tower = sum(p.numel() for p in model.visual.parameters())
    n_lm = sum(p.numel() for p in model.language_model.parameters())
    print(f"qwen: Qwen2-VL-7B ({n_tower + n_lm} parameters: tower {n_tower},"
          f" LM {n_lm}; f32) built and seeded on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    vqa = build_vqa(model, encode, decode, max_new_tokens=VQA_NEW_TOKENS)
    question = object_question(EVAL_OBJECT)
    score, w = judge_wall(removal_score, vqa, base_imgs, erased_imgs,
                          question)
    print(f"qwen: removal_score({question!r}) over {len(base_imgs)} "
          f"baseline and {len(erased_imgs)} erased images: {score}; wall "
          f"{w:.3f} s", flush=True)
    scorer = MultipleChoiceScorer(vqa, MC_OBJECTS[:len(base_imgs)], "gender")
    _, w_mc = judge_wall(lambda: (
        scorer.score_images(base_imgs, label=2, before=True),
        scorer.score_images(erased_imgs, label=2, before=False)))
    mc = scorer.get_results()
    print(f"qwen: MultipleChoiceScorer({list(MC_OBJECTS[:len(base_imgs)])}, "
          f"'gender') before and after: {json.dumps(mc)}; wall {w_mc:.3f} s",
          flush=True)
    out.update(removal_score=score, multiple_choice=mc)

    pre = [preprocess_image(img, qcfg.vision, max_pixels=28 * 28 * 576)
           for img in base_imgs]
    grid = pre[0][1]
    check(all(g == grid for _, g in pre), f"grids {[g for _, g in pre]}")
    m2 = qcfg.vision.spatial_merge_size ** 2
    ids = prompt_ids(encode, question, pre[0][0].shape[0] // m2, qcfg)
    patches = np.stack([p for p, _ in pre])
    feats, t_feat = judge_wall(image_features, model, patches, grid)
    lm = model.language_model
    b, length = len(pre), len(ids)
    img_pos = torch.from_numpy(np.nonzero(ids == qcfg.image_token_id)[0]
                               ).to(DEV)
    embeds = embed_tokens(lm, torch.from_numpy(ids))[None].repeat(b, 1, 1)
    embeds[:, img_pos] = feats
    pos, delta = rope_index(qcfg, ids, grid)
    pos = torch.from_numpy(pos).long().to(DEV).expand(3, b, -1)
    lengths = torch.full((b,), length, device=DEV)
    offsets = torch.full((b,), delta, device=DEV)

    def decode_n(n, e=embeds, ln=lengths, p=pos, o=offsets):
        return greedy_decode(lm, e, ln, n, qcfg.eos_id, pad_id=qcfg.pad_id,
                             prefill_positions=p, pos_offset=o)

    _, t_prefill = judge_wall(decode_n, 1)
    toks, t_full = judge_wall(decode_n, VQA_NEW_TOKENS)
    answers = vqa.batch(base_imgs, question)
    texts = [decode([int(t) for t in row
                     if int(t) not in (qcfg.pad_id, qcfg.eos_id)])
             for row in toks.tolist()]
    check(answers == texts, f"vqa.batch answers {answers} != the decoded "
          f"tokens {texts}")
    # the cached decode against a teacher-forced forward: token j sits at
    # slot length + j, at 3-D position slot + delta on every axis
    seq = torch.cat([embeds, embed_tokens(lm, toks[:, :-1]).to(embeds.dtype)],
                    dim=1)
    tail = (torch.arange(length, seq.shape[1], device=DEV) + delta
            ).expand(3, b, -1)
    logits, _ = lm(seq, torch.cat([pos, tail], dim=2),
                   torch.ones(seq.shape[:2], dtype=torch.bool, device=DEV))
    forced = logits[:, length - 1:]
    top2 = forced.topk(2, dim=-1).values
    margins = []
    for r in range(b):
        row = toks[r].tolist()
        n = row.index(qcfg.eos_id) + 1 if qcfg.eos_id in row else len(row)
        check(forced[r, :n].argmax(dim=-1).tolist() == row[:n],
              f"image {r}: cached greedy tokens {row[:n]} != the "
              f"teacher-forced argmax")
        margins.append((top2[r, :n, 0] - top2[r, :n, 1]).min().item())
    del logits, forced, seq
    solo = decode_n(VQA_NEW_TOKENS, embeds[:1], lengths[:1], pos[:, :1],
                    offsets[:1])
    check(torch.equal(solo[0], toks[0]), "image 0 alone decodes "
          f"{solo[0].tolist()}, co-batched {toks[0].tolist()}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    per_token = (t_full - t_prefill) / (VQA_NEW_TOKENS - 1)
    side = grid[1] * qcfg.vision.patch_size
    print(f"qwen: Qwen2-VL decode of {b} images at {side} px ({grid} "
          f"patches, {feats.shape[1]} image tokens), prompt {length} ids, "
          f"{VQA_NEW_TOKENS} new tokens: image features {t_feat:.3f} s, "
          f"prefill {t_prefill:.3f} s, decode {per_token * 1e3:.2f} ms a "
          f"token; peak memory {peak_gib:.2f} GiB; cached tokens equal the "
          f"teacher-forced argmax (smallest top-2 margin "
          f"{min(margins):.4e}); image 0 alone equal to co-batched; answers "
          f"{answers}", flush=True)
    out.update(qwen_params=n_tower + n_lm, qwen_features_s=t_feat,
               qwen_prefill_s=t_prefill,
               qwen_decode_ms_per_token=per_token * 1e3,
               qwen_peak_gib=peak_gib, qwen_min_top2_margin=min(margins))

    # the tower and the LM layers against the CPU: built on the meta device
    # and given the card's weights (a CPU initialisation of them takes ~20 s)
    with torch.device("meta"):
        tower = Qwen2VisionTower(qcfg.vision)
    tower.load_state_dict({k[len("visual."):]: v.cpu() for k, v in
                           model.state_dict().items()
                           if k.startswith("visual.")}, assign=True)
    small = np.asarray(Image.fromarray(base_imgs[0]).resize(
        (QWEN_CHECK_PX, QWEN_CHECK_PX)))
    p_small, g_small = preprocess_image(small, qcfg.vision)
    got, w = judge_wall(model.visual, torch.from_numpy(p_small), g_small)
    ref = tower(torch.from_numpy(p_small), g_small)
    abs_err, rel = rel_err(got.cpu(), ref)
    print(f"qwen: Qwen2-VL vision tower (32 blocks of 1280, 2-D RoPE, "
          f"PatchMerger) on a {QWEN_CHECK_PX}-px image ({g_small} patches, "
          f"{got.shape[0]} tokens): card wall {w:.3f} s; card vs CPU max abs "
          f"{abs_err:.3e}, rel {rel:.3e} (tolerance {JUDGE_TOL})", flush=True)
    check(rel <= JUDGE_TOL, f"Qwen2-VL vision tower: card vs CPU {rel}")
    out["qwen_vision_rel_err"] = rel
    del tower
    cpu_lm = LlamaModel(dataclasses.replace(qcfg.text, num_layers=2),
                        device="meta")
    keep = ("model.embed_tokens.", "model.norm.", "lm_head.",
            "model.layers.0.", "model.layers.1.")
    cpu_lm.load_state_dict({k: v.cpu() for k, v in lm.state_dict().items()
                            if k.startswith(keep)}, assign=True)
    n_img = 16
    check_ids = np.concatenate([
        [151644, 872, 198, qcfg.vision_start_token_id],
        [qcfg.image_token_id] * n_img,
        np.random.RandomState(46).randint(
            0, QWEN_PIECES, QWEN_CHECK_TOKENS - n_img - 4)])
    check_pos, _ = rope_index(qcfg, check_ids, (1, 8, 8))
    tok_ids = torch.from_numpy(check_ids)[None]
    tok_pos = torch.from_numpy(check_pos).long()
    (hid, log), w = judge_wall(qwen_lm_layers, lm, tok_ids.to(DEV),
                               tok_pos.to(DEV), 2)
    ref_hid, ref_log = qwen_lm_layers(cpu_lm, tok_ids, tok_pos, 2)
    for key, name, got, ref in (
            ("qwen_lm_layers", "two decoder layers' output", hid, ref_hid),
            ("qwen_lm_logits", "lm_head logits", log, ref_log)):
        abs_err, rel = rel_err(got.cpu(), ref)
        print(f"qwen: Qwen2-7B embedding + {name} on {QWEN_CHECK_TOKENS} "
              f"tokens (3-D positions of a 16-token image span): card wall "
              f"{w:.3f} s; card vs CPU max abs {abs_err:.3e}, rel {rel:.3e} "
              f"(tolerance {JUDGE_TOL})", flush=True)
        check(rel <= JUDGE_TOL, f"Qwen2 {name}: card vs CPU {rel}")
        out[f"{key}_rel_err"] = rel
    del cpu_lm, model, lm, vqa, embeds, feats
    torch.cuda.empty_cache()

    # load_qwen2vl_native at a tiny size: a snapshot the script writes
    tiny = tiny_qwen2vl_config()
    tcfg = dataclasses.replace(
        qcfg, vision=tiny.vision, text=dataclasses.replace(
            tiny.text, vocab_size=QWEN_PIECES + len(QWEN_ADDED)))
    snap = os.path.join(root, "qwen_tiny")
    src = seed_judge(Qwen2VLForConditionalGeneration(tcfg, device=DEV), 47)
    save_safetensors({(k[len("language_model."):] if k.startswith(
        "language_model.") else k): v for k, v in src.state_dict().items()},
        os.path.join(snap, "model.safetensors"))
    write_qwen_tokenizer(snap)
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump({"hidden_size": tcfg.text.hidden_size}, f)
    t0 = time.perf_counter()
    native = load_qwen2vl_native(snap, config=tcfg, max_new_tokens=8,
                                 device=DEV)
    t_native = time.perf_counter() - t0
    got = native.batch(base_imgs[:2], question)
    ref = build_vqa(src, encode, decode, max_new_tokens=8).batch(
        base_imgs[:2], question)
    check(got == ref, f"load_qwen2vl_native answers {got} != the written "
          f"model's {ref}")
    print(f"qwen: load_qwen2vl_native(config=tiny, vocabulary "
          f"{tcfg.text.vocab_size}) from the snapshot written here, in "
          f"{t_native:.2f} s: answers {got} equal the written model's",
          flush=True)
    del src, native
    return out


def run_baselines(pipe, tok, root: str) -> tuple:
    """Phase 18 (e): `pipe`'s seeded weights written as a diffusers snapshot
    in their bf16 (phase 12's layout, half its bytes) under `root`, with
    an ESD-style whole-UNet `.pt` (cross-attention projections perturbed,
    fp16) and a Concept-Ablation `delta.bin` (K and V projections and the
    whole text encoder); `load_baseline` of "esd" and "concept-ablation"
    on them, each file's tensors checked in the loaded pipeline and a
    BASELINE_STEPS-step generate of BASELINE_PROMPTS I2P prompts on
    kernels 1-3; "sld" through `run_eval` with `make_protocol_generate`.
    Returns the launches by baseline and the SLD run's wall."""
    from diffusion_models_moe_tpu_torch.benchmarks.baselines import (
        BASELINES, load_baseline, make_protocol_generate)
    from diffusion_models_moe_tpu_torch.benchmarks.runner import (
        EvalRunConfig, run_eval)
    from diffusion_models_moe_tpu_torch.data.prompts import i2p_prompts
    from diffusion_models_moe_tpu_torch.ops import _build
    cfg = pipe.config
    launches: dict = {}
    snap = os.path.join(root, "snapshot")
    t0 = time.perf_counter()
    n_bytes = write_snapshot(pipe, snap, cfg.unet.dtype)
    rng = torch.Generator().manual_seed(48)
    unet_sd = {k: v.cpu() for k, v in pipe.unet.state_dict().items()}
    edited = {f"unet.{k}": (v.float() * (1 + 0.05 * torch.randn(
        v.shape, generator=rng))).half() if "attn2.to_" in k
        else v.half() for k, v in unet_sd.items()}
    torch.save(edited, os.path.join(root, "esd.pt"))
    delta = {"unet": {k: v.float() * 1.5 for k, v in unet_sd.items()
                      if "attn2.to_k" in k or "attn2.to_v" in k},
             "text_encoder": {k[len("text_model."):]: v.cpu().float()
                              + 0.01 for k, v in
                              pipe.text_encoder.state_dict().items()}}
    torch.save(delta, os.path.join(root, "delta.bin"))
    print(f"baselines: the seeded SD1.5 as a snapshot ({n_bytes} bytes), "
          f"esd.pt and delta.bin written in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    del unet_sd
    prompts = i2p_prompts()[:BASELINE_PROMPTS]
    cond = tok(prompts).to(DEV)
    uncond = tok([""] * len(prompts)).to(DEV)
    bcalls = unet_calls(cfg, BASELINE_STEPS)
    for name, kw, key in (
            ("esd", {"edited_unet": os.path.join(root, "esd.pt")},
             "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k."
             "weight"),
            ("concept-ablation",
             {"delta": os.path.join(root, "delta.bin")},
             "up_blocks.3.attentions.2.transformer_blocks.0.attn2.to_v."
             "weight")):
        (bpipe, gen_kw), t_load = judge_wall(
            lambda: load_baseline(name, snap, device=DEV, **kw))
        want = (edited[f"unet.{key}"] if name == "esd"
                else delta["unet"][key])
        check(gen_kw == {} and torch.equal(
            bpipe.unet.state_dict()[key].cpu(),
            want.to(cfg.unet.dtype)), f"{name}: the UNet's {key} is not "
            "the file's")
        if name == "concept-ablation":
            te = bpipe.text_encoder.state_dict()
            k = "text_model.final_layer_norm.weight"
            check(torch.equal(te[k].cpu(), delta["text_encoder"][
                k[len("text_model."):]].to(te[k].dtype)),
                "concept-ablation: the delta's text encoder not loaded")
        _build.reset_launch_counts()
        (imgs, _), w = judge_wall(lambda: bpipe.generate(
            cond, uncond, torch.Generator(device=DEV).manual_seed(5),
            num_steps=BASELINE_STEPS))
        check(bool(torch.isfinite(imgs).all()), f"{name}: non-finite")
        launches[f"baseline_{name}"] = expect_calls(
            [dict(_build.LAUNCHES)], ["no_moe"], bcalls,
            f"baseline {name}")
        print(f"baselines: load_baseline({name!r}, {list(kw)}) "
              f"({BASELINES[name].description}) in {t_load:.2f} s; a "
              f"{BASELINE_STEPS}-step generate of {len(prompts)} I2P "
              f"prompts {w:.3f} s; launches "
              f"{launches[f'baseline_{name}']}", flush=True)
        del bpipe, imgs
        torch.cuda.empty_cache()
    (bpipe, gen_kw), t_load = judge_wall(
        lambda: load_baseline("sld", snap, device=DEV))
    check(gen_kw == {"use_sld": True}, f"sld kwargs {gen_kw}")
    sld_gen = make_protocol_generate(bpipe, gen_kw, tok)
    sld_calls = []

    def counted(*a, **kw):
        before = dict(_build.LAUNCHES)
        res = sld_gen(*a, **kw)
        torch.cuda.synchronize()
        sld_calls.append({k: v - before.get(k, 0)
                          for k, v in _build.LAUNCHES.items()})
        return res

    sld_dir = os.path.join(root, "sld")
    _build.reset_launch_counts()
    summary, w = judge_wall(lambda: run_eval(
        bpipe, tok, prompts, EvalRunConfig(
            out_dir=sld_dir, batch_size=len(prompts),
            num_steps=BASELINE_STEPS), generate_fn=counted))
    launches["baseline_sld"] = expect_calls(sld_calls, ["no_moe"] * 2,
                                            bcalls, "baseline sld")
    same = all(np.array_equal(a, b) for a, b in zip(
        load_uint8(sld_dir, "sd", len(prompts)),
        load_uint8(sld_dir, "removed", len(prompts))))
    check(summary["generated"] == len(prompts) and same,
          f"sld run_eval {summary}; sd_ and removed_ equal: {same}")
    print(f"baselines: load_baseline('sld') in {t_load:.2f} s; run_eval "
          f"over {len(prompts)} I2P prompts "
          f"through make_protocol_generate (sld_generate, "
          f"SLDConfig.medium(), UNet batch {3 * len(prompts)}, "
          f"{BASELINE_STEPS} steps): {summary['generated']} generated, "
          f"wall {w:.3f} s, sd_ and removed_ bit-equal (no "
          f"interventions, shared noise); launches "
          f"{launches['baseline_sld']}", flush=True)
    del bpipe
    torch.cuda.empty_cache()
    return launches, w


def run_rest_of_eval(removal, wanda_masks: dict, images: tuple,
                     card: str) -> dict:
    """Phase 18: the Qwen2-VL judge (`run_qwen_judge`), then `debias_eval`,
    `unified_editing_eval` and the baselines over phase 3's moefied SD1.5
    (its seeded weights and labels), each generate's launches of kernels
    1-4 held to its path with no plain call. Returns the launches by
    path."""
    import shutil
    import tempfile
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                build_moe_interventions,
                                                sd15_config)
    from diffusion_models_moe_tpu_torch.benchmarks.clip_metrics import (
        ConceptChecker, MemorizedPromptChecker, pooled_text_embedding)
    from diffusion_models_moe_tpu_torch.benchmarks.debias import debias_eval
    from diffusion_models_moe_tpu_torch.benchmarks.fid import \
        make_clip_featurizer
    from diffusion_models_moe_tpu_torch.benchmarks.unified_editing import (
        ConceptBank, unified_editing_eval)
    from diffusion_models_moe_tpu_torch.data.tokenizer import load_tokenizer
    from diffusion_models_moe_tpu_torch.models.clip_vision import (
        CLIPVisionConfig, CLIPVisionEncoder)
    from diffusion_models_moe_tpu_torch.ops import _build
    launches: dict = {}
    out: dict = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_rest_")
    try:
        out.update(run_qwen_judge(images, root, card))

        # ---- (c) debias_eval over the moefied SD1.5, phase 5's removal
        cfg = sd15_config(torch.bfloat16)
        pipe = StableDiffusionPipeline(cfg, device=DEV)
        pipe.init_params(torch.Generator(device=DEV).manual_seed(0))
        moe = build_moe_interventions(labels_for(cfg.unet.ff_dims()), 0.3,
                                      device=DEV, dtype=cfg.unet.dtype)
        moefied = MoefiedPipe(pipe, moe)
        tcfg = cfg.text_encoder
        write_tokenizer(os.path.join(root, "clip"), tcfg.vocab_size)
        tok = load_tokenizer(os.path.join(root, "clip"), tcfg.max_length)
        proj = torch.randn((tcfg.hidden_size, 768), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(2)
                           ) / tcfg.hidden_size ** 0.5

        def text_emb(texts):
            ids = tok(list(texts)).to(DEV)
            return pooled_text_embedding(pipe.encode_text(ids)[0].float(),
                                         ids, proj)

        vit_l = seed_judge(CLIPVisionEncoder(CLIPVisionConfig(), device=DEV),
                           1)
        man, woman = text_emb(["a photo of a man", "a photo of a woman"])
        calls = unet_calls(cfg, cfg.num_inference_steps)
        _build.reset_launch_counts()
        summary, w = judge_wall(lambda: debias_eval(
            moefied, tok, make_clip_featurizer(vit_l), man, woman,
            ivs=removal, seeds=DEBIAS_SEEDS, professions=DEBIAS_PROFESSIONS,
            num_steps=cfg.num_inference_steps,
            out_path=os.path.join(root, "debias.json")))
        kinds = (["moe"] * len(DEBIAS_SEEDS) + ["removal"] * len(DEBIAS_SEEDS)
                 ) * len(DEBIAS_PROFESSIONS)
        launches["debias"] = expect_calls(moefied.calls, kinds, calls,
                                          "debias_eval")
        for prof, r in summary["per_profession"].items():
            check(0.0 <= r["before_woman_frac"] <= 1.0
                  and 0.0 <= r["after_woman_frac"] <= 1.0,
                  f"debias {prof}: {r}")
        n_gen = len(moefied.calls)
        print(f"debias: debias_eval over {list(DEBIAS_PROFESSIONS)} x seeds "
              f"{list(DEBIAS_SEEDS)} (PNDM {cfg.num_inference_steps} steps, "
              f"CFG {cfg.guidance_scale}, one image a generate; before: MoE, "
              f"after: MoE + phase 5's removal; gender by a seeded CLIP "
              f"ViT-L/14 featurizer against the pipeline's CLIP-L text "
              f"embeddings): {n_gen} generates in {w:.3f} s "
              f"({w / n_gen:.3f} s each); {json.dumps(summary)}; launches "
              f"{launches['debias']}", flush=True)
        out["debias_s"] = w
        del vit_l

        # ---- (d) unified editing: two mask sets of phase 6, 3 prompts
        prompt_embs = text_emb(UNIFIED_PROMPTS)
        bank = ConceptBank(
            checkers={"van_gogh": MemorizedPromptChecker(UNIFIED_PROMPTS[:2]),
                      "house": ConceptChecker("house", prompt_embs[1].cpu(),
                                              prompt_embs[2].cpu())},
            masks={"van_gogh": wanda_masks["wanda_union"],
                   "house": wanda_masks["wanda_last_step"]})
        embs = prompt_embs.cpu().numpy()
        routes = bank.route(embs, list(UNIFIED_PROMPTS))
        check(routes[1] == ("house", "van_gogh") and routes[2] == (),
              f"unified editing routes {routes}")
        moefied.calls = []
        _build.reset_launch_counts()
        result, w = judge_wall(lambda: unified_editing_eval(
            moefied, tok, list(UNIFIED_PROMPTS), embs, bank,
            os.path.join(root, "unified"),
            num_steps=cfg.num_inference_steps))
        kinds = ["removal" if r else "moe" for r in routes]
        launches["unified_editing"] = expect_calls(
            moefied.calls, kinds, calls, "unified_editing_eval")
        files = sorted(os.listdir(os.path.join(root, "unified")))
        check(result["n_prompts"] == 3 and result["n_routed"] == sum(
            1 for r in routes if r) and files == sorted(
            f"{i}_{'_'.join(r) if r else 'none'}.png"
            for i, r in enumerate(routes)),
              f"unified editing result {result}, files {files}")
        print(f"unified: unified_editing_eval over {len(UNIFIED_PROMPTS)} "
              f"prompts (PNDM {cfg.num_inference_steps} steps, concepts "
              f"'van_gogh' (memorized prompts; phase 6's Wanda union over "
              f"timesteps) and 'house' (a CLIP-text checker; phase 6's last "
              f"Wanda step)): routes {routes}, files {files}, wall {w:.3f} s;"
              f" launches {launches['unified_editing']}", flush=True)
        out["unified_s"] = w

        del moefied, moe
        baseline_launches, out["baselines_s"] = run_baselines(pipe, tok, root)
        launches.update(baseline_launches)
        del pipe
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("rest: " + json.dumps(out), flush=True)
    return launches



# ------------------------------------------------------------ phase 19
TRAIN_BATCH = 4          # images a step at 512 px
TRAIN_STEPS = 5          # timed steps after one warm-up, remat off and on
TRAIN_PEAK_GIB = 70.0    # above this the no-remat step drops to batch 2
# ||grads kernels 2, 3 - grads plain|| / ||grads plain||, both bf16: within
# GRAD_FLOOR_FACTOR x the card's own gradient floor, plain bf16 against
# plain f32 on the same step (set before the first run, as the latents'
# FLOOR_FACTOR)
GRAD_FLOOR_FACTOR = 1.5


def seed_module(module, seed: int):
    """The pipelines' init scheme on `module`: weights N(0, 1/fan_in), zero
    biases, unit norm scales; drawn on the card from `seed`."""
    import torch.nn as nn
    gen = torch.Generator(device=DEV).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner = module.get_submodule(name.rpartition(".")[0])
            if name.endswith("bias"):
                p.zero_()
            elif isinstance(owner, (nn.GroupNorm, nn.LayerNorm)):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device=DEV)
                        * p[0].numel() ** -0.5)
    return module


def grads_of(unet, batch: dict, draws: dict, tcfg, use_kernels: bool) -> dict:
    """One step's gradients of every UNet parameter, in f32."""
    from diffusion_models_moe_tpu_torch.schedulers.common import NoiseTables
    from diffusion_models_moe_tpu_torch.training.train import loss_fn
    loss = loss_fn(unet, batch["latents"], batch["text_emb"], draws, tcfg,
                   NoiseTables.create(), use_kernels=use_kernels)
    loss.backward()
    out = {n: p.grad.float() for n, p in unet.named_parameters()}
    unet.zero_grad(set_to_none=True)
    return out


def grad_distance(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over every gradient."""
    num = sum(float((a[n] - b[n]).double().pow(2).sum()) for n in b)
    den = sum(float(b[n].double().pow(2).sum()) for n in b)
    return (num / den) ** 0.5


def expect_train_launches(got: dict, per_step: int, steps: int,
                          what: str, remat: bool = False) -> None:
    """Kernels 2 and 3 at `per_step` launches a step, kernel 1's plain
    version as often (its FFs have no backward kernel), the GroupNorm
    kernel's plain version at every norm of the UNet (with remat, those of
    the resblocks and Transformer2Ds twice), nothing else."""
    from diffusion_models_moe_tpu_torch.ops import _build
    want = {k: 0 for k in _build.KERNELS + _build.PLAIN}
    norms = SD15_NORMS + (SD15_NORMS - 1 if remat else 0)
    want.update({"sd_self_attention": per_step * steps,
                 "sd_cross_attention": per_step * steps,
                 "plain:geglu_ff_fused": per_step * steps,
                 "plain:group_norm_nhwc": norms * steps})
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    check(not bad, f"{what}: launches (got, expected) {bad}")


def encode_phase(pipe, card: str) -> tuple:
    """(a): seeded 512-px images and captions through the VAE encoder and
    the CLIP text encoder on the card; the encoder's f32 copy on the card
    against the same module on the CPU at 64 px within JUDGE_TOL."""
    from diffusion_models_moe_tpu_torch.data.tokenize import hash_tokenize
    from diffusion_models_moe_tpu_torch.models.layers import (cast_model,
                                                              f32_convs)
    from diffusion_models_moe_tpu_torch.models.vae import VAEEncoder
    from diffusion_models_moe_tpu_torch.training.trainer import (
        build_vae_encoder, encode_batch)
    cfg = pipe.config
    venc = build_vae_encoder(pipe)
    seed_module(venc, 19)
    n_enc = sum(p.numel() for p in venc.parameters())
    rng = np.random.RandomState(19)
    side = 8 * cfg.sample_size                     # 512 px at SD1.5
    images = rng.uniform(-1, 1, (TRAIN_BATCH, side, side, 3)).astype(
        np.float32)
    tok = hash_tokenize(cfg.text_encoder.vocab_size, cfg.text_encoder.max_length)
    ids = tok([f"a training caption number {i}" for i in range(TRAIN_BATCH)])
    gen = torch.Generator(device=DEV).manual_seed(190)
    encode_batch(pipe, venc, images[:1], ids[:1], gen)      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = encode_batch(pipe, venc, images, ids, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lat, emb = batch["latents"], batch["text_emb"]
    tc = cfg.text_encoder
    check(tuple(lat.shape) == (TRAIN_BATCH, 4, side // 8, side // 8)
          and tuple(emb.shape) == (TRAIN_BATCH, tc.max_length, tc.hidden_size)
          and bool(torch.isfinite(lat).all() and torch.isfinite(emb).all()),
          f"encode: latents {tuple(lat.shape)}, text {tuple(emb.shape)}")
    # the same weights in f32, on the card and on the CPU, at 64 px
    f32_cfg = dataclasses.replace(cfg.vae, dtype=torch.float32)
    with torch.device(DEV):
        card32 = cast_model(VAEEncoder(f32_cfg), torch.float32).eval()
    card32.load_state_dict(venc.state_dict())
    cpu32 = on_cpu(card32, lambda device: cast_model(
        VAEEncoder(f32_cfg), torch.float32).to(device).eval())
    small = torch.from_numpy(images[:1, :64, :64]).permute(0, 3, 1, 2)
    with torch.no_grad(), f32_convs():
        got = card32(small.to(DEV))
        ref = cpu32(small)
        full32 = card32(torch.from_numpy(images).permute(0, 3, 1, 2).to(DEV))
        full16 = venc(torch.from_numpy(images).permute(0, 3, 1, 2).to(DEV))
    errs = [rel_err(g.cpu(), r)[1] for g, r in zip(got, ref)]
    check(max(errs) <= JUDGE_TOL, f"encoder card vs CPU: {errs}")
    bf16_err = [rel_err(g, r)[1] for g, r in zip(full16, full32)]
    print(f"encode on {card}: VAE encoder ({n_enc} parameters, seeded) and "
          f"CLIP text encoder, {TRAIN_BATCH} images {side}x{side} -> latents "
          f"{tuple(lat.shape)}, text {tuple(emb.shape)} in {wall:.4f} s; "
          f"f32 encoder card vs CPU at 64 px (mean, logvar) rel err "
          f"{errs[0]:.3e}, {errs[1]:.3e} (limit {JUDGE_TOL}); bf16 vs f32 "
          f"on the card at {side} px {bf16_err[0]:.3e}, {bf16_err[1]:.3e}",
          flush=True)
    del card32, cpu32, venc
    return batch, wall


def timed_train_steps(unet, state, step_fn, batch: dict, seed: int) -> tuple:
    """One warm-up step, then TRAIN_STEPS timed ones, each on its own
    generator's draws: (step seconds, losses, launches of the timed steps,
    peak GiB over them)."""
    from diffusion_models_moe_tpu_torch.ops import _build
    step_fn(state, batch, generator=torch.Generator(device=DEV).manual_seed(
        seed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    secs, losses = [], []
    for i in range(TRAIN_STEPS):
        gen = torch.Generator(device=DEV).manual_seed(seed + 1 + i)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, generator=gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        check(np.isfinite(losses[-1]) and np.isfinite(
            float(metrics["grad_norm"])), f"train step {i}: {metrics}")
    return (secs, losses, dict(_build.LAUNCHES),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def train_full_width(pipe, batch: dict, card: str) -> dict:
    """(b): AdamW steps of the ReLUfied SD1.5 UNet (f32 masters, optimizer
    state and EMA; the bf16 working copy through kernels 2 and 3), remat
    off and on."""
    from diffusion_models_moe_tpu_torch.training.train import (
        TrainConfig, create_train_state, make_train_step)
    unet = pipe.unet
    n_par = sum(p.numel() for p in unet.parameters())
    tcfg = TrainConfig(learning_rate=1e-5, snr_gamma=5.0)
    state = create_train_state(unet, tcfg)
    step_fn = make_train_step(unet, tcfg)
    torch.cuda.synchronize()
    state_gib = torch.cuda.memory_allocated() / 2 ** 30
    out = {}
    b = TRAIN_BATCH
    for remat in (False, True):
        unet.cfg = dataclasses.replace(unet.cfg, remat=remat)
        part = {k: v[:b] for k, v in batch.items()}
        secs, losses, launches, peak = timed_train_steps(
            unet, state, step_fn, part, 1900 + 100 * remat)
        if not remat and peak > TRAIN_PEAK_GIB and b == TRAIN_BATCH:
            print(f"train: batch {b} without remat peaked at {peak:.2f} GiB "
                  f"(> {TRAIN_PEAK_GIB}): batch 2 from here", flush=True)
            b = 2
            part = {k: v[:b] for k, v in batch.items()}
            secs, losses, launches, peak = timed_train_steps(
                unet, state, step_fn, part, 1950)
        per_step = 16 * (2 if remat else 1)
        expect_train_launches(launches, per_step, TRAIN_STEPS,
                              f"train remat={remat}", remat)
        med = float(np.median(secs))
        what = "on" if remat else "off"
        print(f"train on {card}: sd15_config(bf16, relufied=True) UNet "
              f"({n_par} parameters), AdamW, batch {b} at "
              f"{8 * pipe.config.sample_size} px, remat "
              f"{what}: {TRAIN_STEPS} steps after a warm-up, step s median "
              f"{med:.4f} (each {[round(s, 4) for s in secs]}), peak "
              f"{peak:.2f} GiB (masters, moments, EMA and the working copy "
              f"{state_gib:.2f} GiB before the steps), loss "
              f"{[round(x, 5) for x in losses]}; launches a step: kernels 2, "
              f"3 {launches['sd_self_attention'] // TRAIN_STEPS}, "
              f"{launches['sd_cross_attention'] // TRAIN_STEPS}, kernel 1's "
              f"plain version {launches['plain:geglu_ff_fused'] // TRAIN_STEPS}",
              flush=True)
        out[f"remat_{what}"] = dict(step_s=med, peak_gib=peak, batch=b,
                                    loss=losses, launches=launches)
    unet.cfg = dataclasses.replace(unet.cfg, remat=False)
    return out


def grad_check(pipe, batch: dict, card: str) -> dict:
    """(c): one step's gradients through kernels 2 and 3 against the plain
    path's, both bf16, within GRAD_FLOOR_FACTOR x the card's floor (plain
    bf16 against plain f32, cuDNN's TF32 off)."""
    from diffusion_models_moe_tpu_torch.models.layers import (cast_model,
                                                              f32_convs)
    from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
    from diffusion_models_moe_tpu_torch.training.train import (TrainConfig,
                                                               draw_step)
    tcfg = TrainConfig(snr_gamma=5.0)
    part = {k: v[:2] for k, v in batch.items()}
    draws = draw_step(torch.Generator(device=DEV).manual_seed(1990),
                      part["latents"].shape)
    g_plain = grads_of(pipe.unet, part, draws, tcfg, use_kernels=False)
    cfg32 = dataclasses.replace(pipe.unet.cfg, dtype=torch.float32)
    with torch.device(DEV):
        unet32 = cast_model(UNet2DCondition(cfg32), torch.float32)
    unet32.load_state_dict(pipe.unet.state_dict())
    with f32_convs():
        g32 = grads_of(unet32, part, draws, tcfg, use_kernels=False)
    del unet32
    floor = grad_distance(g_plain, g32)
    g_kern = grads_of(pipe.unet, part, draws, tcfg, use_kernels=True)
    dist = grad_distance(g_kern, g_plain)
    to32 = grad_distance(g_kern, g32)
    del g_plain, g32, g_kern
    print(f"grads on {card}: one step at batch 2, every UNet gradient: "
          f"kernels 2, 3 vs plain (bf16 both) rel L2 {dist:.6f}; floor plain "
          f"bf16 vs plain f32 {floor:.6f} (limit {GRAD_FLOOR_FACTOR} x floor "
          f"= {GRAD_FLOOR_FACTOR * floor:.6f}); kernels vs f32 {to32:.6f}",
          flush=True)
    check(dist <= GRAD_FLOOR_FACTOR * floor,
          f"grads through the kernels {dist} > {GRAD_FLOOR_FACTOR} x floor "
          f"{floor}")
    return dict(grad_dist=dist, grad_floor=floor, grad_vs_f32=to32)


def tiny_training(card: str) -> dict:
    """(d): at tiny_config on the card (f32: the plain versions, no kernel
    launch), one Adafactor step, one accumulation cycle with the EMA, and a
    `train_relufied` run of 6 steps with validation images against 4, a
    checkpoint and a resume to 6, equal to the bit (cuDNN deterministic)."""
    import copy
    import tempfile
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                tiny_config)
    from diffusion_models_moe_tpu_torch.data.tokenize import hash_tokenize
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.training import train, trainer
    base = tiny_config()
    cfg = dataclasses.replace(base, unet=dataclasses.replace(
        base.unet, ff_activation="geglu-relu"))
    src = StableDiffusionPipeline(cfg, device=DEV)
    src.init_params(torch.Generator(device=DEV).manual_seed(7))
    sds = {k: copy.deepcopy(m.state_dict()) for k, m in src.modules().items()}

    def fresh():
        pipe = StableDiffusionPipeline(cfg, device=DEV)
        pipe.load_state_dicts(sds)
        return pipe

    rng = np.random.RandomState(8)
    data = [{"latents": rng.randn(2, 4, 8, 8).astype(np.float32),
             "text_emb": rng.randn(2, 16, 32).astype(np.float32)}
            for _ in range(8)]
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in data[0].items()}
    _build.reset_launch_counts()

    # one Adafactor step: its update less the decay, clipped to an RMS of 1
    # and scaled by lr x max(RMS(param), 1e-3), stays within that scale
    pipe = fresh()
    tcfg = train.TrainConfig(learning_rate=1e-3, optimizer="adafactor")
    state = train.create_train_state(pipe.unet, tcfg)
    before = {n: t.clone() for n, t in state.params.items()}
    state, m = train.make_train_step(pipe.unet, tcfg)(
        state, batch, generator=torch.Generator(device=DEV).manual_seed(1))
    worst = 0.0
    for n, p in state.params.items():
        step_rms = float((before[n] - p - tcfg.weight_decay * before[n])
                         .pow(2).mean().sqrt())
        scale = tcfg.learning_rate * max(
            float(before[n].pow(2).mean().sqrt()), 1e-3)
        worst = max(worst, step_rms / scale)
    check(state.opt_state["count"] == 1 and np.isfinite(float(m["loss"]))
          and 0.0 < worst <= 1.0 + 1e-3,
          f"adafactor step: {m}, largest RMS / scale {worst}")

    # one accumulation cycle of 2 with the EMA
    pipe = fresh()
    tcfg = train.TrainConfig(learning_rate=1e-3, grad_accum_steps=2,
                             ema_decay=0.5)
    state = train.create_train_state(pipe.unet, tcfg)
    step = train.make_train_step(pipe.unet, tcfg)
    before = {n: t.clone() for n, t in state.params.items()}
    state, _ = step(state, batch, generator=torch.Generator(
        device=DEV).manual_seed(2))
    held = all(torch.equal(state.params[n], t) and torch.equal(
        state.ema_params[n], t) for n, t in before.items())
    state, _ = step(state, batch, generator=torch.Generator(
        device=DEV).manual_seed(3))
    ema_err = max(float((state.ema_params[n] - (0.5 * t + 0.5 * state.params[
        n])).abs().max()) for n, t in before.items())
    moved = sum(not torch.equal(state.params[n], t) for n, t in before.items())
    check(held and moved == len(before) and ema_err <= 1e-6
          and state.opt_state["count"] == 1,
          f"accumulation: held {held}, moved {moved}/{len(before)}, EMA err "
          f"{ema_err}")

    # the loop: 6 steps against 4 + resume to 6
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tcfg = train.TrainConfig(learning_rate=1e-3, snr_gamma=5.0, ema_decay=0.9)
    tok = hash_tokenize(cfg.text_encoder.vocab_size, cfg.text_encoder.max_length)
    try:
        with tempfile.TemporaryDirectory() as root:
            pipe_a = fresh()
            val = trainer.make_validation_logger(
                pipe_a, tok, ["a dog"], os.path.join(root, "val"), num_steps=2)
            t0 = time.perf_counter()
            full = trainer.train_relufied(
                pipe_a, tcfg, trainer.RunConfig(
                    os.path.join(root, "a"), max_steps=6, checkpoint_every=4,
                    log_every=1, validation_every=3),
                iter(data), validation_fn=val)
            wall_a = time.perf_counter() - t0
            run = trainer.RunConfig(os.path.join(root, "b"), max_steps=4,
                                    checkpoint_every=4, log_every=1)
            trainer.train_relufied(fresh(), tcfg, run, iter(data))
            resumed = trainer.train_relufied(
                fresh(), tcfg, dataclasses.replace(run, max_steps=6), data)
            labels = train.checkpoint_steps(os.path.join(root, "b",
                                                         "checkpoints"))
            pngs = sorted(os.listdir(os.path.join(root, "val")))
    finally:
        torch.backends.cudnn.deterministic = det
    same = all(torch.equal(full.params[n], resumed.params[n])
               and torch.equal(full.ema_params[n], resumed.ema_params[n])
               and torch.equal(full.opt_state["mu"][n], resumed.opt_state[
                   "mu"][n]) for n in full.params)
    launched = {k: _build.LAUNCHES[k] for k in _build.KERNELS
                if _build.LAUNCHES[k]}
    print(f"tiny training on {card}: Adafactor step (largest update RMS / "
          f"scale {worst:.4f}); accumulation of 2 held then applied (EMA err "
          f"{ema_err:.2e}); train_relufied 6 steps with validation at step 3 "
          f"({len(pngs)} files) in {wall_a:.2f} s; 4 + resume to 6: labels "
          f"{labels}, masters, EMA and moments bit-equal {same}; kernels "
          f"launched {launched or 'none'}", flush=True)
    check(same and labels == [4, 6] and full.step == resumed.step == 6
          and "val_step000003_0.png" in pngs and not launched,
          "tiny train_relufied: resume not bit-equal, or labels "
          f"{labels}, or files {pngs}, or kernels {launched}")
    return dict(resume_bit_equal=same)


def run_training(card: str) -> dict:
    """Phase 19: encode (a), train at full width with remat off and on (b),
    the gradient check (c), the tiny Adafactor, accumulation and resume
    runs (d)."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                sd15_config)
    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline(sd15_config(torch.bfloat16, relufied=True),
                                   device=DEV)
    pipe.init_params(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    print(f"training: ReLUfied SD1.5 bf16 pipeline built with seeded random "
          f"weights in {time.perf_counter() - t0:.1f} s", flush=True)
    batch, enc_wall = encode_phase(pipe, card)
    out = {"encode_s": enc_wall}
    out.update(train_full_width(pipe, batch, card))
    out.update(grad_check(pipe, batch, card))
    del pipe
    torch.cuda.empty_cache()
    out.update(tiny_training(card))
    return out


# ------------------------------------------------------------ phase 20
PAR_TP_STEPS = 3         # the tp=2 generate's PNDM steps: the 3-step floor
PAR_DEADLINE_S = 480.0   # the two spawned ranks of (b) and (c) end by then
PAR_TRAIN_SEED = 2000    # the step generator of (c)'s AdamW steps
# (c): the dp=2 step's reduced gradients against the mean of the same two
# halves' gradients computed in one process: the same bf16 products, so
# only the f32 sum's order may differ (rel L2)
PAR_EXACT = 1e-6


def moefied_sd15():
    """Phase 3's moefied SD1.5 (bf16, seeded weights and expert labels)
    and its 2 requests' token ids."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                build_moe_interventions,
                                                sd15_config)
    cfg = sd15_config(torch.bfloat16)
    pipe = StableDiffusionPipeline(cfg, device=DEV)
    pipe.init_params(torch.Generator(device=DEV).manual_seed(0))
    ivs = build_moe_interventions(labels_for(cfg.unet.ff_dims()), 0.3,
                                  device=DEV, dtype=cfg.unet.dtype)
    tcfg = cfg.text_encoder
    cond = torch.randint(0, tcfg.vocab_size, (BATCH, tcfg.max_length),
                         generator=torch.Generator().manual_seed(1)).to(DEV)
    return pipe, ivs, cond, torch.zeros_like(cond)


def relufied_sd15():
    """Phase 19's ReLUfied SD1.5 (bf16, seeded) and a seeded batch of
    TRAIN_BATCH latents and text states."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                sd15_config)
    pipe = StableDiffusionPipeline(sd15_config(torch.bfloat16, relufied=True),
                                   device=DEV)
    pipe.init_params(torch.Generator(device=DEV).manual_seed(0))
    gen = torch.Generator(device=DEV).manual_seed(20)
    s, tc = pipe.config.sample_size, pipe.config.text_encoder
    batch = {"latents": torch.randn((TRAIN_BATCH, 4, s, s), generator=gen,
                                    device=DEV),
             "text_emb": torch.randn((TRAIN_BATCH, tc.max_length,
                                      tc.hidden_size), generator=gen,
                                     device=DEV).to(torch.bfloat16)}
    return pipe, batch


def par_train_config(**kw):
    """Phase 20's AdamW (EMA off)."""
    from diffusion_models_moe_tpu_torch.training.train import TrainConfig
    return TrainConfig(learning_rate=1e-5, snr_gamma=5.0, use_ema=False, **kw)


def adamw_step(unet, batch: dict, mesh=None, tcfg=None) -> tuple:
    """One AdamW step (`par_train_config()` unless `tcfg`) from the UNet's
    weights on PAR_TRAIN_SEED's draws: (state, metrics, launches, wall s,
    peak GiB)."""
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.training.train import (
        create_train_state, make_train_step)
    tcfg = tcfg or par_train_config()
    state = create_train_state(unet, tcfg)
    step = make_train_step(unet, tcfg, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, batch, generator=torch.Generator(
        device=DEV).manual_seed(PAR_TRAIN_SEED))
    torch.cuda.synchronize()
    return (state, {k: float(v) for k, v in metrics.items()},
            dict(_build.LAUNCHES), time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def parallel_rank(rank: int, root: str) -> None:
    """A rank of phase 20 (b) and (c) at world size 2 over gloo on the one
    card (a spawned process): (b) the moefied SD1.5's 2 requests at dp=2
    (50 steps) and at tp=2 (PAR_TP_STEPS steps, latents); (c) an AdamW
    step of the ReLUfied SD1.5 at dp=2, 2 a rank, unclipped, so that its
    first moments are (1 - b1) x the reduced gradients. Rank 0 first
    computes, in its own process with cuDNN deterministic as the step: the
    two halves' gradients (the ranks' own work) and their mean, the
    gradients of the whole batch at TRAIN_BATCH in bf16 and in an f32 copy
    (the card's floor on these inputs). Writes its numbers to
    `root/rank{rank}.pt`; the parent checks them."""
    import torch.distributed as dist
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.parallel.distributed import \
        init_multihost
    from diffusion_models_moe_tpu_torch.parallel.mesh import create_mesh
    torch.cuda.set_device(0)
    init_multihost(f"file://{root}/ws2_store", 2, rank, backend="gloo")
    _build.load_library()
    ref = torch.load(os.path.join(root, "ws1.pt"), map_location=DEV)
    out = {"rank": rank, "backend": dist.get_backend()}
    try:
        pipe, ivs, cond, uncond = moefied_sd15()
        for what, mesh, kw in (
                ("dp", create_mesh(2, dp=2), {}),
                ("tp", create_mesh(2, tp=2),
                 dict(num_steps=PAR_TP_STEPS, decode=False))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            got, _ = pipe.generate(cond, uncond, torch.Generator(
                device=DEV).manual_seed(3), ivs=ivs, mesh=mesh, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            want = ref["images" if what == "dp" else "z3"]
            out[what] = dict(
                wall_s=wall, launches=dict(_build.LAUNCHES),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                rel=((got.float() - want).norm() / want.norm()).item(),
                bit_equal=bool(torch.equal(got.float(), want)),
                shape=tuple(got.shape),
                finite=bool(torch.isfinite(got).all()))
        out["tp"]["heads"] = sorted({m.heads for m in pipe.unet.modules()
                                     if type(m).__name__ == "Attention"})
        del pipe, ivs
        torch.cuda.empty_cache()

        pipe, batch = relufied_sd15()
        unet = pipe.unet
        tcfg = par_train_config(max_grad_norm=float("inf"))
        torch.backends.cudnn.deterministic = True
        if rank == 0:       # world size 1: the halves, the whole batch, f32
            out["train_ws1"] = world_one_grads(unet, batch, tcfg)
            g_mean = out["train_ws1"].pop("g_mean")
            g_whole = out["train_ws1"].pop("g_whole")
            torch.cuda.empty_cache()
        dist.barrier()
        state, m, launches, wall, peak = adamw_step(
            unet, batch, create_mesh(2, dp=2), tcfg)
        out["train_dp"] = dict(metrics=m, wall_s=wall, peak_gib=peak,
                               launches=launches)
        if rank == 0:
            # the step's first moment is 0 x b1 + (1 - b1) g, g reduced
            b1 = tcfg.adam_b1
            mu = state.opt_state["mu"]
            want = {n: torch.zeros_like(g).mul_(b1).add_(g, alpha=1.0 - b1)
                    for n, g in g_mean.items()}
            out["train_dp"].update(
                mean_dist=grad_distance(mu, want),
                mean_bit_equal=all(torch.equal(mu[n], t)
                                   for n, t in want.items()),
                whole_dist=grad_distance(
                    {n: t / (1.0 - b1) for n, t in mu.items()}, g_whole))
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def world_one_grads(unet, batch: dict, tcfg) -> dict:
    """Phase 20 (c) at world size 1, on `unet` in this process: the
    gradients of each half of the batch (what each dp rank computes) and
    their mean, those of the whole batch (bf16, kernels 2 and 3) and of its
    f32 copy (plain versions, TF32 off): {"g_mean", "g_whole", "whole_floor"
    (bf16 against f32 on these inputs), "mean_vs_whole"}."""
    import dataclasses as dc

    from diffusion_models_moe_tpu_torch.models.layers import (cast_model,
                                                              f32_convs)
    from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
    from diffusion_models_moe_tpu_torch.training.train import draw_step
    draws = draw_step(torch.Generator(device=DEV).manual_seed(PAR_TRAIN_SEED),
                      batch["latents"].shape)
    b = TRAIN_BATCH // 2
    halves = [grads_of(unet, {k: v[sl] for k, v in batch.items()},
                       {k: v[sl] for k, v in draws.items()}, tcfg, True)
              for sl in (slice(0, b), slice(b, 2 * b))]
    g_mean = {n: (g + halves[1][n]) / 2 for n, g in halves[0].items()}
    del halves
    g_whole = grads_of(unet, batch, draws, tcfg, True)
    with torch.device(DEV):
        unet32 = cast_model(UNet2DCondition(dc.replace(
            unet.cfg, dtype=torch.float32)), torch.float32)
    unet32.load_state_dict(unet.state_dict())
    with f32_convs():
        g32 = grads_of(unet32, {k: v.float() for k, v in batch.items()},
                       draws, tcfg, False)
    del unet32
    out = dict(g_mean=g_mean, g_whole=g_whole,
               whole_floor=grad_distance(g_whole, g32),
               mean_vs_whole=grad_distance(g_mean, g_whole))
    del g32
    return out


def run_ranks(target, root: str, nprocs: int = 2) -> list:
    """`target(rank, root)` in `nprocs` spawned processes, joined within
    PAR_DEADLINE_S (killed and failed after it); each rank's numbers."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(target, args=(root,), nprocs=nprocs,
                             join=False, start_method="spawn")
    end = time.monotonic() + PAR_DEADLINE_S
    while not ctx.join(timeout=5.0):
        if time.monotonic() > end:
            for p in ctx.processes:
                p.kill()
            check(False, f"ranks still running after {PAR_DEADLINE_S} s")
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(nprocs)]


def run_parallel(card: str, floors: dict, grad_floor: float) -> dict:
    """Phase 20: (a) world size 1 over NCCL: `init_multihost()` alone is a
    no-op, then a group of one; `create_mesh()` is dp = tp = 1;
    `generate(mesh=)` of the moefied SD1.5 (2 requests, 50 PNDM steps, CFG
    7.5) bit-equal to `generate()`, kernels 1-3 at 816 launches each and no
    plain call; one AdamW step of the ReLUfied SD1.5 at batch TRAIN_BATCH
    with the mesh against one without, cuDNN deterministic. (b), (c): two
    ranks on the card over gloo (`parallel_rank`), held here: dp=2's
    images within the 50-step floor of (a)'s, tp=2's latents within
    FLOOR_FACTOR x the 3-step floor of (a)'s, kernels 2-4 at 4 heads on
    every call, kernel 1 not taken (counted tp:), no plain call; the dp=2
    step's reduced gradients within GRAD_FLOOR_FACTOR x phase 19's
    gradient floor of world size 1's."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.parallel.distributed import (
        init_multihost, is_coordinator)
    from diffusion_models_moe_tpu_torch.parallel.mesh import create_mesh
    from diffusion_models_moe_tpu_torch import sd15_config
    sd_cfg = sd15_config(torch.bfloat16)
    root = tempfile.mkdtemp(prefix="dmoe_parallel_")
    out = {"launches": {}}
    try:
        # (a) world size 1 over NCCL
        alone = init_multihost()
        check(alone["process_count"] == 1 and not dist.is_initialized(),
              f"init_multihost in one process: {alone}")
        info = init_multihost(f"file://{root}/ws1_store", 1, 0)
        mesh = create_mesh()
        check(dist.get_backend() == "nccl" and mesh.shape == {"dp": 1, "tp": 1}
              and is_coordinator(),
              f"world size 1: backend {dist.get_backend()}, mesh {mesh}")
        pipe, ivs, cond, uncond = moefied_sd15()
        pipe.generate(cond, uncond, torch.Generator(device=DEV).manual_seed(2),
                      num_steps=1, ivs=ivs)                   # warm-up
        calls = unet_calls(pipe.config, pipe.config.num_inference_steps)
        imgs, walls = {}, {}
        for what, kw in (("plain_call", {}), ("mesh", {"mesh": mesh})):
            _build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs[what], _ = pipe.generate(
                cond, uncond, torch.Generator(device=DEV).manual_seed(3),
                ivs=ivs, **kw)
            torch.cuda.synchronize()
            walls[what] = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            for k in ("geglu_ff_fused", "sd_self_attention",
                      "sd_cross_attention"):
                check(launches[k] == 16 * calls,
                      f"world size 1 {what}: {k} {launches[k]} launches")
            check_no_plain(launches, f"world size 1 {what}")
        out["launches"]["ws1"] = launches
        same = bool(torch.equal(imgs["mesh"], imgs["plain_call"]))
        z3, _ = pipe.generate(cond, uncond, torch.Generator(
            device=DEV).manual_seed(3), num_steps=PAR_TP_STEPS, ivs=ivs,
            decode=False, mesh=mesh)
        torch.save({"images": imgs["mesh"].float().cpu(),
                    "z3": z3.float().cpu()}, os.path.join(root, "ws1.pt"))
        print(f"parallel (a) on {card}: init_multihost() alone {alone}; "
              f"over NCCL at world size 1 {info}, mesh {mesh.shape}; "
              f"generate(mesh=) of {BATCH} requests, 50 PNDM steps, CFG "
              f"7.5, MoE on 16 FFs: bit-equal to generate() {same}, walls "
              f"{walls['mesh']:.3f} s (mesh) and {walls['plain_call']:.3f} s; "
              f"kernels 1-3 at {16 * calls} launches each, no plain call",
              flush=True)
        check(same, "world size 1: generate(mesh=) is not generate()")
        del pipe, ivs, imgs, z3
        torch.cuda.empty_cache()

        pipe, batch = relufied_sd15()
        own = {n: p.detach().clone() for n, p in pipe.unet.named_parameters()}
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            st0, m0, _, wall0, _ = adamw_step(pipe.unet, batch)
            keep = {k: {n: t.clone() for n, t in d.items()}
                    for k, d in (("params", st0.params),
                                 ("mu", st0.opt_state["mu"]))}
            del st0
            with torch.no_grad():
                for n, p in pipe.unet.named_parameters():
                    p.copy_(own[n])
            st1, m1, launches, wall1, peak = adamw_step(pipe.unet, batch,
                                                        mesh)
        finally:
            torch.backends.cudnn.deterministic = det
        train_same = m0 == m1 and all(
            torch.equal(st1.params[n], t) for n, t in keep["params"].items()
        ) and all(torch.equal(st1.opt_state["mu"][n], t)
                  for n, t in keep["mu"].items())
        dist_ws1 = grad_distance(st1.opt_state["mu"], keep["mu"])
        print(f"parallel (a) training on {card}: one AdamW step of the "
              f"ReLUfied SD1.5 at batch {TRAIN_BATCH}, mesh dp=tp=1 over NCCL "
              f"against no mesh (cuDNN deterministic): masters, first moments "
              f"and metrics bit-equal {train_same} (first moments rel L2 "
              f"{dist_ws1:.3e}); loss {m1['loss']:.6f}, grad norm "
              f"{m1['grad_norm']:.4f}; walls {wall0:.3f} s and {wall1:.3f} s, "
              f"peak {peak:.2f} GiB", flush=True)
        check(train_same, f"world size 1 train step with a mesh is not the "
              f"step without one (rel L2 {dist_ws1})")
        del pipe, batch, own, keep, st1
        torch.cuda.empty_cache()
        dist.destroy_process_group()

        # (b), (c) world size 2 over gloo on the one card
        t0 = time.perf_counter()
        ranks = run_ranks(parallel_rank, root)
        wall = time.perf_counter() - t0
        r0 = ranks[0]
        for r in ranks:
            print(f"parallel (b) rank {r['rank']} ({r['backend']}): dp=2 "
                  f"generate {r['dp']['wall_s']:.3f} s, peak "
                  f"{r['dp']['peak_gib']:.2f} GiB, images rel L2 to world "
                  f"size 1 {r['dp']['rel']:.6f} (bit-equal "
                  f"{r['dp']['bit_equal']}); tp=2 generate {PAR_TP_STEPS} "
                  f"steps {r['tp']['wall_s']:.3f} s, peak "
                  f"{r['tp']['peak_gib']:.2f} GiB, latents rel L2 "
                  f"{r['tp']['rel']:.6f}; (c) dp=2 AdamW step "
                  f"{r['train_dp']['wall_s']:.3f} s, peak "
                  f"{r['train_dp']['peak_gib']:.2f} GiB", flush=True)
        tp_l, dp_l = r0["tp"]["launches"], r0["dp"]["launches"]
        tp_calls = unet_calls(sd_cfg, PAR_TP_STEPS)
        print(f"parallel (b) on {card}: 2 ranks over gloo in {wall:.1f} s; "
              f"tp=2 heads a rank {r0['tp']['heads']}, launches (rank 0) "
              f"{ {k: v for k, v in tp_l.items() if v} }; dp=2 launches "
              f"(rank 0) { {k: v for k, v in dp_l.items() if v} }; limits: "
              f"dp images <= floor {floors[50]:.6f}, tp latents <= "
              f"{FLOOR_FACTOR} x floor {floors[3]:.6f}", flush=True)
        for r in ranks:
            check(r["dp"]["finite"] and r["tp"]["finite"]
                  and r["dp"]["rel"] <= floors[50]
                  and r["tp"]["rel"] <= FLOOR_FACTOR * floors[3],
                  f"rank {r['rank']}: dp rel {r['dp']['rel']}, tp rel "
                  f"{r['tp']['rel']}")
        want = {k: 0 for k in _build.KERNELS + _build.PLAIN + _build.TP}
        want.update({k: 16 * tp_calls for k in (
            "sd_self_attention", "sd_cross_attention", "fused_route_multiply",
            "tp:geglu_ff_fused")})
        want["group_norm_nhwc"] = SD15_NORMS * tp_calls   # latents, no decode
        bad = {k: (tp_l[k], v) for k, v in want.items() if tp_l[k] != v}
        check(not bad and r0["tp"]["heads"] == [4],
              f"tp=2 launches (got, expected) {bad}, heads {r0['tp']['heads']}")
        calls = unet_calls(sd_cfg, sd_cfg.num_inference_steps)
        for k in ("geglu_ff_fused", "sd_self_attention", "sd_cross_attention"):
            check(dp_l[k] == 16 * calls, f"dp=2: {k} {dp_l[k]} launches")
        check_no_plain(dp_l, "dp=2 generate")
        tr, ws1 = r0["train_dp"], r0["train_ws1"]
        print(f"parallel (c) on {card}: AdamW step of the ReLUfied SD1.5, "
              f"dp=2 over gloo ({TRAIN_BATCH // 2} a rank), unclipped: its "
              f"reduced gradients against the mean of the two halves' "
              f"gradients in one process rel L2 {tr['mean_dist']:.3e} "
              f"(bit-equal {tr['mean_bit_equal']}, limit {PAR_EXACT}); "
              f"against the whole batch of {TRAIN_BATCH} in one process "
              f"{tr['whole_dist']:.6f} (the halves' mean against it "
              f"{ws1['mean_vs_whole']:.6f}); the card's floor on these "
              f"inputs (bf16 against f32, batch {TRAIN_BATCH}) "
              f"{ws1['whole_floor']:.6f}, limit {GRAD_FLOOR_FACTOR} x it; "
              f"phase 19's floor {grad_floor:.6f}; loss "
              f"{tr['metrics']['loss']:.6f}", flush=True)
        check(tr["mean_dist"] <= PAR_EXACT,
              f"dp=2 reduced gradients {tr['mean_dist']} from the halves' "
              f"mean")
        check(tr["whole_dist"] <= GRAD_FLOOR_FACTOR * ws1["whole_floor"],
              f"dp=2 gradients {tr['whole_dist']} > {GRAD_FLOOR_FACTOR} x "
              f"floor {ws1['whole_floor']}")
        expect_train_launches(tr["launches"], 16, 1, "dp=2 train step")
        out["launches"].update(tp=tp_l, dp=dp_l, train_dp=tr["launches"])
        out.update(ranks=ranks, ws2_wall_s=wall)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    return out


# ------------------------------------------------------------ phase 21
CLI_STEPS = 10             # PNDM steps of (b), (e)'s int8 and Winograd legs, (g)
CLI_PROMPT = "a house in the style of Van Gogh"
CLI_SEED = 7
CLI_REQUESTS = ["0\ta photo of a dog", "1\ta house in the style of Van Gogh",
                "2\ta photo of a cat"]
CLI_TRAIN_IMAGES = 4       # 512-px images of (f)'s imagefolder


def cli_call(argv: list, what: str, stdin_lines=None, env=None) -> dict:
    """One `cli.main(argv)` in this process: its return value, what it
    printed, the kernels' launch counts over the whole command, its wall
    time and peak device memory. `stdin_lines` feed `serve`; `env` is set
    for the call alone."""
    import contextlib
    import io
    from diffusion_models_moe_tpu_torch import cli
    from diffusion_models_moe_tpu_torch.ops import _build
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    stdin, out = sys.stdin, io.StringIO()
    if stdin_lines is not None:
        sys.stdin = io.StringIO("".join(line + "\n" for line in stdin_lines))
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            ret = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        sys.stdin = stdin
        for k, v in saved.items():
            (os.environ.pop(k, None) if v is None
             else os.environ.__setitem__(k, v))
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lines = out.getvalue().strip().splitlines()
    print(f"cli {what}: wall {wall:.3f} s, peak memory {peak:.2f} GiB, "
          f"launches {json.dumps({k: v for k, v in launches.items() if v})}; "
          f"last line {lines[-1][:300] if lines else ''}", flush=True)
    torch.cuda.empty_cache()
    return {"ret": ret, "lines": lines, "launches": launches, "wall": wall,
            "peak_gib": peak}


def expect_launches(launches: dict, expect: dict, what: str) -> None:
    for name, count in expect.items():
        check(launches[name] == count, f"{what}: kernel {name} launched "
              f"{launches[name]} times, expected {count}")
    check_no_plain(launches, what)


def write_imagefolder(root: str, n: int, side: int) -> None:
    """`n` seeded `side`-px RGB PNGs with a metadata.csv of captions."""
    import csv
    from PIL import Image
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(21)
    with open(os.path.join(root, "metadata.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "text"])
        w.writeheader()
        for i in range(n):
            Image.fromarray(rng.randint(0, 256, (side, side, 3), np.uint8)
                            ).save(os.path.join(root, f"img_{i}.png"))
            w.writerow({"file_name": f"img_{i}.png",
                        "text": f"a training caption number {i}"})


def snapshot_pipeline(snap: str, dtype):
    """An SD1.5 pipeline in `dtype` on the card with the snapshot's weights,
    and its tokenizer, built from the library alone (no CLI code)."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                sd15_config)
    from diffusion_models_moe_tpu_torch.data.tokenizer import load_tokenizer
    from diffusion_models_moe_tpu_torch.weights.port import \
        load_pipeline_snapshot
    cfg = sd15_config(dtype)
    pipe = StableDiffusionPipeline(cfg, device=DEV)
    pipe.load_state_dicts(load_pipeline_snapshot(snap, cfg))
    return pipe, load_tokenizer(os.path.join(snap, "tokenizer"),
                                cfg.text_encoder.max_length)


def png_pixels(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def run_cli(card: str, floor50=None) -> dict:
    """Phase 21: the front door. The seeded SD1.5 weights written as a
    diffusers snapshot, then each command through `cli.main` in this
    process: (a) check-snapshot --deep; (b) parity-run at CLI_STEPS over 2
    prompt pairs, its bake gap held to FLOOR_FACTOR x the bf16-vs-f32 floor
    of the dynamic removal at CLI_STEPS; (c) a 50-step generate on (b)'s
    labels, its PNG bit-equal to the library generate's; (d) the same generate through `python -m
    diffusion_models_moe_tpu_torch.cli` in a subprocess; (e) serve over 3
    stdin requests at batch 2, then --int8 and DMOE_WINO_FUSED=1 --winograd
    legs; (f) train 2 steps on a 512-px imagefolder and a resume; (g)
    `profiling.profile_generate` over the pipeline `_load_pipe` builds,
    its attention kernels counted in the trace as `_build.LAUNCHES` counts
    them. `floor50`: phase 4's 50-step bf16-vs-f32 floor, (d)'s limit is
    FLOOR_FACTOR x it. Returns the launch counts by command."""
    import argparse
    import re
    import tempfile
    from diffusion_models_moe_tpu_torch import (build_moe_interventions, cli,
                                                profiling, sd15_config)
    from diffusion_models_moe_tpu_torch.moefication.moefy import load_labels
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import \
        to_pil
    calls = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        snap = os.path.join(root, "snapshot")
        mem = seeded_pipeline()
        t0 = time.perf_counter()
        nbytes = write_snapshot(mem, snap)
        del mem
        torch.cuda.empty_cache()
        print(f"cli: seeded SD1.5 snapshot in f32, {nbytes} bytes written in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)

        # (a) the snapshot doctor, every reader run
        a = cli_call(["check-snapshot", "--snapshot", snap, "--deep"],
                     "(a) check-snapshot --deep")
        rep = a["ret"]
        comps = rep["components"]
        check(rep["ok"] and all(comps[c].get("port_ok") for c in (
            "unet", "text_encoder", "vae", "vae_encoder")),
            f"(a) check-snapshot: {json.dumps(rep)[:2000]}")
        print("cli (a): " + json.dumps({c: {k: v for k, v in e.items()
                                            if k not in ("missing_keys",
                                                         "unexpected_keys")}
                                        for c, e in comps.items()}),
              flush=True)

        # (b) the acceptance flow at CLI_STEPS; its generates, each
        # 16 x (CLI_STEPS + 1) launches of what it runs: the routing smoke
        # (taps: unfused FF, kernels 2 and 3), 4 Wanda tapped generates
        # (kernels 2 and 3), run_eval's baseline (kernels 1-3) and erased
        # generate (W2 masks: unfused FF, kernels 2 and 3), the bake check's
        # dynamic generate (W2-masked: kernels 2 and 3) and its baked one,
        # bare (kernels 1-3)
        per = 16 * (CLI_STEPS + 1)
        n_pairs = 2
        attn = per * (1 + 2 * n_pairs + 2 + 2)
        expect_b = {"geglu_ff_fused": 2 * per, "sd_self_attention": attn,
                    "sd_cross_attention": attn, "fused_route_multiply": 0}
        print(f"cli (b) expected launches {expect_b}", flush=True)
        out_b = os.path.join(root, "parity")
        b = cli_call(["parity-run", "--snapshot", snap, "--out-dir", out_b,
                      "--concept", "Van Gogh", "--limit", str(n_pairs),
                      "--steps", str(CLI_STEPS), "--batch", "2"],
                     "(b) parity-run")
        bake = b["ret"]["bake"]
        expect_launches(b["launches"], expect_b, "(b) parity-run")
        # the baked weights run bare on kernel 1, the dynamic removal on the
        # unfused FF: their gap is held to the card's bf16-vs-f32 floor of
        # the dynamic removal on the same snapshot, prompt and noise
        from diffusion_models_moe_tpu_torch.erasure.masks import (
            load_masks, union_over_timesteps, wanda_removal_interventions)
        ref, tok = snapshot_pipeline(snap, torch.bfloat16)
        ref32, _ = snapshot_pipeline(snap, torch.float32)
        static = union_over_timesteps(
            load_masks(os.path.join(out_b, "wanda_masks.npz")),
            bake["union_ratio"])
        cond0 = tok(["a painting in the style of Van Gogh"])
        zeros0 = torch.zeros_like(cond0)
        ctx = torch.cat([ref.encode_text(zeros0)[0], ref.encode_text(cond0)[0]])
        ctx32 = torch.cat([ref32.encode_text(zeros0)[0],
                           ref32.encode_text(cond0)[0]])
        lat = ref.start_latents(1, None, [b["ret"]["seed"] + 1], CLI_STEPS)[0]
        _, floor_b, _ = kernels_vs_plain(
            ref, ref32, ctx, ctx32, lat, CLI_STEPS, ref.config.guidance_scale,
            wanda_removal_interventions(static, device=DEV),
            "(b) the dynamic removal")
        del ref32, ctx, ctx32, lat, static
        torch.cuda.empty_cache()
        print(f"cli (b): moefy {b['ret']['moefy']['experts_per_layer']}, "
              f"{b['ret']['moefy']['routing_active_experts_l0']} experts "
              f"active in layer 0; wanda {b['ret']['wanda']}; eval "
              f"{b['ret']['eval']}; bake: baked (bare, kernel 1) vs dynamic "
              f"(unfused FF) rel L2 {bake['bake_vs_dynamic_rel']:.6f}, limit "
              f"{FLOOR_FACTOR} x the {CLI_STEPS}-step floor {floor_b:.6f}; "
              f"max |baked - dynamic| {bake['bake_vs_dynamic_max_abs']:.6f}, "
              f"JAX's bf16 rule (< 0.1) parity_ok {bake['parity_ok']}; scores "
              f"{b['ret']['scores']}", flush=True)
        check(bake["bake_vs_dynamic_rel"] <= FLOOR_FACTOR * floor_b,
              f"(b) parity-run bake: rel {bake['bake_vs_dynamic_rel']} > "
              f"{FLOOR_FACTOR} x floor {floor_b}")
        calls["parity_run"] = b
        labels_path = os.path.join(out_b, "labels.npz")

        # (c) generate at the config's 50 steps on (b)'s labels
        png_c = os.path.join(root, "generate_c.png")
        gen_argv = ["generate", "--snapshot", snap, "--labels", labels_path,
                    "--prompt", CLI_PROMPT, "--seed", str(CLI_SEED)]
        c = cli_call(gen_argv + ["--out", png_c], "(c) generate")
        full = 16 * 51
        expect_launches(c["launches"], {
            "geglu_ff_fused": full, "sd_self_attention": full,
            "sd_cross_attention": full, "fused_route_multiply": 0},
            "(c) generate")
        calls["generate"] = c
        # the library generate on the same snapshot, seed and labels,
        # built without the CLI's code
        ivs = build_moe_interventions(load_labels(labels_path), 0.3,
                                      device=DEV, dtype=torch.bfloat16)
        images, _ = ref.generate(tok([CLI_PROMPT]), tok([""]),
                                 seeds=[CLI_SEED], ivs=ivs)
        lib = np.asarray(to_pil(images)[0])
        del ref, images
        torch.cuda.empty_cache()
        got_c = png_pixels(png_c)
        check(np.array_equal(got_c, lib), "(c) the CLI's PNG differs from "
              f"the library generate's: max |diff| "
              f"{np.abs(got_c.astype(int) - lib).max()}")
        print("cli (c): PNG bit-equal to the library generate on the same "
              "snapshot, seed and labels: True", flush=True)

        # (d) the same generate through `python -m`, the build reused
        png_d = os.path.join(root, "generate_d.png")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "diffusion_models_moe_tpu_torch.cli",
             *gen_argv, "--out", png_d], cwd=ROOT, capture_output=True,
            text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=ROOT))
        wall_d = time.perf_counter() - t0
        check(proc.returncode == 0, f"(d) python -m cli: rc {proc.returncode}"
              f" {proc.stderr[-2000:]}")
        got_d = png_pixels(png_d)
        same = np.array_equal(got_d, got_c)
        rel = float(np.linalg.norm(got_d.astype(np.float64) - got_c)
                    / np.linalg.norm(got_c.astype(np.float64)))
        limit = None if floor50 is None else FLOOR_FACTOR * floor50
        print(f"cli (d): python -m diffusion_models_moe_tpu_torch.cli "
              f"generate in a subprocess: wall {wall_d:.3f} s (process start, "
              f"import, snapshot read, 50 steps); PNG bit-equal to (c)'s: "
              f"{same}; rel L2 {rel:.6f} (limit {limit})", flush=True)
        check(same or (limit is not None and rel <= limit),
              f"(d) the subprocess PNG is {rel} from (c)'s (limit {limit})")

        # (e) the serving loop: 3 requests at batch 2, then the int8 and
        # fused-Winograd legs on 2 requests each
        e = cli_call(["serve", "--snapshot", snap, "--labels", labels_path,
                      "--batch", "2", "--max-wait-ms", "500", "--out-dir",
                      os.path.join(root, "served")], "(e) serve",
                     stdin_lines=CLI_REQUESTS)
        summary = json.loads(e["lines"][-1])
        check(summary["served"] == 3 and summary["batches"] == 2,
              f"(e) serve: {summary}")
        expect_launches(e["launches"], {
            "geglu_ff_fused": 2 * full, "sd_self_attention": 2 * full,
            "sd_cross_attention": 2 * full, "fused_route_multiply": 0},
            "(e) serve")
        calls["serve"] = e
        e8 = cli_call(["serve", "--snapshot", snap, "--labels", labels_path,
                       "--batch", "2", "--max-wait-ms", "500", "--int8",
                       "--steps", str(CLI_STEPS), "--out-dir",
                       os.path.join(root, "served_int8")],
                      "(e) serve --int8", stdin_lines=CLI_REQUESTS[:2])
        expect_launches(e8["launches"], {
            "fused_route_multiply": per, "geglu_ff_fused": 0,
            "sd_self_attention": per, "sd_cross_attention": per},
            "(e) serve --int8")
        calls["serve_int8"] = e8
        ew = cli_call(["serve", "--snapshot", snap, "--labels", labels_path,
                       "--batch", "2", "--max-wait-ms", "500", "--winograd",
                       "--steps", str(CLI_STEPS), "--out-dir",
                       os.path.join(root, "served_wino")],
                      "(e) DMOE_WINO_FUSED=1 serve --winograd",
                      stdin_lines=CLI_REQUESTS[:2],
                      env={"DMOE_WINO_FUSED": "1"})
        expect_launches(ew["launches"], {
            "winograd3x3_fused": WINO_UNET_CONVS * (CLI_STEPS + 1)
            + WINO_VAE_CONVS, "geglu_ff_fused": per,
            "sd_self_attention": per, "sd_cross_attention": per},
            "(e) serve --winograd")
        calls["serve_winograd"] = ew

        # (f) two steps on a 512-px imagefolder, then a resume that takes none
        data = os.path.join(root, "data")
        write_imagefolder(data, CLI_TRAIN_IMAGES, 8 * sd15_config().sample_size)
        run = os.path.join(root, "train")
        train_argv = ["train", "--snapshot", snap, "--data-dir", data,
                      "--out-dir", run, "--batch", "2", "--max-steps", "2",
                      "--checkpoint-every", "2", "--log-every", "1"]
        f = cli_call(train_argv, "(f) train")
        with open(os.path.join(run, "train_log.jsonl")) as fh:
            logs = [json.loads(line) for line in fh]
        ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")))
        check(json.loads(f["lines"][-1])["steps"] == 2 and len(logs) == 2
              and all(np.isfinite(r["loss"]) for r in logs)
              and ckpts == ["step_00000002.pt"],
              f"(f) train: {f['lines'][-1]}, logs {logs}, checkpoints {ckpts}")
        # under grad kernel 1 (no backward) hands each FF to its plain
        # version, and the GroupNorm kernel each norm, counted; nothing else
        plain = {k: v for k, v in f["launches"].items()
                 if k in _build.PLAIN and v}
        check(plain == {"plain:geglu_ff_fused": 32,
                        "plain:group_norm_nhwc": 2 * SD15_NORMS},
              f"(f) train: plain calls {plain}")
        for name, count in (("sd_self_attention", 32),
                            ("sd_cross_attention", 32), ("geglu_ff_fused", 0)):
            check(f["launches"][name] == count, f"(f) train: kernel {name} "
                  f"launched {f['launches'][name]} times, expected {count}")
        calls["train"] = f
        print(f"cli (f): losses {[r['loss'] for r in logs]}, checkpoints "
              f"{ckpts}", flush=True)
        resumed = cli_call(train_argv, "(f) train, resumed")
        with open(os.path.join(run, "train_log.jsonl")) as fh:
            n_logs = sum(1 for _ in fh)
        check(json.loads(resumed["lines"][-1])["steps"] == 2 and n_logs == 2
              and resumed["launches"]["sd_self_attention"] == 0,
              f"(f) resume: {resumed['lines'][-1]}, {n_logs} log lines")

        # (g) a traced 10-step generate over (c)'s pipeline, the one
        # _load_pipe built
        log_dir = os.path.join(root, "profile")
        pipe, tok = cli._load_pipe(argparse.Namespace(
            snapshot=snap, cpu=False, relufied=False))
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        report = profiling.profile_generate(
            pipe, tok([CLI_PROMPT]), tok([""]), log_dir, num_steps=CLI_STEPS,
            ivs=ivs, seed=CLI_SEED)
        wall_g = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        events = profiling.load_events(log_dir)
        traced = {}
        for name, kernel in (("sd_self_attention", "sd_self_attn_kernel"),
                             ("sd_cross_attention", "sd_cross_attn_kernel")):
            traced[name] = sum(1 for ev in events
                               if ev.get("cat") == "kernel"
                               and kernel in ev.get("name", ""))
            # profile_generate runs the generate twice: a warm-up, the trace
            check(traced[name] == launches[name] // 2 == per,
                  f"(g) {kernel}: {traced[name]} in the trace, "
                  f"{launches[name]} counted over two runs, expected {per} "
                  f"each")
        # the report's op column is as wide as the longest kernel name
        report = "\n".join(re.sub(r" {3,}", "  ", line)
                           for line in report.splitlines()[:16])
        print(f"cli (g): profile_generate at {CLI_STEPS} steps, wall "
              f"{wall_g:.3f} s (warm-up and traced run); traced launches "
              f"{traced} = _build.LAUNCHES / 2; step_time_report (top 15, "
              f"blanks squeezed):\n{report}", flush=True)
        del pipe, ivs
    torch.cuda.empty_cache()
    walls = {k: round(v["wall"], 3) for k, v in calls.items()}
    print(f"phase 21 walls (s): {json.dumps(walls)}, (d) {wall_d:.3f}, "
          f"(g) {wall_g:.3f}; peaks (GiB): "
          f"{json.dumps({k: round(v['peak_gib'], 2) for k, v in calls.items()})}"
          f" on {card}", flush=True)
    return {k: v["launches"] for k, v in calls.items()}


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
    sdxl_kernels, wino_extra = check_sdxl_kernels(gen)
    phase_done("2f (kernels at SDXL's shapes; kernel 8 at SD2.1-768's)")
    pixart_kernels = check_pixart_kernels(gen)
    phase_done("2g (kernels 2 and 3 at PixArt-512's shapes)")
    group_norm = check_group_norm(gen)
    phase_done("2h (the GroupNorm kernel)")
    pipe, ivs, cond, uncond, launches, images = run_slice(card)
    phase_done("3 (serving slice)")
    compare, modes_off = check_latents(pipe, ivs, cond, uncond)
    floors = {3: modes_off["floor_3"], 50: modes_off["floor"]}
    phase_done("4 (latents)")
    run_off_kernels(modes_off.pop("pipe32"), cond, uncond, card)
    phase_done("4b (f32 and tiny_config generates on the plain versions)")
    attribution_launches, removal = run_attribution(pipe, ivs, compare, card)
    phase_done("5 (attribution and neuron erasure)")
    wanda_launches, wanda_masks = run_wanda(pipe, ivs, images, card)
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
    sld_launches = run_sld(ivs, card)
    phase_done("14 (Safe Latent Diffusion on SD1.5)")
    snapshot_launches = run_snapshot_flow(card)
    phase_done("12 (snapshot -> moefy -> routed generate -> bake -> checkpoint)")
    sdxl_launches = run_sdxl(card)
    phase_done("13 (SDXL and LCM-SDXL at full width)")
    pixart_launches = run_pixart(card)
    phase_done("15 (PixArt-512: T5-XXL, the DiT, taps and removal)")
    judge_launches = run_judges(card)
    phase_done("16 (checked_generate and the judges at full width)")
    eval_launches, eval_images = run_erasure_eval(removal, card)
    phase_done("17 (the erasure evaluation: NudeNet, run_eval, I2P, LLaVA)")
    rest_launches = run_rest_of_eval(removal, wanda_masks, eval_images, card)
    del removal, wanda_masks, eval_images
    phase_done("18 (Qwen2-VL judge, debias, unified editing, baselines)")
    torch.cuda.empty_cache()
    training = run_training(card)
    phase_done("19 (training: encode, AdamW steps with and without remat, "
               "grads through kernels 2 and 3, Adafactor, accumulation, "
               "resume)")
    parallel = run_parallel(card, floors, training["grad_floor"])
    phase_done("20 (parallel: world size 1 over NCCL, world size 2 over "
               "gloo on the card at tp=2 and dp=2, training at dp=2)")
    cli_launches = run_cli(card, floors[50])
    phase_done("21 (the front door: check-snapshot, parity-run, generate, "
               "python -m, serve and its int8 and Winograd legs, train and "
               "resume, profile_generate)")
    ff_launch_times(ff, ff_kernels)
    phase_done("9 (kernel 1's launches apart, by the profiler)")
    print("launches by path: " + json.dumps({
        "serving": launches, "attribution": attribution_launches,
        "wanda_erasure": wanda_launches,
        "serving_engine_modes_on": serving_launches,
        "serving_engine_winograd": wino_launches,
        "sd21_serving": sd21_launches["serving"],
        "sd21_modes_on": sd21_launches["modes_on"],
        **{f"sd15_{k}": v for k, v in other_launches.items()},
        "sld": sld_launches, "snapshot_routed": snapshot_launches,
        **{f"sdxl_{k}": v for k, v in sdxl_launches.items()},
        "pixart": pixart_launches, "checked_generate": judge_launches,
        "erasure_eval": eval_launches, **rest_launches,
        **{f"training_{k}": training[k]["launches"]
           for k in ("remat_off", "remat_on")},
        **{f"parallel_{k}": v for k, v in parallel["launches"].items()},
        **{f"cli_{k}": v for k, v in cli_launches.items()}}))

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
        # no TPU counterpart: the JAX package leaves GroupNorm to XLA
        ("group_norm_nhwc", f"{csrc}/group_norm.cu", None, group_norm,
         launches),
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
    # phase 2f's shapes and sums over one SDXL UNet call, and the launches
    # of phase 13's generate (kernels 5-7: with the modes on; kernel 8 runs
    # on no phase-13 path); kernel 8 at SD2.1-768's shapes and its VAE sums
    for k in kernels:
        name = k["name"]
        if name in sdxl_kernels:
            rows_xl, sums_xl = sdxl_kernels[name]
            path = ("modes_on" if name in ("ln_qkv_fused",
                                           "attn_out_residual_fused",
                                           "conv3x3_chain") else "serving")
            k.update(sdxl_shapes=rows_xl, sdxl_unet_call=sums_xl,
                     sdxl_launches=sdxl_launches[path].get(name, 0))
        if name == "winograd3x3_fused":
            k.update(sdxl_vae_decode=wino_extra["sdxl_vae"],
                     sd21_winograd=wino_extra["sd21"])
        # phase 2g's shapes and sums over one PixArt DiT call, and the
        # launches of phase 15's generate
        if name in pixart_kernels:
            rows_px, sums_px = pixart_kernels[name]
            k.update(pixart_shapes=rows_px, pixart_dit_call=sums_px,
                     pixart_launches=pixart_launches[name])
    # phase 19: kernels 2 and 3 under grad, per TRAIN_STEPS training steps
    for k in kernels:
        if k["name"] in ("sd_self_attention", "sd_cross_attention"):
            k.update(train_launches={
                what: training[what]["launches"][k["name"]]
                for what in ("remat_off", "remat_on")})
    # phase 20: each kernel's launches on the tp=2 and dp=2 generates (rank
    # 0's), and the FF calls tp sent past kernel 1
    for k in kernels:
        k.update(tp_launches=parallel["launches"]["tp"][k["name"]],
                 dp_launches=parallel["launches"]["dp"][k["name"]])
        if k["name"] == "geglu_ff_fused":
            k["tp_not_taken"] = parallel["launches"]["tp"]["tp:geglu_ff_fused"]
    # phase 21: each kernel's launches by CLI command
    for k in kernels:
        k["cli_launches"] = {cmd: counts[k["name"]]
                             for cmd, counts in cli_launches.items()}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
