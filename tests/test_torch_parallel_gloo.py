"""The port over two processes on the CPU: gloo at world size 2 against
world size 1, at `tiny_config` sizes in f32.

Each case spawns two ranks once (`tests/torch_dist_worker.py`, which
imports no JAX: a spawned child re-imports it), joined through a `file://`
store under this module's temporary directory; each rank computes the
world-size-1 result in its own process first, then the same work over the
mesh. The world-size-1 paths are held to the JAX package by the other
`test_torch_*.py` files. Tolerances: images and latents 2e-5 (atol, rtol
1e-5), JAX's own for its dp and tp generates
(tests/test_parallel_and_kernels.py); uint8 images one level (the rounding
of values within 2e-5); the train steps 2e-4.
"""
import numpy as np
import pytest
import torch

import torch_dist_worker as worker

ATOL, RTOL = 2e-5, 1e-5
TRAIN_TOL = 2e-4


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cache = {}

    def get(case: str) -> list:
        if case not in cache:
            cache[case] = worker.launch(
                case, str(tmp_path_factory.mktemp(case)))
        return cache[case]
    return get


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=rtol)


# --------------------------------------------------------------- generate
@pytest.mark.parametrize("what", ["dp", "dp_seeds", "tp"])
def test_generate_matches_world_size_one(results, what):
    """SD1.5-tiny with MoE routing on its 16 FFs: images at dp=2 (noise
    from one generator, or from each request's seed) and at tp=2 equal
    world size 1's on each rank."""
    r0, r1 = results("generate")
    ref = r0["ref_seeds" if what == "dp_seeds" else "ref"]
    for r in (r0, r1):
        _close(r[what], ref)
    assert torch.equal(r0[what], r1[what])


def test_generate_tp_routes_every_ff_through_the_unfused_path(results):
    """Under tp=2 every attention holds 2 of its 4 heads, and every FF call
    that would take kernel 1 takes the unfused path (its routing in kernel
    4's plain version here), counted under tp:geglu_ff_fused: 16 FFs x 3
    PNDM UNet calls; no call is counted plain."""
    r0, _ = results("generate")
    assert set(r0["heads"]) == {2}
    launched = {k: v for k, v in r0["tp_launches"].items() if v}
    assert launched == {"tp:geglu_ff_fused": 48}


def test_generate_refuses_a_batch_dp_does_not_divide(results):
    """A batch of 3 does not split over dp = 2: refused."""
    for r in results("generate"):
        assert "does not split over dp" in r["odd_batch"]


@pytest.mark.parametrize("what", ["dp", "tp"])
def test_generate_taps_match_world_size_one(results, what):
    """Every tap (gate and expert statistics, the saved gates and eps, the
    CLIP MLP's Wanda norms) of the tapped generate at dp=2, gathered over the
    ranks (`taps.gather_taps`), and at tp=2, equal world size 1's on each
    rank; the expert counts to the unit."""
    r0, r1 = results("generate")
    ref = r0["taps_ref"]
    assert set(ref) == {"max_gate", "mean_gate", "gate_sparsity",
                        "save_gate", "ff_out_colnorm_sq", "expert_scores_max",
                        "expert_freq", "expert_sel", "eps", "text_colnorm_sq"}
    for r in (r0, r1):
        got = r[f"taps_{what}"]
        assert got.keys() == ref.keys()
        for stat, layers in ref.items():
            assert got[stat].keys() == layers.keys(), stat
            for layer, want in layers.items():
                _close(got[stat][layer], want)


def test_serving_engine_tp_matches_world_size_one(results):
    """The serving engine at tp=2: rank 0's images equal the one-process
    engine's within one uint8 level, request 0 served alone equals request
    0 co-batched to the bit, the follower ran every batch and refuses
    submits."""
    r0, r1 = results("generate")
    assert len(r0["serve_tp"]) == 3
    for got, ref in zip(r0["serve_tp"], r0["serve_ref"]):
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(r0["serve_alone"][0], r0["serve_tp"][0])
    assert r0["serve_stats"]["requests"] == 4
    assert r1["serve_stats"]["batches"] == r0["serve_stats"]["batches"] == 3
    assert "rank 0" in r1["follower_submit"]


def test_run_eval_dp_writes_each_png_once(results):
    """`run_eval` at dp=2: the coordinator writes each of the 6 PNGs once,
    the other rank none; the images equal world size 1's within one level;
    a rerun reads the same resume state on both ranks and skips all."""
    from PIL import Image
    r0, r1 = results("generate")
    names = sorted(f"{p}_{i}.png" for p in ("sd", "removed") for i in range(3))
    assert sorted(r0["eval_saves"]) == names and r1["eval_saves"] == []
    out = r0["eval_summary"]["out_dir"]
    ref = out.rsplit("/", 1)[0] + "/eval_ref_0"
    for name in names:
        a = np.asarray(Image.open(f"{out}/{name}")).astype(int)
        b = np.asarray(Image.open(f"{ref}/{name}")).astype(int)
        assert np.abs(a - b).max() <= 1, name
    for r in (r0, r1):
        assert r["eval_summary"]["generated"] == 3
        assert r["eval_rerun"]["skipped"] == 3


# ----------------------------------------------------------------- models
@pytest.mark.parametrize("what", ["sdxl", "pixart"])
def test_sdxl_pixart_tp_match_world_size_one(results, what):
    """SDXL-tiny (two towers, 22 routed FFs, Euler) and PixArt-tiny (T5 and
    the DiT, DPM, masked captions) at tp=2 equal world size 1."""
    r0, r1 = results("models")
    for r in (r0, r1):
        _close(r[f"{what}_tp"], r0[f"{what}_ref"])


def test_llava_tp_same_greedy_tokens(results):
    """A tiny LLaVA with its LM at tp=2 (heads, the MLP and lm_head over
    the vocabulary): the same greedy tokens as world size 1 on each rank,
    its gathered logits within 1e-5 of the largest."""
    r0, r1 = results("models")
    for r in (r0, r1):
        np.testing.assert_array_equal(r["llava_tp"], r0["llava_ref"])
        ref = r0["llava_logits_ref"]
        assert float((r["llava_logits_tp"] - ref).abs().max()) <= \
            1e-5 * float(ref.abs().max())
    assert r0["llava_embed_same"]


def test_tp_refuses_absorb_and_int8(results):
    """The absorbed attention and the int8 projections take no shard:
    sharding such a pipeline raises."""
    refusals = results("models")[0]["refusals"]
    assert "attn_absorb" in refusals["attn_absorb"]
    assert "QuantDense" in refusals["quant_int8"]


# ----------------------------------------------------------------- train
def _train_close(got: dict, ref: dict) -> None:
    for table in ("params", "ema"):
        for n, v in ref[table].items():
            assert float((got[table][n] - v).abs().max()) <= TRAIN_TOL, n
    for n, v in ref["mu"].items():       # the gradients' running mean
        assert float((got["mu"][n] - v).abs().max()) <= \
            TRAIN_TOL * float(v.abs().max()), n


@pytest.mark.parametrize("what", ["dp", "tp"])
def test_train_steps_match_world_size_one(results, what):
    """Two AdamW steps of the ReLUfied tiny UNet through `train_relufied`
    at dp=2 (a batch of 4, 2 a rank) and at tp=2 (`RunConfig.n_devices=2`):
    masters, first moments and EMA (gathered over tp) within 2e-4 of world
    size 1's steps, and the logged loss and grad norm too."""
    r0, r1 = results("train")
    for r in (r0, r1):
        _train_close(r[what], r0["ref"])
    if what == "tp":
        assert r0["tp_mesh"] == {"dp": 1, "tp": 2}
    for got, ref in zip(r0[f"{what}_logs"], r0["ref_metrics"]):
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - ref[k]) <= TRAIN_TOL * abs(ref[k]), k


def test_train_logs_written_once(results):
    """The coordinator alone logs: rank 1's log_fn saw nothing, and the
    JSONL holds one line a step."""
    r0, r1 = results("train")
    assert len(r0["tp_logs"]) == 2 and r1["tp_logs"] == []
    assert r0["tp_log_lines"] == r0["tp_logs"]
    assert r1["dp_logs"] == []


def test_checkpoint_tp2_resumes_at_tp1_bit_equal(results):
    """The tp=2 run's checkpoint, gathered and written once, read back at
    tp=1: every tensor equals the gathered tp=2 state to the bit."""
    for r in results("train"):
        assert r["resumed_label"] == 2
        for table in ("params", "mu", "ema"):
            for n, v in r["tp"][table].items():
                assert torch.equal(r["resumed_tp1"][table][n], v), n


def test_checkpoint_tp1_resumes_at_tp2_bit_equal(results):
    """World size 1's checkpoint read back at tp=2: each rank holds its
    shard of every tensor, bit-equal; Adafactor is refused under tp."""
    from diffusion_models_moe_tpu_torch.parallel.mesh import (local_shard,
                                                              param_shardings)
    for r in results("train"):
        for table in ("params", "mu", "ema"):
            for n, v in r["resumed_tp2"][table].items():
                want = local_shard(r["ref"][table][n],
                                   param_shardings([n])[n], {"tp": 2},
                                   {"tp": r["tp_rank"]})
                assert torch.equal(v, want), n
        assert "adafactor" in r["adafactor_tp"]
