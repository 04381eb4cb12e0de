"""Operations and bytes from shapes, against counts made by hand and
against torch's operation counter over the reference at a tiny size."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_h100.harness import counts
from bench_h100.reference.sd_ref import Reference
from bench_h100.tests.tiny import TINY

MOE = {"expert_size": 20, "topk_ratio": 0.3}


def test_ff_by_hand():
    # n = 10 tokens, c = 40, H = 160, E = 8 experts, k = int(2.4) = 2
    flops, nbytes = counts.ff(10, 40, 4, MOE)
    w1 = 2 * 10 * 40 * 320
    w2 = 2 * 10 * 160 * 40 * 2 / 8
    assert flops == w1 + 10 * 160 + w2
    assert nbytes == (2 * 10 * 40 * 2 + 2 * 40 * 4 + (320 * 40 + 320) * 2
                      + (160 * 40 + 40) * 2 + 8 * 160 * 2)
    dense, _ = counts.ff(10, 40, 4, None)
    assert dense == w1 + 2 * 10 * 160 * 40


def test_self_attention_by_hand():
    flops, nbytes = counts.self_attn(2, 16, 8)
    assert flops == 4 * 2 * 32 * 8 * 8 + 2 * 2 * (2 * 16 * 16 * 8)
    assert nbytes == (2 * 32 * 8 + 4 * 64 + 8) * 2


def test_least_time_takes_the_binding_bound():
    assert counts.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@torch.no_grad()
def test_dense_unet_matches_the_operation_counter():
    ref = Reference(TINY)
    u, s = TINY["unet"], TINY["sample_size"]
    x = torch.zeros(2, 4, s, s)
    ctx = torch.zeros(2, 16, u["cross_attention_dim"])
    got = _counted(lambda: ref.unet(x, 500, ctx))
    assert got == counts.unet_call(u, None, 2, s, 16)


@torch.no_grad()
def test_text_and_decode_match_the_operation_counter():
    ref = Reference(TINY)
    t = TINY["text_encoders"][0]
    ids = torch.zeros(3, t["max_length"], dtype=torch.long)
    assert _counted(lambda: ref.towers[0](ids)) == counts.text_tower(t, 3)
    z = torch.zeros(2, 4, 8, 8)
    assert _counted(lambda: ref.vae(z)) == counts.vae_decode(TINY["vae"], 2, 8)


def test_moe_counts_the_selected_share_of_w2_and_the_score_sums():
    u, s = TINY["unet"], TINY["sample_size"]
    dense = counts.unet_call(u, None, 1, s, 16)
    routed = counts.unet_call(u, MOE, 1, s, 16)
    # every FF here is 32, 64 or 128 wide; the difference is per FF
    # (1 - k/E) of W2 less, plus n * H score additions
    assert routed < dense
    gen = counts.generate(TINY, 2, 4, 7.5)
    assert gen == (counts.text_tower(TINY["text_encoders"][0], 4)
                   + 5 * counts.unet_call(u, MOE, 4, s, 16)
                   + counts.vae_decode(TINY["vae"], 2, s))
