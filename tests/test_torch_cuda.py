"""The torch port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU or interpret mode, so these tests need an NVIDIA
GPU (sm_90a) and `nvcc`; elsewhere they skip. On the GPU, from the repo root
(`--noconftest`: tests/conftest.py configures JAX, which the port does not
use):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Shapes are small and ragged (rows and tokens not multiples of the tiles) to
reach the kernels' edge masking; `chip_smoke.py` covers the SD1.5 shapes.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.ops import attn_absorb_fused as absorb
from diffusion_models_moe_tpu_torch.ops import conv_chain_fused as chain
from diffusion_models_moe_tpu_torch.ops import geglu_ff_fused as ffm
from diffusion_models_moe_tpu_torch.ops import routing_kernel, sd_flash
from diffusion_models_moe_tpu_torch.ops import winograd_fused as wino
from diffusion_models_moe_tpu_torch.taps import (TapSpec, patterns_from_labels,
                                                 routing_mask)

pytestmark = pytest.mark.cuda

REL_TOL = 2e-2     # max |kernel - plain| / max |plain|, bf16 rounding scale
# least shares of routing decisions and of rows' expert sets on which kernel
# and plain version agree (chip_smoke.py holds the SD1.5 shapes to the same)
DECISION_AGREEMENT = 0.99998
ROW_AGREEMENT = 0.999


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def _rn(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_geglu_ff_kernel_matches_plain(gen, routed, absorb, relu):
    n, c = 3000, 64
    hdim, e, k = 4 * c, 12, 3
    x = _rn(gen, n, c)
    w1, b1 = _rn(gen, 2 * hdim, c, scale=c ** -0.5), _rn(gen, 2 * hdim, scale=0.1)
    w2, b2 = _rn(gen, c, hdim, scale=hdim ** -0.5), _rn(gen, c, scale=0.1)
    ln = {}
    if absorb:
        ln = dict(ln_scale=_rn(gen, c, scale=0.1, dtype=torch.float32) + 1,
                  ln_bias=_rn(gen, c, scale=0.1, dtype=torch.float32))
    pat = None
    if routed:
        lab = np.random.RandomState(0).permutation(np.arange(hdim) % e)
        pat = patterns_from_labels(lab, e).to("cuda", torch.bfloat16)
    args = (x, w1, b1, w2, b2, pat, k if routed else 0, relu)
    _build.reset_launch_counts()
    y = ffm.geglu_ff_fused(*args, **ln)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["geglu_ff_fused"] == 1
    y_plain = ffm.geglu_ff_fused(*args, **ln, use_kernels=False)
    rows = torch.ones(n, dtype=torch.bool, device="cuda")
    if routed:
        g, b = ln.get("ln_scale"), ln.get("ln_bias")
        sel_k = ffm.kernel_selection(x, w1, b1, pat, k, relu, g, b)
        _, ga = ffm.reference_gate(x, w1, b1, relu, g, b, 1e-5)
        sel_p = ffm.reference_selection(ga, pat, k, torch.bfloat16)
        assert (sel_k == sel_p).float().mean().item() >= DECISION_AGREEMENT
        rows = (sel_k == sel_p).all(dim=1)
        assert rows.float().mean().item() >= ROW_AGREEMENT
    assert _rel(y[rows], y_plain[rows]) < REL_TOL


def test_geglu_ff_kernel_keeps_ties(gen):
    """Experts with identical gate columns tie exactly: both are kept."""
    n, c, e, k = 128, 64, 8, 3
    hdim = 4 * c
    lab = np.arange(hdim) % e
    x = _rn(gen, n, c)
    w1 = _rn(gen, 2 * hdim, c, scale=c ** -0.5)
    gate = w1[hdim:]
    gate[torch.from_numpy(lab == 1).cuda()] = gate[torch.from_numpy(lab == 0).cuda()]
    b1 = torch.zeros(2 * hdim, dtype=torch.bfloat16, device="cuda")
    pat = patterns_from_labels(lab, e).to("cuda", torch.bfloat16)
    sel = ffm.kernel_selection(x, w1, b1, pat, k)
    assert (sel.sum(1) > k).any()
    assert torch.equal(sel[:, 0], sel[:, 1])
    # kernel 4 on the same gate keeps the same tied experts
    h, ga = ffm.reference_gate(x, w1, b1, False, None, None, 1e-5)
    out = routing_kernel.fused_route_multiply(h.bfloat16(), ga.bfloat16(),
                                              pat, k)
    sel4 = ((out != 0).float() @ pat.float().t() > 0).float()
    assert (sel4.sum(1) > k).any()
    assert torch.equal(sel4[:, 0], sel4[:, 1])


# (C, H, E) of the SD1.5 FFs (20-neuron experts) and ragged row counts
FF_SD15 = [(320, 1280, 64), (640, 2560, 128), (1280, 5120, 256)]


def _ff_weights(gen, c, hdim, e, seed=0):
    w1, b1 = _rn(gen, 2 * hdim, c, scale=c ** -0.5), _rn(gen, 2 * hdim, scale=0.1)
    w2, b2 = _rn(gen, c, hdim, scale=hdim ** -0.5), _rn(gen, c, scale=0.1)
    ln = dict(ln_scale=_rn(gen, c, scale=0.1, dtype=torch.float32) + 1,
              ln_bias=_rn(gen, c, scale=0.1, dtype=torch.float32))
    lab = np.random.RandomState(seed).permutation(np.arange(hdim) % e)
    pat = patterns_from_labels(lab, e).to("cuda", torch.bfloat16)
    return w1, b1, w2, b2, ln, pat


def _ff_agrees(x, w1, b1, w2, b2, pat, k, relu=False, row_limit=ROW_AGREEMENT,
               **ln):
    """Kernel 1 against its plain version: routing decisions and rows agree
    as chip_smoke.py requires (rows at least `row_limit`), and the outputs
    agree on agreeing rows."""
    y = ffm.geglu_ff_fused(x, w1, b1, w2, b2, pat, k, relu, **ln)
    y_plain = ffm.geglu_ff_fused(x, w1, b1, w2, b2, pat, k, relu, **ln,
                                 use_kernels=False)
    g, b = ln.get("ln_scale"), ln.get("ln_bias")
    sel_k = ffm.kernel_selection(x, w1, b1, pat, k, relu, g, b)
    _, ga = ffm.reference_gate(x, w1, b1, relu, g, b, 1e-5)
    sel_p = ffm.reference_selection(ga, pat, k, torch.bfloat16)
    assert (sel_k == sel_p).float().mean().item() >= DECISION_AGREEMENT
    rows = (sel_k == sel_p).all(dim=1)
    assert rows.float().mean().item() >= row_limit
    assert _rel(y[rows], y_plain[rows]) < REL_TOL
    return y


@pytest.mark.parametrize("n", [77, 1000, 4100])
@pytest.mark.parametrize("c,hdim,e", FF_SD15)
def test_geglu_ff_kernel_at_sd15_widths_and_ragged_rows(gen, c, hdim, e, n):
    """Kernel 1 routed with LN (the main path) at every SD1.5 FF width, with
    row counts no multiple of any tile."""
    w1, b1, w2, b2, ln, pat = _ff_weights(gen, c, hdim, e)
    y = _ff_agrees(_rn(gen, n, c), w1, b1, w2, b2, pat, int(0.3 * e), **ln)
    assert torch.isfinite(y.float()).all()


@pytest.mark.parametrize("edit", ["expert_remove", "two_ones", "three_ones"])
def test_geglu_ff_kernel_on_edited_patterns(gen, edit):
    """Pattern rows zeroed as expert_remove zeroes them (those experts score
    0 and still compete), columns with two ones (m up to 2: bf16(h*ga) * m
    is exact) and with three (m up to 3: rounded twice, within one bf16
    unit of bf16(h*ga*m))."""
    n, c, hdim, e = 1000, 64, 256, 12
    w1, b1, w2, b2, ln, pat = _ff_weights(gen, c, hdim, e)
    pat = pat.clone()
    if edit == "expert_remove":
        pat[[1, 5, 9]] = 0
    else:
        cols = torch.arange(0, hdim, 3, device="cuda")
        lab = pat.argmax(0)
        for shift in range(1, 2 if edit == "two_ones" else 3):
            pat[(lab[cols] + shift) % e, cols] = 1
    x, k = _rn(gen, n, c), 4
    g, b = ln["ln_scale"], ln["ln_bias"]
    y = ffm.geglu_ff_fused(x, w1, b1, w2, b2, pat, k, **ln)
    y_plain = ffm.geglu_ff_fused(x, w1, b1, w2, b2, pat, k, **ln,
                                 use_kernels=False)
    # a neuron may belong to several experts, so rows agree where the
    # kernel's masked product is nonzero exactly where the plain one is
    plan = ffm.ff_plan(n, c, hdim, e, _build.sm_count(x.device))
    prod, _ = ffm._launch_front(x, w1, b1, pat, k, False, g, b, 1e-5, plan)
    h, ga = ffm.reference_gate(x, w1, b1, False, g, b, 1e-5)
    m = ffm.reference_selection(ga, pat, k, torch.bfloat16) @ pat.float()
    rows = ((prod != 0) == ((h * ga * m).bfloat16() != 0)).all(dim=1)
    assert rows.float().mean().item() >= ROW_AGREEMENT
    assert _rel(y[rows], y_plain[rows]) < REL_TOL


@pytest.mark.parametrize("n", [256, 1024])
def test_geglu_ff_split_plans_are_bit_equal_on_a_repeat(gen, n):
    """At C = 1280 and these N the plan splits the depth of ff_down and of
    the routing scores; the parts are added in a fixed order, so a repeat
    gives the same bits, and a row's result does not depend on the other
    rows at one N (request 0 alone equals request 0 co-batched)."""
    c, hdim, e = FF_SD15[2]
    plan = ffm.ff_plan(n, c, hdim, e, _build.sm_count(torch.device("cuda")))
    assert plan.down_split > 1 and plan.route.split > 1
    w1, b1, w2, b2, ln, pat = _ff_weights(gen, c, hdim, e)
    x = _rn(gen, n, c)
    args = (w1, b1, w2, b2, pat, int(0.3 * e))
    y = ffm.geglu_ff_fused(x, *args, **ln)
    assert torch.equal(y, ffm.geglu_ff_fused(x, *args, **ln))
    other = x.clone()
    other[1:] = _rn(gen, n - 1, c)
    assert torch.equal(ffm.geglu_ff_fused(other, *args, **ln)[0], y[0])
    hidden, gate, rpat = _route_inputs(gen, n, e, hdim)
    out = routing_kernel.fused_route_multiply(hidden, gate, rpat, 76)
    assert torch.equal(out, routing_kernel.fused_route_multiply(
        hidden, gate, rpat, 76))


def _heads(gen, b, s, h, d, strided):
    """(B, S, H, D) as the model hands it over: a (B, S, H*D) projection
    output viewed, or (strided) a column third of kernel 5's (B, S, 3C)."""
    if not strided:
        return _rn(gen, b, s, h * d).view(b, s, h, d)
    t = _rn(gen, b, s, 3 * h * d)[..., h * d:2 * h * d]
    return t.view(b, s, h, d)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("b,s,h,d", [(2, 200, 3, 40), (2, 200, 3, 64),
                                     (2, 200, 3, 80), (2, 200, 3, 160),
                                     (1, 77, 2, 40), (1, 1000, 2, 80),
                                     (1, 4100, 2, 40), (4, 64, 8, 160)])
def test_self_attention_kernel_matches_plain(gen, b, s, h, d, strided):
    """Kernel 2 at ragged S (no multiple of the 64-row tiles or the key
    tiles), at every instantiated head dim, on contiguous and strided
    views."""
    q, k, v = (_heads(gen, b, s, h, d, strided) for _ in range(3))
    assert sd_flash.attn_kernel_ok(q, k)
    _build.reset_launch_counts()
    o = sd_flash.sd_self_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sd_self_attention"] == 1
    ref = sd_flash.sd_self_attention(q, k, v, d ** -0.5, use_kernels=False)
    assert _rel(o, ref) < REL_TOL


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("b,s,h,d", [(2, 200, 3, 40), (2, 200, 3, 64),
                                     (2, 200, 3, 80), (2, 200, 3, 160),
                                     (1, 1000, 2, 80), (1, 4100, 2, 40)])
def test_cross_attention_kernel_matches_plain(gen, b, s, h, d, strided):
    """Kernel 3 at ragged S, every head dim, strided views, 77 keys and
    fewer valid ones."""
    q = _heads(gen, b, s, h, d, strided)
    k, v = (_heads(gen, b, 77, h, d, strided) for _ in range(2))
    for kv_valid in (77, 40, 1):
        o = sd_flash.sd_cross_attention(q, k, v, d ** -0.5, kv_valid)
        ref = sd_flash.sd_cross_attention(q, k, v, d ** -0.5, kv_valid,
                                          use_kernels=False)
        assert _rel(o, ref) < REL_TOL


def test_attention_kernels_are_bit_equal_across_a_batch(gen):
    """No row depends on another (batch, head) or on the launch plan: batch
    element 0 alone equals batch element 0 of a batch of 4 (64-row self
    blocks at batch 1, 128-row ones at batch 4; other cross runs)."""
    for s, d in ((1024, 80), (256, 160)):
        q, k, v = (_rn(gen, 4, s, 8 * d).view(4, s, 8, d) for _ in range(3))
        kc, vc = (_rn(gen, 4, 77, 8 * d).view(4, 77, 8, d) for _ in range(2))
        full = sd_flash.sd_self_attention(q, k, v, d ** -0.5)
        one = sd_flash.sd_self_attention(q[:1], k[:1], v[:1], d ** -0.5)
        assert torch.equal(full[:1], one)
        full = sd_flash.sd_cross_attention(q, kc, vc, d ** -0.5, 77)
        one = sd_flash.sd_cross_attention(q[:1], kc[:1], vc[:1], d ** -0.5, 77)
        assert torch.equal(full[:1], one)


@pytest.mark.parametrize("which", ["f32", "tiny"])
def test_generate_off_the_kernels_takes_the_plain_versions(gen, which):
    """Where the predicates say no (an f32 model; tiny_config's head dims 8
    to 32) `generate` runs on the card through the plain versions: no
    attention kernel launches and the plain counters count the calls."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                sd15_config, tiny_config)
    cfg = (tiny_config() if which == "tiny"
           else dataclasses.replace(sd15_config(torch.float32), sample_size=16))
    pipe = StableDiffusionPipeline(cfg, device="cuda")
    pipe.init_params(torch.Generator(device="cuda").manual_seed(0))
    cond = torch.randint(0, cfg.text_encoder.vocab_size,
                         (1, cfg.text_encoder.max_length), device="cuda")
    _build.reset_launch_counts()
    images, _ = pipe.generate(cond, torch.zeros_like(cond), seeds=[0],
                              num_steps=2)
    torch.cuda.synchronize()
    assert torch.isfinite(images).all()
    assert all(_build.LAUNCHES[k] == 0 for k in _build.KERNELS)
    calls = 16 * 3          # 16 attention layers, PNDM's 2 steps + warm-up
    assert _build.LAUNCHES["plain:sd_self_attention"] == calls
    assert _build.LAUNCHES["plain:sd_cross_attention"] == calls
    if which == "f32":
        assert _build.LAUNCHES["plain:geglu_ff_fused"] == calls


def test_kernels_refuse_what_they_do_not_take(gen):
    q = _rn(gen, 1, 64, 2, 40, dtype=torch.float32)
    with pytest.raises(ValueError):
        sd_flash.sd_self_attention(q, q, q, 40 ** -0.5)
    # routing patterns are made once in the model dtype, never cast per call
    n, c, e = 64, 64, 8
    x = _rn(gen, n, c)
    w1, b1 = _rn(gen, 8 * c, c), _rn(gen, 8 * c)
    w2, b2 = _rn(gen, c, 4 * c), _rn(gen, c)
    pat = patterns_from_labels(np.arange(4 * c) % e, e).cuda()
    with pytest.raises(ValueError):
        ffm.geglu_ff_fused(x, w1, b1, w2, b2, pat, 3)


@pytest.mark.parametrize("has_ln", [True, False])
@pytest.mark.parametrize("shape", [(3, 200, 320, 8), (1, 77, 96, 2),
                                   (2, 1000, 1280, 8)])
def test_ln_qkv_kernel_matches_plain(gen, shape, has_ln):
    """Kernel 5 at ragged shapes: B*S no multiple of the 64- and 128-row
    tiles, 3C no multiple of the 128-column tile (C = 96, 320); q, k, v are
    views of one tensor that the flash kernel takes as they are."""
    b, s, c, heads = shape
    x = _rn(gen, b, s, c)
    wq, wk, wv = (_rn(gen, c, c, scale=c ** -0.5) for _ in range(3))
    ln = ()
    if has_ln:
        ln = (_rn(gen, c, scale=0.1, dtype=torch.float32) + 1,
              _rn(gen, c, scale=0.1, dtype=torch.float32))
    _build.reset_launch_counts()
    got = absorb.ln_qkv_fused(x, wq, wk, wv, heads, *ln)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ln_qkv_fused"] == 1
    ref = absorb.ln_qkv_fused(x, wq, wk, wv, heads, *ln, use_kernels=False)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (b, s, heads, c // heads)
        assert g.stride() == (s * 3 * c, 3 * c, c // heads, 1)
        assert _rel(g, r) < REL_TOL
    if c // heads in (40, 160):
        o = sd_flash.sd_self_attention(*got, (c // heads) ** -0.5)
        o_ref = sd_flash.sd_self_attention(*(t.contiguous() for t in got),
                                           (c // heads) ** -0.5)
        assert torch.equal(o, o_ref)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("shape", [(3, 200, 320, 8), (1, 77, 96, 2),
                                   (2, 1000, 1280, 8)])
def test_attn_out_residual_kernel_matches_plain(gen, shape, strided):
    """Kernel 6 at ragged shapes, reading o contiguous and as a strided view
    (the value third of a (B, S, 3C) tensor)."""
    b, s, c, heads = shape
    d = c // heads
    o = _rn(gen, b, s, heads, d)
    if strided:
        o = torch.cat([o.view(b, s, c)] * 3, dim=-1)[..., 2 * c:].view(
            b, s, heads, d)
        assert not o.is_contiguous()
    w, bias = _rn(gen, c, c, scale=c ** -0.5), _rn(gen, c, scale=0.1)
    resid = _rn(gen, b, s, c)
    _build.reset_launch_counts()
    got = absorb.attn_out_residual_fused(o, w, bias, resid)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["attn_out_residual_fused"] == 1
    ref = absorb.attn_out_residual_fused(o, w, bias, resid, use_kernels=False)
    assert _rel(got, ref) < REL_TOL


@pytest.mark.parametrize("mode", ["1", "qkv", "out"])
def test_absorbed_self_attention_kernels_match_plain(gen, mode):
    b, s, c, heads = 2, 200, 320, 8
    x = _rn(gen, b, s, c)
    wq, wk, wv, wo = (_rn(gen, c, c, scale=c ** -0.5) for _ in range(4))
    bo = _rn(gen, c, scale=0.1)
    ln = (_rn(gen, c, scale=0.1, dtype=torch.float32) + 1,
          _rn(gen, c, scale=0.1, dtype=torch.float32), 1e-5)
    args = (x, wq, wk, wv, wo, bo, heads, (c // heads) ** -0.5, ln, mode)
    _build.reset_launch_counts()
    got = absorb.absorbed_self_attention(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ln_qkv_fused"] == (mode != "out")
    assert _build.LAUNCHES["attn_out_residual_fused"] == (mode != "qkv")
    assert _build.LAUNCHES["sd_self_attention"] == 1
    ref = absorb.absorbed_self_attention(*args, use_kernels=False)
    assert _rel(got, ref) < REL_TOL


# (B, S, C): the four SD1.5 self-attentions at UNet batch 4, 8 heads
ABSORB_SD15 = [(4, 4096, 320), (4, 1024, 640), (4, 256, 1280), (4, 64, 1280)]


def _absorb_inputs(gen, b, s, c):
    x = _rn(gen, b, s, c)
    w = [_rn(gen, c, c, scale=c ** -0.5) for _ in range(4)]
    ln = (_rn(gen, c, scale=0.1, dtype=torch.float32) + 1,
          _rn(gen, c, scale=0.1, dtype=torch.float32))
    return x, w, _rn(gen, c, scale=0.1), ln


@pytest.mark.parametrize("kind", ["qkv", "out"])
@pytest.mark.parametrize("shape", ABSORB_SD15)
def test_absorb_kernels_at_sd15_shapes(gen, shape, kind):
    """Kernels 5 and 6 at the four SD1.5 shapes (kernel 6's depth split at
    S = 256 and 64, kernel 5's shared-out column tiles at C = 640 and 1280):
    within REL_TOL of the plain versions, bit-equal on a repeat, and a row's
    result independent of the other rows at one N."""
    b, s, c = shape
    heads = 8
    plan = absorb.absorb_plan(kind, b * s, c,
                              _build.sm_count(torch.device("cuda")))
    if kind == "out":
        assert (plan.split > 1) == (s <= 256)
    else:
        assert (plan.run < plan.col_tiles) == (c > 320)
    x, (wq, wk, wv, wo), bo, ln = _absorb_inputs(gen, b, s, c)
    o = _rn(gen, b, s, heads, c // heads)
    if kind == "qkv":
        def run(inp, uk=True):
            return torch.cat([t.reshape(b, s, c) for t in absorb.ln_qkv_fused(
                inp, wq, wk, wv, heads, *ln, use_kernels=uk)], dim=-1)
        other = x.clone()
    else:
        def run(inp, uk=True):
            return absorb.attn_out_residual_fused(inp, wo, bo, x,
                                                  use_kernels=uk)
        other = o.clone()
    inp = x if kind == "qkv" else o
    got = run(inp)
    assert _rel(got, run(inp, False)) < REL_TOL
    assert torch.equal(got, run(inp))
    other[1:] = _rn(gen, *other[1:].shape)
    assert torch.equal(run(other)[0], got[0])


def test_attn_out_residual_takes_only_head_dense_o(gen):
    """Kernel 6 reads o through one row stride: the plain attention's
    output (an einsum's permuted view, heads S*D apart) and a slice of the
    sequence (rows unevenly spaced) are refused; the absorbed sub-block
    hands the plain attention's output over contiguous, so a head dim that
    kernel 2 refuses (D = 48) still runs kernels 5 and 6."""
    b, s, c, heads = 1, 77, 96, 2
    d = c // heads
    q, k, v = (_rn(gen, b, s, heads, d) for _ in range(3))
    o = sd_flash.sd_self_attention_reference(q, k, v, d ** -0.5)
    assert absorb.row_stride(o) is None
    w, bias, resid = _rn(gen, c, c, scale=c ** -0.5), _rn(gen, c), _rn(gen, b, s, c)
    with pytest.raises(ValueError, match="row_stride"):
        absorb.attn_out_residual_fused(o, w, bias, resid)
    long = _rn(gen, 2, 100, heads, d)
    with pytest.raises(ValueError, match="row_stride"):
        absorb.attn_out_residual_fused(long[:, :s], w, bias,
                                       _rn(gen, 2, s, c))
    got = absorb.attn_out_residual_fused(o.contiguous(), w, bias, resid)
    ref = absorb.attn_out_residual_fused(o, w, bias, resid, use_kernels=False)
    assert _rel(got, ref) < REL_TOL
    x, (wq, wk, wv, wo), bo, ln = _absorb_inputs(gen, b, s, c)
    args = (x, wq, wk, wv, wo, bo, heads, d ** -0.5, (*ln, 1e-5), "1")
    _build.reset_launch_counts()
    got = absorb.absorbed_self_attention(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["plain:sd_self_attention"] == 1
    assert _build.LAUNCHES["ln_qkv_fused"] == 1
    assert _build.LAUNCHES["attn_out_residual_fused"] == 1
    assert _rel(got, absorb.absorbed_self_attention(
        *args, use_kernels=False)) < REL_TOL


@pytest.mark.parametrize("prologue,res", [(True, True), (True, False),
                                          (False, True), (False, False)])
@pytest.mark.parametrize("shape,split", [
    ((3, 13, 9, 40, 72), False),      # two 8x8 tiles each way, across the edge
    ((1, 7, 7, 8, 8), False),         # under a tile, a chunk and a column tile
    ((2, 20, 12, 320, 136), True),    # 12 tiles x 1 column tile: 5 chunks split
    ((2, 8, 24, 96, 160), True),      # 8x16 tiles across the edge, 2 chunks
    ((1, 16, 16, 72, 168), True),     # a ragged second chunk and column tile
    ((1, 8, 8, 256, 160), True),      # one block without the split: 4 splits
    ((4, 32, 32, 128, 640), False),   # 128 blocks: a split is forbidden
])
def test_conv_chain_kernel_matches_plain(gen, shape, split, prologue, res):
    """Kernel 7 at ragged shapes: H and W under and across the 8 x 8 and
    8 x 16 pixel tiles (every pixel of a 7x7 image is on or next to the
    border), Cin below and no multiple of the 64-channel chunk, Cout below
    and no multiple of the 160-column tile, with the depth split over blocks
    and without."""
    b, h, w, cin, cout = shape
    plan = chain.chain_plan(*shape, _build.sm_count(torch.device("cuda", 0)))
    assert (plan.split > 1) == split
    cl = torch.channels_last
    x = _rn(gen, b, cin, h, w).contiguous(memory_format=cl)
    wt = _rn(gen, cout, cin, 3, 3, scale=(9 * cin) ** -0.5
             ).contiguous(memory_format=cl)
    bt = _rn(gen, b, cout, scale=0.1)
    scale = shift = None
    if prologue:
        scale = _rn(gen, b, cin, scale=0.1, dtype=torch.float32) + 1
        shift = _rn(gen, b, cin, scale=0.5, dtype=torch.float32)
    r = _rn(gen, b, cout, h, w).contiguous(memory_format=cl) if res else None
    _build.reset_launch_counts()
    got = chain.conv3x3_chain(x, wt, bt, scale, shift, residual=r,
                              prologue=prologue)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["conv3x3_chain"] == 1
    assert got.is_contiguous(memory_format=cl)
    ref = chain.conv3x3_chain(x, wt, bt, scale, shift, residual=r,
                              prologue=prologue, use_kernels=False)
    assert _rel(got, ref) < REL_TOL


@pytest.mark.parametrize("shape", [(4, 8, 8, 1280, 1280),
                                   (2, 20, 12, 320, 136)])
def test_conv_chain_split_is_bit_equal_on_a_repeat(gen, shape):
    """The split partial sums are added in a fixed order: the same input
    gives the same bits, launch after launch."""
    b, h, w, cin, cout = shape
    dev = torch.device("cuda", 0)
    assert chain.chain_plan(*shape, _build.sm_count(dev)).split > 1
    cl = torch.channels_last
    x = _rn(gen, b, cin, h, w).contiguous(memory_format=cl)
    wt = _rn(gen, cout, cin, 3, 3, scale=(9 * cin) ** -0.5
             ).contiguous(memory_format=cl)
    bt = _rn(gen, b, cout, scale=0.1)
    scale = _rn(gen, b, cin, scale=0.1, dtype=torch.float32) + 1
    shift = _rn(gen, b, cin, scale=0.5, dtype=torch.float32)
    r = _rn(gen, b, cout, h, w).contiguous(memory_format=cl)
    outs = [chain.conv3x3_chain(x, wt, bt, scale, shift, residual=r)
            for _ in range(4)]
    torch.cuda.synchronize()
    for y in outs[1:]:
        assert torch.equal(y, outs[0])


def test_conv_chain_kernel_refuses_nchw_memory(gen):
    x = _rn(gen, 1, 8, 8, 8)
    wt = _rn(gen, 8, 8, 3, 3).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="channels_last"):
        chain.conv3x3_chain(x, wt, _rn(gen, 1, 8), prologue=False)


def test_unet_call_with_the_modes_on_matches_modes_off(gen):
    """One UNet call at SD1.5 widths (16x16 latents) with `attn_absorb` and
    `conv_chain` on: all 16 self-attentions and all 44 resblock convs take
    the kernels, and eps agrees with the modes-off UNet on the same weights
    at bf16 rounding scale."""
    from diffusion_models_moe_tpu_torch import sd15_config
    from diffusion_models_moe_tpu_torch.models.layers import cast_model
    from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
    with torch.device("cuda"):
        off = cast_model(UNet2DCondition(sd15_config(torch.bfloat16).unet),
                         torch.bfloat16).eval()
        on = cast_model(UNet2DCondition(sd15_config(
            torch.bfloat16, attn_absorb="1", conv_chain=True).unet),
            torch.bfloat16).eval()
    on.load_state_dict(off.state_dict(), strict=True)
    lat = torch.randn((2, 4, 16, 16), generator=gen, device="cuda")
    ctx = torch.randn((2, 77, 768), generator=gen, device="cuda")
    _build.reset_launch_counts()
    with torch.no_grad():
        eps_on = on(lat, 500, ctx)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        eps_off = off(lat, 500, ctx)
    assert counts["ln_qkv_fused"] == counts["attn_out_residual_fused"] == 16
    assert counts["conv3x3_chain"] == 44
    assert torch.isfinite(eps_on).all()
    assert ((eps_on.float() - eps_off.float()).norm()
            / eps_off.float().norm()).item() < 0.05


def _route_inputs(gen, n, e, hdim):
    """bf16 hidden and an activated gate as the FF makes them, and bf16
    patterns of random balanced labels."""
    hidden = _rn(gen, n, hdim)
    gate = torch.nn.functional.gelu(_rn(gen, n, hdim, dtype=torch.float32)
                                    ).bfloat16()
    lab = np.random.RandomState(e).permutation(np.arange(hdim) % e)
    return hidden, gate, patterns_from_labels(lab, e).to("cuda", torch.bfloat16)


@pytest.mark.parametrize("e", [64, 128, 256])
def test_routing_kernel_matches_plain(gen, e):
    """Kernel 4 at a ragged N: selections read back from its product agree
    with the plain version's as the FF kernel's do, and the products agree
    on agreeing rows."""
    n, hdim, k = 3000, 20 * e, int(0.3 * e)
    hidden, gate, pat = _route_inputs(gen, n, e, hdim)
    if e == 128:
        # the FF hands in hidden as a view of its (N, 2H) projection
        hidden = torch.cat([hidden, gate], dim=1)[:, :hdim]
    _build.reset_launch_counts()
    out = routing_kernel.fused_route_multiply(hidden, gate, pat, k)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_route_multiply"] == 1
    plain = routing_kernel.fused_route_multiply(hidden, gate, pat, k,
                                                use_kernels=False)
    sel_k = ((out != 0).float() @ pat.float().t() > 0).float()
    _, sel_p = routing_mask(gate, pat, k)
    assert (sel_k == sel_p).float().mean().item() >= DECISION_AGREEMENT
    rows = (sel_k == sel_p).all(dim=1)
    assert rows.float().mean().item() >= ROW_AGREEMENT
    assert _rel(out[rows], plain[rows]) < REL_TOL


@pytest.mark.parametrize("n", [77, 1000, 4100])
@pytest.mark.parametrize("c,hdim,e", FF_SD15)
def test_routing_kernel_at_sd15_widths_and_ragged_rows(gen, c, hdim, e, n):
    """Kernel 4 at every SD1.5 FF width with ragged N, hidden read in place
    as the first half of the (N, 2H) projection, and with rows of the
    patterns zeroed as expert_remove zeroes them."""
    k = int(0.3 * e)
    hidden, gate, pat = _route_inputs(gen, n, e, hdim)
    hidden = torch.cat([hidden, gate], dim=1)[:, :hdim]
    for p in (pat, pat * (torch.arange(e, device="cuda") % 7 != 3)[:, None]):
        p = p.to(torch.bfloat16).contiguous()
        out = routing_kernel.fused_route_multiply(hidden, gate, p, k)
        plain = routing_kernel.fused_route_multiply(hidden, gate, p, k,
                                                    use_kernels=False)
        sel_k = ((out != 0).float() @ p.float().t() > 0).float()
        _, sel_p = routing_mask(gate, p, k)
        # zeroed experts have no neuron: compare the experts that have one
        live = p.float().sum(1) > 0
        agree = (sel_k == sel_p)[:, live]
        assert agree.float().mean().item() >= DECISION_AGREEMENT
        rows = agree.all(dim=1)
        assert rows.float().mean().item() >= ROW_AGREEMENT
        assert _rel(out[rows], plain[rows]) < REL_TOL


def test_routing_kernel_refuses_a_misaligned_row_stride(gen):
    """hidden's rows must lie a multiple of 8 elements apart (the TMA's
    16-byte strides)."""
    hidden, gate, pat = _route_inputs(gen, 64, 16, 320)
    wide = torch.cat([hidden, hidden[:, :4]], dim=1)[:, :320]
    with pytest.raises(ValueError, match="multiple of 8"):
        routing_kernel.fused_route_multiply(wide, gate, pat, 4)


def test_tapped_routed_unet_call_runs_the_routing_kernel(gen):
    """One UNet call at SD1.5 widths (16x16 latents) with MoE on all 16 FFs
    and a max-gate tap: every FF takes kernel 4, none the fused FF."""
    from diffusion_models_moe_tpu_torch import (build_moe_interventions,
                                                sd15_config)
    from diffusion_models_moe_tpu_torch.models.layers import cast_model
    from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
    cfg = sd15_config(torch.bfloat16).unet
    with torch.device("cuda"):
        unet = cast_model(UNet2DCondition(cfg), torch.bfloat16).eval()
    rng = np.random.RandomState(0)
    labels = {f"ff_{i:02d}": rng.permutation(np.arange(4 * d) % (4 * d // 20))
              for i, d in enumerate(cfg.ff_dims())}
    ivs = build_moe_interventions(labels, 0.3, device="cuda",
                                  dtype=torch.bfloat16)
    lat = torch.randn((2, 4, 16, 16), generator=gen, device="cuda")
    ctx = torch.randn((2, 77, 768), generator=gen, device="cuda")
    taps = {}
    _build.reset_launch_counts()
    with torch.no_grad():
        eps = unet(lat, 500, ctx, ivs=ivs, tap=TapSpec(max_gate=True),
                   taps_out=taps)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_route_multiply"] == 16
    assert _build.LAUNCHES["geglu_ff_fused"] == 0
    assert torch.isfinite(eps).all()
    assert sorted(taps["max_gate"]) == list(range(16))
    for l, d in enumerate(cfg.ff_dims()):
        assert taps["max_gate"][l].shape == (4 * d,)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape,split", [
    ((3, 18, 22, 24, 136), False),   # H != W across the 16-pixel squares, Cin
                                     # under a chunk, Cout no multiple of the
                                     # column tile, batch 3
    ((1, 16, 16, 16, 128), False),   # the least geometry fused_ok admits
    ((2, 20, 16, 72, 264), True),    # three chunks (the last ragged) split,
                                     # three column blocks
    ((1, 16, 48, 96, 128), True),    # three squares, three whole chunks split
    ((1, 16, 16, 40, 136), True),    # Cin 40: a ragged second chunk, split
    ((4, 64, 64, 40, 256), False),   # 128 blocks: a split is forbidden
])
def test_winograd_kernel_matches_plain(gen, shape, split, bias):
    """Kernel 8 at ragged shapes against its plain version and, at twice the
    limit (the plain version shares the kernel's rounding of V and U, cuDNN
    does not), against the direct convolution, with the depth split over
    blocks and without."""
    b, h, w, cin, cout = shape
    assert wino.fused_ok(h, w, cin, cout)
    plan = wino.fused_plan(*shape, _build.sm_count(torch.device("cuda", 0)))
    assert (plan.split > 1) == split
    x = _rn(gen, b, cin, h, w).contiguous(memory_format=torch.channels_last)
    wt = _rn(gen, cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    bs = _rn(gen, cout, scale=0.1) if bias else None
    u = wino.fused_filter(wt)
    _build.reset_launch_counts()
    y = wino.winograd3x3_fused(x, u, bs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["winograd3x3_fused"] == 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    plain = wino.winograd3x3_fused(x, u, bs, use_kernels=False)
    assert _build.LAUNCHES["winograd3x3_fused"] == 1
    assert _rel(y, plain) < REL_TOL
    direct = torch.nn.functional.conv2d(x, wt, bs, padding=1)
    assert _rel(y, direct) < 2 * REL_TOL


def test_winograd_split_is_bit_equal_on_a_repeat(gen):
    """The split partial planes are added in a fixed order: the same input
    gives the same bits, launch after launch."""
    b, h, w, cin, cout = shape = (4, 16, 16, 1280, 1280)
    assert wino.fused_plan(
        *shape, _build.sm_count(torch.device("cuda", 0))).split > 1
    x = _rn(gen, b, cin, h, w).contiguous(memory_format=torch.channels_last)
    u = wino.fused_filter(_rn(gen, cout, cin, 3, 3, scale=(9 * cin) ** -0.5))
    bs = _rn(gen, cout, scale=0.1)
    outs = [wino.winograd3x3_fused(x, u, bs) for _ in range(4)]
    torch.cuda.synchronize()
    for y in outs[1:]:
        assert torch.equal(y, outs[0])


def test_winograd_kernel_refuses_nchw_memory(gen):
    x = _rn(gen, 1, 16, 16, 16)
    u = wino.fused_filter(_rn(gen, 128, 16, 3, 3))
    with pytest.raises(ValueError, match="channels_last"):
        wino.winograd3x3_fused(x, u)
    with pytest.raises(ValueError, match="dtype"):
        wino.winograd3x3_fused(
            x.float().contiguous(memory_format=torch.channels_last), u.float())


def test_unet_call_with_fused_winograd_counts_its_launches(gen):
    """One UNet call at SD1.5 widths on 64 x 64 latents with
    `conv_winograd="fused"`: the 30 resblock convs above 8 x 8 and the 3
    upsampler convs take kernel 8, no conv the chain kernel, and the result
    agrees with the modes-off UNet on the same weights."""
    from diffusion_models_moe_tpu_torch import sd15_config
    from diffusion_models_moe_tpu_torch.models.layers import cast_model
    from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
    with torch.device("cuda"):
        on = cast_model(UNet2DCondition(sd15_config(
            torch.bfloat16, conv_winograd="fused", conv_chain=True).unet),
            torch.bfloat16).eval()
        off = cast_model(UNet2DCondition(sd15_config(torch.bfloat16).unet),
                         torch.bfloat16).eval()
    with torch.no_grad():
        for p in on.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device="cuda")
                    * (p[0].numel() ** -0.5 if p.dim() > 1 else 0.02)
                    + (1.0 if p.dim() == 1 else 0.0))
    off.load_state_dict(on.state_dict(), strict=True)
    lat = torch.randn((2, 4, 64, 64), generator=gen, device="cuda")
    ctx = torch.randn((2, 77, 768), generator=gen, device="cuda")
    _build.reset_launch_counts()
    with torch.no_grad():
        eps = on(lat, 500, ctx)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["winograd3x3_fused"] == 33
    assert _build.LAUNCHES["conv3x3_chain"] == 0
    with torch.no_grad():
        ref = off(lat, 500, ctx)
    assert torch.isfinite(eps).all()
    assert ((eps - ref).norm() / ref.norm()).item() < 0.05


# SD2.1-768 at UNet batch 4 (2 requests with CFG): (tokens, channels, heads)
# of the four levels, 64-dim heads throughout
SD21_LEVELS = [(9216, 320, 5), (2304, 640, 10), (576, 1280, 20),
               (144, 1280, 20)]


@pytest.mark.parametrize("s,c,heads", SD21_LEVELS)
def test_geglu_ff_kernel_at_sd21_shapes(gen, s, c, heads):
    """Kernel 1 routed with LN at each SD2.1-768 FF shape (N = 4 S, up to
    36 864 rows at C = 320) against its plain version."""
    hdim, e = 4 * c, 4 * c // 20
    w1, b1, w2, b2, ln, pat = _ff_weights(gen, c, hdim, e)
    y = _ff_agrees(_rn(gen, 4 * s, c), w1, b1, w2, b2, pat, int(0.3 * e), **ln)
    assert torch.isfinite(y.float()).all()


@pytest.mark.parametrize("kind", ["self", "cross"])
@pytest.mark.parametrize("s,c,heads", SD21_LEVELS)
def test_attention_kernels_at_sd21_shapes(gen, s, c, heads, kind):
    """Kernels 2 and 3 at SD2.1-768's shapes: 5 to 20 heads of 64 over 9216
    to 144 queries, self or over 77 keys, on projection outputs viewed as
    (B, S, H, D)."""
    q = _heads(gen, 4, s, heads, 64, False)
    n_kv = s if kind == "self" else 77
    k, v = (_heads(gen, 4, n_kv, heads, 64, False) for _ in range(2))
    assert sd_flash.attn_kernel_ok(q, k, None if kind == "self" else 77, v)
    if kind == "self":
        def fn(uk):
            return sd_flash.sd_self_attention(q, k, v, 0.125, use_kernels=uk)
    else:
        def fn(uk):
            return sd_flash.sd_cross_attention(q, k, v, 0.125, 77,
                                               use_kernels=uk)
    _build.reset_launch_counts()
    o = fn(True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"sd_{kind}_attention"] == 1
    assert _rel(o, fn(False)) < REL_TOL


@pytest.mark.parametrize("kind", ["qkv", "out"])
@pytest.mark.parametrize("s,c,heads", SD21_LEVELS)
def test_absorb_kernels_at_sd21_shapes(gen, s, c, heads, kind):
    """Kernels 5 and 6 at SD2.1-768's shapes (whole heads of 64: 5 at
    C = 320) against their plain versions, bit-equal on a repeat."""
    b = 4
    assert absorb.attn_absorb_ok(s, c, heads)
    x, (wq, wk, wv, wo), bo, ln = _absorb_inputs(gen, b, s, c)
    if kind == "qkv":
        def run(uk=True):
            return torch.cat([t.reshape(b, s, c) for t in absorb.ln_qkv_fused(
                x, wq, wk, wv, heads, *ln, use_kernels=uk)], dim=-1)
    else:
        o = _rn(gen, b, s, heads, c // heads)

        def run(uk=True):
            return absorb.attn_out_residual_fused(o, wo, bo, x,
                                                  use_kernels=uk)
    got = run()
    assert _rel(got, run(False)) < REL_TOL
    assert torch.equal(got, run())


def test_sd2_shaped_generate_takes_the_kernels(gen):
    """A 2-step generate of an SD2-shaped model at small width on the card
    (DDIM, v-prediction, per-block heads (1, 2, 4, 4) of 64, exact-GELU text
    tower, bf16): every attention and FF call on the kernels, none on a
    plain version."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                sd21_config, tiny_config)
    base = sd21_config(torch.bfloat16)
    tiny = tiny_config(torch.bfloat16)
    cfg = dataclasses.replace(
        base, sample_size=16, vae=tiny.vae,
        unet=dataclasses.replace(base.unet, block_out_channels=(64, 128, 256,
                                                                256),
                                 attention_head_dim=(1, 2, 4, 4),
                                 cross_attention_dim=64),
        text_encoder=dataclasses.replace(tiny.text_encoder, hidden_size=64,
                                         hidden_act="gelu"))
    pipe = StableDiffusionPipeline(cfg, device="cuda")
    pipe.init_params(torch.Generator(device="cuda").manual_seed(0))
    cond = torch.randint(0, cfg.text_encoder.vocab_size,
                         (2, cfg.text_encoder.max_length), device="cuda")
    _build.reset_launch_counts()
    images, _ = pipe.generate(cond, torch.zeros_like(cond), seeds=[0, 1],
                              num_steps=2)
    torch.cuda.synchronize()
    assert images.shape == (2, 3, 128, 128) and torch.isfinite(images).all()
    calls = 16 * 2          # 16 attention layers and FFs, DDIM's 2 steps
    for name in ("sd_self_attention", "sd_cross_attention", "geglu_ff_fused"):
        assert _build.LAUNCHES[name] == calls, name
    assert all(_build.LAUNCHES[k] == 0 for k in _build.PLAIN)


# SDXL at UNet batch 4 (2 requests with CFG, 128 x 128 latents): (tokens,
# channels, heads) of its two attention levels, 64-dim heads
SDXL_LEVELS = [(4096, 640, 10), (1024, 1280, 20)]


@pytest.mark.parametrize("s,c,heads", SDXL_LEVELS)
def test_geglu_ff_kernel_at_sdxl_shapes(gen, s, c, heads):
    """Kernel 1 routed with LN at each SDXL FF shape (N = 16 384 rows at
    C = 640, E = 128; N = 4096 at C = 1280, E = 256) against its plain
    version, whole rows held to what the decision limit implies at E (a
    near tie flips two of a row's E decisions), as chip_smoke.py holds
    them."""
    hdim, e = 4 * c, 4 * c // 20
    w1, b1, w2, b2, ln, pat = _ff_weights(gen, c, hdim, e)
    limit = 1.0 - e * (1.0 - DECISION_AGREEMENT) / 2
    y = _ff_agrees(_rn(gen, 4 * s, c), w1, b1, w2, b2, pat, int(0.3 * e),
                   row_limit=limit, **ln)
    assert torch.isfinite(y.float()).all()


@pytest.mark.parametrize("kind", ["self", "cross"])
@pytest.mark.parametrize("s,c,heads", SDXL_LEVELS)
def test_attention_kernels_at_sdxl_shapes(gen, s, c, heads, kind):
    """Kernels 2 and 3 at SDXL's shapes: 10 and 20 heads of 64 over 4096 and
    1024 queries, self or over 77 keys."""
    q = _heads(gen, 4, s, heads, 64, False)
    n_kv = s if kind == "self" else 77
    k, v = (_heads(gen, 4, n_kv, heads, 64, False) for _ in range(2))
    assert sd_flash.attn_kernel_ok(q, k, None if kind == "self" else 77, v)
    if kind == "self":
        def fn(uk):
            return sd_flash.sd_self_attention(q, k, v, 0.125, use_kernels=uk)
    else:
        def fn(uk):
            return sd_flash.sd_cross_attention(q, k, v, 0.125, 77,
                                               use_kernels=uk)
    _build.reset_launch_counts()
    o = fn(True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"sd_{kind}_attention"] == 1
    assert _rel(o, fn(False)) < REL_TOL


@pytest.mark.parametrize("kind", ["qkv", "out"])
@pytest.mark.parametrize("s,c,heads", SDXL_LEVELS)
def test_absorb_kernels_at_sdxl_shapes(gen, s, c, heads, kind):
    """Kernels 5 and 6 at SDXL's shapes (C = 640 and 1280) against their
    plain versions, bit-equal on a repeat."""
    b = 4
    assert absorb.attn_absorb_ok(s, c, heads)
    x, (wq, wk, wv, wo), bo, ln = _absorb_inputs(gen, b, s, c)
    if kind == "qkv":
        def run(uk=True):
            return torch.cat([t.reshape(b, s, c) for t in absorb.ln_qkv_fused(
                x, wq, wk, wv, heads, *ln, use_kernels=uk)], dim=-1)
    else:
        o = _rn(gen, b, s, heads, c // heads)

        def run(uk=True):
            return absorb.attn_out_residual_fused(o, wo, bo, x,
                                                  use_kernels=uk)
    got = run()
    assert _rel(got, run(False)) < REL_TOL
    assert torch.equal(got, run())


@pytest.mark.parametrize("shape", [(4, 128, 128, 320, 320),
                                   (4, 128, 128, 960, 320),
                                   (4, 64, 64, 1920, 640),
                                   (4, 32, 32, 2560, 1280)])
def test_conv_kernels_at_sdxl_shapes(gen, shape):
    """Kernels 7 and 8 at SDXL resblock conv shapes (batch 4: 128 x 128 at
    320 channels to 32 x 32 at 1280, channel-changing ones included)
    against their plain versions."""
    b, h, w, cin, cout = shape
    cl = torch.channels_last
    x = _rn(gen, b, cin, h, w).contiguous(memory_format=cl)
    wt = _rn(gen, cout, cin, 3, 3, scale=(9 * cin) ** -0.5
             ).contiguous(memory_format=cl)
    bt = _rn(gen, b, cout, scale=0.1)
    scale = _rn(gen, b, cin, scale=0.1, dtype=torch.float32) + 1
    shift = _rn(gen, b, cin, scale=0.5, dtype=torch.float32)
    r = _rn(gen, b, cout, h, w).contiguous(memory_format=cl)
    assert chain.chain_ok(h, w, cin, cout) and wino.fused_ok(h, w, cin, cout)
    got = chain.conv3x3_chain(x, wt, bt, scale, shift, residual=r)
    assert _rel(got, chain.conv3x3_chain(x, wt, bt, scale, shift, residual=r,
                                         use_kernels=False)) < REL_TOL
    u = wino.fused_filter(wt)
    y = wino.winograd3x3_fused(x, u, bt[0])
    assert _rel(y, wino.winograd3x3_fused(x, u, bt[0],
                                          use_kernels=False)) < REL_TOL


def test_winograd_kernel_at_the_1024px_decode(gen):
    """Kernel 8 at the largest conv of SDXL's VAE decode (1024 x 1024, 128
    channels, batch 2) against its plain version."""
    x = _rn(gen, 2, 128, 1024, 1024).contiguous(
        memory_format=torch.channels_last)
    wt = _rn(gen, 128, 128, 3, 3, scale=(9 * 128) ** -0.5)
    u, bias = wino.fused_filter(wt), _rn(gen, 128, scale=0.1)
    y = wino.winograd3x3_fused(x, u, bias)
    assert _rel(y, wino.winograd3x3_fused(x, u, bias,
                                          use_kernels=False)) < REL_TOL


def test_sdxl_shaped_generate_takes_the_kernels(gen):
    """A 2-step generate of an SDXL-shaped model at small width on the card
    (Euler, depth (0, 2, 2) with heads of 64, two text towers, the added
    conditioning, bf16), MoE routing on every FF: every attention and FF
    call on the kernels, none on a plain version."""
    from diffusion_models_moe_tpu_torch import (SDXLPipeline,
                                                build_moe_interventions,
                                                sdxl_config, tiny_config)
    from diffusion_models_moe_tpu_torch.taps import layer_name
    base = sdxl_config(torch.bfloat16)
    tiny = tiny_config(torch.bfloat16)
    tc1 = dataclasses.replace(tiny.text_encoder, hidden_size=64)
    tc2 = dataclasses.replace(tiny.text_encoder, hidden_size=128,
                              hidden_act="gelu")
    cfg = dataclasses.replace(
        base, sample_size=16, vae=tiny.vae,
        unet=dataclasses.replace(base.unet, block_out_channels=(64, 128, 256),
                                 attention_head_dim=(1, 2, 4),
                                 transformer_layers_per_block=(0, 2, 2),
                                 cross_attention_dim=192,
                                 addition_embed_dim=128,
                                 addition_time_embed_dim=32))
    pipe = SDXLPipeline(cfg, (tc1, tc2), device="cuda")
    pipe.init_params(torch.Generator(device="cuda").manual_seed(0))
    dims = cfg.unet.ff_dims()
    labels = {layer_name(i): np.random.RandomState(i).permutation(
        np.arange(4 * d) % ((4 * d) // 16)) for i, d in enumerate(dims)}
    ivs = build_moe_interventions(labels, 0.3, device="cuda",
                                  dtype=torch.bfloat16)
    cond = torch.randint(0, tc1.vocab_size, (2, tc1.max_length),
                         device="cuda")
    _build.reset_launch_counts()
    images, _ = pipe.generate(cond, torch.zeros_like(cond), seeds=[0, 1],
                              num_steps=2, ivs=ivs)
    torch.cuda.synchronize()
    assert images.shape == (2, 3, 128, 128) and torch.isfinite(images).all()
    calls = len(dims) * 2
    for name in ("sd_self_attention", "sd_cross_attention", "geglu_ff_fused"):
        assert _build.LAUNCHES[name] == calls, name
    assert all(_build.LAUNCHES[k] == 0 for k in _build.PLAIN)


def test_sinkhorn_plan_on_the_card_matches_the_cpu(gen):
    """The Sinkhorn plan of balanced k-means in float32 on the card against
    the same plan on the CPU, at an SD1.5 gate's cost shape (5120 neurons,
    256 experts) and the annealed eps of Lloyd iterations 0 and 24."""
    from diffusion_models_moe_tpu_torch.moefication import cluster
    cost = torch.rand((5120, 256), generator=gen, device="cuda",
                      dtype=torch.float64) * 4.0
    for it in (0, 24):
        eps = float(np.float32(0.05 * 0.85 ** it))
        got = cluster._sinkhorn_plan(cost, eps).cpu()
        ref = cluster._sinkhorn_plan(cost.cpu(), eps)
        assert ((got - ref).abs().max() / ref.abs().max()).item() < 1e-4, it


def test_moefy_unet_on_the_card_equals_the_cpu_on_separable_gates(gen):
    """`moefy_unet` with its Sinkhorn plans on the card gives the CPU's
    labels where every gate's rows form well-separated clusters of 16."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                tiny_config)
    from diffusion_models_moe_tpu_torch.moefication import moefy
    cfg = tiny_config()
    pipe = StableDiffusionPipeline(cfg, device="cpu")
    state = dict(pipe.unet.state_dict())
    rng = np.random.RandomState(0)
    for path, d in zip(moefy.ff_param_paths(cfg.unet), cfg.unet.ff_dims()):
        w = state[f"{path}.net.0.proj.weight"].clone()
        h = w.shape[0] // 2
        centers = rng.randn(h // 16, d) * 4
        rows = centers[rng.permutation(np.arange(h) % (h // 16))]
        w[h:] = torch.from_numpy(rows + 0.05 * rng.randn(h, d))
        state[f"{path}.net.0.proj.weight"] = w
    got = moefy.moefy_unet(state, cfg.unet, expert_size=16, device="cuda")
    ref = moefy.moefy_unet(state, cfg.unet, expert_size=16, device="cpu")
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_tiny_snapshot_reads_onto_the_card(gen, tmp_path):
    """A tiny diffusers snapshot written by the port's writer loads into a
    pipeline on the card, every tensor equal to what was written."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                tiny_config)
    from diffusion_models_moe_tpu_torch.weights.export import save_safetensors
    from diffusion_models_moe_tpu_torch.weights.port import \
        load_pipeline_snapshot
    cfg = tiny_config()
    src = StableDiffusionPipeline(cfg, device="cuda")
    src.init_params(gen)
    for sub, name, module in (
            ("unet", "diffusion_pytorch_model", src.unet),
            ("text_encoder", "model", src.text_encoder),
            ("vae", "diffusion_pytorch_model", src.vae_decoder)):
        save_safetensors(module.state_dict(),
                         str(tmp_path / sub / f"{name}.safetensors"))
    pipe = StableDiffusionPipeline(cfg, device="cuda")
    pipe.load_state_dicts(load_pipeline_snapshot(str(tmp_path), cfg))
    for key, module in src.modules().items():
        got = pipe.modules()[key].state_dict()
        for name, t in module.state_dict().items():
            assert got[name].is_cuda and torch.equal(got[name], t), name


# PixArt-alpha: heads of 72 (1152 / 16) and T5's 120 caption positions
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("s", [77, 1000, 1024])
def test_attention_kernels_at_head_dim_72(gen, s, strided):
    """Kernels 2 and 3 at D = 72 (three 64-byte chunks a row, the third
    padded by the TMA's zeros) at ragged S; the cross kernel over 120 keys
    with 120, 100 and 1 valid (its 128-key tile) and over 77 (the 80-key
    tile)."""
    b, h, d = 2, 3, 72
    q, k, v = (_heads(gen, b, s, h, d, strided) for _ in range(3))
    kc, vc = (_heads(gen, b, 120, h, d, strided) for _ in range(2))
    _build.reset_launch_counts()
    o = sd_flash.sd_self_attention(q, k, v, d ** -0.5)
    ref = sd_flash.sd_self_attention(q, k, v, d ** -0.5, use_kernels=False)
    assert _rel(o, ref) < REL_TOL
    for n_kv, kv_valid, tile in ((120, 120, 128), (120, 100, 128),
                                 (120, 1, 80), (77, 77, 80)):
        kk, vv = kc[:, :n_kv], vc[:, :n_kv]
        assert sd_flash.attn_kernel_ok(q, kk, kv_valid, vv)
        assert sd_flash.attn_plan("cross", b, h, s, kv_valid, d,
                                  _build.sm_count(q.device)).bkv == tile
        o = sd_flash.sd_cross_attention(q, kk, vv, d ** -0.5, kv_valid)
        ref = sd_flash.sd_cross_attention(q, kk, vv, d ** -0.5, kv_valid,
                                          use_kernels=False)
        assert _rel(o, ref) < REL_TOL, (n_kv, kv_valid)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sd_self_attention"] == 1
    assert _build.LAUNCHES["sd_cross_attention"] == 4


@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_cross_attention_key_tiles_at_every_head_dim(gen, d):
    """SD's 77 keys keep the 80-key tile at every head dim; 120 keys take
    the 128-key tile up to D = 80, and at D = 160 the predicate refuses them
    and the wrapper raises."""
    b, h, s = 2, 3, 200
    q = _heads(gen, b, s, h, d, False)
    k, v = (_heads(gen, b, 120, h, d, False) for _ in range(2))
    sms = _build.sm_count(q.device)
    assert sd_flash.attn_plan("cross", b, h, s, 77, d, sms).bkv == 80
    o = sd_flash.sd_cross_attention(q, k, v, d ** -0.5, 77)
    assert _rel(o, sd_flash.sd_cross_attention(
        q, k, v, d ** -0.5, 77, use_kernels=False)) < REL_TOL
    if d == 160:
        assert not sd_flash.attn_kernel_ok(q, k, 120, v)
        with pytest.raises(ValueError):
            sd_flash.sd_cross_attention(q, k, v, d ** -0.5, 120)
        return
    assert sd_flash.attn_plan("cross", b, h, s, 120, d, sms).bkv == 128
    o = sd_flash.sd_cross_attention(q, k, v, d ** -0.5, 120)
    assert _rel(o, sd_flash.sd_cross_attention(
        q, k, v, d ** -0.5, 120, use_kernels=False)) < REL_TOL


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_attention_kernels_at_pixart_shapes(gen, kind):
    """Kernels 2 and 3 at PixArt-512's shapes: DiT batch 4, 16 heads of 72
    over 1024 queries, self or over T5's 120 keys, all valid."""
    q = _heads(gen, 4, 1024, 16, 72, False)
    n_kv = 1024 if kind == "self" else 120
    k, v = (_heads(gen, 4, n_kv, 16, 72, False) for _ in range(2))
    scale = 72 ** -0.5
    if kind == "self":
        def fn(uk):
            return sd_flash.sd_self_attention(q, k, v, scale, use_kernels=uk)
    else:
        def fn(uk):
            return sd_flash.sd_cross_attention(q, k, v, scale, 120,
                                               use_kernels=uk)
    _build.reset_launch_counts()
    o = fn(True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"sd_{kind}_attention"] == 1
    assert _rel(o, fn(False)) < REL_TOL


def test_pixart_dit_runs_the_attention_kernels(gen):
    """A bf16 DiT of two blocks with heads of 72 and 120 caption positions:
    every self- and cross-attention on kernels 2 and 3, no plain call (its
    FFs are non-gated: no FF kernel applies), eps within 0.05 of the plain
    versions'."""
    from diffusion_models_moe_tpu_torch.models.layers import cast_model
    from diffusion_models_moe_tpu_torch.models.pixart import (
        PixArtConfig, PixArtTransformer2D)
    from diffusion_models_moe_tpu_torch.pipelines.pixart import init_module
    cfg = PixArtConfig(hidden_size=144, num_heads=2, num_layers=2,
                       cross_attention_dim=144, text_in_dim=64,
                       dtype=torch.bfloat16)
    with torch.device("cuda"):
        dit = cast_model(PixArtTransformer2D(cfg, 16), torch.bfloat16).eval()
    init_module(dit, gen)
    lat = torch.randn((2, 4, 16, 16), generator=gen, device="cuda")
    ctx = _rn(gen, 2, 120, 64)
    _build.reset_launch_counts()
    with torch.no_grad():
        eps = dit(lat, 500, ctx)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        ref = dit(lat, 500, ctx, use_kernels=False)
    assert counts["sd_self_attention"] == counts["sd_cross_attention"] == 2
    assert not any(counts[k] for k in _build.PLAIN)
    assert torch.isfinite(eps).all()
    assert ((eps - ref).norm() / ref.norm()).item() < 0.05


# ------------------------------------------------------- the judges (phase 16)
JUDGE_TOL = 1e-4     # card against CPU, f32 both (chip_smoke.py JUDGE_TOL)


def _judge(kind: str, device: str):
    from diffusion_models_moe_tpu_torch.models import backbones as bb
    from diffusion_models_moe_tpu_torch.models.clip_vision import (
        CLIPVisionConfig, CLIPVisionEncoder)
    from diffusion_models_moe_tpu_torch.models.inception import InceptionV3
    return {"vit_l14": lambda: CLIPVisionEncoder(CLIPVisionConfig(),
                                                 device=device),
            "vit_b32": lambda: CLIPVisionEncoder(CLIPVisionConfig(
                patch_size=32, hidden_size=768, intermediate_size=3072,
                num_layers=12, num_heads=12, projection_dim=512),
                device=device),
            "inception": lambda: InceptionV3(device=device),
            "lpips": lambda: bb.LPIPS(device=device),
            "sscd": lambda: bb.SSCD(device=device)}[kind]()


def _judge_out(kind: str, model, images):
    from diffusion_models_moe_tpu_torch.benchmarks.fid import (
        make_clip_featurizer, make_inception_featurizer)
    from diffusion_models_moe_tpu_torch.models import backbones as bb
    if kind.startswith("vit"):
        return make_clip_featurizer(model)(images)
    if kind == "inception":
        return make_inception_featurizer(model)(images)
    if kind == "lpips":
        return bb.lpips_distance(model, images * 2 - 1, images.flip(0) * 2 - 1)
    return bb.sscd_embed(model, bb.preprocess_imagenet(images))


@pytest.mark.parametrize("kind", ["vit_l14", "vit_b32", "inception", "lpips",
                                  "sscd"])
def test_judges_on_the_card_match_the_cpu(gen, kind):
    """Each full-width judge of phase 16 with seeded weights, on the card
    (cuDNN's TF32 off for its convs) and on the CPU from the same state
    dict: outputs within JUDGE_TOL; the process's TF32 flag unchanged."""
    tf32 = torch.backends.cudnn.allow_tf32
    card = _judge(kind, "cuda")
    with torch.no_grad():
        for name, t in card.state_dict().items():
            rn = torch.randn(t.shape, generator=gen, device="cuda")
            if t.dim() <= 1:
                t.copy_(torch.rand(t.shape, generator=gen, device="cuda")
                        + 0.5 if name.endswith(("weight", "running_var"))
                        or name.startswith("lins.") else 0.1 * rn)
            else:
                t.copy_(rn * ((2.0 if t.dim() == 4 else 1.0)
                              / t[0].numel()) ** 0.5)
    cpu = _judge(kind, "cpu")
    cpu.load_state_dict(card.state_dict())
    images = torch.rand((2, 3, 256, 256), generator=gen, device="cuda")
    got = _judge_out(kind, card, images)
    ref = _judge_out(kind, cpu, images.cpu())
    assert torch.isfinite(got).all()
    assert _rel(got.cpu(), ref) < JUDGE_TOL
    assert torch.backends.cudnn.allow_tf32 == tf32


def test_checked_generate_on_the_card(gen):
    """`checked_generate` of a tiny f32 pipeline on the card, a checker
    flagging image 0: image 1 bit-equal to plain `generate`'s, image 0 its
    blur."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                tiny_config)
    from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import \
        blur_images
    from diffusion_models_moe_tpu_torch.safety import (CLIPNSFWChecker,
                                                       checked_generate)
    cfg = dataclasses.replace(tiny_config(), safety_check=True,
                              blur_nsfw=True)
    pipe = StableDiffusionPipeline(cfg)
    pipe.init_params(gen)
    cond = torch.randint(0, cfg.text_encoder.vocab_size,
                         (2, cfg.text_encoder.max_length), device="cuda",
                         generator=gen)
    checker = CLIPNSFWChecker(
        lambda x: torch.eye(2, 4, device="cuda"),
        torch.tensor([[1.0, 0, 0, 0]], device="cuda"), 0.5)
    imgs, _, flags = checked_generate(pipe, cond, torch.zeros_like(cond),
                                      seeds=[1, 2], num_steps=2,
                                      checker=checker)
    plain, _ = pipe.generate(cond, torch.zeros_like(cond), seeds=[1, 2],
                             num_steps=2)
    assert flags.tolist() == [True, False]
    assert torch.equal(imgs[1], plain[1])
    assert torch.equal(imgs[0], blur_images(plain)[0])


def test_lpips_package_path_runs_on_the_card(gen, monkeypatch):
    """`load_lpips` builds the lpips package's model on the card and runs
    it there (a stub package: no environment of the repo installs it); the
    same images on the CPU give the same distances."""
    import types
    from diffusion_models_moe_tpu_torch.benchmarks.scores import load_lpips

    seen = []

    class Stub(torch.nn.Module):
        def __init__(self, net="alex"):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor([0.5, 1.0, 2.0]))

        def forward(self, a, b):
            seen.append((a.device.type, self.w.device.type))
            d = (a - b).square() * self.w.view(1, 3, 1, 1)
            return d.mean(dim=(1, 2, 3), keepdim=True)

    stub = types.ModuleType("lpips")
    stub.LPIPS = Stub
    monkeypatch.setitem(sys.modules, "lpips", stub)
    a = torch.rand((2, 3, 64, 64), generator=gen, device="cuda")
    b = torch.rand((2, 3, 64, 64), generator=gen, device="cuda")
    card, cpu = load_lpips(), load_lpips(device="cpu")
    got, ref = card(a, b), cpu(a.cpu(), b.cpu())
    assert seen == [("cuda", "cuda"), ("cpu", "cpu")]
    assert got.shape == (2,) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= JUDGE_TOL * np.abs(ref).max()


# ----------------------------------------------- the erasure judges (phase 17)
def _seed_(module, gen):
    with torch.no_grad():
        for name, t in module.state_dict().items():
            rn = torch.randn(t.shape, generator=gen, device=t.device)
            if t.dim() <= 1:
                t.copy_(torch.rand(t.shape, generator=gen, device=t.device)
                        + 0.5 if name.endswith("weight") else 0.1 * rn)
            else:
                t.copy_(rn * ((2.0 if t.dim() == 4 else 1.0)
                              / t[0].numel()) ** 0.5)
    return module


def test_yolov8n_on_the_card_matches_the_cpu(gen):
    """NudeNet's full-width YOLOv8n (18 classes, 320 px) with seeded weights:
    boxes and class probabilities on the card within JUDGE_TOL of the CPU's,
    and the native detector's labels and scores the same on both."""
    from diffusion_models_moe_tpu_torch.benchmarks.nudity import \
        make_native_detector
    from diffusion_models_moe_tpu_torch.models.yolo import (YOLOv8,
                                                            dfl_weight,
                                                            yolov8n_config)
    cfg = yolov8n_config()
    card = _seed_(YOLOv8(cfg), gen)
    with torch.no_grad():
        card.model[22].dfl.conv.weight.copy_(dfl_weight(cfg.reg_max))
    cpu = YOLOv8(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    x = torch.rand((3, 3, cfg.imgsz, cfg.imgsz), generator=gen, device="cuda")
    for got, ref in zip(card(x), cpu(x.cpu())):
        assert torch.isfinite(got).all()
        assert _rel(got.cpu(), ref) < JUDGE_TOL
    imgs = list((x.permute(0, 2, 3, 1).cpu().numpy() * 255).round().astype(
        np.uint8))
    dets, ref = make_native_detector(card)(imgs), make_native_detector(cpu)(imgs)
    assert [[lbl for lbl, _ in d] for d in dets] == \
        [[lbl for lbl, _ in d] for d in ref]
    for a, b in zip(dets, ref):
        for (_, sa), (_, sb) in zip(a, b):
            assert abs(sa - sb) < JUDGE_TOL


def test_llama_decode_is_consistent_on_the_card(gen):
    """A full-width LLaMA-7B geometry cut to 4 layers, f32 on the card: the
    KV-cached greedy tokens of 3 right-padded prompts equal the argmax of a
    teacher-forced forward over prompt + tokens, and each prompt decoded
    alone equals its co-batched decode."""
    from diffusion_models_moe_tpu_torch.models.llama import (LlamaConfig,
                                                             LlamaModel,
                                                             embed_tokens,
                                                             greedy_decode)
    cfg = LlamaConfig(num_layers=4)
    lm = _seed_(LlamaModel(cfg), gen)
    lengths = torch.tensor([40, 57, 33], device="cuda")
    ids = torch.randint(3, cfg.vocab_size, (3, 57), generator=gen,
                        device="cuda")
    toks = greedy_decode(lm, embed_tokens(lm, ids), lengths, 12, eos_id=2)
    for r in range(3):
        n = int(lengths[r])
        seq = torch.cat([ids[r, :n], toks[r, :-1]])[None]
        pos = torch.arange(seq.shape[1], device="cuda")[None]
        logits, _ = lm(embed_tokens(lm, seq), pos,
                       torch.ones_like(seq, dtype=torch.bool))
        row = toks[r].tolist()
        m = row.index(2) + 1 if 2 in row else len(row)
        assert logits[0, n - 1:].argmax(-1)[:m].tolist() == row[:m]
        solo = greedy_decode(lm, embed_tokens(lm, ids[r:r + 1, :n]),
                             lengths[r:r + 1], 12, eos_id=2)
        assert torch.equal(solo[0], toks[r])


def test_qwen2vl_tower_and_lm_layer_on_the_card_match_the_cpu(gen):
    """Qwen2-VL-7B's vision tower cut to 2 blocks and its LM cut to one
    layer, at full width with seeded weights, f32: the merged features of a
    512-px image (324 tokens) and the layer's logits over 64 tokens (3-D
    positions of an image span) on the card within JUDGE_TOL of the CPU's."""
    from diffusion_models_moe_tpu_torch.models.llama import embed_tokens
    from diffusion_models_moe_tpu_torch.models.qwen2vl import (
        Qwen2VLConfig, Qwen2VLForConditionalGeneration, image_features,
        preprocess_image, rope_index)
    full = Qwen2VLConfig()
    cfg = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, depth=2),
        text=dataclasses.replace(full.text, num_layers=1))
    card = _seed_(Qwen2VLForConditionalGeneration(cfg), gen)
    cpu = Qwen2VLForConditionalGeneration(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    img = (torch.rand((512, 512, 3), generator=gen, device="cuda") * 255
           ).byte().cpu().numpy()
    patches, grid = preprocess_image(img, cfg.vision,
                                     max_pixels=28 * 28 * 576)
    got = image_features(card, patches, grid)
    assert got.shape == (1, 324, full.text.hidden_size)
    assert torch.isfinite(got).all()
    assert _rel(got.cpu(), image_features(cpu, patches, grid)) < JUDGE_TOL
    ids = np.concatenate([[3, 5, cfg.vision_start_token_id],
                          [cfg.image_token_id] * 16, [7, 9] * 22])
    pos, _ = rope_index(cfg, ids, (1, 8, 8))
    outs = []
    for model in (card, cpu):
        lm = model.language_model
        dev = model.device
        x = embed_tokens(lm, torch.from_numpy(ids))[None]
        p = torch.from_numpy(pos).long().to(dev)
        logits, _ = lm(x, p, torch.ones((1, len(ids)), dtype=torch.bool,
                                        device=dev))
        outs.append(logits)
    assert torch.isfinite(outs[0]).all()
    assert _rel(outs[0].cpu(), outs[1]) < JUDGE_TOL


def test_qwen2vl_generate_is_consistent_on_the_card(gen):
    """Qwen2-VL-7B geometry cut to 2 vision blocks and 2 LM layers, f32 on
    the card: two images co-batched decode as each does alone, and the
    cached tokens equal a teacher-forced argmax under the 3-D positions
    (decode positions from the largest prompt position + 1)."""
    from diffusion_models_moe_tpu_torch.models.llama import embed_tokens
    from diffusion_models_moe_tpu_torch.models.qwen2vl import (
        Qwen2VLConfig, Qwen2VLForConditionalGeneration, generate,
        image_features, preprocess_image, prompt_ids, rope_index)
    full = Qwen2VLConfig()
    cfg = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, depth=2),
        text=dataclasses.replace(full.text, num_layers=2))
    model = _seed_(Qwen2VLForConditionalGeneration(cfg), gen)
    imgs = [(torch.rand((96, 128, 3), generator=gen, device="cuda") * 255
             ).byte().cpu().numpy() for _ in range(2)]
    pre = [preprocess_image(i, cfg.vision) for i in imgs]
    grid = pre[0][1]
    ids = prompt_ids(lambda t: np.arange(3, 3 + len(t.split())), "q a b",
                     pre[0][0].shape[0] // 4, cfg)
    both = generate(model, ids, np.stack([p for p, _ in pre]), grid,
                    max_new_tokens=8)
    for r, (p, _) in enumerate(pre):
        np.testing.assert_array_equal(
            generate(model, ids, p, grid, max_new_tokens=8)[0], both[r])
    pos, delta = rope_index(cfg, ids, grid)
    lm = model.language_model
    feats = image_features(model, pre[0][0], grid)[0]
    row = both[0].tolist()
    n = row.index(cfg.eos_id) + 1 if cfg.eos_id in row else len(row)
    seq = np.concatenate([ids, row[:n - 1]]).astype(np.int64)
    x = embed_tokens(lm, torch.from_numpy(seq))[None].clone()
    img = torch.from_numpy(np.nonzero(ids == cfg.image_token_id)[0]).cuda()
    x[0, img] = feats
    tail = np.arange(len(ids), len(seq)) + delta
    p = np.concatenate([pos[:, 0], np.broadcast_to(tail, (3, len(tail)))], 1)
    logits, _ = lm(x, torch.from_numpy(p).long().cuda()[:, None],
                   torch.ones((1, len(seq)), dtype=torch.bool, device="cuda"))
    assert logits[0, len(ids) - 1:].argmax(-1).tolist() == row[:n]


def test_qwen_tokenizer_round_trip_on_the_card_machine(gen, tmp_path):
    """The full-size Qwen2-layout tokenizer.json of chip_smoke.py read by the
    port's own reader where the card is (no `tokenizers` or `regex` there):
    the chat strings one id each, and text decodes back to itself."""
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from diffusion_models_moe_tpu_torch.data.prompts import i2p_prompts
    from diffusion_models_moe_tpu_torch.data.tokenizer import \
        load_qwen_tokenizer
    chip_smoke.write_qwen_tokenizer(str(tmp_path))
    encode, decode = load_qwen_tokenizer(str(tmp_path))
    ids = encode("<|im_start|>user\n<|im_end|>").tolist()
    assert ids[0] == 151644 and ids[-1] == 151645 and len(ids) < 8
    for text in i2p_prompts()[:50] + ["naïve café, 日本 🎨\r\n\ttab"]:
        assert decode(encode(text)) == text.strip()


GRAD_REL_TOL = 2e-2    # max |grad kernel path - grad plain| / max |plain|


@pytest.mark.parametrize("kind", ["self", "cross"])
@pytest.mark.parametrize("b,s,h,d,strided", [
    (2, 200, 3, 40, False), (2, 200, 3, 64, True), (2, 300, 2, 72, False),
    (1, 1000, 2, 80, False), (2, 77, 2, 160, True)])
def test_attention_kernels_carry_gradients(gen, b, s, h, d, strided, kind):
    """Kernels 2 and 3 under grad: the forward launches the kernel once
    (no plain call), the backward is the plain version's VJP and launches
    nothing; q's, k's and v's gradients hold to the plain path's (the same
    plain math differentiated, on outputs that differ by the kernels'
    rounding)."""
    q = _heads(gen, b, s, h, d, strided).requires_grad_()
    n_kv = s if kind == "self" else 77
    k, v = (_heads(gen, b, n_kv, h, d, strided).requires_grad_()
            for _ in range(2))
    do = _rn(gen, b, s, h, d)

    def fn(uk):
        if kind == "self":
            return sd_flash.self_attention(q, k, v, d ** -0.5, use_kernels=uk)
        return sd_flash.cross_attention(q, k, v, d ** -0.5, 70,
                                        use_kernels=uk)

    key = f"sd_{kind}_attention"
    _build.reset_launch_counts()
    out = fn(True)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == 1 and _build.LAUNCHES[f"plain:{key}"] == 0
    ref = torch.autograd.grad(fn(False), (q, k, v), do)
    for name, a, r in zip("qkv", got, ref):
        assert torch.isfinite(a).all()
        assert _rel(a, r) < GRAD_REL_TOL, (name, _rel(a, r))
    if kind == "cross":
        assert k.grad is None and got[1][:, 70:].abs().max() == 0


def test_unet_train_step_through_the_kernels(gen):
    """A bf16 SD1.5-geometry UNet at 16 x 16 latents under grad: kernels 2
    and 3 launch once per attention layer, every FF takes kernel 1's plain
    version (counted), and the gradients hold to the plain path's."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                sd15_config)
    from diffusion_models_moe_tpu_torch.training import train
    cfg = dataclasses.replace(sd15_config(torch.bfloat16, relufied=True),
                              sample_size=16)
    pipe = StableDiffusionPipeline(cfg, device="cuda")
    pipe.init_params(torch.Generator(device="cuda").manual_seed(0))
    batch = {"latents": torch.randn(2, 4, 16, 16, generator=gen,
                                    device="cuda"),
             "text_emb": torch.randn(2, 77, 768, generator=gen,
                                     device="cuda")}
    draws = train.draw_step(gen, batch["latents"].shape)
    grads = []
    for uk in (True, False):
        _build.reset_launch_counts()
        loss = train.loss_fn(pipe.unet, batch["latents"], batch["text_emb"],
                             draws, train.TrainConfig(), train.NoiseTables
                             .create(), use_kernels=uk)
        loss.backward()
        torch.cuda.synchronize()
        if uk:
            assert _build.LAUNCHES["sd_self_attention"] == 16
            assert _build.LAUNCHES["sd_cross_attention"] == 16
            assert _build.LAUNCHES["plain:geglu_ff_fused"] == 16
            assert _build.LAUNCHES["geglu_ff_fused"] == 0
            # every GroupNorm under grad on its plain version
            assert _build.LAUNCHES["plain:group_norm_nhwc"] == 61
            assert _build.LAUNCHES["group_norm_nhwc"] == 0
        grads.append(torch.cat([p.grad.float().flatten()
                                for p in pipe.unet.parameters()]))
        pipe.unet.zero_grad(set_to_none=True)
    dist = ((grads[0] - grads[1]).norm() / grads[1].norm()).item()
    assert dist < 0.05, dist


# (B, C, H, W), groups, SiLU, time bias, eps of the GroupNorm kernel's cases:
# SD1.5's UNet at batch 16 (a resblock's norm2 with the time bias, an up
# resblock's norm1, the 8 x 8 concatenation), SDXL's Transformer2D norm at
# batch 8, the VAE decoder's widest norms at 512 px batch 8 and at 1024 px
# batch 4; ragged small cases with 4 and 5 channels a group (a 16-byte
# vector across two and three groups) and a pixel count no multiple of a
# block's rows
GN_CASES = [((16, 320, 64, 64), 32, True, True, 1e-5),
            ((16, 960, 64, 64), 32, True, False, 1e-5),
            ((8, 640, 128, 128), 32, False, False, 1e-6),
            ((8, 256, 512, 512), 32, True, False, 1e-6),
            ((4, 128, 1024, 1024), 32, True, False, 1e-6),
            ((16, 2560, 8, 8), 32, True, True, 1e-5),
            ((3, 72, 5, 7), 18, True, True, 1e-5),
            ((2, 160, 9, 11), 32, False, True, 1e-6)]


@pytest.mark.parametrize("shape,groups,silu,bias,eps", GN_CASES)
def test_group_norm_kernel_matches_plain(gen, shape, groups, silu, bias, eps):
    """The GroupNorm kernel on inputs whose channel means are large against
    their spread (what a SiLU leaves), held to the exact f32 sequence within
    1.5 x its plain version's distance (the bf16 rounding of its output, the
    card's floor for this op); channels-last out, from channels-last or
    NCHW in; bit-equal on a repeat and for a sample alone."""
    from diffusion_models_moe_tpu_torch.ops import group_norm_nhwc as gnm
    b, c, h, w = shape
    mu = 2.0 + torch.randn((1, c, 1, 1), generator=gen, device="cuda")
    x = (mu + 0.5 * torch.randn(shape, generator=gen, device="cuda")).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    gamma = 1 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
    beta = 0.1 * torch.randn((c,), generator=gen, device="cuda")
    t = _rn(gen, b, c) if bias else None

    def norm(xs=x, ts=t, uk=True):
        return gnm.group_norm_nhwc(xs, gamma, beta, groups, eps, silu=silu,
                                   bias=ts, use_kernels=uk)

    _build.reset_launch_counts()
    y = norm()
    assert _build.LAUNCHES["group_norm_nhwc"] == 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    xb = x if t is None else x + t[:, :, None, None]
    exact = torch.nn.functional.group_norm(xb.float(), groups, gamma, beta,
                                           eps)
    if silu:
        exact = torch.nn.functional.silu(exact)
    floor = _rel(norm(uk=False), exact)
    assert _rel(y, exact) <= 1.5 * floor, (_rel(y, exact), floor)
    assert torch.equal(y, norm())
    assert torch.equal(y[:1], norm(x[:1], None if t is None else t[:1]))
    if b * c * h * w < 2 ** 25:
        assert torch.equal(y, norm(x.contiguous()))


@pytest.mark.parametrize("which", ["sd15", "sdxl"])
def test_generate_takes_the_group_norm_kernel_at_every_norm(gen, which):
    """A 2-step bf16 generate at full width (16 x 16 latents): every
    GroupNorm of every UNet call (SD1.5 61, SDXL 46) and of the decode (30)
    on the kernel, none on its plain version."""
    from diffusion_models_moe_tpu_torch import (SDXLPipeline,
                                                StableDiffusionPipeline,
                                                sd15_config, sdxl_config)
    if which == "sd15":
        cfg = dataclasses.replace(sd15_config(torch.bfloat16), sample_size=16)
        pipe = StableDiffusionPipeline(cfg, device="cuda")
        tc, per_call, calls = cfg.text_encoder, 61, 3   # PNDM: 2 steps + 1
    else:
        cfg = dataclasses.replace(sdxl_config(torch.bfloat16), sample_size=16)
        pipe = SDXLPipeline(cfg, device="cuda")
        tc, per_call, calls = pipe.text_configs[0], 46, 2   # Euler: 2 steps
    pipe.init_params(torch.Generator(device="cuda").manual_seed(0))
    cond = torch.randint(0, tc.vocab_size, (1, tc.max_length), device="cuda")
    _build.reset_launch_counts()
    images, _ = pipe.generate(cond, torch.zeros_like(cond), seeds=[0],
                              num_steps=2)
    torch.cuda.synchronize()
    assert torch.isfinite(images).all() and images.is_contiguous()
    assert _build.LAUNCHES["group_norm_nhwc"] == per_call * calls + 30
    assert _build.LAUNCHES["plain:group_norm_nhwc"] == 0
