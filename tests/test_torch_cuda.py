"""The torch port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU or interpret mode, so these tests need an NVIDIA
GPU (sm_90a) and `nvcc`; elsewhere they skip. On the GPU, from the repo root
(`--noconftest`: tests/conftest.py configures JAX, which the port does not
use):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Shapes are small and ragged (rows and tokens not multiples of the tiles) to
reach the kernels' edge masking; `chip_smoke.py` covers the SD1.5 shapes.
"""
import numpy as np
import pytest
import torch

from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.ops import geglu_ff_fused as ffm
from diffusion_models_moe_tpu_torch.ops import sd_flash
from diffusion_models_moe_tpu_torch.taps import patterns_from_labels

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


@pytest.mark.parametrize("d", [40, 80, 160])
def test_self_attention_kernel_matches_plain(gen, d):
    b, s, h = 2, 200, 3
    q, k, v = (_rn(gen, b, s, h * d).view(b, s, h, d) for _ in range(3))
    o = sd_flash.sd_self_attention(q, k, v, d ** -0.5)
    ref = sd_flash.sd_self_attention(q, k, v, d ** -0.5, use_kernels=False)
    assert _rel(o, ref) < REL_TOL


@pytest.mark.parametrize("d", [40, 80, 160])
def test_cross_attention_kernel_matches_plain(gen, d):
    b, s, h = 2, 200, 3
    q = _rn(gen, b, s, h * d).view(b, s, h, d)
    k, v = (_rn(gen, b, 77, h * d).view(b, 77, h, d) for _ in range(2))
    for kv_valid in (77, 40):
        o = sd_flash.sd_cross_attention(q, k, v, d ** -0.5, kv_valid)
        ref = sd_flash.sd_cross_attention(q, k, v, d ** -0.5, kv_valid,
                                          use_kernels=False)
        assert _rel(o, ref) < REL_TOL


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
