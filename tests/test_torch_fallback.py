"""What the model asks before it hands a call to a kernel, on the CPU.

The kernels take bf16 CUDA tensors of certain shapes; where their predicates
(`attn_kernel_ok`, `fused_ff_ok`, `route_kernel_ok`) say no, the model runs
the plain version, as the JAX package falls back to its library path. The
predicates are held here at the shapes where they say yes and no (the
attention one through `attn_layout_ok`, its part that does not need a card),
and `sd15_config(relufied=True)` against the JAX preset. On the card,
`chip_smoke.py` and `tests/test_torch_cuda.py` run an f32 and a `tiny_config`
generate through the fallbacks.
"""
import pytest
import torch

from diffusion_models_moe_tpu.config import sd15_config as jax_sd15_config
from diffusion_models_moe_tpu_torch import sd15_config, tiny_config
from diffusion_models_moe_tpu_torch.models.attention import GEGLUFeedForward
from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
from diffusion_models_moe_tpu_torch.ops import _build, sd_flash
from diffusion_models_moe_tpu_torch.ops.geglu_ff_fused import fused_ff_ok
from diffusion_models_moe_tpu_torch.ops.routing_kernel import route_kernel_ok

BF16 = torch.bfloat16


def _bshd(b, s, h, d, dtype=BF16, width=None):
    """(B, S, H, D) as the model makes it: a (B, S, width) projection output
    (width = H * D, or 3 H * D for the column thirds of kernel 5) viewed."""
    width = width or h * d
    return torch.zeros((b, s, width), dtype=dtype)[..., :h * d].view(b, s, h, d)


@pytest.mark.parametrize("d,ok", [(40, True), (64, True), (80, True),
                                  (160, True), (8, False), (16, False),
                                  (32, False), (48, False), (128, False),
                                  (44, False), (72, True)])
def test_attn_layout_ok_takes_the_instantiated_head_dims(d, ok):
    q = _bshd(2, 77, 4, d)
    assert sd_flash.attn_layout_ok(q, q) is ok
    assert sd_flash.attn_layout_ok(q, q, kv_valid=77) is ok
    # never on the CPU, whatever the shape
    assert not sd_flash.attn_kernel_ok(q, q)


def test_attn_layout_ok_refuses_dtype_strides_and_key_count():
    q = _bshd(2, 64, 8, 40)
    assert sd_flash.attn_layout_ok(q, q)
    assert sd_flash.attn_layout_ok(_bshd(2, 64, 8, 40, width=960),
                                   _bshd(2, 77, 8, 40, width=960), 77)
    assert not sd_flash.attn_layout_ok(q.float(), q.float())
    assert not sd_flash.attn_layout_ok(q, q.float())
    # a row of D not on a 16-byte boundary, and D not the unit-stride axis
    odd = torch.zeros((2, 64, 8 * 40 + 4), dtype=BF16)[..., 4:].view(2, 64, 8, 40)
    assert not sd_flash.attn_layout_ok(odd, q)
    d_strided = torch.zeros((2, 64, 40, 8), dtype=BF16).permute(0, 1, 3, 2)
    assert d_strided.shape == q.shape and d_strided.stride(3) == 8
    assert not sd_flash.attn_layout_ok(d_strided, q)
    k = _bshd(2, 100, 8, 40)
    assert sd_flash.attn_layout_ok(q, k, kv_valid=80)
    assert sd_flash.attn_layout_ok(q, k[:, :77], kv_valid=100)   # clamped to 77
    # up to 128 keys (T5's 120) at D <= 80, up to 80 at D = 160
    assert sd_flash.attn_layout_ok(q, k, kv_valid=81)
    k = _bshd(2, 130, 8, 40)
    assert sd_flash.attn_layout_ok(q, k, kv_valid=128)
    assert not sd_flash.attn_layout_ok(q, k, kv_valid=129)
    q160, k160 = _bshd(2, 64, 2, 160), _bshd(2, 130, 2, 160)
    assert sd_flash.attn_layout_ok(q160, k160, kv_valid=80)
    assert not sd_flash.attn_layout_ok(q160, k160, kv_valid=81)
    assert not sd_flash.attn_layout_ok(q, k, kv_valid=0)
    k = _bshd(2, 100, 8, 40)
    # v, where given, must be laid out as k; k must match q's B, H and D
    assert sd_flash.attn_layout_ok(q, k, 77, v=_bshd(2, 100, 8, 40))
    assert not sd_flash.attn_layout_ok(q, k, 77, v=_bshd(2, 99, 8, 40))
    assert not sd_flash.attn_layout_ok(q, k, 77, v=_bshd(2, 100, 8, 40).float())
    assert not sd_flash.attn_layout_ok(q, _bshd(1, 100, 8, 40), 77)
    assert not sd_flash.attn_layout_ok(q, _bshd(2, 100, 4, 80), 77)


@pytest.mark.parametrize("n,c,hidden,e,dtype,ok", [
    (16384, 320, 1280, 64, BF16, True),      # SD1.5, 20-neuron experts
    (256, 1280, 5120, 256, BF16, True),
    (256, 1280, 5120, 0, BF16, True),        # no routing
    (256, 1280, 5120, 257, BF16, False),     # too many experts
    (256, 1280, 5120, 64, torch.float32, False),
    (64, 32, 128, 6, BF16, True),            # tiny_config
    (64, 48, 192, 0, BF16, False),           # C % 32
    (64, 64, 96, 0, BF16, False),            # H % 64
])
def test_fused_ff_ok(n, c, hidden, e, dtype, ok):
    assert fused_ff_ok(n, c, hidden, e, dtype) is ok


@pytest.mark.parametrize("hidden,e,dtype,ok", [
    (1280, 64, BF16, True), (5120, 256, BF16, True), (5120, 257, BF16, False),
    (1280, 64, torch.float32, False), (96, 4, BF16, False), (128, 6, BF16, True),
])
def test_route_kernel_ok(hidden, e, dtype, ok):
    assert route_kernel_ok(hidden, e, dtype) is ok


def test_the_model_counts_no_plain_call_on_the_cpu():
    """On CPU tensors the wrappers run their plain versions by design: the
    `plain:` counters count only calls the card's kernels refused."""
    q = torch.randn(1, 20, 2, 8)
    _build.reset_launch_counts()
    a = sd_flash.self_attention(q, q, q, 0.3)
    b = sd_flash.cross_attention(q, q, q, 0.3, 16)
    torch.testing.assert_close(a, sd_flash.sd_self_attention_reference(q, q, q, 0.3))
    torch.testing.assert_close(
        b, sd_flash.sd_cross_attention_reference(q, q, q, 0.3, 16))
    assert all(v == 0 for v in _build.LAUNCHES.values())
    assert set(_build.PLAIN) <= set(_build.LAUNCHES)


@pytest.mark.parametrize("relufied", [False, True])
def test_sd15_config_relufied_matches_jax(relufied):
    """`sd15_config(relufied=...)` sets the activation as the JAX preset
    does, takes the serving modes beside it, and builds a UNet whose 16 FFs
    gate through ReLU (built on the meta device: no weights)."""
    cfg = sd15_config(torch.bfloat16, relufied=relufied, attn_absorb="1")
    assert cfg.unet.ff_activation == jax_sd15_config(
        relufied=relufied).unet.ff_activation
    assert cfg.unet.attn_absorb == "1"
    with torch.device("meta"):
        unet = UNet2DCondition(cfg.unet)
    ffs = [m for m in unet.modules() if isinstance(m, GEGLUFeedForward)]
    assert len(ffs) == 16 and all(ff.relu is relufied for ff in ffs)
    assert tiny_config().unet.ff_activation == "geglu"
