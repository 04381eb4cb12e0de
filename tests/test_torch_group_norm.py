"""The channels-last GroupNorm (`ops/group_norm_nhwc.py`) on the CPU: its
plain version against the sequence the models ran before it, what the model
asks before it hands a call to the kernel, the launch plan, and the models'
channels-last format against the NCHW models they were.

The kernel itself runs only on the card (`tests/test_torch_cuda.py`).
"""
import copy

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch_parity import one_torch_thread, rel_err  # noqa: F401  (autouse)

from diffusion_models_moe_tpu_torch import tiny_config
from diffusion_models_moe_tpu_torch.models import layers
from diffusion_models_moe_tpu_torch.models.layers import ResnetBlock2D
from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
from diffusion_models_moe_tpu_torch.models.vae import VAEDecoder
from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.ops import group_norm_nhwc as gn

BF16, CL = torch.bfloat16, torch.channels_last
# a CPU conv in f32 sums in another order over channels-last memory
FORMAT_TOL = 1e-5


def _norm(c, groups, eps, gen):
    norm = nn.GroupNorm(groups, c, eps=eps)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
        norm.bias.copy_(0.1 * torch.randn(c, generator=gen))
    return norm


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("cpg", [4, 10])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("fmt", ["nchw", "channels_last"])
def test_plain_version_is_the_sequence_it_replaces(fmt, with_bias, silu, cpg,
                                                   eps):
    """`layers.group_norm` off the card and the kernel's plain version are,
    bit for bit, what the resblock computed before them: `h + t` in bf16,
    then SiLU of GroupNorm on an f32 copy, cast back (or without SiLU, as
    `Transformer2D` and `VAEAttention` ran it), in either memory format."""
    gen = torch.Generator().manual_seed(cpg)
    groups = 4
    c = groups * cpg
    x = (3 * torch.randn(2, c, 5, 7, generator=gen) + 1).to(BF16)
    if fmt == "channels_last":
        x = x.contiguous(memory_format=CL)
    t = torch.randn(2, c, generator=gen).to(BF16) if with_bias else None
    norm = _norm(c, groups, eps, gen)
    h = x if t is None else x + t[:, :, None, None]
    want = F.group_norm(h.float(), groups, norm.weight, norm.bias, eps)
    want = (F.silu(want) if silu else want).to(BF16)
    got = layers.group_norm(norm, x, silu=silu, bias=t)
    assert torch.equal(got, want)
    ref = gn.group_norm_nhwc(x, norm.weight, norm.bias, groups, eps,
                             silu=silu, bias=t)
    assert torch.equal(ref, want)


@pytest.mark.parametrize("case,ok", [
    ("bf16", True), ("f32", False), ("c_not_multiple_of_8", False),
    ("grad_through_x", False), ("grad_through_affine", False),
    ("grad_through_bias", False), ("grad_off", True), ("groups_over_512", False),
    ("not_on_card", False)])
def test_group_norm_ok(case, ok, monkeypatch):
    """The predicate takes bf16 on the card, C a multiple of 8 and of the
    groups, and no recorded gradient; the rest goes to the plain version."""
    on_card = case != "not_on_card"
    monkeypatch.setattr(_build, "on_card", lambda t: on_card)
    c, groups = (36, 4) if case == "c_not_multiple_of_8" else (64, 8)
    if case == "groups_over_512":
        c, groups = 1024, 1024
    x = torch.zeros(2, c, 4, 4, dtype=torch.float32 if case == "f32" else BF16)
    norm = nn.GroupNorm(groups, c)
    bias = torch.zeros(2, c, dtype=BF16)
    if case == "grad_through_x":
        x.requires_grad_()
    if case == "grad_through_bias":
        bias.requires_grad_()
    if case not in ("grad_through_affine", "grad_off"):
        norm.requires_grad_(False)
    with torch.set_grad_enabled(case != "grad_off"):
        assert gn.group_norm_ok(x, groups, norm.weight, norm.bias, bias) is ok


def _count_kernel_calls(monkeypatch) -> list:
    calls = []
    real = layers.group_norm_nhwc
    monkeypatch.setattr(layers, "group_norm_nhwc",
                        lambda x, *a, **kw: calls.append(x.shape[1])
                        or real(x, *a, **kw))
    return calls


def _tiny_unet(dtype):
    unet = UNet2DCondition(tiny_config().unet).eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in unet.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05
                    + (1.0 if p.dim() == 1 else 0.0))
    return layers.cast_model(unet, dtype)


@pytest.mark.parametrize("dtype,grad,kernel", [
    (BF16, False, True), (torch.float32, False, False), (BF16, True, False)])
def test_unet_counts_what_the_kernel_cannot_take(dtype, grad, kernel,
                                                 monkeypatch):
    """With the tensors taken to lie on the card, every GroupNorm of a UNet
    call (22 resblocks x 2, 16 Transformer2D, conv_norm_out: 61) goes to the
    kernel where it takes the call, and elsewhere (an f32 model, a call
    autograd records) to the plain version, counted under
    `plain:group_norm_nhwc`; the kernel's wrapper runs its plain version on
    CPU tensors."""
    unet = _tiny_unet(dtype)
    norms = sum(isinstance(m, nn.GroupNorm) for m in unet.modules())
    assert norms == 61
    calls = _count_kernel_calls(monkeypatch)
    monkeypatch.setattr(_build, "on_card", lambda t: True)
    gen = torch.Generator().manual_seed(1)
    lat = torch.randn(2, 4, 8, 8, generator=gen)
    ctx = torch.randn(2, 6, 32, generator=gen)
    _build.reset_launch_counts()
    with torch.set_grad_enabled(grad):
        eps = unet(lat, 17, ctx)
    assert len(calls) == (norms if kernel else 0)
    assert _build.LAUNCHES["plain:group_norm_nhwc"] == (0 if kernel else norms)
    assert _build.LAUNCHES["group_norm_nhwc"] == 0          # no launch on CPU
    assert eps.is_contiguous() and eps.dtype == torch.float32


def _nchw_twin(model: nn.Module) -> nn.Module:
    """The model as it ran before the channels-last format: every resblock
    NCHW (`channels_last` False, which also keeps the UNet's input NCHW)
    and every conv weight NCHW-contiguous, on the same weights."""
    twin = copy.deepcopy(model)
    for m in twin.modules():
        if isinstance(m, ResnetBlock2D):
            m.channels_last = False
    with torch.no_grad():
        for p in twin.parameters():
            # clone: `contiguous` keeps a 1x1 kernel's channels-last strides
            p.data = p.data.clone(memory_format=torch.contiguous_format)
    return twin


@pytest.mark.parametrize("which", ["unet", "vae_decoder"])
def test_models_run_channels_last_and_return_nchw(which):
    """A tiny UNet and VAE decoder hold every conv weight channels-last
    (made so once, at construction, and kept by `cast_model`), and return
    NCHW-contiguous outputs equal, to f32 rounding, to the same models run
    NCHW throughout."""
    gen = torch.Generator().manual_seed(2)
    if which == "unet":
        model = _tiny_unet(torch.float32)
        args = (torch.randn(2, 4, 8, 8, generator=gen), 17,
                torch.randn(2, 6, 32, generator=gen))
    else:
        model = layers.cast_model(VAEDecoder(tiny_config().vae).eval(),
                                  torch.float32)
        args = (torch.randn(2, 4, 8, 8, generator=gen),)
    convs = [m for m in model.modules() if isinstance(m, nn.Conv2d)]
    assert convs and all(m.weight.is_contiguous(memory_format=CL)
                         for m in convs)
    seen = []
    hook = model.get_submodule(
        "down_blocks.0.resnets.0" if which == "unet" else
        "decoder.mid_block.resnets.0").register_forward_hook(
            lambda mod, inp, out: seen.append(out))
    with torch.no_grad():
        got = model(*args)
        want = _nchw_twin(model)(*args)
    hook.remove()
    assert seen[0].is_contiguous(memory_format=CL)
    assert not seen[1].is_contiguous(memory_format=CL)
    assert got.is_contiguous() and want.is_contiguous()
    assert rel_err(got.numpy(), want.numpy()) < FORMAT_TOL


@pytest.mark.parametrize("shape,fills", [
    ((16, 320, 64, 64), True), ((16, 960, 64, 64), True),
    ((8, 640, 128, 128), True), ((8, 256, 512, 512), True),
    ((4, 128, 1024, 1024), True), ((16, 2560, 8, 8), True),
    ((1, 320, 64, 64), False), ((3, 72, 5, 7), False)])
def test_gn_plan_covers_the_image_in_whole_blocks(shape, fills):
    """The plan covers an image in non-empty tiles, a block's threads within
    the kernel's 512 and its 16-byte rows; SD1.5's, SDXL's and the VAE's
    shapes at the benchmark's batches spread over at least the card's 132
    SMs."""
    b, c, h, w = shape
    groups = 32 if c % 32 == 0 else 8
    plan = gn.gn_plan(h * w, c, groups)
    assert plan.rows * (c // gn.VEC) <= gn.THREADS
    assert plan.tiles * plan.pixels >= h * w > (plan.tiles - 1) * plan.pixels
    assert 1 <= plan.tiles <= gn.MAX_TILES
    assert plan.tiles * groups <= gn.MAX_PARTS
    assert (b * plan.tiles >= 132) is fills
