"""Parity of the torch port's resblock conv chain with the JAX package, on
the CPU.

The JAX function runs its Pallas kernel in interpret mode, as
tests/test_conv_chain_fused.py runs it; the port runs the plain PyTorch
version its wrapper takes on CPU tensors. Inputs come from numpy seeds, f32
throughout. JAX is NHWC with HWIO weights, the port NCHW with OIHW weights:
the same numbers are handed to both in their own layout.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusion_models_moe_tpu.models.layers as jax_layers
import diffusion_models_moe_tpu.ops.conv_chain_fused as jax_chain
from diffusion_models_moe_tpu_torch import tiny_config
from diffusion_models_moe_tpu_torch.models import layers as layers_mod
from diffusion_models_moe_tpu_torch.models.layers import ResnetBlock2D
from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.ops.conv_chain_fused import (
    chain_ok, conv3x3_chain, conv3x3_chain_reference, gn_scale_shift)
from torch_parity import block_state_dict, rel_err
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

KERNEL_TOL = 1e-5   # max |diff| / max |ref|
BLOCK_TOL = 2e-4    # the limit of the port's model parity tests
GROUPS, EPS = 8, 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _inputs(shape, seed=0):
    b, h, w, ci, co = shape
    rng = np.random.RandomState(seed)
    f = np.float32
    return dict(
        x=rng.randn(b, h, w, ci).astype(f),
        k=(rng.randn(3, 3, ci, co) * 0.1).astype(f),               # HWIO
        bt=rng.randn(b, co).astype(f),
        gamma=(1.0 + 0.1 * rng.randn(ci)).astype(f),
        beta=(0.1 * rng.randn(ci)).astype(f),
        res=rng.randn(b, h, w, co).astype(f))


def _port_chain(d, scale, shift, res, prologue=True):
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(d["k"], (3, 2, 0, 1))))
    return conv3x3_chain(
        _nchw(d["x"]), w, torch.from_numpy(d["bt"]),
        None if scale is None else torch.from_numpy(np.array(scale)),
        None if shift is None else torch.from_numpy(np.array(shift)),
        residual=_nchw(d["res"]) if res else None, prologue=prologue)


@pytest.mark.parametrize("shape", [
    (2, 16, 16, 32, 128),    # the least geometry the JAX kernel takes
    (1, 32, 32, 48, 160),    # several row bands on the TPU side, Cin != Cout
])
@pytest.mark.parametrize("res", [True, False])
def test_chain_plain_matches_jax_kernel(shape, res):
    d = _inputs(shape)
    scale, shift = jax_chain.gn_scale_shift(
        jnp.asarray(d["x"]), jnp.asarray(d["gamma"]), jnp.asarray(d["beta"]),
        GROUPS, EPS)
    ref = jax_chain.conv3x3_chain(
        jnp.asarray(d["x"]), jnp.asarray(d["k"]), jnp.asarray(d["bt"]), scale,
        shift, residual=jnp.asarray(d["res"]) if res else None, interpret=True)
    assert chain_ok(*shape[1:])
    got = _port_chain(d, scale, shift, res)
    assert rel_err(_nhwc(got), np.asarray(ref)) < KERNEL_TOL


def test_chain_without_prologue_matches_jax_kernel():
    d = _inputs((1, 16, 16, 32, 128), seed=1)
    ref = jax_chain.conv3x3_chain(
        jnp.asarray(d["x"]), jnp.asarray(d["k"]), jnp.asarray(d["bt"]),
        residual=jnp.asarray(d["res"]), prologue=False, interpret=True)
    got = _port_chain(d, None, None, True, prologue=False)
    assert rel_err(_nhwc(got), np.asarray(ref)) < KERNEL_TOL


@pytest.mark.parametrize("channels_last", [False, True])
def test_gn_scale_shift_matches_jax(channels_last):
    d = _inputs((2, 8, 8, 32, 32), seed=2)
    ref = jax_chain.gn_scale_shift(jnp.asarray(d["x"]), jnp.asarray(d["gamma"]),
                                   jnp.asarray(d["beta"]), GROUPS, EPS)
    x = _nchw(d["x"])
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    got = gn_scale_shift(x, torch.from_numpy(d["gamma"]),
                         torch.from_numpy(d["beta"]), GROUPS, EPS)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == (2, 32)
        assert rel_err(g.numpy(), np.asarray(r)) < KERNEL_TOL


def test_border_is_zero_of_the_normalised_tensor():
    """SAME padding contributes zeros after the prologue: with x = 0 and a
    shift, silu(shift) != 0 inside the image and 0 outside it, so a corner
    pixel sums 4 taps where an inner pixel sums 9."""
    b, c, h = 1, 8, 4
    x = torch.zeros(b, c, h, h)
    w = torch.ones(8, c, 3, 3)
    shift = torch.full((b, c), 2.0)
    y = conv3x3_chain(x, w, torch.zeros(b, 8), torch.ones(b, c), shift)
    unit = c * float(torch.nn.functional.silu(torch.tensor(2.0)))
    torch.testing.assert_close(y[0, 0, 0, 0].item(), 4 * unit, rtol=1e-6, atol=0)
    torch.testing.assert_close(y[0, 0, 0, 1].item(), 6 * unit, rtol=1e-6, atol=0)
    torch.testing.assert_close(y[0, 0, 1, 1].item(), 9 * unit, rtol=1e-6, atol=0)


def test_cpu_wrapper_is_the_plain_version():
    d = _inputs((1, 8, 8, 16, 24), seed=3)
    scale, shift = (torch.from_numpy(d[k]) for k in ("gamma", "beta"))
    scale, shift = scale[None], shift[None]
    _build.reset_launch_counts()
    a = _port_chain(d, scale, shift, True)
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(d["k"], (3, 2, 0, 1))))
    b = conv3x3_chain_reference(_nchw(d["x"]), w, torch.from_numpy(d["bt"]),
                                scale, shift, _nchw(d["res"]))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_chain_ok_states_what_the_kernel_needs():
    # every 3x3 resblock conv of SD1.5, the 8x8 level included
    for side, cin, cout in ((64, 320, 320), (64, 960, 320), (32, 1920, 640),
                            (16, 2560, 1280), (8, 2560, 1280)):
        assert chain_ok(side, side, cin, cout)
    assert chain_ok(5, 7, 8, 8)              # any spatial size
    assert not chain_ok(16, 16, 36, 64)      # Cin rows not 16-byte vectors
    assert not chain_ok(16, 16, 64, 36)
    with pytest.raises(ValueError, match="chain_ok"):
        conv3x3_chain(torch.zeros(1, 4, 8, 8), torch.zeros(8, 4, 3, 3),
                      torch.zeros(1, 8), prologue=False)
    with pytest.raises(ValueError, match="scale and shift"):
        conv3x3_chain(torch.zeros(1, 8, 8, 8), torch.zeros(8, 8, 3, 3),
                      torch.zeros(1, 8))


# ------------------------------------------------------------------ the block
@pytest.fixture(scope="module")
def resblock_case():
    """One JAX ResnetBlock2D (f32, 32 -> 128 channels, so with a shortcut
    conv) with random params, its inputs and the plain block's output."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 16, 16, 32).astype(np.float32)
    temb = rng.randn(2, 64).astype(np.float32)
    blk = jax_layers.ResnetBlock2D(out_channels=128, norm_num_groups=GROUPS)
    params = blk.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(temb))
    params = jax.tree_util.tree_map(np.asarray, params)
    for name, p in params["params"].items():     # zero-init biases: make them count
        p["bias"] = (0.1 * rng.randn(*p["bias"].shape)).astype(np.float32)
        if name.startswith("norm"):
            p["scale"] = (1 + 0.1 * rng.randn(*p["scale"].shape)).astype(np.float32)
    plain = np.asarray(blk.apply(params, jnp.asarray(x), jnp.asarray(temb)))
    return dict(blk=blk, params=params, x=x, temb=temb, plain=plain)


def _port_resblock(case, conv_chain):
    blk = ResnetBlock2D(32, 128, GROUPS, EPS, temb_channels=64,
                        conv_chain=conv_chain).eval()
    blk.load_state_dict(block_state_dict("resnet", case["params"]["params"]),
                        strict=True)
    return blk


def test_chain_resblock_matches_jax(resblock_case, monkeypatch):
    """The port's chain resblock against the JAX block driven as
    tests/test_conv_chain_fused.py drives it: the mode switch in the
    environment, the backend and profitability gates forced open, the kernel
    in interpret mode."""
    case = resblock_case
    monkeypatch.setenv("DMOE_CONV_CHAIN", "1")
    monkeypatch.setattr(jax_layers.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_chain, "conv3x3_chain", functools.partial(
        jax_chain.conv3x3_chain, interpret=True))
    monkeypatch.setattr(jax_chain, "chain_profitable", jax_chain.chain_ok)
    ref = np.asarray(case["blk"].apply(case["params"], jnp.asarray(case["x"]),
                                       jnp.asarray(case["temb"])))
    monkeypatch.undo()
    # the JAX kernel really ran: another summation order than the plain block
    assert not np.array_equal(ref, case["plain"])

    calls = []
    real = layers_mod.conv3x3_chain
    monkeypatch.setattr(
        layers_mod, "conv3x3_chain",
        lambda *a, **kw: calls.append(kw.get("residual") is not None)
        or real(*a, **kw))
    x, temb = _nchw(case["x"]), torch.from_numpy(case["temb"])
    with torch.no_grad():
        got = _port_resblock(case, True)(x, temb)
        off = _port_resblock(case, False)(x, temb)
    assert calls == [False, True]   # conv1 with the time bias, conv2 + shortcut
    assert rel_err(_nhwc(got), ref) < BLOCK_TOL
    assert rel_err(_nhwc(got), case["plain"]) < BLOCK_TOL
    assert rel_err(_nhwc(off), case["plain"]) < BLOCK_TOL


def test_one_state_dict_loads_with_the_mode_on_and_off(resblock_case):
    """The chain mode keeps the parameter tree and the logical weight shapes
    (channels-last is a memory format): one state dict loads strictly with
    the mode on and off, and gives back the same values."""
    sd = block_state_dict("resnet", resblock_case["params"]["params"])
    for mode in (False, True):
        blk = _port_resblock(resblock_case, mode)
        back = blk.state_dict()
        assert set(back) == set(sd)
        for name, v in sd.items():
            assert back[name].shape == v.shape
            np.testing.assert_array_equal(back[name].numpy(), v.numpy())
    assert blk.conv1.weight.is_contiguous(memory_format=torch.channels_last)


def test_chain_branches_follow_chain_ok():
    """conv1 and conv2 choose their branch one by one from `chain_ok`."""
    blk = ResnetBlock2D(36, 64, 4, EPS, temb_channels=16, conv_chain=True)
    assert blk.chain_branches(8, 8) == (False, True)
    assert ResnetBlock2D(32, 64, 4, EPS, conv_chain=True
                         ).chain_branches(8, 8) == (True, True)
    assert ResnetBlock2D(32, 64, 4, EPS, conv_chain=False
                         ).chain_branches(8, 8) == (False, False)
    calls = []
    real = layers_mod.conv3x3_chain
    mp = pytest.MonkeyPatch()
    mp.setattr(layers_mod, "conv3x3_chain",
               lambda x, *a, **kw: calls.append(x.shape[1]) or real(x, *a, **kw))
    try:
        with torch.no_grad():
            y = blk.eval()(torch.randn(1, 36, 8, 8), torch.randn(1, 16))
    finally:
        mp.undo()
    assert calls == [64] and tuple(y.shape) == (1, 64, 8, 8)


def test_tiny_unet_convs_take_the_chain(monkeypatch):
    """Which convs of a `tiny_config` UNet take which branch: with
    `conv_chain` every resblock's two 3x3 convs (22 resblocks, all widths
    multiples of 8) go through `conv3x3_chain`, conv2 with the shortcut as
    residual; without it none does; the outputs agree."""
    cfg = tiny_config(conv_chain=True).unet
    on = UNet2DCondition(cfg).eval()
    off = UNet2DCondition(tiny_config().unet).eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in on.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05
                    + (1.0 if p.dim() == 1 else 0.0))
    off.load_state_dict(on.state_dict(), strict=True)
    calls = []
    real = layers_mod.conv3x3_chain
    monkeypatch.setattr(
        layers_mod, "conv3x3_chain",
        lambda x, w, *a, **kw: calls.append(
            (tuple(w.shape[:2]), kw.get("residual") is not None))
        or real(x, w, *a, **kw))
    lat = torch.randn(2, 4, 8, 8, generator=gen)
    ctx = torch.randn(2, 6, cfg.cross_attention_dim, generator=gen)
    with torch.no_grad():
        y_on = on(lat, 17, ctx)
        n_on = len(calls)
        y_off = off(lat, 17, ctx)
    resblocks = [m for m in on.modules() if isinstance(m, ResnetBlock2D)]
    assert len(resblocks) == 22 and n_on == 44 and len(calls) == 44
    assert [c[1] for c in calls] == [False, True] * 22
    assert calls[0][0] == (32, 32) and (128, 256) in [c[0] for c in calls]
    assert rel_err(y_on.numpy(), y_off.numpy()) < BLOCK_TOL
