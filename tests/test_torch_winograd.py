"""Parity of the torch port's Winograd convolutions with the JAX package, on
the CPU: `ops/winograd.py`, the plain version of the fused F(2x2, 3x3) kernel
(`ops/winograd_fused.py`), `WinoConv`/`make_conv`, and the resblock, the UNet,
the VAE decoder and `denoise` with `conv_winograd` on.

The JAX fused function runs its Pallas kernel in interpret mode, as
tests/test_winograd_fused.py runs it; the port runs the plain PyTorch version
its wrapper takes on CPU tensors. On the CPU the JAX `WinoConv` with
DMOE_WINO_FUSED=1 runs the direct conv, so the JAX side of the `"fused"` model
comparisons is the formulation of `ops/winograd.py` (`conv_winograd=True`).
`tile=` is passed explicitly; DMOE_WINO_TILE is never set. Inputs come from
numpy seeds, f32 throughout; JAX is NHWC with HWIO weights, the port NCHW
with OIHW weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import diffusion_models_moe_tpu.models.layers as jax_layers
import diffusion_models_moe_tpu.ops.winograd as jax_wino
import diffusion_models_moe_tpu.ops.winograd_fused as jax_fused
import torch_parity
from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu.models.unet import UNet2DCondition as JaxUNet
from diffusion_models_moe_tpu.models.vae import VAEDecoder as JaxVAE
from diffusion_models_moe_tpu.moefication.moefy import \
    build_moe_interventions as jax_build_ivs
from diffusion_models_moe_tpu.pipelines.stable_diffusion import \
    StableDiffusionPipeline as JaxPipeline
from diffusion_models_moe_tpu_torch import (build_moe_interventions,
                                            tiny_config)
from diffusion_models_moe_tpu_torch import config as tcfg
from diffusion_models_moe_tpu_torch.models import layers as layers_mod
from diffusion_models_moe_tpu_torch.models.layers import (QuantConv,
                                                          ResnetBlock2D,
                                                          WinoConv, cast_model,
                                                          make_conv)
from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
from diffusion_models_moe_tpu_torch.models.vae import VAEDecoder
from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.ops.winograd import (transform_filter,
                                                         winograd_conv3x3)
from diffusion_models_moe_tpu_torch.ops.winograd_fused import (
    fused_filter, fused_ok, winograd3x3_fused, winograd3x3_reference)
from diffusion_models_moe_tpu_torch.weights import bridge
from torch_parity import block_state_dict, nchw, nhwc, oihw, rel_err

# max |diff| / max |ref|: the JAX tests' own limits
# (tests/test_winograd.py:39,76)
TILE_TOL = {2: 2e-6, 4: 2e-5}
KERNEL_TOL = 2e-5     # plain version against the interpreted Pallas kernel
MODEL_TOL = 2e-4      # the limit of the port's model parity tests
SLICE_TOL = 1e-3      # the limit of the port's pipeline parity tests
GROUPS, EPS = 8, 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _conv_inputs(b, h, w, ci, co, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, ci).astype(np.float32),
            (rng.randn(3, 3, ci, co) * (9 * ci) ** -0.5).astype(np.float32))


# ------------------------------------------------------------ ops/winograd.py
@pytest.mark.parametrize("tile", [2, 4])
def test_transform_filter_matches_jax(tile):
    _, k = _conv_inputs(1, 4, 4, 5, 7)
    ref = np.asarray(jax_wino.transform_filter(jnp.asarray(k), tile))
    got = transform_filter(oihw(k), tile)
    assert tuple(got.shape) == ((tile + 2) ** 2, 7, 5)    # (a^2, Cout, Cin)
    assert got.dtype == torch.float32
    assert rel_err(got.permute(0, 2, 1).numpy(), ref) < TILE_TOL[tile]


@pytest.mark.parametrize("tile,hw", [(2, (8, 8)), (2, (7, 9)), (4, (8, 12)),
                                     (4, (7, 9))])
def test_winograd_conv_matches_jax(tile, hw):
    """Even sizes, and odd ones by padding and cropping, against the JAX
    function and against the direct convolution."""
    x, k = _conv_inputs(2, *hw, 6, 10, seed=tile)
    ref = np.asarray(jax_wino.winograd_conv3x3(jnp.asarray(x), jnp.asarray(k),
                                               tile=tile))
    got = winograd_conv3x3(nchw(x), oihw(k), tile=tile)
    assert tuple(got.shape) == (2, 10, *hw)
    assert rel_err(nhwc(got), ref) < TILE_TOL[tile]
    direct = F.conv2d(nchw(x), oihw(k), padding=1)
    assert rel_err(got.numpy(), direct.numpy()) < TILE_TOL[tile]


@pytest.mark.parametrize("tile", [2, 4])
def test_banded_matches_single_shot(tile):
    """A budget of one tile row a band against the whole image at once."""
    x, k = _conv_inputs(2, 12, 8, 6, 10, seed=5)
    whole = winograd_conv3x3(nchw(x), oihw(k), tile=tile)
    banded = winograd_conv3x3(nchw(x), oihw(k), tile=tile,
                              stack_budget_mb=1e-6)
    assert rel_err(banded.numpy(), whole.numpy()) < TILE_TOL[tile]
    ref = np.asarray(jax_wino.winograd_conv3x3(jnp.asarray(x), jnp.asarray(k),
                                               tile=tile))
    assert rel_err(nhwc(banded), ref) < TILE_TOL[tile]


def test_winograd_conv_takes_w_or_u():
    x, k = _conv_inputs(1, 4, 4, 3, 5)
    u = transform_filter(oihw(k), 2)
    a = winograd_conv3x3(nchw(x), oihw(k))
    b = winograd_conv3x3(nchw(x), u=u)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="w or u"):
        winograd_conv3x3(nchw(x))
    with pytest.raises(ValueError, match="does not fit"):
        winograd_conv3x3(nchw(x), u=u, tile=4)
    with pytest.raises(ValueError, match="one of"):
        transform_filter(oihw(k), 3)


# ------------------------------------------------------- ops/winograd_fused.py
@pytest.mark.parametrize("shape", [
    (2, 16, 16, 16, 128),    # the least geometry fused_ok admits
    (2, 32, 32, 16, 256),    # Cout in two column blocks, several row bands
])
def test_fused_plain_matches_jax_kernel(shape):
    x, k = _conv_inputs(*shape, seed=1)
    assert fused_ok(*shape[1:]) and jax_fused.fused_ok(*shape[1:])
    ref = np.asarray(jax_fused.winograd3x3_fused(jnp.asarray(x), jnp.asarray(k),
                                                 interpret=True))
    got = winograd3x3_fused(nchw(x), fused_filter(oihw(k)))
    assert rel_err(nhwc(got), ref) < KERNEL_TOL
    direct = F.conv2d(nchw(x), oihw(k), padding=1)
    assert rel_err(got.numpy(), direct.numpy()) < TILE_TOL[2]


def test_fused_border_tiles_read_zeros_outside_the_image():
    """Corner, edge and inner tiles pinned: with x = 1 and w = 1 an output
    pixel counts the taps inside the image, Cin each: 4 at a corner, 6 on an
    edge, 9 inside; the bias is added once."""
    cin, cout = 16, 128
    x = torch.ones(1, cin, 16, 18)
    u = fused_filter(torch.ones(cout, cin, 3, 3))
    y = winograd3x3_fused(x, u, torch.full((cout,), 0.5))
    want = F.conv2d(x, torch.ones(cout, cin, 3, 3), padding=1) + 0.5
    for (r, c), taps in (((0, 0), 4), ((0, 17), 4), ((15, 0), 4),
                         ((15, 17), 4), ((0, 5), 6), ((7, 0), 6), ((15, 9), 6),
                         ((8, 17), 6), ((1, 1), 9), ((14, 16), 9)):
        assert y[0, 3, r, c].item() == taps * cin + 0.5, (r, c)
    torch.testing.assert_close(y, want, rtol=1e-6, atol=0)


def test_cpu_wrapper_is_the_plain_version():
    x, k = _conv_inputs(1, 16, 16, 16, 128, seed=3)
    u = fused_filter(oihw(k))
    _build.reset_launch_counts()
    a = winograd3x3_fused(nchw(x), u)
    b = winograd3x3_reference(nchw(x), u)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert all(v == 0 for v in _build.LAUNCHES.values())
    assert "winograd3x3_fused" in _build.LAUNCHES


def test_fused_ok_states_what_the_kernel_needs():
    # every stride-1 3x3 conv of SD1.5's UNet above 8x8, and the VAE's
    for side, cin, cout in ((64, 320, 320), (64, 960, 320), (32, 1920, 640),
                            (16, 2560, 1280), (64, 512, 512), (512, 256, 128)):
        assert fused_ok(side, side, cin, cout)
    assert not fused_ok(8, 8, 1280, 1280)        # the JAX kernel's scope
    assert not fused_ok(16, 17, 32, 128)
    assert not fused_ok(64, 64, 4, 320)          # conv_in
    assert not fused_ok(512, 512, 128, 3)        # the VAE's conv_out
    assert fused_ok(16, 18, 24, 136)             # ragged, 16-byte channel rows
    assert not fused_ok(16, 16, 36, 128)
    assert not fused_ok(16, 16, 32, 132)
    with pytest.raises(ValueError, match="fused_ok"):
        winograd3x3_fused(torch.zeros(1, 16, 8, 8), torch.zeros(16, 128, 16))
    with pytest.raises(ValueError, match="do not form"):
        winograd3x3_fused(torch.zeros(1, 16, 16, 16), torch.zeros(16, 128, 32))


# ------------------------------------------------------------------ make_conv
def test_make_conv_precedence():
    """Winograd takes the stride-1 3x3 padding-1 convs, int8 the rest when
    both are set; all are nn.Conv2d with the same parameters."""
    both = dict(quant=True, winograd="1")
    assert type(make_conv(8, 8)) is nn.Conv2d
    assert type(make_conv(8, 8, **both)) is WinoConv
    assert type(make_conv(8, 8, stride=2, **both)) is QuantConv
    assert type(make_conv(8, 8, 1, padding=0, **both)) is QuantConv
    assert type(make_conv(8, 8, stride=2, winograd="fused")) is nn.Conv2d
    assert type(make_conv(8, 8, quant=True)) is QuantConv
    ref = nn.Conv2d(8, 16, 3, 1, 1).state_dict()
    for conv in (make_conv(8, 16, **both), make_conv(8, 16, quant=True),
                 make_conv(8, 16, winograd="fused")):
        assert {k: v.shape for k, v in conv.state_dict().items()} == {
            k: v.shape for k, v in ref.items()}


# ------------------------------------------------------------------ the block
@pytest.fixture(scope="module")
def resblock_case():
    """One JAX ResnetBlock2D (f32, 32 -> 128 channels at 16 x 16, so with a
    shortcut conv and two convs `fused_ok` admits) with `winograd=True`."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 16, 16, 32).astype(np.float32)
    temb = rng.randn(2, 64).astype(np.float32)
    blk = jax_layers.ResnetBlock2D(out_channels=128, norm_num_groups=GROUPS,
                                   winograd=True)
    params = _np_tree(blk.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               jnp.asarray(temb)))
    for name, p in params["params"].items():     # zero-init biases: make them count
        p["bias"] = (0.1 * rng.randn(*p["bias"].shape)).astype(np.float32)
        if name.startswith("norm"):
            p["scale"] = (1 + 0.1 * rng.randn(*p["scale"].shape)).astype(np.float32)
    ref = np.asarray(blk.apply(params, jnp.asarray(x), jnp.asarray(temb)))
    return dict(params=params, x=x, temb=temb, ref=ref)


def _port_resblock(case, **modes):
    blk = ResnetBlock2D(32, 128, GROUPS, EPS, temb_channels=64, **modes).eval()
    blk.load_state_dict(block_state_dict("resnet", case["params"]["params"]),
                        strict=True)
    return blk


def _count_fused(monkeypatch) -> list:
    """Records the (Cin, Cout, H) of every conv that takes the kernel's route."""
    calls = []
    real = layers_mod.winograd3x3_fused
    monkeypatch.setattr(
        layers_mod, "winograd3x3_fused",
        lambda x, u, *a, **kw: calls.append((x.shape[1], u.shape[1], x.shape[2]))
        or real(x, u, *a, **kw))
    return calls


@pytest.mark.parametrize("mode,tile", [("1", 2), ("1", 4), ("fused", 2)])
def test_winograd_resblock_matches_jax(resblock_case, monkeypatch, mode, tile):
    case = resblock_case
    calls = _count_fused(monkeypatch)
    blk = _port_resblock(case, winograd=mode, winograd_tile=tile)
    with torch.no_grad():
        got = blk(nchw(case["x"]), torch.from_numpy(case["temb"]))
    assert calls == ([(32, 128, 16), (128, 128, 16)] if mode == "fused" else [])
    assert blk.channels_last == (mode == "fused")
    assert blk.conv1.weight.is_contiguous(
        memory_format=torch.channels_last) == (mode == "fused")
    assert rel_err(nhwc(got), case["ref"]) < MODEL_TOL
    if mode == "fused":          # and against the port's own formulation
        with torch.no_grad():
            plain = _port_resblock(case, winograd="1")(
                nchw(case["x"]), torch.from_numpy(case["temb"]))
        assert rel_err(got.numpy(), plain.numpy()) < MODEL_TOL


def test_hoisted_filter_follows_the_weights(resblock_case):
    """The transformed filter is made once and is no part of the state dict;
    new weights loaded into a built block after a first forward move the
    output with them, and so does a cast of the model."""
    case = resblock_case
    x, temb = nchw(case["x"]), torch.from_numpy(case["temb"])
    for mode in ("1", "fused"):
        blk = _port_resblock(case, winograd=mode)
        sd = blk.state_dict()
        with torch.no_grad():
            first = blk(x, temb)
            u_first = blk.conv1.hoisted_0
            assert blk(x, temb) is not None and blk.conv1.hoisted_0 is u_first
            assert set(blk.state_dict()) == set(sd)       # no buffer leaks in
            new = {k: (v * 1.5 if k.startswith("conv") else v)
                   for k, v in sd.items()}
            blk.load_state_dict(new, strict=True)
            moved = blk(x, temb)
            fresh = ResnetBlock2D(32, 128, GROUPS, EPS, temb_channels=64,
                                  winograd=mode).eval()
            fresh.load_state_dict(new, strict=True)
            want = fresh(x, temb)
            np.testing.assert_array_equal(moved.numpy(), want.numpy())
            assert rel_err(moved.numpy(), first.numpy()) > 0.1
            cast_model(blk, torch.float64)
            assert not hasattr(blk.conv1, "hoisted_0")
            again = blk(x.double(), temb.double())
            assert blk.conv1.hoisted_0.dtype == torch.float64
            assert rel_err(again.numpy(), want.numpy()) < 1e-5


# ------------------------------------------------------------------ the models
def _small_unet_cfgs():
    """A UNet every stride-1 3x3 conv of which `fused_ok` admits at a 32 x 32
    sample: two levels of 128 channels (32 x 32 and 16 x 16)."""
    kw = dict(block_out_channels=(128, 128), down_block_types=("cross", "plain"),
              up_block_types=("plain", "cross"), layers_per_block=1,
              cross_attention_dim=32, attention_head_dim=4, norm_num_groups=8)
    return jcfg.UNetConfig(conv_winograd=True, **kw), tcfg.UNetConfig(**kw)


@pytest.fixture(scope="module")
def unet_case():
    jax_cfg, port_cfg = _small_unet_cfgs()
    rng = np.random.RandomState(0)
    lat = rng.randn(2, 32, 32, 4).astype(np.float32)
    ctx = rng.randn(2, 6, 32).astype(np.float32)
    model = JaxUNet(jax_cfg)
    params = _np_tree(model.init(jax.random.PRNGKey(0), jnp.asarray(lat),
                                 jnp.zeros((1,), jnp.int32),
                                 jnp.asarray(ctx))["params"])
    out = np.asarray(model.apply({"params": params}, jnp.asarray(lat),
                                 jnp.asarray([17]), jnp.asarray(ctx)))
    sd = bridge.to_torch(bridge.unet_numpy_state_dict(params, port_cfg))
    return dict(cfg=port_cfg, sd=sd, lat=lat, ctx=ctx, out=out)


@pytest.mark.parametrize("mode", ["1", "fused"])
def test_winograd_unet_matches_jax(unet_case, monkeypatch, mode):
    """Against the JAX UNet with `conv_winograd=True`; the `"fused"` UNet
    also against the port's `"1"`."""
    case = unet_case
    calls = _count_fused(monkeypatch)

    def run(m):
        unet = UNet2DCondition(dataclasses.replace(case["cfg"], conv_winograd=m)
                               ).eval()
        unet.load_state_dict(case["sd"], strict=True)
        with torch.no_grad():
            return unet, unet(nchw(case["lat"]), 17,
                              torch.from_numpy(case["ctx"]))

    unet, got = run(mode)
    n_calls = len(calls)
    if mode == "fused":
        assert rel_err(got.numpy(), run("1")[1].numpy()) < MODEL_TOL
    # 8 resblocks (1 + 1 down, 2 mid, 2 + 2 up) of two convs and one
    # upsampler conv; conv_in (Cin = 4), conv_out (Cout = 4) and the stride-2
    # downsampler stay direct
    n_wino = sum(isinstance(m, WinoConv) for m in unet.modules())
    assert n_wino == 17
    assert n_calls == (17 if mode == "fused" else 0) and len(calls) == n_calls
    assert type(unet.conv_in) is nn.Conv2d and type(unet.conv_out) is nn.Conv2d
    assert rel_err(nhwc(got), case["out"]) < MODEL_TOL


def test_tiny_unet_fused_mode_admits_no_conv(monkeypatch):
    """`tiny_config` at an 8 x 8 sample: `fused_ok` admits no conv, so the
    `"fused"` UNet runs direct convs and equals the modes-off UNet."""
    calls = _count_fused(monkeypatch)
    on = UNet2DCondition(tiny_config(conv_winograd="fused").unet).eval()
    off = UNet2DCondition(tiny_config().unet).eval()
    off.load_state_dict(on.state_dict(), strict=True)
    gen = torch.Generator().manual_seed(0)
    lat = torch.randn(2, 4, 8, 8, generator=gen)
    ctx = torch.randn(2, 6, 32, generator=gen)
    with torch.no_grad():
        a, b = on(lat, 3, ctx), off(lat, 3, ctx)
    assert calls == []
    assert rel_err(a.numpy(), b.numpy()) < 1e-5


@pytest.fixture(scope="module")
def vae_case():
    """A JAX VAE decoder with `conv_winograd=True`: two levels of 128
    channels, so that on 8 x 8 latents the upsampler conv and the last
    block's four resblock convs (16 x 16) are shapes `fused_ok` admits."""
    kw = dict(block_out_channels=(128, 128), layers_per_block=1,
              norm_num_groups=8)
    rng = np.random.RandomState(2)
    z = rng.randn(2, 8, 8, 4).astype(np.float32)
    model = JaxVAE(jcfg.VAEConfig(conv_winograd=True, **kw))
    params = _np_tree(model.init(jax.random.PRNGKey(1), jnp.asarray(z))["params"])
    out = np.asarray(model.apply({"params": params}, jnp.asarray(z)))
    cfg = tcfg.VAEConfig(**kw)
    sd = bridge.to_torch(bridge.vae_decoder_numpy_state_dict(params, cfg))
    return dict(cfg=cfg, sd=sd, z=z, out=out)


@pytest.mark.parametrize("mode", ["1", "fused"])
def test_winograd_vae_decoder_matches_jax(vae_case, monkeypatch, mode):
    case = vae_case
    calls = _count_fused(monkeypatch)
    vae = VAEDecoder(dataclasses.replace(case["cfg"], conv_winograd=mode)).eval()
    vae.load_state_dict(case["sd"], strict=True)
    with torch.no_grad():
        got = vae(nchw(case["z"]))
    assert type(vae.decoder.conv_in) is WinoConv
    assert type(vae.post_quant_conv) is nn.Conv2d
    assert len(calls) == (5 if mode == "fused" else 0)
    assert rel_err(nhwc(got), case["out"]) < MODEL_TOL


# ------------------------------------------------------------------ the slice
def test_denoise_with_winograd_matches_jax():
    """The slice as a whole: `denoise` (2 PNDM steps, CFG 7.5, MoE on all 16
    FFs) on injected latents with `conv_winograd="1"` against the JAX
    pipeline with `conv_winograd=True`, and the VAE decode after it."""
    base = jcfg.tiny_config()
    cfg = dataclasses.replace(
        base, unet=dataclasses.replace(base.unet, conv_winograd=True),
        vae=dataclasses.replace(base.vae, conv_winograd=True))
    pipe = JaxPipeline(cfg)
    params, port = torch_parity.pipelines(
        cfg, port_cfg=tiny_config(conv_winograd="1"))
    rng = np.random.RandomState(1)
    t = cfg.text_encoder
    cond = rng.randint(0, t.vocab_size, size=(2, t.max_length)).astype(np.int32)
    latents = rng.randn(2, 8, 8, 4).astype(np.float32)
    labels = torch_parity.labels(cfg.unet)
    emb_c, _ = pipe.encode_text(params, jnp.asarray(cond))
    emb_u, _ = pipe.encode_text(params, jnp.zeros_like(cond))
    final, _ = pipe.denoise(params, jnp.concatenate([emb_u, emb_c]),
                            jnp.asarray(latents), 2, 7.5,
                            ivs=jax_build_ivs(labels, 0.3))
    images = pipe.vae_decoder.apply({"params": params["vae"]}, final)

    ids = torch.from_numpy(cond).long()
    context = torch.cat([port.encode_text(torch.zeros_like(ids))[0],
                         port.encode_text(ids)[0]])
    got, _ = port.denoise(context, nchw(latents), 2, 7.5,
                          ivs=build_moe_interventions(labels, 0.3, device="cpu"))
    assert rel_err(nhwc(got), np.asarray(final)) < SLICE_TOL
    with torch.no_grad():
        got_images = port.vae_decoder(got)
    assert rel_err(nhwc(got_images), np.asarray(images)) < SLICE_TOL
