"""Parity of the torch port's int8 W8A8 serving mode with the JAX package, on
the CPU: `ops/quant.py` (quantised integers equal, outputs to f32 rounding),
`QuantDense`/`QuantConv` with their hoisted weight quantisation, and the
UNet and the VAE decoder under `quant_int8`, alone and with Winograd.

Both sides round half to even onto [-127, 127], accumulate in int32 and
dequantise in f32, so the ops agree to 1e-6. The models are held to a
relative L2 of 1e-2: a 1e-7 difference upstream can flip one rounding, which
moves one element by 1/127 of its scale. Inputs come from numpy seeds, f32
throughout; JAX is NHWC with HWIO and (K, N) weights, the port NCHW with
OIHW and (N, K) weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

import diffusion_models_moe_tpu.ops.quant as jax_quant
from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu.models.unet import UNet2DCondition as JaxUNet
from diffusion_models_moe_tpu.models.vae import VAEDecoder as JaxVAE
from diffusion_models_moe_tpu.moefication.moefy import \
    build_moe_interventions as jax_build_ivs
from diffusion_models_moe_tpu_torch import (build_moe_interventions,
                                            tiny_config)
from diffusion_models_moe_tpu_torch.models import attention as attn_mod
from diffusion_models_moe_tpu_torch.models.attention import (
    GEGLUFeedForward, QuantDense, make_dense)
from diffusion_models_moe_tpu_torch.models.layers import (QuantConv, WinoConv,
                                                          make_conv)
from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
from diffusion_models_moe_tpu_torch.models.vae import VAEDecoder
from diffusion_models_moe_tpu_torch.ops import quant
from diffusion_models_moe_tpu_torch.taps import layer_name
from diffusion_models_moe_tpu_torch.weights import bridge
from torch_parity import labels, nchw, nhwc, oihw, rel_err, rel_l2
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

OP_TOL = 1e-6       # max |diff| / max |ref|: f32 rounding of the dequantisation
MODEL_L2 = 1e-2     # relative L2 of a quantised model against JAX's


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ the ops
@pytest.mark.parametrize("per_token", [True, False])
def test_int8_dot_matches_jax(per_token):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 24).astype(np.float32)
    w = (rng.randn(24, 40) * 0.2).astype(np.float32)               # (K, N)
    ref = np.asarray(jax_quant.int8_dot(jnp.asarray(x), jnp.asarray(w),
                                        per_token=per_token))
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    got = quant.int8_dot(torch.from_numpy(x), wt, per_token=per_token)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 7, 40)
    assert rel_err(got.numpy(), ref) < OP_TOL
    # the integers themselves
    sw = np.maximum(np.abs(w).max(0), 1e-8) / 127.0
    wq, sw_t = quant.quantize_dense_weight(wt)
    assert wq.dtype == torch.int8
    np.testing.assert_array_equal(
        wq.numpy().T, np.asarray(jax_quant._quantize(jnp.asarray(w), sw[None])))
    np.testing.assert_allclose(sw_t.numpy(), sw, rtol=1e-7)
    sx = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8) / 127.0
    np.testing.assert_array_equal(
        quant._quantize(torch.from_numpy(x), torch.from_numpy(sx)).numpy(),
        np.asarray(jax_quant._quantize(jnp.asarray(x), jnp.asarray(sx))))


@pytest.mark.parametrize("k,stride,padding", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
@pytest.mark.parametrize("per_sample", [True, False])
def test_int8_conv_matches_jax(k, stride, padding, per_sample):
    rng = np.random.RandomState(k + stride)
    x = rng.randn(2, 9, 10, 12).astype(np.float32)
    w = (rng.randn(k, k, 12, 20) * 0.1).astype(np.float32)         # HWIO
    ref = np.asarray(jax_quant.int8_conv(
        jnp.asarray(x), jnp.asarray(w), strides=(stride, stride),
        padding=((padding, padding),) * 2, per_sample=per_sample))
    got = quant.int8_conv(nchw(x), oihw(w), stride=stride, padding=padding,
                          per_sample=per_sample)
    assert got.dtype == torch.float32
    assert nhwc(got).shape == ref.shape
    assert rel_err(nhwc(got), ref) < OP_TOL
    sw = np.maximum(np.abs(w).max((0, 1, 2)), 1e-8) / 127.0
    wq, _ = quant.quantize_conv_weight(oihw(w))
    np.testing.assert_array_equal(        # (Cout, ky, kx, Cin) rows
        wq.numpy().reshape(20, k, k, 12).transpose(1, 2, 3, 0),
        np.asarray(jax_quant._quantize(jnp.asarray(w), sw[None, None, None])))


def test_int_mm_accumulates_in_int32():
    """9 x 2560 products of 127 x 127 exceed what f32 holds exactly."""
    a = torch.full((4, 9 * 2560), 127, dtype=torch.int8)
    b = torch.full((8, 9 * 2560), 127, dtype=torch.int8)
    b[1] = -127
    y = quant._int_mm(a, b)
    assert y.dtype == torch.int32
    assert y[0, 0].item() == 127 * 127 * 9 * 2560
    assert y[0, 1].item() == -127 * 127 * 9 * 2560


def test_no_cobatching_coupling():
    """Per-token and per-sample scales: sample 0 alone equals sample 0
    co-batched, bit for bit; a per-tensor scale couples them."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 12, 8, 8).astype(np.float32))
    x[1] *= 50.0                                     # a loud neighbour
    w = torch.from_numpy((rng.randn(16, 12, 3, 3) * 0.1).astype(np.float32))
    both, alone = quant.int8_conv(x, w), quant.int8_conv(x[:1], w)
    np.testing.assert_array_equal(both[:1].numpy(), alone.numpy())
    coupled = quant.int8_conv(x, w, per_sample=False)
    assert not torch.equal(coupled[:1], alone)
    t = x.permute(0, 2, 3, 1).reshape(2, 64, 12)
    wd = torch.from_numpy((rng.randn(20, 12) * 0.1).astype(np.float32))
    np.testing.assert_array_equal(quant.int8_dot(t, wd)[:1].numpy(),
                                  quant.int8_dot(t[:1], wd).numpy())
    assert not torch.equal(quant.int8_dot(t, wd, per_token=False)[:1],
                           quant.int8_dot(t[:1], wd, per_token=False))


# ------------------------------------------------------------------ the modules
def test_quant_modules_hoist_the_weight_quantisation():
    """`QuantDense` and `QuantConv` keep the parameters of `nn.Linear` and
    `nn.Conv2d`, equal the op on their weight, quantise the weight once, and
    follow new weights."""
    gen = torch.Generator().manual_seed(0)
    dense, conv = make_dense(12, 20, quant=True), make_conv(12, 16, quant=True)
    assert type(dense) is QuantDense and type(conv) is QuantConv
    assert type(make_dense(12, 20)) is nn.Linear
    x = torch.randn(2, 5, 12, generator=gen)
    img = torch.randn(2, 12, 6, 6, generator=gen)
    with torch.no_grad():
        for mod, inp, op in ((dense, x, quant.int8_dot),
                             (conv, img, quant.int8_conv)):
            keys = set(mod.state_dict())
            assert keys == {"weight", "bias"}
            bias = mod.bias if mod is dense else mod.bias[:, None, None]
            y = mod(inp)
            np.testing.assert_array_equal(
                y.numpy(), (op(inp, mod.weight) + bias).numpy())
            wq = mod.hoisted_0
            assert wq.dtype == torch.int8 and mod(inp) is not None
            assert mod.hoisted_0 is wq                       # made once
            assert set(mod.state_dict()) == keys
            new = {k: v * (2.0 if k == "weight" else 1.0) + 0.01
                   for k, v in mod.state_dict().items()}
            mod.load_state_dict(new, strict=True)
            y2 = mod(inp)
            np.testing.assert_array_equal(
                y2.numpy(), (op(inp, mod.weight) + bias).numpy())
            assert rel_err(y2.numpy(), y.numpy()) > 0.1


def test_quant_ff_routes_in_the_routing_kernel_and_masks_w2(monkeypatch):
    """Under int8 no FF call takes the fused FF: a routed call goes through
    `fused_route_multiply` between the two int8 projections, and a masked W2
    is quantised for its step."""
    gen = torch.Generator().manual_seed(1)
    ff = GEGLUFeedForward(16, quant=True).eval()
    plain = GEGLUFeedForward(16).eval()
    plain.load_state_dict(ff.state_dict(), strict=True)
    assert type(ff.net[0].proj) is QuantDense and type(ff.net[2]) is QuantDense
    calls = []
    real = attn_mod.fused_route_multiply
    monkeypatch.setattr(attn_mod, "fused_route_multiply",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(attn_mod, "geglu_ff_fused",
                        lambda *a, **kw: pytest.fail("the fused FF ran"))
    x = torch.randn(2, 8, 16, generator=gen)
    lab = np.random.RandomState(0).permutation(np.arange(64) % 4)
    (iv,) = build_moe_interventions({layer_name(0): lab}, 0.5, device="cpu")[:1]
    ln = nn.LayerNorm(16)
    with torch.no_grad():
        y = ff(x, iv=iv, ln=ln)
        assert calls == [1]
        assert rel_l2(y.numpy(), plain._unfused(x, 0, None, iv, ln, None, True
                                                 ).numpy()) < 5e-2
        mask = torch.zeros(16, 64, dtype=torch.bool)
        mask[:, :32] = True
        masked = dataclasses.replace(iv, out_weight_mask=mask)
        y_m = ff(x, iv=masked, ln=ln)
        assert rel_err(y_m.numpy(), y.numpy()) > 1e-2
        assert ff(x, ln=ln).shape == x.shape          # unrouted: no kernel 4
        assert len(calls) == 3       # the two routed int8 calls and `plain`'s


# ------------------------------------------------------------------ the models
@pytest.fixture(scope="module")
def unet_case():
    """One JAX UNet (tiny, f32) under `quant_int8`, alone and with
    `conv_winograd`, MoE routing on all FFs; the same params for both."""
    base = jcfg.tiny_config().unet
    rng = np.random.RandomState(0)
    lat = rng.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(2, 6, base.cross_attention_dim).astype(np.float32)
    lab = labels(base)
    jivs = jax_build_ivs(lab, 0.3)
    params, outs = None, {}
    for wino in (False, True):
        model = JaxUNet(dataclasses.replace(base, quant_int8=True,
                                            conv_winograd=wino))
        if params is None:
            params = _np_tree(model.init(
                jax.random.PRNGKey(0), jnp.asarray(lat),
                jnp.zeros((1,), jnp.int32), jnp.asarray(ctx))["params"])
        outs[wino] = np.asarray(model.apply(
            {"params": params}, jnp.asarray(lat), jnp.asarray([17]),
            jnp.asarray(ctx), step_idx=1, ivs=jivs))
    return dict(params=params, lat=lat, ctx=ctx, labels=lab, outs=outs)


@pytest.mark.parametrize("wino", [False, True])
def test_quant_unet_matches_jax(unet_case, wino):
    case = unet_case
    cfg = tiny_config(quant_int8=True, conv_winograd="1" if wino else "0",
                      attn_absorb="1", conv_chain=True).unet
    unet = UNet2DCondition(cfg).eval()
    sd = bridge.to_torch(bridge.unet_numpy_state_dict(case["params"], cfg))
    assert set(unet.state_dict()) == set(sd)
    unet.load_state_dict(sd, strict=True)
    # int8 and Winograd switch the chain off, int8 the attention absorb
    res = unet.down_blocks[0].resnets[0]
    assert not res.conv_chain and not res.channels_last
    assert type(res.conv1) is (WinoConv if wino else QuantConv)
    assert type(unet.down_blocks[0].downsamplers[0].conv) is QuantConv
    assert type(unet.down_blocks[1].resnets[0].conv_shortcut) is QuantConv
    assert type(unet.conv_in) is nn.Conv2d and type(unet.conv_out) is nn.Conv2d
    blk = unet.down_blocks[0].attentions[0].transformer_blocks[0]
    assert blk.attn_absorb == "0" and type(blk.attn2.to_k) is QuantDense
    assert type(unet.time_embedding.linear_1) is nn.Linear
    ivs = build_moe_interventions(case["labels"], 0.3, device="cpu")
    with torch.no_grad():
        got = unet(nchw(case["lat"]), 17, torch.from_numpy(case["ctx"]),
                   ivs=ivs, step_idx=1)
    assert set(unet.state_dict()) == set(sd)      # the hoisted tensors stay out
    assert rel_l2(nhwc(got), case["outs"][wino]) < MODEL_L2


@pytest.mark.parametrize("wino", [False, True])
def test_quant_vae_decoder_matches_jax(wino):
    base = jcfg.tiny_config().vae
    rng = np.random.RandomState(2)
    z = rng.randn(2, 8, 8, 4).astype(np.float32)
    model = JaxVAE(dataclasses.replace(base, quant_int8=True,
                                       conv_winograd=wino))
    params = _np_tree(model.init(jax.random.PRNGKey(1), jnp.asarray(z))["params"])
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(z)))
    cfg = tiny_config(quant_int8=True, conv_winograd="1" if wino else "0").vae
    vae = VAEDecoder(cfg).eval()
    vae.load_state_dict(bridge.to_torch(
        bridge.vae_decoder_numpy_state_dict(params, cfg)), strict=True)
    assert type(vae.post_quant_conv) is QuantConv
    assert type(vae.decoder.conv_out) is (WinoConv if wino else QuantConv)
    assert type(vae.decoder.mid_block.attentions[0].to_q) is nn.Linear
    with torch.no_grad():
        got = vae(nchw(z))
    assert rel_l2(nhwc(got), ref) < MODEL_L2
