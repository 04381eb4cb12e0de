"""Parity of the torch port's absorbed self-attention with the JAX package,
on the CPU.

The JAX functions run their Pallas kernels in interpret mode, as
tests/test_attn_absorb_fused.py runs them; the port runs the plain PyTorch
versions its wrappers take on CPU tensors. Inputs come from numpy seeds, f32
throughout. The JAX functions carry the TPU's 128-lane head pad (zero
columns folded into the weights); the port carries none, so the JAX pad
columns are checked to be zero and dropped before comparing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusion_models_moe_tpu.ops.flash as jax_flash
from diffusion_models_moe_tpu.models.attention import \
    BasicTransformerBlock as JaxBlock
from diffusion_models_moe_tpu.ops.attn_absorb_fused import \
    attn_out_residual_fused as jax_attn_out_residual_fused
from diffusion_models_moe_tpu.ops.attn_absorb_fused import \
    ln_apply as jax_ln_apply
from diffusion_models_moe_tpu.ops.attn_absorb_fused import \
    ln_qkv_fused as jax_ln_qkv_fused
from diffusion_models_moe_tpu_torch.models import attention as attention_mod
from diffusion_models_moe_tpu_torch.models.attention import \
    BasicTransformerBlock
from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.ops.attn_absorb_fused import (
    absorbed_self_attention, attn_absorb_ok, attn_out_residual_fused,
    attn_out_residual_reference, ln_apply, ln_qkv_fused, ln_qkv_reference)
from torch_parity import block_state_dict, rel_err

KERNEL_TOL = 2e-5   # max |diff| / max |ref|: the JAX kernel tests' own limit
BLOCK_TOL = 2e-4    # the limit of the port's model parity tests
D_PAD = 128         # the TPU lane width the JAX functions pad heads to


def _pad_heads(w, heads, axis):
    """(C, H*D) -> (C, H*D_PAD) with zero pad columns (axis=1), or the same
    for the rows of an (H*D, C) output weight (axis=0)."""
    c = w.shape[1 - axis]
    d = w.shape[axis] // heads
    if axis == 1:
        w3 = np.pad(w.reshape(c, heads, d), ((0, 0), (0, 0), (0, D_PAD - d)))
        return w3.reshape(c, heads * D_PAD)
    w3 = np.pad(w.reshape(heads, d, c), ((0, 0), (0, D_PAD - d), (0, 0)))
    return w3.reshape(heads * D_PAD, c)


def _inputs(seed, b=2, s=256, c=64, heads=2):
    rng = np.random.RandomState(seed)
    f = np.float32
    x = rng.randn(b, s, c).astype(f)
    ws = [(rng.randn(c, c) * 0.05).astype(f) for _ in range(3)]   # (in, out)
    g = (1.0 + 0.1 * rng.randn(c)).astype(f)
    bb = (0.1 * rng.randn(c)).astype(f)
    return x, ws, g, bb


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("has_ln", [True, False])
def test_ln_qkv_plain_matches_jax_kernel(has_ln):
    heads = 2
    x, ws, g, bb = _inputs(0, heads=heads)
    b, s, c = x.shape
    d = c // heads
    ln = dict(ln_scale=jnp.asarray(g), ln_bias=jnp.asarray(bb)) if has_ln else {}
    ref = jax_ln_qkv_fused(jnp.asarray(x),
                           *(jnp.asarray(_pad_heads(w, heads, 1)) for w in ws),
                           heads=heads, interpret=True, **ln)
    assert attn_absorb_ok(s, c, heads)
    got = ln_qkv_fused(_t(x), *(_t(w.T) for w in ws), heads,
                       _t(g) if has_ln else None, _t(bb) if has_ln else None)
    for r, o in zip(ref, got):
        r = np.asarray(r)                               # (B, H, S, D_PAD)
        assert not r[..., d:].any()
        assert tuple(o.shape) == (b, s, heads, d)
        assert rel_err(o.numpy(), r[..., :d].transpose(0, 2, 1, 3)) < KERNEL_TOL


def test_attn_out_residual_plain_matches_jax_kernel():
    heads, b, s, c = 2, 2, 256, 64
    d = c // heads
    rng = np.random.RandomState(1)
    f = np.float32
    o = rng.randn(b, s, heads, d).astype(f)
    w = (rng.randn(c, c) * 0.05).astype(f)                        # (H*D, C)
    bias = (0.1 * rng.randn(c)).astype(f)
    resid = rng.randn(b, s, c).astype(f)
    o_pad = np.pad(o.transpose(0, 2, 1, 3),
                   ((0, 0), (0, 0), (0, 0), (0, D_PAD - d)))
    ref = jax_attn_out_residual_fused(
        jnp.asarray(o_pad), jnp.asarray(_pad_heads(w, heads, 0)),
        jnp.asarray(bias), jnp.asarray(resid), interpret=True)
    got = attn_out_residual_fused(_t(o), _t(w.T), _t(bias), _t(resid))
    assert rel_err(got.numpy(), np.asarray(ref)) < KERNEL_TOL
    # o read through strides: the flash output as a view of a wider tensor
    wide = _t(np.concatenate([o.reshape(b, s, c)] * 2, axis=-1))
    view = wide[..., c:].view(b, s, heads, d)
    assert not view.is_contiguous()
    got_view = attn_out_residual_fused(view, _t(w.T), _t(bias), _t(resid))
    np.testing.assert_array_equal(got_view.numpy(), got.numpy())


def test_ln_apply_matches_jax():
    x, _, g, bb = _inputs(2)
    ref = jax_ln_apply(jnp.asarray(x), jnp.asarray(g), jnp.asarray(bb))
    got = ln_apply(_t(x), _t(g), _t(bb))
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), np.asarray(ref)) < KERNEL_TOL


def test_cpu_wrappers_are_the_plain_versions():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing."""
    heads = 2
    x, ws, g, bb = _inputs(3, heads=heads)
    args = (_t(x), *(_t(w.T) for w in ws), heads, _t(g), _t(bb))
    _build.reset_launch_counts()
    for a, b in zip(ln_qkv_fused(*args), ln_qkv_reference(*args)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    q = ln_qkv_fused(*args)[0]
    out_args = (q, _t(ws[0].T), _t(bb), _t(x))
    np.testing.assert_array_equal(
        attn_out_residual_fused(*out_args).numpy(),
        attn_out_residual_reference(*out_args).numpy())
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_attn_absorb_ok_states_what_the_kernels_need():
    # every SD1.5 self-attention level, S = 64 included
    for s, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280)):
        assert attn_absorb_ok(s, c, 8)
    assert attn_absorb_ok(100, 64, 2)          # ragged S
    assert not attn_absorb_ok(256, 36, 3)      # head dim 12: no 16-byte rows
    assert not attn_absorb_ok(256, 65, 2)      # heads do not divide C
    with pytest.raises(ValueError, match="attn_absorb_ok"):
        ln_qkv_fused(torch.zeros(1, 8, 36), *(torch.zeros(36, 36),) * 3, 3)


def test_absorb_mode_is_validated():
    x, ws, g, bb = _inputs(4)
    w = [_t(v.T) for v in ws]
    with pytest.raises(ValueError, match="absorb mode"):
        absorbed_self_attention(_t(x), *w, w[0], _t(bb), 2, 0.1,
                                (_t(g), _t(bb), 1e-5), mode="0")


# ------------------------------------------------------------------ the block
DIM, HEADS, CTX_DIM, SEQ = 64, 2, 32, 256


@pytest.fixture(scope="module")
def block_case():
    """One JAX BasicTransformerBlock (f32) with random params, its input and
    the plain (un-absorbed) block's output."""
    rng = np.random.RandomState(5)
    x = rng.randn(1, SEQ, DIM).astype(np.float32)
    ctx = rng.randn(1, 7, CTX_DIM).astype(np.float32)
    blk = JaxBlock(dim=DIM, heads=HEADS, context_dim=CTX_DIM, ff_index=0,
                   dtype=jnp.float32)
    params = blk.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ctx))
    params = jax.tree_util.tree_map(np.asarray, params)
    # the init leaves biases at zero and norm scales at one; make them count
    p = params["params"]
    for name in ("norm1", "norm2", "norm3"):
        p[name]["scale"] = (1 + 0.1 * rng.randn(DIM)).astype(np.float32)
        p[name]["bias"] = (0.1 * rng.randn(DIM)).astype(np.float32)
    p["attn1"]["to_out"]["bias"] = (0.1 * rng.randn(DIM)).astype(np.float32)
    plain = np.asarray(blk.apply(params, jnp.asarray(x), jnp.asarray(ctx)))
    return dict(blk=blk, params=params, x=x, ctx=ctx, plain=plain)


def _port_block(case, mode):
    blk = BasicTransformerBlock(DIM, HEADS, CTX_DIM, attn_absorb=mode).eval()
    blk.load_state_dict(
        block_state_dict("transformer_block", case["params"]["params"]),
        strict=True)
    return blk


@pytest.mark.parametrize("mode", ["1", "qkv", "out"])
def test_absorbed_block_matches_jax(block_case, monkeypatch, mode):
    """The port's block in absorb mode `mode` against the JAX block driven as
    tests/test_attn_absorb_fused.py drives it: the mode and interpret
    switches in the environment, the TPU flash gate forced open."""
    case = block_case
    monkeypatch.setenv("DMOE_ATTN_ABSORB", mode)
    monkeypatch.setenv("DMOE_ATTN_ABSORB_INTERPRET", "1")
    monkeypatch.setattr(jax_flash, "use_flash", lambda q, kv, e: bool(e))
    ref = np.asarray(case["blk"].apply(case["params"], jnp.asarray(case["x"]),
                                       jnp.asarray(case["ctx"])))
    # the JAX kernels really ran: another summation order than the plain block
    assert not np.array_equal(ref, case["plain"])

    calls = []
    real = attention_mod.absorbed_self_attention
    monkeypatch.setattr(
        attention_mod, "absorbed_self_attention",
        lambda *a, **kw: calls.append(kw["mode"]) or real(*a, **kw))
    with torch.no_grad():
        got = _port_block(case, mode)(_t(case["x"]), _t(case["ctx"]))
        off = _port_block(case, "0")(_t(case["x"]), _t(case["ctx"]))
    assert calls == [mode]          # mode "0" never reaches the absorbed path
    assert rel_err(got.numpy(), ref) < BLOCK_TOL
    assert rel_err(got.numpy(), case["plain"]) < BLOCK_TOL
    assert rel_err(off.numpy(), case["plain"]) < BLOCK_TOL


def test_unadmitted_shape_takes_the_delegated_ln_path(block_case, monkeypatch):
    """A self-attention shape the gate does not admit (head dim 12) applies
    the delegated LayerNorm in the module and adds the residual at the end:
    the un-absorbed block's result, through no absorbed call."""
    rng = np.random.RandomState(6)
    dim, heads = 36, 3
    x = _t(rng.randn(2, 16, dim).astype(np.float32))
    ctx = _t(rng.randn(2, 7, CTX_DIM).astype(np.float32))
    on = BasicTransformerBlock(dim, heads, CTX_DIM, attn_absorb="1").eval()
    off = BasicTransformerBlock(dim, heads, CTX_DIM, attn_absorb="0").eval()
    off.load_state_dict(on.state_dict(), strict=True)
    monkeypatch.setattr(attention_mod, "absorbed_self_attention",
                        lambda *a, **kw: pytest.fail("gate not consulted"))
    with torch.no_grad():
        np.testing.assert_allclose(on(x, ctx).numpy(), off(x, ctx).numpy(),
                                   atol=2e-6, rtol=2e-6)


def test_one_state_dict_loads_with_the_mode_on_and_off(block_case):
    """The absorb mode keeps the parameter tree: the bridge's state dict for
    a block loads strictly whatever the mode."""
    sd = block_state_dict("transformer_block", block_case["params"]["params"])
    keys = [set(BasicTransformerBlock(DIM, HEADS, CTX_DIM, attn_absorb=m)
                .state_dict()) for m in ("0", "1", "qkv", "out")]
    assert all(k == set(sd) for k in keys)
