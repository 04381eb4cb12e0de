"""Parity of the torch port's kernel modules with the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
(its Pallas kernel in interpret mode) and the port's plain PyTorch version,
which is what the port's wrappers run on CPU tensors. f32 throughout, so
the tolerances bound the algorithm, not the dtype.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_moe_tpu.ops.geglu_ff_fused import \
    geglu_ff_fused as jax_geglu_ff_fused
from diffusion_models_moe_tpu.ops.sd_flash import (_sd_cross_fwd_impl,
                                                   _sd_self_fwd_impl)
from diffusion_models_moe_tpu.taps import routing_mask as jax_routing_mask
from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.ops.attn_absorb_fused import (
    attn_out_residual_fused, ln_qkv_fused)
from diffusion_models_moe_tpu_torch.ops.conv_chain_fused import conv3x3_chain
from diffusion_models_moe_tpu_torch.ops.geglu_ff_fused import (
    geglu_ff_fused, geglu_ff_reference)
from diffusion_models_moe_tpu_torch.ops.sd_flash import (sd_cross_attention,
                                                         sd_self_attention)
from diffusion_models_moe_tpu_torch.taps import (LayerIntervention,
                                                 patterns_from_labels,
                                                 routing_mask)

FF_RTOL = 1e-5      # max |diff| / max |ref|, as the JAX kernel's own tests
ATTN_TOL = 2e-5


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _ff_inputs(seed, n=256, c=64, e=16, tie=False):
    rng = np.random.RandomState(seed)
    hdim = 4 * c
    f = np.float32
    x = rng.randn(n, c).astype(f)
    w1 = (rng.randn(c, 2 * hdim) * 0.05).astype(f)       # flax (in, out)
    b1 = (rng.randn(2 * hdim) * 0.1).astype(f)
    w2 = (rng.randn(hdim, c) * 0.05).astype(f)
    b2 = (rng.randn(c) * 0.1).astype(f)
    g = (1.0 + 0.1 * rng.randn(c)).astype(f)
    bb = (0.1 * rng.randn(c)).astype(f)
    labels = rng.permutation(np.arange(hdim) % e)
    if tie:
        # experts 0 and 1 get identical gate columns, so their scores tie
        # exactly and both survive the threshold
        labels = np.arange(hdim) % e
        gate = w1[:, hdim:]
        gate[:, labels == 1] = gate[:, labels == 0]
        b1[:] = 0.0
    patterns = (labels[None, :] == np.arange(e)[:, None]).astype(f)
    return x, w1, b1, w2, b2, g, bb, patterns


def _port_ff(x, w1, b1, w2, b2, pat, k, relu, g, bb, fn=geglu_ff_fused):
    t = torch.from_numpy
    return fn(t(x), t(np.ascontiguousarray(w1.T)), t(b1),
              t(np.ascontiguousarray(w2.T)), t(b2),
              None if pat is None else t(pat), k, relu,
              None if g is None else t(g), None if bb is None else t(bb)).numpy()


@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("absorb", [False, True])
def test_ff_plain_matches_jax_kernel(routed, relu, absorb):
    x, w1, b1, w2, b2, g, bb, patterns = _ff_inputs(0)
    pat, k = (patterns, 5) if routed else (None, 0)
    ln = dict(ln_scale=jnp.asarray(g), ln_bias=jnp.asarray(bb)) if absorb else {}
    ref = jax_geglu_ff_fused(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1),
                             jnp.asarray(w2), jnp.asarray(b2),
                             None if pat is None else jnp.asarray(pat), k,
                             relu, interpret=True, **ln)
    got = _port_ff(x, w1, b1, w2, b2, pat, k, relu,
                   g if absorb else None, bb if absorb else None)
    err = _rel_err(got, ref)
    msg = f"max |port - jax| / max |jax| = {err:.3e}"
    if err >= FF_RTOL:
        # which side moved: each against the plain version in float64
        f64 = _port_ff(*(None if a is None else a.astype(np.float64)
                         for a in (x, w1, b1, w2, b2, pat)), k, relu,
                       *((g.astype(np.float64), bb.astype(np.float64))
                         if absorb else (None, None)))
        msg += (f"; against float64: jax {_rel_err(ref, f64):.3e}, port "
                f"{_rel_err(got, f64):.3e}")
    assert err < FF_RTOL, msg


def test_ff_ties_keep_more_than_k_experts():
    """Exact score ties at the kth place keep every tied expert, as the JAX
    kernel's threshold does (mirrors test_fused_ff_routing_threshold_semantics)."""
    x, w1, b1, w2, b2, _, _, patterns = _ff_inputs(1, e=8, tie=True)
    k = 3
    ref = jax_geglu_ff_fused(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1),
                             jnp.asarray(w2), jnp.asarray(b2),
                             jnp.asarray(patterns), k, interpret=True)
    got = _port_ff(x, w1, b1, w2, b2, patterns, k, False, None, None)
    assert _rel_err(got, ref) < FF_RTOL
    # the tie really happens: some rows keep more than k experts
    hdim = w1.shape[1] // 2
    h = x @ w1[:, hdim:] + b1[hdim:]
    ga = torch.nn.functional.gelu(torch.from_numpy(h)).numpy()
    s = ga @ patterns.T
    kth = np.sort(s, axis=1)[:, -k][:, None]
    assert ((s >= kth).sum(1) > k).any()


def _edit_patterns(patterns: np.ndarray, edit: str) -> np.ndarray:
    """expert_remove: rows of three experts zeroed, as the model's
    `_step_patterns` zeroes them; two_ones: every third column also in the
    next expert's pattern."""
    pat = patterns.copy()
    if edit == "expert_remove":
        pat[[1, 5, 9]] = 0.0
    else:
        cols = np.arange(0, pat.shape[1], 3)
        pat[(pat[:, cols].argmax(0) + 1) % pat.shape[0], cols] = 1.0
    return pat


@pytest.mark.parametrize("edit", ["expert_remove", "two_ones"])
def test_ff_plain_matches_jax_kernel_on_edited_patterns(edit):
    """Zeroed expert rows (they score 0 and still compete) and columns with
    two ones (a neuron in two experts, mask values up to 2), as the kernel
    takes them, against the JAX kernel in interpret mode."""
    x, w1, b1, w2, b2, g, bb, patterns = _ff_inputs(4)
    pat, k = _edit_patterns(patterns, edit), 5
    ref = jax_geglu_ff_fused(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1),
                             jnp.asarray(w2), jnp.asarray(b2), jnp.asarray(pat),
                             k, False, interpret=True, ln_scale=jnp.asarray(g),
                             ln_bias=jnp.asarray(bb))
    got = _port_ff(x, w1, b1, w2, b2, pat, k, False, g, bb)
    assert _rel_err(got, ref) < FF_RTOL


def test_masked_product_rounds_the_same_for_mask_values_up_to_two():
    """The FF kernel writes bf16(h*ga) once and the masked product as
    bf16(bf16(h*ga) * m): that equals bf16(h*ga*m) bit for bit where the
    neuron mask m is 0, 1 or 2 (zero or a power of two), as every pattern
    the model builds gives it. For a column of three or more ones (m up to
    E = 256) it is rounded twice, and stays within one bf16 unit in the last
    place of bf16(h*ga*m)."""
    rng = np.random.RandomState(0)
    v = torch.from_numpy((rng.randn(100_000) * rng.lognormal(0, 3, 100_000))
                         .astype(np.float32))
    for m in (0.0, 1.0, 2.0):
        assert torch.equal((v.bfloat16() * m).view(torch.int16),
                           (v * m).bfloat16().view(torch.int16))
    assert not torch.equal(v.bfloat16() * 3.0, (v * 3.0).bfloat16())
    for m in (3.0, 5.0, 7.0, 255.0, 256.0):
        twice = (v.bfloat16().float() * m).bfloat16().float()
        once = (v * m).bfloat16().float()
        assert ((twice - once).abs() <= once.abs() * 2.0 ** -7).all()


def test_ff_cpu_wrapper_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches nothing."""
    x, w1, b1, w2, b2, g, bb, patterns = _ff_inputs(2)
    _build.reset_launch_counts()
    a = _port_ff(x, w1, b1, w2, b2, patterns, 4, False, g, bb)
    b = _port_ff(x, w1, b1, w2, b2, patterns, 4, False, g, bb,
                 fn=geglu_ff_reference)
    np.testing.assert_array_equal(a, b)
    assert all(v == 0 for v in _build.LAUNCHES.values())


@pytest.mark.parametrize("op", ["ff", "self", "cross", "ln_qkv", "attn_out",
                                "chain"])
def test_wrappers_take_the_plain_version_only_on_cpu(op):
    """Off the CPU a wrapper launches its kernel or raises; it never falls
    back to the plain version (a meta tensor has no kernel)."""
    def t(*shape):
        return torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        if op == "ff":
            geglu_ff_fused(t(8, 32), t(256, 32), t(256), t(32, 128), t(32))
        elif op == "self":
            sd_self_attention(t(1, 8, 2, 40), t(1, 8, 2, 40), t(1, 8, 2, 40), 0.1)
        elif op == "cross":
            sd_cross_attention(t(1, 8, 2, 40), t(1, 77, 2, 40),
                               t(1, 77, 2, 40), 0.1, 77)
        elif op == "ln_qkv":
            ln_qkv_fused(t(1, 8, 32), t(32, 32), t(32, 32), t(32, 32), 2,
                         t(32), t(32))
        elif op == "attn_out":
            attn_out_residual_fused(t(1, 8, 2, 16), t(32, 32), t(32),
                                    t(1, 8, 32))
        else:
            conv3x3_chain(t(1, 8, 4, 4), t(16, 8, 3, 3), t(1, 16), t(1, 8),
                          t(1, 8), residual=t(1, 16, 4, 4))


def _qkv(seed, b, s, h, d, s_kv=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s_kv or s, h, d).astype(np.float32)
    v = rng.randn(b, s_kv or s, h, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("d", [40, 80])
def test_self_attention_plain_matches_jax_kernel(d):
    q, k, v = _qkv(d, 2, 128, 2, d)
    scale = d ** -0.5
    ref = _sd_self_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            scale, block_q=64, block_k=64, interpret=True)
    got = sd_self_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("d", [40, 80])
def test_cross_attention_plain_matches_jax_kernel(d):
    q, k, v = _qkv(d + 1, 2, 128, 2, d, s_kv=77)
    scale = d ** -0.5
    ref = _sd_cross_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             scale, 77, block_q=64, interpret=True)
    got = sd_cross_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), scale, 77)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("exact_k", [False, True])
def test_routing_mask_matches_jax(exact_k):
    rng = np.random.RandomState(5)
    n, hdim, e, k = 64, 160, 8, 3
    # quarter-integers: every score is exact in any summation order, and
    # exact ties at the kth place are common
    gate = (rng.randint(-4, 5, size=(n, hdim)) / 4.0).astype(np.float32)
    labels = rng.permutation(np.arange(hdim) % e)
    pat_np = (labels[None, :] == np.arange(e)[:, None]).astype(np.float32)
    mask_j, sel_j = jax_routing_mask(jnp.asarray(gate), jnp.asarray(pat_np), k,
                                     exact_k=exact_k)
    mask_t, sel_t = routing_mask(torch.from_numpy(gate),
                                 patterns_from_labels(labels, e), k,
                                 exact_k=exact_k)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    kept = sel_t.sum(1)
    assert (kept == k).all() if exact_k else (kept > k).any()


@pytest.mark.parametrize("field", ["expert_boost", "neuron_mask",
                                   "out_weight_mask", "token_mask"])
def test_unported_interventions_raise(field):
    """The four interventions the first slice refused are ported; each
    still raises on a tensor whose rank the FF layer cannot read per step
    (a 0-d tensor), and takes a tensor of its rank."""
    with pytest.raises(ValueError, match=field):
        LayerIntervention(**{field: torch.zeros(())})
    rank = {"expert_boost": 2, "neuron_mask": 2, "out_weight_mask": 3,
            "token_mask": 1}[field]
    iv = LayerIntervention(**{field: torch.zeros((1,) * rank)})
    assert getattr(iv, field).dim() == rank


def test_package_imports_without_jax():
    """The port imports neither JAX nor the JAX package (checked in a fresh
    interpreter: this process has JAX loaded already)."""
    code = ("import sys, diffusion_models_moe_tpu_torch as p\n"
            "import diffusion_models_moe_tpu_torch.weights.bridge\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.startswith('diffusion_models_moe_tpu.')"
            " or m == 'diffusion_models_moe_tpu']\n"
            "assert not bad, bad\n"
            "from diffusion_models_moe_tpu_torch.ops import _build\n"
            "assert _build.load_library.cache_info().currsize == 0\n")
    root = __file__.rsplit("/tests/", 1)[0]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
