"""The fused MoE routing kernel's plain version against the JAX kernel, on
the CPU.

The same numpy inputs go through JAX `fused_route_multiply` (its Pallas
kernel in interpret mode) and the port's `route_multiply_reference`, which
is what `fused_route_multiply` runs on CPU tensors. f32 throughout: the
tolerance bounds the algorithm, not the dtype.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_moe_tpu.ops.routing_kernel import \
    fused_route_multiply as jax_fused_route_multiply
from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.ops.routing_kernel import (
    fused_route_multiply, route_multiply_reference)
from diffusion_models_moe_tpu_torch.taps import patterns_from_labels

RTOL = 1e-5      # max |diff| / max |ref|, as the JAX kernel's own tests


def _inputs(seed, n, e, hdim=None, tie=False):
    rng = np.random.RandomState(seed)
    hdim = hdim or 20 * e
    hidden = rng.randn(n, hdim).astype(np.float32)
    gate = rng.randn(n, hdim).astype(np.float32)
    labels = rng.permutation(np.arange(hdim) % e)
    if tie:
        # experts 0 and 1 get the same gate values, so their scores tie
        # exactly in any summation order and both survive the threshold
        labels = np.arange(hdim) % e
        gate[:, labels == 1] = gate[:, labels == 0]
    return hidden, gate, labels


def _selected(out: np.ndarray, patterns: np.ndarray) -> np.ndarray:
    """(N, E): experts with any nonzero neuron in the routed product."""
    return ((out != 0).astype(np.float32) @ patterns.T) > 0


@pytest.mark.parametrize("e", [16, 64])
@pytest.mark.parametrize("tie", [False, True])
def test_plain_version_matches_jax_kernel(e, tie):
    n, k = 203, max(int(0.3 * e), 1)          # N ragged against any tile
    hidden, gate, labels = _inputs(e + tie, n, e, tie=tie)
    pat = patterns_from_labels(labels, e)
    ref = np.asarray(jax_fused_route_multiply(
        jnp.asarray(hidden), jnp.asarray(gate), jnp.asarray(pat.numpy()), k,
        interpret=True))
    got = route_multiply_reference(torch.from_numpy(hidden),
                                   torch.from_numpy(gate), pat, k).numpy()
    assert float(np.max(np.abs(got - ref)) / np.max(np.abs(ref))) <= RTOL
    sel_ref, sel_got = _selected(ref, pat.numpy()), _selected(got, pat.numpy())
    np.testing.assert_array_equal(sel_got, sel_ref)
    if tie:
        # the tie really happens and keeps more than k experts
        assert (sel_got.sum(1) > k).any()
        np.testing.assert_array_equal(sel_got[:, 0], sel_got[:, 1])
    else:
        assert (sel_got.sum(1) == k).all()


@pytest.mark.parametrize("edit", ["expert_remove", "two_ones"])
def test_plain_version_matches_jax_kernel_on_edited_patterns(edit):
    """Pattern rows zeroed as expert_remove zeroes them (those experts
    score 0 and still compete) and columns with two ones (mask values up to
    2), against the JAX kernel in interpret mode."""
    n, e, k = 203, 16, 4
    hidden, gate, labels = _inputs(7, n, e)
    pat = patterns_from_labels(labels, e)
    if edit == "expert_remove":
        pat[[1, 5, 9]] = 0.0
    else:
        cols = torch.arange(0, pat.shape[1], 3)
        pat[(pat[:, cols].argmax(0) + 1) % e, cols] = 1.0
    ref = np.asarray(jax_fused_route_multiply(
        jnp.asarray(hidden), jnp.asarray(gate), jnp.asarray(pat.numpy()), k,
        interpret=True))
    got = route_multiply_reference(torch.from_numpy(hidden),
                                   torch.from_numpy(gate), pat, k).numpy()
    assert float(np.max(np.abs(got - ref)) / np.max(np.abs(ref))) <= RTOL
    if edit == "two_ones":
        assert np.abs(got / np.where(hidden * gate == 0, 1, hidden * gate)
                      ).max() == pytest.approx(2.0)


def test_cpu_wrapper_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    hidden, gate, labels = _inputs(3, 77, 16)
    h, g = torch.from_numpy(hidden), torch.from_numpy(gate)
    pat = patterns_from_labels(labels, 16)
    _build.reset_launch_counts()
    got = fused_route_multiply(h, g, pat, 4)
    assert torch.equal(got, route_multiply_reference(h, g, pat, 4))
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_wrapper_has_no_plain_fallback_off_the_cpu():
    """Off the CPU the wrapper launches its kernel or raises (a meta tensor
    has no kernel)."""
    t = torch.empty((8, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_route_multiply(t, t, torch.empty((4, 128), device="meta"), 2)


@pytest.mark.parametrize("k", [0, 17])
def test_wrapper_refuses_k_outside_the_experts(k):
    hidden, gate, labels = _inputs(4, 8, 16)
    with pytest.raises(ValueError, match="outside"):
        fused_route_multiply(torch.from_numpy(hidden), torch.from_numpy(gate),
                             patterns_from_labels(labels, 16), k)
