"""Gradient accumulation with the EMA, and selective fine-tuning, in the
port's training step against the JAX package's `make_train_step` on the
CPU (tiny_config, f32, the ReLUfied FF; JAX's draws injected).

Parameter changes are held within 2e-4 of max |JAX change| per tensor on
the entries whose gradient is at least 1000 Adam eps (see
tests/test_torch_train_step.py: Adam's first step turns the f32 rounding of
a gradient within a few eps of 0 into an O(1) change of its step). Each
JAX configuration is one XLA compile (~55-60 s here). The learning rate
is 1e-2 so that a step stands well above the f32 rounding of the
parameters it moves (norm scales of 1 round at 6e-8).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from diffusion_models_moe_tpu.training import train as jtrain
from diffusion_models_moe_tpu_torch.schedulers.common import NoiseTables
from diffusion_models_moe_tpu_torch.training import train

TOL = 2e-4


@pytest.fixture(scope="module")
def setup():
    return tp.train_setup()


def _port_grads(port, batch, draws, tcfg) -> dict:
    unet = copy.deepcopy(port.unet)
    pb = tp.port_batch(batch)
    train.loss_fn(unet, pb["latents"], pb["text_emb"], draws, tcfg,
                  NoiseTables.create()).backward()
    return {n: p.grad.numpy() for n, p in unet.named_parameters()}


def _conditioned_err(got: dict, ref: dict, grads: dict, eps: float) -> float:
    """max over tensors of max |got - ref| / max |ref| on the entries whose
    |grad| >= 1000 eps."""
    worst = 0.0
    for n, r in ref.items():
        keep = np.abs(grads[n]) >= 1000 * eps
        if keep.any() and np.abs(r).max() > 0:
            worst = max(worst, float(np.abs(got[n] - r)[keep].max()
                                     / np.abs(r).max()))
    return worst


def test_accumulation_with_ema_matches_jax(setup):
    """k = 2: the first micro-step leaves the parameters and the EMA as they
    were (JAX's `MultiSteps` returns zero updates, and its EMA skips
    micro-steps); the second applies the mean of the two gradients,
    clipped, through AdamW, and the EMA decays once."""
    jcfg, pcfg, params, port, batch = setup
    kw = dict(learning_rate=1e-2, grad_accum_steps=2, ema_decay=0.5,
              snr_gamma=5.0)
    tcfg_j, tcfg = jtrain.TrainConfig(**kw), train.TrainConfig(**kw)
    state_j = jtrain.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params["unet"]), tcfg_j)
    step_j = jax.jit(jtrain.make_train_step(jcfg.unet, tcfg_j))
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    keys = [jax.random.PRNGKey(10), jax.random.PRNGKey(11)]
    before = tp.unet_tree_to_port(state_j.params, pcfg.unet)

    unet = copy.deepcopy(port.unet)
    state = train.create_train_state(unet, tcfg)
    step = train.make_train_step(unet, tcfg)
    draws = [tp.jax_draws(k, batch["latents"].shape) for k in keys]
    grads = [_port_grads(port, batch, d, tcfg) for d in draws]

    state_j, _ = step_j(state_j, jb, keys[0])
    state, _ = step(state, tp.port_batch(batch), draws=draws[0])
    assert state.opt_state["mini_step"] == 1 and state.opt_state["count"] == 0
    assert int(state_j.opt_state.mini_step) == 1
    for tree in (state_j.params, state_j.ema_params):
        for k, v in tp.unet_tree_to_port(tree, pcfg.unet).items():
            np.testing.assert_array_equal(v, before[k])
    for tensors in (state.params, state.ema_params):
        for k, v in tensors.items():
            np.testing.assert_array_equal(v.numpy(), before[k])

    state_j, _ = step_j(state_j, jb, keys[1])
    state, _ = step(state, tp.port_batch(batch), draws=draws[1])
    assert state.opt_state["mini_step"] == 0 and state.opt_state["count"] == 1
    mean_grad = {n: (grads[0][n] + grads[1][n]) / 2 for n in grads[0]}
    for got, ref in ((state.params, state_j.params),
                     (state.ema_params, state_j.ema_params)):
        ref = tp.unet_tree_to_port(ref, pcfg.unet)
        ref_delta = {k: ref[k] - before[k] for k in before}
        got_delta = {k: got[k].numpy() - before[k] for k in before}
        assert max(np.abs(v).max() for v in ref_delta.values()) > 1e-4
        assert _conditioned_err(got_delta, ref_delta, mean_grad,
                                tcfg.adam_eps) < TOL
    for n, p in unet.named_parameters():
        assert torch.equal(p.detach(), state.params[n])


def test_frozen_parameters_take_no_update_departure(setup):
    """Selective fine-tuning (`ft_method="attention"`), a departure pinned:
    JAX's `optax.masked` hands a frozen leaf its raw gradient and
    `apply_updates` adds it (the frozen delta equals the gradient); the
    port's frozen parameters do not move and take no gradient; the
    trainable parameters agree."""
    jcfg, pcfg, params, port, batch = setup
    kw = dict(learning_rate=1e-2, ft_method="attention")
    tcfg_j, tcfg = jtrain.TrainConfig(**kw), train.TrainConfig(**kw)
    state_j = jtrain.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params["unet"]), tcfg_j)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    key = jax.random.PRNGKey(12)
    step_fn = jtrain.make_train_step(jcfg.unet, tcfg_j)
    new_j, _ = jax.jit(step_fn)(state_j, jb, key)
    _, grads_j = jax.jit(jax.value_and_grad(tp.closure_var(step_fn, "loss_fn"))
                         )(state_j.params, jb, key)
    before = tp.unet_tree_to_port(state_j.params, pcfg.unet)
    after = tp.unet_tree_to_port(new_j.params, pcfg.unet)
    grads = tp.unet_tree_to_port(grads_j, pcfg.unet)
    mask = train.trainable_mask(before, "attention")
    assert 0 < sum(mask.values()) < len(mask)

    unet = copy.deepcopy(port.unet)
    state = train.create_train_state(unet, tcfg)
    step = train.make_train_step(unet, tcfg)
    draws = tp.jax_draws(key, batch["latents"].shape)
    state, _ = step(state, tp.port_batch(batch), draws=draws)
    got = {k: v.numpy() for k, v in state.params.items()}
    port_grads = _port_grads(port, batch, draws, tcfg)
    moved = 0
    for n, trains in mask.items():
        assert unet.get_parameter(n).requires_grad == trains
        if trains:
            continue
        np.testing.assert_array_equal(got[n], before[n])
        jax_delta = after[n] - before[n]
        assert tp.rel_err(jax_delta, grads[n]) < TOL, n
        moved += bool(np.abs(jax_delta).max() > 0)
    assert moved > 0
    trainable = [n for n in mask if mask[n]]
    assert _conditioned_err({n: got[n] - before[n] for n in trainable},
                            {n: after[n] - before[n] for n in trainable},
                            port_grads, tcfg.adam_eps) < TOL
