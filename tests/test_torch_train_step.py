"""The port's training step (`training/train.py`) against the JAX package's
`make_train_step` on the CPU, at tiny_config in f32 with the ReLUfied FF:
the loss and every parameter's gradient under the objective's options
(eps or v target, min-SNR, noise offset, input perturbation), and the
parameters after one AdamW step. JAX's four draws are made from its key
split and injected into the port; noise never crosses frameworks.

Errors are max |port - JAX| / max |JAX| per tensor, held within 2e-4. JAX's
gradients come from its own `loss_fn` (closed over by `make_train_step`)
under `jax.value_and_grad`; each JAX configuration is one XLA compile (the
full step ~55 s, the gradient ~16 s on this suite's CPU).
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


def _jax_state(params, tcfg):
    return jtrain.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params["unet"]), tcfg)


def _worst(got: dict, ref: dict) -> float:
    assert got.keys() == ref.keys()
    return max(tp.rel_err(got[k], ref[k]) for k in ref
               if np.abs(ref[k]).max() > 0)


CASES = {
    "eps": dict(),
    "eps-snr-offset-perturbation": dict(snr_gamma=5.0, noise_offset=0.1,
                                        input_perturbation=0.1),
    "v-snr-offset": dict(prediction_type="v_prediction", snr_gamma=5.0,
                         noise_offset=0.1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(setup, case):
    """The loss and the gradient of every UNet parameter equal JAX's
    `loss_fn` and its `jax.value_and_grad` on the same draws."""
    jcfg, pcfg, params, port, batch = setup
    tcfg_j = jtrain.TrainConfig(**CASES[case])
    tcfg = train.TrainConfig(**CASES[case])
    loss_j = tp.closure_var(jtrain.make_train_step(jcfg.unet, tcfg_j),
                            "loss_fn")
    key = jax.random.PRNGKey(3)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_j))(
        _jax_state(params, tcfg_j).params,
        jax.tree_util.tree_map(jnp.asarray, batch), key)
    ref = tp.unet_tree_to_port(ref_grads, pcfg.unet)

    unet = copy.deepcopy(port.unet)
    pb = tp.port_batch(batch)
    loss = train.loss_fn(unet, pb["latents"], pb["text_emb"],
                         tp.jax_draws(key, batch["latents"].shape), tcfg,
                         NoiseTables.create())
    loss.backward()
    got = {n: p.grad.numpy() for n, p in unet.named_parameters()}
    assert abs(loss.item() - float(ref_loss)) <= TOL * abs(float(ref_loss))
    assert _worst(got, ref) < TOL


def test_adamw_step_matches_jax(setup):
    """One AdamW step of `make_train_step` (clip, decoupled decay, the
    objective with every option on): loss, grad_norm, and each parameter's
    change against JAX's jitted step."""
    jcfg, pcfg, params, port, batch = setup
    kw = dict(learning_rate=1e-3, snr_gamma=5.0, noise_offset=0.1,
              input_perturbation=0.1, max_grad_norm=1.0)
    tcfg_j, tcfg = jtrain.TrainConfig(**kw), train.TrainConfig(**kw)
    state_j = _jax_state(params, tcfg_j)
    key = jax.random.PRNGKey(4)
    new_j, metrics_j = jax.jit(jtrain.make_train_step(jcfg.unet, tcfg_j))(
        state_j, jax.tree_util.tree_map(jnp.asarray, batch), key)
    before = tp.unet_tree_to_port(state_j.params, pcfg.unet)
    after = tp.unet_tree_to_port(new_j.params, pcfg.unet)
    ref_delta = {k: after[k] - before[k] for k in before}

    unet = copy.deepcopy(port.unet)
    state = train.create_train_state(unet, tcfg)
    step = train.make_train_step(unet, tcfg)
    state, metrics = step(state, tp.port_batch(batch),
                          draws=tp.jax_draws(key, batch["latents"].shape))
    got_delta = {k: (state.params[k] - torch.from_numpy(before[k])).numpy()
                 for k in before}
    assert state.step == 1 and state.opt_state["count"] == 1
    for name in ("loss", "grad_norm"):
        assert abs(float(metrics[name]) - float(metrics_j[name])) <= (
            TOL * abs(float(metrics_j[name])))
    assert float(metrics_j["grad_norm"]) > tcfg.max_grad_norm  # clip ran
    # Adam's first step moves an entry by lr (g / (|g| + eps) + wd p): where
    # |g| is within a few eps, f32 rounding of g changes that step by O(1).
    # Held on the entries whose gradient is at least 1000 eps (about 65% of
    # them here); every other entry within the step's bound, in both.
    grad_unet = copy.deepcopy(port.unet)
    pb = tp.port_batch(batch)
    train.loss_fn(grad_unet, pb["latents"], pb["text_emb"],
                  tp.jax_draws(key, batch["latents"].shape), tcfg,
                  NoiseTables.create()).backward()
    kept = total = 0
    worst = 0.0
    for n, p in grad_unet.named_parameters():
        conditioned = p.grad.abs().numpy() >= 1000 * tcfg.adam_eps
        kept, total = kept + conditioned.sum(), total + conditioned.size
        diff = np.abs(got_delta[n] - ref_delta[n])[conditioned]
        if diff.size:
            worst = max(worst, diff.max() / np.abs(ref_delta[n]).max())
        # (the deltas are differences of f32 parameters: a few units in
        # the last place of p besides)
        bound = (tcfg.learning_rate * (1 + tcfg.weight_decay
                                       * np.abs(before[n]))
                 + 4 * np.spacing(np.abs(before[n])))
        assert (np.abs(got_delta[n]) <= bound).all(), n
        assert (np.abs(ref_delta[n]) <= bound).all(), n
    assert worst < TOL and kept / total > 0.5
    # the working copy holds the masters
    for n, p in unet.named_parameters():
        assert torch.equal(p.detach(), state.params[n])
