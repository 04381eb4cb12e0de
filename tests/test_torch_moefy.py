"""MoEfication on the torch port against the JAX package: balanced k-means
(greedy, exact, Sinkhorn), gate extraction and `moefy_unet` on a tiny UNet
through the bridge, and the expert routers. Sinkhorn plans are float32 on
both sides (JAX runs its jitted plan with x64 off), in another summation
order: their labels are held equal on separable gates, their plans within
PLAN_TOL on random costs."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu.moefication import cluster as jcluster
from diffusion_models_moe_tpu.moefication import moefy as jmoefy
from diffusion_models_moe_tpu.moefication import native as jnative
from diffusion_models_moe_tpu.moefication import routers as jrouters
from diffusion_models_moe_tpu_torch.moefication import (cluster, moefy,
                                                        native, routers)

import torch_parity as tp

# |plan_port - plan_jax| / max plan_jax after 50 float32 log-domain
# iterations: a few hundred float32 ulps of the largest entry
PLAN_TOL = 1e-4
ROUTER_TOL = 1e-5


@pytest.fixture(autouse=True)
def jax_exact_solver_from_the_port(monkeypatch):
    """JAX's "exact" method calls the port's build of the same C++ solver
    (`native/balanced_assign.cpp`): the JAX package builds its library in
    place, which another test process may be loading."""
    monkeypatch.setattr(jnative, "exact_balanced_assign",
                        native.exact_balanced_assign)


def _gates(seed: int, n: int = 240, d: int = 24) -> np.ndarray:
    return np.random.RandomState(seed).randn(n, d)


def _separable(seed: int, k: int = 8, per: int = 20, d: int = 16):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 4
    x = np.concatenate([c + 0.05 * rng.randn(per, d) for c in centers])
    return x[rng.permutation(k * per)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("method", ["greedy", "exact"])
def test_balanced_kmeans_equals_jax(method, seed):
    x = _gates(seed)
    got = cluster.balanced_kmeans(x, 12, seed=seed, method=method,
                                  device="cpu")
    ref = jcluster.balanced_kmeans(x, 12, seed=seed, method=method)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.bincount(got), np.full(12, 20))
    assert cluster.cluster_cost(x, got) == jcluster.cluster_cost(x, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_sinkhorn_labels_equal_jax_on_separable_gates(seed):
    x = _separable(seed)
    got = cluster.balanced_kmeans(x, 8, seed=seed, device="cpu")
    ref = jcluster.balanced_kmeans(x, 8, seed=seed)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.bincount(got), np.full(8, 20))
    rand = cluster.random_split_labels(160, 20)
    np.testing.assert_array_equal(rand, jcluster.random_split_labels(160, 20))
    assert cluster.cluster_cost(x, got) < 0.5 * cluster.cluster_cost(x, rand)


@pytest.mark.parametrize("it", [0, 12, 24])
def test_sinkhorn_plan_within_f32_tolerance_of_jax(it):
    """Random squared distances at the annealed eps of Lloyd iterations 0,
    12 and 24; exact cluster sizes from random gates too."""
    dist = np.random.RandomState(it).rand(200, 10) * 4.0
    eps = 0.05 * 0.85 ** it
    ref = np.asarray(jcluster._sinkhorn_plan(jnp.asarray(dist), jnp.asarray(eps)))
    got = cluster._sinkhorn_plan(torch.from_numpy(dist), float(np.float32(eps)))
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err < PLAN_TOL, err
    labels = cluster.balanced_kmeans(_gates(it), 12, seed=it, device="cpu")
    np.testing.assert_array_equal(np.bincount(labels), np.full(12, 20))


def test_gate_weights_and_moefy_unet_equal_jax(tmp_path):
    """On the same tiny UNet weights (the bridge): the gate rows, and the
    labels of `moefy_unet` by greedy, exact and the random split, with its
    `param_split.npz`. (Sinkhorn's: the tests above, and `chip_smoke.py`
    phase 12 on every SD1.5 gate.)"""
    jax_cfg = jcfg.tiny_config()
    params, pipe = tp.pipelines(jax_cfg)
    cfg, state = pipe.config.unet, pipe.unet.state_dict()
    for got, ref in zip(moefy.gate_weights(state, cfg),
                        jmoefy.gate_weights(params["unet"], jax_cfg.unet)):
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, ref)
    for kw in (dict(method="greedy"), dict(method="exact", seed=3),
               dict(random_split=True)):
        path = str(tmp_path / "param_split.npz")
        got = moefy.moefy_unet(state, cfg, expert_size=16, save_path=path,
                               device="cpu", **kw)
        ref = jmoefy.moefy_unet(params["unet"], jax_cfg.unet, expert_size=16,
                                **kw)
        assert got.keys() == ref.keys() == moefy.load_labels(path).keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_centroid_router_and_targets_equal_jax():
    rng = np.random.RandomState(0)
    labels = rng.permutation(np.arange(64) % 8)
    w = rng.randn(64, 16)
    acts = rng.randn(50, 64)
    np.testing.assert_array_equal(routers.centroid_router(w, labels),
                                  jrouters.centroid_router(w, labels))
    for relu in (True, False):
        np.testing.assert_array_equal(
            routers.expert_activation_targets(acts, labels, relu),
            jrouters.expert_activation_targets(acts, labels, relu))
    scores, targets = rng.randn(50, 8), rng.rand(50, 8)
    for k in (1, 3):
        assert (routers.router_topk_accuracy(scores, targets, k)
                == jrouters.router_topk_accuracy(scores, targets, k))


def _jax_init(d, hidden, e, seed):
    """The initial MLP router parameters of the JAX package's
    `train_mlp_router` for `seed`."""
    k0, k1 = jax.random.split(jax.random.PRNGKey(seed))
    return {"w1": jax.random.normal(k0, (d, hidden)) * (1.0 / np.sqrt(d)),
            "b1": jnp.zeros(hidden),
            "w2": jax.random.normal(k1, (hidden, e)) * (1.0 / np.sqrt(hidden)),
            "b2": jnp.zeros(e)}


def _router_from(p, d, hidden, e) -> routers.MLPRouter:
    r = routers.MLPRouter(d, hidden, e)
    r.load_state_dict({"fc1.weight": torch.tensor(np.asarray(p["w1"]).T),
                       "fc1.bias": torch.tensor(np.asarray(p["b1"])),
                       "fc2.weight": torch.tensor(np.asarray(p["w2"]).T),
                       "fc2.bias": torch.tensor(np.asarray(p["b2"]))})
    return r


def test_mlp_router_loss_gradients_and_adam_steps_match_jax():
    """From JAX's initial parameters: the loss and its gradients on one
    batch, then 5 Adam steps on the batches of the same RandomState, within
    ROUTER_TOL of the JAX package's."""
    rng = np.random.RandomState(0)
    d, hidden, e, n, seed = 16, 32, 8, 300, 1
    x = rng.randn(n, d).astype(np.float32)
    y = jrouters.expert_activation_targets(
        np.maximum(x @ rng.randn(d, 64), 0), np.arange(64) % e).astype(np.float32)
    p0 = _jax_init(d, hidden, e, seed)

    def jax_loss(p, xb, yb):
        logits = jnp.tanh(xb @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
        return jnp.mean(optax.sigmoid_binary_cross_entropy(logits, yb))

    loss, grads = jax.value_and_grad(jax_loss)(p0, x[:64], y[:64])
    r = _router_from(p0, d, hidden, e)
    got = routers.router_loss(r, torch.from_numpy(x[:64]), torch.from_numpy(y[:64]))
    got.backward()
    assert abs(got.item() - float(loss)) < ROUTER_TOL
    for name, key, t in (("fc1.weight", "w1", True), ("fc1.bias", "b1", False),
                         ("fc2.weight", "w2", True), ("fc2.bias", "b2", False)):
        g = r.get_parameter(name).grad.numpy()
        np.testing.assert_allclose(g.T if t else g, np.asarray(grads[key]),
                                   atol=ROUTER_TOL, err_msg=name)

    ref = jrouters.train_mlp_router(x, y, hidden=hidden, steps=5, batch=64,
                                    seed=seed)
    fit = routers.fit_mlp_router(_router_from(p0, d, hidden, e), x, y,
                                 steps=5, batch=64, seed=seed)
    for name, key, t in (("fc1.weight", "w1", True), ("fc1.bias", "b1", False),
                         ("fc2.weight", "w2", True), ("fc2.bias", "b2", False)):
        w = fit.get_parameter(name).detach().numpy()
        np.testing.assert_allclose(w.T if t else w, np.asarray(ref.params[key]),
                                   atol=ROUTER_TOL, err_msg=name)
    with torch.no_grad():
        scores = fit(torch.from_numpy(x)).numpy()
    # the scores (up to ~1.6) carry the parameters' differences through
    # two layers: relative to their size
    np.testing.assert_allclose(scores, np.asarray(ref.scores(x)),
                               rtol=ROUTER_TOL, atol=ROUTER_TOL)


def test_trained_mlp_router_recovers_the_dominant_expert():
    """The port's own training run (its initial weights from a torch
    generator) learns separable synthetic data, as the JAX package's test
    asks of its router."""
    rng = np.random.RandomState(0)
    d, e, per = 16, 4, 8
    labels = np.repeat(np.arange(e), per)
    w = (rng.randn(e, d) * 3)[labels] + 0.1 * rng.randn(e * per, d)
    x = rng.randn(512, d).astype(np.float32)
    targets = routers.expert_activation_targets(np.maximum(x @ w.T, 0), labels)
    router = routers.train_mlp_router(x, targets, hidden=32, steps=300, seed=1)
    with torch.no_grad():
        pred = router(torch.from_numpy(x)).numpy()
    assert routers.router_topk_accuracy(pred, targets, k=1) > 0.8
