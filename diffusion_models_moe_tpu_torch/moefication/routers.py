"""Learned expert routers: centroid and MLP variants (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/moefication/routers.py`, the
MoEfication paper's router constructions:

* `centroid_router`: an expert's embedding is the mean of its neurons'
  gate-weight rows; route by input @ centroid^T.
* `train_mlp_router`: a 2-layer tanh MLP trained with sigmoid BCE against
  each expert's share of positive activation mass.

Routers give per-token expert scores in the layout `routing_mask`'s top-k
selection takes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def centroid_router(gate_weights: np.ndarray, labels: np.ndarray,
                    normalize: bool = True) -> np.ndarray:
    """(H, D) gate rows + (H,) labels -> (E, D) float64 expert centroids."""
    w = np.asarray(gate_weights, np.float64)
    if normalize:
        w = w / np.maximum(np.linalg.norm(w, axis=1, keepdims=True), 1e-12)
    labels = np.asarray(labels)
    n_experts = int(labels.max()) + 1
    return np.stack([w[labels == e].mean(axis=0) for e in range(n_experts)])


def expert_activation_targets(acts: np.ndarray, labels: np.ndarray,
                              relu: bool = True) -> np.ndarray:
    """(N, H) activations -> (N, E) per-expert positive mass, each row
    divided by its largest: the MLP router's BCE target."""
    a = np.asarray(acts, np.float64)
    if relu:
        a = np.maximum(a, 0.0)
    labels = np.asarray(labels)
    n_experts = int(labels.max()) + 1
    onehot = (labels[None, :] == np.arange(n_experts)[:, None])  # (E, H)
    mass = a @ onehot.T                                          # (N, E)
    denom = np.maximum(mass.max(axis=1, keepdims=True), 1e-12)
    return mass / denom


class MLPRouter(nn.Module):
    """router(x) -> expert scores tanh(x W1 + b1) W2 + b2, in float32.
    Weights are drawn N(0, 1/fan_in) from `generator`, biases zero."""

    def __init__(self, d: int, hidden: int, n_experts: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden = hidden
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, n_experts)
        with torch.no_grad():
            for fc in (self.fc1, self.fc2):
                fan_in = fc.weight.shape[1]
                fc.weight.copy_(torch.randn(fc.weight.shape, generator=generator)
                                * fan_in ** -0.5)
                fc.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.tanh(self.fc1(x)))


def router_loss(router: MLPRouter, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy of the router's scores against the
    targets."""
    return F.binary_cross_entropy_with_logits(router(x), y)


def fit_mlp_router(router: MLPRouter, inputs: np.ndarray, targets: np.ndarray,
                   lr: float = 1e-2, steps: int = 500, batch: int = 256,
                   seed: int = 0) -> MLPRouter:
    """Trains `router` in place with Adam (0.9, 0.999, eps 1e-8, as optax's
    defaults) on batches of min(batch, N) rows drawn with replacement from
    `np.random.RandomState(seed)`; returns it."""
    x = torch.as_tensor(np.asarray(inputs, np.float32))
    y = torch.as_tensor(np.asarray(targets, np.float32))
    opt = torch.optim.Adam(router.parameters(), lr=lr)
    rng = np.random.RandomState(seed)
    n = x.shape[0]
    for _ in range(steps):
        idx = torch.from_numpy(rng.randint(0, n, min(batch, n)))
        opt.zero_grad()
        router_loss(router, x[idx], y[idx]).backward()
        opt.step()
    return router


def train_mlp_router(inputs: np.ndarray, targets: np.ndarray,
                     hidden: int = 64, lr: float = 1e-2, steps: int = 500,
                     batch: int = 256, seed: int = 0) -> MLPRouter:
    """An input -> expert-mass router, its initial weights from a
    `torch.Generator` seeded with `seed`, trained by `fit_mlp_router`."""
    router = MLPRouter(np.shape(inputs)[1], hidden, np.shape(targets)[1],
                       torch.Generator().manual_seed(seed))
    return fit_mlp_router(router, inputs, targets, lr, steps, batch, seed)


def router_topk_accuracy(scores: np.ndarray, targets: np.ndarray,
                         k: int) -> float:
    """Share of the true top-k experts that the router's top-k recovers."""
    s_top = np.argsort(-np.asarray(scores), axis=1)[:, :k]
    t_top = np.argsort(-np.asarray(targets), axis=1)[:, :k]
    hits = [len(set(a) & set(b)) / k for a, b in zip(s_top, t_top)]
    return float(np.mean(hits))
