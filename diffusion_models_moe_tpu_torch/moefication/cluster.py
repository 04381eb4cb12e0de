"""Balanced (equal-size) k-means for expert construction (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/moefication/cluster.py`: the rows of
each GEGLU gate matrix are clustered into experts of exactly `expert_size`
neurons. The k-means++ initialisation and the Lloyd updates are float64
numpy on the same `np.random.RandomState(seed)` as the JAX package, so they
are the same numbers. Each iteration's balanced assignment is one of:

* "sinkhorn": an entropic optimal-transport plan with uniform marginals
  (50 log-domain iterations in float32, torch on the caller's device, as
  the JAX package runs its jitted plan in float32), rounded to an exact
  assignment greedily on -log(plan) in float64;
* "greedy": points by how much they lose if denied their nearest cluster,
  each to the nearest cluster with room;
* "exact": the least-cost assignment by min-cost flow
  (`moefication/native.py`).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.config import resolve_device


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(n, 1e-12)


def _greedy_balanced_assign(dist: np.ndarray, size: int) -> np.ndarray:
    """Capacity-constrained assignment: visit points by how much they lose
    if denied their best cluster (best-vs-second margin), assign to the
    nearest cluster with remaining capacity."""
    n, k = dist.shape
    part = np.partition(dist, 1, axis=1)
    order = np.argsort(part[:, 0] - part[:, 1])    # most to lose first
    capacity = np.full(k, size, np.int64)
    labels = np.full(n, -1, np.int64)
    ranked = np.argsort(dist, axis=1)
    for i in order:
        for c in ranked[i]:
            if capacity[c] > 0:
                labels[i] = c
                capacity[c] -= 1
                break
    return labels


@torch.no_grad()
def _sinkhorn_plan(cost: torch.Tensor, eps: float,
                   n_iter: int = 50) -> torch.Tensor:
    """Entropic OT plan with uniform marginals, in float32 on `cost`'s
    device: rows sum to 1/N, columns to 1/K."""
    cost = cost.float()
    n, k = cost.shape
    log_mu = torch.full((n, 1), -float(np.log(np.float32(n))), device=cost.device)
    log_nu = torch.full((1, k), -float(np.log(np.float32(k))), device=cost.device)
    log_k = -cost / torch.tensor(eps, dtype=torch.float32, device=cost.device)
    f = torch.zeros((n, 1), device=cost.device)
    g = torch.zeros((1, k), device=cost.device)
    for _ in range(n_iter):
        f = log_mu - torch.logsumexp(log_k + g, dim=1, keepdim=True)
        g = log_nu - torch.logsumexp(log_k + f, dim=0, keepdim=True)
    return torch.exp(log_k + f + g)


def balanced_kmeans(x: np.ndarray, n_clusters: int, *, n_iter: int = 25,
                    seed: int = 0, method: str = "sinkhorn",
                    normalize: bool = True, device="cuda") -> np.ndarray:
    """Cluster the rows of `x` into `n_clusters` clusters of equal size;
    returns (N,) int64 labels. N must be a multiple of n_clusters. `device`
    is where the Sinkhorn plan runs (the card unless the caller names
    another); the other methods run on the host."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if n % n_clusters:
        raise ValueError(f"{n} rows do not split into {n_clusters} equal "
                         "clusters")
    if method not in ("sinkhorn", "greedy", "exact"):
        raise ValueError(f"method={method!r}: one of 'sinkhorn', 'greedy', "
                         "'exact'")
    size = n // n_clusters
    if method == "sinkhorn":
        device = resolve_device(device)
    elif method == "exact":
        from diffusion_models_moe_tpu_torch.moefication.native import \
            exact_balanced_assign
    if normalize:
        x = _normalize_rows(x)

    # k-means++ initialisation on a deterministic RNG
    rng = np.random.RandomState(seed)
    centers = _kmeanspp_init(x, n_clusters, rng)

    labels = None
    for it in range(n_iter):
        # squared euclidean distances by the Gram expansion
        dist = (np.sum(x * x, axis=1, keepdims=True)
                - 2.0 * x @ centers.T
                + np.sum(centers * centers, axis=1)[None, :])
        dist = np.maximum(dist, 0.0)
        if method == "sinkhorn":
            plan = _sinkhorn_plan(
                torch.from_numpy(dist).to(device, torch.float32),
                float(np.float32(0.05 * (0.85 ** it)))).cpu().numpy()
            # round the soft plan exactly: greedy on -log(plan). NaNs appear
            # where the annealed eps underflows every logit; they are zeroed,
            # and the floor is applied in float64 before the log (in float32
            # 1e-300 is 0 and the log would see it)
            plan = np.nan_to_num(plan, nan=0.0, posinf=0.0, neginf=0.0)
            plan = plan.astype(np.float64)
            new_labels = _greedy_balanced_assign(
                -np.log(np.clip(plan, 1e-300, None)), size)
        elif method == "greedy":
            new_labels = _greedy_balanced_assign(dist, size)
        else:
            new_labels = exact_balanced_assign(dist, size)
        if labels is not None and np.array_equal(new_labels, labels):
            break
        labels = new_labels
        for c in range(n_clusters):
            centers[c] = x[labels == c].mean(axis=0)
    return labels.astype(np.int64)


def _kmeanspp_init(x: np.ndarray, k: int, rng) -> np.ndarray:
    """k-means++ seeding. Each point's squared distance to the last centre
    is summed over its own row, so row blocks on threads give the same bits
    as one numpy expression over the whole array (numpy releases the GIL
    in both the subtraction and the sum)."""
    n = x.shape[0]
    centers = np.empty((k, x.shape[1]), x.dtype)
    centers[0] = x[rng.randint(n)]
    closest = np.full(n, np.inf)
    d = np.empty(n)
    workers = os.cpu_count() or 1
    step = -(-n // workers)

    def rows(lo: int, center: np.ndarray) -> None:
        diff = x[lo:lo + step] - center
        np.square(diff, out=diff)
        np.sum(diff, axis=1, out=d[lo:lo + step])

    with ThreadPoolExecutor(workers) as pool:
        for c in range(1, k):
            list(pool.map(lambda lo: rows(lo, centers[c - 1]),
                          range(0, n, step)))
            closest = np.minimum(closest, d)
            probs = closest / closest.sum()
            centers[c] = x[rng.choice(n, p=probs)]
    return centers


def random_split_labels(n_neurons: int, expert_size: int) -> np.ndarray:
    """Contiguous split control: neuron i in expert i // expert_size."""
    return (np.arange(n_neurons) // expert_size).astype(np.int64)


def cluster_cost(x: np.ndarray, labels: np.ndarray,
                 normalize: bool = True) -> float:
    """Mean within-cluster squared distance (for quality tests)."""
    x = np.asarray(x, np.float64)
    if normalize:
        x = _normalize_rows(x)
    total = 0.0
    for c in np.unique(labels):
        pts = x[labels == c]
        total += np.sum((pts - pts.mean(axis=0)) ** 2)
    return total / x.shape[0]
