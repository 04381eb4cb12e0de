"""Skilled neuron/expert selectors: paired t-test, AP/accuracy, Wanda, 'greater'.

A copy of `diffusion_models_moe_tpu/analysis/selectors.py` (numpy and scipy
only) for the PyTorch port, which cannot import the JAX package.

Pure numpy on stacked (T, H)/(T, E) stat arrays from the tap system. Artifact
semantics match the reference's per-(t, l) masks (SURVEY.md §2.4); storage is one
npz of (T, H) boolean arrays per concept instead of 51x16 JSON/pickle files.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import stats as scipy_stats


# ---------------------------------------------------------------- paired t-test
def t_test_skilled(base_mean: np.ndarray, adj_mean: np.ndarray,
                   diff_std: np.ndarray, n_prompts: int,
                   conf: float = 0.05) -> np.ndarray:
    """One-sided paired t-test: neuron is skilled for the concept if its activation
    is significantly HIGHER on concept prompts, i.e. t < -critical with
    t = (base - adj) / (diff_std / sqrt(n)) (reference: modularity/paired_t_test.py:68-80).

    Critical values are computed with scipy instead of the reference's CSV table
    (reference: modularity/paired_t_test.py:15-36, dof_critical_values.csv).
    Returns a boolean array shaped like the inputs ((T, H) or (H,)).
    """
    critical = scipy_stats.t.ppf(1.0 - conf, df=n_prompts - 1)
    denom = np.asarray(diff_std, np.float64) / np.sqrt(n_prompts)
    t_value = (np.asarray(base_mean, np.float64)
               - np.asarray(adj_mean, np.float64)) / np.maximum(denom, 1e-12)
    return t_value < -critical


def random_masks_like(skilled: np.ndarray, seed: int = 0
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Random-skilled and random-unskilled control masks with the same per-(t,)
    cardinality (reference: modularity/paired_t_test.py:122-154)."""
    rng = np.random.RandomState(seed)
    skilled = np.asarray(skilled, bool)
    flat = skilled.reshape(-1, skilled.shape[-1])
    rand_sk = np.zeros_like(flat)
    rand_unsk = np.zeros_like(flat)
    for i, row in enumerate(flat):
        k = int(row.sum())
        if k == 0:
            continue
        rand_sk[i, rng.choice(row.size, k, replace=False)] = True
        unskilled_idx = np.where(~row)[0]
        take = min(k, unskilled_idx.size)
        rand_unsk[i, rng.choice(unskilled_idx, take, replace=False)] = True
    return rand_sk.reshape(skilled.shape), rand_unsk.reshape(skilled.shape)


# ---------------------------------------------------------------- AP / accuracy
def prediction_accuracy_skilled(base_acts: np.ndarray, adj_acts: np.ndarray,
                                labels: np.ndarray,
                                ratio: float = 0.05) -> np.ndarray:
    """Prediction-accuracy selector (reference: modularity/skilled_neuron_ap.py:96-177).

    base_acts/adj_acts: (N_prompts, T, H) per-prompt stats; labels: (N,) binary
    (e.g. memorized=1). A neuron's score is the fraction of prompts where
    (adj > base) agrees with the label; the top `ratio` per (t,) are skilled.
    Returns (T, H) bool.
    """
    agree = ((adj_acts > base_acts).astype(np.int8)
             == np.asarray(labels, np.int8)[:, None, None])
    score = agree.mean(axis=0)                      # (T, H)
    k = max(int(ratio * score.shape[-1]), 1)
    # exactly-k per (t,), highest scores first (ties by index)
    order = np.argsort(-score, axis=-1)
    exact = np.zeros(score.shape, bool)
    np.put_along_axis(exact, order[..., :k], True, axis=-1)
    return exact


# ---------------------------------------------------------------------- Wanda
def wanda_metric(w2_abs: np.ndarray, act_norms: np.ndarray) -> np.ndarray:
    """|W2| * ||act||_2: (D, H) weight magnitudes x (T, H) column norms -> (T, D, H)
    (reference: modularity/wanda.py:142-144). float32: the (T, D, H) product for a
    real mid-block layer (51, 1280, 5120) is 1.3 GB already; float64 doubles it
    without changing which entries rank top-k."""
    return (np.asarray(w2_abs, np.float32)[None, :, :]
            * np.asarray(act_norms, np.float32)[:, None, :])


def wanda_skilled(w2_abs: np.ndarray, base_norms: np.ndarray,
                  adj_norms: np.ndarray, skill_ratio: float) -> np.ndarray:
    """Per (t, output-row): top `skill_ratio` columns of the adj metric, kept only
    where adj metric > base metric (reference: modularity/wanda.py:150-168).
    Returns (T, D, H) bool in the reference's (out, in) weight orientation.

    Ranked per timestep slice (the top-k is independent per (t, row)) so the
    peak ancillary allocation is one (D, H) argsort instead of a full
    (T, D, H) int64 (~2.7 GB for a real mid-block layer)."""
    w2f = np.asarray(w2_abs, np.float32)
    k = int(skill_ratio * w2f.shape[-1])
    t_steps = np.asarray(adj_norms).shape[0]
    out = np.zeros((t_steps,) + w2f.shape, bool)
    if k == 0:
        return out
    for t in range(t_steps):
        mb = w2f * np.asarray(base_norms[t], np.float32)[None, :]
        ma = w2f * np.asarray(adj_norms[t], np.float32)[None, :]
        order = np.argsort(-ma, axis=-1)
        top = np.zeros_like(ma, bool)
        np.put_along_axis(top, order[..., :k], True, axis=-1)
        out[t] = top & (ma > mb)
    return out


def wanda_mask_to_flax(mask: np.ndarray) -> np.ndarray:
    """(.., D, H) reference orientation -> (.., H, D) flax kernel orientation, the
    JAX package's `LayerIntervention.out_weight_mask` layout (the port's
    masks keep the (D, H) layout of `ff.net.2.weight`)."""
    return np.swapaxes(mask, -1, -2)


# ------------------------------------------------------------------- "greater"
def greater_skilled_experts(base_mean: np.ndarray, adj_mean: np.ndarray,
                            base_std: np.ndarray, labels: np.ndarray,
                            skill_ratio: float = 0.5) -> np.ndarray:
    """Expert is skilled if > skill_ratio of its neurons satisfy
    adj_mean > base_mean + 0.5 * std (reference: modularity/greater.py:38-84).
    base/adj_mean, base_std: (T, H); labels: (H,) cluster ids. Returns (T, E) bool.
    """
    hot = adj_mean > (base_mean + 0.5 * base_std)    # (T, H)
    labels = np.asarray(labels)
    n_experts = int(labels.max()) + 1
    onehot = (labels[None, :] == np.arange(n_experts)[:, None])  # (E, H)
    frac = (hot[:, None, :] * onehot[None, :, :]).sum(-1) / onehot.sum(-1)[None, :]
    return frac > skill_ratio


def skilled_neurons_to_experts(skilled: np.ndarray, labels: np.ndarray,
                               skill_ratio: float) -> np.ndarray:
    """Map skilled-neuron masks into expert space: expert skilled if the fraction of
    its neurons that are skilled exceeds skill_ratio (reference:
    modularity/paired_t_test.py:213-228 / greater.py:57-75). skilled: (T, H)."""
    labels = np.asarray(labels)
    n_experts = int(labels.max()) + 1
    onehot = (labels[None, :] == np.arange(n_experts)[:, None])
    frac = (np.asarray(skilled, np.float64)[:, None, :] * onehot).sum(-1) \
        / onehot.sum(-1)[None, :]
    return frac > skill_ratio


# --------------------------------------------------------------- set operations
def intersect_over_seeds(masks: list[np.ndarray]) -> np.ndarray:
    """Seed-robust skilled set: AND across seeds
    (reference: modularity/intersection_over_seeds.py:11-96)."""
    out = np.asarray(masks[0], bool)
    for m in masks[1:]:
        out = out & np.asarray(m, bool)
    return out


def moefy_compare_skilled_experts(sel_base: np.ndarray, sel_adj: np.ndarray
                                  ) -> np.ndarray:
    """SIMPLIFIED aggregate variant: experts ever selected (by top-k routing)
    for concept prompts and never for base prompts, over prompt-summed (T, E)
    counts. The reference's actual rule is per-prompt — use
    `moefy_compare_skilled_experts_per_prompt` for exact parity."""
    return (np.asarray(sel_adj) > 0) & (np.asarray(sel_base) == 0)


def moefy_compare_skilled_experts_per_prompt(sel_base: np.ndarray,
                                             sel_adj: np.ndarray,
                                             skill_ratio: float,
                                             symm: bool = False) -> np.ndarray:
    """The reference's moefy-compare rule, verbatim
    (modularity/moefy_skilled_experts.py:94-121): per prompt pair and (t, l),
    take the SET difference of selected experts (adj − base; symmetric when
    `symm`), accumulate the per-expert occurrence count across prompts, and
    mark an expert skilled when its count >= int(skill_ratio * n_prompts)
    (floor + >=, as in the reference's Counter threshold). Unlike the
    aggregate variant, an expert that base selects in a few prompts can still
    be skilled if the per-prompt difference fires often enough.

    sel_*: (P, T, E) boolean/count per-prompt selections (GetExperts /
    TapSpec.expert_sel per prompt). Returns (T, E) bool."""
    b = np.asarray(sel_base) > 0
    a = np.asarray(sel_adj) > 0
    if b.shape != a.shape or b.ndim != 3:
        raise ValueError(f"need matching (P, T, E) stacks, got {b.shape} "
                         f"vs {a.shape}")
    diff = a & ~b
    if symm:
        diff = diff | (b & ~a)
    counts = diff.sum(axis=0)
    # the reference thresholds Counter entries, which only exist for experts
    # appearing in >= 1 per-prompt diff — so a floor-zero int(skill_ratio*P)
    # still requires one occurrence, never "every expert"
    return counts >= max(int(skill_ratio * b.shape[0]), 1)
