"""Taps and interventions for GEGLU FF layers (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/taps.py`.

* `TapSpec` names the per-layer statistics to collect. The FF layers write
  them into a dict the caller passes down; `denoise` stacks them over the
  steps into `(T, ...)` tensors, indexed by the step, never by a hook
  counter.
* `LayerIntervention` holds the tensors that mutate one FF layer's forward
  pass. Per-step fields are read with `step_row`, which clamps the step to
  the last row as JAX's traced indexing does: a `(1, E)` mask applies at
  every step, and a windowed mask ends in an all-False row that the steps
  past the window read.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

# Fill value for removed GEGLU gate neurons: about the minimum of GELU.
GEGLU_REMOVAL_FILL = -0.17


@dataclasses.dataclass(frozen=True)
class TapSpec:
    """Per-layer statistics to collect (all off by default).

      max_gate          max over tokens of the activated gate, (H,)
      mean_gate         mean over tokens of the activated gate, (H,)
      gate_sparsity     share of exact zeros in the activated gate, ()
      save_gate         the activated gate itself, (B, S, H)
      ff_out_colnorm_sq sum over tokens of the squared entries of the
                        row-normalised input to W2, (H,); additive over
                        steps and prompts, sqrt gives the Wanda norms
      expert_scores_max max over tokens of the expert routing scores, (E,)
      expert_freq       per-expert selection count of batch element 0,
                        weighted 1/seq_len, (E,)
      expert_sel        per-expert selection count over the batch, (E,)
      save_eps          the CFG-combined noise prediction of each step
    """
    max_gate: bool = False
    mean_gate: bool = False
    gate_sparsity: bool = False
    save_gate: bool = False
    ff_out_colnorm_sq: bool = False
    expert_scores_max: bool = False
    expert_freq: bool = False
    expert_sel: bool = False
    save_eps: bool = False

    def any_gate_stat(self) -> bool:
        return (self.max_gate or self.mean_gate or self.gate_sparsity
                or self.save_gate or self.ff_out_colnorm_sq)

    def any_expert_stat(self) -> bool:
        return self.expert_scores_max or self.expert_freq or self.expert_sel

    def any(self) -> bool:
        return any(getattr(self, f.name) for f in dataclasses.fields(self))


# the ranks each per-step field may have (checked at construction)
_RANKS = {"expert_remove": (2,), "expert_boost": (2,), "neuron_mask": (1, 2),
          "out_weight_mask": (2, 3), "token_mask": (1,)}


@dataclasses.dataclass(frozen=True)
class LayerIntervention:
    """Tensors mutating one FF layer's forward pass. All fields optional.
    H is the gate width (4 x dim), D the model dim, E the number of experts,
    T the number of intervention steps.

    patterns:        (E, H) 0/1 expert membership; row e marks expert e's
                     neurons.
    k:               top-k expert count. k > 0 routes (masks the gate);
                     k < 0 only observes top-|k| selection for the expert
                     taps; k == 0 observes top-1.
    expert_remove:   (T, E) bool; zero these experts' pattern rows at step
                     t before routing.
    expert_boost:    (T, E) float added to the routing scores at step t.
    neuron_mask:     (T, H) bool; replace these gate values by
                     `neuron_fill` at step t (before routing). The CLIP
                     MLP also takes (H,).
    neuron_fill:     GEGLU: -0.17; GELU path: 0.0.
    out_weight_mask: (D, H) or (T, D, H) bool; zero these entries of the
                     output projection. Stored in the nn.Linear layout of
                     `ff.net.2.weight`; the JAX package stores its
                     transpose, the flax kernel layout (H, D).
    token_mask:      (S,) bool; restrict the gate statistics to these
                     token positions.
    """
    patterns: Optional[torch.Tensor] = None
    k: int = 0
    expert_remove: Optional[torch.Tensor] = None
    expert_boost: Optional[torch.Tensor] = None
    neuron_mask: Optional[torch.Tensor] = None
    neuron_fill: float = GEGLU_REMOVAL_FILL
    out_weight_mask: Optional[torch.Tensor] = None
    token_mask: Optional[torch.Tensor] = None

    def __post_init__(self):
        for name, ranks in _RANKS.items():
            t = getattr(self, name)
            if t is not None and t.dim() not in ranks:
                raise ValueError(f"LayerIntervention.{name} has rank {t.dim()}"
                                 f", expected one of {ranks}")


Interventions = Tuple[Optional[LayerIntervention], ...]


def no_interventions(n_layers: int) -> Interventions:
    return tuple([None] * n_layers)


def layer_name(idx: int) -> str:
    """Canonical FF layer key used in label dicts and artifacts."""
    return f"ff_{idx:02d}"


def step_row(arr: torch.Tensor, t: int) -> torch.Tensor:
    """Row t of a per-step tensor, the step clamped to the last row as JAX
    clamps an index traced in `lax.scan`."""
    return arr[min(t, arr.shape[0] - 1)]


def routing_mask(gate2d: torch.Tensor, patterns: torch.Tensor, k: int,
                 expert_boost: Optional[torch.Tensor] = None,
                 exact_k: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k expert routing: returns (neuron mask (N, H), selected (N, E)).

    score[n, e] is the sum of the post-activation gate over expert e's
    neurons, accumulated in f32, plus `expert_boost[e]` if given. By default
    selection is `score >= kth` (threshold semantics): on exact ties more
    than k experts are kept. `exact_k=True` keeps exactly k, lower expert
    index first on ties, as `jax.lax.top_k` orders them."""
    score = gate2d.float() @ patterns.float().t()              # (N, E)
    if expert_boost is not None:
        score = score + expert_boost.float()
    if exact_k:
        idx = torch.sort(score, dim=-1, descending=True, stable=True)[1][:, :k]
        sel = torch.zeros_like(score).scatter_(1, idx, 1.0)
    else:
        kth = torch.topk(score, k, dim=-1).values[:, -1:]
        sel = (score >= kth).float()
    mask = sel @ patterns.float()                              # (N, H) 0/1
    return mask.to(gate2d.dtype), sel


def patterns_from_labels(labels, n_experts: int) -> torch.Tensor:
    """(H,) cluster labels -> (E, H) f32 0/1 membership matrix."""
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64)
    return (labels[None, :] == torch.arange(n_experts)[:, None]).float()
