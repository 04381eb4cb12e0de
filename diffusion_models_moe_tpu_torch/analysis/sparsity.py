"""Gate sparsity measurement for ReLUfied models (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/analysis/sparsity.py`: the
per-(timestep, layer) share of exact-zero activated gate entries over a
prompt set, from the `gate_sparsity` tap. ReLUfication itself is the
`ff_activation='geglu-relu'` config field.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.analysis.stats import TapAccumulator
from diffusion_models_moe_tpu_torch.taps import TapSpec


def measure_sparsity(pipe, tokenize, prompts: Sequence[str], seed: int = 0,
                     num_steps: Optional[int] = None,
                     out_path: Optional[str] = None) -> dict[int, np.ndarray]:
    """Returns {layer: (T,) mean zero share}; optionally writes it as JSON.
    The negative prompt is the encoding of "" (not all-zero ids)."""
    acc = TapAccumulator()
    tap = TapSpec(gate_sparsity=True)
    uncond = tokenize([""])
    for prompt in prompts:
        _, taps = pipe.generate(tokenize([prompt]), uncond,
                                torch.Generator().manual_seed(seed),
                                num_steps=num_steps, tap=tap, decode=False)
        acc.update({l: v.float().cpu().numpy()
                    for l, v in taps["gate_sparsity"].items()})
    means = acc.mean()
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({str(l): np.asarray(v).tolist()
                       for l, v in means.items()}, f)
    return means
