"""Judge-backbone weights into the port's modules: torchvision ResNet and
AlexNet, LPIPS, SSCD and Inception-v3 (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/weights/port_torchvision.py`. The
port's `models/backbones.py` and `models/inception.py` carry torchvision's
names, so the JAX package's transposes become key mappings here: a state
dict is filtered to the module's keys (batch norm's `num_batches_tracked`
and the Inception aux head dropped), SSCD's `backbone.` prefix kept and its
projection found by the JAX porter's rule (the key ending in
`embeddings.weight`), and the lpips package's heads (`lin{i}.model.1.weight`
of shape (1, C, 1, 1), or bare `lin{i}.weight` / `lin{i}`) flattened to the
`lins.{i}` vectors of `LPIPS`.

State dicts come from torchvision checkpoints, SSCD torchscript files or
the lpips package (`load_state_dict`), or .npz archives of the same keys;
values may be tensors or numpy arrays.
"""
from __future__ import annotations

import zipfile
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.models.backbones import (ALEX_FEATURE_IDX,
                                                             AlexNetConfig,
                                                             ResNetConfig)

StateDict = dict[str, torch.Tensor]


def _t(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else \
        torch.from_numpy(np.asarray(v))


def _keep(key: str) -> bool:
    return not key.endswith("num_batches_tracked")


def resnet_state_dict(sd: Mapping, cfg: ResNetConfig, prefix: str = "",
                      with_fc: bool = True) -> StateDict:
    """A torchvision ResNet (bottleneck) state dict, its keys under
    `prefix` -> `ResNet(cfg)`'s state dict (the stem, `cfg.stage_blocks`
    blocks a stage, and `fc` where present and `with_fc`)."""
    stem = ("conv1.", "bn1.")
    blocks = tuple(f"layer{si + 1}.{bi}." for si, n in
                   enumerate(cfg.stage_blocks) for bi in range(n))
    out = {}
    for k, v in sd.items():
        if not k.startswith(prefix) or not _keep(k):
            continue
        name = k[len(prefix):]
        if name.startswith(stem + blocks) or (with_fc and
                                              name.startswith("fc.")):
            out[name] = _t(v)
    return out


def sscd_state_dict(sd: Mapping, cfg: Optional[ResNetConfig] = None
                    ) -> StateDict:
    """SSCD torchscript state dict (a `backbone.*` ResNet-50 trunk and the
    embeddings projection) -> `SSCD(cfg)`'s state dict."""
    cfg = cfg or ResNetConfig()
    prefix = "backbone." if any(k.startswith("backbone.") for k in sd) else ""
    out = {f"backbone.{k}": v for k, v in
           resnet_state_dict(sd, cfg, prefix, with_fc=False).items()}
    emb_key = next(k for k in sd if k.endswith("embeddings.weight"))
    base = emb_key[: -len(".weight")]
    out["embeddings.weight"] = _t(sd[emb_key])
    if f"{base}.bias" in sd:
        out["embeddings.bias"] = _t(sd[f"{base}.bias"])
    return out


def alexnet_state_dict(sd: Mapping, prefix: Optional[str] = None
                       ) -> StateDict:
    """torchvision AlexNet state dict -> `AlexNet`'s. The prefix
    auto-detects: 'features.' (the full torchvision model) or '' (a bare
    features Sequential)."""
    if prefix is None:
        prefix = "features." if "features.0.weight" in sd else ""
    return {f"features.{idx}.{p}": _t(sd[f"{prefix}{idx}.{p}"])
            for idx in ALEX_FEATURE_IDX for p in ("weight", "bias")}


def lpips_state_dict(alex_sd: Mapping, lin_sd: Mapping,
                     cfg: AlexNetConfig = AlexNetConfig()) -> StateDict:
    """AlexNet features + LPIPS linear heads -> `LPIPS(cfg)`'s state dict.
    `lin_sd` takes the lpips package's naming (`lin{i}.model.1.weight`,
    shape (1, C, 1, 1)) or bare `lin{i}.weight` / `lin{i}`."""
    out = {f"net.{k}": v for k, v in alexnet_state_dict(alex_sd).items()}
    for i, c in enumerate(cfg.channels):
        for key in (f"lin{i}.model.1.weight", f"lin{i}.weight", f"lin{i}"):
            if key in lin_sd:
                w = _t(lin_sd[key]).reshape(-1)
                break
        else:
            raise KeyError(f"no LPIPS linear head for tap {i} in lin_sd")
        if w.shape[0] != c:
            raise ValueError(f"lin{i} has {w.shape[0]} channels, config says {c}")
        out[f"lins.{i}"] = w
    return out


def inception_state_dict(sd: Mapping) -> StateDict:
    """torchvision / torch-fidelity InceptionV3 state dict ->
    `InceptionV3`'s: every BasicConv2d (`<module>.conv.weight` and
    `<module>.bn.*`) and `fc`; the aux head is dropped (the eval-mode FID
    network has none)."""
    return {k: _t(v) for k, v in sd.items()
            if _keep(k) and not k.startswith("AuxLogits")
            and (".conv." in k or ".bn." in k or k.startswith("fc."))}


def census(sd: Mapping, prefix: str = "") -> Sequence[str]:
    """Sorted key listing of a state dict (or of a module's), under
    `prefix` (debug aid, mirrors the tests' key-census pattern)."""
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    return [f"{prefix}{k}" for k in sorted(sd)]


def load_state_dict(path: str) -> StateDict:
    """One '.npz or torch checkpoint -> flat state dict' loader for the
    judge backbones: .npz archives of the same keys, plain torch state
    dicts and `{'state_dict': ...}` wrappers (read with
    `torch.load(weights_only=True)`, which runs no pickled code), and
    torchscript archives (SSCD's), whose `.state_dict()` is taken."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            scripted = any(n.endswith("constants.pkl") for n in z.namelist())
        if scripted:
            return dict(torch.jit.load(path, map_location="cpu").state_dict())
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        obj = obj.get("state_dict", obj)
    return dict(obj)
