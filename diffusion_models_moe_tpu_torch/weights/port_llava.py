"""HF LLaVA-1.5 / Llama checkpoints into the port's judge modules (PyTorch
port of `diffusion_models_moe_tpu/weights/port_llava.py`).

The port's `LlavaForConditionalGeneration` and `LlamaModel` carry
transformers' names, so the JAX package's transposes become key mappings:

  * `port_llama_state(sd, cfg, prefix)`: a `LlamaForCausalLM` state dict
    (`{prefix}model.layers.N...`, `lm_head.weight` under the prefix or
    outside it, or tied to the embeddings where absent) -> `LlamaModel`'s
  * `port_llava_state(sd, cfg)`: a `LlavaForConditionalGeneration` state
    dict in either transformers layout (published llava-hf snapshots'
    `language_model.model.*`, or the `model.language_model.*` nesting of
    transformers >= 4.52) -> `LlavaForConditionalGeneration`'s
  * `port_llava(snapshot_dir, cfg)`: `model.safetensors`, or the shards of
    `model.safetensors.index.json`, read by the port's own safetensors
    reader, through `port_llava_state`.

f16 and bf16 tensors are widened to f32. `load_llava_state` loads such a
state dict and accepts the keys a llava-hf snapshot may leave out: the
vision layers past the feature layer and the post-layernorm, which LLaVA
never runs.
"""
from __future__ import annotations

import json
import os

import torch

from diffusion_models_moe_tpu_torch.models.clip_vision import CLIPVisionConfig
from diffusion_models_moe_tpu_torch.models.llama import LlamaConfig
from diffusion_models_moe_tpu_torch.models.llava import LlavaConfig
from diffusion_models_moe_tpu_torch.weights import _safetensors

StateDict = dict[str, torch.Tensor]


def load_snapshot_state(snapshot_dir: str) -> StateDict:
    """model.safetensors, or every shard named by
    model.safetensors.index.json, merged into one state dict."""
    single = os.path.join(snapshot_dir, "model.safetensors")
    if os.path.exists(single):
        return _safetensors.read(single)
    index = os.path.join(snapshot_dir, "model.safetensors.index.json")
    if not os.path.exists(index):
        raise FileNotFoundError(f"no model.safetensors[.index.json] under "
                                f"{snapshot_dir}")
    with open(index) as f:
        shards = sorted(set(json.load(f)["weight_map"].values()))
    sd: StateDict = {}
    for shard in shards:
        sd.update(_safetensors.read(os.path.join(snapshot_dir, shard)))
    return sd


def _f32(t) -> torch.Tensor:
    t = torch.as_tensor(t)
    return t.float() if t.dtype in (torch.float16, torch.bfloat16) else t


def port_llama_state(sd: dict, cfg: LlamaConfig, prefix: str = "") -> StateDict:
    """`{prefix}model.*` + `lm_head.weight` -> `LlamaModel(cfg)`'s state
    dict (Qwen2's q/k/v biases where present)."""
    out = {}
    for k, v in sd.items():
        if k.startswith(f"{prefix}model."):
            name = k[len(prefix):]
            if name.startswith("model.layers."):
                if int(name.split(".")[2]) >= cfg.num_layers:
                    continue
            out[name] = _f32(v)
    lm_key = f"{prefix}lm_head.weight"
    if lm_key not in sd and "lm_head.weight" in sd:
        lm_key = "lm_head.weight"    # llava-hf keeps lm_head outside the prefix
    out["lm_head.weight"] = (_f32(sd[lm_key]) if lm_key in sd   # else tied
                             else out["model.embed_tokens.weight"].clone())
    return out


def _normalize_llava_keys(sd: dict) -> dict:
    """transformers >= 4.52 nests everything under `model.` (state dicts say
    `model.language_model.layers...`, `lm_head.weight`); published llava-hf
    snapshots use the original `language_model.model.layers...` layout.
    Normalize to the published layout."""
    if not any(k.startswith("model.language_model.") for k in sd):
        return sd
    out = {}
    for k, v in sd.items():
        if k.startswith("model.language_model."):
            k = "language_model.model." + k[len("model.language_model."):]
        elif k.startswith(("model.vision_tower.",
                           "model.multi_modal_projector.")):
            k = k[len("model."):]
        out[k] = v
    return out


def _vision_state(sd: dict, cfg: CLIPVisionConfig) -> StateDict:
    pre = "vision_tower.vision_model."
    out = {}
    for k, v in sd.items():
        if not k.startswith(pre) or k.endswith("position_ids"):
            continue
        name = k[len(pre):].replace("pre_layernorm.", "pre_layrnorm.")
        if name.startswith("encoder.layers."):
            if int(name.split(".")[2]) >= cfg.num_layers:
                continue
        out["vision_tower.vision_model." + name] = _f32(v)
    return out


def port_llava_state(sd: dict, cfg: LlavaConfig) -> StateDict:
    """LlavaForConditionalGeneration state dict (either transformers
    layout) -> `LlavaForConditionalGeneration(cfg)`'s state dict."""
    sd = _normalize_llava_keys(sd)
    lm_prefix = ("language_model."
                 if any(k.startswith("language_model.") for k in sd) else "")
    out = _vision_state(sd, cfg.vision)
    for i in (1, 2):
        for p in ("weight", "bias"):
            key = f"multi_modal_projector.linear_{i}.{p}"
            out[key] = _f32(sd[key])
    for k, v in port_llama_state(sd, cfg.text, prefix=lm_prefix).items():
        out[f"language_model.{k}"] = v
    return out


def port_llava(snapshot_dir: str, cfg: LlavaConfig | None = None) -> StateDict:
    return port_llava_state(load_snapshot_state(snapshot_dir),
                            cfg or LlavaConfig())


def load_llava_state(model, sd: StateDict) -> None:
    """`model.load_state_dict(sd)`, allowing only the keys LLaVA never reads
    to be missing: vision layers past the feature layer and the vision
    post-layernorm (llava-hf snapshots may drop them)."""
    cfg = model.cfg
    v = cfg.vision
    used = (cfg.vision_feature_layer if cfg.vision_feature_layer >= 0
            else v.num_layers + cfg.vision_feature_layer + 1)
    pre = "vision_tower.vision_model."
    missing, unexpected = model.load_state_dict(sd, strict=False)
    for k in missing:
        name = k[len(pre):] if k.startswith(pre) else None
        if name is not None and (name.startswith("post_layernorm.") or (
                name.startswith("encoder.layers.")
                and int(name.split(".")[2]) >= used)):
            continue
        raise KeyError(f"LLaVA state dict lacks {k!r}")
    if unexpected:
        raise KeyError(f"unexpected keys in the LLaVA state dict: "
                       f"{sorted(unexpected)[:8]}")


def llava_7b_config(dtype: torch.dtype = torch.float32) -> LlavaConfig:
    """llava-hf/llava-1.5-7b-hf geometry."""
    return LlavaConfig(
        vision=CLIPVisionConfig(image_size=336, patch_size=14,
                                hidden_size=1024, intermediate_size=4096,
                                num_layers=24, num_heads=16),
        text=LlamaConfig(dtype=dtype))


def llava_13b_config(dtype: torch.dtype = torch.float32) -> LlavaConfig:
    """llava-hf/llava-1.5-13b-hf geometry (the reference's judge)."""
    return LlavaConfig(
        vision=CLIPVisionConfig(image_size=336, patch_size=14,
                                hidden_size=1024, intermediate_size=4096,
                                num_layers=24, num_heads=16),
        text=LlamaConfig(hidden_size=5120, intermediate_size=13824,
                         num_layers=40, num_heads=40, num_kv_heads=40,
                         dtype=dtype))
