"""Flax parameter trees (numpy) -> the torch port's state dicts.

The inverse of `diffusion_models_moe_tpu/weights/port.py`, written without
importing the JAX package: a params tree from the JAX package's
`init_params` (converted to numpy) becomes the state dicts of the port's
UNet, CLIP text encoder and VAE decoder, so both run the same weights.
Layouts: conv HWIO -> OIHW; Dense (in, out) -> Linear (out, in); Flax
multi-head attention kernels (D, heads, hd) / (heads, hd, D) -> Linear;
the GEGLU FF's `proj/kernel` and `out_proj_kernel` -> `ff.net.0.proj` and
`ff.net.2`.
"""
from __future__ import annotations

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.config import (CLIPTextConfig, UNetConfig,
                                                   VAEConfig)


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _linear(p: dict, use_bias: bool = True) -> dict:
    out = {"weight": np.ascontiguousarray(_np(p["kernel"]).T)}
    if use_bias and "bias" in p:
        out["bias"] = _np(p["bias"])
    return out


def _conv(p: dict) -> dict:
    return {"weight": np.ascontiguousarray(np.transpose(_np(p["kernel"]),
                                                        (3, 2, 0, 1))),
            "bias": _np(p["bias"])}


def _norm(p: dict) -> dict:
    return {"weight": _np(p["scale"]), "bias": _np(p["bias"])}


def _emit(sd: dict, prefix: str, tensors: dict) -> None:
    for name, v in tensors.items():
        sd[f"{prefix}.{name}"] = v


def _resnet(sd: dict, prefix: str, p: dict) -> None:
    for name in ("norm1", "norm2"):
        _emit(sd, f"{prefix}.{name}", _norm(p[name]))
    for name in ("conv1", "conv2", "conv_shortcut"):
        if name in p:
            _emit(sd, f"{prefix}.{name}", _conv(p[name]))
    if "time_emb_proj" in p:
        _emit(sd, f"{prefix}.time_emb_proj", _linear(p["time_emb_proj"]))


def _transformer_block(sd: dict, prefix: str, blk: dict) -> None:
    for name in ("norm1", "norm2", "norm3"):
        _emit(sd, f"{prefix}.{name}", _norm(blk[name]))
    for attn in ("attn1", "attn2"):
        for proj in ("to_q", "to_k", "to_v"):
            _emit(sd, f"{prefix}.{attn}.{proj}",
                  _linear(blk[attn][proj], use_bias=False))
        _emit(sd, f"{prefix}.{attn}.to_out.0", _linear(blk[attn]["to_out"]))
    ff = blk["ff"]
    _emit(sd, f"{prefix}.ff.net.0.proj", _linear(ff["proj"]))
    sd[f"{prefix}.ff.net.2.weight"] = np.ascontiguousarray(
        _np(ff["out_proj_kernel"]).T)
    sd[f"{prefix}.ff.net.2.bias"] = _np(ff["out_proj_bias"])


def _transformer2d(sd: dict, prefix: str, p: dict) -> None:
    _emit(sd, f"{prefix}.norm", _norm(p["norm"]))
    _emit(sd, f"{prefix}.proj_in", _linear(p["proj_in"]))
    _emit(sd, f"{prefix}.proj_out", _linear(p["proj_out"]))
    d = 0
    while f"transformer_blocks_{d}" in p:
        _transformer_block(sd, f"{prefix}.transformer_blocks.{d}",
                           p[f"transformer_blocks_{d}"])
        d += 1


def unet_numpy_state_dict(params: dict, cfg: UNetConfig) -> dict:
    """UNet2DCondition params -> diffusers-named numpy state dict."""
    sd: dict = {}
    _emit(sd, "conv_in", _conv(params["conv_in"]))
    _emit(sd, "conv_out", _conv(params["conv_out"]))
    _emit(sd, "conv_norm_out", _norm(params["conv_norm_out"]))
    for name in ("linear_1", "linear_2"):
        _emit(sd, f"time_embedding.{name}",
              _linear(params["time_embedding"][name]))
    if "time_cond_proj" in params:      # LCM's guidance embedding
        _emit(sd, "time_embedding.cond_proj",
              _linear(params["time_cond_proj"], use_bias=False))
    n = len(cfg.block_out_channels)
    for i, kind in enumerate(cfg.down_block_types):
        for j in range(cfg.layers_per_block):
            _resnet(sd, f"down_blocks.{i}.resnets.{j}", params[f"down_{i}_res_{j}"])
            if kind == "cross":
                _transformer2d(sd, f"down_blocks.{i}.attentions.{j}",
                               params[f"down_{i}_attn_{j}"])
        if i < n - 1:
            _emit(sd, f"down_blocks.{i}.downsamplers.0.conv",
                  _conv(params[f"down_{i}_downsample"]["conv"]))
    _resnet(sd, "mid_block.resnets.0", params["mid_res_0"])
    _resnet(sd, "mid_block.resnets.1", params["mid_res_1"])
    _transformer2d(sd, "mid_block.attentions.0", params["mid_attn_0"])
    for i, kind in enumerate(cfg.up_block_types):
        for j in range(cfg.layers_per_block + 1):
            _resnet(sd, f"up_blocks.{i}.resnets.{j}", params[f"up_{i}_res_{j}"])
            if kind == "cross":
                _transformer2d(sd, f"up_blocks.{i}.attentions.{j}",
                               params[f"up_{i}_attn_{j}"])
        if i < n - 1:
            _emit(sd, f"up_blocks.{i}.upsamplers.0.conv",
                  _conv(params[f"up_{i}_upsample"]["conv"]))
    return sd


def vae_decoder_numpy_state_dict(params: dict, cfg: VAEConfig) -> dict:
    """VAEDecoder params -> diffusers AutoencoderKL decoder-side numpy state dict."""
    sd: dict = {}
    _emit(sd, "post_quant_conv", _conv(params["post_quant_conv"]))
    _emit(sd, "decoder.conv_in", _conv(params["conv_in"]))
    _emit(sd, "decoder.conv_out", _conv(params["conv_out"]))
    _emit(sd, "decoder.conv_norm_out", _norm(params["conv_norm_out"]))
    _resnet(sd, "decoder.mid_block.resnets.0", params["mid"]["res_0"])
    _resnet(sd, "decoder.mid_block.resnets.1", params["mid"]["res_1"])
    a, pa = params["mid"]["attn"], "decoder.mid_block.attentions.0"
    _emit(sd, f"{pa}.group_norm", _norm(a["group_norm"]))
    for proj in ("to_q", "to_k", "to_v"):
        _emit(sd, f"{pa}.{proj}", _linear(a[proj]))
    _emit(sd, f"{pa}.to_out.0", _linear(a["to_out"]))
    n = len(cfg.block_out_channels)
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}",
                    params[f"up_{i}_res_{j}"])
        if i < n - 1:
            _emit(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                  _conv(params[f"up_{i}_upsample"]["conv"]))
    return sd


def clip_text_numpy_state_dict(params: dict, cfg: CLIPTextConfig) -> dict:
    """CLIPTextEncoder params -> transformers CLIPTextModel numpy state dict."""
    pre = "text_model"
    d = cfg.hidden_size
    sd = {f"{pre}.embeddings.token_embedding.weight":
          _np(params["token_embedding"]["embedding"]),
          f"{pre}.embeddings.position_embedding.weight":
          _np(params["position_embedding"])}
    _emit(sd, f"{pre}.final_layer_norm", _norm(params["final_layer_norm"]))
    for i in range(cfg.num_layers):
        lp, p = f"{pre}.encoder.layers.{i}", params[f"layers_{i}"]
        _emit(sd, f"{lp}.layer_norm1", _norm(p["layer_norm1"]))
        _emit(sd, f"{lp}.layer_norm2", _norm(p["layer_norm2"]))
        attn = p["self_attn"]
        for flax_name, name in (("query", "q_proj"), ("key", "k_proj"),
                                ("value", "v_proj")):
            sd[f"{lp}.self_attn.{name}.weight"] = np.ascontiguousarray(
                _np(attn[flax_name]["kernel"]).reshape(d, d).T)
            sd[f"{lp}.self_attn.{name}.bias"] = _np(
                attn[flax_name]["bias"]).reshape(d)
        sd[f"{lp}.self_attn.out_proj.weight"] = np.ascontiguousarray(
            _np(attn["out"]["kernel"]).reshape(d, d).T)
        sd[f"{lp}.self_attn.out_proj.bias"] = _np(attn["out"]["bias"])
        _emit(sd, f"{lp}.mlp.fc1", _linear(p["mlp"]["fc1"]))
        sd[f"{lp}.mlp.fc2.weight"] = np.ascontiguousarray(
            _np(p["mlp"]["fc2_kernel"]).T)
        sd[f"{lp}.mlp.fc2.bias"] = _np(p["mlp"]["fc2_bias"])
    return sd


def to_torch(sd: dict) -> dict[str, torch.Tensor]:
    """numpy state dict -> f32 torch tensors (load_state_dict casts them)."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def pipeline_state_dicts(params: dict, config) -> dict[str, dict]:
    """A JAX pipeline's params {"unet", "text_encoder", "vae"} -> the port's
    state dicts, as `StableDiffusionPipeline.load_state_dicts` takes them."""
    return {
        "unet": to_torch(unet_numpy_state_dict(params["unet"], config.unet)),
        "text_encoder": to_torch(clip_text_numpy_state_dict(
            params["text_encoder"], config.text_encoder)),
        "vae": to_torch(vae_decoder_numpy_state_dict(params["vae"],
                                                     config.vae)),
    }
