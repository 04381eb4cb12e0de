"""Flax parameter trees (numpy) -> the torch port's state dicts.

The inverse of `diffusion_models_moe_tpu/weights/port.py`, written without
importing the JAX package: a params tree from the JAX package's
`init_params` (converted to numpy) becomes the state dicts of the port's
UNet, CLIP text encoder and VAE decoder, so both run the same weights.
Layouts: conv HWIO -> OIHW; Dense (in, out) -> Linear (out, in); Flax
multi-head attention kernels (D, heads, hd) / (heads, hd, D) -> Linear;
the GEGLU FF's `proj/kernel` and `out_proj_kernel` -> `ff.net.0.proj` and
`ff.net.2`. PixArt-alpha's trees (`t5_numpy_state_dict`,
`pixart_numpy_state_dict`, `pixart_pipeline_state_dicts`) become the state
dicts of the port's `T5Encoder` (transformers' `T5EncoderModel` names) and
`PixArtTransformer2D` (diffusers' names; the patch embedding's dense kernel
over (p, p, C) patches -> the stride-p conv `pos_embed.proj`, the position
parameter -> `pos_embed.pos_embed`). The judges' trees
(`clip_vision_numpy_state_dict`, `resnet_numpy_state_dict`,
`sscd_numpy_state_dict`, `alexnet_numpy_state_dict`,
`lpips_numpy_state_dict`, `inception_numpy_state_dict`) become the state
dicts of the port's CLIP vision tower (transformers' names) and backbones
(torchvision's names; batch norm's scale, bias, mean and var -> weight,
bias, running_mean and running_var). The erasure judges' trees
(`yolo_numpy_state_dict`, `llama_numpy_state_dict`,
`llava_numpy_state_dict`) become the state dicts of the port's `YOLOv8`
(ultralytics' names, fused convs, the DFL arange), `LlamaModel`
(transformers' `LlamaForCausalLM` names) and
`LlavaForConditionalGeneration` (llava-hf names; its tower without the
projection head).
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
    if "add_embedding" in params:       # SDXL's added conditioning
        for name in ("linear_1", "linear_2"):
            _emit(sd, f"add_embedding.{name}",
                  _linear(params["add_embedding"][name]))
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


def pipeline_state_dicts(params: dict, config,
                         text_configs: tuple = None) -> dict[str, dict]:
    """A JAX pipeline's params {"unet", "text_encoder", "vae"} -> the port's
    state dicts, as `StableDiffusionPipeline.load_state_dicts` takes them.
    An SDXL pipeline's params also have "text_encoder_2" and
    "text_projection_2" ((hidden, projection), applied as `pooled @ P`):
    they become the bigG tower's state dict and the projection's
    `{"weight": P.T}` (transformers' `text_projection.weight`), as
    `SDXLPipeline.load_state_dicts` takes them. `text_configs`: the two
    towers' configs (default: `config.text_encoder` for the first; the
    second is needed where "text_encoder_2" is present)."""
    tc1 = text_configs[0] if text_configs else config.text_encoder
    out = {
        "unet": to_torch(unet_numpy_state_dict(params["unet"], config.unet)),
        "text_encoder": to_torch(clip_text_numpy_state_dict(
            params["text_encoder"], tc1)),
        "vae": to_torch(vae_decoder_numpy_state_dict(params["vae"],
                                                     config.vae)),
    }
    if "text_encoder_2" in params:
        out["text_encoder_2"] = to_torch(clip_text_numpy_state_dict(
            params["text_encoder_2"], text_configs[1]))
        out["text_projection_2"] = to_torch(
            {"weight": np.ascontiguousarray(_np(params["text_projection_2"]).T)})
    return out


def t5_numpy_state_dict(params: dict, cfg) -> dict:
    """T5Encoder params -> transformers T5EncoderModel numpy state dict."""
    sd = {"shared.weight": _np(params["token_embedding"]),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias"
          ".weight": _np(params["relative_attention_bias"]),
          "encoder.final_layer_norm.weight": _np(
              params["final_norm"]["weight"])}
    for i in range(cfg.num_layers):
        p, pre = params[f"block_{i}"], f"encoder.block.{i}.layer"
        sd[f"{pre}.0.layer_norm.weight"] = _np(p["attn_norm"]["weight"])
        sd[f"{pre}.1.layer_norm.weight"] = _np(p["ff_norm"]["weight"])
        for name in ("q", "k", "v", "o"):
            _emit(sd, f"{pre}.0.SelfAttention.{name}",
                  _linear(p["attn"][name], use_bias=False))
        for name in ("wi_0", "wi_1", "wo"):
            _emit(sd, f"{pre}.1.DenseReluDense.{name}",
                  _linear(p[name], use_bias=False))
    return sd


def pixart_numpy_state_dict(params: dict, cfg) -> dict:
    """PixArtTransformer2D params -> diffusers PixArtTransformer2DModel
    numpy state dict, with the port's `pos_embed.pos_embed` (1, S, D)."""
    p, d = cfg.patch_size, cfg.hidden_size
    k = _np(params["patch_embed"]["kernel"]).reshape(p, p, cfg.sample_channels, d)
    sd = {"pos_embed.proj.weight": np.ascontiguousarray(
              np.transpose(k, (3, 2, 0, 1))),
          "pos_embed.proj.bias": _np(params["patch_embed"]["bias"]),
          "pos_embed.pos_embed": _np(params["pos_embed"])[None],
          "scale_shift_table": _np(params["final_scale_shift"])}
    te = "adaln_single.emb.timestep_embedder"
    for name in ("linear_1", "linear_2"):
        _emit(sd, f"{te}.{name}", _linear(params["time_embedding"][name]))
        if f"caption_{name}" in params:
            _emit(sd, f"caption_projection.{name}",
                  _linear(params[f"caption_{name}"]))
    _emit(sd, "adaln_single.linear", _linear(params["adaln_single"]))
    _emit(sd, "proj_out", _linear(params["proj_out"]))
    for i in range(cfg.num_layers):
        blk, pre = params[f"blocks_{i}"], f"transformer_blocks.{i}"
        sd[f"{pre}.scale_shift_table"] = _np(blk["scale_shift_table"])
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                _emit(sd, f"{pre}.{attn}.{proj}", _linear(blk[attn][proj]))
            _emit(sd, f"{pre}.{attn}.to_out.0", _linear(blk[attn]["to_out"]))
        ff = blk["ff"]
        _emit(sd, f"{pre}.ff.net.0.proj", _linear(ff["proj"]))
        sd[f"{pre}.ff.net.2.weight"] = np.ascontiguousarray(
            _np(ff["out_proj_kernel"]).T)
        sd[f"{pre}.ff.net.2.bias"] = _np(ff["out_proj_bias"])
    return sd


def pixart_pipeline_state_dicts(params: dict, config) -> dict[str, dict]:
    """A JAX PixArt pipeline's params {"transformer", "text_encoder", "vae"}
    -> the port's state dicts, as `PixArtPipeline.load_state_dicts` takes
    them."""
    return {
        "transformer": to_torch(pixart_numpy_state_dict(
            params["transformer"], config.transformer)),
        "text_encoder": to_torch(t5_numpy_state_dict(
            params["text_encoder"], config.text_encoder)),
        "vae": to_torch(vae_decoder_numpy_state_dict(params["vae"],
                                                     config.vae)),
    }


# ------------------------------------------------------------------ judges
def clip_vision_numpy_state_dict(params: dict, cfg) -> dict:
    """CLIPVisionEncoder params -> the port's `CLIPVisionEncoder` numpy
    state dict (transformers' `CLIPVisionModelWithProjection` names)."""
    pre, d = "vision_model", cfg.hidden_size
    sd = {f"{pre}.embeddings.class_embedding": _np(params["class_embedding"]),
          f"{pre}.embeddings.patch_embedding.weight": np.ascontiguousarray(
              np.transpose(_np(params["patch_embedding"]["kernel"]),
                           (3, 2, 0, 1))),
          f"{pre}.embeddings.position_embedding.weight":
              _np(params["position_embedding"])}
    # LLaVA's tower (JAX `port_vision_tower`) has no projection and may lack
    # the post-layernorm and its last layers
    if "visual_projection" in params:
        sd["visual_projection.weight"] = np.ascontiguousarray(
            _np(params["visual_projection"]["kernel"]).T)
    _emit(sd, f"{pre}.pre_layrnorm", _norm(params["pre_layernorm"]))
    if "post_layernorm" in params:
        _emit(sd, f"{pre}.post_layernorm", _norm(params["post_layernorm"]))
    for i in range(cfg.num_layers):
        if f"layers_{i}" not in params:
            break
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
        _emit(sd, f"{lp}.mlp.fc1", _linear(p["fc1"]))
        _emit(sd, f"{lp}.mlp.fc2", _linear(p["fc2"]))
    return sd


def _tv_conv(p: dict) -> dict:
    """A judge conv {kernel HWIO[, bias]} -> torchvision {weight OIHW[, bias]}."""
    out = {"weight": np.ascontiguousarray(np.transpose(_np(p["kernel"]),
                                                       (3, 2, 0, 1)))}
    if "bias" in p:
        out["bias"] = _np(p["bias"])
    return out


def _tv_bn(p: dict) -> dict:
    return {"weight": _np(p["scale"]), "bias": _np(p["bias"]),
            "running_mean": _np(p["mean"]), "running_var": _np(p["var"])}


def resnet_numpy_state_dict(params: dict, cfg) -> dict:
    """backbones.resnet_* params -> torchvision ResNet names (the port's
    `ResNet`; `fc` where the params have one)."""
    sd: dict = {}
    _emit(sd, "conv1", _tv_conv(params["conv1"]))
    _emit(sd, "bn1", _tv_bn(params["bn1"]))
    for si, n_blocks in enumerate(cfg.stage_blocks):
        for bi in range(n_blocks):
            p, pre = params[f"layer{si + 1}_{bi}"], f"layer{si + 1}.{bi}"
            for ci in (1, 2, 3):
                _emit(sd, f"{pre}.conv{ci}", _tv_conv(p[f"conv{ci}"]))
                _emit(sd, f"{pre}.bn{ci}", _tv_bn(p[f"bn{ci}"]))
            if "downsample" in p:
                _emit(sd, f"{pre}.downsample.0", _tv_conv(p["downsample"]["conv"]))
                _emit(sd, f"{pre}.downsample.1", _tv_bn(p["downsample"]["bn"]))
    if "fc" in params:
        _emit(sd, "fc", _linear(params["fc"]))
    return sd


def sscd_numpy_state_dict(params: dict, cfg) -> dict:
    """backbones.sscd_embed params -> the port's `SSCD` names
    (`backbone.*`, `embeddings.weight` and its bias)."""
    sd = {f"backbone.{k}": v for k, v in
          resnet_numpy_state_dict(params, cfg).items() if not k.startswith("fc.")}
    _emit(sd, "embeddings", _linear(params["embeddings"]))
    return sd


def alexnet_numpy_state_dict(params: dict) -> dict:
    """backbones.alexnet_features params -> torchvision AlexNet names."""
    from diffusion_models_moe_tpu_torch.models.backbones import \
        ALEX_FEATURE_IDX
    sd: dict = {}
    for i, idx in enumerate(ALEX_FEATURE_IDX):
        _emit(sd, f"features.{idx}", _tv_conv(params[f"conv{i}"]))
    return sd


def lpips_numpy_state_dict(params: dict) -> dict:
    """backbones.lpips_distance params -> the port's `LPIPS` names."""
    sd = {f"net.{k}": v for k, v in
          alexnet_numpy_state_dict(params["net"]).items()}
    for i, w in enumerate(params["lins"]):
        sd[f"lins.{i}"] = _np(w)
    return sd


def inception_numpy_state_dict(params: dict, prefix: str = "") -> dict:
    """models/inception.py params -> torchvision Inception3 names (the
    port's `InceptionV3`)."""
    sd: dict = {}
    for name, p in params.items():
        if name == "fc" and not prefix:
            _emit(sd, "fc", _linear(p))
        elif "conv" in p and "bn" in p:
            _emit(sd, f"{prefix}{name}.conv", _tv_conv(p["conv"]))
            _emit(sd, f"{prefix}{name}.bn", _tv_bn(p["bn"]))
        else:
            sd.update(inception_numpy_state_dict(p, f"{prefix}{name}."))
    return sd


def yolo_numpy_state_dict(params: dict) -> dict:
    """models/yolo.py params (fused convs {kernel HWIO, bias}) -> the port's
    `YOLOv8` state dict (ultralytics names, the DFL arange included)."""
    sd: dict = {}
    for idx, p in params["layers"].items():
        if "kernel" in p:                               # a plain Conv module
            _emit(sd, f"model.{idx}.conv", _tv_conv(p))
            continue
        for part, q in p.items():                       # C2f / SPPF
            if part == "m":
                for j, blk in enumerate(q):
                    for name in ("cv1", "cv2"):
                        _emit(sd, f"model.{idx}.m.{j}.{name}.conv",
                              _tv_conv(blk[name]))
            else:
                _emit(sd, f"model.{idx}.{part}.conv", _tv_conv(q))
    for branch in ("cv2", "cv3"):
        for i, convs in enumerate(params["detect"][branch]):
            for j, p in enumerate(convs):
                _emit(sd, f"model.22.{branch}.{i}.{j}"
                      + ("" if j == 2 else ".conv"), _tv_conv(p))
    reg_max = _np(params["detect"]["cv2"][0][2]["kernel"]).shape[-1] // 4
    sd["model.22.dfl.conv.weight"] = np.arange(
        reg_max, dtype=np.float32).reshape(1, reg_max, 1, 1)
    return sd


def llama_numpy_state_dict(params: dict, cfg) -> dict:
    """models/llama.py params (with `embed_tokens`) -> the port's
    `LlamaModel` state dict (transformers' `LlamaForCausalLM` names)."""
    sd = {"model.embed_tokens.weight": _np(params["embed_tokens"]),
          "model.norm.weight": _np(params["norm"]["weight"]),
          "lm_head.weight": np.ascontiguousarray(
              _np(params["lm_head"]["kernel"]).T)}
    for i in range(cfg.num_layers):
        lp, p = f"model.layers.{i}", params[f"layers_{i}"]
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{lp}.{norm}.weight"] = _np(p[norm]["weight"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _emit(sd, f"{lp}.self_attn.{name}", _linear(p["self_attn"][name]))
        for name in ("gate_proj", "up_proj", "down_proj"):
            _emit(sd, f"{lp}.mlp.{name}", _linear(p[name]))
    return sd


def llava_numpy_state_dict(params: dict, cfg) -> dict:
    """models/llava.py params ({vision, projector, language}) -> the port's
    `LlavaForConditionalGeneration` state dict (llava-hf names)."""
    sd = {f"vision_tower.{k}": v for k, v in
          clip_vision_numpy_state_dict(params["vision"], cfg.vision).items()}
    for i in (1, 2):
        _emit(sd, f"multi_modal_projector.linear_{i}",
              _linear(params["projector"][f"linear_{i}"]))
    for k, v in llama_numpy_state_dict(params["language"], cfg.text).items():
        sd[f"language_model.{k}"] = v
    return sd
