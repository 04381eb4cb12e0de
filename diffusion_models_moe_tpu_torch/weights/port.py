"""Read diffusers-layout Stable Diffusion snapshots and edited checkpoints
into the port's state dicts (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/weights/port.py`. The JAX package
converts torch layouts into Flax trees; the port's modules already carry the
diffusers and transformers key names, so here a snapshot is read, filtered
and renamed where old checkpoints differ, and handed to
`StableDiffusionPipeline.load_state_dicts`:

* `unet/diffusion_pytorch_model.safetensors`: Transformer2D `proj_in` /
  `proj_out` stored as 1x1 convs are squeezed to linears;
* `text_encoder/model.safetensors`: the `text_model.` prefix is added where
  the file lacks it, transformers' `position_ids` buffer is dropped;
* `vae/diffusion_pytorch_model.safetensors`: split into the decoder side
  and the encoder side (`encoder.*`, `quant_conv.*`, read only for the
  training path), and the old mid-block attention names
  `query/key/value/proj_attn`, possibly stored as 1x1 convs, become
  `to_q/to_k/to_v/to_out.0`.

An SDXL snapshot (`load_sdxl_snapshot`) adds `text_encoder_2/`, a
transformers `CLIPTextModelWithProjection`: its `text_projection.weight`
becomes the pipeline's `text_projection_2`, the rest the bigG tower.

fp16 tensors are widened to f32; every other dtype is kept as stored
(`load_state_dict` casts into the module's dtype). Files are read by the
port's own safetensors reader (`weights/_safetensors.py`).
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch

from diffusion_models_moe_tpu_torch.config import ADD_TIME_IDS, UNetConfig
from diffusion_models_moe_tpu_torch.weights import _safetensors

StateDict = dict[str, torch.Tensor]

_VAE_ATTN_NAMES = {"query": "to_q", "key": "to_k", "value": "to_v",
                   "proj_attn": "to_out.0"}
_VAE_OLD_ATTN = re.compile(
    r"^(.*\.attentions\.\d+)\.(query|key|value|proj_attn)\.(weight|bias)$")
_VAE_ATTN_WEIGHT = re.compile(r"^.*\.attentions\.\d+\.to_(q|k|v|out\.0)\.weight$")


def _widen(sd: StateDict) -> StateDict:
    return {k: v.float() if v.dtype == torch.float16 else v
            for k, v in sd.items()}


def load_safetensors(path: str) -> StateDict:
    """All tensors of a safetensors file, on the CPU, in their stored
    dtypes."""
    return _safetensors.read(path)


def _squeeze_proj(sd: StateDict) -> StateDict:
    """Old-layout checkpoints store Transformer2D proj_in/out as 1x1 convs;
    squeeze them to linears."""
    return {k: (v[:, :, 0, 0] if ("proj_in.weight" in k
                                  or "proj_out.weight" in k) and v.dim() == 4
                else v)
            for k, v in sd.items()}


def unet_state_dict(sd: StateDict) -> StateDict:
    """A flat diffusers UNet state dict -> the port UNet's: 1x1-conv
    projections squeezed, fp16 widened."""
    return _widen(_squeeze_proj(sd))


def load_unet_state_dict(snapshot_dir: str,
                         overlay: Optional[StateDict] = None) -> StateDict:
    """`{snapshot_dir}/diffusion_pytorch_model.safetensors` -> the port
    UNet's state dict. `overlay` is a partial UNet state dict put over the
    snapshot's tensors first (the Concept-Ablation delta format:
    `load_delta_bin(path)["unet"]` over the stock checkpoint)."""
    sd = load_safetensors(os.path.join(snapshot_dir,
                                       "diffusion_pytorch_model.safetensors"))
    if overlay:
        sd.update(overlay)
    return unet_state_dict(sd)


def clip_text_state_dict(sd: StateDict) -> StateDict:
    """A flat transformers CLIPTextModel state dict, with or without the
    `text_model.` prefix (the Concept-Ablation delta carries it bare) -> the
    port's, without the `position_ids` buffer."""
    pre = "" if any(k.startswith("text_model.") for k in sd) else "text_model."
    return _widen({pre + k: v for k, v in sd.items()
                   if not k.endswith("embeddings.position_ids")})


def load_clip_text_state_dict(snapshot_dir: str) -> StateDict:
    """`{snapshot_dir}/model.safetensors` -> the port's CLIP text encoder
    state dict."""
    return clip_text_state_dict(load_safetensors(
        os.path.join(snapshot_dir, "model.safetensors")))


_VAE_ENCODER_SIDE = ("encoder.", "quant_conv.")


def vae_decoder_state_dict(sd: StateDict) -> StateDict:
    """A flat diffusers AutoencoderKL state dict -> the port's VAE decoder
    state dict: the encoder side dropped, old attention names mapped and
    their 1x1 convs squeezed."""
    return _vae_side(sd, encoder=False)


def vae_encoder_state_dict(sd: StateDict) -> StateDict:
    """A flat diffusers AutoencoderKL state dict -> the port's `VAEEncoder`
    state dict (`encoder.*`, `quant_conv.*`, the decoder side dropped), old
    attention names mapped as for the decoder."""
    return _vae_side(sd, encoder=True)


def _vae_side(sd: StateDict, encoder: bool) -> StateDict:
    out = {}
    for k, v in sd.items():
        if k.startswith(_VAE_ENCODER_SIDE) != encoder:
            continue
        m = _VAE_OLD_ATTN.match(k)
        if m:
            k = f"{m[1]}.{_VAE_ATTN_NAMES[m[2]]}.{m[3]}"
        if _VAE_ATTN_WEIGHT.match(k) and v.dim() == 4:
            v = v[:, :, 0, 0]
        out[k] = v
    return _widen(out)


def load_vae_decoder_state_dict(snapshot_dir: str) -> StateDict:
    """`{snapshot_dir}/diffusion_pytorch_model.safetensors` -> the port's
    VAE decoder state dict."""
    return vae_decoder_state_dict(load_safetensors(
        os.path.join(snapshot_dir, "diffusion_pytorch_model.safetensors")))


def load_vae_encoder_state_dict(snapshot_dir: str) -> StateDict:
    """`{snapshot_dir}/diffusion_pytorch_model.safetensors` -> the port's
    VAE encoder state dict (the JAX package's `port_vae_encoder`)."""
    return vae_encoder_state_dict(load_safetensors(
        os.path.join(snapshot_dir, "diffusion_pytorch_model.safetensors")))


def _unet_shape_checks(sd: StateDict, cfg: UNetConfig) -> dict:
    """Sentinel shapes that tell SD1.x, SD2.x and SDXL apart (their key
    names are the same): {check: {"got", "expected"}} for those `sd` has."""
    checks = {}
    k = "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight"
    if k in sd:
        checks["cross_attention_dim"] = {
            "got": int(sd[k].shape[1]), "expected": cfg.cross_attention_dim}
    if "conv_in.weight" in sd:
        checks["sample_channels"] = {
            "got": int(sd["conv_in.weight"].shape[1]),
            "expected": cfg.sample_channels}
        checks["block_out_channels[0]"] = {
            "got": int(sd["conv_in.weight"].shape[0]),
            "expected": cfg.block_out_channels[0]}
    return checks


def load_pipeline_snapshot(snapshot_root: str, config,
                           include_vae_encoder: bool = False
                           ) -> dict[str, StateDict]:
    """A diffusers snapshot `{root}/unet`, `{root}/text_encoder`,
    `{root}/vae` -> {"unet", "text_encoder", "vae"} state dicts, as
    `StableDiffusionPipeline.load_state_dicts` takes them;
    `include_vae_encoder=True` adds "vae_encoder", the `VAEEncoder` state
    dict the training loop encodes images with (one read of the VAE file
    serves both sides). Raises ValueError where the UNet's sentinel shapes
    do not fit `config` (an SD2.x or SDXL snapshot for an SD1.x config)."""
    vae_sd = load_safetensors(os.path.join(
        snapshot_root, "vae", "diffusion_pytorch_model.safetensors"))
    out = {
        "unet": load_unet_state_dict(os.path.join(snapshot_root, "unet")),
        "text_encoder": load_clip_text_state_dict(
            os.path.join(snapshot_root, "text_encoder")),
        "vae": vae_decoder_state_dict(vae_sd),
    }
    if include_vae_encoder:
        out["vae_encoder"] = vae_encoder_state_dict(vae_sd)
    _check_unet(snapshot_root, out["unet"], config)
    return out


def load_sdxl_snapshot(snapshot_root: str, config) -> dict[str, StateDict]:
    """An SDXL diffusers snapshot `{root}/unet`, `{root}/text_encoder`,
    `{root}/text_encoder_2` (a `CLIPTextModelWithProjection`), `{root}/vae`
    -> {"unet", "text_encoder", "text_encoder_2", "text_projection_2",
    "vae"} state dicts, as `SDXLPipeline.load_state_dicts` takes them.
    Raises ValueError where the UNet's sentinel shapes do not fit `config`
    (an SD1.x or SD2.x snapshot for an SDXL config)."""
    te2 = os.path.join(snapshot_root, "text_encoder_2")
    sd2 = _widen(load_safetensors(os.path.join(te2, "model.safetensors")))
    proj = sd2.pop("text_projection.weight")
    out = {
        "unet": load_unet_state_dict(os.path.join(snapshot_root, "unet")),
        "text_encoder": load_clip_text_state_dict(
            os.path.join(snapshot_root, "text_encoder")),
        "text_encoder_2": clip_text_state_dict(sd2),
        "text_projection_2": {"weight": proj},
        "vae": load_vae_decoder_state_dict(os.path.join(snapshot_root, "vae")),
    }
    _check_unet(snapshot_root, out["unet"], config)
    return out


_CROSS_K = re.compile(
    r"^(down_blocks|mid_block|up_blocks)\.(\d+\.)?attentions\.\d+\."
    r"transformer_blocks\.\d+\.attn2\.to_k\.weight$")


def _check_unet(snapshot_root: str, sd: StateDict, config) -> None:
    """Raises ValueError where a snapshot's UNet does not fit `config`: the
    sentinel shapes of `_unet_shape_checks`, the context width read off the
    first cross-attention key (SDXL's down block 0 has none), and the input
    width of the added conditioning (0 where there is no
    `add_embedding`)."""
    cfg = config.unet
    checks = _unet_shape_checks(sd, cfg)
    k = next((name for name in sd if _CROSS_K.match(name)), None)
    if k is not None:
        checks["cross_attention_dim"] = {
            "got": int(sd[k].shape[1]), "expected": cfg.cross_attention_dim}
    add = sd.get("add_embedding.linear_1.weight")
    checks["add_embedding_in"] = {
        "got": 0 if add is None else int(add.shape[1]),
        "expected": (cfg.addition_embed_dim
                     + ADD_TIME_IDS * cfg.addition_time_embed_dim
                     if cfg.addition_embed_dim > 0 else 0)}
    bad = {k: c for k, c in checks.items() if c["got"] != c["expected"]}
    if bad:
        raise ValueError(f"{snapshot_root}: the UNet does not fit the "
                         f"config: {bad}")


def load_edited_unet_state_dict(path: str) -> StateDict:
    """A published edited-UNet checkpoint -> a flat UNet state dict. Takes
    the two containers the baselines publish: torch-pickled `.pt`/`.bin`
    (a state dict, a module, or a `{"state_dict": ...}` wrapper) and
    `.safetensors`. fp16 widens to f32, a uniform `unet.` key prefix is
    stripped; keys are otherwise as stored (use `unet_state_dict` before
    `load_state_dict` for old 1x1-conv projections)."""
    if path.endswith(".safetensors"):
        sd = load_safetensors(path)
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(obj, "state_dict"):
            obj = obj.state_dict()
        if not isinstance(obj, dict):
            raise ValueError(f"{path}: expected a state dict, got "
                             f"{type(obj).__name__}")
        if "state_dict" in obj and isinstance(obj["state_dict"], dict):
            obj = obj["state_dict"]
        sd = {k: torch.as_tensor(v).to(torch.float32) for k, v in obj.items()}
    sd = _widen(sd)
    if sd and all(k.startswith("unet.") for k in sd):
        sd = {k[len("unet."):]: v for k, v in sd.items()}
    return sd


def load_delta_bin(path: str) -> dict[str, StateDict]:
    """A Concept-Ablation delta.bin -> {"unet": a PARTIAL UNet state dict,
    "text_encoder": a whole CLIPTextModel state dict}, whichever it has,
    in f32."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict) or not ({"unet", "text_encoder"} & set(obj)):
        raise ValueError(f"{path}: expected a delta bundle with 'unet' "
                         "and/or 'text_encoder' sub-dicts")
    return {part: {k: torch.as_tensor(v).float() for k, v in obj[part].items()}
            for part in ("unet", "text_encoder") if part in obj}


def validate_edited_unet(path: str, cfg: UNetConfig,
                         expected_keys: Optional[set[str]] = None) -> dict:
    """Census of an edited-UNet checkpoint before a long run: the exact key
    difference against `expected_keys` and the sentinel shape checks that
    tell SD1.x, SD2.x and SDXL apart. Returns a report; raises nothing."""
    report: dict = {"path": path, "present": os.path.exists(path)}
    if not report["present"]:
        return report
    try:
        sd = load_edited_unet_state_dict(path)
    except Exception as e:  # noqa: BLE001 -- a census reports every failure
        report["load_ok"] = False
        report["load_error"] = f"{type(e).__name__}: {str(e)[:200]}"
        return report
    report["load_ok"] = True
    report["n_tensors"] = len(sd)
    if expected_keys is not None:
        got = set(sd)
        report["missing_keys"] = sorted(expected_keys - got)
        report["unexpected_keys"] = sorted(got - expected_keys)
        report["keys_ok"] = not report["missing_keys"]
    checks = _unet_shape_checks(sd, cfg)
    report["shape_checks"] = checks
    report["shapes_ok"] = all(c["got"] == c["expected"]
                              for c in checks.values())
    return report
