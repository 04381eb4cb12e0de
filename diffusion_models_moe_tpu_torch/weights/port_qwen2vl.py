"""HF Qwen2-VL checkpoints into the port's Qwen2-VL judge (PyTorch port of
`diffusion_models_moe_tpu/weights/port_qwen2vl.py`).

The port's `Qwen2VLForConditionalGeneration` carries transformers' names,
so the JAX package's transposes become key mappings:

  * both transformers layouts are read: published snapshots'
    `visual.* / model.* / lm_head`, and the `model.visual.* /
    model.language_model.* / lm_head` nesting that transformers >= 4.52
    saves;
  * the tower's tensors keep their names under `visual.` (the patch
    embedding stays the Conv3d weight the tower multiplies by), blocks past
    `depth` are dropped;
  * the LM goes through `port_llava.port_llama_state` (Qwen2 = Llama with
    q/k/v biases; the 2B's tied embeddings become `lm_head`);
  * `port_qwen2vl(snapshot_dir, cfg)` reads `model.safetensors` or the
    shards of `model.safetensors.index.json` with the port's own reader
    (`port_llava.load_snapshot_state`).

f16 and bf16 tensors are widened to f32. Reference: the Qwen judge path,
modularity/qwen_score.py:15-45.
"""
from __future__ import annotations

from diffusion_models_moe_tpu_torch.models.llama import LlamaConfig
from diffusion_models_moe_tpu_torch.models.qwen2vl import (Qwen2VisionConfig,
                                                           Qwen2VLConfig)
from diffusion_models_moe_tpu_torch.weights.port_llava import (
    StateDict, _f32, load_snapshot_state, port_llama_state)


def _normalize_keys(sd: dict) -> dict:
    """The nested layout -> the published one."""
    if not any(k.startswith("model.visual.") for k in sd):
        return sd
    out = {}
    for k, v in sd.items():
        if k.startswith("model.visual."):
            k = k[len("model."):]
        elif k.startswith("model.language_model."):
            k = "model." + k[len("model.language_model."):]
        out[k] = v
    return out


def port_qwen2_vision_state(sd: dict, cfg: Qwen2VisionConfig,
                            prefix: str = "visual.") -> StateDict:
    """`{prefix}*` tensors -> `Qwen2VisionTower(cfg)`'s state dict."""
    out = {}
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        name = k[len(prefix):]
        if name.startswith("blocks.") and int(name.split(".")[1]) >= cfg.depth:
            continue
        out[name] = _f32(v)
    return out


def port_qwen2vl_state(sd: dict, cfg: Qwen2VLConfig) -> StateDict:
    """A Qwen2VLForConditionalGeneration state dict (either layout) ->
    `Qwen2VLForConditionalGeneration(cfg)`'s."""
    sd = _normalize_keys(sd)
    out = {f"visual.{k}": v
           for k, v in port_qwen2_vision_state(sd, cfg.vision).items()}
    for k, v in port_llama_state(sd, cfg.text).items():
        out[f"language_model.{k}"] = v
    return out


def port_qwen2vl(snapshot_dir: str, cfg: Qwen2VLConfig | None = None
                 ) -> StateDict:
    return port_qwen2vl_state(load_snapshot_state(snapshot_dir),
                              cfg or Qwen2VLConfig())


def qwen2vl_2b_config() -> Qwen2VLConfig:
    """Qwen/Qwen2-VL-2B-Instruct geometry (tied embeddings)."""
    return Qwen2VLConfig(
        vision=Qwen2VisionConfig(hidden_size=1536),
        text=LlamaConfig(vocab_size=151936, hidden_size=1536,
                         intermediate_size=8960, num_layers=28, num_heads=12,
                         num_kv_heads=2, rope_theta=1e6, rms_eps=1e-6,
                         attention_bias=True, mrope_section=(16, 24, 24)))


def qwen2vl_7b_config() -> Qwen2VLConfig:
    """Qwen/Qwen2-VL-7B-Instruct geometry."""
    return Qwen2VLConfig()
