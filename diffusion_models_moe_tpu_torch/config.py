"""Typed model/pipeline configuration (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/config.py`: the same frozen
dataclasses and presets, with the compute dtype held as a `torch.dtype`.
Only the fields the text-to-image slice reads are kept: SD1.x and SD2.x
geometry, every scheduler of the JAX package, v-prediction and LCM's
guidance embedding (`UNetConfig.time_cond_proj_dim`). Options of the JAX
package that steer TPU layouts, training or other model families (flash
switch, fused routing, remat, SDXL add-embeds) have no counterpart here.

Serving modes, all off by default. The exact-tier modes that the JAX package
switches with environment variables at trace time (DMOE_ATTN_ABSORB,
DMOE_CONV_CHAIN) are the `UNetConfig` fields `attn_absorb` and `conv_chain`.
The opt-in modes are `conv_winograd`, `winograd_tile` and `quant_int8` on
`UNetConfig` and `VAEConfig` (DMOE_WINO_FUSED and DMOE_WINO_TILE are the
values `"fused"` and the tile field) and `PipelineConfig.deep_cache_interval`.
Precedence as in the JAX package: Winograd or int8 switch the conv chain
off, int8 switches the attention absorb and the fused FF kernel off, and
with both Winograd takes the stride-1 3x3 convs and int8 the rest. This
package reads no environment variable.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch


def check_winograd(conv_winograd: str, winograd_tile: int) -> None:
    if conv_winograd not in ("0", "1", "fused"):
        raise ValueError(f"conv_winograd={conv_winograd!r}: one of '0', '1', "
                         "'fused'")
    if winograd_tile not in (2, 4):
        raise ValueError(f"winograd_tile={winograd_tile!r}: 2 or 4")


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD-style UNet2DCondition configuration ("cross" blocks carry
    transformer blocks, "plain" blocks only resnets)."""
    sample_channels: int = 4
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    down_block_types: Sequence[str] = ("cross", "cross", "cross", "plain")
    up_block_types: Sequence[str] = ("plain", "cross", "cross", "cross")
    layers_per_block: int = 2
    transformer_layers_per_block: Any = 1
    cross_attention_dim: int = 768
    # number of attention heads (SD1.x: 8), one int or one per block
    attention_head_dim: Any = 8
    norm_num_groups: int = 32
    ff_mult: int = 4
    ff_activation: str = "geglu"         # "geglu" | "geglu-relu"
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    # LCM guidance-scale embedding width (0: none; LCM checkpoints use 256)
    time_cond_proj_dim: int = 0
    dtype: torch.dtype = torch.float32
    # absorbed self-attention sub-block (ops/attn_absorb_fused.py): "0" off,
    # "1" both kernels, "qkv" the LN+qkv prologue only, "out" the
    # out-projection+residual epilogue only
    attn_absorb: str = "0"
    # resblock convs through the fused GN+SiLU -> conv -> bias -> residual
    # kernel (ops/conv_chain_fused.py) wherever `chain_ok` admits the shape
    conv_chain: bool = False
    # stride-1 3x3 convs as Winograd: "0" off, "1" the batched-product
    # formulation of ops/winograd.py at `winograd_tile` (2 or 4), "fused" the
    # F(2x2, 3x3) kernel (ops/winograd_fused.py) wherever `fused_ok` admits
    # the shape and the direct conv elsewhere
    conv_winograd: str = "0"
    winograd_tile: int = 2
    # W8A8 int8 dots and convs (ops/quant.py)
    quant_int8: bool = False

    def __post_init__(self):
        if self.attn_absorb not in ("0", "1", "qkv", "out"):
            raise ValueError(f"attn_absorb={self.attn_absorb!r}: one of "
                             "'0', '1', 'qkv', 'out'")
        check_winograd(self.conv_winograd, self.winograd_tile)

    def depth_for_block(self, block_idx: int) -> int:
        d = self.transformer_layers_per_block
        return d if isinstance(d, int) else d[block_idx]

    def heads_for_block(self, block_idx: int) -> int:
        h = self.attention_head_dim
        return h if isinstance(h, int) else h[block_idx]

    @property
    def n_ff_layers(self) -> int:
        return len(self.ff_dims())

    def ff_dims(self) -> list[int]:
        """Model dim of each GEGLU FF layer in canonical (execution) order:
        down blocks outer to inner, mid, up blocks inner to outer."""
        dims = []
        for i, kind in enumerate(self.down_block_types):
            if kind == "cross":
                dims += ([self.block_out_channels[i]]
                         * self.layers_per_block * self.depth_for_block(i))
        n_blocks = len(self.block_out_channels)
        dims += [self.block_out_channels[-1]] * self.depth_for_block(n_blocks - 1)
        rev_ch = list(reversed(self.block_out_channels))
        rev_idx = list(range(n_blocks))[::-1]
        for i, kind in enumerate(self.up_block_types):
            if kind == "cross":
                dims += ([rev_ch[i]] * (self.layers_per_block + 1)
                         * self.depth_for_block(rev_idx[i]))
        return dims


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.float32
    # the decoder's serving modes, as on UNetConfig
    conv_winograd: str = "0"
    winograd_tile: int = 2
    quant_int8: bool = False

    def __post_init__(self):
        check_winograd(self.conv_winograd, self.winograd_tile)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    unet: UNetConfig = UNetConfig()
    text_encoder: CLIPTextConfig = CLIPTextConfig()
    vae: VAEConfig = VAEConfig()
    sample_size: int = 64                # latent spatial size (64 -> 512 px)
    guidance_scale: float = 7.5
    num_inference_steps: int = 50
    scheduler: str = "pndm"              # ddim, pndm, euler, dpm or lcm
    prediction_type: str = "epsilon"     # or "v_prediction" (SD2.1-768)
    # DeepCache: > 0 runs the full UNet on every interval-th step and the
    # shallow forward on a cached deep feature between them
    deep_cache_interval: int = 0


_SHARED_MODES = ("conv_winograd", "winograd_tile", "quant_int8")


def _split_modes(modes: dict) -> tuple[dict, dict, dict]:
    """Serving-mode keywords -> (UNet fields, VAE fields, pipeline fields):
    the Winograd and int8 modes go to the UNet and the VAE decoder alike."""
    pipe = {k: modes.pop(k) for k in ("deep_cache_interval",) if k in modes}
    vae = {k: modes[k] for k in _SHARED_MODES if k in modes}
    return modes, vae, pipe


def sd15_config(dtype: torch.dtype = torch.bfloat16, relufied: bool = False,
                **modes) -> PipelineConfig:
    """Stable Diffusion v1.4/1.5 geometry; `relufied` gives the ReLUfied
    model (GEGLU gates through ReLU, as the JAX preset). `modes`: the
    serving modes, `attn_absorb`, `conv_chain`, `conv_winograd`,
    `winograd_tile`, `quant_int8` and `deep_cache_interval`."""
    unet_modes, vae_modes, pipe_modes = _split_modes(modes)
    return PipelineConfig(
        unet=UNetConfig(dtype=dtype,
                        ff_activation="geglu-relu" if relufied else "geglu",
                        **unet_modes),
        text_encoder=CLIPTextConfig(dtype=dtype),
        vae=VAEConfig(dtype=dtype, **vae_modes),
        **pipe_modes,
    )


def sd21_config(dtype: torch.dtype = torch.bfloat16, v_prediction: bool = True,
                **modes) -> PipelineConfig:
    """Stable Diffusion 2.1 geometry: 1024-wide OpenCLIP text conditioning
    (23 layers of exact GELU), 64-dim attention heads, DDIM; v-prediction at
    768 px (96 x 96 latents) or, with `v_prediction=False`, epsilon at 512 px.
    `modes` as in `sd15_config`."""
    unet_modes, vae_modes, pipe_modes = _split_modes(modes)
    return PipelineConfig(
        unet=UNetConfig(cross_attention_dim=1024,
                        attention_head_dim=(5, 10, 20, 20), dtype=dtype,
                        **unet_modes),
        text_encoder=CLIPTextConfig(hidden_size=1024, intermediate_size=4096,
                                    num_layers=23, num_heads=16,
                                    hidden_act="gelu", dtype=dtype),
        vae=VAEConfig(dtype=dtype, **vae_modes),
        sample_size=96 if v_prediction else 64,
        scheduler="ddim",
        prediction_type="v_prediction" if v_prediction else "epsilon",
        **pipe_modes,
    )


def tiny_config(dtype: torch.dtype = torch.float32, **modes) -> PipelineConfig:
    """Tiny model for unit tests: same topology (16 FF layers), small dims.
    `modes` as in `sd15_config`."""
    unet_modes, vae_modes, pipe_modes = _split_modes(modes)
    return PipelineConfig(
        unet=UNetConfig(
            block_out_channels=(32, 64, 128, 128),
            cross_attention_dim=32,
            attention_head_dim=4,
            norm_num_groups=8,
            dtype=dtype,
            **unet_modes,
        ),
        text_encoder=CLIPTextConfig(
            vocab_size=1000, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, max_length=16, dtype=dtype,
        ),
        vae=VAEConfig(block_out_channels=(32, 32, 64, 64), norm_num_groups=8,
                      layers_per_block=1, dtype=dtype, **vae_modes),
        sample_size=8,
        num_inference_steps=4,
        **pipe_modes,
    )


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises where a CUDA device is asked for and none is present, so
    that nothing falls back to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for and no CUDA device is present; "
            "pass device=\"cpu\" to run on the CPU")
    return dev
