"""A tiny cell on the CPU: the port's `tiny_config` geometry in float32 as
a configuration dict, with the harness's own loaders and generators."""
from __future__ import annotations

import copy
import types

from bench_h100.harness import loader, sd_family

TINY = {
    "name": "tiny", "pipeline": "sd", "dtype": "float32",
    "unet": {"in_channels": 4, "out_channels": 4,
             "block_out_channels": [32, 64, 128, 128],
             "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
             "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3,
             "layers_per_block": 2, "transformer_layers_per_block": 1,
             "cross_attention_dim": 32, "attention_heads": 4,
             "norm_num_groups": 8, "ff_mult": 4, "flip_sin_to_cos": True,
             "freq_shift": 0, "addition_embed_dim": 0,
             "addition_time_embed_dim": 0},
    "text_encoders": [{"vocab_size": 1000, "hidden_size": 32,
                       "intermediate_size": 64, "num_layers": 2,
                       "num_heads": 4, "max_length": 16,
                       "layer_norm_eps": 1e-05, "hidden_act": "quick_gelu"}],
    "vae": {"latent_channels": 4, "out_channels": 3,
            "block_out_channels": [32, 32, 64, 64], "layers_per_block": 1,
            "norm_num_groups": 8, "scaling_factor": 0.18215},
    "sample_size": 8,
    "scheduler": {"name": "pndm", "num_train_timesteps": 1000,
                  "beta_start": 0.00085, "beta_end": 0.012,
                  "beta_schedule": "scaled_linear", "steps_offset": 1},
    "num_inference_steps": 4, "guidance_scale": 7.5,
    "moe": {"expert_size": 20, "topk_ratio": 0.3},
}


def _tiny_xl(dtype, **modes):
    """The port's tiny geometry as SDXL: three levels, added conditioning,
    two 32-wide towers (the second exact GELU), Euler."""
    import dataclasses

    import diffusion_models_moe_tpu_torch as port
    base = port.tiny_config(dtype, **modes)
    u = TINY_XL["unet"]
    unet = dataclasses.replace(
        base.unet, block_out_channels=tuple(u["block_out_channels"]),
        down_block_types=("plain", "cross", "cross"),
        up_block_types=("cross", "cross", "plain"),
        transformer_layers_per_block=(0, 1, 2),
        cross_attention_dim=u["cross_attention_dim"],
        attention_head_dim=tuple(u["attention_heads"]),
        addition_embed_dim=u["addition_embed_dim"],
        addition_time_embed_dim=u["addition_time_embed_dim"])
    text = base.text_encoder
    return (dataclasses.replace(base, unet=unet, scheduler="euler"),
            (text, dataclasses.replace(text, hidden_act="gelu")))


TINY_XL = dict(
    TINY, name="tiny-xl", pipeline="sdxl",
    unet=dict(TINY["unet"], block_out_channels=[32, 64, 64],
              down_block_types=["DownBlock2D", "CrossAttnDownBlock2D",
                                "CrossAttnDownBlock2D"],
              up_block_types=["CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                              "UpBlock2D"],
              transformer_layers_per_block=[1, 1, 2], cross_attention_dim=64,
              attention_heads=[2, 2, 4], addition_embed_dim=32,
              addition_time_embed_dim=8),
    text_encoders=[TINY["text_encoders"][0],
                   dict(TINY["text_encoders"][0], hidden_act="gelu")],
    scheduler=dict(TINY["scheduler"], name="euler"))


def _family(preset):
    """configs/<name>.py for a tiny geometry: the SD family's names, the
    program built from `preset`."""
    return types.SimpleNamespace(
        **{n: getattr(sd_family, n) for n in loader.FAMILY if n != "build"},
        build=sd_family.preset_build(preset))


TinyFamily = _family("tiny_config")     # the port's `tiny_config`
TinyXLFamily = _family(_tiny_xl)


def tiny_cell(traffic: str = "gen-b8", mix: dict | None = None,
              limit: float = 0.02, requests: int = 2, config=None):
    real = loader.load_cell({"gen-b8": "sd15-moe.gen-b8",
                             "gen-b4": "sdxl-moe.gen-b4",
                             "serve-poisson": "sd15-moe.serve-poisson"}[traffic])
    xl = (config or TINY)["pipeline"] == "sdxl"
    mix = dict(real.mix, **(mix or {}))
    kind = loader.load_module(loader.BENCH / "traffic" / f"{mix['kind']}.py")
    return loader.Cell(f"tiny.{traffic}", dict(real.entry), copy.deepcopy(config or TINY),
                       TinyXLFamily if xl else TinyFamily, mix, kind,
                       {"requests": requests, "reference_batch": 2,
                        "limits": {"img_rel_l2": limit}},
                       real.metrics)
