"""The Stable Diffusion family (SD1.x and SDXL) as the benchmark runs it:
the names of the configuration-module interface (`harness/loader.py`) for
a UNet configuration: the program built through the port's own entry
points, the reference, the skeleton the weights are made for, the FF
widths, the latent shape, the norms, the counts from shapes and the
controls.

A configuration's `.py` names the port's preset (`PORT_PRESET`) and
re-exports this module's names; `build` checks that the preset, as the
port fills it, equals the configuration file field by field, so the file
holds the configuration as it is run. The VAE's scaling factor, an option
of the port's config, is set from the file.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from bench_h100.harness import counts
from bench_h100.reference.sd_ref import Reference

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_KIND = {"CrossAttnDownBlock2D": "cross", "DownBlock2D": "plain",
         "CrossAttnUpBlock2D": "cross", "UpBlock2D": "plain"}


# the parameters drawn as norms (scale 1 + 0.1 N(0, 1), shift 0.1 N(0, 1))
NORMS = (nn.GroupNorm, nn.LayerNorm)
# the lower-precision controls beside the program: the port's own int8 path
# (W8A8 products and convolutions), the nearest precision below bfloat16
CONTROLS = {"int8": {"quant_int8": True}}


def dtype_of(cfg: dict) -> torch.dtype:
    return _DTYPES[cfg["dtype"]]


def ff_dims(u: dict) -> list:
    """Width C of each GEGLU FF in execution order (down, mid, up)."""
    ch = list(u["block_out_channels"])
    layers = u["transformer_layers_per_block"]
    depth = lambda i: counts.per_block(layers, i)  # noqa: E731
    dims = []
    for i, kind in enumerate(u["down_block_types"]):
        if kind in counts.CROSS:
            dims += [ch[i]] * u["layers_per_block"] * depth(i)
    n = len(ch)
    dims += [ch[-1]] * depth(n - 1)
    for i, kind in enumerate(u["up_block_types"]):
        if kind in counts.CROSS:
            dims += [ch[n - 1 - i]] * (u["layers_per_block"] + 1) * depth(n - 1 - i)
    return dims


def ff_widths(cfg: dict) -> list:
    """Hidden width H = ff_mult * C of each routed FF, in execution order."""
    u = cfg["unet"]
    return [u["ff_mult"] * c for c in ff_dims(u)]


def latent_shape(cfg: dict) -> tuple:
    """(C, s, s) of one request's initial noise."""
    s = cfg["sample_size"]
    return cfg["unet"]["in_channels"], s, s


def ff_work(cfg: dict, shape) -> tuple:
    """(operations, bytes) of one `*.ff` call on input (b, s, c): the
    GEGLU-MoE FF with its LayerNorm and residual."""
    b, s, c = shape
    return counts.ff(b * s, c, cfg["unet"]["ff_mult"], cfg["moe"])


def attn_work(cfg: dict, shape) -> tuple:
    """(operations, bytes) of one `*.attn1` call on input (b, s, c)."""
    return counts.self_attn(*shape)


def skeleton(cfg: dict) -> dict:
    """The parameter groups' modules, on the meta device."""
    return Reference(cfg, device="meta").modules()


def reference(cfg: dict, device) -> Reference:
    return Reference(cfg, device=device)


def _expected(cfg: dict) -> dict:
    """The port's config fields that the configuration file fixes."""
    u, v = cfg["unet"], cfg["vae"]
    t = lambda x: tuple(x) if isinstance(x, list) else x  # noqa: E731
    unet = dict(sample_channels=u["in_channels"], out_channels=u["out_channels"],
                block_out_channels=t(u["block_out_channels"]),
                down_block_types=tuple(_KIND[k] for k in u["down_block_types"]),
                up_block_types=tuple(_KIND[k] for k in u["up_block_types"]),
                layers_per_block=u["layers_per_block"],
                cross_attention_dim=u["cross_attention_dim"],
                attention_head_dim=t(u["attention_heads"]),
                norm_num_groups=u["norm_num_groups"], ff_mult=u["ff_mult"],
                ff_activation="geglu", flip_sin_to_cos=u["flip_sin_to_cos"],
                freq_shift=u["freq_shift"], time_cond_proj_dim=0,
                addition_embed_dim=u["addition_embed_dim"],
                addition_time_embed_dim=u["addition_time_embed_dim"],
                dtype=dtype_of(cfg))
    vae = dict(latent_channels=v["latent_channels"],
               in_channels=v["out_channels"],
               block_out_channels=t(v["block_out_channels"]),
               layers_per_block=v["layers_per_block"],
               norm_num_groups=v["norm_num_groups"],
               scaling_factor=v["scaling_factor"], dtype=dtype_of(cfg))
    pipe = dict(sample_size=cfg["sample_size"],
                guidance_scale=cfg["guidance_scale"],
                num_inference_steps=cfg["num_inference_steps"],
                scheduler=cfg["scheduler"]["name"], prediction_type="epsilon",
                deep_cache_interval=0)
    return {"unet": unet, "vae": vae, "pipe": pipe}


_TEXT = ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
         "num_heads", "max_length", "layer_norm_eps", "hidden_act")


def check_port_config(cfg: dict, pcfg, text_configs) -> None:
    """Raises where the port's config departs from the file."""
    exp = _expected(cfg)
    got = {"unet": pcfg.unet, "vae": pcfg.vae, "pipe": pcfg}
    bad = [f"{part}.{k}: file {want!r}, port {getattr(got[part], k)!r}"
           for part, fields in exp.items() for k, want in fields.items()
           if getattr(got[part], k) != want]
    for j, (tc, t) in enumerate(zip(text_configs, cfg["text_encoders"])):
        bad += [f"text_encoders[{j}].{k}: file {t[k]!r}, port "
                f"{getattr(tc, k)!r}" for k in _TEXT if getattr(tc, k) != t[k]]
        if tc.dtype != dtype_of(cfg):
            bad.append(f"text_encoders[{j}].dtype: {tc.dtype}")
    # a block without transformers reads no depth (SDXL's source states 1
    # for its first block, the port's preset 0)
    u, pu = cfg["unet"], pcfg.unet
    for i, kind in enumerate(u["down_block_types"]):
        want = counts.per_block(u["transformer_layers_per_block"], i)
        if kind in counts.CROSS and pu.depth_for_block(i) != want:
            bad.append(f"unet.transformer_layers_per_block[{i}]: file {want}, "
                       f"port {pu.depth_for_block(i)}")
    if len(text_configs) != len(cfg["text_encoders"]):
        bad.append("number of text towers")
    sched = cfg["scheduler"]
    if (sched["num_train_timesteps"], sched["beta_start"], sched["beta_end"],
            sched["beta_schedule"], sched["steps_offset"]) != (
            1000, 0.00085, 0.012, "scaled_linear", 1):
        bad.append("scheduler tables: the port's are SD's scaled_linear "
                   "0.00085-0.012 over 1000, offset 1")
    if bad:
        raise ValueError("configuration file and port differ: " + "; ".join(bad))


class Program:
    """The system under test: the port's pipeline with MoE routing on every
    FF, on `device`. `preset`: the name of the port's preset function, or
    (for tests at other sizes) a function of (dtype, **modes) returning
    (pipeline config, SDXL text configs or None). `modes`: serving-mode
    keywords of the preset (the control runs `quant_int8=True`)."""

    def __init__(self, cfg: dict, preset, state_dicts: dict, labels,
                 device, modes: dict | None = None):
        import diffusion_models_moe_tpu_torch as port
        from diffusion_models_moe_tpu_torch.taps import layer_name
        dt = dtype_of(cfg)
        if callable(preset):
            pcfg, text = preset(dt, **(modes or {}))
        else:
            pcfg, text = getattr(port, preset)(dt, **(modes or {})), None
        # the VAE's scaling factor is an option of the port's config: the
        # file's (the source's) is run
        pcfg = dataclasses.replace(pcfg, vae=dataclasses.replace(
            pcfg.vae, scaling_factor=cfg["vae"]["scaling_factor"]))
        if cfg["pipeline"] == "sdxl":
            text = text or port.sdxl_text_configs(dt)
            self.pipe = port.SDXLPipeline(pcfg, text, device=device)
        else:
            text = (pcfg.text_encoder,)
            self.pipe = port.StableDiffusionPipeline(pcfg, device=device)
        check_port_config(cfg, pcfg, text)
        self.pipe.load_state_dicts(state_dicts)
        self.ivs = port.build_moe_interventions(
            {layer_name(i): lab for i, lab in enumerate(labels)},
            cfg["moe"]["topk_ratio"], device=device, dtype=dt)
        self.cfg, self.device = cfg, device

    @property
    def denoiser(self) -> torch.nn.Module:
        """The module whose `*.ff` and `*.attn1` calls the tracer wraps."""
        return self.pipe.unet

    def generate(self, cond_ids, uncond_ids, seeds, steps: int,
                 guidance: float) -> torch.Tensor:
        """Images (B, 3, H, W) in [0, 1] on the device."""
        images, _ = self.pipe.generate(cond_ids.to(self.device),
                                       uncond_ids.to(self.device),
                                       seeds=list(seeds), num_steps=steps,
                                       guidance_scale=guidance, ivs=self.ivs)
        return images

    def engine(self, tokenize, **kw):
        from diffusion_models_moe_tpu_torch.serving import ServingEngine
        return ServingEngine(self.pipe, tokenize, ivs=self.ivs, **kw)


def preset_build(preset):
    def build(cfg, state_dicts, labels, device, modes=None) -> Program:
        return Program(cfg, preset, state_dicts, labels, device, modes)
    return build


generate_flops = counts.generate
