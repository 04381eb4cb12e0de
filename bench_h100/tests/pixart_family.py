"""A configuration family with no UNet, for the CPU tests: the port's tiny
PixArt-alpha geometry (`tiny_pixart_pipeline_config`: a DiT with
adaLN-single, the T5 encoder with its `T5LayerNorm`, non-gated tanh-GELU FFs
routed over random balanced experts, DPM-Solver++, the SD VAE) in float32,
with every name of the configuration-module interface
(`harness/loader.py`). Its configuration dict has no `unet` key.

Test scaffolding only: the reference here is the port's own PixArt pipeline
in float32, and `CONTROLS` runs the program in bfloat16. The plain
reference that imports nothing of the port, and the control, are a real
configuration's.
"""
from __future__ import annotations

import json
import pathlib

import torch
import torch.nn as nn

from bench_h100.harness import counts
from diffusion_models_moe_tpu_torch import build_moe_interventions
from diffusion_models_moe_tpu_torch.models.t5 import T5LayerNorm
from diffusion_models_moe_tpu_torch.pipelines.pixart import (
    PixArtPipeline, tiny_pixart_pipeline_config)
from diffusion_models_moe_tpu_torch.taps import layer_name

NAME = "tiny-pixart"
CONFIG = {
    "name": NAME, "pipeline": "pixart", "dtype": "float32",
    "transformer": {"sample_channels": 4, "out_channels": 4, "patch_size": 2,
                    "hidden_size": 32, "num_layers": 3, "num_heads": 4,
                    "cross_attention_dim": 32, "text_in_dim": 48,
                    "ff_mult": 4},
    "text_encoders": [{"vocab_size": 256, "d_model": 48, "d_kv": 8,
                       "d_ff": 96, "num_layers": 2, "num_heads": 4,
                       "max_length": 16}],
    "vae": {"latent_channels": 4, "out_channels": 3,
            "block_out_channels": [32, 32, 64, 64], "layers_per_block": 1,
            "norm_num_groups": 8, "scaling_factor": 0.18215},
    "sample_size": 8, "scheduler": {"name": "dpm"},
    "num_inference_steps": 2, "guidance_scale": 4.5,
    "moe": {"expert_size": 20, "topk_ratio": 0.3},
}
MIX = {"kind": "closed_batch", "batch": 2, "steps": 2, "guidance": 4.5,
       "warmup_steps": 1}
CHECK = {"requests": 2, "reference_batch": 2,
         "limits": {"img_rel_l2": 1e-3}}

NORMS = (nn.GroupNorm, nn.LayerNorm, T5LayerNorm)
CONTROLS = {"bf16": {"bf16": True}}


def port_config(cfg: dict, bf16: bool = False):
    """The port's tiny PixArt config; raises where it departs from `cfg`."""
    pcfg = tiny_pixart_pipeline_config(torch.bfloat16 if bf16
                                       else torch.float32)
    v = dict(cfg["vae"], in_channels=cfg["vae"]["out_channels"],
             block_out_channels=tuple(cfg["vae"]["block_out_channels"]))
    del v["out_channels"]
    parts = [(cfg["transformer"], pcfg.transformer),
             (cfg["text_encoders"][0], pcfg.text_encoder), (v, pcfg.vae),
             ({"sample_size": cfg["sample_size"],
               "scheduler": cfg["scheduler"]["name"],
               "guidance_scale": cfg["guidance_scale"],
               "num_inference_steps": cfg["num_inference_steps"]}, pcfg)]
    bad = [f"{k}: file {want!r}, port {getattr(got, k)!r}"
           for fields, got in parts for k, want in fields.items()
           if getattr(got, k) != want]
    if bad:
        raise ValueError("configuration and port differ: " + "; ".join(bad))
    return pcfg


def _load(pipe: PixArtPipeline, state_dicts: dict) -> None:
    """The drawn parameters, beside the modules' own buffers (the DiT's
    sincos position table)."""
    pipe.load_state_dicts({k: {**m.state_dict(), **state_dicts[k]}
                           for k, m in pipe.modules().items()})


def _routing(labels, topk_ratio: float, device, dtype):
    return build_moe_interventions(
        {layer_name(i): lab for i, lab in enumerate(labels)}, topk_ratio,
        device=device, dtype=dtype)


class Program:
    """The port's PixArt pipeline with MoE routing on every DiT FF."""

    def __init__(self, cfg: dict, state_dicts: dict, labels, device,
                 modes: dict | None = None):
        pcfg = port_config(cfg, **(modes or {}))
        self.pipe = PixArtPipeline(pcfg, device=device)
        _load(self.pipe, state_dicts)
        self.ivs = _routing(labels, cfg["moe"]["topk_ratio"], device,
                            pcfg.transformer.dtype)
        self.device = device

    @property
    def denoiser(self) -> nn.Module:
        return self.pipe.transformer

    def generate(self, cond_ids, uncond_ids, seeds, steps: int,
                 guidance: float) -> torch.Tensor:
        images, _ = self.pipe.generate(cond_ids.to(self.device),
                                       uncond_ids.to(self.device),
                                       seeds=list(seeds), num_steps=steps,
                                       guidance_scale=guidance, ivs=self.ivs)
        return images


def build(cfg, state_dicts, labels, device, modes=None) -> Program:
    return Program(cfg, state_dicts, labels, device, modes)


class Reference:
    """The port's PixArt pipeline in float32 (scaffolding, see above)."""

    def __init__(self, cfg: dict, device):
        self.pipe = PixArtPipeline(port_config(cfg), device=device)
        self.ivs = None

    def load(self, state_dicts: dict) -> None:
        _load(self.pipe, {k: {n: t.float() for n, t in sd.items()}
                          for k, sd in state_dicts.items()})

    def set_routing(self, labels, topk_ratio: float) -> None:
        self.ivs = _routing(labels, topk_ratio, self.pipe.device,
                            torch.float32)

    @torch.no_grad()
    def generate(self, cond_ids, uncond_ids, noise, steps: int,
                 guidance: float, bf16: bool = False) -> torch.Tensor:
        pipe = self.pipe
        with torch.autocast(pipe.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            ctx = pipe.encode_text(cond_ids)
            if guidance > 1.0:
                ctx = torch.cat([pipe.encode_text(uncond_ids), ctx])
            lat = noise.to(pipe.device) * pipe.scheduler.init_noise_sigma
            lat, _ = pipe.denoise(ctx, lat, steps, guidance, ivs=self.ivs)
            return pipe.decode(lat).float()


def reference(cfg: dict, device) -> Reference:
    return Reference(cfg, device)


def skeleton(cfg: dict) -> dict:
    return PixArtPipeline(port_config(cfg), device="meta").modules()


def ff_widths(cfg: dict) -> list:
    t = cfg["transformer"]
    return [t["ff_mult"] * t["hidden_size"]] * t["num_layers"]


def latent_shape(cfg: dict) -> tuple:
    s = cfg["sample_size"]
    return cfg["transformer"]["sample_channels"], s, s


def ff_work(cfg: dict, shape) -> tuple:
    """One non-gated FF over (b, s, d): W1 (H, d) and its bias, the score
    sums, W2 over the selected experts; no LayerNorm or residual inside."""
    b, s, d = shape
    n = b * s
    h = cfg["transformer"]["ff_mult"] * d
    e = h // cfg["moe"]["expert_size"]
    k = max(int(e * cfg["moe"]["topk_ratio"]), 1)
    flops = counts.linear(n, d, h) + n * h + counts.linear(n, h, d) * k / e
    nbytes = (2 * n * d + h * d + h + d * h + d + e * h) * counts.BF16
    return flops, nbytes


def attn_work(cfg: dict, shape) -> tuple:
    """One self-attention over (b, s, d) with biases on q, k, v and out."""
    b, s, d = shape
    flops = 4 * counts.linear(b * s, d, d) + 4.0 * b * s * s * d
    return flops, (2 * b * s * d + 4 * d * d + 4 * d) * counts.BF16


def _t5(t: dict, seqs: int) -> float:
    l, d, inner = t["max_length"], t["d_model"], t["num_heads"] * t["d_kv"]
    layer = (4 * counts.linear(l, d, inner) + 4.0 * l * l * inner
             + 3 * counts.linear(l, d, t["d_ff"]))
    return seqs * t["num_layers"] * layer


def _dit(cfg: dict, batch: int) -> float:
    t, s = cfg["transformer"], cfg["sample_size"]
    d, p, l = t["hidden_size"], t["patch_size"], cfg["text_encoders"][0][
        "max_length"]
    tokens = (s // p) ** 2
    block = (attn_work(cfg, (1, tokens, d))[0]
             + counts.cross_attn(1, tokens, d, l, t["cross_attention_dim"])
             + ff_work(cfg, (1, tokens, d))[0])
    per = (counts.conv(s // p, s // p, t["sample_channels"], d, p)
           + counts.linear(1, 256, d) + counts.linear(1, d, d)
           + counts.linear(1, d, 6 * d)
           + counts.linear(l, t["text_in_dim"], t["cross_attention_dim"])
           + counts.linear(l, t["cross_attention_dim"],
                           t["cross_attention_dim"])
           + t["num_layers"] * block
           + counts.linear(tokens, d, p * p * t["out_channels"]))
    return batch * per


def generate_flops(cfg: dict, images: int, steps: int,
                   guidance: float) -> float:
    """Both captions' T5 encodes, a DiT call a step (batch 2B under
    classifier-free guidance), the decode."""
    cfgs = 2 if guidance > 1.0 else 1
    return (_t5(cfg["text_encoders"][0], cfgs * images)
            + steps * _dit(cfg, cfgs * images)
            + counts.vae_decode(cfg["vae"], images, cfg["sample_size"]))


def add_to_checkout(root: pathlib.Path, traffic: str = "gen-b2") -> str:
    """Adds this family's configuration to the checkout at `root` as files
    and entries alone: its JSON and module, a traffic mix, the cell's check
    file and the cell in `BENCHMARK.json` (with the closed-loop metrics).
    Returns the cell's name."""
    bench, cell = root / "bench_h100", f"{NAME}.{traffic}"
    (bench / "configs" / f"{NAME}.json").write_text(json.dumps(CONFIG))
    (bench / "configs" / f"{NAME}.py").write_text(
        '"""Configuration `tiny-pixart`: bench_h100/tests/pixart_family.py."""\n'
        "from bench_h100.tests.pixart_family import (  # noqa: F401\n"
        "    CONTROLS, NORMS, attn_work, build, ff_widths, ff_work,\n"
        "    generate_flops, latent_shape, reference, skeleton)\n")
    (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(MIX))
    (bench / "workloads" / f"{cell}.json").write_text(json.dumps(
        dict(CHECK, config=NAME, traffic=traffic)))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": NAME, "source": "tests",
                           "file": f"bench_h100/configs/{NAME}.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": cell, "config": NAME,
                             "traffic": traffic, "chips": 1, "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "sd15-moe.gen-b8" in m.get("workloads", ()):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return cell

