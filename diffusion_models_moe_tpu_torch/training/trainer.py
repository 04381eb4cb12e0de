"""ReLUfication training loop (PyTorch port): batches -> frozen text and VAE
encoders -> the train step -> JSONL log, checkpoints, validation images.

Counterpart of `diffusion_models_moe_tpu/training/trainer.py`, on the
pipeline's device (the card unless it was built with `device="cpu"`) in each
process of a ("dp", "tp") mesh: `create_mesh(RunConfig.n_devices)`, as in
JAX (one process without a group), or the `mesh` handed in. Every rank runs
`train_relufied` with the same batches; the UNet is sharded over tp in
place, each step takes the rank's dp slice (`training/train.py`), and the
log lines, checkpoints and validation images are written once, by the
coordinator. The ReLUfied UNet is a config flag
(`sd15_config(relufied=True)`), as in JAX.

Randomness: step i draws its VAE sample noise and the step's four draws
from a `torch.Generator` on the device seeded from step i alone
(`step_generator`), so a run resumed from a checkpoint draws what the
uninterrupted run drew. (JAX splits one key, PRNGKey(0), and restarts it on
resume.)
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.nn as nn

from diffusion_models_moe_tpu_torch.models.layers import cast_model
from diffusion_models_moe_tpu_torch.models.vae import VAEEncoder, sample_latents
from diffusion_models_moe_tpu_torch.parallel.distributed import (
    barrier, is_coordinator)
from diffusion_models_moe_tpu_torch.parallel.mesh import (create_mesh,
                                                          param_shardings,
                                                          shard_module)
from diffusion_models_moe_tpu_torch.training.train import (
    TrainConfig, TrainState, create_train_state, load_params, make_train_step,
    restore_checkpoint, save_checkpoint)


@dataclasses.dataclass
class RunConfig:
    out_dir: str
    max_steps: int = 1000
    checkpoint_every: int = 500
    log_every: int = 50
    max_checkpoints: int = 3
    resume: bool = True
    # devices of the mesh (`create_mesh`), by default every process's one
    n_devices: Optional[int] = None
    # generate validation images every N steps (0: off); see
    # make_validation_logger
    validation_every: int = 0


def step_generator(step: int, device) -> torch.Generator:
    """Step `step`'s generator on `device`, seeded from the step alone: the
    first 64-bit word of numpy's `SeedSequence((0, step))`, shifted right by
    one."""
    word = np.random.SeedSequence((0, int(step))).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word) >> 1)


def build_vae_encoder(pipe, state_dict: Optional[dict] = None) -> VAEEncoder:
    """A `VAEEncoder` for `pipe`'s VAE config on its device, in the config's
    dtype (norms f32), loaded strictly from `state_dict` where given (e.g.
    `load_pipeline_snapshot(..., include_vae_encoder=True)["vae_encoder"]`)."""
    cfg = pipe.config.vae
    with torch.device(pipe.device):
        enc = cast_model(VAEEncoder(cfg), cfg.dtype).eval()
    if state_dict is not None:
        enc.load_state_dict(state_dict, strict=True)
    enc.requires_grad_(False)
    return enc


@torch.no_grad()
def encode_batch(pipe, vae_encoder: nn.Module, images, input_ids,
                 generator: torch.Generator) -> dict:
    """Raw images (B, H, W, 3) in [-1, 1], as `data/ingest.py` yields them,
    and token ids (B, S) -> {"latents": (B, 4, H/8, W/8) sampled and scaled,
    "text_emb": (B, S, D)}, through the frozen encoders. The sample noise is
    drawn from `generator`."""
    dev = pipe.device
    imgs = torch.as_tensor(np.asarray(images), dtype=torch.float32)
    imgs = imgs.permute(0, 3, 1, 2).contiguous().to(dev)
    ids = torch.as_tensor(np.asarray(input_ids)).to(dev)
    emb, _ = pipe.encode_text(ids)
    mean, logvar = vae_encoder(imgs)
    noise = torch.randn(mean.shape, generator=generator, device=dev)
    lat = sample_latents(mean, logvar, noise, pipe.config.vae.scaling_factor)
    return {"latents": lat, "text_emb": emb}


def train_relufied(pipe, train_cfg: TrainConfig, run_cfg: RunConfig,
                   batches: Iterator[dict],
                   vae_encoder: Optional[nn.Module] = None,
                   log_fn: Optional[Callable[[dict], None]] = None,
                   validation_fn: Optional[Callable] = None,
                   mesh=None) -> TrainState:
    """Fine-tunes `pipe.unet` (the model being tuned, with
    `ff_activation="geglu-relu"` for ReLUfication) on `batches`, which yield
    {"images": (B, H, W, 3) in [-1, 1], "input_ids": (B, S)} (raw, encoded
    by `pipe.text_encoder` and `vae_encoder`, both frozen) or pre-encoded
    {"latents": (B, 4, h, w), "text_emb": (B, S, D)}. Returns the final
    state; `pipe.unet` ends holding its masters.

    Resume (`run_cfg.resume` and a checkpoint under `out_dir/checkpoints`):
    the newest label N is restored and the first N batches are skipped (the
    iterator is materialised first, so a list is not restarted). Batches are
    pulled on demand: the loop takes none past `max_steps`. Checkpoint
    labels are steps completed; the final save is skipped where nothing ran
    or the loop has just saved that label. `out_dir/train_log.jsonl` gets
    {"step", "loss", "grad_norm", "elapsed_s"} every `log_every` steps.
    `validation_fn(unet_params, step)` gets the EMA (else the masters)
    every `validation_every` steps after step 0, on every rank (the rank's
    shards). `mesh`: in place of `create_mesh(run_cfg.n_devices)`."""
    mesh = mesh or create_mesh(run_cfg.n_devices)
    plan = param_shardings(pipe.unet)
    unet = shard_module(pipe.unet, plan, mesh)
    write = is_coordinator()
    state = create_train_state(unet, train_cfg)
    start_step = 0
    ckpt_dir = os.path.join(os.path.abspath(run_cfg.out_dir), "checkpoints")
    if run_cfg.resume and os.path.isdir(ckpt_dir):
        state, start_step = restore_checkpoint(ckpt_dir, state, mesh, plan)
        load_params(unet, state.params)
    barrier()            # every rank has read the resume state
    step_fn = make_train_step(unet, train_cfg, mesh=mesh)

    os.makedirs(run_cfg.out_dir, exist_ok=True)
    log_path = os.path.join(run_cfg.out_dir, "train_log.jsonl")
    t0 = time.perf_counter()
    completed = start_step
    batches = iter(batches)
    for _ in itertools.islice(batches, start_step):
        pass
    for step in range(start_step, run_cfg.max_steps):
        batch = next(batches, None)
        if batch is None:
            break
        gen = step_generator(step, pipe.device)
        if "latents" not in batch:
            if vae_encoder is None:
                raise ValueError("raw-image batches need a vae_encoder")
            batch = encode_batch(pipe, vae_encoder, batch["images"],
                                 batch["input_ids"], gen)
        else:
            batch = {k: torch.as_tensor(batch[k]).to(pipe.device)
                     for k in ("latents", "text_emb")}
        state, metrics = step_fn(state, batch, generator=gen)
        if step % run_cfg.log_every == 0:
            rec = {"step": step, "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "elapsed_s": round(time.perf_counter() - t0, 1)}
            if write:
                with open(log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                if log_fn:
                    log_fn(rec)
        completed = step + 1
        if completed % run_cfg.checkpoint_every == 0:
            save_checkpoint(ckpt_dir, state, completed,
                            run_cfg.max_checkpoints, mesh, plan)
        if (validation_fn is not None and run_cfg.validation_every > 0
                and step > 0 and step % run_cfg.validation_every == 0):
            validation_fn(state.ema_params if state.ema_params is not None
                          else state.params, step)
    if completed > start_step and completed % run_cfg.checkpoint_every != 0:
        save_checkpoint(ckpt_dir, state, completed, run_cfg.max_checkpoints,
                        mesh, plan)
    return state


def make_validation_logger(pipe, tokenize: Callable, prompts, out_dir: str,
                           num_steps: int = 4, seed: int = 0) -> Callable:
    """validation_fn for `train_relufied`: generates `prompts` through
    `pipe.generate` (its kernels under no_grad) with the given UNet params
    (the EMA) loaded into `pipe.unet`, writes PNGs and a JSONL record per
    validation step, and puts the UNet's own weights back. Under a mesh
    every rank calls it (the UNet's collectives) and the coordinator alone
    writes."""
    from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import \
        to_pil

    os.makedirs(out_dir, exist_ok=True)
    cond = torch.as_tensor(np.asarray(tokenize(list(prompts))))
    uncond = torch.as_tensor(np.asarray(tokenize([""] * len(prompts))))
    log_path = os.path.join(out_dir, "validation_log.jsonl")

    def validation_fn(unet_params: dict, step: int) -> None:
        unet = pipe.unet
        own = {n: p.detach().clone() for n, p in unet.named_parameters()}
        load_params(unet, unet_params)
        try:
            gen = torch.Generator(device=pipe.device).manual_seed(seed)
            imgs, _ = pipe.generate(cond, uncond, gen, num_steps=num_steps)
        finally:
            load_params(unet, own)
        if not is_coordinator():
            return
        paths = []
        for i, img in enumerate(to_pil(imgs)):
            p = os.path.join(out_dir, f"val_step{step:06d}_{i}.png")
            img.save(p)
            paths.append(p)
        with open(log_path, "a") as f:
            f.write(json.dumps({"step": step, "images": paths,
                                "prompts": list(prompts)}) + "\n")

    return validation_fn


def param_count_report(params: dict, mask: Optional[dict] = None) -> dict:
    """Tunable-parameter share of {name: tensor} under {name: trains}."""
    total = sum(int(t.numel()) for t in params.values())
    if mask is None:
        return {"total": total, "trainable": total, "share": 1.0}
    trainable = sum(int(t.numel()) for n, t in params.items() if mask[n])
    return {"total": total, "trainable": trainable, "share": trainable / total}
