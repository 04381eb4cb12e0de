"""ReLUfication fine-tuning step: the noise-prediction objective, AdamW or
Adafactor with global-norm clipping and gradient accumulation, EMA, and
checkpoints (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/training/train.py`. What optax
composes there is written here, with optax's semantics:

* the update is `MultiSteps(masked(chain(clip_by_global_norm, opt)))`:
  micro-step gradients are averaged (a running mean, as `MultiSteps` keeps
  it) and every `grad_accum_steps`-th step clips their global norm and
  applies the optimizer; the learning-rate schedule counts optimizer steps;
* AdamW is optax's `adamw`: bias-corrected moments, eps outside the square
  root, decoupled decay `weight_decay * param` on every parameter, all
  scaled by -lr;
* Adafactor is `optax.adafactor(lr, weight_decay_rate=weight_decay or
  None)` with its defaults: second moments factored over the two largest
  axes where the second-largest has at least 128 entries, decay rate
  1 - (t + 1)^-0.8, eps 1e-30 added to the squared gradient, the update
  clipped to an RMS of 1, times lr, times max(RMS(param), 1e-3), plus
  `weight_decay_rate * param`;
* the EMA decays once per optimizer step, never on accumulation
  micro-steps.

**Departure, on purpose: frozen parameters take no update.** JAX masks the
chain with `optax.masked`, which hands the masked-out leaves' raw gradient
through, and `apply_updates` adds it: a "frozen" parameter takes an
unclipped step of size 1 up its gradient. Here a parameter outside
`trainable_mask` has `requires_grad=False`, no gradient and no update, and
the clip's norm and the `grad_norm` metric run over the trainable
parameters (JAX's metric runs over all; with `ft_method="full"` they are
the same).

**Precision.** `TrainState.params` holds an f32 master of every UNet
parameter, and the optimizer state and the EMA are f32, as JAX's params
are. The UNet module is the working copy the forward runs in: in its
config's compute dtype (bf16 on the card, so that kernels 2 and 3 take the
attention), its norms f32 (`models/layers.cast_model`). After each
optimizer step the updated masters are copied into it (`load_params`).
Gradients are taken with respect to the working copy and widened to f32,
which is what JAX's cast at use gives (the cast's VJP widens a bf16
cotangent). A copy rather than a cast at use, because every module of the
port reads its compute dtype from its weights.

The step's four draws (t, noise, offset, perturbation) come from a
`torch.Generator` (`draw_step`) or are handed in as tensors: the parity
tests take JAX's draws from `jax.random.split(key, 4)` and inject them.
Latents are NCHW here, (B, 4, h, w); JAX's are NHWC.

Checkpoints are the port's own: one `torch.save` of the step, the masters,
the optimizer state and the EMA per label under `ckpt_dir`, the newest
`max_to_keep` kept (orbax is JAX's).

**Over a mesh** (`parallel/mesh.py`; JAX jits the step over `state_shardings`
and `batch_sharding`): every rank takes the same global batch and draws, and
keeps its dp slice of both; the gradients are averaged in f32 over dp before
the clip (JAX's mean over the global batch), and the loss metric too. Under
tp the UNet's layers, the masters, the moments and the EMA hold the rank's
shards (`param_shardings`); the clip's global norm sums the sharded
gradients' squares over tp once. A checkpoint is gathered over tp and written
once, by the coordinator, in the format above, and restored by slicing it to
the reading rank's shard: a tp=2 checkpoint resumes at tp=1 and the reverse.
Adafactor's factored moments and its RMS clip read whole tensors, so it is
refused under tp > 1.
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
from typing import Callable, Optional

import torch
import torch.nn as nn

from diffusion_models_moe_tpu_torch.parallel.distributed import (
    barrier, is_coordinator)
from diffusion_models_moe_tpu_torch.parallel.mesh import (all_reduce,
                                                          gather_tensor,
                                                          param_shardings,
                                                          shard_batch,
                                                          shard_tensor,
                                                          state_shardings)
from diffusion_models_moe_tpu_torch.schedulers.common import NoiseTables

# Selective fine-tuning methods: regexes (`re.match`) over the UNet's
# state-dict names, translated from the JAX package's patterns over Flax
# paths (`.../attn1/...` is `....attn1....` here, `.../ff/...` is `.ff.`,
# `/bias` and `_bias` leaves are `.bias`).
FT_METHODS = {
    "full": [r".*"],
    "attention": [r".*\.attn\d\..*", r".*\.(norm\d|norm)\..*"],
    "norm": [r".*\.(norm\d|norm|conv_norm_out)\..*", r".*norm.*"],
    "bias": [r".*\.bias$"],
    "ff": [r".*\.ff\..*"],
    "norm_bias": [r".*norm.*", r".*\.bias$"],
    "norm_bias_attention": [r".*norm.*", r".*\.bias$", r".*\.attn\d\..*"],
}

ADAFACTOR_DECAY = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_MIN_DIM = 128
ADAFACTOR_CLIP = 1.0
ADAFACTOR_MIN_SCALE = 1e-3


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    grad_accum_steps: int = 1
    snr_gamma: Optional[float] = None       # e.g. 5.0
    noise_offset: float = 0.0
    input_perturbation: float = 0.0
    ema_decay: float = 0.9999
    use_ema: bool = True
    ft_method: str = "full"
    prediction_type: str = "epsilon"        # or "v_prediction"
    # "constant" | "cosine" | "linear", after a linear warm-up from 0
    lr_schedule: str = "constant"
    lr_warmup_steps: int = 0
    # decay horizon of cosine and linear
    max_train_steps: int = 10000
    optimizer: str = "adamw"                # or "adafactor"


def trainable_mask(names, ft_method: str) -> dict[str, bool]:
    """{name: trains} over UNet state-dict names, by `FT_METHODS`."""
    pats = [re.compile(p) for p in FT_METHODS[ft_method]]
    return {n: any(p.match(n) for p in pats) for n in names}


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate at each optimizer step count, as optax's
    `constant_schedule`, `cosine_decay_schedule` and `linear_schedule`,
    joined after a linear warm-up from 0 (`join_schedules`: the body
    restarts its count at the boundary)."""
    lr = cfg.learning_rate
    decay = max(cfg.max_train_steps - cfg.lr_warmup_steps, 1)
    if cfg.lr_schedule == "constant":
        def body(count):
            return lr
    elif cfg.lr_schedule == "cosine":
        def body(count):
            return lr * 0.5 * (1.0 + math.cos(math.pi * min(count, decay)
                                              / decay))
    elif cfg.lr_schedule == "linear":
        def body(count):
            return lr * (1.0 - min(max(count, 0), decay) / decay)
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    warm = cfg.lr_warmup_steps
    if warm <= 0:
        return body

    def schedule(count):
        if count < warm:
            return lr * min(max(count, 0), warm) / warm
        return body(count - warm)
    return schedule


def factored_dims(shape) -> Optional[tuple[int, int]]:
    """Adafactor's (d1, d0): the axes of the second-largest and the largest
    size, where the second-largest has at least ADAFACTOR_MIN_DIM entries;
    None otherwise (optax `_factored_dims`; ties by position, as a stable
    argsort gives them). The factored estimate is symmetric in the two
    axes, so the port's (out, in) layouts give JAX's (in, out) updates."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < ADAFACTOR_MIN_DIM:
        return None
    return order[-2], order[-1]


@dataclasses.dataclass
class TrainState:
    """`step`: micro-steps taken; `params`: the f32 master of every UNet
    parameter by state-dict name; `opt_state`: "count" (optimizer steps
    applied), "mini_step" and "acc" (the accumulation's running mean, None
    without accumulation), and the optimizer's moments by name ("mu", "nu";
    or "v_row", "v_col", "v"), trainable parameters only; `ema_params`: f32,
    every parameter, or None."""
    step: int
    params: dict
    opt_state: dict
    ema_params: Optional[dict]


def _zeros_like(params: dict, names) -> dict:
    return {n: torch.zeros_like(params[n]) for n in names}


def create_train_state(unet: nn.Module, cfg: TrainConfig) -> TrainState:
    """The state at step 0 from the UNet's current weights: f32 masters, the
    optimizer's zero state, the EMA equal to the masters. Marks the UNet's
    parameters trainable or frozen by `cfg.ft_method`."""
    params = {n: p.detach().float().clone() for n, p in unet.named_parameters()}
    mask = trainable_mask(params, cfg.ft_method)
    for n, p in unet.named_parameters():
        p.requires_grad_(mask[n])
    train = [n for n in params if mask[n]]
    opt = {"count": 0, "mini_step": 0,
           "acc": (_zeros_like(params, train) if cfg.grad_accum_steps > 1
                   else None)}
    if cfg.optimizer == "adamw":
        opt["mu"] = _zeros_like(params, train)
        opt["nu"] = _zeros_like(params, train)
    elif cfg.optimizer == "adafactor":
        one = lambda p: torch.zeros((1,), device=p.device)  # noqa: E731
        opt["v_row"], opt["v_col"], opt["v"] = {}, {}, {}
        for n in train:
            p = params[n]
            dims = factored_dims(p.shape)
            if dims is None:
                opt["v_row"][n], opt["v_col"][n] = one(p), one(p)
                opt["v"][n] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                opt["v_row"][n] = p.new_zeros(p.shape[:d0] + p.shape[d0 + 1:])
                opt["v_col"][n] = p.new_zeros(p.shape[:d1] + p.shape[d1 + 1:])
                opt["v"][n] = one(p)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    ema = ({n: t.clone() for n, t in params.items()} if cfg.use_ema else None)
    return TrainState(step=0, params=params, opt_state=opt, ema_params=ema)


@torch.no_grad()
def load_params(unet: nn.Module, params: dict) -> None:
    """Copies f32 tensors by name into the UNet's parameters, each cast to
    its parameter's dtype (the working copy's refresh)."""
    for n, p in unet.named_parameters():
        if n in params:
            p.copy_(params[n])


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, f32 (optax `global_norm`)."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def _adamw(cfg, p, g, mu, nu, count: int, lr: float) -> None:
    mu.mul_(cfg.adam_b1).add_(g, alpha=1.0 - cfg.adam_b1)
    nu.mul_(cfg.adam_b2).addcmul_(g, g, value=1.0 - cfg.adam_b2)
    mu_hat = mu / (1.0 - cfg.adam_b1 ** (count + 1))
    nu_hat = nu / (1.0 - cfg.adam_b2 ** (count + 1))
    u = mu_hat / (nu_hat.sqrt() + cfg.adam_eps) + cfg.weight_decay * p
    p.sub_(lr * u)


def _rms(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(t.pow(2).mean())


def _adafactor(cfg, p, g, v_row, v_col, v, count: int, lr: float) -> None:
    decay = 1.0 - (count + 1.0) ** -ADAFACTOR_DECAY
    g2 = g * g + ADAFACTOR_EPS
    dims = factored_dims(p.shape)
    if dims is not None:
        d1, d0 = dims
        v_row.mul_(decay).add_(g2.mean(d0), alpha=1.0 - decay)
        v_col.mul_(decay).add_(g2.mean(d1), alpha=1.0 - decay)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)) ** -0.5
        u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
    else:
        v.mul_(decay).add_(g2, alpha=1.0 - decay)
        u = g * v ** -0.5
    u = u / torch.clamp(_rms(u) / ADAFACTOR_CLIP, min=1.0)
    u = u * lr * torch.clamp(_rms(p), min=ADAFACTOR_MIN_SCALE)
    if cfg.weight_decay:
        u = u + cfg.weight_decay * p
    p.sub_(u)


def tp_global_norm(sharded: set, mesh) -> Callable:
    """`global_norm` of {name: gradient} over a mesh whose tp axis shards
    the names in `sharded`: their squares summed over tp, the replicated
    ones counted once."""
    def norm(grads: dict) -> torch.Tensor:
        dev = next(iter(grads.values())).device
        rep, shard = torch.zeros((), device=dev), torch.zeros((), device=dev)
        for n, g in grads.items():
            if n in sharded:
                shard = shard + g.float().pow(2).sum()
            else:
                rep = rep + g.float().pow(2).sum()
        return torch.sqrt(rep + all_reduce(shard, mesh.group("tp")))
    return norm


@torch.no_grad()
def apply_gradients(state: TrainState, grads: dict, cfg: TrainConfig,
                    schedule: Callable[[int], float],
                    norm_fn: Optional[Callable] = None) -> bool:
    """One micro-step of the update on the trainable masters: accumulate,
    and on the last micro-step of a cycle (every step without accumulation)
    clip the gradients' global norm (`norm_fn` of the gradients, by default
    `global_norm` of their values) to `max_grad_norm` and apply the
    optimizer. Returns whether the parameters changed."""
    opt = state.opt_state
    k = cfg.grad_accum_steps
    if k > 1:
        mini, acc = opt["mini_step"], opt["acc"]
        for n, g in grads.items():
            acc[n].add_((g - acc[n]) / (mini + 1))
        if mini < k - 1:
            opt["mini_step"] = mini + 1
            return False
        grads = {n: a.clone() for n, a in acc.items()}
        for a in acc.values():
            a.zero_()
        opt["mini_step"] = 0
    norm = (norm_fn(grads) if norm_fn is not None
            else global_norm(grads.values()))
    if not bool(norm < cfg.max_grad_norm):
        grads = {n: g / norm * cfg.max_grad_norm for n, g in grads.items()}
    count = opt["count"]
    lr = float(schedule(count))
    for n, g in grads.items():
        p = state.params[n]
        if cfg.optimizer == "adamw":
            _adamw(cfg, p, g, opt["mu"][n], opt["nu"][n], count, lr)
        else:
            _adafactor(cfg, p, g, opt["v_row"][n], opt["v_col"][n],
                       opt["v"][n], count, lr)
    opt["count"] = count + 1
    return True


def draw_step(generator: torch.Generator, shape, n_train_t: int = 1000
              ) -> dict:
    """The step's four draws from `generator`, on its device, in this order:
    timesteps t (B,) in [0, n_train_t), noise (shape), the per-sample
    channel offset (B, C, 1, 1) and the input perturbation (shape)."""
    b, c = shape[:2]
    dev = generator.device
    return {"t": torch.randint(0, n_train_t, (b,), generator=generator,
                               device=dev),
            "noise": torch.randn(shape, generator=generator, device=dev),
            "offset": torch.randn((b, c, 1, 1), generator=generator,
                                  device=dev),
            "perturbation": torch.randn(shape, generator=generator,
                                        device=dev)}


def loss_fn(unet: nn.Module, latents: torch.Tensor, text_emb: torch.Tensor,
            draws: dict, cfg: TrainConfig, tables: NoiseTables,
            use_kernels: bool = True) -> torch.Tensor:
    """The objective of JAX's `make_train_step`: noise (plus `noise_offset`
    times the offset draw), the noisy latents from that noise plus
    `input_perturbation` times the perturbation draw, the eps or v target
    from the unperturbed noise, the per-example MSE weighted by min-SNR
    (min(snr, gamma) / snr for eps, / (snr + 1) for v), the mean over the
    batch. f32. `use_kernels=False` runs the kernels' plain versions (for
    kernel-vs-plain comparisons)."""
    t = draws["t"]
    noise = draws["noise"]
    if cfg.noise_offset > 0:
        noise = noise + cfg.noise_offset * draws["offset"]
    target_noise = noise
    if cfg.input_perturbation > 0:
        noise = noise + cfg.input_perturbation * draws["perturbation"]
    a = tables.alphas_at(t)[:, None, None, None]
    noisy = tables.add_noise(latents, noise, t)
    pred = unet(noisy, t, text_emb, use_kernels=use_kernels)
    if cfg.prediction_type == "epsilon":
        target = target_noise
    else:
        target = torch.sqrt(a) * target_noise - torch.sqrt(1.0 - a) * latents
    per_ex = ((pred - target) ** 2).mean(dim=(1, 2, 3))
    if cfg.snr_gamma is not None:
        snr = tables.snr(t)
        div = snr + 1.0 if cfg.prediction_type == "v_prediction" else snr
        per_ex = per_ex * (torch.clamp(snr, max=cfg.snr_gamma) / div)
    return per_ex.mean()


def make_train_step(unet: nn.Module, cfg: TrainConfig,
                    tables: Optional[NoiseTables] = None,
                    mesh=None) -> Callable:
    """Returns step(state, batch, generator=None, draws=None) -> (state,
    metrics) on the working copy `unet`. batch: {"latents": (B, 4, h, w)
    scaled latents, "text_emb": (B, S, D)}; `draws` as `draw_step` gives
    them, else drawn from `generator`. metrics: {"loss", "grad_norm"}, f32
    scalars. The state is updated in place and returned. Made after
    `create_train_state`, which marks the parameters that train. With
    `mesh`, every rank calls the step with the same global batch (and
    draws), and `unet` is sharded over its tp axis already (see the
    module's docstring)."""
    tables = tables or NoiseTables.create()
    schedule = make_lr_schedule(cfg)
    named = [(n, p) for n, p in unet.named_parameters() if p.requires_grad]
    dp_group = None if mesh is None else mesh.group("dp")
    norm_fn = None
    if mesh is not None and mesh.group("tp") is not None:
        if cfg.optimizer == "adafactor":
            raise ValueError("adafactor is not taken under tp > 1: its "
                             "factored moments read whole tensors")
        plan = param_shardings(unet)
        norm_fn = tp_global_norm({n for n, _ in named if "tp" in plan[n]},
                                 mesh)

    def step(state: TrainState, batch: dict,
             generator: Optional[torch.Generator] = None,
             draws: Optional[dict] = None):
        lat, emb = batch["latents"], batch["text_emb"]
        if draws is None:
            draws = draw_step(generator, lat.shape,
                              tables.num_train_timesteps)
        if dp_group is not None:
            lat, emb = shard_batch(lat, mesh), shard_batch(emb, mesh)
            draws = {k: shard_batch(v, mesh) for k, v in draws.items()}
        with torch.enable_grad():
            loss = loss_fn(unet, lat, emb, draws, cfg, tables)
            loss.backward()
        grads = {}
        for n, p in named:
            grads[n] = p.grad.float()
            p.grad = None
        if dp_group is not None:
            dp = mesh.axis_size("dp")
            for g in grads.values():
                all_reduce(g, dp_group).div_(dp)
            loss = all_reduce(loss.detach().clone(), dp_group) / dp
        gnorm = (norm_fn(grads) if norm_fn is not None
                 else global_norm(grads.values()))
        applied = apply_gradients(state, grads, cfg, schedule, norm_fn)
        del grads
        if applied:
            load_params(unet, {n: state.params[n] for n, _ in named})
        if cfg.use_ema and state.ema_params is not None and applied:
            with torch.no_grad():
                for n, e in state.ema_params.items():
                    e.mul_(cfg.ema_decay).add_(state.params[n],
                                               alpha=1.0 - cfg.ema_decay)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


# --------------------------------------------------------------- checkpoints
_CKPT = re.compile(r"^step_(\d+)\.pt$")


def checkpoint_steps(ckpt_dir: str) -> list[int]:
    """The labels saved under `ckpt_dir`, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m[1]) for m in map(_CKPT.match, os.listdir(ckpt_dir))
                  if m)


def map_state(state: TrainState, plan: dict, fn: Callable) -> TrainState:
    """A state whose every name-keyed tensor t is `fn(t, spec)`, its spec
    from `state_shardings(state, plan)`."""
    specs = state_shardings(state, plan)

    def table(t, sp):
        return None if t is None else {n: fn(v, sp[n]) for n, v in t.items()}
    opt = {k: table(v, specs["opt_state"][k]) if isinstance(v, dict) else v
           for k, v in state.opt_state.items()}
    return TrainState(step=state.step, params=table(state.params,
                                                    specs["params"]),
                      opt_state=opt,
                      ema_params=table(state.ema_params,
                                       specs["ema_params"]))


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int,
                    max_to_keep: int = 3, mesh=None,
                    plan: Optional[dict] = None) -> str:
    """Writes the state under label `step` (`step_{step:08d}.pt`, written
    to a temporary name and renamed into place) and removes all but the
    newest `max_to_keep` labels. Refuses a label that exists, as orbax
    does. With a `mesh` whose tp axis shards the state by `plan` (the
    UNet's `param_shardings`), every rank calls it: the state is gathered
    over tp and written by the coordinator alone."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}.pt")
    if mesh is not None and mesh.group("tp") is not None:
        state = map_state(state, plan,
                          lambda t, sp: gather_tensor(t, sp, mesh))
    if is_coordinator():
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(path):
            raise FileExistsError(f"checkpoint {step} exists under "
                                  f"{ckpt_dir}")
        tmp = path + ".tmp"
        torch.save(dict(vars(state)), tmp)
        os.replace(tmp, path)
        for old in checkpoint_steps(ckpt_dir)[:-max_to_keep]:
            os.remove(os.path.join(ckpt_dir, f"step_{old:08d}.pt"))
    barrier()
    return path


def restore_checkpoint(ckpt_dir: str, template: TrainState, mesh=None,
                       plan: Optional[dict] = None
                       ) -> tuple[TrainState, int]:
    """The newest checkpoint under `ckpt_dir`, on the template's device, and
    its label; (template, 0) where none exists. With a `mesh` whose tp axis
    shards the state by `plan`, each rank keeps its shard of the whole
    tensors saved."""
    steps = checkpoint_steps(ckpt_dir)
    if not steps:
        return template, 0
    dev = next(iter(template.params.values())).device
    saved = TrainState(**torch.load(
        os.path.join(ckpt_dir, f"step_{steps[-1]:08d}.pt"),
        map_location=dev, weights_only=True))
    if mesh is not None and mesh.group("tp") is not None:
        saved = map_state(saved, plan,
                          lambda t, sp: shard_tensor(t, sp, mesh))
    return saved, steps[-1]
