"""Text-to-image Stable Diffusion pipeline (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/pipelines/stable_diffusion.py`:
CLIP encodes the prompt and the negative prompt, the config's scheduler
(`SCHEDULERS`: DDIM, PNDM, Euler, DPM-Solver++ 2M, LCM) denoises with
classifier-free guidance (off when guidance <= 1) through the MoE-routed
UNet, and the VAE decodes. Latents and images are NCHW. The JAX pipeline
traces the loop into one `lax.scan`; here it is an eager Python loop.

With `prediction_type="v_prediction"` (SD2.1-768) the UNet's output v is
turned into eps = sqrt(a_t) v + sqrt(1 - a_t) x_t on the carried latent, in
f32, with a_t taken at the step's timestep; that is right only for schedulers
whose carried latent is x_t itself with one model output a step, so, as in
the JAX package, v-prediction is refused with Euler (sigma-space latents)
and PNDM (whose multistep combination would have to precede the
conversion). Under LCM there is no classifier-free guidance: the context
holds the prompt alone and the guidance scale g enters the UNet as the
embedding of w = 1000 (g - 1) through `time_embedding.cond_proj`; its step
noise comes from one generator a sample (`generate`) or is handed in
(`denoise(step_noise=)`).

With a `TapSpec`, `denoise` returns the statistics of every step stacked to
`(T, ...)` by the step index, as {stat: {layer: tensor}}; they stay on the
device until the loop ends. `generate` returns `(images, taps)`, the CLIP
MLP taps added over the prompt and the negative-prompt encodes.

The Winograd and int8 serving modes are fields of the UNet's and the VAE's
configs and change nothing here. With `config.deep_cache_interval > 0`
`denoise` runs the full UNet on every interval-th entry of the scheduler's
timestep table, keeping the feature that enters the last up block, and the
shallow forward on that feature in between: a host branch where the JAX
pipeline has a `lax.cond`, on the index over the scheduler's table, whatever
the scheduler.

`generate(mesh=)` runs over the processes of a ("dp", "tp") mesh
(`parallel/mesh.py`): every rank calls it with the same global inputs. The
pipeline's modules are sharded over tp in place on the first such call
(heads and FF hidden columns, `shard_pipeline`); each rank denoises its dp
slice of the batch, and the images and the taps are gathered over dp
(`taps.gather_taps`), so every rank returns what one process returns,
within rounding.

`denoise(use_kernels=False)` runs the plain versions of the hand-written
kernels on CUDA tensors; it exists only for kernel-vs-plain comparisons.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.config import (PipelineConfig,
                                                   resolve_device)
from diffusion_models_moe_tpu_torch.models.clip_text import CLIPTextEncoder
from diffusion_models_moe_tpu_torch.models.layers import (cast_model,
                                                          f32_convs,
                                                          timestep_embedding)
from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
from diffusion_models_moe_tpu_torch.models.vae import VAEDecoder
from diffusion_models_moe_tpu_torch.parallel.mesh import (batch_slice,
                                                          gather_batch,
                                                          shard_pipeline)
from diffusion_models_moe_tpu_torch.schedulers.ddim import DDIMScheduler
from diffusion_models_moe_tpu_torch.schedulers.dpm import DPMSolverScheduler
from diffusion_models_moe_tpu_torch.schedulers.euler import \
    EulerDiscreteScheduler
from diffusion_models_moe_tpu_torch.schedulers.lcm import LCMScheduler
from diffusion_models_moe_tpu_torch.schedulers.pndm import PNDMScheduler
from diffusion_models_moe_tpu_torch.taps import (Interventions, TapSpec,
                                                 gather_taps)

SCHEDULERS = {
    "ddim": DDIMScheduler,
    "pndm": PNDMScheduler,
    "euler": EulerDiscreteScheduler,
    "dpm": DPMSolverScheduler,
    "lcm": LCMScheduler,
}


def step_seed(seed: int) -> int:
    """The seed of a request's LCM step-noise generator, from its seed
    alone: the first 64-bit word of numpy's `SeedSequence((seed, 1))`,
    shifted right by one. (Its initial noise comes from a generator seeded
    with `seed` itself.)"""
    words = np.random.SeedSequence((int(seed), 1)).generate_state(1, np.uint64)
    return int(words[0]) >> 1


class StableDiffusionPipeline:
    """Holds the three modules and the scheduler on one device: the card,
    unless the caller asks for another (`device="cpu"`)."""

    def __init__(self, config: PipelineConfig, device="cuda"):
        if (config.prediction_type == "v_prediction"
                and config.scheduler not in ("ddim", "dpm")):
            # the v -> eps conversion in `denoise` uses the carried latent
            # at the current timestep: Euler carries sqrt(sigma^2 + 1) x_t,
            # and PNDM's warm-up relabels timesteps and combines model
            # outputs before a conversion would have to happen
            raise ValueError(
                f"prediction_type='v_prediction' supports schedulers "
                f"ddim/dpm, not {config.scheduler!r}")
        if config.scheduler == "lcm" and config.unet.time_cond_proj_dim <= 0:
            # without the guidance embedding an LCM run would ignore the
            # guidance scale (no CFG and no embedded guidance)
            raise ValueError(
                "scheduler='lcm' needs unet.time_cond_proj_dim > 0 (the "
                "distilled guidance embedding)")
        self.config = config
        self.device = resolve_device(device)
        with torch.device(self.device):
            self._build_modules()
        self.scheduler = SCHEDULERS[config.scheduler].create()

    def _build_modules(self) -> None:
        config = self.config
        self.unet = cast_model(UNet2DCondition(config.unet),
                               config.unet.dtype).eval()
        self.text_encoder = cast_model(CLIPTextEncoder(config.text_encoder),
                                       config.text_encoder.dtype).eval()
        self.vae_decoder = cast_model(VAEDecoder(config.vae),
                                      config.vae.dtype).eval()

    # ------------------------------------------------------------------ params
    def modules(self) -> dict[str, nn.Module]:
        return {"unet": self.unet, "text_encoder": self.text_encoder,
                "vae": self.vae_decoder}

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random weights from `generator`, in the JAX package's init scheme:
        lecun-normal weights (std 1/sqrt(fan_in)), zero biases, unit norm
        scales, token embeddings with std 1/sqrt(width), zero position
        embeddings. Parameters are drawn in state-dict order."""
        gdev = generator.device
        for module in self.modules().values():
            for name, p in module.named_parameters():
                if name.endswith("position_embedding.weight") or (
                        name.endswith("bias")):
                    p.zero_()
                    continue
                owner = module.get_submodule(name.rpartition(".")[0])
                if isinstance(owner, (nn.GroupNorm, nn.LayerNorm)):
                    p.fill_(1.0)
                    continue
                fan_in = (p.shape[1] if isinstance(owner, nn.Embedding)
                          else p[0].numel())
                vals = torch.randn(p.shape, generator=generator, device=gdev)
                p.copy_(vals * fan_in ** -0.5)

    def load_state_dicts(self, state_dicts: dict[str, dict]) -> None:
        """Loads a state dict for each of `modules()` ({"unet",
        "text_encoder", "vae"}; diffusers / transformers names, e.g. from
        `weights/bridge.py`), strictly."""
        for key, module in self.modules().items():
            module.load_state_dict(state_dicts[key], strict=True)

    # ------------------------------------------------------------------ text
    @torch.no_grad()
    def encode_text(self, input_ids: torch.Tensor,
                    tap: Optional[TapSpec] = None,
                    text_ivs: Optional[Interventions] = None):
        """ids (B, S) -> (embeddings (B, S, D), text taps or None). Text taps
        are collected only for `tap.ff_out_colnorm_sq`."""
        ids = input_ids.to(self.device)
        if tap is not None and tap.ff_out_colnorm_sq:
            taps: dict = {}
            emb = self.text_encoder(ids, tap=tap, ivs=text_ivs, taps_out=taps)
            return emb, taps
        return self.text_encoder(ids, ivs=text_ivs), None

    # ------------------------------------------------------------------ core
    @torch.no_grad()
    def denoise(self, context: torch.Tensor, latents: torch.Tensor,
                num_steps: int, guidance_scale: float,
                tap: Optional[TapSpec] = None,
                ivs: Optional[Interventions] = None,
                use_kernels: bool = True,
                step_noise: Optional[torch.Tensor] = None,
                generators: Optional[Sequence[torch.Generator]] = None,
                added_cond: Optional[dict] = None):
        """CFG denoise. context: (2B, S, D) with the unconditional half first
        (B when guidance <= 1, and under LCM); latents: (B, C, h, w), the
        initial noise already scaled by the scheduler's initial sigma.
        Under LCM the step noise is `step_noise` (T, B, C, h, w) where
        given, else drawn from `generators` (one a sample). `added_cond`:
        keyword arguments handed to every UNet call, full, shallow and
        tapped (SDXL's `added_text_embeds` and `added_time_ids`, batched
        as `context`). Returns (final latents (B, C, h, w) in f32, taps with
        (T, ...) leaves or None)."""
        sched = self.scheduler
        timesteps, coeffs = sched.set_timesteps(num_steps)
        is_lcm = isinstance(sched, LCMScheduler)
        do_cfg = guidance_scale > 1.0 and not is_lcm
        b = latents.shape[0]
        tcond = None
        if is_lcm:
            if step_noise is None and generators is None:
                raise ValueError("LCM's denoise needs step_noise or one "
                                 "generator a sample")
            w = torch.full((b,), (guidance_scale - 1.0) * 1000.0,
                           device=self.device)
            tcond = timestep_embedding(w, self.config.unet.time_cond_proj_dim,
                                       flip_sin_to_cos=False,
                                       downscale_freq_shift=1.0)
        v_pred = self.config.prediction_type == "v_prediction"
        if v_pred:
            # f32, as the JAX tables: sqrt(a_t) and sqrt(1 - a_t) at each
            # step's timestep
            acp = sched.tables.alphas_cumprod[timesteps].astype(np.float32)
            v_sqrt_a, v_sqrt_1ma = np.sqrt(acp), np.sqrt(np.float32(1) - acp)
        collect = tap is not None and tap.any()
        dc = self.config.deep_cache_interval
        if dc > 0 and tap is not None:
            raise ValueError(
                "deep_cache_interval > 0 does not support taps: shallow "
                "steps skip the deep layers, so the taps of a step would "
                "lack their statistics")
        deep = None
        state = (sched.init_state(generators or ()) if is_lcm
                 else sched.init_state())
        lat = latents.to(self.device, torch.float32)
        context = context.to(self.device)
        per_step: list[dict] = []
        for i, t in enumerate(timesteps.tolist()):
            lat_in = torch.cat([lat, lat]) if do_cfg else lat
            lat_in = sched.scale_model_input(coeffs, i, lat_in)
            step_taps: dict = {}
            kw = dict(ivs=ivs, step_idx=i, use_kernels=use_kernels,
                      timestep_cond=tcond, **(added_cond or {}))
            if dc > 0 and i % dc == 0:
                # entry 0 is always full, so `deep` is set before its first use
                eps, deep = self.unet(lat_in, t, context, return_deep=True,
                                      **kw)
            elif dc > 0:
                eps = self.unet(lat_in, t, context, deep_feature=deep, **kw)
            else:
                eps = self.unet(lat_in, t, context,
                                tap=tap if collect else None,
                                taps_out=step_taps, **kw)
            if do_cfg:
                eps_u, eps_c = eps.chunk(2)
                eps = eps_u + guidance_scale * (eps_c - eps_u)
            if v_pred:
                eps = float(v_sqrt_a[i]) * eps + float(v_sqrt_1ma[i]) * lat
            if collect and tap.save_eps:
                step_taps["eps"] = {0: eps}
            per_step.append(step_taps)
            if is_lcm:
                state, lat = sched.step(
                    state, coeffs, eps, i, lat,
                    noise=None if step_noise is None else step_noise[i])
            else:
                state, lat = sched.step(state, coeffs, eps, i, lat)
        if not collect:
            return lat, None
        return lat, {stat: {l: torch.stack([s[stat][l] for s in per_step])
                            for l in layers}
                     for stat, layers in per_step[0].items()}

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents -> images (B, 3, H, W) in [0, 1]."""
        images = self.vae_decoder(latents)
        return torch.clamp(images / 2.0 + 0.5, 0.0, 1.0)

    def initial_noise(self, batch: int, generator: torch.Generator
                      ) -> torch.Tensor:
        """The N(0, 1) latents `generate` starts from, (B, C, s, s), drawn
        from `generator` on its own device."""
        cfg = self.config
        s = cfg.sample_size
        return torch.randn((batch, cfg.unet.sample_channels, s, s),
                           generator=generator, device=generator.device)

    def seeded_noise(self, seeds) -> torch.Tensor:
        """Per-request N(0, 1) latents (B, C, s, s): request i's come from
        its own `torch.Generator` on the pipeline's device, seeded with
        seeds[i] alone, so they do not depend on what shares its batch."""
        gens = (torch.Generator(device=self.device).manual_seed(int(sd))
                for sd in seeds)
        return torch.cat([self.initial_noise(1, g) for g in gens])

    def step_generators(self, seeds) -> list[torch.Generator]:
        """LCM's per-request step-noise generators on the pipeline's device:
        request i's seeded with `step_seed(seeds[i])`, from its seed alone
        and apart from the generator of its initial noise."""
        return [torch.Generator(device=self.device).manual_seed(step_seed(sd))
                for sd in seeds]

    # ------------------------------------------------------------------ full
    @torch.no_grad()
    def generate(self, cond_ids: torch.Tensor, uncond_ids: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 num_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None,
                 tap: Optional[TapSpec] = None,
                 ivs: Optional[Interventions] = None,
                 text_ivs: Optional[Interventions] = None,
                 decode: bool = True, seeds=None, mesh=None):
        """Token ids (B, S) -> (images (B, 3, 8s, 8s) in [0, 1], or the final
        latents with decode=False; taps or None). The initial noise comes
        from `generator`, or with `seeds` (B ints, the serving engine's
        determinism contract) from each request's own seed, and is scaled by
        the scheduler's `init_noise_sigma_for(num_steps)` where it has one
        (Euler), else by its `init_noise_sigma`. Under LCM each request's
        step noise comes from a generator of its own: with `seeds`, seeded
        with `step_seed(seeds[i])`; with `generator`, with B draws of
        `generator` made after the initial noise. Text taps add over both
        encodes. With `mesh`, every rank of the mesh makes this call with the
        same arguments (see the module's docstring); B must split over dp,
        and the taps are the whole batch's on every rank."""
        cfg = self.config
        num_steps = num_steps or cfg.num_inference_steps
        g = cfg.guidance_scale if guidance_scale is None else guidance_scale
        part = self.mesh_part(mesh, cond_ids.shape[0])
        latents, generators = self.start_latents(cond_ids.shape[0], generator,
                                                 seeds, num_steps, part)
        cond_ids, uncond_ids = cond_ids[part], uncond_ids[part]
        cond, cond_taps = self.encode_text(cond_ids, tap, text_ivs)
        uncond, text_taps = self.encode_text(uncond_ids, tap, text_ivs)
        if cond_taps and text_taps:
            text_taps = {stat: {l: v + text_taps[stat][l]
                                for l, v in layers.items()}
                         for stat, layers in cond_taps.items()}
        # LCM embeds the guidance scale: the UNet batch is B, as with g <= 1
        context = (cond if self.is_lcm or g <= 1.0
                   else torch.cat([uncond, cond]))
        latents, taps = self.denoise(context, latents, num_steps, g, tap, ivs,
                                     generators=generators)
        if text_taps:
            taps = dict(taps or {}, **text_taps)
        out = self.decode(latents) if decode else latents
        taps = gather_taps(taps, mesh, not (self.is_lcm or g <= 1.0))
        return gather_batch(out, mesh), taps

    def mesh_part(self, mesh, b: int) -> slice:
        """This rank's requests of a batch of `b` under `mesh` (all of
        them without one), the pipeline sharded over its tp axis first."""
        if mesh is None:
            return slice(0, b)
        shard_pipeline(self, mesh)
        return batch_slice(mesh, b)

    @property
    def is_lcm(self) -> bool:
        return isinstance(self.scheduler, LCMScheduler)

    def start_latents(self, b: int, generator: Optional[torch.Generator],
                      seeds, num_steps: int, part: Optional[slice] = None):
        """`generate`'s initial latents (B, C, s, s) on the device, scaled
        by the scheduler's `init_noise_sigma_for(num_steps)` where it has
        one (Euler), else by its `init_noise_sigma`, and under LCM the step
        noise's generators (else None): from `generator`, or with `seeds`
        from each request's own seed (see `generate`). `part`: the requests
        kept (a rank's dp slice): `generator` draws the whole batch's noise
        first, `seeds` are drawn for those requests alone."""
        if (generator is None) == (seeds is None):
            raise ValueError("generate takes a generator or seeds, not both")
        if seeds is not None and len(seeds) != b:
            raise ValueError(f"{len(seeds)} seeds for {b} requests")
        if part is not None and part != slice(0, b):
            if seeds is not None:
                return self.start_latents(part.stop - part.start, None,
                                          list(seeds)[part], num_steps)
            latents, gens = self.start_latents(b, generator, None, num_steps)
            return latents[part], None if gens is None else gens[part]
        sched = self.scheduler
        latents = (self.seeded_noise(seeds) if seeds is not None
                   else self.initial_noise(b, generator))
        scale = getattr(sched, "init_noise_sigma_for", None)
        scale = scale(num_steps) if scale else sched.init_noise_sigma
        latents = latents.to(self.device) * scale
        generators = None
        if self.is_lcm and seeds is not None:
            generators = self.step_generators(seeds)
        elif self.is_lcm:
            draws = torch.randint(0, 2 ** 62, (b,), generator=generator,
                                  device=generator.device).tolist()
            generators = [torch.Generator(device=self.device).manual_seed(d)
                          for d in draws]
        return latents, generators


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """Images (B, 3, H, W) in [0, 1] -> (B, H, W, 3) uint8, on their device."""
    return (images.float() * 255.0).round().clamp(0, 255).to(torch.uint8
                                                             ).permute(0, 2, 3, 1)


def to_pil(images: torch.Tensor) -> list:
    """Images (B, 3, H, W) in [0, 1] -> list of PIL images; the uint8
    conversion runs on the images' device, so the host copy is a quarter of
    the f32 one."""
    from PIL import Image
    return [Image.fromarray(a) for a in to_uint8(images).cpu().numpy()]


def blur_images(images: torch.Tensor, sigma: float = 7.0) -> torch.Tensor:
    """Gaussian blur of (B, 3, H, W) images, the reference's blur-if-nsfw
    output policy (reference: modularity/remove_experts.py:17-22): a
    separable kernel of size 2 round(3 sigma) + 1, zero-padded to the same
    size, rows then columns."""
    size = int(2 * round(3 * sigma) + 1)
    x = torch.arange(size, dtype=torch.float32) - size // 2
    k1d = torch.exp(-0.5 * (x / sigma) ** 2)
    k1d = (k1d / k1d.sum()).to(images.device, images.dtype)
    b, c, h, w = images.shape
    flat = images.reshape(b * c, 1, h, w)
    with f32_convs():
        flat = F.conv2d(flat, k1d.view(1, 1, size, 1), padding=(size // 2, 0))
        flat = F.conv2d(flat, k1d.view(1, 1, 1, size), padding=(0, size // 2))
    return flat.reshape(b, c, h, w)


def stitch_side_by_side(images_a: torch.Tensor, images_b: torch.Tensor
                        ) -> list:
    """Horizontally stitched before/after pairs, the reference's removal
    comparison artifact (reference: modularity/remove_experts.py:47-69)."""
    from PIL import Image
    out = []
    for a, b in zip(to_pil(images_a), to_pil(images_b)):
        canvas = Image.new("RGB", (a.width + b.width, a.height))
        canvas.paste(a, (0, 0))
        canvas.paste(b, (a.width, 0))
        out.append(canvas)
    return out
