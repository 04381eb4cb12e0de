"""External-baseline registry: run any protocol over comparison models
(PyTorch port of `diffusion_models_moe_tpu/benchmarks/baselines.py`).

The reference evaluates erasure against published baselines (UCE, ESD,
Concept-Ablation, Forget-Me-Not, Selective-Amnesia, SLD, SD2/2.1) by
loading their edited checkpoints or other pipelines (reference:
benchmarks/eval_coco.py:70-101, i2p_eval.py:134-194, eval_baselines.py).
Most ship as diffusers-layout SD1.x checkpoints with an edited UNet, so a
baseline is a config preset, a snapshot layout and, for SLD, a generate of
its own. The port's pipelines hold their weights, so `load_baseline`
returns `(pipe with weights loaded, generate_kwargs)`; `baseline_generate`
and `make_protocol_generate` dispatch on the kwargs (SLD through
`pipelines/sld.py:sld_generate`), the latter as `benchmarks/runner.py:
run_eval`'s `generate_fn`.

No baseline weights are in the repository: point `snapshot` (and
`edited_unet` or `delta`) at local copies.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class BaselineSpec:
    """How to build a comparison model.

    kind:
      sd15-edited  diffusers SD1.x layout with an edited or fine-tuned UNet
                   (UCE, ESD, Concept-Ablation, Forget-Me-Not and
                   Selective-Amnesia all publish in this form)
      sd15-sld     stock SD1.4 + Safe Latent Diffusion guidance at generate
      sd2x         SD2/SD2.1 geometry (v-prediction for the 768 variants)
    """
    kind: str
    description: str
    v_prediction: bool = False


BASELINES: dict[str, BaselineSpec] = {
    "uce": BaselineSpec("sd15-edited", "Unified Concept Editing checkpoint"),
    "esd": BaselineSpec("sd15-edited", "Erased Stable Diffusion checkpoint"),
    "concept-ablation": BaselineSpec("sd15-edited",
                                     "Concept Ablation checkpoint"),
    "forget-me-not": BaselineSpec("sd15-edited", "Forget-Me-Not checkpoint"),
    "selective-amnesia": BaselineSpec("sd15-edited",
                                      "Selective Amnesia checkpoint"),
    "sld": BaselineSpec("sd15-sld", "SD1.4 + Safe Latent Diffusion guidance"),
    # the reference's SD2 comparison model is stabilityai/stable-diffusion-2,
    # the 768 v-prediction model (utils.py:91-95 pairs it with Euler; the
    # v-prediction path here runs DDIM or DPM)
    "sd2": BaselineSpec("sd2x", "Stable Diffusion 2 (768, v-pred)",
                        v_prediction=True),
    "sd2-base": BaselineSpec("sd2x", "Stable Diffusion 2 base (512, epsilon)"),
    "sd2.1": BaselineSpec("sd2x", "Stable Diffusion 2.1 (768, v-pred)",
                          v_prediction=True),
    # this framework's own product path: a union-over-timesteps baked
    # checkpoint
    "union-timesteps": BaselineSpec(
        "sd15-edited", "wanda union-over-timesteps baked checkpoint "
                       "(erasure/masks.py:bake_wanda_masks output)"),
}


def load_baseline(name: str, snapshot: str, dtype=torch.bfloat16,
                  edited_unet: Optional[str] = None,
                  delta: Optional[str] = None, config=None, device="cuda"):
    """-> (pipe with its weights loaded, generate_kwargs), the pipeline on
    `device` (the card unless the caller asks for another). `snapshot` is a
    local diffusers-layout directory of the BASE checkpoint (the baselines
    edit SD1.4; reference: eval_coco.py:96-101 builds the pipeline from
    CompVis/stable-diffusion-v1-4 and swaps the UNet); `config` takes the
    place of the preset (SD1.5's, or SD2.1's for the `sd2x` kind).

    `edited_unet`: a whole-UNet state-dict file, the UCE/ESD publishing
    format ('erased-...-method_replace.pt', 'diffusers-nudity-ESDu1-UNET.pt';
    reference: eval_coco.py:70-101, i2p_eval.py:163-168), read by
    `weights/port.py:load_edited_unet_state_dict`; it replaces the
    snapshot's UNet.

    `delta`: a Concept-Ablation delta.bin ({'unet': a partial state dict,
    optional 'text_encoder': a whole one}, `load_delta_bin`), put over the
    base (reference: i2p_eval.py:142-152). Not with `edited_unet`.

    'sd2' is the 768 v-prediction model (the reference's comparison model,
    utils.py:91-95); an SD2-base (512, epsilon) checkpoint is 'sd2-base':
    v-prediction decoding of an epsilon model gives noise without an
    error. The `sd2x` kind reads the snapshot alone, as JAX's."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                sd15_config, sd21_config)
    from diffusion_models_moe_tpu_torch.config import resolve_device
    from diffusion_models_moe_tpu_torch.weights.port import (
        clip_text_state_dict, load_delta_bin, load_edited_unet_state_dict,
        load_pipeline_snapshot, load_unet_state_dict, unet_state_dict)

    dev = resolve_device(device)
    spec = BASELINES[name]
    if spec.kind == "sd2x":
        cfg = config or sd21_config(dtype, v_prediction=spec.v_prediction)
        pipe = StableDiffusionPipeline(cfg, device=dev)
        pipe.load_state_dicts(load_pipeline_snapshot(snapshot, cfg))
        return pipe, {}
    if edited_unet and delta:
        raise ValueError("pass either edited_unet (UCE/ESD whole-UNet file) "
                         "or delta (Concept-Ablation delta.bin), not both")
    if (edited_unet or delta) and spec.kind != "sd15-edited":
        raise ValueError(f"baseline '{name}' ({spec.kind}) does not take an "
                         "edited-UNet checkpoint")
    cfg = config or sd15_config(dtype)
    state = load_pipeline_snapshot(snapshot, cfg)
    if edited_unet:
        state["unet"] = unet_state_dict(load_edited_unet_state_dict(
            edited_unet))
    elif delta:
        bundle = load_delta_bin(delta)
        if "unet" in bundle:
            state["unet"] = load_unet_state_dict(
                os.path.join(snapshot, "unet"), overlay=bundle["unet"])
        if "text_encoder" in bundle:
            state["text_encoder"] = clip_text_state_dict(
                bundle["text_encoder"])
    pipe = StableDiffusionPipeline(cfg, device=dev)
    pipe.load_state_dicts(state)
    if spec.kind == "sd15-sld":
        # protocol runners call sld_generate instead of pipe.generate
        return pipe, {"use_sld": True}
    return pipe, {}


def baseline_generate(pipe, cond_ids, uncond_ids, generator,
                      generate_kwargs: dict, safety_ids=None, **kw):
    """One generate over stock and SLD baselines (the reference's
    eval_baselines dispatch, i2p_eval.py:134-194) -> (images, taps or
    None). SLD baselines need `safety_ids`, the tokenized SLD safety
    concept (`pipelines/sld.py:SAFETY_CONCEPT`)."""
    if generate_kwargs.get("use_sld"):
        from diffusion_models_moe_tpu_torch.pipelines.sld import sld_generate
        if safety_ids is None:
            raise ValueError("SLD baseline needs safety_ids "
                             "(tokenize(pipelines.sld.SAFETY_CONCEPT))")
        return sld_generate(pipe, cond_ids, uncond_ids, safety_ids,
                            generator, **kw), None
    return pipe.generate(cond_ids, uncond_ids, generator, **kw)


def make_protocol_generate(pipe, generate_kwargs: dict, tokenize):
    """`run_eval`'s `generate_fn` for a loaded baseline, or None where the
    stock `pipe.generate` is right. SLD baselines wrap `sld_generate` with
    the tokenized safety concept (the reference evaluates SLD through the
    same benchmark runners, i2p_eval.py:134-194). It refuses `ivs` (a
    comparison model takes no intervention) and passes `seeds` on (the
    port's `sld_generate` takes them; JAX's does not, and its wrapper
    raises). It refuses `mesh`, as JAX's does: `sld_generate` runs on one
    device."""
    if not generate_kwargs.get("use_sld"):
        return None
    from diffusion_models_moe_tpu_torch.pipelines.sld import (SAFETY_CONCEPT,
                                                              sld_generate)
    safety_row = torch.as_tensor(tokenize([SAFETY_CONCEPT]))

    def gen(cond_ids, uncond_ids, generator=None, *, num_steps=None,
            guidance_scale=None, ivs=None, seeds=None, mesh=None, **kw):
        if ivs is not None:
            raise ValueError("the SLD baseline is a comparison model: "
                             "interventions do not apply to it")
        if mesh is not None:
            raise ValueError("the SLD baseline's generate takes no mesh")
        safety = safety_row.to(cond_ids.device).expand(cond_ids.shape[0], -1)
        imgs = sld_generate(pipe, cond_ids, uncond_ids, safety, generator,
                            num_steps=num_steps,
                            guidance_scale=guidance_scale, seeds=seeds)
        return imgs, None

    return gen
