"""Command-line orchestration of the PyTorch port: one typed CLI over the
library, the counterpart of `diffusion_models_moe_tpu/cli.py`, with the
same 18 subcommands, options and defaults:

    python -m diffusion_models_moe_tpu_torch.cli moefy      --snapshot <dir> --out <npz>
    python -m diffusion_models_moe_tpu_torch.cli generate   --snapshot <dir> --prompt "..."
    python -m diffusion_models_moe_tpu_torch.cli serve      --snapshot <dir> --labels <npz>
    python -m diffusion_models_moe_tpu_torch.cli wanda      --snapshot <dir> --concept "Van Gogh" ...
    python -m diffusion_models_moe_tpu_torch.cli ttest      --snapshot <dir> --concept ...
    python -m diffusion_models_moe_tpu_torch.cli remove     --snapshot <dir> --masks <npz> ...
    python -m diffusion_models_moe_tpu_torch.cli bake-union --masks <npz> --ratio 0.3 ...
    python -m diffusion_models_moe_tpu_torch.cli train      --snapshot <dir> --data-dir <dir> ...
    python -m diffusion_models_moe_tpu_torch.cli parity-run --snapshot <dir> --out-dir <dir>

`--snapshot` points at a local diffusers-layout SD1.5 checkpoint, loaded in
bf16; omit it to run the tiny config on weights seeded from
`torch.Generator().manual_seed(0)` (smoke runs without weights; prompts
through the md5 hash tokenizer). Every command runs on the card; `--cpu`
runs everything it builds on the CPU instead, and without it a host with no
CUDA device raises. Nothing falls back to the CPU or to a plain version.

`serve --winograd` reads `DMOE_WINO_FUSED` (1: the fused F(2x2, 3x3)
kernel, `conv_winograd="fused"`) and `DMOE_WINO_TILE` (2 or 4: the tile of
the batched-product formulation, `conv_winograd="1"`) here, once; no module
below the CLI reads the environment. `train --snapshot` keeps f32 masters,
optimizer state and EMA with a bf16 working copy on the card (the attention
kernels run in bf16), an f32 one under `--cpu` (as the JAX CLI's).
Noise comes from the port's own generators: a command's `--seed` is a
request's seed (`generate(seeds=[seed])`), not a JAX `PRNGKey`.

This module imports only the standard library and numpy at its top; each
command imports what it runs, so `--help` loads no model code.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _device(args):
    """The device everything a command builds lives on: the CPU under
    `--cpu`, else the card (raises where no CUDA device is present)."""
    from diffusion_models_moe_tpu_torch.config import resolve_device
    return resolve_device("cpu" if getattr(args, "cpu", False) else "cuda")


def _hash_tokenize(vocab: int, maxlen: int):
    """Deterministic fake tokenizer for snapshot-less (tiny/random-init) runs:
    md5-seeded ids, stable across processes (python's hash() varies with
    PYTHONHASHSEED, which would break resume-by-skip on restart). The
    commands take the same ids as int64 tensors from
    `data/tokenize.py:hash_tokenize`."""
    def tokenize(texts):
        import hashlib
        digest = hashlib.md5("\x00".join(texts).encode()).digest()
        rng = np.random.RandomState(
            int.from_bytes(digest[:4], "little") % (2 ** 31))
        return rng.randint(0, vocab, (len(texts), maxlen)).astype(np.int32)
    return tokenize


def _seeded(module, seed: int):
    """Random weights for a snapshot-less module (a tiny judge tower, the
    tiny VAE encoder), drawn from `torch.Generator().manual_seed(seed)` on
    the host by the port's init scheme (`pipelines/pixart.py:init_module`)."""
    import torch

    from diffusion_models_moe_tpu_torch.pipelines.pixart import init_module
    with torch.no_grad():
        init_module(module, torch.Generator().manual_seed(seed))
    return module


def _winograd_modes() -> dict:
    """`--winograd`'s config fields from DMOE_WINO_FUSED / DMOE_WINO_TILE."""
    if os.environ.get("DMOE_WINO_FUSED", "0") == "1":
        return {"conv_winograd": "fused"}
    return {"conv_winograd": "1",
            "winograd_tile": int(os.environ.get("DMOE_WINO_TILE", "2"))}


def _serving_modes(args) -> dict:
    # opt-in serving modes (outputs differ from bf16 beyond rounding);
    # exposed on the `serve` subcommand; the VAE decoder's convs join them
    modes = {}
    if getattr(args, "int8", False):
        modes["quant_int8"] = True
    if getattr(args, "winograd", False):
        modes.update(_winograd_modes())
    if getattr(args, "deep_cache", 0):
        modes["deep_cache_interval"] = args.deep_cache
    return modes


def _load_pipe(args):
    """-> (pipeline holding its weights, tokenize(texts) -> int64 ids)."""
    import torch

    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                sd15_config, tiny_config)
    from diffusion_models_moe_tpu_torch.data.tokenize import hash_tokenize
    dev = _device(args)
    if args.snapshot:
        from diffusion_models_moe_tpu_torch.data.tokenizer import \
            load_tokenizer
        from diffusion_models_moe_tpu_torch.weights.port import \
            load_pipeline_snapshot
        cfg = sd15_config(torch.bfloat16,
                          relufied=getattr(args, "relufied", False),
                          **_serving_modes(args))
        pipe = StableDiffusionPipeline(cfg, device=dev)
        pipe.load_state_dicts(load_pipeline_snapshot(args.snapshot, cfg))
        tokenize = load_tokenizer(os.path.join(args.snapshot, "tokenizer"),
                                  cfg.text_encoder.max_length)
    else:
        pipe = StableDiffusionPipeline(tiny_config(**_serving_modes(args)),
                                       device=dev)
        pipe.init_params(torch.Generator().manual_seed(0))
        tcfg = pipe.config.text_encoder
        tokenize = hash_tokenize(tcfg.vocab_size, tcfg.max_length)
    return pipe, tokenize


def _moe_ivs(pipe, labels, topk):
    """MoE routing interventions on the pipeline's device, in its UNet's
    dtype (the FF kernel takes the patterns as they are)."""
    from diffusion_models_moe_tpu_torch.moefication.moefy import \
        build_moe_interventions
    return build_moe_interventions(labels, topk, device=pipe.device,
                                   dtype=pipe.config.unet.dtype)


def _removal_ivs(pipe, masks, mode):
    from diffusion_models_moe_tpu_torch.erasure.masks import (
        neuron_removal_interventions, wanda_removal_interventions)
    fn = (wanda_removal_interventions if mode == "wanda"
          else neuron_removal_interventions)
    return fn(masks, device=pipe.device)


def _prompt_pairs(args):
    from diffusion_models_moe_tpu_torch.data.prompts import concept_prompts
    subjects = None
    if getattr(args, "subjects_file", None):
        from diffusion_models_moe_tpu_torch.data.prompts import load_subjects
        subjects = load_subjects(args.subjects_file)
    pairs = concept_prompts(args.concept, subjects=subjects)
    if getattr(args, "limit", 0):
        return pairs.base[:args.limit], pairs.concept[:args.limit]
    return pairs.base, pairs.concept


def _host(x) -> np.ndarray:
    import torch
    return (x.float().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def cmd_moefy(args):
    pipe, _ = _load_pipe(args)
    from diffusion_models_moe_tpu_torch.moefication.moefy import moefy_unet
    labels = moefy_unet(pipe.unet.state_dict(), pipe.config.unet,
                        expert_size=args.expert_size, method=args.method,
                        seed=args.seed, save_path=args.out,
                        device=pipe.device)
    print(json.dumps({k: int(v.max()) + 1 for k, v in labels.items()}))


def cmd_generate(args):
    import torch
    pipe, tokenize = _load_pipe(args)
    from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import \
        to_pil
    ivs = None
    if args.labels:
        from diffusion_models_moe_tpu_torch.moefication.moefy import \
            load_labels
        ivs = _moe_ivs(pipe, load_labels(args.labels), args.topk)
    cond = tokenize([args.prompt])
    uncond = tokenize([""]) if args.snapshot else torch.zeros_like(cond)
    img, _ = pipe.generate(cond, uncond, seeds=[args.seed],
                           num_steps=args.steps, ivs=ivs)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    to_pil(img)[0].save(args.out)
    print(args.out)


def cmd_wanda(args):
    pipe, tokenize = _load_pipe(args)
    from diffusion_models_moe_tpu_torch.analysis.collect import wanda_pipeline
    from diffusion_models_moe_tpu_torch.data.operating_points import \
        wanda_skill_ratio
    from diffusion_models_moe_tpu_torch.erasure.masks import save_masks
    base, adj = _prompt_pairs(args)
    if args.skill_ratio is None:
        # the reference's known-good per-concept ratio (operating_points.py,
        # <- save_union_over_time.py:9-69); 0.05 when the concept has none
        args.skill_ratio = wanda_skill_ratio(args.concept, default=0.05)
    masks = wanda_pipeline(pipe, tokenize, base, adj,
                           skill_ratio=args.skill_ratio, seed=args.seed,
                           num_steps=args.steps, cache_dir=args.cache_dir)
    save_masks(args.out, masks)
    total = sum(int(m.sum()) for m in masks.values())
    print(json.dumps({"out": args.out, "skilled_entries": total,
                      "skill_ratio": args.skill_ratio}))


def cmd_ttest(args):
    pipe, tokenize = _load_pipe(args)
    from diffusion_models_moe_tpu_torch.analysis.collect import (
        collect_predictivity, t_test_pipeline)
    from diffusion_models_moe_tpu_torch.erasure.masks import save_masks
    base, adj = _prompt_pairs(args)
    pred = collect_predictivity(pipe, tokenize, base, adj, seed=args.seed,
                                num_steps=args.steps)
    if args.save_predictivity:
        pred.save(args.save_predictivity)
    masks = t_test_pipeline(pred, conf=args.conf)
    save_masks(args.out, masks)
    total = sum(int(m.sum()) for m in masks.values())
    print(json.dumps({"out": args.out, "skilled_neurons": total}))


def cmd_remove(args):
    pipe, tokenize = _load_pipe(args)
    from diffusion_models_moe_tpu_torch.benchmarks.runner import (
        EvalRunConfig, run_eval)
    from diffusion_models_moe_tpu_torch.erasure.masks import load_masks
    ivs = _removal_ivs(pipe, load_masks(args.masks), args.mode)
    base, adj = _prompt_pairs(args)
    cfg = EvalRunConfig(out_dir=args.out_dir, batch_size=args.batch,
                        num_steps=args.steps, seed=args.seed)
    print(json.dumps(run_eval(pipe, tokenize, adj, cfg, ivs=ivs)))


def cmd_bake_union(args):
    pipe, _ = _load_pipe(args)
    from diffusion_models_moe_tpu_torch.erasure.masks import (
        bake_wanda_masks, load_masks, union_over_timesteps)
    from diffusion_models_moe_tpu_torch.weights.export import save_safetensors
    # masks are stored in reference (T, D, H) orientation (wanda_pipeline)
    static = union_over_timesteps(load_masks(args.masks), args.ratio)
    baked = bake_wanda_masks(pipe.unet.state_dict(), pipe.config.unet, static)
    save_safetensors(baked, args.out)
    print(json.dumps({"out": args.out,
                      "pruned": {str(l): int(m.sum())
                                 for l, m in static.items()}}))


def cmd_sparsity(args):
    pipe, tokenize = _load_pipe(args)
    from diffusion_models_moe_tpu_torch.analysis.sparsity import \
        measure_sparsity
    base, _ = _prompt_pairs(args) if args.concept else (
        ["a photo of a cat"], None)
    res = measure_sparsity(pipe, tokenize, base, seed=args.seed,
                           num_steps=args.steps, out_path=args.out)
    print(json.dumps({str(l): float(np.mean(v)) for l, v in res.items()}))


def cmd_expert_freq(args):
    import torch
    pipe, tokenize = _load_pipe(args)
    from diffusion_models_moe_tpu_torch.moefication.moefy import load_labels
    from diffusion_models_moe_tpu_torch.taps import TapSpec
    ivs = _moe_ivs(pipe, load_labels(args.labels), args.topk)
    base, _ = _prompt_pairs(args) if args.concept else (
        ["a photo of a cat"], None)
    counts = None
    for prompt in base:
        cond = tokenize([prompt])
        _, taps = pipe.generate(cond, torch.zeros_like(cond),
                                seeds=[args.seed], num_steps=args.steps,
                                tap=TapSpec(expert_freq=True), ivs=ivs,
                                decode=False)
        freq = {l: _host(v) for l, v in taps["expert_freq"].items()}
        counts = freq if counts is None else {
            l: counts[l] + freq[l] for l in counts}
    out = {str(l): (v / len(base)).tolist() for l, v in counts.items()}
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(args.out)


def cmd_eval_gen(args):
    """Batched eval generation with resume-by-skip (eval_coco/i2p/artist
    shape)."""
    pipe, tokenize = _load_pipe(args)
    from diffusion_models_moe_tpu_torch.benchmarks.runner import (
        EvalRunConfig, run_eval)
    ivs = None
    if args.masks:
        from diffusion_models_moe_tpu_torch.erasure.masks import load_masks
        ivs = _removal_ivs(pipe, load_masks(args.masks), args.mode)
    if args.prompts_csv:
        from diffusion_models_moe_tpu_torch.data.coco import load_prompt_csv
        prompts, seeds = load_prompt_csv(args.prompts_csv)
    elif args.coco_root:
        from diffusion_models_moe_tpu_torch.data.coco import coco_dataset
        prompts, _ = coco_dataset(args.coco_root, args.n_samples,
                                  seed=args.seed)
        seeds = None
    else:
        _, adj = _prompt_pairs(args)
        prompts, seeds = adj, None
    cfg = EvalRunConfig(out_dir=args.out_dir, batch_size=args.batch,
                        num_steps=args.steps or 50, seed=args.seed,
                        per_prompt_seeds=seeds,
                        save_baseline=not args.no_baseline)
    print(json.dumps(run_eval(pipe, tokenize, prompts, cfg, ivs=ivs)))


def _clip_featurizer(clip_snapshot, dev):
    """The CLIP image featurizer: the ViT-L/14 tower ported from a full
    CLIPModel snapshot, else a seeded tiny tower (a smoke-test judge)."""
    from diffusion_models_moe_tpu_torch.benchmarks.fid import \
        make_clip_featurizer
    from diffusion_models_moe_tpu_torch.models.clip_vision import (
        CLIPVisionConfig, CLIPVisionEncoder, tiny_vision_config)
    if clip_snapshot:
        from diffusion_models_moe_tpu_torch.weights.port_vision import \
            port_clip_vision
        cfg = CLIPVisionConfig()
        enc = CLIPVisionEncoder(cfg, device=dev)
        enc.load_state_dict(port_clip_vision(clip_snapshot, cfg))
    else:
        enc = _seeded(CLIPVisionEncoder(tiny_vision_config(), device=dev), 0)
    return make_clip_featurizer(enc.eval())


def _clip_text_tower(snapshot, tcfg, dev):
    """The text tower of a full CLIPModel snapshot (`text_model.*` of its
    model.safetensors) as the port's `CLIPTextEncoder` on `dev`."""
    import torch

    from diffusion_models_moe_tpu_torch.models.clip_text import \
        CLIPTextEncoder
    from diffusion_models_moe_tpu_torch.weights.port import (
        clip_text_state_dict, load_safetensors)
    sd = load_safetensors(os.path.join(snapshot, "model.safetensors"))
    with torch.device(dev):
        enc = CLIPTextEncoder(tcfg).eval()
    enc.load_state_dict(clip_text_state_dict(
        {k: v for k, v in sd.items() if k.startswith("text_model.")}))
    return enc


def cmd_score_dirs(args):
    """FID + perceptual distance between sd_/removed_ directories."""
    from diffusion_models_moe_tpu_torch.benchmarks.scores import (
        clip_perceptual_distance, fid_between_dirs, perceptual_between_dirs)
    dev = _device(args)
    featurize = _clip_featurizer(args.clip_snapshot, dev)
    fid = fid_between_dirs(args.a_dir, args.b_dir, featurize)
    if bool(args.lpips_alexnet) != bool(args.lpips_lins):
        # one flag alone would silently fall back to the CLIP-distance metric
        # the user did not ask for
        raise SystemExit("LPIPS needs BOTH --lpips-alexnet and --lpips-lins")
    if args.lpips_alexnet and args.lpips_lins:
        from diffusion_models_moe_tpu_torch.benchmarks.scores import \
            load_native_lpips
        dist = load_native_lpips(args.lpips_alexnet, args.lpips_lins,
                                 device=dev)
    else:
        dist = clip_perceptual_distance(featurize)
    perc = perceptual_between_dirs(args.a_dir, args.b_dir, dist)
    print(json.dumps({"fid": fid, "perceptual": perc}))


def _dp_mesh(args):
    """With `--dp` under a process group of more than one rank (torchrun):
    the (dp = world size, tp = 1) mesh, every rank running the command."""
    if not args.dp:
        return None
    from diffusion_models_moe_tpu_torch.parallel.distributed import \
        init_multihost
    from diffusion_models_moe_tpu_torch.parallel.mesh import create_mesh
    n = init_multihost(device=_device(args).type)["process_count"]
    return create_mesh(dp=n, tp=1) if n > 1 else None


def cmd_protocol(args):
    """Flagship protocols end-to-end on the shipped dataset assets
    (benchmarks/protocols.py; reference: i2p_eval / inference_mem /
    artist_removal CLIs)."""
    from diffusion_models_moe_tpu_torch.benchmarks import protocols as proto

    mesh = _dp_mesh(args)
    generate_fn = None
    if args.baseline:
        # comparison-model mode (reference: eval_baselines.py + the baseline
        # rows of i2p_eval/eval_coco): the protocol runs over a registered
        # baseline checkpoint instead of the default SD1.5 + interventions
        if not args.snapshot:
            raise SystemExit("--baseline needs --snapshot (the baseline's "
                             "diffusers-layout checkpoint)")
        from diffusion_models_moe_tpu_torch.benchmarks.baselines import (
            load_baseline, make_protocol_generate)
        from diffusion_models_moe_tpu_torch.data.tokenizer import \
            load_tokenizer
        pipe, gkw = load_baseline(args.baseline, args.snapshot,
                                  device=_device(args))
        tokenize = load_tokenizer(os.path.join(args.snapshot, "tokenizer"),
                                  pipe.config.text_encoder.max_length)
        generate_fn = make_protocol_generate(pipe, gkw, tokenize)
    else:
        pipe, tokenize = _load_pipe(args)
    dev = pipe.device
    ivs = None
    if args.masks and args.name != "unified":
        # 'unified' parses --masks itself ("name=path,..." per-concept bank)
        from diffusion_models_moe_tpu_torch.erasure.masks import load_masks
        ivs = _removal_ivs(pipe, load_masks(args.masks), "wanda")
    common = dict(ivs=ivs, limit=args.limit or None,
                  num_steps=args.steps or 50, batch_size=args.batch,
                  mesh=mesh, generate_fn=generate_fn)

    def clip_featurize():
        return _clip_featurizer(args.clip_snapshot, dev)

    if args.name == "i2p":
        from diffusion_models_moe_tpu_torch.benchmarks.nudity import (
            load_nudenet, load_nudenet_native)
        if args.judge == "none":
            raise SystemExit("i2p needs a NudeNet judge (--judge PATH)")
        if args.judge.endswith(".onnx"):
            # native path: YOLOv8 forward + in-repo ONNX porter
            detector = load_nudenet_native(args.judge, device=dev)
        else:
            detector = load_nudenet(args.judge, device=dev)
        out = proto.i2p_protocol(pipe, tokenize, args.out_dir, detector,
                                 variant=args.variant, **common)
    elif args.name == "memorize":
        feat = clip_featurize()
        out = proto.memorization_protocol(
            pipe, tokenize, args.out_dir, feat,
            split=args.split if args.split != "" else "", **common)
    elif args.name == "artists":
        text_feat = None
        if args.clip_snapshot:
            # full CLIPModel snapshot: build the text tower + projection so
            # removal accuracy uses the reference's cos(text, image) protocol
            from diffusion_models_moe_tpu_torch.benchmarks.fid import \
                make_clip_text_featurizer
            from diffusion_models_moe_tpu_torch.weights.port_vision import (
                clip_b32_text_config, port_clip_text_projection)
            text_feat = make_clip_text_featurizer(
                _clip_text_tower(args.clip_snapshot, clip_b32_text_config(),
                                 dev),
                tokenize, port_clip_text_projection(args.clip_snapshot))
        out = proto.artist_removal_protocol(
            pipe, tokenize, args.out_dir, clip_featurize(),
            n_artists=args.n_artists, part=args.part, seed=args.seed,
            text_featurize=text_feat, **common)
    elif args.name == "objects":
        classify = _protocol_classifier(args, pipe, tokenize, clip_featurize)
        out = proto.object_erasure_protocol(
            pipe, tokenize, args.out_dir, classify,
            target=args.concept or "parachute", **common)
    elif args.name == "debias":
        from diffusion_models_moe_tpu_torch.benchmarks.debias import \
            debias_eval
        from diffusion_models_moe_tpu_torch.data.prompts import professions
        feat = clip_featurize()
        man, woman = _class_embeddings(args, pipe, tokenize, feat,
                                       ["a photo of a man",
                                        "a photo of a woman"])
        profs = professions()
        if args.limit:
            profs = profs[:args.limit]
        out = debias_eval(
            pipe, tokenize, feat, man, woman, ivs,
            seeds=range(args.seed, args.seed + (args.limit or 4)),
            professions=profs, num_steps=args.steps or 50,
            out_path=os.path.join(args.out_dir, "debias_results.json"))
    elif args.name == "unified":
        out = _unified(args, pipe, tokenize)
    else:
        raise SystemExit(f"unknown protocol {args.name}")
    print(json.dumps(out))


def _unified(args, pipe, tokenize):
    """Router benchmark (reference: benchmarks/unified_editing.py):
    per-prompt CLIP concept checkers -> union of fired concepts' masks."""
    import torch

    from diffusion_models_moe_tpu_torch.benchmarks.clip_metrics import (
        ConceptChecker, pooled_text_embedding)
    from diffusion_models_moe_tpu_torch.benchmarks.unified_editing import (
        ConceptBank, unified_editing_eval)
    from diffusion_models_moe_tpu_torch.erasure.masks import load_masks
    if not args.masks or "=" not in args.masks:
        raise SystemExit(
            'protocol unified needs --masks "name=path.npz,name2=..."')
    bank_masks = {}
    for pair in args.masks.split(","):
        name, path = pair.split("=", 1)
        bank_masks[name.strip()] = load_masks(path.strip())

    def text_embed(texts):
        ids = torch.as_tensor(tokenize(list(texts))).to(pipe.device)
        hidden, _ = pipe.encode_text(ids)
        proj = torch.eye(hidden.shape[-1], dtype=torch.float32)
        return _host(pooled_text_embedding(hidden.float(), ids, proj))

    anchor = text_embed([args.anchor])[0]
    checkers = {name: ConceptChecker(name, text_embed([name])[0], anchor,
                                     margin=args.margin)
                for name in bank_masks}
    bank = ConceptBank(checkers=checkers, masks=bank_masks)
    if args.prompts_file:
        from diffusion_models_moe_tpu_torch.data.coco import load_prompt_csv
        prompts, _ = load_prompt_csv(args.prompts_file)
    else:
        prompts = [f"a painting in the style of {n}"
                   for n in bank_masks] + ["a photo of a dog"]
    if args.limit:
        prompts = prompts[:args.limit]
    return unified_editing_eval(pipe, tokenize, prompts, text_embed(prompts),
                                bank, args.out_dir,
                                num_steps=args.steps or 50, seed=args.seed)


def _class_embeddings(args, pipe, tokenize, featurize, texts):
    """Class embeddings for zero-shot judging, in the image featurizer's space:
    from --class-embs .npz (real CLIP text embeddings matching a real CLIP
    vision tower), or a clearly-degraded fallback — featurize one baseline
    generation per class prompt as its anchor (dimensionally consistent in any
    config; smoke path, NOT the CLIP joint space)."""
    if getattr(args, "class_embs", None):
        data = np.load(args.class_embs)
        return [data[k] for k in data.files]
    out = []
    uncond = tokenize([""])
    for i, t in enumerate(texts):
        img, _ = pipe.generate(tokenize([t]), uncond, seeds=[10_000 + i],
                               num_steps=min(args.steps or 50, 8))
        out.append(_host(featurize(img))[0])
    return out


def _protocol_classifier(args, pipe, tokenize, clip_featurize):
    """images -> logits judge for the objects protocol: native ResNet-50 when
    --judge points at a torchvision state dict, else zero-shot CLIP over the
    class list."""
    if args.judge and args.judge != "none":
        from diffusion_models_moe_tpu_torch.benchmarks.object_erase import \
            make_resnet_classifier
        return make_resnet_classifier(args.judge, device=pipe.device)
    from diffusion_models_moe_tpu_torch.benchmarks.object_erase import \
        make_clip_zero_shot_classifier
    from diffusion_models_moe_tpu_torch.data.prompts import erasing_objects
    feat = clip_featurize()
    embs = _class_embeddings(args, pipe, tokenize, feat,
                             [f"a photo of a {c}" for c in erasing_objects()])
    return make_clip_zero_shot_classifier(feat, np.stack(embs))


def cmd_train(args):
    """ReLUfication fine-tune from an imagefolder — the CLI front door to the
    reference's `accelerate launch train_relufied_sd.py` (SURVEY.md §2.8).
    Data: --data-dir with metadata.{csv,jsonl} (HF imagefolder layout,
    data/ingest.py); model: a diffusers snapshot (--snapshot, VAE encoder
    included) or the tiny random-init config for smoke runs. The UNet
    module is the working copy of the f32 masters (training/train.py): bf16
    on the card, f32 under --cpu."""
    import dataclasses

    import torch

    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                sd15_config, tiny_config)
    from diffusion_models_moe_tpu_torch.data.ingest import imagefolder_batches
    from diffusion_models_moe_tpu_torch.data.tokenize import hash_tokenize
    from diffusion_models_moe_tpu_torch.training.train import TrainConfig
    from diffusion_models_moe_tpu_torch.training.trainer import (
        RunConfig, build_vae_encoder, train_relufied)

    dev = _device(args)
    if args.snapshot:
        from diffusion_models_moe_tpu_torch.data.tokenizer import \
            load_tokenizer
        from diffusion_models_moe_tpu_torch.weights.port import \
            load_pipeline_snapshot
        dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
        cfg = sd15_config(dtype, relufied=True)
        sds = load_pipeline_snapshot(args.snapshot, cfg,
                                     include_vae_encoder=True)
        pipe = StableDiffusionPipeline(cfg, device=dev)
        pipe.load_state_dicts(sds)
        vae_encoder = build_vae_encoder(pipe, sds.pop("vae_encoder"))
        del sds
        tokenize = load_tokenizer(os.path.join(args.snapshot, "tokenizer"),
                                  cfg.text_encoder.max_length)
    else:
        cfg = tiny_config()
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, ff_activation="geglu-relu"))
        pipe = StableDiffusionPipeline(cfg, device=dev)
        pipe.init_params(torch.Generator().manual_seed(0))
        vae_encoder = _seeded(build_vae_encoder(pipe), 2)
        tokenize = hash_tokenize(cfg.text_encoder.vocab_size,
                                 cfg.text_encoder.max_length)

    downsample = 2 ** (len(cfg.vae.block_out_channels) - 1)
    resolution = args.resolution or (512 if args.snapshot else 8 * downsample)
    batches = imagefolder_batches(
        args.data_dir, tokenize, batch_size=args.batch,
        caption_col=args.caption_col, resolution=resolution, seed=args.seed,
        center_crop=args.center_crop)
    tcfg = TrainConfig(
        learning_rate=args.lr, use_ema=args.ema, ft_method=args.ft_method,
        snr_gamma=args.snr_gamma, lr_schedule=args.lr_schedule,
        lr_warmup_steps=args.warmup_steps, max_train_steps=args.max_steps,
        grad_accum_steps=args.grad_accum, optimizer=args.optimizer,
        noise_offset=args.noise_offset,
        input_perturbation=args.input_perturbation,
        prediction_type=args.prediction_type)
    rcfg = RunConfig(out_dir=args.out_dir, max_steps=args.max_steps,
                     checkpoint_every=args.checkpoint_every,
                     log_every=args.log_every, resume=not args.no_resume,
                     validation_every=args.validation_every)
    validation_fn = None
    if args.validation_every > 0:
        from diffusion_models_moe_tpu_torch.training.trainer import \
            make_validation_logger
        validation_fn = make_validation_logger(
            pipe, tokenize, [args.validation_prompt],
            os.path.join(args.out_dir, "validation"))
    state = train_relufied(pipe, tcfg, rcfg, batches, vae_encoder=vae_encoder,
                           validation_fn=validation_fn)
    print(json.dumps({"steps": int(state.step), "out_dir": args.out_dir}))


def cmd_vqa(args):
    """Multiple-choice VLM scoring over before/after removal image
    directories — the reference's LLAVAScorer loop (mod_utils.py:195-290).
    `--judge` is an HF llava-1.5 snapshot run natively on the card
    (benchmarks/vqa.py:load_llava_native), or any transformers
    image-text-to-text checkpoint with `--judge-kind transformers`."""
    from PIL import Image

    from diffusion_models_moe_tpu_torch.benchmarks.vqa import (
        MultipleChoiceScorer, load_llava_native, load_qwen2vl_native,
        load_transformers_vqa)

    dev = _device(args)
    if args.judge_kind == "transformers":
        vqa = load_transformers_vqa(args.judge, device=dev)
    else:
        loader = (load_qwen2vl_native if args.judge_kind == "qwen"
                  else load_llava_native)
        mesh = None
        if args.tp > 1:
            from diffusion_models_moe_tpu_torch.parallel.distributed import \
                init_multihost
            from diffusion_models_moe_tpu_torch.parallel.mesh import \
                create_mesh
            init_multihost(device=dev.type)
            mesh = create_mesh(tp=args.tp)
        vqa = loader(args.judge, mesh=mesh, quant_int8=args.int8, device=dev)
    objects = [o.strip() for o in args.objects.split(",")]

    def load_dir(d):
        names = sorted(f for f in os.listdir(d)
                       if f.lower().endswith((".png", ".jpg", ".jpeg")))
        if len(names) != len(objects):
            raise SystemExit(f"{d}: {len(names)} images for "
                             f"{len(objects)} objects")
        return [np.asarray(Image.open(os.path.join(d, f)).convert("RGB"))
                for f in names]

    scorer = MultipleChoiceScorer(vqa, objects, args.concept)
    for before, d, label in ((True, args.before_dir, args.label_before),
                             (False, args.after_dir, args.label_after)):
        if d is None:
            continue
        # batched decode when the judge supports it (native LLaVA/Qwen)
        scorer.score_images(load_dir(d), label, before=before)
    results = scorer.get_results()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results))


def cmd_iqa(args):
    """CLIP-IQA quality/concept report over three image directories (base /
    concept / after-removal) — the reference's clip_score.py scorer
    (modularity/clip_score.py:85-140), natively on the CLIP towers."""
    import torch

    from diffusion_models_moe_tpu_torch.benchmarks.fid import \
        make_clip_text_featurizer
    from diffusion_models_moe_tpu_torch.benchmarks.protocols import \
        clip_iqa_protocol

    def load_dir(d):
        from PIL import Image
        names = sorted(f for f in os.listdir(d)
                       if f.lower().endswith((".png", ".jpg", ".jpeg")))
        if not names:
            raise SystemExit(f"no images in {d}")
        out = []
        for f in names:
            img = Image.open(os.path.join(d, f)).convert("RGB")
            # uniform size so mixed-size dirs stack; the CLIP featurizer
            # resizes to its input size anyway
            if img.size != (224, 224):
                img = img.resize((224, 224), Image.BILINEAR)
            out.append(torch.from_numpy(
                np.asarray(img, np.float32) / 255.0).permute(2, 0, 1))
        return out

    dev = _device(args)
    image_f = _clip_featurizer(args.clip_snapshot, dev)
    if args.clip_snapshot:
        from diffusion_models_moe_tpu_torch.config import CLIPTextConfig
        from diffusion_models_moe_tpu_torch.data.tokenizer import \
            load_tokenizer
        from diffusion_models_moe_tpu_torch.weights.port_vision import \
            port_clip_text_projection
        tcfg = CLIPTextConfig()
        # full-CLIPModel snapshots (the layout port_clip_vision reads) keep
        # vocab.json/merges.txt at the snapshot ROOT, not a tokenizer/ subdir
        text_f = make_clip_text_featurizer(
            _clip_text_tower(args.clip_snapshot, tcfg, dev),
            load_tokenizer(args.clip_snapshot, tcfg.max_length),
            text_projection=port_clip_text_projection(args.clip_snapshot))
    else:
        # seeded tiny towers: structure smoke test, not a real judge
        from diffusion_models_moe_tpu_torch import tiny_config
        from diffusion_models_moe_tpu_torch.data.tokenize import \
            hash_tokenize
        from diffusion_models_moe_tpu_torch.models.clip_text import \
            CLIPTextEncoder
        from diffusion_models_moe_tpu_torch.models.clip_vision import \
            tiny_vision_config
        tcfg = tiny_config().text_encoder
        with torch.device(dev):
            tenc = _seeded(CLIPTextEncoder(tcfg).eval(), 1)
        proj = np.asarray(np.random.RandomState(2).randn(
            tcfg.hidden_size, tiny_vision_config().projection_dim),
            np.float32)
        text_f = make_clip_text_featurizer(
            tenc, hash_tokenize(tcfg.vocab_size, tcfg.max_length),
            text_projection=proj)
    report = clip_iqa_protocol(load_dir(args.base_dir),
                               load_dir(args.concept_dir),
                               load_dir(args.removed_dir),
                               image_f, text_f, concept=args.concept,
                               out_dir=args.out_dir)
    print(json.dumps(report))


def _module_keys(build) -> set:
    """The state-dict keys of a module built on the meta device (no memory)."""
    import torch
    with torch.device("meta"):
        return set(build().state_dict())


def _checked(sd: dict, keys: set, what: str) -> dict:
    """`sd` where it holds every one of `keys`; KeyError naming the first
    missing ones otherwise (a file the module cannot load)."""
    missing = sorted(keys - set(sd))
    if missing:
        raise KeyError(f"{what}: {len(missing)} keys missing, e.g. "
                       f"{missing[:3]}")
    return sd


def cmd_check_snapshot(args):
    """Snapshot doctor: validate a local diffusers-layout checkpoint BEFORE a
    long port/eval run. Porting fidelity is the framework's #1 hard part
    (SURVEY.md §7); this surfaces missing files, key drift (exact UNet
    state-dict key diff against the expected topology), and — with --deep —
    runs the port's readers component by component, each held to the key
    set of its module at the --kind topology. Header shapes come from the
    port's own safetensors reader, without loading tensors."""
    from diffusion_models_moe_tpu_torch import (sd15_config, sd21_config,
                                                sdxl_config)
    from diffusion_models_moe_tpu_torch.weights import _safetensors

    _device(args)
    cfg = {"sd15": sd15_config, "sd21": sd21_config,
           "sdxl": sdxl_config}[args.kind]()
    report = {"snapshot": args.snapshot, "kind": args.kind, "components": {}}

    # --- file presence + tensor counts -----------------------------------
    expected_files = {
        "unet": "unet/diffusion_pytorch_model.safetensors",
        "vae": "vae/diffusion_pytorch_model.safetensors",
        "text_encoder": "text_encoder/model.safetensors",
        "tokenizer": "tokenizer/vocab.json",
    }
    if args.kind == "sdxl":
        expected_files["text_encoder_2"] = "text_encoder_2/model.safetensors"
        expected_files["tokenizer_2"] = "tokenizer_2/vocab.json"
    for name, rel in expected_files.items():
        p = os.path.join(args.snapshot, rel)
        entry = {"path": rel, "present": os.path.exists(p)}
        if entry["present"] and rel.endswith(".safetensors"):
            entry["n_tensors"] = len(_safetensors.header(p))
        report["components"][name] = entry

    # --- exact UNet key census -------------------------------------------
    unet_entry = report["components"]["unet"]
    expected = None
    if unet_entry["present"] or getattr(args, "baseline_unet", None):
        from diffusion_models_moe_tpu_torch.models.unet import \
            UNet2DCondition
        expected = _module_keys(lambda: UNet2DCondition(cfg.unet))
    if unet_entry["present"]:
        u = cfg.unet
        shapes = _safetensors.header(os.path.join(args.snapshot,
                                                  expected_files["unet"]))
        got = set(shapes)
        unet_entry["missing_keys"] = sorted(expected - got)
        unet_entry["unexpected_keys"] = sorted(got - expected)
        unet_entry["keys_ok"] = not unet_entry["missing_keys"]
        # sentinel SHAPES: key names are identical between sd15 and sd21
        # (same topology), so a wrong --kind passes the census; the
        # cross-attention K projection's in-dim and conv_in's channel counts
        # disambiguate (sd15: 768, sd21: 1024, sdxl: 2048)
        checks = {}
        s = shapes.get("down_blocks.0.attentions.0.transformer_blocks.0"
                       ".attn2.to_k.weight")
        if s is not None:
            checks["cross_attention_dim"] = {
                "got": s[1], "expected": u.cross_attention_dim}
        s = shapes.get("conv_in.weight")
        if s is not None:
            checks["sample_channels"] = {
                "got": s[1], "expected": u.sample_channels}
            checks["block_out_channels[0]"] = {
                "got": s[0], "expected": u.block_out_channels[0]}
        unet_entry["shape_checks"] = checks
        unet_entry["shapes_ok"] = all(c["got"] == c["expected"]
                                      for c in checks.values())

    # --- deep: run the port's readers --------------------------------------
    if args.deep:
        _deep_check(args, cfg, report)

    # --- baseline edited-UNet file (UCE/ESD publishing format) ------------
    if getattr(args, "baseline_unet", None):
        from diffusion_models_moe_tpu_torch.weights.port import (
            load_edited_unet_state_dict, unet_state_dict, validate_edited_unet)
        entry = validate_edited_unet(args.baseline_unet, cfg.unet,
                                     expected_keys=expected)
        if args.deep and entry.get("keys_ok", entry.get("load_ok")):
            try:
                sd = unet_state_dict(load_edited_unet_state_dict(
                    args.baseline_unet))
                entry["ported_params"] = int(sum(t.numel()
                                                 for t in sd.values()))
                entry["port_ok"] = True
            except Exception as e:  # noqa: BLE001 — doctor reports
                entry["port_ok"] = False
                entry["port_error"] = f"{type(e).__name__}: {str(e)[:200]}"
        report["components"]["baseline_unet"] = entry

    report["ok"] = all(c.get("present", True) and c.get("keys_ok", True)
                       and c.get("shapes_ok", True) and c.get("port_ok", True)
                       and c.get("load_ok", True)
                       for c in report["components"].values())
    print(json.dumps(report, indent=2))
    return report


def _deep_check(args, cfg, report) -> None:
    """--deep: each component read by the port's reader and held to the
    key set of its module at the --kind topology; `ported_params` counts
    the entries read."""
    from diffusion_models_moe_tpu_torch.models.clip_text import \
        CLIPTextEncoder
    from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
    from diffusion_models_moe_tpu_torch.models.vae import (VAEDecoder,
                                                           VAEEncoder)
    from diffusion_models_moe_tpu_torch.weights.port import (
        clip_text_state_dict, load_clip_text_state_dict, load_safetensors,
        load_unet_state_dict, vae_decoder_state_dict, vae_encoder_state_dict)
    snap = args.snapshot
    vae_file = os.path.join(snap, "vae", "diffusion_pytorch_model.safetensors")
    vae_sd = {}   # one read serves both VAE sides

    def vae_state():
        if not vae_sd:
            vae_sd["sd"] = load_safetensors(vae_file)
        return vae_sd["sd"]

    def unet():
        return _checked(load_unet_state_dict(os.path.join(snap, "unet")),
                        _module_keys(lambda: UNet2DCondition(cfg.unet)),
                        "unet")

    def text(sub, tcfg, sd=None):
        sd = sd if sd is not None else load_clip_text_state_dict(
            os.path.join(snap, sub))
        return _checked(sd, _module_keys(lambda: CLIPTextEncoder(tcfg)), sub)

    porters = {
        "unet": unet,
        "text_encoder": lambda: text("text_encoder", cfg.text_encoder),
        "vae": lambda: _checked(vae_decoder_state_dict(vae_state()),
                                _module_keys(lambda: VAEDecoder(cfg.vae)),
                                "vae"),
        "vae_encoder": lambda: _checked(
            vae_encoder_state_dict(vae_state()),
            _module_keys(lambda: VAEEncoder(cfg.vae)), "vae_encoder"),
    }
    if args.kind == "sdxl":
        from diffusion_models_moe_tpu_torch.config import sdxl_text_configs
        _, tc2 = sdxl_text_configs()

        def text_2():
            sd = load_safetensors(os.path.join(snap, "text_encoder_2",
                                               "model.safetensors"))
            sd.pop("text_projection.weight")
            return text("text_encoder_2", tc2, clip_text_state_dict(sd))
        porters["text_encoder_2"] = text_2
    for name, fn in porters.items():
        entry = report["components"].setdefault(name, {})
        try:
            sd = fn()
            entry["ported_params"] = int(sum(t.numel() for t in sd.values()))
            entry["port_ok"] = True
        except Exception as e:  # noqa: BLE001 — doctor reports, not raises
            entry["port_ok"] = False
            entry["port_error"] = f"{type(e).__name__}: {str(e)[:200]}"


def cmd_create_datasets(args):
    """The reference's benchmarks/create_datasets.py:1-18 as a subcommand:
    artwork CSV (artist -> concept) + I2P prompts (concept='naked') ->
    combined_prompts.csv."""
    from diffusion_models_moe_tpu_torch.data.prompts import \
        combine_prompt_datasets
    n = combine_prompt_datasets(args.artwork_csv, args.i2p_file, args.out)
    print(json.dumps({"rows": n, "out": args.out}))
    return 0


# mode -> (the JAX package's environment knobs, DeepCache interval, tier
# rel-err bound): exact modes must be bit-identical (1e-6); exact-tier
# kernel modes sit at dtype-rounding scale (0.02 covers bf16 end-to-end);
# DeepCache modes approximate but must stay far under the ~1.4
# decorrelated floor. The port has no environment knobs: `_mode_fields`
# maps each knob onto the config fields that give the same path.
MODE_KNOBS: dict = {
    "pad_proj": ({"DMOE_PAD_PROJ": "1"}, 0, 1e-6),
    "dc3": ({"DMOE_PAD_PROJ": "0"}, 3, 0.5),
    "dc3_pad": ({"DMOE_PAD_PROJ": "1"}, 3, 0.5),
    "fff_pad": ({"DMOE_PAD_PROJ": "1", "DMOE_FF_FUSED": "1"}, 0, 0.02),
    "chain_pad": ({"DMOE_PAD_PROJ": "1", "DMOE_CONV_CHAIN": "1"}, 0, 0.02),
    "chain16_pad": ({"DMOE_PAD_PROJ": "1", "DMOE_CONV_CHAIN": "1",
                     "DMOE_CHAIN_SHAPES": "16"}, 0, 0.02),
    "winof_pad": ({"DMOE_PAD_PROJ": "1", "DMOE_WINOGRAD": "1",
                   "DMOE_WINO_FUSED": "1"}, 0, 0.02),
    "attnabs_pad": ({"DMOE_PAD_PROJ": "1", "DMOE_ATTN_ABSORB": "1"}, 0, 0.02),
    "attnabs_fff_pad": ({"DMOE_PAD_PROJ": "1", "DMOE_ATTN_ABSORB": "1",
                         "DMOE_FF_FUSED": "1"}, 0, 0.02),
    "dc3_fff_pad": ({"DMOE_PAD_PROJ": "1", "DMOE_FF_FUSED": "1"}, 3, 0.5),
    "dc3_attnabs_fff_pad": ({"DMOE_PAD_PROJ": "1", "DMOE_ATTN_ABSORB": "1",
                             "DMOE_FF_FUSED": "1"}, 3, 0.5),
}


def _mode_fields(knobs: dict, dc: int) -> dict:
    """A mode's knobs as the port's config fields. DMOE_PAD_PROJ and
    DMOE_CHAIN_SHAPES are TPU layout knobs with no counterpart (they add
    nothing); DMOE_FF_FUSED is the path the port takes anyway (kernel 1
    wherever its predicate admits the shape)."""
    fields = {}
    if knobs.get("DMOE_CONV_CHAIN") == "1":
        fields["conv_chain"] = True
    if knobs.get("DMOE_WINOGRAD") == "1":
        fields["conv_winograd"] = ("fused" if knobs.get("DMOE_WINO_FUSED")
                                   == "1" else "1")
    if knobs.get("DMOE_ATTN_ABSORB") == "1":
        fields["attn_absorb"] = "1"
    if dc:
        fields["deep_cache_interval"] = dc
    return fields


def _mode_pipeline(pipe, fields: dict):
    """A fresh pipeline with the serving-mode `fields` and `pipe`'s
    weights, on its device."""
    import dataclasses

    from diffusion_models_moe_tpu_torch import StableDiffusionPipeline
    cfg = pipe.config
    unet_f = {k: v for k, v in fields.items()
              if k in ("conv_chain", "conv_winograd", "attn_absorb")}
    vae_f = {k: v for k, v in fields.items() if k == "conv_winograd"}
    cfg = dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, **unet_f),
        vae=dataclasses.replace(cfg.vae, **vae_f),
        deep_cache_interval=fields.get("deep_cache_interval",
                                       cfg.deep_cache_interval))
    out = StableDiffusionPipeline(cfg, device=pipe.device)
    out.load_state_dicts({k: m.state_dict()
                          for k, m in pipe.modules().items()})
    return out


def cmd_parity_run(args):
    """The snapshot-gated acceptance run (BASELINE.json criterion: 'CLIP/FID
    parity after expert removal'). ONE command executes the reference's
    product flow end to end — moefy -> wanda skilled neurons at the concept's
    operating point -> removal eval -> union-over-timesteps bake -> scores —
    and writes {out_dir}/PARITY_RUN.md + parity_run.json with provenance.

    Runs against the tiny random-init model (omit --snapshot; machinery
    checks only, images are noise), or the real acceptance against a local
    SD1.5 snapshot (reference real-weights flow: utils.py:64-138;
    operating points: benchmarks/artist_removal.py best_ckpt_dict /
    eval_coco.py:40-60)."""
    import time

    import torch

    pipe, tokenize = _load_pipe(args)
    real = bool(args.snapshot)
    concept = args.concept or "Van Gogh"
    steps = args.steps or (50 if real else 4)
    out = args.out_dir
    os.makedirs(out, exist_ok=True)
    report: dict = {
        "concept": concept, "real_weights": real, "num_steps": steps,
        "snapshot": args.snapshot, "ts_unix": int(time.time()),
        "commit": _git_rev(), "seed": args.seed,
    }

    # ---- 1. moefy: cluster FFNs into experts --------------------------------
    from diffusion_models_moe_tpu_torch.moefication.moefy import moefy_unet
    labels_path = os.path.join(out, "labels.npz")
    # default expert size: the reference's 20 at SD dims; 16 divides every
    # tiny-config FF width (128..512) for the dbg run
    expert_size = (args.expert_size if args.expert_size is not None
                   else (20 if real else 16))
    labels = moefy_unet(pipe.unet.state_dict(), pipe.config.unet,
                        expert_size=expert_size, seed=args.seed,
                        save_path=labels_path, device=pipe.device)
    report["moefy"] = {"labels": labels_path,
                       "experts_per_layer": {str(k): int(v.max()) + 1
                                             for k, v in labels.items()}}

    # routing smoke: expert_freq tap under MoE interventions
    from diffusion_models_moe_tpu_torch.taps import TapSpec
    cond0 = tokenize([f"a painting in the style of {concept}"])
    zeros0 = torch.zeros_like(cond0)
    _, taps = pipe.generate(cond0, zeros0, seeds=[args.seed],
                            num_steps=steps, ivs=_moe_ivs(pipe, labels, 0.3),
                            tap=TapSpec(expert_freq=True), decode=False)
    freq0 = _host(next(iter(taps["expert_freq"].values())))
    report["moefy"]["routing_active_experts_l0"] = int((freq0 > 0).sum())

    # ---- 2. wanda skilled neurons at the operating point --------------------
    from diffusion_models_moe_tpu_torch.analysis.collect import wanda_pipeline
    from diffusion_models_moe_tpu_torch.data.operating_points import (
        union_select_ratio, wanda_skill_ratio)
    base, adj = _prompt_pairs(args)
    skill_ratio = (args.skill_ratio if args.skill_ratio is not None
                   else wanda_skill_ratio(concept, default=0.05))
    masks = wanda_pipeline(pipe, tokenize, base, adj,
                           skill_ratio=skill_ratio, seed=args.seed,
                           num_steps=steps,
                           cache_dir=os.path.join(out, "norm_cache"))
    from diffusion_models_moe_tpu_torch.erasure.masks import (
        bake_wanda_masks, save_masks, union_over_timesteps)
    masks_path = os.path.join(out, "wanda_masks.npz")
    save_masks(masks_path, masks)
    report["wanda"] = {
        "masks": masks_path, "skill_ratio": skill_ratio,
        "skilled_entries": int(sum(int(m.sum()) for m in masks.values())),
        "prompts": len(base)}

    # ---- 3. removal eval: baseline + removed image pairs --------------------
    from diffusion_models_moe_tpu_torch.benchmarks.runner import (
        EvalRunConfig, run_eval)
    img_dir = os.path.join(out, "images")
    stats = run_eval(pipe, tokenize, adj,
                     EvalRunConfig(out_dir=img_dir, batch_size=args.batch,
                                   num_steps=steps, seed=args.seed),
                     ivs=_removal_ivs(pipe, masks, "wanda"))
    report["eval"] = stats

    # ---- 4. union-over-timesteps bake + bake==dynamic parity ----------------
    union_ratio = (args.union_ratio if args.union_ratio is not None
                   else union_select_ratio(concept, default=0.3))
    static = union_over_timesteps(masks, union_ratio)
    own = pipe.unet.state_dict()
    baked = bake_wanda_masks(own, pipe.config.unet, static)
    from diffusion_models_moe_tpu_torch.weights.export import save_safetensors
    baked_path = os.path.join(out, "baked_unet.safetensors")
    save_safetensors(baked, baked_path)
    # machinery parity: the baked checkpoint must reproduce the dynamic
    # static-union intervention on a fixed seed (the reference's
    # bake-then-check, save_union_over_time.py:243-276)
    ivs_static = _removal_ivs(pipe, static, "wanda")
    lat_dyn, _ = pipe.generate(cond0, zeros0, seeds=[args.seed + 1],
                               num_steps=steps, ivs=ivs_static, decode=False)
    changed = {k: own[k].clone() for k in baked if baked[k] is not own[k]}
    pipe.unet.load_state_dict(baked)
    try:
        lat_baked, _ = pipe.generate(cond0, zeros0, seeds=[args.seed + 1],
                                     num_steps=steps, decode=False)
    finally:
        pipe.unet.load_state_dict(changed, strict=False)
    del own, baked, changed
    a, b = lat_dyn.double(), lat_baked.double()
    bake_max_abs = float((a - b).abs().max())
    bake_rel = float((b - a).norm() / (a.norm() + 1e-12))
    # bf16 real runs accumulate rounding over 50 steps; fp32 tiny is ~1e-5
    bake_tol = 1e-4 if pipe.config.unet.dtype == torch.float32 else 0.1
    report["bake"] = {"baked_unet": baked_path, "union_ratio": union_ratio,
                      "pruned": {str(l): int(m.sum())
                                 for l, m in static.items()},
                      "bake_vs_dynamic_max_abs": bake_max_abs,
                      "bake_vs_dynamic_rel": bake_rel,
                      "parity_ok": bake_max_abs < bake_tol}

    # ---- 5. scores: CLIP-feature FID + perceptual distance ------------------
    from diffusion_models_moe_tpu_torch.benchmarks.scores import (
        clip_perceptual_distance, fid_between_dirs, perceptual_between_dirs)
    clip_snap = getattr(args, "clip_snapshot", None)
    featurize = _clip_featurizer(clip_snap, pipe.device)
    fid = fid_between_dirs(img_dir, img_dir, featurize)
    perc = perceptual_between_dirs(img_dir, img_dir,
                                   clip_perceptual_distance(featurize))
    report["scores"] = {"clip_fid_base_vs_removed": fid,
                        "clip_perceptual_base_vs_removed": perc,
                        "clip_featurizer": ("ported" if clip_snap
                                            else "tiny-random (dbg)")}

    # ---- 6. serving-mode A/B: the acceptance run also covers the serving
    # leg it will be judged under — fixed-seed latent deltas of --mode vs the
    # exact path, same intervention and seed -----------------------------------
    mode = getattr(args, "mode", None)
    if mode:
        if mode not in MODE_KNOBS:
            raise SystemExit(f"--mode must be one of {list(MODE_KNOBS)}")
        knobs, dc, tier_bound = MODE_KNOBS[mode]
        fields = _mode_fields(knobs, dc)
        pipe_m = _mode_pipeline(pipe, fields)
        lat_m, _ = pipe_m.generate(cond0, zeros0, seeds=[args.seed + 1],
                                   num_steps=steps, ivs=ivs_static,
                                   decode=False)
        del pipe_m
        a, m_ = lat_dyn.double(), lat_m.double()
        rel = float((m_ - a).norm() / (a.norm() + 1e-12))
        mse = float(((m_ - a) ** 2).mean())
        report["serving_mode"] = {
            "mode": mode, "knobs": knobs, "config_fields": fields,
            "deep_cache": dc,
            "latent_rel_err_vs_exact": round(rel, 6),
            "latent_mse_vs_exact": mse,
            "tier_bound": tier_bound,
            "tier_ok": bool(rel <= tier_bound),
            "note": ("serving-leg quality vs the exact path on the SAME "
                     "removal intervention, seed and steps; the port maps "
                     "the JAX package's knobs onto its config fields")}

    report["acceptance"] = {
        "bake_parity_ok": report["bake"]["parity_ok"],
        "pipeline_complete": True,
        "real_weights_run": real,
        "note": ("compare scores against the reference's operating table "
                 "(BASELINE.md) — this was a REAL-weights run" if real else
                 "dbg mode: random weights — machinery verified, image "
                 "quality metrics are not meaningful; re-run with "
                 "--snapshot the day a local SD1.5 snapshot exists"),
    }

    with open(os.path.join(out, "parity_run.json"), "w") as f:
        json.dump(report, f, indent=1)
    _write_parity_md(os.path.join(out, "PARITY_RUN.md"), report)
    print(json.dumps(report["acceptance"]))
    return report


def _git_rev() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10).stdout.strip()
    except Exception:
        return ""


def _write_parity_md(path: str, r: dict) -> None:
    import datetime
    ts = datetime.datetime.fromtimestamp(r["ts_unix"],
                                         datetime.timezone.utc).isoformat()
    mode = ("REAL WEIGHTS" if r["real_weights"]
            else "dbg (tiny random-init — machinery check only)")
    lines = [
        "# Parity run",
        "",
        f"- concept: **{r['concept']}**  |  mode: **{mode}**",
        f"- commit `{r['commit']}`  |  {ts}  |  steps {r['num_steps']}  |  "
        f"seed {r['seed']}",
        f"- snapshot: `{r['snapshot']}`",
        "",
        "| stage | key result |",
        "|---|---|",
        f"| moefy | experts/layer {list(r['moefy']['experts_per_layer'].values())[:4]}…, "
        f"{r['moefy']['routing_active_experts_l0']} experts active (L0) |",
        f"| wanda | skill_ratio {r['wanda']['skill_ratio']}, "
        f"{r['wanda']['skilled_entries']} skilled entries over "
        f"{r['wanda']['prompts']} prompt pairs |",
        f"| removal eval | {r['eval']} |",
        f"| bake | union_ratio {r['bake']['union_ratio']}, "
        f"max&#124;baked−dynamic&#124; = {r['bake']['bake_vs_dynamic_max_abs']:.2e}, "
        f"rel L2 {r['bake']['bake_vs_dynamic_rel']:.2e} "
        f"→ parity_ok={r['bake']['parity_ok']} |",
        f"| scores | CLIP-FID(base, removed) = "
        f"{r['scores']['clip_fid_base_vs_removed']:.4f}, perceptual mean = "
        f"{r['scores']['clip_perceptual_base_vs_removed']['mean']:.4f} "
        f"over n={r['scores']['clip_perceptual_base_vs_removed']['n']} "
        f"({r['scores']['clip_featurizer']}) |",
    ]
    if "serving_mode" in r:
        sm = r["serving_mode"]
        lines.append(
            f"| serving mode | {sm['mode']}: latent rel-err vs exact = "
            f"{sm['latent_rel_err_vs_exact']} (same intervention/seed) |")
    lines += [
        "",
        f"**Acceptance:** {r['acceptance']['note']}",
        "",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def cmd_serve(args):
    """Line-oriented serving loop over the batched engine (serving.py):
    stdin lines `seed<TAB>prompt` (or just `prompt`), PNGs written to
    --out-dir, one result line per request on stdout. A transport-agnostic
    front door: wrap it in whatever RPC layer the deployment uses."""
    import queue as _queue
    import sys
    import threading

    from PIL import Image

    pipe, tokenize = _load_pipe(args)
    from diffusion_models_moe_tpu_torch.serving import ServingEngine
    ivs = None
    if args.labels:
        from diffusion_models_moe_tpu_torch.moefication.moefy import \
            load_labels
        ivs = _moe_ivs(pipe, load_labels(args.labels), args.topk)
    os.makedirs(args.out_dir, exist_ok=True)
    eng = ServingEngine(pipe, tokenize, batch_size=args.batch,
                        num_steps=args.steps or 50, ivs=ivs,
                        max_wait_ms=args.max_wait_ms)

    # Results stream as they complete (a request/response client must not wait
    # for stdin EOF), and completed images never accumulate unboundedly: the
    # writer drains futures in submit order while stdin is still open.
    done_q: "_queue.Queue" = _queue.Queue()

    def _writer():
        while True:
            item = done_q.get()
            if item is None:
                return
            fut, path = item
            try:
                Image.fromarray(fut.result()).save(path)
                print(path, flush=True)
            except Exception as e:
                print(f"ERROR {path}: {e}", flush=True)

    n = 0
    with eng:
        wt = threading.Thread(target=_writer, daemon=True)
        wt.start()
        for line in sys.stdin:
            line = line.rstrip("\n")
            if not line:
                continue
            seed_s, _, prompt = line.partition("\t")
            if not prompt:
                seed_s, prompt = str(args.seed), seed_s
            try:
                seed = int(seed_s)
            except ValueError:
                print(f"ERROR bad seed {seed_s!r} (line: {line[:80]!r})",
                      flush=True)
                continue
            path = os.path.join(args.out_dir, f"img_{n:05d}.png")
            done_q.put((eng.submit(prompt, seed=seed), path))
            n += 1
        done_q.put(None)
        wt.join()
    print(json.dumps({"served": eng.stats.requests,
                      "batches": eng.stats.batches,
                      "mean_fill": round(eng.stats.mean_fill, 3),
                      "images_per_second":
                          round(eng.stats.images_per_second, 4)}))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="diffusion_models_moe_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp, concept=False):
        sp.add_argument("--snapshot", default=None)
        sp.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card (smoke "
                             "tests)")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--steps", type=int, default=None)
        sp.add_argument("--relufied", action="store_true")
        if concept:
            sp.add_argument("--concept", default=None)
            sp.add_argument("--subjects-file", default=None)
            sp.add_argument("--limit", type=int, default=0)

    sp = sub.add_parser("moefy"); common(sp)
    sp.add_argument("--expert-size", type=int, default=20)
    sp.add_argument("--method", default="sinkhorn")
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_moefy)

    sp = sub.add_parser("generate"); common(sp)
    sp.add_argument("--prompt", required=True)
    sp.add_argument("--labels", default=None)
    sp.add_argument("--topk", type=float, default=0.3)
    sp.add_argument("--out", default="out.png")
    sp.set_defaults(fn=cmd_generate)

    sp = sub.add_parser("serve"); common(sp)
    sp.add_argument("--batch", type=int, default=8)
    sp.add_argument("--max-wait-ms", type=float, default=50.0)
    sp.add_argument("--labels", default=None)
    sp.add_argument("--topk", type=float, default=0.3)
    sp.add_argument("--out-dir", default="served")
    sp.add_argument("--int8", action="store_true",
                    help="int8 W8A8 serving mode (outputs differ from bf16)")
    sp.add_argument("--winograd", action="store_true",
                    help="Winograd 3x3-conv serving mode (DMOE_WINO_FUSED=1 "
                         "for the fused F(2x2,3x3) kernel, else "
                         "DMOE_WINO_TILE=4 for F(4x4,3x3); composes with "
                         "--int8)")
    sp.add_argument("--deep-cache", type=int, default=0, metavar="N",
                    help="DeepCache serving mode: full UNet every N-th step, "
                         "cached-deep-feature shallow forward otherwise "
                         "(approximate; composes with --int8/--winograd)")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("wanda"); common(sp, concept=True)
    sp.add_argument("--skill-ratio", type=float, default=None,
                    help="top fraction of Wanda columns per (t,l); defaults "
                         "to the reference's per-concept operating point "
                         "(data/operating_points.py), else 0.05")
    sp.add_argument("--cache-dir", default=None)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_wanda)

    sp = sub.add_parser("ttest"); common(sp, concept=True)
    sp.add_argument("--conf", type=float, default=0.05)
    sp.add_argument("--save-predictivity", default=None)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_ttest)

    sp = sub.add_parser("remove"); common(sp, concept=True)
    sp.add_argument("--masks", required=True)
    sp.add_argument("--mode", choices=["neurons", "wanda"], default="wanda")
    sp.add_argument("--batch", type=int, default=4)
    sp.add_argument("--out-dir", required=True)
    sp.set_defaults(fn=cmd_remove)

    sp = sub.add_parser("bake-union"); common(sp)
    sp.add_argument("--masks", required=True)
    sp.add_argument("--ratio", type=float, default=0.3)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_bake_union)

    sp = sub.add_parser("sparsity"); common(sp, concept=True)
    sp.add_argument("--out", default=None)
    sp.set_defaults(fn=cmd_sparsity)

    sp = sub.add_parser("expert-freq"); common(sp, concept=True)
    sp.add_argument("--labels", required=True)
    sp.add_argument("--topk", type=float, default=0.3)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_expert_freq)

    sp = sub.add_parser("eval-gen"); common(sp, concept=True)
    sp.add_argument("--masks", default=None)
    sp.add_argument("--mode", choices=["neurons", "wanda"], default="wanda")
    sp.add_argument("--prompts-csv", default=None)
    sp.add_argument("--coco-root", default=None)
    sp.add_argument("--n-samples", type=int, default=100)
    sp.add_argument("--batch", type=int, default=4)
    sp.add_argument("--no-baseline", action="store_true")
    sp.add_argument("--out-dir", required=True)
    sp.set_defaults(fn=cmd_eval_gen)

    sp = sub.add_parser("score-dirs")
    sp.add_argument("--a-dir", required=True)
    sp.add_argument("--b-dir", required=True)
    sp.add_argument("--clip-snapshot", default=None)
    # native LPIPS (models/backbones.py): torchvision alexnet + lpips lin heads
    sp.add_argument("--lpips-alexnet", default=None)
    sp.add_argument("--lpips-lins", default=None)
    sp.set_defaults(fn=cmd_score_dirs)

    sp = sub.add_parser("protocol"); common(sp, concept=True)
    sp.add_argument("name", choices=["i2p", "memorize", "artists", "objects",
                                     "debias", "unified"])
    sp.add_argument("--out-dir", required=True)
    sp.add_argument("--masks", default=None,
                    help="wanda mask npz to apply as the intervention")
    sp.add_argument("--batch", type=int, default=4)
    sp.add_argument("--dp", action="store_true",
                    help="shard batches over the ranks of the process group "
                         "(torchrun)")
    sp.add_argument("--variant", default="", help="i2p prompt-file variant")
    sp.add_argument("--split", default="", help="memorize split (0-19)")
    sp.add_argument("--n-artists", type=int, default=100)
    sp.add_argument("--part", type=int, default=1)
    sp.add_argument("--judge", default="none",
                    help="NudeNet path (i2p; a .onnx file runs the native "
                         "detector on the card) / ResNet-50 state dict "
                         "(objects)")
    sp.add_argument("--clip-snapshot", default=None)
    sp.add_argument("--class-embs", default=None,
                    help=".npz of class text embeddings in the featurizer's "
                         "space (objects/debias zero-shot judges)")
    sp.add_argument("--prompts-file", default=None,
                    help="prompt CSV for 'unified' (combined artists+i2p)")
    sp.add_argument("--baseline", default=None,
                    help="run over a registry baseline (uce/esd/sld/sd2/...)"
                         " loaded from --snapshot (benchmarks/baselines.py)")
    sp.add_argument("--anchor", default="a photo",
                    help="no-concept anchor text for 'unified' checkers")
    sp.add_argument("--margin", type=float, default=0.0,
                    help="checker margin for 'unified'")
    sp.set_defaults(fn=cmd_protocol)

    sp = sub.add_parser("vqa")
    sp.add_argument("--judge", required=True,
                    help="llava-1.5 snapshot (native judge on the card) or "
                         "transformers checkpoint path")
    sp.add_argument("--judge-kind", default="native",
                    choices=["native", "qwen", "transformers"],
                    help="native = llava-1.5 on the card, qwen = Qwen2-VL on "
                         "the card, transformers = any local "
                         "image-text-to-text model")
    sp.add_argument("--before-dir", default=None)
    sp.add_argument("--after-dir", default=None)
    sp.add_argument("--objects", required=True,
                    help="comma-separated ground-truth object per image "
                         "(sorted filename order)")
    sp.add_argument("--concept", required=True,
                    help="style/gender/scene question key (e.g. 'Van Gogh')")
    sp.add_argument("--label-before", type=int, default=2,
                    help="expected 1-based option before removal "
                         "(2 = concept present)")
    sp.add_argument("--label-after", type=int, default=1)
    sp.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel the judge LM over this many ranks "
                         "of the process group (torchrun)")
    sp.add_argument("--int8", action="store_true",
                    help="W8A8 judge LM projections")
    sp.add_argument("--out", default=None)
    sp.add_argument("--cpu", action="store_true")
    sp.set_defaults(fn=cmd_vqa)

    sp = sub.add_parser("iqa")
    sp.add_argument("--base-dir", required=True)
    sp.add_argument("--concept-dir", required=True)
    sp.add_argument("--removed-dir", required=True)
    sp.add_argument("--concept", required=True,
                    help="per-concept test-prompt key (e.g. 'Van Gogh')")
    sp.add_argument("--out-dir", default=None)
    sp.add_argument("--clip-snapshot", default=None)
    sp.add_argument("--cpu", action="store_true")
    sp.set_defaults(fn=cmd_iqa)

    sp = sub.add_parser("check-snapshot")
    sp.add_argument("--snapshot", required=True)
    sp.add_argument("--kind", default="sd15", choices=["sd15", "sd21", "sdxl"])
    sp.add_argument("--cpu", action="store_true")
    sp.add_argument("--deep", action="store_true",
                    help="run the port's readers component by component")
    sp.add_argument("--baseline-unet", default=None,
                    help="also validate an edited-UNet state-dict file "
                         "(the UCE/ESD publishing format: .pt/.bin/"
                         ".safetensors) against the --kind topology")
    sp.set_defaults(fn=cmd_check_snapshot)

    sp = sub.add_parser(
        "create-datasets",
        help="merge an artwork-prompts CSV with an I2P prompt list into one "
             "combined eval CSV (reference: benchmarks/create_datasets.py)")
    sp.add_argument("--artwork-csv", required=True)
    sp.add_argument("--i2p-file", required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_create_datasets)

    sp = sub.add_parser(
        "parity-run",
        help="snapshot-gated acceptance run: moefy->wanda->remove->bake->"
             "score in one command, writes PARITY_RUN.md")
    common(sp, concept=True)
    sp.add_argument("--out-dir", required=True)
    sp.add_argument("--batch", type=int, default=4)
    sp.add_argument("--expert-size", type=int, default=None,
                    help="default 20 (real) / 16 (dbg tiny)")
    sp.add_argument("--skill-ratio", type=float, default=None,
                    help="default: the concept's reference operating point")
    sp.add_argument("--union-ratio", type=float, default=None,
                    help="default: the concept's reference select_ratio")
    sp.add_argument("--clip-snapshot", default=None,
                    help="ported CLIP vision tower for real FID/perceptual")
    sp.add_argument("--mode", default=None,
                    help="also A/B one serving mode vs the exact path "
                         f"({'|'.join(MODE_KNOBS)})")
    sp.set_defaults(fn=cmd_parity_run)

    sp = sub.add_parser("train"); common(sp)
    sp.add_argument("--data-dir", required=True,
                    help="imagefolder with metadata.{csv,jsonl}")
    sp.add_argument("--out-dir", required=True)
    sp.add_argument("--caption-col", default="text")
    sp.add_argument("--resolution", type=int, default=None,
                    help="default 512 (snapshot) / tiny-native (random init)")
    sp.add_argument("--batch", type=int, default=4)
    sp.add_argument("--lr", type=float, default=1e-5)
    sp.add_argument("--max-steps", type=int, default=1000)
    sp.add_argument("--checkpoint-every", type=int, default=500)
    sp.add_argument("--log-every", type=int, default=50)
    sp.add_argument("--warmup-steps", type=int, default=0)
    sp.add_argument("--lr-schedule", default="constant",
                    choices=["constant", "cosine", "linear"])
    # kept in sync with training.train.FT_METHODS (tests/test_torch_cli.py
    # asserts it; a live import here would drag torch into `--help`)
    sp.add_argument("--ft-method", default="full",
                    choices=["full", "attention", "norm", "bias", "ff",
                             "norm_bias", "norm_bias_attention"])
    sp.add_argument("--snr-gamma", type=float, default=None)
    sp.add_argument("--grad-accum", type=int, default=1)
    sp.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    sp.add_argument("--ema", action="store_true")
    sp.add_argument("--noise-offset", type=float, default=0.0)
    sp.add_argument("--input-perturbation", type=float, default=0.0)
    sp.add_argument("--prediction-type", default="epsilon",
                    choices=["epsilon", "v_prediction"])
    sp.add_argument("--validation-every", type=int, default=0,
                    help="generate a validation image every N steps")
    sp.add_argument("--validation-prompt", default="a photo of a dog")
    sp.add_argument("--center-crop", action="store_true")
    sp.add_argument("--no-resume", action="store_true")
    sp.set_defaults(fn=cmd_train)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
