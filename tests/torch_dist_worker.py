"""Rank functions of the port's tests at world size 2 over gloo
(`tests/test_torch_parallel_gloo.py`).

A spawned child re-imports the module of its target, so this module imports
neither JAX nor a test module. `launch(case, tmp_dir)` spawns two ranks of
`CASES[case]` on one torch thread each, joined through a `file://` store in
`tmp_dir`, and returns each rank's result dict. Every case first computes
the world-size-1 result in the same process (no mesh, no collective), then
the same work over the mesh.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import time

import numpy as np
import torch

WORLD = 2
DEADLINE_S = 300.0


def launch(case: str, tmp_dir: str) -> list:
    """`CASES[case]` on WORLD ranks over gloo; each rank's result dict.
    Raises where a rank raised or the ranks did not end in DEADLINE_S."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(case, tmp_dir), nprocs=WORLD,
                             join=False, start_method="spawn")
    end = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=5.0):
        if time.monotonic() > end:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{case}: ranks still running after "
                               f"{DEADLINE_S} s")
    return [torch.load(os.path.join(tmp_dir, f"{case}_{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


def _rank_main(rank: int, case: str, tmp_dir: str) -> None:
    import torch.distributed as dist

    from diffusion_models_moe_tpu_torch.parallel.distributed import \
        init_multihost
    torch.set_num_threads(1)
    info = init_multihost(f"file://{tmp_dir}/{case}_store", WORLD, rank,
                          backend="gloo", device="cpu")
    try:
        out = CASES[case](rank, tmp_dir)
        out["info"] = info
        torch.save(out, os.path.join(tmp_dir, f"{case}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------- helpers
def _labels(ff_dims, expert: int = 8, seed: int = 0) -> dict:
    from diffusion_models_moe_tpu_torch.taps import layer_name
    rng = np.random.RandomState(seed)
    return {layer_name(i): rng.permutation(np.arange(4 * d) % (4 * d // expert))
            for i, d in enumerate(ff_dims)}


def _sd_pipe(cfg=None):
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                tiny_config)
    pipe = StableDiffusionPipeline(cfg or tiny_config(), device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    return pipe


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _launch_counts() -> dict:
    from diffusion_models_moe_tpu_torch.ops import _build
    return dict(_build.LAUNCHES)


# ------------------------------------------------------------------- cases
def _all_taps():
    from diffusion_models_moe_tpu_torch.taps import TapSpec
    return TapSpec(**{f.name: True for f in dataclasses.fields(TapSpec)})


TAPS = _all_taps()


def case_generate(rank: int, tmp_dir: str) -> dict:
    """SD1.5-tiny with MoE routing: generate at dp=2 (a generator and
    seeds) and at tp=2, with every tap too; the serving engine at tp=2;
    run_eval at dp=2."""
    from diffusion_models_moe_tpu_torch import build_moe_interventions
    from diffusion_models_moe_tpu_torch.benchmarks.runner import (
        EvalRunConfig, run_eval)
    from diffusion_models_moe_tpu_torch.data.tokenize import \
        per_prompt_hash_tokenize
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.parallel.mesh import create_mesh
    from diffusion_models_moe_tpu_torch.serving import ServingEngine
    pipe = _sd_pipe()
    cfg = pipe.config
    ivs = build_moe_interventions(_labels(cfg.unet.ff_dims()), 0.3,
                                  device="cpu")
    tc = cfg.text_encoder
    cond = torch.randint(0, tc.vocab_size, (4, tc.max_length),
                         generator=_gen(1))
    uncond = torch.zeros_like(cond)
    kw = dict(num_steps=2, ivs=ivs)
    out = {"ref": pipe.generate(cond, uncond, _gen(2), **kw)[0],
           "ref_seeds": pipe.generate(cond, uncond, seeds=[5, 6, 7, 8],
                                      **kw)[0],
           "taps_ref": pipe.generate(cond, uncond, _gen(2), tap=TAPS,
                                     **kw)[1]}
    tok = per_prompt_hash_tokenize(tc.vocab_size, tc.max_length)
    prompts = [f"prompt {i}" for i in range(3)]
    with ServingEngine(pipe, tok, batch_size=2, num_steps=2, ivs=ivs) as eng:
        out["serve_ref"] = eng.generate_sync(prompts, [11, 12, 13])
    eval_pipe = _sd_pipe()
    ecfg = EvalRunConfig(os.path.join(tmp_dir, f"eval_ref_{rank}"),
                         batch_size=2, num_steps=2)
    run_eval(eval_pipe, tok, prompts, ecfg, ivs=ivs)

    dp = create_mesh(2, dp=2)
    out["dp"] = pipe.generate(cond, uncond, _gen(2), mesh=dp, **kw)[0]
    out["dp_seeds"] = pipe.generate(cond, uncond, seeds=[5, 6, 7, 8],
                                    mesh=dp, **kw)[0]
    try:
        pipe.generate(cond[:3], uncond[:3], _gen(2), mesh=dp, **kw)
        out["odd_batch"] = "accepted"
    except ValueError as e:
        out["odd_batch"] = str(e)
    out["taps_dp"] = pipe.generate(cond, uncond, _gen(2), mesh=dp, tap=TAPS,
                                   **kw)[1]
    # run_eval at dp=2: every PNG written once, by rank 0
    from PIL import Image
    saves = []
    save = Image.Image.save

    def counted(img, fp, *a, **k):
        saves.append(os.path.basename(str(fp)))
        return save(img, fp, *a, **k)
    Image.Image.save = counted
    try:
        edir = os.path.join(tmp_dir, "eval_dp")
        out["eval_summary"] = run_eval(eval_pipe, tok, prompts,
                                       dataclasses.replace(ecfg, out_dir=edir),
                                       ivs=ivs, mesh=dp)
        # a rerun reads the same resume state on every rank: all skipped
        out["eval_rerun"] = run_eval(eval_pipe, tok, prompts,
                                     dataclasses.replace(ecfg, out_dir=edir),
                                     ivs=ivs, mesh=dp)
    finally:
        Image.Image.save = save
    out["eval_saves"] = saves

    tp = create_mesh(2, tp=2)
    _build.reset_launch_counts()
    out["tp"] = pipe.generate(cond, uncond, _gen(2), mesh=tp, **kw)[0]
    out["tp_launches"] = _launch_counts()
    out["taps_tp"] = pipe.generate(cond, uncond, _gen(2), mesh=tp, tap=TAPS,
                                   **kw)[1]
    out["heads"] = [m.heads for m in pipe.unet.modules()
                    if type(m).__name__ == "Attention"]
    with ServingEngine(pipe, tok, batch_size=2, num_steps=2, ivs=ivs,
                       mesh=tp) as eng:
        if rank == 0:
            out["serve_alone"] = eng.generate_sync(prompts[:1], [11])
            out["serve_tp"] = eng.generate_sync(prompts, [11, 12, 13])
        else:
            try:
                eng.submit("x")
                out["follower_submit"] = "accepted"
            except RuntimeError as e:
                out["follower_submit"] = str(e)
    out["serve_stats"] = dataclasses.asdict(eng.stats)
    return out


def _tiny_sdxl():
    """The tiny SDXL geometry of tests/test_sdxl_pipeline.py (a copy)."""
    from diffusion_models_moe_tpu_torch import config as pcfg
    unet = pcfg.UNetConfig(
        block_out_channels=(16, 32, 64),
        down_block_types=("plain", "cross", "cross"),
        up_block_types=("cross", "cross", "plain"),
        transformer_layers_per_block=(0, 2, 2),
        attention_head_dim=(2, 4, 8), cross_attention_dim=48,
        norm_num_groups=8, addition_embed_dim=32, addition_time_embed_dim=8,
        time_cond_proj_dim=8)
    tc1 = pcfg.CLIPTextConfig(vocab_size=100, hidden_size=16,
                              intermediate_size=32, num_layers=2, num_heads=2,
                              max_length=8)
    tc2 = pcfg.CLIPTextConfig(vocab_size=100, hidden_size=32,
                              intermediate_size=64, num_layers=2, num_heads=4,
                              max_length=8, hidden_act="gelu")
    cfg = pcfg.PipelineConfig(
        unet=unet, vae=pcfg.VAEConfig(block_out_channels=(16, 16, 32, 32),
                                      norm_num_groups=8, layers_per_block=1),
        sample_size=16, scheduler="euler", num_inference_steps=2)
    return cfg, (tc1, tc2)


def case_models(rank: int, tmp_dir: str) -> dict:
    """SDXL-tiny and PixArt-tiny at tp=2; a tiny LLaVA at tp=2 (tokens and
    logits); the refusals under tp."""
    from diffusion_models_moe_tpu_torch import (PixArtPipeline, SDXLPipeline,
                                                tiny_config,
                                                tiny_pixart_pipeline_config)
    from diffusion_models_moe_tpu_torch.models import llava
    from diffusion_models_moe_tpu_torch.models.llama import embed_tokens
    from diffusion_models_moe_tpu_torch.parallel.mesh import (
        all_gather_cat, create_mesh, shard_llama, shard_pipeline)
    tp = create_mesh(2, tp=2)
    out = {}
    # SDXL (Euler, CFG), its 22 FFs routed
    from diffusion_models_moe_tpu_torch import build_moe_interventions
    cfg, tcs = _tiny_sdxl()
    pipe = SDXLPipeline(cfg, tcs, device="cpu")
    pipe.init_params(_gen(0))
    ivs = build_moe_interventions(_labels(cfg.unet.ff_dims()), 0.3,
                                  device="cpu")
    cond = torch.randint(1, 100, (2, 8), generator=_gen(1))
    uncond = torch.zeros_like(cond)
    out["sdxl_ref"] = pipe.generate(cond, uncond, _gen(2), ivs=ivs)[0]
    out["sdxl_tp"] = pipe.generate(cond, uncond, _gen(2), ivs=ivs,
                                   mesh=tp)[0]
    # PixArt (DPM, CFG) with masked captions
    pcfg = tiny_pixart_pipeline_config()
    px = PixArtPipeline(pcfg, device="cpu")
    px.init_params(_gen(0))
    t5 = pcfg.text_encoder
    ids = torch.randint(1, t5.vocab_size, (2, t5.max_length),
                        generator=_gen(3))
    mask = torch.ones_like(ids)
    mask[0, 10:] = 0
    kw = dict(cond_mask=mask, uncond_mask=torch.ones_like(ids))
    out["pixart_ref"] = px.generate(ids, torch.zeros_like(ids), _gen(4),
                                    **kw)[0]
    out["pixart_tp"] = px.generate(ids, torch.zeros_like(ids), _gen(4),
                                   mesh=tp, **kw)[0]
    # LLaVA: the same greedy tokens, and the teacher-forced logits
    torch.manual_seed(0)
    lcfg = llava.tiny_llava_config()
    model = llava.LlavaForConditionalGeneration(lcfg, device="cpu")
    with torch.no_grad():
        for p in model.language_model.parameters():
            p.normal_(0.0, 0.5)
    images = torch.rand((2, 3, lcfg.vision.image_size, lcfg.vision.image_size),
                        generator=_gen(5))
    prompt = np.array([1, 5, 9, lcfg.image_token_id, 17, 33, 64])
    lm = model.language_model
    emb, n = llava.splice_image(model, prompt,
                                llava.image_features(model, images))
    pos = torch.arange(n).expand(2, n)
    valid = torch.ones((2, n), dtype=torch.bool)
    out["llava_ref"] = llava.generate(model, prompt, images, max_new_tokens=8)
    out["llava_logits_ref"] = lm(emb, pos, valid)[0]
    shard_llama(lm, tp)
    out["llava_tp"] = llava.generate(model, prompt, images, max_new_tokens=8)
    out["llava_logits_tp"] = all_gather_cat(lm(emb, pos, valid)[0],
                                            lm.lm_head.group, -1)
    out["llava_embed_same"] = bool(torch.equal(
        embed_tokens(lm, torch.tensor([3])), lm.model.embed_tokens.weight[3:4]))
    # refusals: the absorbed attention and int8 under tp
    refusals = {}
    for name, modes in (("attn_absorb", {"attn_absorb": "1"}),
                        ("quant_int8", {"quant_int8": True})):
        p2 = _sd_pipe(tiny_config(**modes))
        try:
            shard_pipeline(p2, tp)
            refusals[name] = "accepted"
        except ValueError as e:
            refusals[name] = str(e)
    out["refusals"] = refusals
    return out


def _train_data(n_batches: int = 2, b: int = 4) -> list:
    rng = np.random.RandomState(8)
    return [{"latents": rng.randn(b, 4, 8, 8).astype(np.float32),
             "text_emb": rng.randn(b, 16, 32).astype(np.float32)}
            for _ in range(n_batches)]


def case_train(rank: int, tmp_dir: str) -> dict:
    """Two AdamW steps of the ReLUfied tiny UNet at world size 1, at dp=2
    and at tp=2 (`RunConfig.n_devices=2`: JAX's rule gives tp=2), the
    checkpoints across tp, and the coordinator-only log."""
    from diffusion_models_moe_tpu_torch import tiny_config
    from diffusion_models_moe_tpu_torch.parallel.mesh import (create_mesh,
                                                              gather_tensor,
                                                              param_shardings,
                                                              shard_module)
    from diffusion_models_moe_tpu_torch.training import train, trainer
    base = tiny_config()
    cfg = dataclasses.replace(base, unet=dataclasses.replace(
        base.unet, ff_activation="geglu-relu"))
    src = _sd_pipe(cfg)
    sds = {k: copy.deepcopy(m.state_dict()) for k, m in src.modules().items()}

    def fresh():
        pipe = _sd_pipe(cfg)
        pipe.load_state_dicts(sds)
        return pipe

    data = _train_data()
    tcfg = train.TrainConfig(learning_rate=1e-4, snr_gamma=5.0, ema_decay=0.9)
    out = {}

    def record(state, metrics=None):
        return {"params": state.params, "mu": state.opt_state["mu"],
                "ema": state.ema_params}

    # world size 1: the loop's own steps, without a mesh
    pipe = fresh()
    state = train.create_train_state(pipe.unet, tcfg)
    step = train.make_train_step(pipe.unet, tcfg)
    metrics = []
    for i, batch in enumerate(data):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        state, m = step(state, batch, generator=trainer.step_generator(i, "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    out["ref"] = record(state)
    out["ref_metrics"] = metrics
    ref_dir = os.path.join(tmp_dir, "ckpt_ref")
    train.save_checkpoint(ref_dir, state, 2)

    logs = []
    run = trainer.RunConfig(os.path.join(tmp_dir, "dp"), max_steps=2,
                            checkpoint_every=100, log_every=1)
    st = trainer.train_relufied(fresh(), tcfg, run, iter(data),
                                log_fn=logs.append,
                                mesh=create_mesh(2, dp=2))
    out["dp"] = record(st)
    out["dp_logs"] = logs

    logs = []
    run = trainer.RunConfig(os.path.join(tmp_dir, "tp"), max_steps=2,
                            checkpoint_every=2, log_every=1, n_devices=2)
    pipe = fresh()
    st = trainer.train_relufied(pipe, tcfg, run, iter(data),
                                log_fn=logs.append)
    mesh = pipe.unet._tp_mesh
    out["tp_mesh"] = dict(mesh.shape)
    plan = param_shardings(pipe.unet)
    full = train.map_state(st, plan, lambda t, sp: gather_tensor(t, sp, mesh))
    out["tp"] = record(full)
    out["tp_local_shape"] = {n: tuple(t.shape) for n, t in st.params.items()}
    out["tp_logs"] = logs
    with open(os.path.join(tmp_dir, "tp", "train_log.jsonl")) as f:
        out["tp_log_lines"] = [json.loads(line) for line in f]
    # the tp=2 checkpoint read back at tp=1, whole
    template = train.create_train_state(fresh().unet, tcfg)
    resumed, label = train.restore_checkpoint(
        os.path.join(tmp_dir, "tp", "checkpoints"), template)
    out["resumed_tp1"] = record(resumed)
    out["resumed_label"] = label
    # world size 1's checkpoint read back at tp=2: this rank's shards
    sharded = fresh()
    shard_module(sharded.unet, param_shardings(sharded.unet), mesh)
    template = train.create_train_state(sharded.unet, tcfg)
    resumed, _ = train.restore_checkpoint(ref_dir, template, mesh, plan)
    out["resumed_tp2"] = record(resumed)
    out["tp_rank"] = mesh.rank("tp")
    try:
        train.make_train_step(sharded.unet, dataclasses.replace(
            tcfg, optimizer="adafactor"), mesh=mesh)
        out["adafactor_tp"] = "accepted"
    except ValueError as e:
        out["adafactor_tp"] = str(e)
    return out


CASES = {"generate": case_generate, "models": case_models,
         "train": case_train}
