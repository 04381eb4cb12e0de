"""The training path's inputs and its loop on the CPU: the VAE encoder and
`sample_latents` against the JAX package's, the encoder's weights through
the bridge, a snapshot and `load_pipeline_snapshot`, the ingest and
MIMIC-CXR batches against JAX's on one seeded folder, and
`train_relufied`'s resume, skip, label and rotation semantics at
tiny_config (~20 s in all; one JAX compile, the tiny encoder's).
"""
import copy
import csv
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from diffusion_models_moe_tpu.data import ingest as jingest
from diffusion_models_moe_tpu.data import mimic_cxr as jmimic
from diffusion_models_moe_tpu.models.vae import VAEEncoder as JaxVAEEncoder
from diffusion_models_moe_tpu.models.vae import \
    sample_latents as jax_sample_latents
from diffusion_models_moe_tpu.weights import export as jexport
from diffusion_models_moe_tpu.weights import port as jport
from diffusion_models_moe_tpu_torch import StableDiffusionPipeline
from diffusion_models_moe_tpu_torch.data import ingest, mimic_cxr
from diffusion_models_moe_tpu_torch.models.vae import (VAEEncoder,
                                                       sample_latents)
from diffusion_models_moe_tpu_torch.training import train, trainer
from diffusion_models_moe_tpu_torch.weights import bridge, port
from diffusion_models_moe_tpu_torch.weights.export import \
    save_pipeline_snapshot

TOL = 2e-4


@pytest.fixture(scope="module")
def enc():
    """(JAX config, port config, the encoder's numpy state dict, its JAX
    params through the JAX porter, the port's encoder loaded from it)."""
    jcfg, pcfg = tp.tiny_pair()
    module = VAEEncoder(pcfg.vae)
    sd = tp._random_state(module, np.random.RandomState(5))
    params = jport.port_vae_encoder("", jcfg.vae, _sd=sd)
    module.load_state_dict(bridge.to_torch(sd), strict=True)
    return jcfg, pcfg, sd, params, module


def test_vae_encoder_bridge_equals_jax_export(enc):
    """`vae_encoder_numpy_state_dict` gives the JAX package's
    `export_vae_encoder` bit for bit, and inverts its porter."""
    jcfg, pcfg, sd, params, _ = enc
    got = bridge.vae_encoder_numpy_state_dict(params, pcfg.vae)
    ref = jexport.export_vae_encoder(params, jcfg.vae)
    assert got.keys() == ref.keys() == sd.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(got[k], sd[k], err_msg=k)


def test_vae_encoder_and_sample_latents_match_jax(enc):
    """mean, logvar (f32) and the scaled sample on JAX's noise, NCHW here
    and NHWC there."""
    jcfg, pcfg, _, params, module = enc
    rng = np.random.RandomState(6)
    side = 8 * jcfg.sample_size
    images = rng.uniform(-1, 1, (2, side, side, 3)).astype(np.float32)
    mean_j, logvar_j = jax.jit(JaxVAEEncoder(jcfg.vae).apply)(
        {"params": params}, jnp.asarray(images))
    with torch.no_grad():
        mean, logvar = module(tp.nchw(images))
    assert mean.dtype == logvar.dtype == torch.float32
    assert tuple(mean.shape) == (2, 4, jcfg.sample_size, jcfg.sample_size)
    assert tp.rel_err(tp.nhwc(mean), mean_j) < TOL
    assert tp.rel_err(tp.nhwc(logvar), logvar_j) < TOL
    key = jax.random.PRNGKey(2)
    ref = jax_sample_latents(mean_j, logvar_j, key, jcfg.vae.scaling_factor)
    noise = tp.nchw(np.asarray(jax.random.normal(key, mean_j.shape)))
    got = sample_latents(mean, logvar, noise, pcfg.vae.scaling_factor)
    assert tp.rel_err(tp.nhwc(got), ref) < TOL


def test_snapshot_round_trip_with_the_encoder(enc, tmp_path):
    """`save_pipeline_snapshot` writes the encoder beside the decoder in the
    VAE file; `load_pipeline_snapshot(include_vae_encoder=True)` reads every
    part back bit for bit, and `build_vae_encoder` loads it strictly."""
    _, pcfg, sd, _, _ = enc
    pipe = StableDiffusionPipeline(pcfg, device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    sds = {k: m.state_dict() for k, m in pipe.modules().items()}
    sds["vae_encoder"] = bridge.to_torch(sd)
    save_pipeline_snapshot(str(tmp_path), sds)
    got = port.load_pipeline_snapshot(str(tmp_path), pcfg,
                                      include_vae_encoder=True)
    assert got.keys() == sds.keys()
    for part, ref in sds.items():
        assert got[part].keys() == ref.keys(), part
        for k, t in ref.items():
            assert torch.equal(got[part][k], t), (part, k)
    assert "vae_encoder" not in port.load_pipeline_snapshot(str(tmp_path),
                                                            pcfg)
    alone = port.load_vae_encoder_state_dict(str(tmp_path / "vae"))
    assert all(torch.equal(alone[k], t) for k, t in got["vae_encoder"].items())
    built = trainer.build_vae_encoder(pipe, got["vae_encoder"])
    assert not any(p.requires_grad for p in built.parameters())


# ------------------------------------------------------------ data
def _tok(texts):
    return np.asarray([[len(t) % 100] * 8 for t in texts], np.int32)


def _folder(root: str, n: int = 7) -> None:
    """Seeded PNGs of mixed sizes with metadata.csv (file_name, text) and a
    MIMIC-style reports.csv (path, report)."""
    rng = np.random.RandomState(0)
    rows = []
    for i in range(n):
        w, h = (40, 30) if i % 2 else (24, 36)
        name = f"img_{i}.png"
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(
            os.path.join(root, name))
        rows.append({"file_name": name, "text": f"caption {i} " * (i + 1)})
    for fname, cols in (("metadata.csv", ("file_name", "text")),
                        ("reports.csv", ("path", "report"))):
        with open(os.path.join(root, fname), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(cols)
            w.writerows([r["file_name"], r["text"]] for r in rows)


def _same_batches(a, b) -> int:
    n = 0
    for x, y in zip(a, b, strict=True):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))
        n += 1
    return n


@pytest.mark.parametrize("center_crop,flip", [(False, True), (True, False)])
def test_ingest_batches_equal_jax(tmp_path, center_crop, flip):
    _folder(str(tmp_path))
    kw = dict(batch_size=2, resolution=16, epochs=2, seed=3,
              center_crop=center_crop, random_flip=flip)
    got = ingest.imagefolder_batches(str(tmp_path), _tok, **kw)
    ref = jingest.imagefolder_batches(str(tmp_path), _tok, **kw)
    assert _same_batches(got, ref) == 6
    assert ingest.read_metadata(str(tmp_path)) == jingest.read_metadata(
        str(tmp_path))


def test_mimic_cxr_batches_equal_jax(tmp_path):
    _folder(str(tmp_path))
    args = (str(tmp_path / "reports.csv"), str(tmp_path))
    got = mimic_cxr.MimicCXRDataset(*args, resolution=16)
    ref = jmimic.MimicCXRDataset(*args, resolution=16)
    assert len(got) == len(ref) == 7
    assert _same_batches(got.batches(3, _tok, seed=1, epochs=2),
                         ref.batches(3, _tok, seed=1, epochs=2)) == 4
    with pytest.raises(ValueError, match="rows"):
        next(mimic_cxr.MimicCXRDataset(*args).batches(8, _tok))


# ------------------------------------------------------------ the loop
@pytest.fixture(scope="module")
def weights():
    """The tiny ReLUfied pipeline's state dicts, seeded."""
    _, pcfg = tp.tiny_pair(unet={"ff_activation": "geglu-relu"})
    pipe = StableDiffusionPipeline(pcfg, device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    return pcfg, {k: copy.deepcopy(m.state_dict())
                  for k, m in pipe.modules().items()}


def _pipe(weights):
    pcfg, sds = weights
    pipe = StableDiffusionPipeline(pcfg, device="cpu")
    pipe.load_state_dicts(sds)
    return pipe


def _latent_batches(n: int, seen: list):
    """Pre-encoded batches, made on demand; `seen` records each pull."""
    for i in range(n):
        seen.append(i)
        rng = np.random.RandomState(100 + i)
        yield {"latents": rng.randn(2, 4, 8, 8).astype(np.float32),
               "text_emb": rng.randn(2, 16, 32).astype(np.float32)}


TCFG = train.TrainConfig(learning_rate=1e-3, snr_gamma=5.0, ema_decay=0.9)


def test_resume_equals_the_uninterrupted_run(weights, tmp_path):
    """6 steps in one run against 4, a checkpoint and a resume to 6: the
    same masters, optimizer state and EMA, bit for bit (each step's draws
    come from (seed, step) alone). The resumed run skips the 4 consumed
    batches and pulls none past max_steps; labels are steps completed."""
    seen: list = []
    full = trainer.train_relufied(
        _pipe(weights), TCFG,
        trainer.RunConfig(str(tmp_path / "a"), max_steps=6,
                          checkpoint_every=4, log_every=1),
        _latent_batches(10, seen))
    assert seen == list(range(6)) and full.step == 6
    assert train.checkpoint_steps(str(tmp_path / "a" / "checkpoints")) == [4, 6]

    seen.clear()
    run = trainer.RunConfig(str(tmp_path / "b"), max_steps=4,
                            checkpoint_every=4, log_every=2)
    trainer.train_relufied(_pipe(weights), TCFG, run, _latent_batches(10, seen))
    assert seen == list(range(4))
    seen.clear()
    pipe = _pipe(weights)
    resumed = trainer.train_relufied(
        pipe, TCFG, dataclasses.replace(run, max_steps=6),
        list(_latent_batches(10, seen)))
    assert resumed.step == 6
    ckpt = str(tmp_path / "b" / "checkpoints")
    assert train.checkpoint_steps(ckpt) == [4, 6]
    for name in ("params", "ema_params"):
        for k, v in getattr(full, name).items():
            assert torch.equal(getattr(resumed, name)[k], v), (name, k)
    for k, v in full.opt_state["mu"].items():
        assert torch.equal(resumed.opt_state["nu"][k],
                           full.opt_state["nu"][k]) and torch.equal(
            resumed.opt_state["mu"][k], v)
    for n, p in pipe.unet.named_parameters():
        assert torch.equal(p.detach(), resumed.params[n])
    logs = [json.loads(line) for line in open(tmp_path / "b" /
                                              "train_log.jsonl")]
    assert [r["step"] for r in logs] == [0, 2, 4]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in logs)

    # a finished run resumed: nothing runs, nothing is saved again
    again = trainer.train_relufied(_pipe(weights), TCFG,
                                   dataclasses.replace(run, max_steps=6),
                                   _latent_batches(10, []))
    assert again.step == 6 and train.checkpoint_steps(ckpt) == [4, 6]


def test_rotation_and_no_second_save(weights, tmp_path):
    """`max_checkpoints` keeps the newest labels; a run whose last step was
    just saved does not save it again (a second save of a label raises)."""
    out = str(tmp_path)
    state = trainer.train_relufied(
        _pipe(weights), dataclasses.replace(TCFG, use_ema=False),
        trainer.RunConfig(out, max_steps=5, checkpoint_every=1,
                          max_checkpoints=2, log_every=10),
        _latent_batches(10, []))
    ckpt = os.path.join(out, "checkpoints")
    assert state.ema_params is None
    assert train.checkpoint_steps(ckpt) == [4, 5]
    with pytest.raises(FileExistsError):
        train.save_checkpoint(ckpt, state, 5)
    restored, step = train.restore_checkpoint(ckpt, state)
    assert step == 5 and restored.step == 5


def test_raw_images_validation_and_report(weights, enc, tmp_path):
    """Raw image batches through the frozen text encoder and the VAE
    encoder, accumulation of 2, `ft_method="ff"`, and the validation
    logger on the EMA at step 1 (PNGs, a JSONL record, the UNet's own
    weights put back)."""
    _, _, sd, _, _ = enc
    pipe = _pipe(weights)
    venc = trainer.build_vae_encoder(pipe, bridge.to_torch(sd))
    rng = np.random.RandomState(0)

    def batches():
        while True:
            yield {"images": rng.uniform(-1, 1, (2, 64, 64, 3)).astype(
                       np.float32),
                   "input_ids": rng.randint(0, 1000, (2, 16))}

    tcfg = dataclasses.replace(TCFG, grad_accum_steps=2, ft_method="ff")
    calls = []
    val = trainer.make_validation_logger(pipe, lambda t: _tok(t) * 0 + 1,
                                         ["a dog"], str(tmp_path / "val"),
                                         num_steps=2)

    def validation_fn(params, step):
        calls.append(step)
        before = {n: p.detach().clone() for n, p in pipe.unet.named_parameters()}
        val(params, step)
        for n, p in pipe.unet.named_parameters():
            assert torch.equal(p.detach(), before[n])

    state = trainer.train_relufied(
        pipe, tcfg, trainer.RunConfig(str(tmp_path), max_steps=2,
                                      checkpoint_every=10, log_every=1,
                                      validation_every=1),
        batches(), vae_encoder=venc, validation_fn=validation_fn)
    assert calls == [1] and state.opt_state["count"] == 1
    assert os.path.exists(tmp_path / "val" / "val_step000001_0.png")
    mask = train.trainable_mask(state.params, "ff")
    report = trainer.param_count_report(state.params, mask)
    assert 0 < report["share"] < 1 and report["total"] == sum(
        t.numel() for t in state.params.values())
    frozen = [n for n, m in mask.items() if not m]
    ref = weights[1]["unet"]
    assert all(torch.equal(state.params[n], ref[n].float()) for n in frozen)
    with pytest.raises(ValueError, match="vae_encoder"):
        trainer.train_relufied(_pipe(weights), TCFG,
                               trainer.RunConfig(str(tmp_path / "x"),
                                                 max_steps=1),
                               batches())
