"""Snapshots and checkpoints in and out of the torch port, against the JAX
package's porter (`weights/port.py`) and the `safetensors` package.

Every snapshot and checkpoint here is written by the test from seeded random
weights at tiny_config, through the JAX package's own exporters.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu.weights import export as jexport
from diffusion_models_moe_tpu.weights import port as jport
from diffusion_models_moe_tpu_torch import StableDiffusionPipeline, sd15_config
from diffusion_models_moe_tpu_torch.weights import _safetensors, bridge, port
from diffusion_models_moe_tpu_torch.weights.export import save_safetensors

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def _sample(dtype: torch.dtype) -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        return torch.randn(3, 5, 2, generator=g).to(dtype)
    if dtype == torch.bool:
        return torch.randint(0, 2, (7, 3), generator=g).bool()
    lo = 0 if dtype == torch.uint8 else -100
    return torch.randint(lo, 100, (4, 6), generator=g).to(dtype)


@pytest.mark.parametrize("name", sorted(_safetensors.DTYPES))
def test_safetensors_interop_with_the_package(tmp_path, name):
    """The port's writer is read by the `safetensors` package and the
    package's files by the port's reader, bit for bit, in every dtype."""
    dtype = _safetensors.DTYPES[name]
    ts = {"t": _sample(dtype), "scalar": _sample(dtype).reshape(-1)[0],
          "empty": torch.empty(0, 3, dtype=dtype)}
    save_safetensors(ts, str(tmp_path / "port.safetensors"))
    save_file(ts, str(tmp_path / "package.safetensors"))
    for got in (load_file(str(tmp_path / "port.safetensors")),
                port.load_safetensors(str(tmp_path / "package.safetensors"))):
        assert got.keys() == ts.keys()
        for k, t in ts.items():
            assert got[k].dtype == dtype and got[k].shape == t.shape, k
            assert torch.equal(_bits(got[k]), _bits(t)), k


def _tiny_snapshot(root, sds: dict, params: dict, cfg) -> None:
    """A diffusers-layout snapshot of the tiny weights, written by the JAX
    package's exporters: an old-layout VAE attention (query/key/value/
    proj_attn as 1x1 convs), the VAE encoder side, a 1x1-conv `proj_in`,
    and the text encoder's `position_ids` buffer."""
    unet = jexport.export_unet(params["unet"], cfg.unet)
    k = "down_blocks.1.attentions.0.proj_in.weight"
    unet[k] = unet[k][:, :, None, None]
    vae = jexport.export_vae_decoder(params["vae"], cfg.vae)
    a = "decoder.mid_block.attentions.0"
    for new, old in (("to_q", "query"), ("to_k", "key"), ("to_v", "value"),
                     ("to_out.0", "proj_attn")):
        vae[f"{a}.{old}.weight"] = vae.pop(f"{a}.{new}.weight")[:, :, None, None]
        vae[f"{a}.{old}.bias"] = vae.pop(f"{a}.{new}.bias")
    rng = np.random.RandomState(7)
    vae["encoder.conv_in.weight"] = rng.randn(32, 3, 3, 3).astype(np.float32)
    vae["quant_conv.weight"] = rng.randn(8, 8, 1, 1).astype(np.float32)
    text = dict(sds["text_encoder"])
    text["text_model.embeddings.position_ids"] = np.arange(
        cfg.text_encoder.max_length, dtype=np.int64)[None]
    for sub, name, sd in (("unet", "diffusion_pytorch_model", unet),
                          ("vae", "diffusion_pytorch_model", vae),
                          ("text_encoder", "model", text)):
        jexport.save_safetensors(sd, os.path.join(root, sub,
                                                  f"{name}.safetensors"))


def test_pipeline_snapshot_equals_the_jax_porter_through_the_bridge(tmp_path):
    """JAX `port_pipeline` -> the bridge gives bit for bit the state dicts
    the port reads from the same snapshot, and they load strictly."""
    jax_cfg = jcfg.tiny_config()
    params, pipe = tp.pipelines(jax_cfg)
    sds = {k: {n: t.numpy() for n, t in m.state_dict().items()}
           for k, m in pipe.modules().items()}
    _tiny_snapshot(str(tmp_path), sds, params, jax_cfg)
    ref = bridge.pipeline_state_dicts(
        jport.port_pipeline(str(tmp_path), jax_cfg), pipe.config)
    got = port.load_pipeline_snapshot(str(tmp_path), pipe.config)
    assert got.keys() == ref.keys()
    for part in ref:
        assert got[part].keys() == ref[part].keys(), part
        for k, t in ref[part].items():
            assert got[part][k].dtype == t.dtype, k
            assert torch.equal(got[part][k], t), k
            np.testing.assert_array_equal(got[part][k].numpy(), sds[part][k])
    fresh = StableDiffusionPipeline(pipe.config, device="cpu")
    fresh.load_state_dicts(got)


def test_pipeline_snapshot_refusals(tmp_path):
    """The VAE file's encoder side goes to "vae_encoder" alone (asked for
    with `include_vae_encoder=True`; the full round trip is
    tests/test_torch_train_io.py's); a snapshot of another geometry is
    refused before loading."""
    jax_cfg = jcfg.tiny_config()
    params, pipe = tp.pipelines(jax_cfg)
    sds = {k: {n: t.numpy() for n, t in m.state_dict().items()}
           for k, m in pipe.modules().items()}
    _tiny_snapshot(str(tmp_path), sds, params, jax_cfg)
    got = port.load_pipeline_snapshot(str(tmp_path), pipe.config,
                                      include_vae_encoder=True)
    assert set(got["vae_encoder"]) == {"encoder.conv_in.weight",
                                       "quant_conv.weight"}
    assert got["vae"].keys() == sds["vae"].keys()
    with pytest.raises(ValueError, match="cross_attention_dim"):
        port.load_pipeline_snapshot(str(tmp_path), sd15_config())


def test_sd15_unet_keys_equal_the_fixture():
    """The port's SD1.5 UNet has exactly diffusers' 686 state-dict keys
    (built on the meta device: no weights are made)."""
    from diffusion_models_moe_tpu_torch.models.unet import UNet2DCondition
    with torch.device("meta"):
        unet = UNet2DCondition(sd15_config().unet)
    with open(os.path.join(ROOT, "tests", "fixtures",
                           "sd15_unet_keys.txt")) as f:
        expected = {line.strip() for line in f if line.strip()}
    assert len(expected) == 686
    assert set(unet.state_dict()) == expected


def _np(sd: dict) -> dict:
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in sd.items()}


def test_edited_checkpoints_equal_the_jax_porter(tmp_path):
    """`load_edited_unet_state_dict` on a fp16 torch pickle with a `unet.`
    prefix and on safetensors, `validate_edited_unet` on good, broken and
    missing files, and `load_delta_bin` with the UNet overlay: the same
    tensors and reports as the JAX package's."""
    jax_cfg = jcfg.tiny_config()
    params, pipe = tp.pipelines(jax_cfg)
    cfg = pipe.config.unet
    sd = {k: t.numpy() for k, t in pipe.unet.state_dict().items()}
    files = {"pt": str(tmp_path / "erased-method_replace.pt"),
             "st": str(tmp_path / "edited.safetensors"),
             "broken": str(tmp_path / "broken.pt"),
             "missing": str(tmp_path / "nope.pt")}
    torch.save({f"unet.{k}": torch.from_numpy(v).half() for k, v in sd.items()},
               files["pt"])
    save_safetensors({k: torch.from_numpy(v) for k, v in sd.items()}, files["st"])
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()
                if not k.startswith("conv_in.")}, files["broken"])
    for name in ("pt", "st"):
        got = _np(port.load_edited_unet_state_dict(files[name]))
        ref = jport.load_edited_unet_state_dict(files[name])
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for name, path in files.items():
        got = port.validate_edited_unet(path, cfg, expected_keys=set(sd))
        ref = jport.validate_edited_unet(path, jax_cfg.unet,
                                         expected_keys=set(sd))
        assert got == ref, name
    assert port.validate_edited_unet(files["st"], cfg, set(sd))["keys_ok"]
    assert not port.validate_edited_unet(files["broken"], cfg, set(sd))["keys_ok"]

    key = "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight"
    delta = np.full_like(sd[key], 0.5)
    text = {k: torch.from_numpy(v.numpy().astype(np.float16))
            for k, v in pipe.text_encoder.state_dict().items()}
    torch.save({"unet": {key: torch.from_numpy(delta)}, "text_encoder": text},
               str(tmp_path / "delta.bin"))
    got = port.load_delta_bin(str(tmp_path / "delta.bin"))
    ref = jport.load_delta_bin(str(tmp_path / "delta.bin"))
    assert got.keys() == ref.keys() == {"unet", "text_encoder"}
    for part in ref:
        g = _np(got[part])
        assert g.keys() == ref[part].keys()
        for k in ref[part]:
            np.testing.assert_array_equal(g[k], ref[part][k], err_msg=k)
    jexport.save_safetensors(sd, str(tmp_path / "unet" /
                                     "diffusion_pytorch_model.safetensors"))
    over = port.load_unet_state_dict(str(tmp_path / "unet"),
                                     overlay=got["unet"])
    np.testing.assert_array_equal(over[key].numpy(), delta)
    np.testing.assert_array_equal(over["conv_in.bias"].numpy(),
                                  sd["conv_in.bias"])
    # the delta's bare text-encoder names take the prefix the port's have
    assert set(port.clip_text_state_dict(got["text_encoder"])) == set(text)


def test_every_port_module_imports_without_jax():
    """Every module of the port, imported in a fresh interpreter, loads
    neither JAX nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffusion_models_moe_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'diffusion_models_moe_tpu'"
        " or m.startswith('diffusion_models_moe_tpu.')]\n"
        "assert not bad, bad\n"
        "assert len(names) > 50, names\n"
        "judges = {'benchmarks.clip_iqa', 'benchmarks.clip_metrics', "
        "'benchmarks.fid', 'benchmarks.memorization', 'benchmarks.scores', "
        "'benchmarks.text_metrics', 'data._native_unigram', "
        "'models.backbones', 'models.clip_vision', 'models.inception', "
        "'safety', 'weights.port_torchvision', 'weights.port_vision', "
        "'benchmarks.art_removal', 'benchmarks.nudity', "
        "'benchmarks.object_erase', 'benchmarks.protocols', "
        "'benchmarks.runner', 'benchmarks.vqa', 'models.llama', "
        "'models.llava', 'models.yolo', 'weights.onnx_reader', "
        "'weights.port_llava', 'weights.port_nudenet', "
        "'parallel.mesh', 'parallel.distributed'}\n"
        "missing = {m for m in judges if p.__name__ + '.' + m not in names}\n"
        "assert not missing, missing\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
