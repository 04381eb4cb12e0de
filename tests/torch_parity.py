"""Shared set-up of the torch port's parity tests (tests/test_torch_*.py):
seeded weights at tiny_config in f32 for both packages, random expert
labels, and the error measure.

Weights are drawn with numpy in the port's state-dict layout (diffusers /
transformers names), go into the JAX package through its own porter
(`weights/port.py`), and come back into the port through
`weights/bridge.py`: both run the same numbers, and the round trip is
checked on every set-up.
"""
import numpy as np
import torch

from diffusion_models_moe_tpu.weights.port import (port_clip_text_state_dict,
                                                   port_unet_state_dict,
                                                   port_vae_decoder)
from diffusion_models_moe_tpu_torch import StableDiffusionPipeline, tiny_config
from diffusion_models_moe_tpu_torch.taps import layer_name
from diffusion_models_moe_tpu_torch.weights import bridge


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-12))


def block_state_dict(kind: str, params: dict) -> dict:
    """One block's JAX params -> the port block's torch state dict, through
    the bridge's own per-block mapping. kind: "resnet" (ResnetBlock2D) or
    "transformer_block" (BasicTransformerBlock)."""
    sd: dict = {}
    getattr(bridge, f"_{kind}")(sd, "_", params)
    return bridge.to_torch({k[2:]: v for k, v in sd.items()})


def labels(unet_cfg, seed: int = 0) -> dict:
    """Random balanced 20-neuron expert labels for every FF layer."""
    rng = np.random.RandomState(seed)
    return {layer_name(i): rng.permutation(np.arange(4 * d) % ((4 * d) // 20))
            for i, d in enumerate(unet_cfg.ff_dims())}


def _random_state(module: torch.nn.Module, rng: np.random.RandomState) -> dict:
    """Numpy weights for `module`'s state dict: matrices and kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.01), biases N(0, 0.01)."""
    out = {}
    for name, t in module.state_dict().items():
        shape = tuple(t.shape)
        v = rng.randn(*shape).astype(np.float32)
        if len(shape) == 1:
            v = 0.1 * v + (1.0 if name.endswith("weight") else 0.0)
        else:
            v = v * np.prod(shape[1:]) ** -0.5
        out[name] = v.astype(np.float32)
    return out


def nchw(a) -> torch.Tensor:
    """A JAX-side NHWC array as the port's NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a), (0, 3, 1, 2))))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def oihw(k) -> torch.Tensor:
    """A JAX-side HWIO kernel as the port's OIHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(k), (3, 2, 0, 1))))


def rel_l2(got, ref) -> float:
    """||got - ref|| / ||ref||."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / (np.linalg.norm(ref) + 1e-12))


def pipelines(jax_cfg, seed: int = 0, port_cfg=None):
    """(JAX params as numpy, the port's tiny f32 pipeline), same weights.
    `port_cfg`: the port's config where it differs from `tiny_config()` (its
    serving modes; the parameters are the same)."""
    port = StableDiffusionPipeline(port_cfg or tiny_config(), device="cpu")
    rng = np.random.RandomState(seed)
    sds = {k: _random_state(m, rng) for k, m in port.modules().items()}
    params = {
        "unet": port_unet_state_dict(sds["unet"], jax_cfg.unet),
        "text_encoder": port_clip_text_state_dict(sds["text_encoder"],
                                                  jax_cfg.text_encoder),
        "vae": port_vae_decoder("", jax_cfg.vae, _sd=sds["vae"]),
    }
    back = bridge.pipeline_state_dicts(params, port.config)
    for key, sd in sds.items():
        assert back[key].keys() == sd.keys(), key
        for name, v in sd.items():
            np.testing.assert_array_equal(back[key][name].numpy(), v,
                                          err_msg=name)
    port.load_state_dicts(back)
    return params, port
