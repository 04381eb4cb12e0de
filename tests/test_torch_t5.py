"""The torch port's T5 v1.1 encoder against the JAX package's, on the CPU.

The tiny T5 of `tiny_t5_config`, in f32, with the weights of
`torch_parity.pixart_pipelines` (drawn with numpy in transformers' names,
written as a snapshot, read into JAX by its porter and into the port by the
bridge). The JAX module runs op by op (no jit): no JAX program is compiled
in this file.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from diffusion_models_moe_tpu.models.t5 import T5Encoder as JaxT5
from diffusion_models_moe_tpu.models.t5 import \
    _relative_position_buckets as jax_buckets
from diffusion_models_moe_tpu_torch.models.t5 import (
    T5Config, _relative_position_buckets)

TOL = 1e-5                 # relative max error, f32


@pytest.fixture(scope="module")
def px(tmp_path_factory):
    d = tp.pixart_pipelines(str(tmp_path_factory.mktemp("pixart")))
    tc = d["jax_cfg"].text_encoder
    rng = np.random.RandomState(3)
    ids = rng.randint(0, tc.vocab_size, (2, tc.max_length)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 9:] = 0                        # a padded caption
    mask[1, 13:] = 0
    d.update(ids=ids, mask=mask)
    return d


@pytest.mark.parametrize("masked", [False, True])
def test_t5_encoder_matches_jax(px, masked):
    """Features (B, L, d_model) within TOL of JAX's, with and without the
    attention mask; the mask moves the features of the kept positions."""
    tc = px["jax_cfg"].text_encoder
    mask = px["mask"] if masked else None
    ref = np.asarray(JaxT5(tc).apply(
        {"params": px["params"]["text_encoder"]}, jnp.asarray(px["ids"]),
        None if mask is None else jnp.asarray(mask)))
    enc = px["port"].text_encoder
    with torch.no_grad():
        got = enc(torch.from_numpy(px["ids"]).long(),
                  None if mask is None else torch.from_numpy(mask))
        other = enc(torch.from_numpy(px["ids"]).long(),
                    None if masked else torch.from_numpy(px["mask"]))
    assert got.shape == (2, tc.max_length, tc.d_model)
    assert tp.rel_err(got.numpy(), ref) < TOL
    assert tp.rel_err(other.numpy()[0, :9], ref[0, :9]) > 1e-3


def test_t5_mask_hides_the_padded_tokens(px):
    """A token past the mask does not reach the kept positions."""
    enc = px["port"].text_encoder
    ids = torch.from_numpy(px["ids"]).long()
    mask = torch.from_numpy(px["mask"])
    ids2 = ids.clone()
    ids2[0, -1] = (ids2[0, -1] + 1) % px["port_cfg"].text_encoder.vocab_size
    with torch.no_grad():
        a, b = enc(ids, mask), enc(ids2, mask)
    torch.testing.assert_close(a[0, :9], b[0, :9], rtol=0, atol=1e-6)
    assert (a[0, 9:] - b[0, 9:]).abs().max() > 1e-4


@pytest.mark.parametrize("seq_len", [16, 120, 300])
def test_relative_position_buckets_equal_jax(seq_len):
    """The bucket table at the tiny, the PixArt and a longer length, at
    T5 v1.1's 32 buckets and distance 128."""
    cfg = T5Config()
    args = (seq_len, cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)
    got = _relative_position_buckets(*args)
    np.testing.assert_array_equal(got, jax_buckets(*args))
    assert got.dtype == np.int32 and got.max() < 32


def test_t5_keeps_norms_and_bias_table_in_f32():
    """In a bf16 encoder the RMSNorm scales and the position-bias table stay
    f32, as the JAX module keeps its parameters."""
    from diffusion_models_moe_tpu_torch.models.layers import cast_model
    from diffusion_models_moe_tpu_torch.models.t5 import (T5Encoder,
                                                          tiny_t5_config)
    enc = cast_model(T5Encoder(tiny_t5_config()), torch.bfloat16)
    dtypes = {n: p.dtype for n, p in enc.named_parameters()}
    for name, dt in dtypes.items():
        keep = "layer_norm" in name or "relative_attention_bias" in name
        assert dt == (torch.float32 if keep else torch.bfloat16), name
    out = enc(torch.zeros((1, 16), dtype=torch.long))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
