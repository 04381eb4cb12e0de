"""T5 v1.1 encoder stack, PixArt-alpha's text encoder (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/models/t5.py`, with the parameter
names of transformers' `T5EncoderModel` (`shared`, `encoder.block.{i}.layer.
{0,1}`, `encoder.final_layer_norm`):

  * token embedding -> N blocks of (RMSNorm -> self-attention plus the
    relative position bias -> residual; RMSNorm -> gated-GELU FF ->
    residual) -> final RMSNorm;
  * the relative position bias is made once a call from the bucket embedding
    that block 0 owns (`relative_attention_bias`) and shared by every block;
    an attention mask adds -1e9 to it at the padded keys;
  * no biases; the attention logits are unscaled (T5 folds 1/sqrt(d) into
    its initialisation), taken in f32 with the bias, softmax in f32, the
    probabilities rounded to the model dtype before P V; RMSNorm statistics
    in f32.

The norms and the bucket embedding keep f32 parameters in a bf16 model
(`F32_PARAMS`, read by `layers.cast_model`), as the JAX module keeps them.
The products are plain torch (cuBLAS): the JAX package computes them outside
any Pallas kernel. Under tensor parallelism (`parallel/mesh.py`) q, k, v,
`wi_0` and `wi_1` are column-parallel and o and `wo` row-parallel, as in
the JAX package's rules: a rank takes heads / tp heads and its slice of the
position bias.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class T5Config:
    """Defaults are t5-v1_1-xxl, the PixArt-alpha text encoder."""
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    max_length: int = 120           # PixArt caption length
    dtype: torch.dtype = torch.float32


def tiny_t5_config() -> T5Config:
    return T5Config(vocab_size=256, d_model=48, d_kv=8, d_ff=96, num_layers=2,
                    num_heads=4, max_length=16)


@functools.lru_cache(maxsize=None)
def _relative_position_buckets(seq_len: int, num_buckets: int,
                               max_distance: int) -> np.ndarray:
    """Bidirectional T5 bucket table, (S, S) int32, made on the host once
    for each sequence length."""
    ctx = np.arange(seq_len)[:, None]
    mem = np.arange(seq_len)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / np.log(max_distance / max_exact)
        * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    out += np.where(is_small, rel, large)
    return out.astype(np.int32)


class T5LayerNorm(nn.Module):
    """RMSNorm (no mean subtraction, no bias), statistics in f32."""
    F32_PARAMS = True

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight.float()
                ).to(x.dtype)


class T5RelativeBias(nn.Embedding):
    """The (buckets, heads) relative position bias table, kept in f32."""
    F32_PARAMS = True


class T5Attention(nn.Module):
    """`SelfAttention`: q, k, v, o without biases; block 0's also owns the
    relative position bias table."""

    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        self.head_slice = slice(None)       # the rank's heads under tp
        if has_bias:
            self.relative_attention_bias = T5RelativeBias(
                cfg.relative_attention_num_buckets, cfg.num_heads)

    def tp_shard(self, tp: int, rank: int) -> None:
        """heads / tp heads a rank (`parallel/mesh.py:shard_module`)."""
        if self.heads % tp:
            raise ValueError(f"{self.heads} heads do not split over tp = {tp}")
        self.heads //= tp
        self.head_slice = slice(rank * self.heads, (rank + 1) * self.heads)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor
                ) -> torch.Tensor:
        b, s, _ = x.shape

        def split(t):                 # (B, S, H * D) -> (B, H, S, D)
            return t.view(b, s, self.heads, self.d_kv).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        logits = (q.float() @ k.float().transpose(-1, -2)
                  + position_bias[:, self.head_slice])
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = (probs @ v).transpose(1, 2).reshape(b, s, self.heads * self.d_kv)
        return self.o(out)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)

    def forward(self, x, position_bias):
        return x + self.SelfAttention(self.layer_norm(x), position_bias)


class T5DenseGatedActDense(nn.Module):
    """T5 v1.1's gated-GELU FF: wo(gelu_tanh(wi_0 h) * wi_1 h)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h):
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_bias),
                                    T5LayerFF(cfg)])

    def forward(self, x, position_bias):
        return self.layer[1](self.layer[0](x, position_bias))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0)
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class T5Encoder(nn.Module):
    """input_ids (B, S) -> features (B, S, d_model). `attention_mask` (B, S)
    of 0/1 masks the padded positions out of every softmax (PixArt masks
    the pad tokens of its caption)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = T5Stack(cfg)

    def position_bias(self, seq_len: int,
                      attention_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """(1 or B, H, S, S) f32: the bucket embedding at the bucket table,
        with -1e9 at the masked keys."""
        cfg = self.cfg
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias
        # a copy (int32 -> long): the cached table is never written
        buckets = torch.from_numpy(_relative_position_buckets(
            seq_len, cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)).to(table.weight.device,
                                                     torch.long)
        bias = table.weight.float()[buckets].permute(2, 0, 1)[None]
        if attention_mask is not None:
            keep = attention_mask.to(bias.device)[:, None, None, :] > 0
            bias = bias + torch.where(keep, 0.0, -1e9)
        return bias

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.shared(input_ids)
        bias = self.position_bias(input_ids.shape[1], attention_mask)
        for block in self.encoder.block:
            x = block(x, bias)
        return self.encoder.final_layer_norm(x)
