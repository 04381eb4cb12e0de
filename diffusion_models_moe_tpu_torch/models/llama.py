"""Llama decoder-only LM with a KV-cached greedy decode: the VQA judge's LM
(PyTorch port of `diffusion_models_moe_tpu/models/llama.py`).

The reference scores erasure runs with LLaVA-1.5 (a Vicuna/Llama LM behind a
CLIP vision tower; reference: modularity/llava_score.py:15-41,
modularity/mod_utils.py:195-290). This is that LM:

  * RMSNorm (f32 statistics, cast to the dtype BEFORE the scale, as HF's
    LlamaRMSNorm) -> GQA self-attention with rotary embeddings -> residual;
    RMSNorm -> SwiGLU MLP -> residual; final RMSNorm -> an f32 `lm_head`
  * RoPE in the HF convention (half-split `rotate_half`, cos/sin built at
    f32 from `rope_theta` and cast to the activations' dtype); Qwen2-VL's
    3-D multimodal RoPE by `mrope_section`, Qwen2's q/k/v biases by
    `attention_bias`
  * attention logits in f32, -1e9 at masked keys, the softmax cast to the
    dtype before it multiplies V: plain torch math (the JAX stack is XLA
    here, no Pallas kernel), its products in cuBLAS
  * one module serves prefill (the whole prompt, causal + pad mask; returns
    each layer's K/V) and decode (one token a step appended at each
    sample's own slot of a fixed-size cache), so right-padded co-batched
    samples decode exactly as they would alone.

Parameter names are transformers' `LlamaForCausalLM` (`model.embed_tokens`,
`model.layers.{i}.self_attn.q_proj`, `model.layers.{i}.mlp.gate_proj`,
`model.norm`, `lm_head`); `quant_int8` makes the seven projections of each
layer the W8A8 `QuantDense` of `models/attention.py` (same parameters),
`lm_head` stays f32 (argmax sensitivity). The dtype defaults to f32, as in
JAX. Under tensor parallelism (`parallel/mesh.py:shard_llama`) q/k/v and
gate/up are column-parallel, o_proj and down_proj row-parallel, and
`lm_head` is split over the vocabulary: a rank holds heads / tp query heads
and kv heads / tp kv heads (num_kv_heads % tp == 0), the model returns the
rank's logits, and the greedy argmax gathers each rank's (max, index).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.config import resolve_device
from diffusion_models_moe_tpu_torch.models.attention import make_dense
from diffusion_models_moe_tpu_torch.parallel.mesh import (ColumnParallelLinear,
                                                          vocab_argmax)

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Defaults are Llama/Vicuna-7B, LLaVA-1.5's LM. The same stack serves
    Qwen2 geometries: bias on q/k/v (`attention_bias`) and, for Qwen2-VL,
    3-D multimodal RoPE (`mrope_section`: channel sections rotated by the
    temporal/height/width position axes)."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    attention_bias: bool = False
    mrope_section: tuple = ()          # empty = standard 1-D RoPE
    quant_int8: bool = False           # W8A8 projections; lm_head stays f32
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def tiny_llama_config(vocab_size: int = 128) -> LlamaConfig:
    return LlamaConfig(vocab_size=vocab_size, hidden_size=32,
                       intermediate_size=64, num_layers=2, num_heads=4,
                       num_kv_heads=2)


# ---------------------------------------------------------------------- RoPE
def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., S) int positions -> cos/sin (..., S, head_dim) in f32, HF
    layout: the frequencies repeated as [f0..f_{d/2-1}, f0..f_{d/2-1}]."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[..., None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  section: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Multimodal 3-D RoPE (Qwen2-VL): positions (3, B, S) for the
    temporal/height/width axes (or (B, S), shared by all three) -> cos/sin
    (B, S, head_dim), channel section i of the doubled `section` list
    rotated by axis i % 3."""
    if positions.dim() == 2:
        positions = positions[None].expand(3, *positions.shape)
    cos3, sin3 = rope_cos_sin(positions, head_dim, theta)   # (3, B, S, hd)
    axis_of = np.repeat(np.arange(len(section) * 2) % 3,
                        np.tile(np.asarray(section), 2))   # (hd,)
    onehot = torch.from_numpy(np.eye(3, dtype=np.float32)[axis_of].T
                              ).to(positions.device)       # (3, hd)
    cos = torch.einsum("absd,ad->bsd", cos3, onehot)
    sin = torch.einsum("absd,ad->bsd", sin3, onehot)
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, H, S, D), cos/sin (B, S, D): HF rotate_half, cos and sin cast
    to x's dtype."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None].to(x.dtype) + rot * sin[:, None].to(x.dtype)


# ------------------------------------------------------------------- modules
class RMSNorm(nn.Module):
    """HF LlamaRMSNorm: f32 statistics, cast to `dtype` before the (f32)
    scale is applied in `dtype`."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps, self.dtype = eps, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = (xf * torch.rsqrt(var + self.eps)).to(self.dtype)
        return y * self.weight.to(self.dtype)


KVCache = tuple[torch.Tensor, torch.Tensor]


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        # this rank's query and kv heads (all of them outside tp)
        self.num_heads, self.num_kv_heads = cfg.num_heads, cfg.num_kv_heads
        d, hd = cfg.hidden_size, cfg.head_dim
        q = cfg.quant_int8
        self.q_proj = make_dense(d, cfg.num_heads * hd, cfg.attention_bias, q)
        self.k_proj = make_dense(d, cfg.num_kv_heads * hd, cfg.attention_bias, q)
        self.v_proj = make_dense(d, cfg.num_kv_heads * hd, cfg.attention_bias, q)
        self.o_proj = make_dense(cfg.num_heads * hd, d, False, q)

    def tp_shard(self, tp: int, rank: int) -> None:
        """heads / tp query and kv heads a rank (`parallel/mesh.py`)."""
        if self.num_kv_heads % tp:
            raise ValueError(f"{self.num_kv_heads} kv heads do not split over "
                             f"tp = {tp}")
        self.num_heads //= tp
        self.num_kv_heads //= tp

    def forward(self, x, cos, sin, kv_mask, cache: Optional[KVCache] = None,
                cache_pos: Optional[torch.Tensor] = None):
        """x (B, S, D); kv_mask (B, K) True where a key is attendable; cache
        None (prefill: K = S, causality applied here) or (k, v) of (B, KVH,
        C, hd) with each sample's append slot cache_pos (B,) (decode: S = 1,
        K = C; the new K/V are written into the cache in place). Returns
        (out, (k_all, v_all))."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim

        def heads(y, n):
            return y.view(b, s, n, hd).transpose(1, 2)

        nh, nkv = self.num_heads, self.num_kv_heads
        q = apply_rope(heads(self.q_proj(x), nh), cos, sin)
        k = apply_rope(heads(self.k_proj(x), nkv), cos, sin)
        v = heads(self.v_proj(x), nkv)
        if cache is None:
            k_all, v_all = k, v
            causal = torch.ones((s, s), dtype=torch.bool,
                                device=x.device).tril()
            mask = causal[None] & kv_mask[:, None, :]          # (B, S, K)
        else:
            rows = torch.arange(b, device=x.device)
            k_all, v_all = cache
            k_all[rows, :, cache_pos] = k[:, :, 0]
            v_all[rows, :, cache_pos] = v[:, :, 0]
            mask = kv_mask[:, None, :]          # (B, 1, K): validity is causality
        rep = nh // nkv
        k_att = k_all.repeat_interleave(rep, dim=1) if rep > 1 else k_all
        v_att = v_all.repeat_interleave(rep, dim=1) if rep > 1 else v_all
        logits = (q.float() @ k_att.float().transpose(-1, -2)) / hd ** 0.5
        logits = logits.masked_fill(~mask[:, None], NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
        out = (probs @ v_att).transpose(1, 2).reshape(b, s, nh * hd)
        return self.o_proj(out), (k_all, v_all)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        d, h, q = cfg.hidden_size, cfg.intermediate_size, cfg.quant_int8
        self.gate_proj = make_dense(d, h, False, q)
        self.up_proj = make_dense(d, h, False, q)
        self.down_proj = make_dense(h, d, False, q)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps,
                                                cfg.dtype)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, cos, sin, kv_mask, cache=None, cache_pos=None):
        att, kv = self.self_attn(self.input_layernorm(x), cos, sin, kv_mask,
                                 cache, cache_pos)
        x = x + att
        return x + self.mlp(self.post_attention_layernorm(x)), kv


class _Decoder(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype)


class LlamaModel(nn.Module):
    """Embeddings in, f32 logits out; shared by prefill and decode.

    forward(embeds, positions, kv_mask, caches=None, cache_pos=None):
      * embeds (B, S, D): token or multimodal embeddings (LLaVA splices the
        image features in before calling)
      * positions (B, S), or (3, B, S) under `mrope_section`: RoPE positions
      * kv_mask (B, K): True where a key slot is attendable; prefill K = S
        (pad mask; causality is internal), decode K = C (cache validity)
      * caches: per-layer (k, v) of (B, KVH, C, hd), written in place at
        each sample's slot cache_pos (B,)
    Returns (logits (B, S, V) f32, caches).

    Built on `device` (the card unless the caller asks for another) in
    `cfg.dtype`, the norms and `lm_head` in f32, with torch's default
    initialisation: load a state dict (`weights/port_llava.py`)."""

    def __init__(self, cfg: LlamaConfig = LlamaConfig(), device="cuda"):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.model = _Decoder(cfg)
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False)
        self.to(cfg.dtype)
        for m in self.modules():
            if isinstance(m, RMSNorm):
                m.float()
        self.lm_head.float()
        self.eval()

    @torch.no_grad()
    def forward(self, embeds, positions, kv_mask, caches=None, cache_pos=None):
        cfg = self.cfg
        if cfg.mrope_section:
            cos, sin = mrope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                                     cfg.mrope_section)
        else:
            cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        x = embeds.to(cfg.dtype)
        new_caches = []
        for i, layer in enumerate(self.model.layers):
            x, kv = layer(x, cos, sin, kv_mask,
                          None if caches is None else caches[i], cache_pos)
            new_caches.append(kv)
        x = self.model.norm(x)
        return self.lm_head(x.float()), new_caches


@torch.no_grad()
def embed_tokens(model: LlamaModel, ids: torch.Tensor) -> torch.Tensor:
    """Token ids -> embeddings from the model's table."""
    table = model.model.embed_tokens.weight
    return table[torch.as_tensor(ids, device=table.device).long()]


def init_cache(cfg: LlamaConfig, batch: int, size: int, device) -> list:
    def kv():
        return torch.zeros((batch, cfg.num_kv_heads, size, cfg.head_dim),
                           dtype=cfg.dtype, device=device)
    return [(kv(), kv()) for _ in range(cfg.num_layers)]


def greedy_token(model: LlamaModel, logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocabulary of f32 logits (..., V): over the ranks'
    vocabulary slices where `lm_head` is split over tp."""
    head = model.lm_head
    if isinstance(head, ColumnParallelLinear):
        return vocab_argmax(logits, head.out_slice.start, head.group)
    return logits.argmax(dim=-1)


@torch.no_grad()
def greedy_decode(model: LlamaModel, embeds: torch.Tensor,
                  lengths: torch.Tensor, max_new_tokens: int, eos_id: int,
                  pad_id: int = 0,
                  prefill_positions: Optional[torch.Tensor] = None,
                  pos_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy decode from right-padded prompt embeddings.

    embeds (B, P, D); lengths (B,) valid prompt lengths. Prefill seeds a
    (P + max_new_tokens)-slot cache; each step appends one token at each
    sample's own slot, so a right-padded prompt overwrites its pad slots and
    `slot <= cur_len` masks the rest. The argmax is taken on f32 logits; a
    sample emits its EOS token, then `pad_id`. Returns (B, max_new_tokens)
    int64 on the model's device.

    Multimodal RoPE (Qwen2-VL): pass `prefill_positions` ((3, B, P)) and
    `pos_offset` (B,) = max prompt position + 1 - length (HF's
    mrope_position_deltas), so generated tokens continue from the max
    position rather than the sequence slot."""
    dev = embeds.device
    b, p, _ = embeds.shape
    lengths = torch.as_tensor(lengths, device=dev).long()
    cache_size = p + max_new_tokens
    slot = torch.arange(p, device=dev).expand(b, p)
    positions = slot if prefill_positions is None else prefill_positions
    pos_offset = (torch.zeros(b, dtype=torch.long, device=dev)
                  if pos_offset is None
                  else torch.as_tensor(pos_offset, device=dev).long())
    logits, kvs = model(embeds, positions, slot < lengths[:, None])
    # the fixed-size cache, seeded with the prefill K/V (slot == position)
    caches = [(F.pad(k, (0, 0, 0, cache_size - p)),
               F.pad(v, (0, 0, 0, cache_size - p))) for k, v in kvs]
    tok = greedy_token(model, logits[torch.arange(b, device=dev), lengths - 1])
    slot_ids = torch.arange(cache_size, device=dev)
    cur_len = lengths.clone()
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    out = []
    for step in range(max_new_tokens):
        out.append(torch.where(finished, torch.full_like(tok, pad_id), tok))
        finished = finished | (tok == eos_id)
        if step == max_new_tokens - 1:
            break                       # the next token would not be emitted
        x = embed_tokens(model, tok)[:, None]
        kv_mask = slot_ids[None] <= cur_len[:, None]   # prompt + this token
        logits, caches = model(x, (cur_len + pos_offset)[:, None], kv_mask,
                               caches=caches, cache_pos=cur_len)
        nxt = greedy_token(model, logits[:, 0])
        tok = torch.where(finished, torch.full_like(nxt, eos_id), nxt)
        cur_len = cur_len + 1
    return torch.stack(out, dim=1)
