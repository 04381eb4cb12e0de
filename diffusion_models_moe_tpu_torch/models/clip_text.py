"""CLIP text encoder (PyTorch port), with transformers' CLIPTextModel names.

Counterpart of `diffusion_models_moe_tpu/models/clip_text.py` without its MLP
taps and Wanda masks. Attention is causal and runs in plain torch ops, as
the JAX package leaves it to XLA: 77 tokens are too few to need a kernel.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.config import CLIPTextConfig
from diffusion_models_moe_tpu_torch.models.layers import layer_norm_f32


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        hd = c // self.heads

        def split(t):
            return t.view(b, s, self.heads, hd).transpose(1, 2)

        q = split(self.q_proj(x) / hd ** 0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        logits = (q @ k.transpose(-1, -2)).float()
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        p = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
        out = (p.to(x.dtype) @ v).transpose(1, 2).reshape(b, s, c)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        if cfg.hidden_act not in ("quick_gelu", "gelu"):
            raise NotImplementedError(f"hidden_act {cfg.hidden_act!r}")
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        h = quick_gelu(h) if self.act == "quick_gelu" else F.gelu(h)
        return self.fc2(h)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = x + self.self_attn(layer_norm_f32(self.layer_norm1, x).to(dt))
        return x + self.mlp(layer_norm_f32(self.layer_norm2, x).to(dt))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)


class CLIPTextEncoder(nn.Module):
    """input_ids (B, S) -> final-LayerNorm hidden states (B, S, D)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        s = input_ids.shape[1]
        x = (tm.embeddings.token_embedding(input_ids)
             + tm.embeddings.position_embedding.weight[None, :s])
        for layer in tm.encoder.layers:
            x = layer(x)
        return layer_norm_f32(tm.final_layer_norm, x).to(x.dtype)
