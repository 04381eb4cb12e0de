"""CLIP text encoder (PyTorch port), with transformers' CLIPTextModel names.

Counterpart of `diffusion_models_moe_tpu/models/clip_text.py`. Attention is
causal and runs in plain torch ops, as the JAX package leaves it to XLA: 77
tokens are too few to need a kernel. The MLPs carry the FF layers' Wanda
surface: the `text_colnorm_sq` tap on the fc1 activations, the neuron fill
on them and the output-weight mask on fc2 (`ivs[i]` acts on layer i).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.config import CLIPTextConfig
from diffusion_models_moe_tpu_torch.models.layers import layer_norm_f32
from diffusion_models_moe_tpu_torch.taps import (Interventions,
                                                 LayerIntervention, TapSpec)


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
    """fc1 -> act -> fc2, with the Wanda tap and masks of layer `index`."""

    def __init__(self, cfg: CLIPTextConfig, index: int = 0):
        super().__init__()
        if cfg.hidden_act not in ("quick_gelu", "gelu"):
            raise NotImplementedError(f"hidden_act {cfg.hidden_act!r}")
        self.act = cfg.hidden_act
        self.index = index
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, tap: Optional[TapSpec] = None,
                iv: Optional[LayerIntervention] = None,
                taps_out: Optional[dict] = None) -> torch.Tensor:
        h = self.fc1(x)
        h = quick_gelu(h) if self.act == "quick_gelu" else F.gelu(h)
        if tap is not None and tap.ff_out_colnorm_sq and taps_out is not None:
            h2 = h.reshape(-1, h.shape[-1]).float()
            h2 = h2 / h2.norm(dim=-1, keepdim=True).clamp_min(1e-12)
            taps_out.setdefault("text_colnorm_sq", {})[self.index] = (
                h2 * h2).sum(0)
        w = self.fc2.weight
        if iv is not None and iv.neuron_mask is not None:
            m = iv.neuron_mask if iv.neuron_mask.dim() == 1 else iv.neuron_mask[0]
            h = h.masked_fill(m, iv.neuron_fill)
        if iv is not None and iv.out_weight_mask is not None:
            wm = iv.out_weight_mask
            wm = wm[0] if wm.dim() == 3 else wm       # (D, I), fc2's layout
            w = w * (1.0 - wm.to(w.dtype))
        return F.linear(h, w, self.fc2.bias)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, index: int = 0):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg, index)

    def forward(self, x: torch.Tensor, **mlp_kw) -> torch.Tensor:
        dt = x.dtype
        x = x + self.self_attn(layer_norm_f32(self.layer_norm1, x).to(dt))
        return x + self.mlp(layer_norm_f32(self.layer_norm2, x).to(dt),
                            **mlp_kw)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg, i) for i in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)


class CLIPTextEncoder(nn.Module):
    """input_ids (B, S) -> final-LayerNorm hidden states (B, S, D). With
    `tap`, the MLPs write their statistics into `taps_out`."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg)

    def forward(self, input_ids: torch.Tensor, *,
                tap: Optional[TapSpec] = None,
                ivs: Optional[Interventions] = None,
                taps_out: Optional[dict] = None) -> torch.Tensor:
        tm = self.text_model
        s = input_ids.shape[1]
        ivs = tuple(ivs) if ivs is not None else ()
        x = (tm.embeddings.token_embedding(input_ids)
             + tm.embeddings.position_embedding.weight[None, :s])
        for i, layer in enumerate(tm.encoder.layers):
            x = layer(x, tap=tap, iv=ivs[i] if i < len(ivs) else None,
                      taps_out=taps_out)
        return layer_norm_f32(tm.final_layer_norm, x).to(x.dtype)
