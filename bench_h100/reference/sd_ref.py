"""Plain PyTorch reference of the moefied Stable Diffusion family.

SD1.x and SDXL text-to-image: the CLIP text towers, the UNet with top-k
expert routing on every GEGLU feed-forward (MoEfication), the PNDM (PLMS)
and Euler schedulers with classifier-free guidance, and the VAE decoder.
It follows the published models (diffusers' UNet2DConditionModel,
AutoencoderKL's decoder, transformers' CLIPTextModel) and the MoEfication
routing rule, in float32 with TF32 off, in plain torch operations: no
kernel, no fusion, no cache. Parameter names are diffusers' and
transformers', so one state dict serves this module and the measured
program alike.

Departures from the published models, each as the measured program
defines the configuration: `proj_in` / `proj_out` of the spatial
transformers are linear layers (diffusers' `use_linear_projection`),
norms use the given eps, and the SDXL VAE keeps SD's scaling factor where
the configuration file says so.

The configuration is a dict (the benchmark's configuration file); nothing
here imports the measured program.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

CROSS = ("CrossAttnDownBlock2D", "CrossAttnUpBlock2D")


# ---------------------------------------------------------------- schedules
def alphas_cumprod(s: dict) -> np.ndarray:
    n = s["num_train_timesteps"]
    if s["beta_schedule"] == "scaled_linear":
        betas = np.linspace(s["beta_start"] ** 0.5, s["beta_end"] ** 0.5, n,
                            dtype=np.float64) ** 2
    else:
        betas = np.linspace(s["beta_start"], s["beta_end"], n,
                            dtype=np.float64)
    return np.cumprod(1.0 - betas)


def leading_timesteps(n_train: int, steps: int, offset: int) -> np.ndarray:
    """Descending timesteps, diffusers' "leading" spacing."""
    ratio = n_train // steps
    return (np.arange(0, steps) * ratio).round()[::-1].astype(np.int64) + offset


class PNDM:
    """PLMS with skip_prk_steps: steps + 1 model calls, the warm-up
    repeating the second timestep (diffusers' PNDMScheduler)."""

    def __init__(self, s: dict, steps: int):
        n = s["num_train_timesteps"]
        ratio = n // steps
        base = leading_timesteps(n, steps, s["steps_offset"])[::-1]
        self.timesteps = np.concatenate(
            [base[:-1], base[-2:-1], base[-1:]])[::-1].copy()
        self.ratio, self.acp = ratio, alphas_cumprod(s)
        self.init_sigma = 1.0

    def scale_input(self, i, x):
        return x

    def _prev(self, x, t, t_prev, eps):
        a_t = self.acp[t]
        a_p = self.acp[t_prev] if t_prev >= 0 else self.acp[0]
        denom = a_t * math.sqrt(1 - a_p) + math.sqrt(a_t * (1 - a_t) * a_p)
        return math.sqrt(a_p / a_t) * x - (a_p - a_t) / denom * eps

    def run(self, model, x):
        ets, cur = [], None
        for i, t in enumerate(self.timesteps.tolist()):
            eps = model(x, t)
            if i == 1:
                # the warm-up half step: from the stashed sample again
                x = self._prev(cur, t + self.ratio, t,
                               (eps + ets[0]) / 2.0)
                continue
            ets = [eps] + ets[:3]
            n = len(ets)
            if n == 1:
                p = ets[0]
            elif n == 2:
                p = (3 * ets[0] - ets[1]) / 2
            elif n == 3:
                p = (23 * ets[0] - 16 * ets[1] + 5 * ets[2]) / 12
            else:
                p = (55 * ets[0] - 59 * ets[1] + 37 * ets[2] - 9 * ets[3]) / 24
            if i == 0:
                cur = x
            x = self._prev(x, t, t - self.ratio, p)
        return x


class Euler:
    """Euler in sigma space without churn (diffusers'
    EulerDiscreteScheduler, epsilon prediction)."""

    def __init__(self, s: dict, steps: int):
        n = s["num_train_timesteps"]
        acp = alphas_cumprod(s)
        self.timesteps = leading_timesteps(n, steps, s["steps_offset"])
        sig = np.interp(self.timesteps.astype(np.float64), np.arange(n),
                        np.sqrt((1 - acp) / acp))
        self.sigmas = np.concatenate([sig, [0.0]])
        self.init_sigma = float(np.sqrt(sig[0] ** 2 + 1.0))

    def scale_input(self, i, x):
        return x / math.sqrt(self.sigmas[i] ** 2 + 1.0)

    def run(self, model, x):
        for i, t in enumerate(self.timesteps.tolist()):
            eps = model(self.scale_input(i, x), t)
            x = x + eps * (self.sigmas[i + 1] - self.sigmas[i])
        return x


SCHEDULERS = {"pndm": PNDM, "euler": Euler}


def timestep_embedding(t: torch.Tensor, dim: int, flip: bool = True,
                       shift: float = 0.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - shift))
    emb = t.float()[:, None] * freqs[None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip else [sin, cos], dim=-1)


def attention(q, k, v, heads: int, causal: bool = False):
    """softmax(q k^T / sqrt(d)) v over (B, S, C) tokens, per head."""
    b, s, c = q.shape
    d = c // heads
    q, k, v = (t.reshape(t.shape[0], t.shape[1], heads, d).transpose(1, 2)
               for t in (q, k, v))
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    out = torch.softmax(logits, dim=-1) @ v
    return out.transpose(1, 2).reshape(b, s, c)


# ---------------------------------------------------------------- text
class _CLIPAttention(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)


class _CLIPMLP(nn.Module):
    def __init__(self, d, i):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(d, i), nn.Linear(i, d)


class _CLIPLayer(nn.Module):
    def __init__(self, c):
        super().__init__()
        d, eps = c["hidden_size"], c["layer_norm_eps"]
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.self_attn = _CLIPAttention(d)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = _CLIPMLP(d, c["intermediate_size"])


class CLIPText(nn.Module):
    """transformers' CLIPTextModel: returns (final-LN states, the state
    entering the last layer)."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        d = c["hidden_size"]
        tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(c["vocab_size"], d)
        tm.embeddings.position_embedding = nn.Embedding(c["max_length"], d)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList(
            [_CLIPLayer(c) for _ in range(c["num_layers"])])
        tm.final_layer_norm = nn.LayerNorm(d, eps=c["layer_norm_eps"])
        self.text_model = tm

    def forward(self, ids):
        tm, c = self.text_model, self.c
        act = ((lambda h: h * torch.sigmoid(1.702 * h))
               if c["hidden_act"] == "quick_gelu" else F.gelu)
        x = (tm.embeddings.token_embedding(ids)
             + tm.embeddings.position_embedding.weight[None, :ids.shape[1]])
        pen = x
        for j, layer in enumerate(tm.encoder.layers):
            if j == len(tm.encoder.layers) - 1:
                pen = x
            a, h = layer.self_attn, layer.layer_norm1(x)
            x = x + a.out_proj(attention(a.q_proj(h), a.k_proj(h), a.v_proj(h),
                                         c["num_heads"], causal=True))
            m = layer.mlp
            x = x + m.fc2(act(m.fc1(layer.layer_norm2(x))))
        return tm.final_layer_norm(x), pen


# ---------------------------------------------------------------- UNet
class Resnet(nn.Module):
    def __init__(self, cin, cout, groups, eps, temb=None):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, 1, 1)
        self.time_emb_proj = None if temb is None else nn.Linear(temb, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1)
        self.conv_shortcut = (nn.Conv2d(cin, cout, 1) if cin != cout
                              else None)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return h + (x if self.conv_shortcut is None else self.conv_shortcut(x))


class _Sampler(nn.Module):
    def __init__(self, c, stride):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride, 1)


class _Attn(nn.Module):
    def __init__(self, dim, ctx_dim):
        super().__init__()
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx_dim, dim, bias=False)
        self.to_v = nn.Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])


class _Proj(nn.Module):
    def __init__(self, dim, out):
        super().__init__()
        self.proj = nn.Linear(dim, out)


class MoEFF(nn.Module):
    """GEGLU feed-forward (`net.0.proj` gives hidden and gate halves,
    `net.2` is W2) with MoEfication's top-k routing: an expert's score is
    the sum of its neurons' activated gate values; the experts scoring at
    least the k-th best are kept, the other neurons' products are zeroed.
    `patterns` (E, H) is the 0/1 membership of the layer's neurons."""

    def __init__(self, dim, mult):
        super().__init__()
        self.net = nn.ModuleList([_Proj(dim, 2 * mult * dim), nn.Identity(),
                                  nn.Linear(mult * dim, dim)])
        self.patterns: Optional[torch.Tensor] = None
        self.k = 0

    def forward(self, x):
        hidden, gate = self.net[0].proj(x).chunk(2, dim=-1)
        gate = F.gelu(gate)
        if self.patterns is not None:
            g2 = gate.reshape(-1, gate.shape[-1])
            score = g2 @ self.patterns.t()
            kth = torch.topk(score, self.k, dim=-1).values[:, -1:]
            mask = (score >= kth).to(g2.dtype) @ self.patterns
            gate = gate * mask.reshape(gate.shape)
        return self.net[2](hidden * gate)


class Block(nn.Module):
    def __init__(self, dim, heads, ctx_dim, mult):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = _Attn(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = _Attn(dim, ctx_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = MoEFF(dim, mult)

    def forward(self, x, ctx):
        for attn, norm, src in ((self.attn1, self.norm1, None),
                                (self.attn2, self.norm2, ctx)):
            h = norm(x)
            kv = h if src is None else src
            x = x + attn.to_out[0](attention(attn.to_q(h), attn.to_k(kv),
                                             attn.to_v(kv), self.heads))
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, dim, heads, ctx_dim, depth, groups, mult):
        super().__init__()
        self.norm = nn.GroupNorm(groups, dim, eps=1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList(
            [Block(dim, heads, ctx_dim, mult) for _ in range(depth)])
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        for blk in self.transformer_blocks:
            y = blk(y, ctx)
        return self.proj_out(y).reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets, self.attentions = nn.ModuleList(), nn.ModuleList()
        self.downsamplers, self.upsamplers = nn.ModuleList(), nn.ModuleList()


def _per_block(v, i):
    return v if isinstance(v, int) else v[i]


class _Embed(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.linear_1, self.linear_2 = nn.Linear(cin, cout), nn.Linear(cout, cout)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class UNet(nn.Module):
    def __init__(self, u: dict):
        super().__init__()
        self.u = u
        ch = list(u["block_out_channels"])
        n, g, tdim = len(ch), u["norm_num_groups"], 4 * ch[0]
        depth = lambda i: _per_block(u["transformer_layers_per_block"], i)  # noqa: E731

        def st(dim, i):
            return SpatialTransformer(dim, _per_block(u["attention_heads"], i),
                                      u["cross_attention_dim"], depth(i), g,
                                      u["ff_mult"])

        self.conv_in = nn.Conv2d(u["in_channels"], ch[0], 3, 1, 1)
        self.time_embedding = _Embed(ch[0], tdim)
        self.add_embedding = (_Embed(u["addition_embed_dim"]
                                     + 6 * u["addition_time_embed_dim"], tdim)
                              if u["addition_embed_dim"] else None)
        self.down_blocks, skips, cur = nn.ModuleList(), [ch[0]], ch[0]
        for i, kind in enumerate(u["down_block_types"]):
            lv = _Level()
            for _ in range(u["layers_per_block"]):
                lv.resnets.append(Resnet(cur, ch[i], g, 1e-5, tdim))
                cur = ch[i]
                if kind in CROSS:
                    lv.attentions.append(st(cur, i))
                skips.append(cur)
            if i < n - 1:
                lv.downsamplers.append(_Sampler(cur, 2))
                skips.append(cur)
            self.down_blocks.append(lv)
        self.mid_block = _Level()
        self.mid_block.resnets.extend([Resnet(cur, cur, g, 1e-5, tdim),
                                       Resnet(cur, cur, g, 1e-5, tdim)])
        self.mid_block.attentions.append(st(cur, n - 1))
        self.up_blocks = nn.ModuleList()
        for i, kind in enumerate(u["up_block_types"]):
            lv, out = _Level(), ch[n - 1 - i]
            for _ in range(u["layers_per_block"] + 1):
                lv.resnets.append(Resnet(cur + skips.pop(), out, g, 1e-5, tdim))
                cur = out
                if kind in CROSS:
                    lv.attentions.append(st(cur, n - 1 - i))
            if i < n - 1:
                lv.upsamplers.append(_Sampler(cur, 1))
            self.up_blocks.append(lv)
        self.conv_norm_out = nn.GroupNorm(g, ch[0], eps=1e-5)
        self.conv_out = nn.Conv2d(ch[0], u["out_channels"], 3, 1, 1)

    def ffs(self) -> list:
        """The GEGLU FFs in execution order: down, mid, up."""
        return [m for m in self.modules() if isinstance(m, MoEFF)]

    def forward(self, x, t, ctx, added: Optional[tuple] = None):
        u = self.u
        temb = timestep_embedding(torch.full((x.shape[0],), float(t),
                                             device=x.device),
                                  u["block_out_channels"][0],
                                  u["flip_sin_to_cos"], u["freq_shift"])
        temb = self.time_embedding(temb)
        if self.add_embedding is not None:
            pooled, time_ids = added
            tid = timestep_embedding(time_ids.reshape(-1),
                                     u["addition_time_embed_dim"],
                                     u["flip_sin_to_cos"], u["freq_shift"])
            temb = temb + self.add_embedding(torch.cat(
                [pooled, tid.reshape(x.shape[0], -1)], dim=-1))
        h = self.conv_in(x)
        stack = [h]
        for lv in self.down_blocks:
            for j, res in enumerate(lv.resnets):
                h = res(h, temb)
                if lv.attentions:
                    h = lv.attentions[j](h, ctx)
                stack.append(h)
            if lv.downsamplers:
                h = lv.downsamplers[0].conv(h)
                stack.append(h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, temb), ctx),
                           temb)
        for lv in self.up_blocks:
            for j, res in enumerate(lv.resnets):
                h = res(torch.cat([h, stack.pop()], dim=1), temb)
                if lv.attentions:
                    h = lv.attentions[j](h, ctx)
            if lv.upsamplers:
                h = lv.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0,
                                                        mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


# ---------------------------------------------------------------- VAE
class _VAEAttn(nn.Module):
    def __init__(self, c, g):
        super().__init__()
        self.group_norm = nn.GroupNorm(g, c, eps=1e-6)
        self.to_q, self.to_k = nn.Linear(c, c), nn.Linear(c, c)
        self.to_v, self.to_out = nn.Linear(c, c), nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.to_out[0](attention(self.to_q(y), self.to_k(y),
                                     self.to_v(y), 1))
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class VAEDecoder(nn.Module):
    """AutoencoderKL's decoder: scaled latents -> images in [-1, 1]."""

    def __init__(self, v: dict):
        super().__init__()
        self.v = v
        rev, g = list(reversed(v["block_out_channels"])), v["norm_num_groups"]
        lc = v["latent_channels"]
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)
        d = nn.Module()
        d.conv_in = nn.Conv2d(lc, rev[0], 3, 1, 1)
        d.mid_block = _Level()
        d.mid_block.resnets.extend([Resnet(rev[0], rev[0], g, 1e-6),
                                    Resnet(rev[0], rev[0], g, 1e-6)])
        d.mid_block.attentions.append(_VAEAttn(rev[0], g))
        d.up_blocks = nn.ModuleList()
        for i, c in enumerate(rev):
            lv = _Level()
            for j in range(v["layers_per_block"] + 1):
                lv.resnets.append(Resnet(rev[max(i - 1, 0)] if j == 0 else c,
                                         c, g, 1e-6))
            if i < len(rev) - 1:
                lv.upsamplers.append(_Sampler(c, 1))
            d.up_blocks.append(lv)
        d.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        d.conv_out = nn.Conv2d(rev[-1], v["out_channels"], 3, 1, 1)
        self.decoder = d

    def forward(self, z):
        d = self.decoder
        h = d.conv_in(self.post_quant_conv(z / self.v["scaling_factor"]))
        m = d.mid_block
        h = m.resnets[1](m.attentions[0](m.resnets[0](h)))
        for lv in d.up_blocks:
            for res in lv.resnets:
                h = res(h)
            if lv.upsamplers:
                h = lv.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0,
                                                        mode="nearest"))
        return d.conv_out(F.silu(d.conv_norm_out(h)))


# ---------------------------------------------------------------- pipeline
def expert_patterns(labels: np.ndarray, device) -> torch.Tensor:
    """(H,) expert labels -> (E, H) 0/1 membership, float32."""
    lab = torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=device)
    return (lab[None, :] == torch.arange(int(lab.max()) + 1,
                                         device=device)[:, None]).float()


class Reference:
    """The whole text-to-image model of one configuration dict, in f32.
    `modules()` has the state-dict groups the benchmark makes weights for:
    "unet", "text_encoder" (and SDXL's "text_encoder_2",
    "text_projection_2"), "vae"."""

    def __init__(self, cfg: dict, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        with torch.device(self.device):
            self.unet = UNet(cfg["unet"])
            self.towers = [CLIPText(t) for t in cfg["text_encoders"]]
            self.projection = (nn.Linear(cfg["text_encoders"][-1]["hidden_size"],
                                         cfg["text_encoders"][-1]["hidden_size"],
                                         bias=False)
                               if cfg["pipeline"] == "sdxl" else None)
            self.vae = VAEDecoder(cfg["vae"])

    def modules(self) -> dict:
        out = {"unet": self.unet, "text_encoder": self.towers[0]}
        if self.projection is not None:
            out["text_encoder_2"] = self.towers[1]
            out["text_projection_2"] = self.projection
        out["vae"] = self.vae
        return out

    def load(self, state_dicts: dict) -> None:
        """Loads the benchmark's weights, each cast to f32."""
        for key, module in self.modules().items():
            module.load_state_dict({k: v.float() for k, v in
                                    state_dicts[key].items()}, strict=True)

    def set_routing(self, labels: Sequence[np.ndarray], topk_ratio: float):
        """Routes FF i by labels[i]: k = max(int(E * topk_ratio), 1)."""
        for ff, lab in zip(self.unet.ffs(), labels):
            ff.patterns = expert_patterns(lab, self.device)
            ff.k = max(int(ff.patterns.shape[0] * topk_ratio), 1)

    def conditioning(self, cond_ids, uncond_ids):
        """(context (2B, S, D) unconditional half first, added or None)."""
        ids = torch.cat([uncond_ids, cond_ids]).to(self.device)
        if self.projection is None:
            return self.towers[0](ids)[0], None
        _, pen1 = self.towers[0](ids)
        final2, pen2 = self.towers[1](ids)
        pooled = final2[torch.arange(ids.shape[0], device=self.device),
                        ids.argmax(dim=-1)]
        px = 8 * self.cfg["sample_size"]
        time_ids = torch.tensor([[px, px, 0, 0, px, px]], dtype=torch.float32,
                                device=self.device).expand(ids.shape[0], -1)
        return (torch.cat([pen1, pen2], dim=-1),
                (self.projection(pooled), time_ids))

    @torch.no_grad()
    def generate(self, cond_ids, uncond_ids, noise, steps: int,
                 guidance: float, bf16: bool = False) -> torch.Tensor:
        """Token ids (B, S), N(0, 1) noise (B, C, s, s) -> images (B, 3, H,
        W) in [0, 1], float32, with TF32 off throughout. With `bf16` the
        model runs under bfloat16 autocast (products and convolutions in
        bfloat16, norms and softmax in float32): the floor that bfloat16
        rounding alone sets, on the same inputs."""
        cfg = self.cfg
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.autocast(torch.device(self.device).type,
                                dtype=torch.bfloat16, enabled=bf16):
                ctx, added = self.conditioning(cond_ids, uncond_ids)
                sched = SCHEDULERS[cfg["scheduler"]["name"]](cfg["scheduler"],
                                                             steps)

                def model(x, t):
                    e_u, e_c = self.unet(sched_in(x), t, ctx, added).chunk(2)
                    return (e_u + guidance * (e_c - e_u)).float()

                sched_in = lambda x: torch.cat([x, x])  # noqa: E731
                x = noise.to(self.device, torch.float32) * sched.init_sigma
                x = sched.run(model, x)
                img = torch.cat([self.vae(x[i:i + 1]).float()
                                 for i in range(x.shape[0])])
            return torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
