"""Qwen2-VL: its native vision transformer and the M-RoPE Qwen2 LM, the
alternate VQA judge (PyTorch port of `diffusion_models_moe_tpu/models/
qwen2vl.py`).

The reference scores with either LLaVA-1.5 or a Qwen VLM (reference:
modularity/qwen_score.py:15-45). Its checkpoint (Qwen-VL-Chat) loads only
with remote code, so the judge is its successor Qwen2-VL, which
transformers specifies in full, behind the same VQA interface:

  * vision: flattened (S, C * tps * ps * ps) patches -> the patch embedding
    (a Conv3d whose stride is its kernel: one product with its weight, no
    bias) -> pre-LN blocks with a fused QKV projection, 2-D rotary
    embeddings (in f32) over the merge-grouped (h, w) patch order and
    attention within each temporal frame, `quick_gelu` MLPs -> the
    PatchMerger (LayerNorm, each 2 x 2 group concatenated, an exact-GELU
    MLP) into the LM width
  * LM: `models/llama.py` with Qwen2's q/k/v biases and the 3-D
    multimodal RoPE (`mrope_section`); the KV-cached greedy decode continues
    from the largest prompt position + 1 (`rope_index`'s delta), not from
    the prompt length
  * preprocessing: transformers' `smart_resize` (both sides to multiples of
    patch x merge, the pixel count clamped), PIL bicubic, the CLIP mean and
    std, the frame duplicated to the temporal patch size and the image
    processor's merge-grouped flatten order, in numpy.

Module names are transformers' (`visual.patch_embed.proj`,
`visual.blocks.{i}.attn.qkv`, `visual.merger.mlp.0`; the LM's under
`language_model.`), so a `Qwen2VLForConditionalGeneration` snapshot maps
onto it key for key (`weights/port_qwen2vl.py`). The attention is plain
torch math and the products cuBLAS, as in JAX, where they are XLA: no
hand-written kernel runs here.

The JAX version rounds prompt lengths up (`generate(pad_to=)`,
`build_vqa(pad_multiple=)`) and pads `.batch`'s last chunk with zero
images to bound XLA recompiles; neither changes an answer, so neither is
ported (as for LLaVA).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.config import resolve_device
from diffusion_models_moe_tpu_torch.models.clip_vision import (CLIP_IMAGE_MEAN,
                                                               CLIP_IMAGE_STD)
from diffusion_models_moe_tpu_torch.models.llama import (NEG_INF, LlamaConfig,
                                                         LlamaModel,
                                                         embed_tokens,
                                                         greedy_decode)


@dataclasses.dataclass(frozen=True)
class Qwen2VisionConfig:
    """Defaults are the Qwen2-VL-2B/7B vision tower (they share it)."""
    depth: int = 32
    embed_dim: int = 1280
    hidden_size: int = 3584          # LM width the merger projects into
    mlp_ratio: float = 4.0
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return (self.in_channels * self.temporal_patch_size
                * self.patch_size ** 2)


@dataclasses.dataclass(frozen=True)
class Qwen2VLConfig:
    vision: Qwen2VisionConfig = dataclasses.field(
        default_factory=Qwen2VisionConfig)
    text: LlamaConfig = dataclasses.field(default_factory=lambda: LlamaConfig(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_layers=28, num_heads=28, num_kv_heads=4, rope_theta=1e6,
        rms_eps=1e-6, attention_bias=True, mrope_section=(16, 24, 24)))
    image_token_id: int = 151655
    vision_start_token_id: int = 151652
    eos_id: int = 151645             # <|im_end|>
    pad_id: int = 151643             # <|endoftext|>


def tiny_qwen2vl_config() -> Qwen2VLConfig:
    return Qwen2VLConfig(
        vision=Qwen2VisionConfig(depth=2, embed_dim=32, hidden_size=48,
                                 mlp_ratio=2.0, num_heads=4, patch_size=4),
        text=LlamaConfig(vocab_size=128, hidden_size=48, intermediate_size=96,
                         num_layers=2, num_heads=4, num_kv_heads=2,
                         rope_theta=10000.0, rms_eps=1e-6,
                         attention_bias=True, mrope_section=(2, 2, 2)),
        image_token_id=120, vision_start_token_id=121, eos_id=122, pad_id=0)


# ------------------------------------------------------------- preprocessing
def smart_resize(height: int, width: int, factor: int,
                 min_pixels: int, max_pixels: int) -> tuple[int, int]:
    """transformers' Qwen2VLImageProcessor.smart_resize: both sides rounded
    to multiples of `factor`, the pixel count kept in [min_pixels,
    max_pixels]."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("aspect ratio over 200")
    h = round(height / factor) * factor
    w = round(width / factor) * factor
    if h * w > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h = max(factor, math.floor(height / beta / factor) * factor)
        w = max(factor, math.floor(width / beta / factor) * factor)
    elif h * w < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h = math.ceil(height * beta / factor) * factor
        w = math.ceil(width * beta / factor) * factor
    return h, w


def preprocess_image(image, cfg: Qwen2VisionConfig,
                     min_pixels: int = 56 * 56,
                     max_pixels: int = 28 * 28 * 1280
                     ) -> tuple[np.ndarray, tuple[int, int, int]]:
    """image -> (flattened patches (S, patch_dim) float32, grid (t, h, w)).

    As transformers' processor: bicubic resize to the smart_resize sides,
    rescale to [0, 1], the CLIP mean and std, the frame duplicated to the
    temporal patch size, then the merge-grouped patch flatten order
    (image_processing_qwen2_vl.py:270-297)."""
    from PIL import Image

    from diffusion_models_moe_tpu_torch.imaging import to_uint8_rgb

    img = to_uint8_rgb(image)
    ih, iw = img.shape[:2]
    factor = cfg.patch_size * cfg.spatial_merge_size
    h, w = smart_resize(ih, iw, factor, min_pixels, max_pixels)
    pil = Image.fromarray(img).resize((w, h), Image.BICUBIC)
    x = np.asarray(pil, np.float32) / 255.0
    x = (x - np.asarray(CLIP_IMAGE_MEAN)) / np.asarray(CLIP_IMAGE_STD)
    x = x.transpose(2, 0, 1)[None]                       # (1, C, H, W)
    x = np.repeat(x, cfg.temporal_patch_size, axis=0)    # duplicate frame
    ps, m, tps = cfg.patch_size, cfg.spatial_merge_size, cfg.temporal_patch_size
    grid_t = x.shape[0] // tps
    grid_h, grid_w = h // ps, w // ps
    x = x.reshape(grid_t, tps, cfg.in_channels, grid_h // m, m, ps,
                  grid_w // m, m, ps)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = x.reshape(grid_t * grid_h * grid_w, cfg.patch_dim)
    return np.ascontiguousarray(flat, np.float32), (grid_t, grid_h, grid_w)


def vision_rope(cfg: Qwen2VisionConfig,
                grid: tuple[int, int, int]) -> np.ndarray:
    """(S, head_dim / 2) rotary angles over the merge-grouped patch order
    (modeling_qwen2_vl.py rot_pos_emb), in f32."""
    t, h, w = grid
    m = cfg.spatial_merge_size
    hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
    wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))

    def grouped(p):
        return p.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).ravel()

    pos = np.stack([grouped(hpos), grouped(wpos)], axis=-1)   # (h*w, 2)
    pos = np.tile(pos, (t, 1))
    dim = cfg.head_dim // 2
    inv = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    freqs = np.arange(max(h, w), dtype=np.float32)[:, None] * inv[None]
    return freqs[pos].reshape(len(pos), -1)                   # (S, hd/2)


# ------------------------------------------------------------- vision tower
class _PatchEmbed(nn.Module):
    def __init__(self, cfg: Qwen2VisionConfig):
        super().__init__()
        k = (cfg.temporal_patch_size, cfg.patch_size, cfg.patch_size)
        self.proj = nn.Conv3d(cfg.in_channels, cfg.embed_dim, k, stride=k,
                              bias=False)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        w = self.proj.weight
        return F.linear(patches.to(w.dtype), w.reshape(w.shape[0], -1))


class _VisionAttention(nn.Module):
    def __init__(self, cfg: Qwen2VisionConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = nn.Linear(cfg.embed_dim, 3 * cfg.embed_dim)
        self.proj = nn.Linear(cfg.embed_dim, cfg.embed_dim)

    def forward(self, x, cos, sin, mask):
        cfg = self.cfg
        s, nh, hd = x.shape[0], cfg.num_heads, cfg.head_dim
        q, k, v = (a.reshape(s, nh, hd).transpose(0, 1)
                   for a in self.qkv(x).chunk(3, dim=-1))

        def rope(a):    # rotate_half over the head dim, in f32 as HF
            af = a.float()
            half = torch.cat([-af[..., hd // 2:], af[..., :hd // 2]], dim=-1)
            return (af * cos + half * sin).to(x.dtype)

        q, k = rope(q), rope(k)
        logits = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
        logits = logits.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        return self.proj((probs @ v).transpose(0, 1).reshape(s, cfg.embed_dim))


class _VisionMLP(nn.Module):
    def __init__(self, cfg: Qwen2VisionConfig):
        super().__init__()
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.fc1 = nn.Linear(cfg.embed_dim, hidden)
        self.fc2 = nn.Linear(hidden, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))   # quick_gelu


class _VisionBlock(nn.Module):
    def __init__(self, cfg: Qwen2VisionConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps)
        self.attn = _VisionAttention(cfg)
        self.mlp = _VisionMLP(cfg)

    def forward(self, x, cos, sin, mask):
        dt = x.dtype
        x = x + self.attn(self.norm1(x.float()).to(dt), cos, sin, mask)
        return x + self.mlp(self.norm2(x.float()).to(dt))


class _PatchMerger(nn.Module):
    def __init__(self, cfg: Qwen2VisionConfig):
        super().__init__()
        width = cfg.embed_dim * cfg.spatial_merge_size ** 2
        self.ln_q = nn.LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps)
        self.mlp = nn.Sequential(nn.Linear(width, width), nn.GELU(),
                                 nn.Linear(width, cfg.hidden_size))


class Qwen2VisionTower(nn.Module):
    """Flattened patches (S, patch_dim) of one image and its grid ->
    (S / merge^2, LM width)."""

    def __init__(self, cfg: Qwen2VisionConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg)
        self.blocks = nn.ModuleList(_VisionBlock(cfg)
                                    for _ in range(cfg.depth))
        self.merger = _PatchMerger(cfg)

    @torch.no_grad()
    def forward(self, patches: torch.Tensor,
                grid: tuple[int, int, int]) -> torch.Tensor:
        cfg = self.cfg
        dev = self.merger.ln_q.weight.device
        x = self.patch_embed(torch.as_tensor(patches, device=dev)
                             ).to(cfg.dtype)
        angles = torch.from_numpy(vision_rope(cfg, tuple(grid))).to(dev)
        emb = torch.cat([angles, angles], dim=-1)
        cos, sin = torch.cos(emb), torch.sin(emb)
        # attention within each temporal frame (HF's cu_seqlens chunks)
        s = x.shape[0]
        frame = torch.arange(s, device=dev) // (grid[1] * grid[2])
        mask = frame[:, None] == frame[None, :]
        for block in self.blocks:
            x = block(x, cos, sin, mask)
        m = self.merger
        x = m.ln_q(x.float()).to(cfg.dtype)
        mm = cfg.spatial_merge_size ** 2
        x = x.reshape(s // mm, mm * cfg.embed_dim)
        return m.mlp[2](F.gelu(m.mlp[0](x), approximate="none"))


class Qwen2VLForConditionalGeneration(nn.Module):
    """The vision tower (`visual`) and the LM (`language_model`), built on
    `device` (the card unless the caller asks for another) with torch's
    default initialisation: load a state dict
    (`weights/port_qwen2vl.py:port_qwen2vl`)."""

    def __init__(self, cfg: Qwen2VLConfig = Qwen2VLConfig(), device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        with torch.device(dev):
            self.visual = Qwen2VisionTower(cfg.vision).to(cfg.vision.dtype)
        for m in self.visual.modules():
            if isinstance(m, nn.LayerNorm):
                m.float()
        self.language_model = LlamaModel(cfg.text, device=dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.visual.merger.ln_q.weight.device


# ------------------------------------------------------------------ M-RoPE
def rope_index(cfg: Qwen2VLConfig, ids: np.ndarray,
               grid: tuple[int, int, int]) -> tuple[np.ndarray, int]:
    """Single-sequence 3-D position ids (HF get_rope_index, one image).

    `ids` carries the image token EXPANDED to its merged-patch count.
    Returns (positions (3, 1, L) int32, delta = max_pos + 1 - L)."""
    ids = np.asarray(ids).reshape(-1)
    m = cfg.vision.spatial_merge_size
    t, h, w = grid
    lh, lw = h // m, w // m
    img = np.nonzero(ids == cfg.image_token_id)[0]
    if len(img) == 0:
        pos = np.broadcast_to(np.arange(len(ids)), (3, len(ids)))
        return np.ascontiguousarray(pos[:, None]).astype(np.int32), 0
    if len(img) != t * lh * lw:
        raise ValueError(f"{len(img)} image tokens != grid {t}x{lh}x{lw}")
    st = int(img[0])
    parts = [np.broadcast_to(np.arange(st), (3, st))]
    t_idx = np.repeat(np.arange(t), lh * lw)
    h_idx = np.tile(np.repeat(np.arange(lh), lw), t)
    w_idx = np.tile(np.arange(lw), t * lh)
    parts.append(np.stack([t_idx, h_idx, w_idx]) + st)
    tail = len(ids) - (st + t * lh * lw)
    # parts[0] is empty where the sequence opens with the image span
    st_idx = max(int(p.max()) for p in parts if p.size) + 1
    parts.append(np.broadcast_to(np.arange(tail), (3, tail)) + st_idx)
    pos = np.concatenate(parts, axis=1)
    delta = int(pos.max()) + 1 - len(ids)
    return np.ascontiguousarray(pos[:, None]).astype(np.int32), delta


# ---------------------------------------------------------------- front door
def prompt_ids(tokenize: Callable, question: str, n_image_tokens: int,
               cfg: Qwen2VLConfig, history: Sequence = ()) -> np.ndarray:
    """Qwen2-VL chat-format ids with the image pad expanded.

    tokenize(text) -> ids WITHOUT the vision tokens; this builds the system
    and user turns and splices <|vision_start|> <pad> * n <|vision_end|>
    (the processor's expansion; vision_end is the start id + 1 in the
    published vocabulary). `history` is prior (question, answer) pairs: the
    image rides only the first user turn, as the HF chat template has it."""
    sys_part = np.asarray(tokenize(
        "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
        "<|im_start|>user\n"), np.int64)
    turns = ""
    for q, a in history:
        turns += (f"{q}<|im_end|>\n<|im_start|>assistant\n"
                  f"{a}<|im_end|>\n<|im_start|>user\n")
    tail = np.asarray(tokenize(
        f"{turns}{question}<|im_end|>\n<|im_start|>assistant\n"), np.int64)
    vis = np.concatenate([[cfg.vision_start_token_id],
                          [cfg.image_token_id] * n_image_tokens,
                          [cfg.vision_start_token_id + 1]])
    return np.concatenate([sys_part, vis, tail]).astype(np.int64)


@torch.no_grad()
def image_features(model: Qwen2VLForConditionalGeneration, patches,
                   grid: tuple[int, int, int]) -> torch.Tensor:
    """Patches (S, patch_dim) or (B, S, patch_dim) of same-grid images ->
    merged features (B, S / merge^2, LM width), one tower pass an image
    (as JAX)."""
    patches = np.asarray(patches)
    pb = patches if patches.ndim == 3 else patches[None]
    return torch.stack([model.visual(torch.from_numpy(p), grid) for p in pb])


@torch.no_grad()
def generate(model: Qwen2VLForConditionalGeneration, input_ids, patches,
             grid: tuple[int, int, int],
             max_new_tokens: int = 32) -> np.ndarray:
    """input_ids (1-D, image token expanded) + preprocessed patches ->
    generated ids (B, T).

    `patches` is (n_patches, patch_dim) for one image or (B, n_patches,
    patch_dim) for a co-batch of same-grid images all answering the SAME
    prompt: the M-RoPE positions depend only on (ids, grid), so every sample
    shares them, and co-batched samples decode exactly as alone. Slots after
    EOS carry `cfg.pad_id`."""
    cfg = model.cfg
    feats = image_features(model, patches, grid)
    ids = np.asarray(input_ids).reshape(-1)
    img = np.nonzero(ids == cfg.image_token_id)[0]
    if len(img) != feats.shape[1]:
        raise ValueError(f"{len(img)} image tokens != {feats.shape[1]} "
                         "vision features")
    b, dev = feats.shape[0], model.device
    lm = model.language_model
    embeds = embed_tokens(lm, torch.from_numpy(ids))
    embeds = embeds[None].repeat(b, 1, 1)
    embeds[:, torch.from_numpy(img).to(dev)] = feats.to(embeds.dtype)
    positions, delta = rope_index(cfg, ids, grid)
    positions = torch.from_numpy(positions).to(dev).long().expand(3, b, -1)
    length = len(ids)
    toks = greedy_decode(
        lm, embeds, torch.full((b,), length, dtype=torch.long, device=dev),
        max_new_tokens, eos_id=cfg.eos_id, pad_id=cfg.pad_id,
        prefill_positions=positions,
        pos_offset=torch.full((b,), delta, dtype=torch.long, device=dev))
    return toks.cpu().numpy()


def build_vqa(model: Qwen2VLForConditionalGeneration, tokenize: Callable,
              detokenize: Callable, max_new_tokens: int = 32,
              max_pixels: int = 28 * 28 * 576) -> Callable:
    """The `benchmarks/vqa.py` VQAFn on the Qwen2-VL judge: `vqa(image,
    question) -> answer text`, with `.batch` and `.chat`.

    tokenize(text) -> 1-D ids (plain text with the <|im_start|> strings,
    which the tokenizer.json holds as added tokens); detokenize(ids) ->
    text; pad and EOS ids are dropped before it. `max_pixels` bounds the
    vision sequence (by default 576 merged tokens)."""
    cfg = model.cfg
    m2 = cfg.vision.spatial_merge_size ** 2

    def answers(toks: np.ndarray) -> list[str]:
        return [detokenize([int(t) for t in row
                            if int(t) not in (cfg.pad_id, cfg.eos_id)])
                for row in toks]

    def ask(image, question: str, history: Sequence = ()) -> str:
        patches, grid = preprocess_image(image, cfg.vision,
                                         max_pixels=max_pixels)
        ids = prompt_ids(tokenize, question, patches.shape[0] // m2, cfg,
                         history)
        return answers(generate(model, ids, patches, grid,
                                max_new_tokens=max_new_tokens))[0]

    def vqa(image, question: str) -> str:
        return ask(image, question)

    def batch(images: Sequence, question: str,
              batch_size: int = 8) -> list:
        """Many images on the SAME question in co-batched decodes of up to
        `batch_size`, grouped by their smart-resize grid (protocol runs
        judge same-size generations, so one group as a rule); within a
        group every sample shares ids and positions and co-batching is
        sample-exact. Answers in input order."""
        pre = [preprocess_image(img, cfg.vision, max_pixels=max_pixels)
               for img in images]
        groups: dict = {}
        for i, (_, grid) in enumerate(pre):
            groups.setdefault(tuple(grid), []).append(i)
        out: list = [None] * len(pre)
        for grid, idxs in groups.items():
            ids = prompt_ids(tokenize, question, pre[idxs[0]][0].shape[0] // m2,
                             cfg)
            for start in range(0, len(idxs), batch_size):
                chunk = idxs[start:start + batch_size]
                toks = generate(model, ids, np.stack([pre[i][0] for i in chunk]),
                                grid, max_new_tokens=max_new_tokens)
                for i, text in zip(chunk, answers(toks)):
                    out[i] = text
        return out

    def chat(image, questions: Sequence[str]) -> list:
        """Multi-turn chat with history (the reference's qwen_score.py and
        qwen_bb.py warm up with 'what is this?' before the real
        question)."""
        history: list = []
        for q in questions:
            history.append((q, ask(image, q, history)))
        return [a for _, a in history]

    vqa.chat = chat    # type: ignore[attr-defined]
    vqa.batch = batch  # type: ignore[attr-defined]
    return vqa
