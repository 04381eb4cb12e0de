"""LLaVA-1.5: the CLIP vision tower + projector + Llama, as the VQA judge
(PyTorch port of `diffusion_models_moe_tpu/models/llava.py`).

The reference's LLAVAScorer loads llava-1.5-13b through transformers
(reference: modularity/llava_score.py:15-41, mod_utils.py:195-290). Here
every stage is the port's own: the CLIP ViT's penultimate-layer patch
features (`models/clip_vision.py`, `feature_layer=-2`, CLS dropped: LLaVA's
'default' select strategy), a 2-layer exact-GELU projector in f32 into the
LM width, and the Llama stack (`models/llama.py`) with its KV-cached greedy
decode. Module names are llava-hf's (`vision_tower.vision_model.*`,
`multi_modal_projector.linear_{1,2}`, `language_model.*`), so a
`LlavaForConditionalGeneration` snapshot maps onto it key for key
(`weights/port_llava.py`).

`build_vqa` returns the standard injected-judge callable
(`vqa(image, question) -> answer text`, with `.batch` and `.chat`) that
`benchmarks/vqa.py`'s protocols consume. Images are what `imaging.
to_uint8_rgb` reads (uint8 or float [0, 255] HWC arrays, PIL images);
`image_features` and `generate` take (B, 3, H, W) tensors in [0, 1].

The JAX version rounds prompt lengths up (`pad_to`, `pad_multiple`) and pads
`.batch`'s last chunk with zero images to bound XLA recompiles; neither
changes an answer (JAX's own pad-invariance test), so neither is ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.config import resolve_device
from diffusion_models_moe_tpu_torch.models.clip_vision import (CLIPVisionConfig,
                                                               CLIPVisionEncoder)
from diffusion_models_moe_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                                         embed_tokens,
                                                         greedy_decode)


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    """Defaults are llava-1.5 (7b and 13b differ only in the LlamaConfig)."""
    vision: CLIPVisionConfig = dataclasses.field(
        default_factory=lambda: CLIPVisionConfig(image_size=336))
    text: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    vision_feature_layer: int = -2
    image_token_id: int = 32000
    eos_id: int = 2

    @property
    def num_image_tokens(self) -> int:
        v = self.vision
        return (v.image_size // v.patch_size) ** 2


def tiny_llava_config() -> LlavaConfig:
    from diffusion_models_moe_tpu_torch.models.clip_vision import \
        tiny_vision_config
    from diffusion_models_moe_tpu_torch.models.llama import tiny_llama_config
    return LlavaConfig(vision=tiny_vision_config(),
                       text=tiny_llama_config(vocab_size=128),
                       image_token_id=120, eos_id=2)


def prompt_template(question: str, history: Sequence = ()) -> str:
    """llava-1.5's conversation format (vicuna_v1; '<image>' is the
    placeholder the processor expands). `history` is prior (question,
    answer) pairs: the image appears only in the first user turn, answers
    close with </s> (the vicuna separator)."""
    if not history:
        return f"USER: <image>\n{question} ASSISTANT:"
    (q0, a0), rest = history[0], history[1:]
    text = f"USER: <image>\n{q0} ASSISTANT: {a0}</s>"
    for q, a in rest:
        text += f"USER: {q} ASSISTANT: {a}</s>"
    return text + f"USER: {question} ASSISTANT:"


class _Projector(nn.Module):
    def __init__(self, cfg: LlavaConfig):
        super().__init__()
        d = cfg.text.hidden_size
        self.linear_1 = nn.Linear(cfg.vision.hidden_size, d)
        self.linear_2 = nn.Linear(d, d)


class LlavaForConditionalGeneration(nn.Module):
    """The vision tower (no projection head: LLaVA takes hidden states), the
    f32 projector and the LM, built on `device` (the card unless the caller
    asks for another) with torch's default initialisation: load a state
    dict (`weights/port_llava.py:load_llava_state`)."""

    def __init__(self, cfg: LlavaConfig = LlavaConfig(), device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        with torch.device(dev):
            self.vision_tower = CLIPVisionEncoder(cfg.vision, device=dev)
            self.vision_tower.visual_projection = None
            self.multi_modal_projector = _Projector(cfg).to(dev).float()
        self.language_model = LlamaModel(cfg.text, device=dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.multi_modal_projector.linear_1.weight.device


@torch.no_grad()
def image_features(model: LlavaForConditionalGeneration,
                   images: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] -> projected image tokens (B, P, lm_width) in
    the LM's dtype: penultimate-layer patch features, CLS dropped, then the
    mlp2x_gelu projector in f32 (exact GELU, as torch's nn.GELU)."""
    cfg = model.cfg
    feats = model.vision_tower(images.to(model.device),
                               feature_layer=cfg.vision_feature_layer)[:, 1:]
    p = model.multi_modal_projector
    h = F.gelu(p.linear_1(feats.float()), approximate="none")
    return p.linear_2(h).to(cfg.text.dtype)


@torch.no_grad()
def splice_image(model: LlavaForConditionalGeneration, input_ids,
                 img_feats: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Replace the single image-token position in `input_ids` (1-D) with the
    image feature span; returns (embeds (B, L, D), length L) for (B, P, D)
    features, the shared text embeddings broadcast over the batch."""
    cfg = model.cfg
    ids = np.asarray(input_ids).reshape(-1)
    where = np.nonzero(ids == cfg.image_token_id)[0]
    if len(where) != 1:
        raise ValueError(f"expected exactly one image token, got {len(where)}")
    i = int(where[0])
    b = img_feats.shape[0]
    lm = model.language_model
    pre = embed_tokens(lm, torch.from_numpy(ids[:i]))[None]
    post = embed_tokens(lm, torch.from_numpy(ids[i + 1:]))[None]
    embeds = torch.cat([pre.expand(b, -1, -1).to(img_feats.dtype), img_feats,
                        post.expand(b, -1, -1).to(img_feats.dtype)], dim=1)
    return embeds, embeds.shape[1]


def preprocess_image(image, size: int) -> np.ndarray:
    """CLIP-style preprocessing to (size, size, 3) float32 in [0, 1]: bicubic
    resize of the SHORT side, the long side int-truncated as HF's
    get_resize_output_image_size, then a centre crop (transformers
    CLIPImageProcessor defaults, which llava-1.5 uses). The tower
    normalizes."""
    from PIL import Image

    from diffusion_models_moe_tpu_torch.imaging import to_uint8_rgb

    pil = Image.fromarray(to_uint8_rgb(image))
    w, h = pil.size
    if w <= h:
        new_w, new_h = size, int(size * h / w)
    else:
        new_w, new_h = int(size * w / h), size
    pil = pil.resize((new_w, new_h), Image.BICUBIC)
    w, h = pil.size
    left, top = (w - size) // 2, (h - size) // 2
    pil = pil.crop((left, top, left + size, top + size))
    return np.asarray(pil, np.float32) / 255.0


def _nchw(images: Sequence[np.ndarray], device) -> torch.Tensor:
    return torch.from_numpy(np.stack(images)).permute(0, 3, 1, 2).to(device)


@torch.no_grad()
def generate(model: LlavaForConditionalGeneration, input_ids,
             images: torch.Tensor, max_new_tokens: int = 32) -> np.ndarray:
    """input_ids (1-D, one image token) + images (B, 3, H, W) in [0, 1] ->
    generated token ids (B, T): every image answers the SAME prompt, and
    co-batched samples decode exactly as they would alone."""
    feats = image_features(model, images)
    embeds, length = splice_image(model, input_ids, feats)
    lengths = torch.full((embeds.shape[0],), length, dtype=torch.long,
                         device=embeds.device)
    toks = greedy_decode(model.language_model, embeds, lengths,
                         max_new_tokens, eos_id=model.cfg.eos_id)
    return toks.cpu().numpy()


def build_vqa(model: LlavaForConditionalGeneration, tokenize: Callable,
              detokenize: Callable, max_new_tokens: int = 32) -> Callable:
    """The `benchmarks/vqa.py` VQAFn: `vqa(image, question) -> answer text`.

    tokenize(text) -> 1-D int ids WITH the image placeholder id and BOS;
    detokenize(ids) -> text; ids 0 and EOS are dropped before it."""
    cfg = model.cfg
    size = cfg.vision.image_size

    def answers(toks: np.ndarray) -> list[str]:
        return [detokenize([int(t) for t in row
                            if int(t) not in (0, cfg.eos_id)]) for row in toks]

    def ask(image, question: str, history: Sequence = ()) -> str:
        ids = np.asarray(tokenize(prompt_template(question, history)))
        img = _nchw([preprocess_image(image, size)], model.device)
        return answers(generate(model, ids, img, max_new_tokens))[0]

    def vqa(image, question: str) -> str:
        return ask(image, question)

    def batch(images: Sequence, question: str, batch_size: int = 8) -> list:
        """Many images on the SAME question in co-batched decodes of up to
        `batch_size` (right-padded co-batching is sample-exact): the big win
        on protocol runs, where the judge asks one question of hundreds of
        images."""
        ids = np.asarray(tokenize(prompt_template(question)))
        out = []
        for start in range(0, len(images), batch_size):
            chunk = _nchw([preprocess_image(img, size)
                           for img in images[start:start + batch_size]],
                          model.device)
            out += answers(generate(model, ids, chunk, max_new_tokens))
        return out

    def chat(image, questions: Sequence[str]) -> list:
        """Multi-turn: each question sees the prior Q/A turns (the
        reference's qwen_score.py / qwen_bb.py chat-with-history
        protocol)."""
        history: list = []
        for q in questions:
            history.append((q, ask(image, q, history)))
        return [a for _, a in history]

    vqa.chat = chat    # type: ignore[attr-defined]
    vqa.batch = batch  # type: ignore[attr-defined]
    return vqa
