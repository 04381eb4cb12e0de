"""VQA judge scoring: "does the image still contain the concept?" (PyTorch
port of `diffusion_models_moe_tpu/benchmarks/vqa.py`).

Rebuild of the reference's LLaVA-1.5-13B / Qwen-VL-Chat scorers
(reference: modularity/llava_score.py:15-41, LLAVAScorer in
modularity/mod_utils.py:195-290, modularity/qwen_score.py:15-45): a VLM is
asked structured questions about generated images before/after concept
removal; answers are parsed into object-presence and style scores.

The VLM judge runs natively: `load_llava_native` reads an HF llava-1.5
snapshot into the port's CLIP vision + Llama stack (`models/llava.py`,
`weights/port_llava.py`: KV-cached greedy decode) on the card, with the
port's own Llama tokenizer (`data/tokenizer.py:load_llama_tokenizer`, no
`tokenizers`), and returns the standard callable. The injected interface
(`vqa(image, question) -> answer text`) stays, so a local transformers
checkpoint (`load_transformers_vqa`) or another judge plugs in; the
question protocol and answer parsing are self-contained.
"""
from __future__ import annotations

import re
from typing import Callable, Optional, Sequence

import numpy as np

VQAFn = Callable[[object, str], str]


def load_transformers_vqa(model_path: str, device="cuda") -> VQAFn:
    """Build a VQA callable from a local image-text-to-text checkpoint, run
    by transformers' pipeline on `device` (the card unless the caller asks
    for another)."""
    from diffusion_models_moe_tpu_torch.config import resolve_device
    dev = resolve_device(device)
    from transformers import pipeline as hf_pipeline  # type: ignore
    pipe = hf_pipeline("image-text-to-text", model=model_path, device=dev)

    def vqa(image, question: str) -> str:
        # return_full_text=False: the pipeline otherwise ECHOES the question
        # before the answer, and the parsers would match tokens from the
        # question itself ('yes or no' -> always yes; '(1)cat' -> always 1)
        out = pipe(images=image, text=question, max_new_tokens=32,
                   return_full_text=False)
        text = out[0]["generated_text"] if isinstance(out, list) else str(out)
        # belt-and-braces for backends that ignore the flag
        if text.startswith(question):
            text = text[len(question):]
        return text

    return vqa


def load_llava_native(snapshot_dir: str, size: str = "auto",
                      max_new_tokens: int = 32, quant_int8: bool = False,
                      device="cuda") -> VQAFn:
    """The native LLaVA-1.5 judge from an HF snapshot directory, on
    `device` (the card unless the caller asks for another), in f32.

    size: '7b' | '13b' | 'auto' (reads config.json's text hidden size).
    `quant_int8`: W8A8 LM projections (judge answers may differ slightly).
    The 13B judge fits one 80-GB card in f32 (about 53 GB), so the JAX
    version's tensor-parallel `mesh=` is not taken."""
    import dataclasses
    import json
    import os

    from diffusion_models_moe_tpu_torch.data.tokenizer import \
        load_llama_tokenizer
    from diffusion_models_moe_tpu_torch.models.llava import (
        LlavaForConditionalGeneration, build_vqa)
    from diffusion_models_moe_tpu_torch.weights.port_llava import (
        llava_7b_config, llava_13b_config, load_llava_state, port_llava)

    if size == "auto":
        with open(os.path.join(snapshot_dir, "config.json")) as f:
            hidden = json.load(f).get("text_config", {}).get("hidden_size",
                                                             4096)
        size = "13b" if hidden == 5120 else "7b"
    cfg = llava_13b_config() if size == "13b" else llava_7b_config()
    if quant_int8:
        cfg = dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, quant_int8=True))
    model = LlavaForConditionalGeneration(cfg, device=device)
    load_llava_state(model, port_llava(snapshot_dir, cfg))
    encode, decode = load_llama_tokenizer(snapshot_dir)
    return build_vqa(model, encode, decode, max_new_tokens=max_new_tokens)


def object_question(obj: str) -> str:
    """Object-presence question (reference: mod_utils.py LLAVAScorer object path)."""
    return (f"Is there a {obj} in the image? "
            "Answer with a single word, yes or no.")


def style_question(artist: str) -> str:
    """Style-attribution question (reference: mod_utils.py style path)."""
    return (f"Is this image in the style of {artist}? "
            "Answer with a single word, yes or no.")


def parse_yes_no(answer: str) -> Optional[bool]:
    a = answer.strip().lower()
    m = re.search(r"\b(yes|no)\b", a)
    return None if m is None else (m.group(1) == "yes")


def vqa_presence_score(vqa: VQAFn, images: Sequence, question: str) -> dict:
    """Fraction of images where the judge answers 'yes'; unparseable answers are
    excluded and counted. A judge exposing `.batch` (the native LLaVA one)
    answers in co-batched decodes (sample-exact, much faster)."""
    batch = getattr(vqa, "batch", None)
    answers = (batch(images, question) if batch is not None
               else [vqa(img, question) for img in images])
    yes = no = unparsed = 0
    for reply in answers:
        ans = parse_yes_no(reply)
        if ans is None:
            unparsed += 1
        elif ans:
            yes += 1
        else:
            no += 1
    n = yes + no
    return {"yes_frac": yes / n if n else float("nan"),
            "n": n, "unparsed": unparsed}


# ---------------------------------------------------------------------------
# Multiple-choice protocol (reference: LLAVAScorer, mod_utils.py:195-290):
# object identification over the prompt's object list + numeric
# style/gender/scene questions, both answered "number only".
# ---------------------------------------------------------------------------

_STYLE_ADJECTIVES = ("painting", "Van Gogh", "Monet", "Pablo Picasso", "manga")


def multiple_choice_object_question(objects: Sequence[str]) -> str:
    """'(1)cat (2)dog ...' — identify the main object by number
    (reference: mod_utils.py:203-206)."""
    options = " ".join(f"({i + 1}){o}" for i, o in enumerate(objects))
    return (f"What is the main object in this image? Answer from the "
            f"following options: {options} . Answer the number only and do "
            f"not include any other texts (e.g., 1).")


def concept_style_question(concept: str) -> str:
    """Per-concept numeric question table (reference: mod_utils.py:207-220).
    '<object>' is substituted per prompt by the scorer."""
    if concept in _STYLE_ADJECTIVES:
        return (f"What is the style of this image? Answer from the following "
                f"options: (1)photo (2){concept}. Answer the number only and "
                f"do not include any other texts (e.g., 1).")
    table = {
        "under a tree": ("Is the <object> under a tree in the image? Answer "
                         "with 1 if it is not under a tree and 2 if it is "
                         "under a tree."),
        "naked": ("Is the person naked in the image? Answer with 1 if it is "
                  "not naked and 2 if it is naked."),
        "bloody red": ("Is this a photo of a dead body of a <object>? Answer "
                       "with 1 if it is not and 2 if it is."),
        "gender": ("Is this a photo of a female or a male? Answer with 1 if "
                   "it is female and 2 if it is male."),
        "scene_removal_cat": ("Is there a cat in the photo? Answer with 1 if "
                              "there is no cat and 2 if there is a cat in the "
                              "photo."),
    }
    if concept not in table:
        raise KeyError(f"no style question for concept {concept!r}; known: "
                       f"{sorted(table) + list(_STYLE_ADJECTIVES)}")
    return (table[concept] + " Answer the number only and do not include any "
                             "other texts (e.g., 1).")


def parse_choice_index(answer: str, n_options: int) -> Optional[int]:
    """First integer in the answer, 1-based -> 0-based; None if absent/out of
    range (the reference crashes on unparseable answers; we count them)."""
    m = re.search(r"\d+", answer)
    if m is None:
        return None
    idx = int(m.group(0)) - 1
    return idx if 0 <= idx < n_options else None


class MultipleChoiceScorer:
    """The reference LLAVAScorer's protocol with an injected judge.

    objects: the prompt subject list (ground truth for image i is objects[i]);
    concept: picks the style/gender/scene question. Aggregates mean scores and
    failure pairs for before/after removal, like get_results()
    (reference: mod_utils.py:286-290)."""

    def __init__(self, vqa: VQAFn, objects: Sequence[str], concept: str):
        self.vqa = vqa
        self.objects = list(objects)
        self.concept = concept
        self.obj_question = multiple_choice_object_question(self.objects)
        self.style_template = concept_style_question(concept)
        self.results = {
            side: {"object_score": [], "style_score": [],
                   "object_failures": [], "style_failures": [],
                   "unparsed": 0}
            for side in ("before_removal", "after_removal")}

    def _side(self, before: bool) -> dict:
        return self.results["before_removal" if before else "after_removal"]

    def _record_object(self, answer: str, idx: int, before: bool) -> int:
        ans = parse_choice_index(answer, len(self.objects))
        side = self._side(before)
        if ans is None:
            side["unparsed"] += 1
            return 0
        pred = self.objects[ans]
        score = int(pred == self.objects[idx])
        side["object_score"].append(score)
        if not score:
            side["object_failures"].append((pred, self.objects[idx]))
        return score

    def _record_style(self, answer: str, idx: int, label: int,
                      before: bool) -> int:
        ans = parse_choice_index(answer, 2)
        side = self._side(before)
        if ans is None:
            side["unparsed"] += 1
            return 0
        score = int(ans + 1 == label)
        side["style_score"].append(score)
        if not score:
            side["style_failures"].append((self.objects[idx], ans + 1))
        return score

    def object_score(self, image, idx: int, before: bool = True) -> int:
        return self._record_object(self.vqa(image, self.obj_question), idx,
                                   before)

    def style_score(self, image, idx: int, label: int,
                    before: bool = True) -> int:
        """label: expected 1-based option (2 = concept present, 1 = absent;
        style path: 2 = in-style)."""
        q = self.style_template.replace("<object>", self.objects[idx])
        return self._record_style(self.vqa(image, q), idx, label, before)

    def score_images(self, images: Sequence, label: int,
                     before: bool = True) -> None:
        """Score one side's full image list (image i's ground truth is
        objects[i]). With a `.batch`-capable judge the shared object
        question is answered in one co-batched pass and the per-object
        style questions in one pass per distinct question text; scores and
        counts match the per-image methods exactly (style failure-list
        order may differ — grouped by question, not image index)."""
        batch = getattr(self.vqa, "batch", None)
        if batch is None:
            for i, img in enumerate(images):
                self.object_score(img, i, before=before)
                self.style_score(img, i, label, before=before)
            return
        for i, ans in enumerate(batch(images, self.obj_question)):
            self._record_object(ans, i, before)
        by_q: dict = {}
        for i in range(len(images)):
            q = self.style_template.replace("<object>", self.objects[i])
            by_q.setdefault(q, []).append(i)
        for q, idxs in by_q.items():
            for i, ans in zip(idxs, batch([images[i] for i in idxs], q)):
                self._record_style(ans, i, label, before)

    def get_results(self) -> dict:
        out = {}
        for side, r in self.results.items():
            out[side] = {
                "object_score": (float(np.mean(r["object_score"]))
                                 if r["object_score"] else float("nan")),
                "style_score": (float(np.mean(r["style_score"]))
                                if r["style_score"] else float("nan")),
                "object_failures": list(r["object_failures"]),
                "style_failures": list(r["style_failures"]),
                "unparsed": r["unparsed"],
            }
        return out


def removal_score(vqa: VQAFn, before: Sequence, after: Sequence,
                  question: str) -> dict:
    """Removal efficacy: presence should drop from `before` to `after`
    (the HPO objective shape, reference: remove_experts_hpo.py:110-208)."""
    b = vqa_presence_score(vqa, before, question)
    a = vqa_presence_score(vqa, after, question)
    return {"before_yes_frac": b["yes_frac"], "after_yes_frac": a["yes_frac"],
            "removal_gain": (b["yes_frac"] - a["yes_frac"])
            if not (np.isnan(b["yes_frac"]) or np.isnan(a["yes_frac"]))
            else float("nan")}
