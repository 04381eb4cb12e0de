"""CLIP BPE tokenizer, and the T5, Llama and Qwen2 tokenizers (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/data/tokenizer.py`. The CLIP
tokenizer needs only a checkpoint's `vocab.json` and `merges.txt` and gives
the `(B, max_length)` int64 ids the text encoder takes, BOS/EOS framed and
padded with the snapshot's pad token. `load_t5_tokenizer` (PixArt's
`tokenizer.json` or `spiece.model`), `load_llama_tokenizer` (LLaVA's) and
`load_qwen_tokenizer` (Qwen2-VL's byte-level BPE) read their files with the
port's own reader (`data/_native_unigram.py`).

CLIP splits text into words with `\\p{L}+|\\p{N}|[^\\s\\p{L}\\p{N}]+` (after
its special tokens and contractions), a pattern of the `regex` package. The
port does not use that package: it builds the same classes for the stdlib
`re` from `unicodedata.category` (letters L*, numbers N*) and the Unicode
White_Space set that `regex` takes for `\\s`, and applies case-insensitive
matching to the literal alternatives only, as `regex` does. Where the
databases differ (`regex`'s is newer than the interpreter's), the committed
table `data/_regex_classes.txt` gives `regex`'s class; it is made by
`tools/gen_regex_classes.py`, so the two splits agree on every code point to
U+10FFFF.

Merges run in the native core (`native/bpe_core.cpp`, `data/_native_bpe.py`)
where it builds; the pure-Python merge loop is the plain version, and
`CLIPTokenizer.merge_loop` says which one the tokenizer runs.
"""
from __future__ import annotations

import functools
import itertools
import json
import os
import re
import subprocess
import sys
import unicodedata
from typing import Callable, Sequence

import numpy as np
import torch

# the White_Space property, which `regex` matches for \s (stdlib `re` also
# takes U+001C..U+001F)
_WHITE_SPACE = (r"\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029"
                r"\u202f\u205f\u3000")
_SPECIALS = r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"


@functools.lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_REGEX_CLASSES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "_regex_classes.txt")


def _char_classes(table: str = _REGEX_CLASSES,
                  white_space: str = "") -> dict[str, str]:
    """The code points of the classes L, N and S of a regex engine, each as
    the body of a stdlib `re` character class in escaped ranges: the major
    Unicode category (S: the code points of `white_space`), overridden by
    the runs of `table` (`_regex_classes.txt`: `regex`'s, the default;
    `_split_classes.txt`: `tokenizers`')."""
    majors = [m if m in "LN" else "O" for m in (
        unicodedata.category(c)[0] for c in map(chr, range(sys.maxunicode + 1)))]
    for c in white_space:
        majors[ord(c)] = "S"
    with open(table, encoding="ascii") as f:
        for line in f:
            if not line.startswith("#"):
                start, end, cls = line.split()
                majors[int(start, 16):int(end, 16) + 1] = (
                    [cls] * (int(end, 16) - int(start, 16) + 1))
    out: dict[str, list[str]] = {"L": [], "N": [], "S": []}
    start = 0
    for major, run in itertools.groupby(majors):
        end = start + sum(1 for _ in run) - 1
        if major in out:
            out[major].append(f"\\U{start:08x}-\\U{end:08x}")
        start = end + 1
    return {k: "".join(v) for k, v in out.items()}


@functools.lru_cache(maxsize=1)
def word_pattern() -> re.Pattern:
    """CLIP's word-split pattern for the stdlib `re` (built once, ~0.5 s).
    U+0345 matches no alternative under `regex`'s case-insensitive matching
    (its case partner is a letter, itself is not) and is skipped there, so
    it is left out of the last class here."""
    cls = _char_classes()
    letters, numbers = cls["L"], cls["N"]
    return re.compile(f"(?i:{_SPECIALS})|[{letters}]+|[{numbers}]"
                      f"|[^{_WHITE_SPACE}\\u0345{letters}{numbers}]+")


class CLIPTokenizer:
    def __init__(self, vocab_path: str, merges_path: str, max_length: int = 77,
                 use_native: bool = True):
        with open(vocab_path, encoding="utf-8") as f:
            self.encoder: dict[str, int] = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # the first line of CLIP's merges.txt is a version header
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#version")]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.max_length = max_length
        self.bos = self.encoder.get("<|startoftext|>")
        self.eos = self.encoder.get("<|endoftext|>")
        self.pad = self.eos
        self._cache: dict[str, str] = {}
        self._pat = word_pattern()
        self._native = None
        if use_native:
            from diffusion_models_moe_tpu_torch.data._native_bpe import \
                NativeBPE
            try:
                self._native = NativeBPE(self.encoder, merges)
            except (OSError, subprocess.CalledProcessError, ValueError):
                self._native = None     # no g++, or a vocabulary it cannot take
        self.merge_loop = "python" if self._native is None else "native"

    @classmethod
    def from_dir(cls, path: str, max_length: int = 77,
                 use_native: bool = True) -> "CLIPTokenizer":
        """A snapshot's tokenizer directory; the pad token comes from its
        `special_tokens_map.json` or `tokenizer_config.json` (SDXL's second
        tokenizer pads with '!', id 0, not with EOS)."""
        tok = cls(os.path.join(path, "vocab.json"),
                  os.path.join(path, "merges.txt"), max_length, use_native)
        for fname in ("special_tokens_map.json", "tokenizer_config.json"):
            try:
                with open(os.path.join(path, fname), encoding="utf-8") as f:
                    spec = json.load(f)
            except (FileNotFoundError, json.JSONDecodeError):
                continue
            pad = spec.get("pad_token")
            if isinstance(pad, dict):
                pad = pad.get("content")
            if isinstance(pad, str):
                if pad in tok.encoder:
                    tok.pad = tok.encoder[pad]
                elif pad + "</w>" in tok.encoder:
                    tok.pad = tok.encoder[pad + "</w>"]
                break
        return tok

    def _bpe(self, token: str) -> str:
        """The plain merge loop: pieces of one byte-unicode word, joined by
        spaces."""
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = re.sub(r"\s+", " ", text.strip()).lower()
        ids: list[int] = []
        for tok in self._pat.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            if self._native is not None:
                ids.extend(self._native.encode_word(tok))
            else:
                ids.extend(self.encoder[t] for t in self._bpe(tok).split(" ")
                           if t in self.encoder)
        return ids

    def __call__(self, texts: Sequence[str] | str) -> torch.Tensor:
        """(B, max_length) int64 ids: BOS, the words' ids cut to
        max_length - 2, EOS, then the pad id."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_length), self.pad, np.int64)
        for i, t in enumerate(texts):
            ids = [self.bos] + self.encode(t)[: self.max_length - 2] + [self.eos]
            out[i, :len(ids)] = ids
        return torch.from_numpy(out)


def load_tokenizer(path: str, max_length: int = 77
                   ) -> Callable[[Sequence[str]], torch.Tensor]:
    """The CLIP tokenizer of a snapshot directory: the port's own from
    `vocab.json` and `merges.txt`, else transformers' `CLIPTokenizer` where
    those files are missing and the directory holds a layout it reads."""
    try:
        return CLIPTokenizer.from_dir(path, max_length)
    except (FileNotFoundError, json.JSONDecodeError):
        from transformers import CLIPTokenizer as HFTokenizer
        hf = HFTokenizer.from_pretrained(path)

        def tokenize(texts: Sequence[str] | str) -> torch.Tensor:
            if isinstance(texts, str):
                texts = [texts]
            return torch.as_tensor(hf(list(texts), padding="max_length",
                                      max_length=max_length, truncation=True
                                      )["input_ids"], dtype=torch.int64)
        return tokenize


def load_sdxl_tokenizers(snapshot_root: str, max_length: int = 77):
    """SDXL snapshots ship two CLIP tokenizers (`tokenizer/`,
    `tokenizer_2/`): (tokenize_l, tokenize_bigG) for
    `SDXLPipeline.generate`'s `cond_ids` and `cond_ids_2`. The second pads
    with '!' (id 0) where CLIP-L pads with EOS, so the bigG tower sees other
    ids than CLIP-L's for a prompt shorter than `max_length`."""
    return (load_tokenizer(os.path.join(snapshot_root, "tokenizer"),
                           max_length),
            load_tokenizer(os.path.join(snapshot_root, "tokenizer_2"),
                           max_length))


def load_t5_tokenizer(path: str, max_length: int = 120
                      ) -> Callable[[Sequence[str]], tuple]:
    """PixArt's T5 tokenizer from a directory holding `tokenizer.json` or,
    failing that, `spiece.model`, read by the port's own reader
    (`data/_native_unigram.py`: no `tokenizers`, `sentencepiece` or
    `protobuf`). Returns `tokenize(texts) -> (ids, mask)`, int32 tensors
    (B, max_length) on the CPU: EOS (`</s>`, id 1 where the file has no such
    token) appended unless the file's post-processor put it last, kept as
    the last id where the ids are cut to `max_length`, pad id 0, mask 1 on
    the tokens."""
    from diffusion_models_moe_tpu_torch.data._native_unigram import Tokenizer
    json_path = os.path.join(path, "tokenizer.json")
    spm_path = os.path.join(path, "spiece.model")
    if os.path.exists(json_path):
        tok = Tokenizer.from_file(json_path)
    elif os.path.exists(spm_path):
        tok = Tokenizer.from_spm(spm_path)
    else:
        raise FileNotFoundError(
            f"no tokenizer.json or spiece.model under {path!r}")
    eos_id = tok.token_to_id("</s>")
    eos_id = 1 if eos_id is None else eos_id

    def tokenize(texts: Sequence[str]) -> tuple[torch.Tensor, torch.Tensor]:
        ids = torch.zeros((len(texts), max_length), dtype=torch.int32)
        mask = torch.zeros_like(ids)
        for i, text in enumerate(texts):
            enc = tok.encode(text)
            if not enc or enc[-1] != eos_id:
                enc = enc + [eos_id]
            enc = enc[:max_length]
            enc[-1] = eos_id
            ids[i, :len(enc)] = torch.tensor(enc, dtype=torch.int32)
            mask[i, :len(enc)] = 1
        return ids, mask

    return tokenize


def load_llama_tokenizer(path: str):
    """Llama/Vicuna tokenizer of the LLaVA judge (`models/llava.py`) from a
    snapshot's `tokenizer.json`, read by the port's own reader
    (`data/_native_unigram.py`: its BPE with byte fallback, the legacy
    `Prepend` + `Replace` normalizer and the newer `Metaspace` layout,
    '<image>' as an added token; no `tokenizers`). Returns (encode,
    decode): encode(text) -> 1-D int32 ids with BOS prepended where the
    file's post-processor did not put it first; decode(ids) -> text,
    special tokens skipped, stripped."""
    from diffusion_models_moe_tpu_torch.data._native_unigram import Tokenizer
    json_path = os.path.join(path, "tokenizer.json")
    if not os.path.exists(json_path):
        # tokenizer.model alone is sentencepiece BPE; every llava-hf
        # snapshot ships tokenizer.json
        raise FileNotFoundError(
            f"no tokenizer.json under {path!r} (a raw tokenizer.model is not "
            "read: re-save the tokenizer with transformers to produce "
            "tokenizer.json)")
    tok = Tokenizer.from_file(json_path)
    bos_id = tok.token_to_id("<s>")

    def encode(text: str) -> np.ndarray:
        ids = tok.encode(text)
        if bos_id is not None and (not ids or ids[0] != bos_id):
            ids = [bos_id] + list(ids)
        return np.asarray(ids, np.int32)

    def decode(ids) -> str:
        return tok.decode([int(i) for i in ids]).strip()

    return encode, decode


def load_qwen_tokenizer(path: str):
    """Qwen2 / Qwen2-VL tokenizer of the Qwen2-VL judge
    (`models/qwen2vl.py`) from a snapshot's `tokenizer.json`, read by the
    port's own reader (`data/_native_unigram.py`: NFC, Qwen2's `Split`,
    byte-level BPE; the chat strings `<|im_start|>` etc. are added tokens
    and encode to one id each; no `tokenizers` or `regex`). Returns
    (encode, decode): encode(text) -> 1-D int32 ids, no BOS; decode(ids) ->
    text, special tokens skipped, stripped."""
    from diffusion_models_moe_tpu_torch.data._native_unigram import Tokenizer
    json_path = os.path.join(path, "tokenizer.json")
    if not os.path.exists(json_path):
        raise FileNotFoundError(f"no tokenizer.json under {path!r}")
    tok = Tokenizer.from_file(json_path)

    def encode(text: str) -> np.ndarray:
        return np.asarray(tok.encode(text), np.int32)

    def decode(ids) -> str:
        return tok.decode([int(i) for i in ids]).strip()

    return encode, decode
