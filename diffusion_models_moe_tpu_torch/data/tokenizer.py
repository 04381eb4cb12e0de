"""CLIP BPE tokenizer (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/data/tokenizer.py`'s CLIP part: it
needs only a checkpoint's `vocab.json` and `merges.txt` and gives the
`(B, max_length)` int64 ids the text encoder takes, BOS/EOS framed and padded
with the snapshot's pad token.

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


def _char_classes() -> dict[str, str]:
    """The code points of the classes L and N of `regex`, each as the body
    of a stdlib `re` character class in escaped ranges: the major Unicode
    category, overridden by the runs of `_regex_classes.txt`."""
    majors = [unicodedata.category(c)[0]
              for c in map(chr, range(sys.maxunicode + 1))]
    with open(_REGEX_CLASSES, encoding="ascii") as f:
        for line in f:
            if not line.startswith("#"):
                start, end, cls = line.split()
                majors[int(start, 16):int(end, 16) + 1] = (
                    [cls] * (int(end, 16) - int(start, 16) + 1))
    out: dict[str, list[str]] = {"L": [], "N": []}
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
