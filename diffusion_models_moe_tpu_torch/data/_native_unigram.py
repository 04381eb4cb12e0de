"""A reader of T5's and Llama's tokenizer files that needs neither
`tokenizers`, `sentencepiece` nor `protobuf` (the port's GPU host has none of
them).

`Tokenizer.from_file` reads an HF `tokenizer.json`, `Tokenizer.from_spm` a
sentencepiece `spiece.model`; `encode(text)` gives the ids that `tokenizers`
gives for the same file, and `decode(ids)` the text its `decode` gives. The
pipeline is that of `tokenizers`:

1. the added tokens with `normalized: false` are split out of the text
   (leftmost, longest first; `lstrip`/`rstrip` take the whitespace beside
   them), then each other piece is normalized and the added tokens with
   `normalized: true` are split out of it;
2. each remaining piece is pre-tokenized and each of its parts goes through
   the model;
3. the post-processor frames the ids.

Components read: normalizers `Sequence`, `Precompiled` (a sentencepiece
charsmap), `Replace` and `Prepend`; pre-tokenizers `Sequence`, `Metaspace`
(`split` or not; `prepend_scheme` always, first or never),
`WhitespaceSplit` and `Whitespace`; models `Unigram` (Viterbi over the
piece scores, unknown characters at the lowest score less 10, runs of them
fused into one unknown id), `WordLevel` and `BPE` (Llama's: merges by rank,
as "a b" strings or as pairs, applied lowest rank first and leftmost among
equal ranks, as `tokenizers`' priority queue does; a character outside the
vocabulary as its UTF-8 bytes' `<0xXX>` tokens with `byte_fallback`, else
as `unk_token`, runs of unknowns fused with `fuse_unk`; `ignore_merges`);
post-processor `TemplateProcessing` (its `single` template); decoders
`Sequence`, `Replace`, `ByteFallback` (a run of `<0xXX>` tokens becomes its
UTF-8 text, or U+FFFD for each byte where it is not valid UTF-8), `Fuse`,
`Strip` and `Metaspace`. Any other component, an added token with
`single_word`, a Unigram with `byte_fallback`, a BPE with `dropout`,
`continuing_subword_prefix` or `end_of_word_suffix` (a byte-level BPE
shows as its `ByteLevel` pre-tokenizer), or a file that sets `truncation`
or `padding`, raises `NotImplementedError` naming it.

A `spiece.model` is a protobuf `ModelProto`, read here by a small wire
reader: `pieces` (piece, score), `trainer_spec.unk_id`, `model_type` and
`byte_fallback`, and `normalizer_spec.precompiled_charsmap`. It becomes the
pipeline that `tokenizers`' `SentencePieceUnigramTokenizer.from_spm`
builds: the charsmap, then `" {2,}"` -> `" "`, then `Metaspace` with
`prepend_scheme: always`; no added tokens and no post-processor.

The charsmap is a little-endian uint32 trie size in bytes, a Darts double
array of that many bytes, then NUL-terminated replacement strings. As in
`tokenizers`, it is applied grapheme by grapheme (extended grapheme
clusters): a grapheme shorter than 6 UTF-8 bytes is looked up whole, and
otherwise, or where that finds nothing, each of its characters is; a lookup
takes the SHORTEST key that is a prefix of the bytes looked up, so a
grapheme whose first character is a key is replaced by that key's string
alone. Graphemes are split by the rules of UAX #29 on the classes of
`_grapheme_classes.txt` (made by `tools/gen_grapheme_classes.py`); rule
GB9c (Indic conjuncts) is left out: it joins only characters of 3 bytes
each, into graphemes of 6 bytes or more, which are looked up character by
character either way.
"""
from __future__ import annotations

import base64
import bisect
import functools
import heapq
import json
import os
import re
import struct
from typing import Optional, Sequence

# the White_Space property (Rust's `char::is_whitespace`)
WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003"
               "\u2004\u2005\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f"
               "\u205f\u3000")
_WS_RUN = re.compile(f"[{WHITE_SPACE}]+")
_WHITESPACE_WORDS = re.compile(r"\w+|[^\w\s]+")
UNK_PENALTY = 10.0
_GRAPHEME_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "_grapheme_classes.txt")


# ------------------------------------------------------------------ graphemes
@functools.lru_cache(maxsize=1)
def _grapheme_runs() -> tuple[list[int], list[int], list[str]]:
    starts, ends, names = [], [], []
    with open(_GRAPHEME_TABLE, encoding="ascii") as f:
        for line in f:
            if not line.startswith("#"):
                s, e, name = line.split()
                starts.append(int(s, 16))
                ends.append(int(e, 16))
                names.append(name)
    return starts, ends, names


def _gcb(c: str) -> tuple[str, bool]:
    """(Grapheme_Cluster_Break class, Extended_Pictographic) of `c`."""
    starts, ends, names = _grapheme_runs()
    cp = ord(c)
    i = bisect.bisect_right(starts, cp) - 1
    if i < 0 or cp > ends[i]:
        return "Other", False
    name = names[i]
    if name.endswith("ExtPict"):
        return name.split("+")[0] if "+" in name else "Other", True
    return name, False


_CONTROLS = ("CR", "LF", "Control")


def graphemes(text: str) -> list[str]:
    """Extended grapheme clusters of `text` (UAX #29 without GB9c)."""
    out: list[str] = []
    prev = None
    ri_run = 0          # regional indicators ending the current cluster
    emoji = 0           # 1: ExtPict Extend*, 2: that then ZWJ
    for c in text:
        cls, pict = _gcb(c)
        if prev is None:
            join = False
        elif prev == "CR" and cls == "LF":
            join = True                                       # GB3
        elif prev in _CONTROLS or cls in _CONTROLS:
            join = False                                      # GB4, GB5
        elif prev == "L" and cls in ("L", "V", "LV", "LVT"):
            join = True                                       # GB6
        elif prev in ("LV", "V") and cls in ("V", "T"):
            join = True                                       # GB7
        elif prev in ("LVT", "T") and cls == "T":
            join = True                                       # GB8
        elif cls in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
            join = True                                       # GB9-GB9b
        elif emoji == 2 and pict:
            join = True                                       # GB11
        elif prev == "Regional_Indicator" and cls == prev:
            join = ri_run % 2 == 1                            # GB12, GB13
        else:
            join = False                                      # GB999
        if join:
            out[-1] += c
        else:
            out.append(c)
        ri_run = ri_run + 1 if cls == "Regional_Indicator" else 0
        if pict:
            emoji = 1
        elif emoji == 1 and cls == "Extend":
            pass
        elif emoji == 1 and cls == "ZWJ":
            emoji = 2
        else:
            emoji = 0
        prev = cls
    return out


# ----------------------------------------------------------------- normalizers
class Precompiled:
    """A sentencepiece charsmap: the Darts double array and its strings."""

    def __init__(self, charsmap: bytes):
        (trie_size,) = struct.unpack_from("<I", charsmap, 0)
        n = trie_size // 4
        self.array = struct.unpack_from(f"<{n}I", charsmap, 4)
        self.strings = bytes(charsmap[4 + trie_size:])

    def _lookup(self, key: bytes) -> Optional[str]:
        """The string of the shortest key that is a prefix of `key`."""
        arr = self.array
        pos = 0
        unit = arr[0]
        pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
        for byte in key:
            if byte == 0:
                break
            pos ^= byte
            if pos >= len(arr):
                return None
            unit = arr[pos]
            if unit & ((1 << 31) | 0xFF) != byte:
                return None
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                start = arr[pos] & ((1 << 31) - 1)
                end = self.strings.index(b"\0", start)
                return self.strings[start:end].decode("utf-8")
        return None

    def __call__(self, text: str) -> str:
        out = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self._lookup(g.encode("utf-8"))
                if norm is not None:
                    out.append(norm)
                    continue
            for c in g:
                norm = self._lookup(c.encode("utf-8"))
                out.append(c if norm is None else norm)
        return "".join(out)


class Replace:
    def __init__(self, spec: dict):
        pattern = spec["pattern"]
        self.pattern = (re.compile(re.escape(pattern["String"]))
                        if "String" in pattern else re.compile(pattern["Regex"]))
        self.content = spec["content"]

    def __call__(self, text: str) -> str:
        return self.pattern.sub(lambda _: self.content, text)


class _Chain:
    def __init__(self, parts: Sequence):
        self.parts = list(parts)

    def __call__(self, text):
        for part in self.parts:
            text = part(text)
        return text


def _prepend(prefix: str):
    return lambda text: prefix + text if text else text


def _normalizer(spec: Optional[dict]):
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Sequence":
        return _Chain([_normalizer(s) for s in spec["normalizers"]])
    if kind == "Precompiled":
        return Precompiled(base64.b64decode(spec["precompiled_charsmap"]))
    if kind == "Replace":
        return Replace(spec)
    if kind == "Prepend":
        return _prepend(spec["prepend"])
    raise NotImplementedError(f"normalizer {kind!r}")


# -------------------------------------------------------------- pre-tokenizers
# a pre-tokenizer maps [(piece, starts at the text's offset 0)] to the same


class Metaspace:
    def __init__(self, spec: dict):
        self.rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        if scheme not in ("always", "first", "never"):
            raise NotImplementedError(f"Metaspace prepend_scheme {scheme!r}")
        self.scheme = scheme
        self.split = spec.get("split", True)

    def __call__(self, pieces):
        out = []
        for text, at_origin in pieces:
            text = text.replace(" ", self.rep)
            if text and not text.startswith(self.rep) and (
                    self.scheme == "always"
                    or (self.scheme == "first" and at_origin)):
                text = self.rep + text
            if not self.split:
                out.append((text, at_origin))
                continue
            # a part starts at each run of replacement characters (the
            # delimiter merged with what follows it)
            parts: list[str] = []
            prev_rep = False
            for c in text:
                is_rep = c == self.rep
                if (is_rep and not prev_rep) or not parts:
                    parts.append(c)
                else:
                    parts[-1] += c
                prev_rep = is_rep
            out.extend((p, at_origin and i == 0) for i, p in enumerate(parts))
        return out


def _whitespace_split(pieces):
    out = []
    for text, at_origin in pieces:
        lead = _WS_RUN.match(text) is not None
        words = [w for w in _WS_RUN.split(text) if w]
        out.extend((w, at_origin and i == 0 and not lead)
                   for i, w in enumerate(words))
    return out


def _whitespace(pieces):
    out = []
    for text, at_origin in pieces:
        out.extend((m.group(), at_origin and m.start() == 0)
                   for m in _WHITESPACE_WORDS.finditer(text))
    return out


def _pre_tokenizer(spec: Optional[dict]):
    if spec is None:
        return lambda pieces: pieces
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def run(pieces):
            for part in parts:
                pieces = part(pieces)
            return pieces
        return run
    if kind == "Metaspace":
        return Metaspace(spec)
    if kind == "WhitespaceSplit":
        return _whitespace_split
    if kind == "Whitespace":
        return _whitespace
    raise NotImplementedError(f"pre-tokenizer {kind!r}")


# ---------------------------------------------------------------------- models
class Unigram:
    """Viterbi segmentation over the pieces' scores, as `tokenizers`'
    `Unigram` (`encode_optimized`, with `fuse_unk`)."""

    def __init__(self, vocab: Sequence, unk_id: Optional[int],
                 byte_fallback: bool = False):
        if byte_fallback:
            raise NotImplementedError("Unigram byte_fallback")
        self.pieces = [(str(p), float(s)) for p, s in vocab]
        self.ids = {p: i for i, (p, _) in enumerate(self.pieces)}
        self.unk_id = unk_id
        self.min_score = min((s for _, s in self.pieces), default=0.0)
        self.max_len = max((len(p) for p, _ in self.pieces), default=0)

    def id_to_token(self, tid: int) -> Optional[str]:
        return self.pieces[tid][0] if 0 <= tid < len(self.pieces) else None

    def tokenize(self, text: str) -> list[int]:
        n = len(text)
        if n == 0:
            return []
        unk_score = self.min_score - UNK_PENALTY
        # best[e] = (score, start, id) of the best path ending at e
        best: list = [None] * (n + 1)
        best[0] = (0.0, None, None)
        for s in range(n):
            here = best[s][0]
            single = False
            for k in range(1, min(self.max_len, n - s) + 1):
                pid = self.ids.get(text[s:s + k])
                if pid is None:
                    continue
                score = self.pieces[pid][1] + here
                node = best[s + k]
                if node is None or score > node[0]:
                    best[s + k] = (score, s, pid)
                if k == 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"no piece covers {text[s]!r} and the "
                                     "model has no unk_id")
                score = unk_score + here
                node = best[s + 1]
                if node is None or score > node[0]:
                    best[s + 1] = (score, s, self.unk_id)
        pieces: list[str] = []
        unk_run: list[str] = []
        end = n
        while end > 0:
            _, start, pid = best[end]
            if pid == self.unk_id:
                unk_run.append(text[start:end])
            else:
                if unk_run:
                    pieces.append("".join(reversed(unk_run)))
                    unk_run = []
                pieces.append(text[start:end])
            end = start
        if unk_run:
            pieces.append("".join(reversed(unk_run)))
        return [self.ids.get(p, self.unk_id) for p in reversed(pieces)]


class WordLevel:
    def __init__(self, vocab: dict, unk_token: Optional[str]):
        self.ids = dict(vocab)
        self.tokens = {i: t for t, i in self.ids.items()}
        self.unk_token = unk_token

    def id_to_token(self, tid: int) -> Optional[str]:
        return self.tokens.get(tid)

    def tokenize(self, text: str) -> list[int]:
        if text in self.ids:
            return [self.ids[text]]
        if self.unk_token is None or self.unk_token not in self.ids:
            raise ValueError(f"{text!r} is not in the vocabulary and the "
                             "model has no unknown token in it")
        return [self.ids[self.unk_token]]


class BPE:
    """`tokenizers`' BPE model (`merge_word` and `Word::merge_all`): a word
    is split into characters (each a vocabulary id, its UTF-8 bytes'
    `<0xXX>` ids with `byte_fallback`, else the unknown id, a run of unknowns
    fused into one with `fuse_unk`; a pending unknown is placed when the
    next in-vocabulary character or the word's end comes, so byte tokens
    may go before it, as there), then adjacent pairs merge lowest rank
    first, the leftmost among equal ranks."""

    def __init__(self, spec: dict):
        for key in ("dropout", "continuing_subword_prefix",
                    "end_of_word_suffix"):
            if spec.get(key) is not None:
                raise NotImplementedError(f"model 'BPE' with {key}")
        self.ids = dict(spec["vocab"])
        self.tokens = {i: t for t, i in self.ids.items()}
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, merge in enumerate(spec.get("merges", [])):
            a, b = merge.split(" ") if isinstance(merge, str) else merge
            new_id = self.ids.get(a + b)
            if a not in self.ids or b not in self.ids or new_id is None:
                raise ValueError(f"BPE merge {a!r} {b!r}: a part or the "
                                 "merged token is not in the vocabulary")
            self.merges[(self.ids[a], self.ids[b])] = (rank, new_id)

    def id_to_token(self, tid: int) -> Optional[str]:
        return self.tokens.get(tid)

    def _unk_id(self) -> int:
        if self.unk_token not in self.ids:
            raise ValueError(f"unk_token {self.unk_token!r} is not in the "
                             "vocabulary")
        return self.ids[self.unk_token]

    def _symbols(self, word: str) -> list[int]:
        syms: list[int] = []
        unk: Optional[int] = None       # the pending unknown, not yet placed
        for c in word:
            tid = self.ids.get(c)
            if tid is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(tid)
                continue
            if self.byte_fallback:
                codes = [self.ids.get(f"<0x{b:02X}>") for b in c.encode("utf-8")]
                if all(t is not None for t in codes):
                    syms.extend(codes)
                    continue
            if self.unk_token is not None:
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                unk = self._unk_id()
        if unk is not None:
            syms.append(unk)
        return syms

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.ids:
            return [self.ids[word]]
        c = self._symbols(word)
        n = len(c)
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = [(m[0], i, m[1]) for i in range(n - 1)
                if (m := self.merges.get((c[i], c[i + 1]))) is not None]
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            right = nxt[pos]
            if not alive[pos] or right == -1:
                continue
            m = self.merges.get((c[pos], c[right]))
            if m is None or m[1] != new_id:        # a stale entry
                continue
            c[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] != -1:
                prv[nxt[pos]] = pos
            if prv[pos] != -1 and (m := self.merges.get(
                    (c[prv[pos]], new_id))) is not None:
                heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] != -1 and (m := self.merges.get(
                    (new_id, c[nxt[pos]]))) is not None:
                heapq.heappush(heap, (m[0], pos, m[1]))
        return [c[i] for i in range(n) if alive[i]]


def _model(spec: dict):
    kind = spec.get("type")
    if kind == "Unigram":
        return Unigram(spec["vocab"], spec.get("unk_id"),
                       spec.get("byte_fallback", False))
    if kind == "WordLevel":
        return WordLevel(spec["vocab"], spec.get("unk_token"))
    if kind == "BPE":
        return BPE(spec)
    raise NotImplementedError(f"model {kind!r}")


# -------------------------------------------------------------------- decoders
# a decoder maps the list of token strings to another (`decode_chain`)
def _byte_fallback(tokens: list[str]) -> list[str]:
    out: list[str] = []
    run = bytearray()

    def flush():
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("\ufffd" * len(run))
            run.clear()

    for tok in tokens:
        if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
            try:
                run.append(int(tok[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(tok)
    flush()
    return out


def _strip(content: str, start: int, stop: int):
    def run(tokens):
        out = []
        for tok in tokens:
            lead = 0
            while lead < min(start, len(tok)) and tok[lead] == content:
                lead += 1
            trail = 0
            while (trail < min(stop, len(tok) - lead)
                   and tok[len(tok) - 1 - trail] == content):
                trail += 1
            out.append(tok[lead:len(tok) - trail])
        return out
    return run


def _metaspace_decoder(spec: dict):
    rep = spec.get("replacement", "▁")
    scheme = spec.get("prepend_scheme")
    if scheme is None:
        scheme = "always" if spec.get("add_prefix_space", True) else "never"

    def run(tokens):
        # the first token loses every replacement character unless the
        # scheme is "never"; elsewhere each becomes a space
        return [tok.replace(rep, "" if i == 0 and scheme != "never" else " ")
                for i, tok in enumerate(tokens)]
    return run


def _decoder(spec: Optional[dict]):
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_decoder(d) for d in spec["decoders"]]

        def run(tokens):
            for part in parts:
                tokens = part(tokens)
            return tokens
        return run
    if kind == "Replace":
        rep = Replace(spec)
        return lambda tokens: [rep(t) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        return _strip(spec["content"], spec.get("start", 0),
                      spec.get("stop", 0))
    if kind == "Metaspace":
        return _metaspace_decoder(spec)
    raise NotImplementedError(f"decoder {kind!r}")


def _post_processor(spec: Optional[dict]):
    if spec is None:
        return lambda ids: ids
    if spec["type"] != "TemplateProcessing":
        raise NotImplementedError(f"post-processor {spec['type']!r}")
    specials = spec.get("special_tokens", {})
    items = []
    for item in spec["single"]:
        if "Sequence" in item:
            if item["Sequence"]["id"] != "A":
                raise NotImplementedError("TemplateProcessing single template "
                                          f"with sequence {item['Sequence']['id']}")
            items.append(None)
        else:
            items.append(list(specials[item["SpecialToken"]["id"]]["ids"]))

    def frame(ids):
        out = []
        for item in items:
            out.extend(ids if item is None else item)
        return out
    return frame


# ------------------------------------------------------------------ tokenizer
class _AddedTokens:
    def __init__(self, tokens: list[dict], normalizer):
        for t in tokens:
            if t.get("single_word"):
                raise NotImplementedError(
                    f"added token {t['content']!r} with single_word")
        plain = [t for t in tokens if not t.get("normalized", False)]
        normed = [t for t in tokens if t.get("normalized", False)]
        self.plain = self._matcher({t["content"]: t for t in plain})
        self.normed = self._matcher(
            {(normalizer(t["content"]) if normalizer else t["content"]): t
             for t in normed})

    @staticmethod
    def _matcher(table: dict):
        if not table:
            return None
        # alternatives longest first: `re` takes the first that matches at
        # the leftmost position, which is then the longest
        keys = sorted(table, key=len, reverse=True)
        return re.compile("|".join(map(re.escape, keys))), table

    @staticmethod
    def split(text: str, matcher) -> list[tuple[str, Optional[int]]]:
        """(piece, id or None): the matched tokens and the text between."""
        if matcher is None or not text:
            return [(text, None)]
        pat, table = matcher
        out, last = [], 0
        for m in pat.finditer(text):
            tok = table[m.group()]
            start, stop = m.start(), m.end()
            if stop <= last:
                continue
            if tok.get("lstrip"):
                start = max(len(text[:start].rstrip(WHITE_SPACE)), last)
            if tok.get("rstrip"):
                stop = len(text) - len(text[stop:].lstrip(WHITE_SPACE))
            if last < start:
                out.append((text[last:start], None))
            out.append((text[start:stop], tok["id"]))
            last = stop
        if last != len(text):
            out.append((text[last:], None))
        return out


class Tokenizer:
    """A tokenizer.json pipeline (see the module's docstring)."""

    def __init__(self, spec: dict):
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise NotImplementedError(f"tokenizer.json {key}")
        self.normalizer = _normalizer(spec.get("normalizer"))
        self.pre_tokenizer = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.model = _model(spec["model"])
        self.post_processor = _post_processor(spec.get("post_processor"))
        self.decoder = _decoder(spec.get("decoder"))
        added = spec.get("added_tokens") or []
        self.added = _AddedTokens(added, self.normalizer)
        self.added_ids = {t["content"]: t["id"] for t in added}
        self.added_tokens = {t["id"]: t["content"] for t in added}
        self.special = {t["content"] for t in added if t.get("special")}

    @classmethod
    def from_file(cls, path: str) -> "Tokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    @classmethod
    def from_spm(cls, path: str) -> "Tokenizer":
        with open(path, "rb") as f:
            model = read_spm(f.read())
        if model["model_type"] != 1:
            raise ValueError(f"{path}: model_type {model['model_type']} is "
                             "not Unigram")
        replace = {"type": "Replace", "pattern": {"Regex": " {2,}"},
                   "content": " "}
        norms = [replace]
        if model["precompiled_charsmap"]:
            norms.insert(0, {"type": "Precompiled", "precompiled_charsmap":
                             base64.b64encode(model["precompiled_charsmap"]
                                              ).decode("ascii")})
        return cls({
            "normalizer": {"type": "Sequence", "normalizers": norms},
            "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                              "prepend_scheme": "always", "split": True},
            "model": {"type": "Unigram", "unk_id": model["unk_id"],
                      "vocab": model["pieces"],
                      "byte_fallback": model["byte_fallback"]},
        })

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self.added_ids:
            return self.added_ids[token]
        ids = self.model.ids
        return ids.get(token)

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        first = True
        for piece, tid in self.added.split(text, self.added.plain):
            at_origin, first = first, False
            if tid is not None:
                ids.append(tid)
                continue
            normed = self.normalizer(piece) if self.normalizer else piece
            for j, (sub, sid) in enumerate(
                    self.added.split(normed, self.added.normed)):
                if sid is not None:
                    ids.append(sid)
                    continue
                for part, _ in self.pre_tokenizer([(sub, at_origin and j == 0)]):
                    ids.extend(self.model.tokenize(part))
        return self.post_processor(ids)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True
               ) -> str:
        """Ids -> text as `tokenizers`' `decode`: each id's token (added
        tokens first; unknown ids dropped, special ones too with
        `skip_special_tokens`) through the decoder, or joined by spaces
        where the file has none."""
        tokens = []
        for tid in ids:
            tok = self.added_tokens.get(int(tid))
            if tok is None:
                tok = self.model.id_to_token(int(tid))
            if tok is None or (skip_special_tokens and tok in self.special):
                continue
            tokens.append(tok)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))


# ------------------------------------------------------------------ protobuf
def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of a message's fields: ints for
    varints, bytes for length-delimited fields, raw 4 or 8 bytes for fixed
    ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"protobuf wire type {wire} of field {field}")
        yield field, wire, val


def read_spm(buf: bytes) -> dict:
    """The fields of a sentencepiece `ModelProto` the tokenizer needs:
    pieces [(piece, score)], unk_id, model_type, byte_fallback and
    precompiled_charsmap (proto2 defaults where a field is absent)."""
    out = {"pieces": [], "unk_id": 0, "model_type": 1, "byte_fallback": False,
           "precompiled_charsmap": b""}
    for field, _, val in _fields(buf):
        if field == 1:                                   # pieces
            piece, score = "", 0.0
            for f, w, v in _fields(val):
                if f == 1:
                    piece = v.decode("utf-8")
                elif f == 2 and w == 5:
                    (score,) = struct.unpack("<f", v)
            out["pieces"].append((piece, score))
        elif field == 2:                                 # trainer_spec
            for f, _, v in _fields(val):
                if f == 40:
                    out["unk_id"] = v - (1 << 64) if v >= 1 << 63 else v
                elif f == 3:
                    out["model_type"] = v
                elif f == 35:
                    out["byte_fallback"] = bool(v)
        elif field == 3:                                 # normalizer_spec
            for f, _, v in _fields(val):
                if f == 2:
                    out["precompiled_charsmap"] = bytes(v)
    return out
