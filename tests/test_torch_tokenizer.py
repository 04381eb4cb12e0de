"""The torch port's CLIP BPE tokenizer against the JAX package's (which
splits words with the `regex` package), on a byte-level vocabulary the test
writes: merges learned from a small multilingual corpus, CLIP's special
tokens at the end."""
import collections
import json

import numpy as np
import pytest
import regex
import torch

from diffusion_models_moe_tpu.data import _native_bpe as jnative
from diffusion_models_moe_tpu.data import tokenizer as jtok
from diffusion_models_moe_tpu_torch.data import tokenizer as ttok
from diffusion_models_moe_tpu_torch.data._native_bpe import NativeBPE

PROMPTS = {
    "ascii": ["a photo of a cat", "A Dog in the Style of Van Gogh!!",
              "it's what we're, they've, I'll, I'd, I'm"],
    "diacritics": ["Café über Ñandú, Dvořák's naïve façade",
                   "Œuvre de Gérôme — São Paulo"],
    "cjk": ["東京の夜景 水墨画", "山水画 in the style of 齐白石"],
    "digits": ["1024 x 768 in 2023", "E = mc² and ½ of ¾", "٣ and ४ and ⅷ"],
    "overlength": [" ".join(["a painting of a castle on a hill"] * 20)],
    "spacing": ["  many\tspaces\nand　ideographic   ", "<|endoftext|>x!"],
}
CORPUS = [p for ps in PROMPTS.values() for p in ps] + [
    "a painting of a photo of a dog", "the style of van gogh and monet"]


def _learn_vocab(n_merges: int = 300):
    """CLIP-layout vocabulary: the 256 byte symbols, the same with </w>,
    then one token per merge learned from CORPUS, then the two special
    tokens. Returns (vocab, merges)."""
    b2u = jtok._bytes_to_unicode()
    symbols = list(b2u.values())
    vocab = {s: i for i, s in enumerate(symbols + [s + "</w>" for s in symbols])}
    words = collections.Counter()
    for text in CORPUS:
        text = " ".join(text.split()).lower()
        for w in jtok._PAT.findall(text):
            chars = [b2u[b] for b in w.encode("utf-8")]
            chars[-1] += "</w>"
            words[tuple(chars)] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, n in words.items():
            for pair in zip(w[:-1], w[1:]):
                pairs[pair] += n
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        vocab.setdefault(best[0] + best[1], len(vocab))
        merged = collections.Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    for special in ("<|startoftext|>", "<|endoftext|>"):
        vocab[special] = len(vocab)
    return vocab, merges


@pytest.fixture(autouse=True)
def jax_python_merges(monkeypatch):
    """The JAX reference runs its plain merge loop (the JAX package's own
    tests hold its native core to it), so these tests never build the JAX
    package's library in place while another test process loads it."""
    def unavailable(*args, **kwargs):
        raise OSError("the JAX package's native BPE is not used here")
    monkeypatch.setattr(jnative, "NativeBPE", unavailable)


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip_tokenizer")
    vocab, merges = _learn_vocab()
    (d / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False),
                                  encoding="utf-8")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges),
        encoding="utf-8")
    return d


@pytest.mark.parametrize("kind", sorted(PROMPTS))
def test_ids_equal_jax(vocab_dir, kind):
    """Same (B, 77) ids as the JAX tokenizer (the port on its native
    merges)."""
    got = ttok.load_tokenizer(str(vocab_dir))
    ref = jtok.load_tokenizer(str(vocab_dir))
    assert got.merge_loop == "native"
    ids = got(PROMPTS[kind])
    assert ids.dtype == torch.int64 and ids.shape == (len(PROMPTS[kind]), 77)
    np.testing.assert_array_equal(ids.numpy(), ref(PROMPTS[kind]))
    if kind == "overlength":
        assert ids[0, -1] == got.eos and (ids[0, :-1] != got.eos).all()


def test_pad_token_from_special_tokens_map(vocab_dir, tmp_path):
    """A snapshot's pad token ('!' in SDXL's second tokenizer) replaces EOS
    as the pad id, as in the JAX tokenizer."""
    for name in ("vocab.json", "merges.txt"):
        (tmp_path / name).write_bytes((vocab_dir / name).read_bytes())
    (tmp_path / "special_tokens_map.json").write_text(
        json.dumps({"pad_token": {"content": "!"}}))
    got = ttok.CLIPTokenizer.from_dir(str(tmp_path), max_length=16)
    ref = jtok.CLIPTokenizer.from_dir(str(tmp_path), max_length=16)
    assert got.pad == ref.pad == got.encoder["!"] != got.eos
    texts = ["a cat", "Café 東京"]
    np.testing.assert_array_equal(got(texts).numpy(), ref(texts))


def test_native_merges_equal_the_python_merges(vocab_dir):
    """The native merge core and the plain merge loop give the same pieces
    on every word of the corpus and on words it never saw."""
    nat = ttok.CLIPTokenizer.from_dir(str(vocab_dir))
    py = ttok.CLIPTokenizer.from_dir(str(vocab_dir), use_native=False)
    assert (nat.merge_loop, py.merge_loop) == ("native", "python")
    texts = CORPUS + ["unseen wordings éèê 你好 12345", "x" * 300]
    np.testing.assert_array_equal(nat(texts).numpy(), py(texts).numpy())
    b2u = jtok._bytes_to_unicode()
    core = NativeBPE(nat.encoder, sorted(nat.bpe_ranks, key=nat.bpe_ranks.get))
    for word in ("painting", "façade", "x" * 300):
        w = "".join(b2u[b] for b in word.encode())
        assert core.encode_word(w) == [nat.encoder[t]
                                       for t in py._bpe(w).split(" ")]


_REGEX = regex.compile(jtok._CLIP_PATTERN, regex.IGNORECASE)


def test_word_split_equals_regex_on_every_code_point():
    """The stdlib split gives `regex`'s words around every code point up to
    U+10FFFF, none left out: inside a word and a number, after an
    apostrophe, doubled before punctuation, after a special token and before
    a contraction. Code points that `regex`'s Unicode database (newer than
    this interpreter's) classes otherwise take their class from the
    committed table `data/_regex_classes.txt`."""
    import sys
    pat = ttok.word_pattern()
    cps = list(map(chr, range(sys.maxunicode + 1)))
    assert len(cps) == 0x110000
    for i in range(0, len(cps), 4096):
        text = "".join(f"a{c}b1{c}2'{c}{c}!<|startoftext|>{c}'s "
                       for c in cps[i:i + 4096])
        assert pat.findall(text) == _REGEX.findall(text), i
