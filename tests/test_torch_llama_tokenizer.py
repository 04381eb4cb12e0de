"""The port's Llama tokenizer (its own BPE reader, `data/_native_unigram.py`)
against `tokenizers` and against the JAX package's `load_llama_tokenizer`,
on the CPU, with no model.

The files are synthetic llama-style `tokenizer.json`s built by `tokenizers`
itself: merges learned on I2P prompts with a small alphabet (so that
accented letters, CJK and emoji take the byte fallback), laid out as Llama's
(<unk>, <s>, </s>, the 256 byte tokens, then the pieces), in transformers'
two llava-hf layouts (legacy: `Prepend` + `Replace` normalizer, no
pre-tokenizer; newer: `Metaspace(prepend_scheme="first", split=false)`),
with a `Metaspace` decoder variant and with merges as "a b" strings, and
'<image>' added as a special token. Encodes and decodes are compared
exactly; so is the hand-written 32 000-piece file `chip_smoke.py` reads on
the card.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from tokenizers import (AddedToken, Tokenizer, decoders, models, normalizers,
                        pre_tokenizers, processors, trainers)

from diffusion_models_moe_tpu.data import tokenizer as jtok
from diffusion_models_moe_tpu_torch.data import _native_unigram as nu
from diffusion_models_moe_tpu_torch.data import tokenizer as ptok
from diffusion_models_moe_tpu_torch.data.prompts import i2p_prompts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = ("legacy", "metaspace", "metaspace_decoder", "string_merges")
TEXTS = [
    "USER: <image>\nIs there a person in the image? Answer with a single "
    "word, yes or no. ASSISTANT:",
    "USER: <image>\nwhat is this? ASSISTANT: a cat</s>USER: Frame the "
    "location of the cat ASSISTANT:",
    "the théâtre de l'Opéra, 日本の絵 🎨 and naïve café",
    "  leading and  double  spaces ",
    "",
    "<s>already framed</s>",
    "Tab\tand\nnewline  nbsp",
]


def _spec(layout: str) -> dict:
    corpus = i2p_prompts()[:300]
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.normalizer = normalizers.Replace(" ", "▁")
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=700, special_tokens=["<unk>", "<s>", "</s>"],
        limit_alphabet=45, show_progress=False))
    trained = json.loads(tok.to_str())["model"]
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for piece, _ in sorted(trained["vocab"].items(), key=lambda kv: kv[1]):
        vocab.setdefault(piece, len(vocab))
    merges = [tuple(m) if isinstance(m, list) else tuple(m.split(" "))
              for m in trained["merges"]]
    out = Tokenizer(models.BPE(vocab=vocab, merges=merges, unk_token="<unk>",
                               fuse_unk=True, byte_fallback=True))
    seq_decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
        decoders.Strip(" ", 1, 0)])
    if layout in ("legacy", "string_merges"):
        out.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                               normalizers.Replace(" ", "▁")])
        out.decoder = seq_decoder
    else:
        out.pre_tokenizer = pre_tokenizers.Metaspace(
            replacement="▁", prepend_scheme="first", split=False)
        out.decoder = (decoders.Metaspace(replacement="▁",
                                          prepend_scheme="first", split=False)
                       if layout == "metaspace_decoder" else seq_decoder)
    out.post_processor = processors.TemplateProcessing(
        single="<s> $A", special_tokens=[("<s>", 1)])
    out.add_special_tokens([AddedToken(t, normalized=False, special=True)
                            for t in ("<unk>", "<s>", "</s>", "<image>")])
    spec = json.loads(out.to_str())
    if layout == "string_merges":
        spec["model"]["merges"] = [" ".join(m) for m in spec["model"]["merges"]]
    return spec


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    out = {}
    for layout in LAYOUTS:
        d = str(tmp_path_factory.mktemp(layout))
        with open(os.path.join(d, "tokenizer.json"), "w",
                  encoding="utf-8") as f:
            json.dump(_spec(layout), f, ensure_ascii=False)
        out[layout] = d
    return out


def _pair(d: str):
    path = os.path.join(d, "tokenizer.json")
    return nu.Tokenizer.from_file(path), Tokenizer.from_file(path)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_native_bpe_equals_tokenizers(files, layout):
    """Ids and decodes (special tokens skipped and kept) equal `tokenizers`'
    on prompts with the image token, chat turns, accents, CJK and emoji
    (byte fallback), whitespace runs and the empty string; and the decode of
    seeded id runs, invalid UTF-8 byte runs among them, equals its too."""
    ours, ref = _pair(files[layout])
    n_byte = 0
    for text in TEXTS:
        ids = ref.encode(text).ids
        assert ours.encode(text) == ids, text
        n_byte += sum(3 <= i < 259 for i in ids)
        for skip in (True, False):
            assert ours.decode(ids, skip) == ref.decode(
                ids, skip_special_tokens=skip), (text, skip)
    assert n_byte > 10                   # the byte fallback was exercised
    rng = np.random.RandomState(0)
    size = ref.get_vocab_size()
    for _ in range(200):
        ids = rng.randint(0, size, rng.randint(1, 12)).tolist()
        if rng.rand() < 0.5:             # runs of byte tokens
            ids += (3 + rng.randint(0x80, 0x100, rng.randint(1, 4))).tolist()
        assert ours.decode(ids) == ref.decode(ids), ids


def _tiny_vocab(with_bytes: bool) -> dict:
    vocab = {"<unk>": 0, "a": 1, "b": 2, "c": 3, "ab": 4, "abc": 5, "bc": 6,
             "cc": 7, "ccc": 8}
    if with_bytes:
        for b in (0xC3, 0xA9, 0xE6, 0x97):
            vocab[f"<0x{b:02X}>"] = len(vocab)
    return vocab


@pytest.mark.parametrize("fuse_unk,byte_fallback,ignore_merges,unk", [
    (True, True, False, "<unk>"), (False, True, False, "<unk>"),
    (True, False, False, "<unk>"), (False, False, False, "<unk>"),
    (True, True, True, "<unk>"), (False, False, False, None)])
def test_bpe_options_equal_tokenizers(fuse_unk, byte_fallback, ignore_merges,
                                      unk):
    """BPE alone, against `tokenizers`: unknowns fused or not, byte fallback
    with a byte token missing (the unknown then waits for the next known
    character), `ignore_merges`, and no unknown token at all; merges whose
    rank order and overlaps decide the result (cc before bc)."""
    vocab = _tiny_vocab(byte_fallback)
    merges = [("c", "c"), ("b", "c"), ("a", "b"), ("ab", "c"), ("cc", "c")]
    ref = Tokenizer(models.BPE(vocab=vocab, merges=merges, unk_token=unk,
                               fuse_unk=fuse_unk, byte_fallback=byte_fallback,
                               ignore_merges=ignore_merges))
    ours = nu.Tokenizer(json.loads(ref.to_str()))
    for text in ("abc", "abcc", "bccc", "ccccc", "éab", "xyab", "xéyz",
                 "日ab", "abcabcab", "ab", "ébcé"):
        assert ours.encode(text) == ref.encode(text).ids, text


@pytest.mark.parametrize("key,value", [
    ("dropout", 0.1), ("continuing_subword_prefix", "##"),
    ("end_of_word_suffix", "</w>")])
def test_bpe_refuses_what_it_does_not_read(files, key, value):
    with open(os.path.join(files["legacy"], "tokenizer.json")) as f:
        spec = json.load(f)
    spec["model"][key] = value
    with pytest.raises(NotImplementedError, match=f"model 'BPE' with {key}"):
        nu.Tokenizer(spec)


@pytest.mark.parametrize("layout", ("legacy", "metaspace"))
def test_load_llama_tokenizer_equals_jax(files, layout):
    """The port's (encode, decode) against the JAX package's (which runs
    `tokenizers`): int32 ids with BOS first, and the stripped decodes of the
    answers' ids."""
    encode, decode = ptok.load_llama_tokenizer(files[layout])
    jencode, jdecode = jtok.load_llama_tokenizer(files[layout])
    for text in TEXTS:
        ids = encode(text)
        ref = jencode(text)
        assert ids.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(ids, ref)
        assert ids[0] == 1
        assert decode(ids[1:]) == jdecode(ref[1:])
    with pytest.raises(FileNotFoundError):
        ptok.load_llama_tokenizer(os.path.join(files[layout], "missing"))


def test_chip_smoke_tokenizer_equals_tokenizers(tmp_path):
    """The hand-written 32 000-piece llava-hf-layout file that chip_smoke.py
    writes on the card (which has no `tokenizers`): `tokenizers` reads it,
    and the port's reader gives the same ids and decodes; <image> is 32000."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    chip_smoke.write_llama_tokenizer(str(tmp_path))
    ours, ref = _pair(str(tmp_path))
    assert ref.get_vocab_size() == 32001 and ref.token_to_id("<image>") == 32000
    assert ours.token_to_id("<image>") == 32000
    for text in TEXTS:
        ids = ref.encode(text).ids
        assert ours.encode(text) == ids, text
        assert ours.decode(ids) == ref.decode(ids), text


def test_llama_reader_needs_no_tokenizer_package(files):
    """The legacy file reads and encodes the same where `tokenizers` cannot
    be imported (the card's machine has none)."""
    d = files["legacy"]
    code = (
        "import sys\n"
        "sys.modules['tokenizers'] = None\n"
        "from diffusion_models_moe_tpu_torch.data.tokenizer import "
        "load_llama_tokenizer\n"
        f"enc, dec = load_llama_tokenizer({d!r})\n"
        f"print([enc(t).tolist() for t in {TEXTS[:3]!r}])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    encode, _ = jtok.load_llama_tokenizer(d)
    assert json.loads(out) == [encode(t).tolist() for t in TEXTS[:3]]
