"""The port's T5 tokenizer (`data/_native_unigram.py`, `load_t5_tokenizer`)
against `tokenizers` and the JAX package's `load_t5_tokenizer`, on the CPU.

Fixtures, all synthetic (no real T5 vocabulary is in the repository): a
Unigram `tokenizer.json` of a few hundred pieces written by `tokenizers`
itself (a `Precompiled` charsmap from the double-array writer below,
`" {2,}"` -> `" "`, `Metaspace`, `TemplateProcessing` `$A </s>`, the added
tokens `<pad>`, `</s>`, `<unk>` and `<extra_id_*>`), the JAX package's
WordLevel fixture, and a `spiece.model` of the same vocabulary written with
transformers' sentencepiece protobuf module. Ids and masks must be equal.
"""
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from diffusion_models_moe_tpu.data.tokenizer import \
    load_t5_tokenizer as jax_load_t5
from diffusion_models_moe_tpu_torch.data import _native_unigram as nu
from diffusion_models_moe_tpu_torch.data.tokenizer import load_t5_tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def darts_charsmap(mapping: dict) -> bytes:
    """A sentencepiece precompiled charsmap: uint32 trie size in bytes, a
    Darts double array over the keys' UTF-8 bytes (each node at a base of
    its own, the array long enough for any byte from any base), then the
    NUL-terminated replacement strings."""
    blob, values = bytearray(), {}
    for src in sorted(mapping):
        values[src] = len(blob)
        blob += mapping[src].encode() + b"\0"
    root: dict = {}
    for src in mapping:
        node = root
        for b in src.encode():
            node = node.setdefault(b, {})
        node[None] = values[src]
    units, bases, queue = {0: 0}, set(), [(0, root)]
    while queue:
        pos, node = queue.pop(0)
        labels = [0 if k is None else k for k in node]
        base = 1
        while base in bases or any((base ^ l) in units or base ^ l == 0
                                   for l in labels):
            base += 1
        bases.add(base)
        units[pos] |= ((pos ^ base) << 10) | ((None in node) << 8)
        for k, child in node.items():
            if k is None:
                units[base] = (1 << 31) | child
            else:
                units[base ^ k] = k
                queue.append((base ^ k, child))
    size = max(max(units), max(b | 0xFF for b in bases)) + 1
    trie = b"".join(struct.pack("<I", units.get(i, 0)) for i in range(size))
    return struct.pack("<I", len(trie)) + trie + bytes(blob)


# a few dozen charsmap entries: full-width Latin, ligatures, NBSP and the
# ideographic space -> " ", a decomposed e-acute -> the composed one (a
# two-character key, looked up as one grapheme), and a key that is a prefix
# of another (the lookup takes the shorter)
MAPPING = {**{chr(0xFF21 + i): chr(0x41 + i) for i in range(26)},
           **{chr(0xFF41 + i): chr(0x61 + i) for i in range(8)},
           "ﬁ": "fi", "ﬂ": "fl", "\xa0": " ", "　": " ",
           "™": "TM", "é": "\xe9", "ＡＢ": "X",
           "Ⅰ": "I"}
WORDS = ("a photo of dog cat house in the style van gogh painting fine art "
         "green red sky over city night light portrait woman man field "
         "sunset flowers").split()
PROMPTS = [
    "a photo of a dog",
    "A Photo  of   the CAT",                          # repeated spaces
    "ﬁne Ａｒｔ house\xa0in the style",
    "unknown Ω漢字 chars ΩΩ end",  # unknown runs
    "a dog <extra_id_0> a cat<extra_id_1>",           # added tokens
    "</s> inside <unk> and <pad>",
    "",
    "   ",
    "été ＡＢＣ Ⅰ™",
    " ".join(WORDS * 6),                              # cut at max_length
]


def vocabulary(seed: int = 0) -> list:
    """[(piece, score)]: the three specials, every substring of up to four
    characters of each '▁word' and 'word', single letters and digits, and
    ten <extra_id_*> at the end (highest id first, as T5's)."""
    rng = np.random.RandomState(seed)
    pieces = []
    for w in WORDS:
        for s in ("▁" + w, w):
            pieces += [s[i:j] for i in range(len(s))
                       for j in range(i + 1, min(len(s), i + 4) + 1)]
    pieces += list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                   "0123456789,.!\xe9") + ["X", "TM", "<"]
    pieces = list(dict.fromkeys(pieces))
    vocab = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
    vocab += [(p, float(s)) for p, s in
              zip(pieces, rng.uniform(-12.0, -1.0, len(pieces)))]
    vocab += [(f"<extra_id_{i}>", 0.0) for i in reversed(range(10))]
    return vocab


def write_unigram_json(path: str) -> None:
    from tokenizers import AddedToken, Regex, Tokenizer, normalizers
    from tokenizers import pre_tokenizers, processors
    from tokenizers.models import Unigram
    vocab = vocabulary()
    tok = Tokenizer(Unigram(vocab, 2, False))
    tok.normalizer = normalizers.Sequence([
        normalizers.Precompiled(list(darts_charsmap(MAPPING))),
        normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace("▁",
                                                 prepend_scheme="always")
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    tok.add_special_tokens(
        [AddedToken(p, normalized=False, special=True) for p, _ in vocab
         if p.startswith("<") and p.endswith(">")])
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))


def write_spiece_model(path: str) -> None:
    from transformers.utils import sentencepiece_model_pb2_new as spb
    m = spb.ModelProto()
    for piece, score in vocabulary():
        p = m.pieces.add()
        p.piece, p.score = piece, score
        p.type = (spb.ModelProto.SentencePiece.CONTROL
                  if piece in ("<pad>", "</s>") else
                  spb.ModelProto.SentencePiece.UNKNOWN if piece == "<unk>"
                  else spb.ModelProto.SentencePiece.NORMAL)
    m.trainer_spec.unk_id = 2
    m.trainer_spec.model_type = spb.TrainerSpec.UNIGRAM
    m.normalizer_spec.precompiled_charsmap = darts_charsmap(MAPPING)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "spiece.model"), "wb") as f:
        f.write(m.SerializeToString())


def write_wordlevel(path: str) -> None:
    """The JAX package's own fixture (tests/test_t5_and_pixart_pipeline.py:
    test_load_t5_tokenizer)."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    vocab = {"<pad>": 0, "</s>": 1, "a": 2, "photo": 3, "of": 4, "dog": 5,
             "cat": 6}
    tok = Tokenizer(WordLevel(vocab, unk_token="<pad>"))
    tok.pre_tokenizer = Whitespace()
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("t5tok")
    out = {k: str(root / k) for k in ("unigram", "wordlevel", "spm")}
    write_unigram_json(out["unigram"])
    write_wordlevel(out["wordlevel"])
    write_spiece_model(out["spm"])
    return out


@pytest.fixture
def spm_module(monkeypatch):
    """`tokenizers`' from_spm imports `sentencepiece_model_pb2` from the
    working directory; transformers ships the same protobuf module."""
    from transformers.utils import sentencepiece_model_pb2_new
    monkeypatch.setitem(sys.modules, "sentencepiece_model_pb2",
                        sentencepiece_model_pb2_new)


def test_unigram_json_ids_equal_tokenizers(dirs):
    from tokenizers import Tokenizer
    path = os.path.join(dirs["unigram"], "tokenizer.json")
    ref, got = Tokenizer.from_file(path), nu.Tokenizer.from_file(path)
    n_unk = 0
    for p in PROMPTS:
        want = ref.encode(p).ids
        assert got.encode(p) == want, p
        n_unk += want.count(2)
    assert n_unk >= 2                       # the unknown runs were fused
    assert got.token_to_id("</s>") == ref.token_to_id("</s>") == 1
    assert got.token_to_id("<extra_id_0>") == ref.token_to_id("<extra_id_0>")


@pytest.mark.parametrize("variant", ["split_first", "strip", "normalized"])
def test_unigram_variants_equal_tokenizers(tmp_path, variant):
    """Components an older T5 file carries (a WhitespaceSplit before the
    Metaspace, `prepend_scheme: first`, no `split`) and added tokens that
    take the whitespace beside them or are matched after normalization give
    the ids of `tokenizers`."""
    from tokenizers import AddedToken, Tokenizer, pre_tokenizers
    write_unigram_json(str(tmp_path))
    path = str(tmp_path / "tokenizer.json")
    tok = Tokenizer.from_file(path)
    if variant == "split_first":
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.WhitespaceSplit(),
            pre_tokenizers.Metaspace("\u2581", prepend_scheme="first",
                                     split=False)])
    elif variant == "strip":
        tok.add_tokens([AddedToken("<sep>", lstrip=True, rstrip=True,
                                   normalized=False)])
    else:
        tok.add_tokens([AddedToken("X y", normalized=True)])
    tok.save(path)
    got = nu.Tokenizer.from_file(path)
    prompts = PROMPTS + ["a dog  <sep>  a cat", "an X\xa0y and X  y",
                         "  leading and <extra_id_2>trailing  "]
    for p in prompts:
        assert got.encode(p) == tok.encode(p).ids, p


@pytest.mark.parametrize("fixture", ["unigram", "wordlevel", "spm"])
@pytest.mark.parametrize("max_length", [120, 12])
def test_load_t5_tokenizer_equals_jax(dirs, spm_module, fixture, max_length):
    """(ids, mask) int32 (B, max_length) equal to the JAX package's on every
    prompt: EOS appended once, kept where the ids are cut, pad 0."""
    prompts = (["a photo of dog", "cat", "a photo of dog cat a photo of dog",
                "a bird"] if fixture == "wordlevel" else PROMPTS)
    ids, mask = load_t5_tokenizer(dirs[fixture], max_length)(prompts)
    jids, jmask = jax_load_t5(dirs[fixture], max_length)(prompts)
    assert ids.dtype == mask.dtype == __import__("torch").int32
    assert tuple(ids.shape) == (len(prompts), max_length)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert (ids.numpy()[np.arange(len(prompts)), mask.numpy().sum(1) - 1]
            == 1).all()


def test_spiece_model_equals_its_tokenizer_json(dirs, spm_module):
    """A spiece.model read by the port's protobuf reader gives the ids of
    the same vocabulary's tokenizer.json pipeline (no added tokens, no
    post-processor) and of `tokenizers`' own from_spm."""
    from tokenizers.implementations import SentencePieceUnigramTokenizer
    spm = os.path.join(dirs["spm"], "spiece.model")
    with open(spm, "rb") as f:
        model = nu.read_spm(f.read())
    assert model["pieces"][:3] == [("<pad>", 0.0), ("</s>", 0.0),
                                   ("<unk>", 0.0)]
    assert model["unk_id"] == 2 and model["model_type"] == 1
    assert model["precompiled_charsmap"] == darts_charsmap(MAPPING)
    got = nu.Tokenizer.from_spm(spm)
    with open(os.path.join(dirs["unigram"], "tokenizer.json")) as f:
        spec = json.load(f)
    spec.update(added_tokens=[], post_processor=None)
    same = nu.Tokenizer(spec)
    ref = SentencePieceUnigramTokenizer.from_spm(spm)._tokenizer
    for p in PROMPTS:
        assert got.encode(p) == same.encode(p) == ref.encode(p).ids, p


def test_precompiled_charsmap_equals_tokenizers():
    """The charsmap lookup, grapheme by grapheme, equals `tokenizers`'
    Precompiled normalizer on random strings over the keys, combining marks,
    CR LF, an emoji ZWJ sequence and plain letters."""
    from tokenizers import normalizers
    cm = darts_charsmap(MAPPING)
    ref, got = normalizers.Precompiled(list(cm)), nu.Precompiled(cm)
    alphabet = (list(MAPPING) + list("abe \r\n\t")
                + ["́", "̈", "‍", "\xa9", "\U0001F600",
                   "\U0001F1E6", "؀", "ः", "가", "ᆨ"])
    rng = np.random.RandomState(0)
    for _ in range(3000):
        s = "".join(alphabet[i] for i in
                    rng.randint(0, len(alphabet), rng.randint(1, 9)))
        assert got(s) == ref.normalize_str(s), repr(s)
    # the shortest key wins and a whole grapheme takes its first key's string
    assert got("ＡＢ") == "AB" and got("Ａ́") == "A"


def test_graphemes_equal_regex():
    """UAX #29 splits equal `regex`'s \\X on strings of every class but the
    Indic conjunct one (GB9c, left out: see the module's docstring)."""
    import regex
    alphabet = ["a", "\xe9", "\r", "\n", " ", "́", "‍", "\xa9",
                "\U0001F600", "\U0001F1E6", "\U0001F1E8", "ᄀ", "ᅡ",
                "ᆨ", "가", "각", "ः", "؀", "️",
                "\U0001F3FB", "\x07"]
    rng = np.random.RandomState(1)
    for _ in range(3000):
        s = "".join(alphabet[i] for i in
                    rng.randint(0, len(alphabet), rng.randint(1, 9)))
        assert nu.graphemes(s) == regex.findall(r"\X", s), repr(s)


@pytest.mark.parametrize("edit,name", [
    # BPE is read since it took Llama's files; a WordPiece-style one is not
    (lambda s: s.update(model={"type": "BPE", "vocab": {}, "merges": [],
                               "continuing_subword_prefix": "##"}),
     "model 'BPE'"),
    (lambda s: s.update(normalizer={"type": "Lowercase"}),
     "normalizer 'Lowercase'"),
    (lambda s: s.update(pre_tokenizer={"type": "ByteLevel"}),
     "pre-tokenizer 'ByteLevel'"),
    (lambda s: s.update(post_processor={"type": "BertProcessing"}),
     "post-processor 'BertProcessing'"),
    (lambda s: s.update(padding={"strategy": "BatchLongest"}),
     "tokenizer.json padding"),
    (lambda s: s["added_tokens"][0].update(single_word=True), "single_word"),
    (lambda s: s["model"].update(byte_fallback=True), "byte_fallback"),
])
def test_reader_refuses_what_it_does_not_read(dirs, edit, name):
    with open(os.path.join(dirs["unigram"], "tokenizer.json")) as f:
        spec = json.load(f)
    edit(spec)
    with pytest.raises(NotImplementedError, match=name):
        nu.Tokenizer(spec)


def test_reader_needs_no_tokenizer_package(dirs):
    """Both files are read, and tokenized as above, in an interpreter where
    `tokenizers`, `sentencepiece` and `google.protobuf` cannot be imported."""
    code = (
        "import sys, json\n"
        "for m in ('tokenizers', 'sentencepiece', 'google', "
        "'google.protobuf'):\n"
        "    sys.modules[m] = None\n"
        "from diffusion_models_moe_tpu_torch.data.tokenizer import "
        "load_t5_tokenizer\n"
        f"prompts = {PROMPTS!r}\n"
        "out = [load_t5_tokenizer(d)(prompts)[0].tolist() for d in "
        f"({dirs['unigram']!r}, {dirs['spm']!r})]\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    for d, ids in zip(("unigram", "spm"), got):
        np.testing.assert_array_equal(
            np.asarray(ids), load_t5_tokenizer(dirs[d])(PROMPTS)[0].numpy())


def test_missing_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_t5_tokenizer(str(tmp_path / "missing"))
