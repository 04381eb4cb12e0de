"""The port's Qwen2 tokenizer (byte-level BPE in its own reader,
`data/_native_unigram.py`) against `tokenizers` and against the JAX
package's `load_qwen_tokenizer`, on the CPU, with no model.

The files are synthetic Qwen2-layout `tokenizer.json`s: merges learned by
`tokenizers`' BPE trainer on I2P prompts over the byte alphabet, laid out as
Qwen2's file (NFC; `Split` on Qwen2's pattern, `Isolated`, then `ByteLevel`
without prefix space or regex; BPE without an unknown token, empty
subword prefix and suffix; `ByteLevel` post-processor and decoder) with
merges as "a b" strings or as pairs, and Qwen2-VL's 14 special added tokens
numbered on from the vocabulary. Encodes and decodes are compared exactly,
on text with the chat template, specials, emoji, CJK, `\\r\\n`, upper-case
contractions and their case partners, combining marks; so is the
151 643-piece file `chip_smoke.py` reads on the card. Exhaustive checks:
the `Split` pattern's classes against `tokenizers`' own `Split` around
every code point to U+10FFFF (in batched strings), NFC against
`tokenizers`' `NFC` on every code point alone, between marks, and on every
canonical composition pair; byte-level decodes of invalid UTF-8.
"""
import json
import os
import subprocess
import sys
import unicodedata

import numpy as np
import pytest
from tokenizers import Regex, Tokenizer, models, normalizers, pre_tokenizers
from tokenizers import trainers

from diffusion_models_moe_tpu.data import tokenizer as jtok
from diffusion_models_moe_tpu_torch.data import _native_unigram as nu
from diffusion_models_moe_tpu_torch.data import tokenizer as ptok
from diffusion_models_moe_tpu_torch.data.prompts import i2p_prompts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = ("string_merges", "pair_merges")
ADDED = ("<|endoftext|>", "<|im_start|>", "<|im_end|>",
         "<|object_ref_start|>", "<|object_ref_end|>", "<|box_start|>",
         "<|box_end|>", "<|quad_start|>", "<|quad_end|>", "<|vision_start|>",
         "<|vision_end|>", "<|vision_pad|>", "<|image_pad|>", "<|video_pad|>")
CHAT = ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
        "<|im_start|>user\n<|vision_start|><|image_pad|><|image_pad|>"
        "<|vision_end|>Is there a cat in the image? Answer with a single word,"
        " yes or no.<|im_end|>\n<|im_start|>assistant\n")
TEXTS = [
    CHAT,
    "what is this?<|im_end|>\n<|im_start|>assistant\nA cat<|im_end|>",
    "the théâtre de l'Opéra, 日本の絵 🎨🍆💦, and naïve café; 한국어 텍스트",
    "I'M here, you'RE there, WE'VE gone, they'LL see, he'D go, it'S ok, "
    "don'T, 'ſ 'K 'll'd",
    "line one\r\nline two\r\n\r\n  indented\n\ttabbed  \n\n",
    "  leading and  double  spaces   ",
    "",
    "numbers 12345 and ½ ⅷ ٣٤ and 3.14159",
    "e\u0301 a\u0323\u0302 \u1100\u1161\u11a8 \U00011935\U00011930 "
    "a\u0898\u0316 \u0915\u093c \u2126",
    "a<|im_end|>b<|endoftext|>",
    "punctuation!!! ... ??? --- (brackets) [x] {y} #tag @user",
]


def _trained(texts) -> dict:
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.train_from_iterator(texts, trainers.BpeTrainer(
        vocab_size=1200, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False))
    return json.loads(tok.to_str())["model"]


def _spec(model: dict, layout: str) -> dict:
    merges = [m if isinstance(m, list) else m.split(" ")
              for m in model["merges"]]
    if layout == "string_merges":
        merges = [" ".join(m) for m in merges]
    n = len(model["vocab"])
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": False, "use_regex": False}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": n + i, "content": t, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for i, t in enumerate(ADDED)],
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": nu.QWEN2_SPLIT},
             "behavior": "Isolated", "invert": False}, byte_level]},
        "post_processor": byte_level, "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": False, "vocab": model["vocab"],
                  "merges": merges}}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    model = _trained(i2p_prompts()[:300] + TEXTS)
    out = {}
    for layout in LAYOUTS:
        d = str(tmp_path_factory.mktemp(layout))
        with open(os.path.join(d, "tokenizer.json"), "w",
                  encoding="utf-8") as f:
            json.dump(_spec(model, layout), f, ensure_ascii=False)
        out[layout] = d
    return out


def _pair(d: str):
    path = os.path.join(d, "tokenizer.json")
    return nu.Tokenizer.from_file(path), Tokenizer.from_file(path)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_encode_decode_equal_tokenizers(files, layout):
    """The same ids as `tokenizers` on every text and on 200 I2P prompts,
    the same decodes (special tokens skipped), and the chat strings as one
    added id each."""
    ours, ref = _pair(files[layout])
    n = ref.get_vocab_size(with_added_tokens=False)
    for i, t in enumerate(ADDED):
        assert ours.token_to_id(t) == ref.token_to_id(t) == n + i
    for text in TEXTS + i2p_prompts()[300:500]:
        ids = ref.encode(text).ids
        assert ours.encode(text) == ids, text
        assert ours.decode(ids) == ref.decode(ids), text
        assert ours.decode(ids, skip_special_tokens=False) == ref.decode(
            ids, skip_special_tokens=False), text
    assert ours.encode(CHAT).count(n + 12) == 2       # <|image_pad|>


def test_load_qwen_tokenizer_equals_jax(files):
    """`load_qwen_tokenizer` gives JAX's ids (int32, no BOS) and its
    stripped decodes."""
    d = files["string_merges"]
    enc, dec = ptok.load_qwen_tokenizer(d)
    jenc, jdec = jtok.load_qwen_tokenizer(d)
    for text in TEXTS:
        got, ref = enc(text), jenc(text)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
        assert dec(got) == jdec(ref)
    with pytest.raises(FileNotFoundError):
        ptok.load_qwen_tokenizer(os.path.join(d, "missing"))


def test_chip_smoke_tokenizer_equals_tokenizers(tmp_path):
    """The full-size file `chip_smoke.py` writes: 151 643 pieces, the added
    tokens at Qwen2-VL's ids (`Qwen2VLConfig`'s EOS, pad, vision start and
    end and image pad), and the port's ids and decodes equal to
    `tokenizers`' on the chat template and the repo's prompt files."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from diffusion_models_moe_tpu_torch.data.prompts import (
        artist_names, load_dataset_file, memorized_captions)
    from diffusion_models_moe_tpu_torch.models.qwen2vl import Qwen2VLConfig
    chip_smoke.write_qwen_tokenizer(str(tmp_path))
    ours, ref = _pair(str(tmp_path))
    cfg = Qwen2VLConfig()
    assert ref.get_vocab_size(with_added_tokens=False) == 151643
    for name, want in (("<|endoftext|>", cfg.pad_id), ("<|im_end|>", cfg.eos_id),
                       ("<|vision_start|>", cfg.vision_start_token_id),
                       ("<|vision_end|>", cfg.vision_start_token_id + 1),
                       ("<|image_pad|>", cfg.image_token_id)):
        assert ours.token_to_id(name) == ref.token_to_id(name) == want
    texts = ([CHAT] + TEXTS + i2p_prompts() + memorized_captions()[:100]
             + artist_names() + list(load_dataset_file("violent.txt")))
    for text in texts:
        ids = ref.encode(text).ids
        assert ours.encode(text) == ids, text
        assert ours.decode(ids) == ref.decode(ids), text


def test_split_equals_tokenizers_on_every_code_point():
    """The stdlib `Split` gives `tokenizers`' parts around every code point
    to U+10FFFF but the surrogates (a Rust string holds none): after a
    letter and before a number, after an apostrophe (the case-insensitive
    contractions: 'ſ is one), doubled before punctuation, after a space and
    before \\r\\n. Code points that
    `tokenizers`' regex engine classes otherwise than this interpreter's
    `unicodedata` take their class from `data/_split_classes.txt`."""
    ours = nu.Split({"pattern": {"Regex": nu.QWEN2_SPLIT},
                     "behavior": "Isolated", "invert": False})
    ref = pre_tokenizers.Split(Regex(nu.QWEN2_SPLIT), behavior="isolated")
    cps = [chr(c) for c in range(sys.maxunicode + 1)
           if not 0xD800 <= c <= 0xDFFF]
    for i in range(0, len(cps), 8192):
        text = "".join(f"a{c}1'{c}{c}! {c}\r\n" for c in cps[i:i + 8192])
        got = [p for p, _ in ours([(text, True)])]
        assert got == [p for p, _ in ref.pre_tokenize_str(text)], i


def test_nfc_equals_tokenizers_on_every_code_point():
    """`nfc` gives `tokenizers`' NFC on every code point alone, after a
    starter and a mark of class 230 and before one of class 220 (canonical
    order), on every canonical composition pair of the interpreter's
    database and of `data/_nfc_table.txt` (adjacent, and with a mark of
    class 220 between: blocked or not by its class), and on Hangul
    syllables' jamo. Batched between NUL separators."""
    ref = normalizers.NFC()
    cps = [chr(c) for c in range(1, sys.maxunicode + 1)
           if not 0xD800 <= c <= 0xDFFF]
    pairs = []
    for c in cps:
        dec = unicodedata.decomposition(c)
        if dec and not dec.startswith("<"):
            parts = [chr(int(x, 16)) for x in dec.split()]
            if len(parts) == 2:
                pairs.append(parts)
    assert len(pairs) > 900
    tables = nu._nfc_data()
    for c, d in tables[1].items():
        pairs.append(list(d) if len(d) == 2 else [c, "\u0301"])
    segments = ([c for c in cps] + [f"a\u0301{c}\u0316" for c in cps]
                + [a + b for a, b in pairs]
                + [a + "\u0316" + b for a, b in pairs]
                + [a + "\u0301" + b for a, b in pairs]
                + ["\u1100\u1161\u11a8", "\uac00\u11a8", "\u1112\u1175"])
    for i in range(0, len(segments), 16384):
        text = "".join("\x00" + s for s in segments[i:i + 16384])
        assert nu.nfc(text) == ref.normalize_str(text), i


def test_nfc_table_matches_installed_tokenizers():
    """The committed table is what `tools/gen_bytelevel_tables.py` makes
    from the installed `tokenizers` for the code points it lists: their
    decompositions and combining classes under `tokenizers`' NFD (the
    class read against marks of 220 and 230)."""
    nfd = normalizers.NFD()
    ccc_t, nfd_t, comp_t, _ = nu._nfc_data()
    assert len(ccc_t) > 0
    for c, d in nfd_t.items():
        assert nfd.normalize_str(c) == d
        if d == c and ccc_t[c] == 0:
            # a class-0 code point stays where it is between two marks
            assert nfd.normalize_str("a\u0301" + c + "\u0316") == \
                "a\u0301" + c + "\u0316"


def test_byte_level_decode_equals_tokenizers(files):
    """Byte-level decodes of seeded runs of single-byte tokens, invalid
    UTF-8 among them (each maximal invalid subpart one U+FFFD), and of
    tokens mixed with added ones."""
    ours, ref = _pair(files["pair_merges"])
    enc = ptok._bytes_to_unicode()
    byte_ids = [ref.token_to_id(enc[b]) for b in range(256)]
    rng = np.random.default_rng(3)
    n = ref.get_vocab_size(with_added_tokens=False)
    for _ in range(500):
        ids = [byte_ids[b] for b in rng.integers(0, 256, rng.integers(1, 12))]
        if rng.random() < 0.3:
            ids.insert(int(rng.integers(0, len(ids))), n + 2)
        assert ours.decode(ids) == ref.decode(ids), ids
        assert ours.decode(ids, skip_special_tokens=False) == ref.decode(
            ids, skip_special_tokens=False), ids


@pytest.mark.parametrize("change,name", [
    (lambda s: s["pre_tokenizer"]["pretokenizers"][0].update(
        pattern={"Regex": r"\w+"}), "Split pattern"),
    (lambda s: s["pre_tokenizer"]["pretokenizers"][0].update(
        behavior="Removed"), "Split behavior"),
    (lambda s: s["pre_tokenizer"]["pretokenizers"][0].update(invert=True),
     "Split behavior"),
    (lambda s: s["pre_tokenizer"]["pretokenizers"][1].update(use_regex=True),
     "'ByteLevel' with use_regex"),
    (lambda s: s["pre_tokenizer"]["pretokenizers"][1].update(
        add_prefix_space=True), "'ByteLevel' with add_prefix_space"),
    (lambda s: s.update(decoder={"type": "ByteLevel",
                                 "add_prefix_space": True}),
     "decoder 'ByteLevel' with add_prefix_space"),
    (lambda s: s["model"].update(continuing_subword_prefix="##"),
     "continuing_subword_prefix"),
    (lambda s: s.update(normalizer={"type": "NFKC"}), "normalizer 'NFKC'"),
])
def test_other_variants_raise(files, change, name):
    with open(os.path.join(files["string_merges"], "tokenizer.json"),
              encoding="utf-8") as f:
        spec = json.load(f)
    change(spec)
    with pytest.raises(NotImplementedError, match=name):
        nu.Tokenizer(spec)


def test_qwen_reader_needs_no_tokenizer_or_regex_package(files):
    """The file reads and encodes the same where neither `tokenizers` nor
    `regex` can be imported (the card's machine has neither)."""
    d = files["string_merges"]
    code = (
        "import sys\n"
        "sys.modules['tokenizers'] = None\n"
        "sys.modules['regex'] = None\n"
        "from diffusion_models_moe_tpu_torch.data.tokenizer import "
        "load_qwen_tokenizer\n"
        f"enc, dec = load_qwen_tokenizer({d!r})\n"
        f"print([enc(t).tolist() for t in {TEXTS[:4]!r}])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    encode, _ = jtok.load_qwen_tokenizer(d)
    assert json.loads(out) == [encode(t).tolist() for t in TEXTS[:4]]


def test_added_token_ids_come_from_the_file(files):
    """A file whose added tokens do not follow the model's vocabulary:
    `tokenizers` numbers them on from the vocabulary whatever ids the file
    gives, the port keeps the file's ids. Qwen2's files (and every file
    this repository writes) put them right after the vocabulary, where both
    agree (`test_encode_decode_equal_tokenizers`)."""
    with open(os.path.join(files["string_merges"], "tokenizer.json"),
              encoding="utf-8") as f:
        spec = json.load(f)
    n = len(spec["model"]["vocab"])
    for i, tok in enumerate(spec["added_tokens"]):
        tok["id"] = n + 100 + i
    ours = nu.Tokenizer(spec)
    ref = Tokenizer.from_str(json.dumps(spec))
    assert ours.token_to_id("<|im_end|>") == n + 102
    assert ref.token_to_id("<|im_end|>") == n + 2
