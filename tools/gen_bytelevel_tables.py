"""Writes the two tables that make the port's byte-level BPE reader split
and normalize text as the installed `tokenizers` does.

    python3 tools/gen_bytelevel_tables.py [--classes PATH] [--nfc PATH]

Qwen2's `tokenizer.json` splits words with a `Split` pre-tokenizer whose
pattern uses `\\p{L}`, `\\p{N}` and `\\s`, and normalizes with `NFC`. The
port (`diffusion_models_moe_tpu_torch/data/_native_unigram.py`) runs the
pattern on the stdlib `re` over classes built from the interpreter's
`unicodedata` and runs NFC through `unicodedata.normalize`. `tokenizers`
carries Unicode tables of its own: its regex engine's classes are newer than
the interpreter's, its normalization data older. The two tables hold the
code points where they differ:

  * `_split_classes.txt`: `start end class` runs (hex, inclusive) of the code
    points whose class under `tokenizers`' `Split` (L letter, N number,
    S white space, O none of them) is not the one `unicodedata` gives (major
    category L or N, the White_Space set for S);
  * `_nfc_table.txt`: `cp ccc nfd composes` lines for each code point whose
    canonical combining class, full canonical decomposition (hex code
    points joined by `.`) or recomposition (1 where NFC of its NFD gives it
    back) differ between `tokenizers`' `NFD`/`NFC` and `unicodedata`. A
    combining class is read from how `tokenizers`' `NFD` orders the code
    point against marks of every class.

Each header names the `tokenizers` version and the interpreter's Unicode
version. Needs `tokenizers`; reads nothing else.
"""
from __future__ import annotations

import argparse
import itertools
import os
import sys
import unicodedata

import tokenizers
from tokenizers import Regex, normalizers, pre_tokenizers

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "diffusion_models_moe_tpu_torch", "data")
WHITE_SPACE = {0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680,
               *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F,
               0x3000}
CHUNK = 8192


def code_points() -> list[int]:
    """Every code point a Rust string can hold (no surrogates)."""
    return [c for c in range(sys.maxunicode + 1)
            if not 0xD800 <= c <= 0xDFFF]


def _removed(pattern: str, cps: list[int]) -> set[int]:
    """The code points `Split(pattern, "removed")` takes out of a string."""
    split = pre_tokenizers.Split(Regex(pattern), behavior="removed")
    out: set[int] = set()
    for i in range(0, len(cps), CHUNK):
        chunk = cps[i:i + CHUNK]
        kept = set()
        for _, (a, b) in split.pre_tokenize_str("".join(map(chr, chunk))):
            kept.update(chunk[a:b])
        out.update(set(chunk) - kept)
    return out


def py_class(cp: int) -> str:
    if cp in WHITE_SPACE:
        return "S"
    major = unicodedata.category(chr(cp))[0]
    return major if major in ("L", "N") else "O"


def class_runs() -> list[tuple[int, int, str]]:
    cps = code_points()
    sets = {k: _removed(p, cps) for k, p in
            (("L", r"\p{L}"), ("N", r"\p{N}"), ("S", r"\s"))}
    diff = []
    for cp in cps:
        got = next((k for k, s in sets.items() if cp in s), "O")
        if got != py_class(cp):
            diff.append((cp, got))
    runs = []
    for (_, cls), grp in itertools.groupby(
            enumerate(diff), key=lambda t: (t[1][0] - t[0], t[1][1])):
        cps_run = [cp for _, (cp, _) in grp]
        runs.append((cps_run[0], cps_run[-1], cls))
    return runs


def _segments(norm, text_of, cps: list[int]) -> list[str]:
    """`norm` of each `text_of(cp)`, batched between NUL separators (no
    decomposition makes or takes a NUL)."""
    out: list[str] = []
    for i in range(0, len(cps), CHUNK):
        chunk = cps[i:i + CHUNK]
        parts = norm.normalize_str("".join("\x00" + text_of(cp)
                                           for cp in chunk)).split("\x00")[1:]
        assert len(parts) == len(chunk)
        out.extend(parts)
    return out


def crate_cccs(cps: list[int]) -> dict[int, int]:
    """Combining classes under `tokenizers`' NFD of the code points it does
    not decompose: ccc(c) > v where NFD("a" c m_v) moves the mark m_v of
    class v before c; classes 0 and 1 told apart by a mark of class 230.
    Each mark m_v has class v by its own check, and is not tested against
    itself."""
    nfd = normalizers.NFD()
    marks = {}
    for cp in range(sys.maxunicode + 1):
        v = unicodedata.combining(chr(cp))
        if v and v not in marks:
            marks[v] = chr(cp)
    # keep the marks `tokenizers` gives the class unicodedata gives
    known = {}
    for v, m in marks.items():
        ok = all(nfd.normalize_str("a" + m + other) == "a" + (
            m + other if v <= w else other + m)
                 for w, other in marks.items() if w != v and w in (1, 240))
        if ok:
            known[v] = m
    values = sorted(known)
    above = {}                          # v -> cps with ccc > v
    cand = cps
    for v in values:
        m = known[v]
        segs = _segments(nfd, lambda cp: "a" + chr(cp) + m, cand)
        above[v] = {cp for cp, s in zip(cand, segs)
                    if s == "a" + m + chr(cp) and chr(cp) != m}
        cand = sorted(above[v])
    m230 = known[230]
    low = _segments(nfd, lambda cp: "a" + m230 + chr(cp), cps)
    below_230 = {cp for cp, s in zip(cps, low)
                 if s == "a" + chr(cp) + m230 and chr(cp) != m230}
    out = {}
    for cp in cps:
        if cp in below_230 and cp not in above[values[0]]:
            out[cp] = values[0]
            continue
        over = [v for v in values if cp in above[v]]
        if not over:
            out[cp] = 0
        else:
            nxt = [v for v in values if v > over[-1]]
            out[cp] = nxt[0] if nxt else 255
    return out


def nfc_rows() -> list[tuple[int, int, str, int]]:
    cps = [cp for cp in code_points() if cp != 0]
    nfd, nfc = normalizers.NFD(), normalizers.NFC()
    crate_nfd = _segments(nfd, chr, cps)
    crate_nfc = _segments(nfc, lambda cp: crate_nfd[idx[cp]], cps)
    selfd = [cp for cp in cps if crate_nfd[idx[cp]] == chr(cp)]
    cccs = crate_cccs(selfd)
    rows = []
    for cp in cps:
        c = chr(cp)
        py_nfd = unicodedata.normalize("NFD", c)
        py_comp = int(py_nfd != c and unicodedata.normalize("NFC", py_nfd) == c)
        d = crate_nfd[idx[cp]]
        comp = int(d != c and crate_nfc[idx[cp]] == c)
        ccc = cccs.get(cp, unicodedata.combining(c))
        py_ccc = unicodedata.combining(c) if py_nfd == c else ccc
        if (d, comp, ccc) != (py_nfd, py_comp, py_ccc):
            if comp and not py_comp:
                raise SystemExit(f"U+{cp:04X}: tokenizers composes it and "
                                 "unicodedata does not; the port's NFC does "
                                 "not take such a table")
            rows.append((cp, ccc, ".".join(f"{ord(x):04x}" for x in d), comp))
    return rows


idx: dict[int, int] = {}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--classes", default=os.path.join(DATA,
                                                      "_split_classes.txt"))
    ap.add_argument("--nfc", default=os.path.join(DATA, "_nfc_table.txt"))
    args = ap.parse_args()
    idx.update({cp: i for i, cp in enumerate(
        cp for cp in code_points() if cp != 0)})
    head = (f"tokenizers {tokenizers.__version__} against unicodedata "
            f"{unicodedata.unidata_version}")
    runs = class_runs()
    n = sum(e - s + 1 for s, e, _ in runs)
    with open(args.classes, "w", encoding="ascii") as f:
        f.write(f"# {head}: {n} code points in {len(runs)} runs; start end "
                "class (L, N, S or O)\n")
        for s, e, cls in runs:
            f.write(f"{s:06x} {e:06x} {cls}\n")
    print(f"{args.classes}: {n} code points in {len(runs)} runs")
    rows = nfc_rows()
    with open(args.nfc, "w", encoding="ascii") as f:
        f.write(f"# {head}: {len(rows)} code points; cp ccc nfd composes\n")
        for cp, ccc, d, comp in rows:
            f.write(f"{cp:06x} {ccc} {d} {comp}\n")
    print(f"{args.nfc}: {len(rows)} code points")


if __name__ == "__main__":
    main()
