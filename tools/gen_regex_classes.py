"""Writes the table of code points whose class under the `regex` package
differs from the interpreter's `unicodedata` major category.

    python3 tools/gen_regex_classes.py [--out PATH]

CLIP's word split uses `\\p{L}` and `\\p{N}` of `regex`, whose Unicode
database can be newer than the interpreter's. The port splits words with the
stdlib `re` on classes built from `unicodedata`
(`diffusion_models_moe_tpu_torch/data/tokenizer.py`), and merges this table
over them so that both splits agree on every code point to U+10FFFF. Each
line of the table is `start end class` (hex code points, inclusive; class
`L` letter, `N` number, `O` neither), a run of consecutive code points of one
class. The header names the `regex` version and the interpreter's Unicode
version it was made with. Needs `regex`; reads nothing else.
"""
from __future__ import annotations

import argparse
import itertools
import os
import sys
import unicodedata

import regex

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "diffusion_models_moe_tpu_torch", "data",
                   "_regex_classes.txt")


def differing_runs() -> list[tuple[int, int, str]]:
    """(start, end, class) runs of the code points whose `regex` class is
    not their `unicodedata` major category's."""
    every = "".join(map(chr, range(sys.maxunicode + 1)))
    in_l = {m.start() for m in regex.finditer(r"\p{L}", every)}
    in_n = {m.start() for m in regex.finditer(r"\p{N}", every)}
    diff = []
    for cp, c in enumerate(every):
        major = unicodedata.category(c)[0]
        got = "L" if cp in in_l else "N" if cp in in_n else "O"
        want = major if major in ("L", "N") else "O"
        if got != want:
            diff.append((cp, got))
    runs = []
    for (_, cls), grp in itertools.groupby(
            enumerate(diff), key=lambda t: (t[1][0] - t[0], t[1][1])):
        cps = [cp for _, (cp, _) in grp]
        runs.append((cps[0], cps[-1], cls))
    return runs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    runs = differing_runs()
    n = sum(e - s + 1 for s, e, _ in runs)
    with open(args.out, "w", encoding="ascii") as f:
        f.write(f"# regex {regex.__version__} against unicodedata "
                f"{unicodedata.unidata_version}: {n} code points in "
                f"{len(runs)} runs; start end class (L, N or O)\n")
        for s, e, cls in runs:
            f.write(f"{s:06x} {e:06x} {cls}\n")
    print(f"{args.out}: {n} code points in {len(runs)} runs")


if __name__ == "__main__":
    main()
