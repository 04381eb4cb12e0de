"""Writes the table of Grapheme_Cluster_Break classes that the port's T5
tokenizer splits graphemes with.

    python3 tools/gen_grapheme_classes.py [--out PATH]

The `Precompiled` normalizer of a T5 `tokenizer.json` looks up its charsmap
grapheme by grapheme (extended grapheme clusters, UAX #29). The port splits
graphemes itself (`diffusion_models_moe_tpu_torch/data/_native_unigram.py`),
since the GPU host has no package that does; this table gives it the
property of every code point whose class is not `Other`: `CR`, `LF`,
`Control`, `Extend`, `ZWJ`, `Regional_Indicator`, `Prepend`, `SpacingMark`,
`L`, `V`, `T`, `LV`, `LVT`, and `ExtPict` (Extended_Pictographic, a separate
property, for rule GB11; a code point of both takes its GCB class, which is
`Other` or `Extend`, with `+ExtPict`). Each line is `start end class` (hex
code points, inclusive), a run of consecutive code points of one class; the
header names the `regex` version it was made with. Needs `regex`; reads
nothing else.
"""
from __future__ import annotations

import argparse
import itertools
import os
import sys

import regex

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "diffusion_models_moe_tpu_torch", "data",
                   "_grapheme_classes.txt")
CLASSES = ("CR", "LF", "Control", "Extend", "ZWJ", "Regional_Indicator",
           "Prepend", "SpacingMark", "L", "V", "T", "LV", "LVT")


def class_runs() -> list[tuple[int, int, str]]:
    every = "".join(map(chr, range(sys.maxunicode + 1)))
    cls = ["Other"] * len(every)
    for name in CLASSES:
        for m in regex.finditer(rf"\p{{GCB={name}}}", every):
            cls[m.start()] = name
    for m in regex.finditer(r"\p{Extended_Pictographic}", every):
        cls[m.start()] = ("ExtPict" if cls[m.start()] == "Other"
                          else cls[m.start()] + "+ExtPict")
    runs, start = [], 0
    for name, grp in itertools.groupby(cls):
        end = start + sum(1 for _ in grp) - 1
        if name != "Other":
            runs.append((start, end, name))
        start = end + 1
    return runs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    runs = class_runs()
    with open(args.out, "w", encoding="ascii") as f:
        f.write(f"# regex {regex.__version__}: Grapheme_Cluster_Break and "
                f"Extended_Pictographic in {len(runs)} runs; start end class\n")
        for s, e, name in runs:
            f.write(f"{s:06x} {e:06x} {name}\n")
    print(f"{args.out}: {len(runs)} runs")


if __name__ == "__main__":
    main()
