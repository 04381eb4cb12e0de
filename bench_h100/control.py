"""Readings that set a cell's limits: the program's compared numbers over
many seeds (the lower reading) and a control's (the upper): the program
with one of the configuration's lower-precision controls on (`CONTROLS` of
`configs/<config>.py`; the SD family's `int8` is the port's own int8 path,
`quant_int8=True`, W8A8 products and convolutions, the nearest precision
below the configuration's bfloat16).

    python3 bench_h100/control.py --workload <cell> --seconds 5 \
        --variant program|<control> --seeds 11 12 13 ...

Every seed is a whole run of the cell (set-up, a short window at the cell's
own load, the reference on the cell's sample) in this one process; one
JSON line a seed. The benchmark's own runs never run this.
"""
import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--variant", required=True,
                    help="program, or a name of the configuration's CONTROLS")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from bench_h100.harness import loader
    from bench_h100.harness.cell import run_cell
    cell = loader.load_cell(args.workload)
    variants = {"program": None, **cell.family.CONTROLS}
    if args.variant not in variants:
        ap.error(f"--variant {args.variant!r}: one of {sorted(variants)}")
    for seed in args.seeds:
        t = time.perf_counter()
        run, checks = run_cell(cell, seed, args.seconds, False, args.device,
                               modes=variants[args.variant],
                               candidates=True)
        print(json.dumps({"workload": args.workload, "variant": args.variant,
                          "seed": seed, "checks": checks,
                          "candidates": run.outcome.notes.get("candidates"),
                          "img_rel_l2_each": run.outcome.notes.get(
                              "img_rel_l2_each"),
                          "requests": len(run.outcome.requests),
                          "failed": len(run.outcome.failed),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
