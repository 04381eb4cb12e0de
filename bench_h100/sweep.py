"""The sweep that fixed the serving cell's rate: the cell's traffic at
several offered rates, one run each in this one process, on the card.

    python3 bench_h100/sweep.py --workload sd15-moe.serve-poisson \
        --seconds 30 --rates 3 4 5 6

One JSON line a rate: p95, the mean latency of the first and second half
of the arrivals (a backlog that grows shows as a second half slower than
the first), the engine's counters. The highest rate without a growing
backlog is the one the engine sustains; the cell offers 0.8 of it. The
benchmark's own runs never run this.
"""
import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=900)
    args = ap.parse_args(argv)
    from bench_h100.harness import loader
    from bench_h100.harness.cell import metrics, run_cell
    for i, rate in enumerate(args.rates):
        cell = loader.load_cell(args.workload)
        cell.mix["rate_per_s"] = rate
        run, checks = run_cell(cell, args.seed + i, args.seconds, False, "cuda")
        o = run.outcome
        print(json.dumps({"rate": rate, "metrics": metrics(run, False),
                          "notes": o.notes, "serving": o.serving,
                          "failed": len(o.failed), "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
