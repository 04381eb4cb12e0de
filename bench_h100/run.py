"""Runs one cell of the port's benchmark once, on this machine's card.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix,
check and metrics are found by name from `BENCHMARK.json` (see
`harness/loader.py`). The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer ones), `device`, with `--trace 1` a
`breakdown`, and last `checks`: each number compared with its limit, also
printed as the last lines of standard error. Exits non-zero without a
result where no card is present, where the checkout lacks the program, or
where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every build and kernel cache of the run stays inside the checkout, at
# fixed paths, so that only a checkout's first run builds
CACHE = ROOT / "bench_h100" / ".cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "diffusion_models_moe_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    jaxlib's, flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--candidates", type=int, choices=(0, 1), default=0,
                    help="also compute every number a cell could compare "
                         "(the reference's bfloat16 floor included) and "
                         "print them with the run's notes: for setting limits")
    args = ap.parse_args(argv)

    import torch
    from bench_h100.harness import loader
    from bench_h100.harness.cell import metrics, run_cell, verdict

    cell = loader.load_cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " present", file=sys.stderr)
        return 2
    trace = bool(args.trace)
    run, checks = run_cell(cell, args.seed, args.seconds, trace, "cuda",
                           t_start=T_START, candidates=bool(args.candidates))
    o = run.outcome
    failed = o.failed
    ok = verdict(run, checks)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": bool(ok), "attempted": len(o.requests),
              "failed": len(failed), "metrics": metrics(run, trace),
              "device": device}
    if trace:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in checks.items()}
    bad = forbidden_modules()
    if bad:
        print(f"run.py: loaded {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    notes = dict(o.notes, requests=len(o.requests), window_s=o.t1 - o.t0,
                 setup_s=run.setup_s)
    print("run: " + json.dumps(notes), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']:.6f} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
