"""Profiling helpers of the PyTorch port: a trace of a run and its time by
op name, the counterpart of `diffusion_models_moe_tpu/profiling.py`.

    from diffusion_models_moe_tpu_torch.profiling import trace, top_ops
    with trace("/tmp/prof"):                 # run the work inside
        images, _ = pipe.generate(cond, uncond, seeds=[0])
    for row in top_ops("/tmp/prof")[:20]:
        print(row)

`trace` wraps `torch.profiler.profile` (CPU activity, plus the card's
kernels, copies and sets through CUPTI where CUDA is on) and writes a
gzipped chrome trace `<ns>.pt.trace.json.gz` under the log directory.
`top_ops` aggregates the duration of the newest trace's complete events by
name. A trace taken on the card tags its device events (`cat` "kernel",
"gpu_memcpy", "gpu_memset"); `device_only` keeps those. A trace without
such tags (a CPU run) gets the JAX package's name filter instead.
"""
from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from collections import defaultdict
from typing import Optional

TRACE_SUFFIX = ".pt.trace.json.gz"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None):
    """torch.profiler trace of the block, written as a gzipped chrome trace
    under `log_dir`. `cuda`: record the card's activity too (default: where
    a CUDA device is present); the device is synchronized before the
    profiler stops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() if cuda is None else cuda
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if cuda:
                torch.cuda.synchronize()
    path = os.path.join(log_dir, f"{time.time_ns():020d}{TRACE_SUFFIX}")
    raw = path[:-len(".gz")]
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as src, gzip.open(path, "wb") as dst:
        dst.writelines(src)
    os.remove(raw)


def _find_trace(log_dir: str) -> str:
    hits = sorted(glob.glob(os.path.join(log_dir, "**", f"*{TRACE_SUFFIX}"),
                            recursive=True), key=os.path.basename)
    if not hits:
        raise FileNotFoundError(f"no torch.profiler trace under {log_dir}")
    return hits[-1]


def load_events(log_dir: str) -> list[dict]:
    """Raw complete-events ('X') from the newest trace."""
    with gzip.open(_find_trace(log_dir), "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", data) if isinstance(data, dict) else data
    return [e for e in events or [] if e.get("ph") == "X" and "dur" in e]


def _host_name(name: str) -> bool:
    """The JAX package's heuristic for a host event (python frames, source
    files, runtime threads)."""
    return (name.startswith("$") or name.endswith(".py")
            or "python" in name.lower())


def top_ops(log_dir: str, min_us: float = 0.0,
            device_only: bool = True) -> list[dict]:
    """Aggregate duration by event name, descending.

    Returns [{"name", "total_us", "count", "pct"}]. With device_only, the
    events of the device categories where the trace has any (a trace taken
    on the card), else the events whose names do not look like host python
    (the JAX package's filter)."""
    events = load_events(log_dir)
    if device_only:
        if any(e.get("cat") in DEVICE_CATEGORIES for e in events):
            events = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
        else:
            events = [e for e in events
                      if not _host_name(e.get("name", ""))]
    agg = defaultdict(lambda: [0.0, 0])
    for e in events:
        name = e.get("name", "")
        agg[name][0] += float(e["dur"])
        agg[name][1] += 1
    total = sum(v[0] for v in agg.values()) or 1.0
    rows = [{"name": k, "total_us": round(v[0], 1), "count": v[1],
             "pct": round(100.0 * v[0] / total, 2)}
            for k, v in agg.items() if v[0] >= min_us]
    return sorted(rows, key=lambda r: -r["total_us"])


def step_time_report(log_dir: str, top_n: int = 25) -> str:
    """Human-readable table of the top ops (the artifact to paste into perf
    commit messages / docstrings)."""
    rows = top_ops(log_dir)[:top_n]
    width = max((len(r["name"]) for r in rows), default=4)
    lines = [f"{'op':<{width}}  {'total_ms':>9}  {'count':>6}  {'pct':>6}"]
    for r in rows:
        lines.append(f"{r['name']:<{width}}  {r['total_us']/1000.0:>9.3f}  "
                     f"{r['count']:>6}  {r['pct']:>5.1f}%")
    return "\n".join(lines)


def profile_generate(pipe, cond, uncond, log_dir: str, num_steps: int = 50,
                     ivs=None, seed: int = 0) -> str:
    """Warm up once (cuDNN and cuBLAS set-up, the kernels' first launch)
    outside the trace, then trace one whole generate and return the report.
    The noise comes from a generator on the pipeline's device seeded with
    `seed`, the same for both runs."""
    import torch

    def run():
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        images, _ = pipe.generate(cond, uncond, gen, num_steps=num_steps,
                                  ivs=ivs)
        return images.cpu()

    run()
    with trace(log_dir, cuda=torch.device(pipe.device).type == "cuda"):
        run()
    return step_time_report(log_dir)
