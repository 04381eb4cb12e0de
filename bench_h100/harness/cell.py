"""One run of one cell: set-up, warm-up, the measured window, the check
against the reference, the metrics.

Set-up: the weights made from the seed (`weights.make`) are loaded into the
program built by the configuration module's `build` (the port's pipeline
and its MoE interventions), then dropped; the peak memory counter is reset
there, so the staging copy is not counted and the program's weights are. The
traffic's session warms up the cell's own shapes. `setup_s` runs from the
process's start to the window's. After the window the program is freed and
the reference runs on a sample of the completed requests. A traced run
traces the window's second half only (`harness/trace.py`); its host-clock
and counter metrics read the first.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import torch

from bench_h100.harness import check, weights
from bench_h100.harness.inputs import Inputs, stream
from bench_h100.harness.outcome import Outcome
from bench_h100.harness.trace import Tracer

_CHECK_SAMPLE = 6


class NoTracer:
    """The untraced run's window: never due to start a profiler."""
    began = True

    def open(self):
        pass

    def due(self):
        return False

    def close(self):
        pass


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cell: object
    outcome: Outcome
    setup_s: float
    memory_peak_bytes: int
    trace: Optional[dict]

    @property
    def config(self) -> dict:
        return self.cell.config


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, modes: Optional[dict] = None,
             candidates: bool = False):
    """Returns (Run, checks {name: {"value", "limit"}}). `modes`: the
    program's serving modes (the control's int8 path); `candidates`: the
    checks also hold `check.candidates`."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    cfg, fam = cell.config, cell.family
    inputs = Inputs(cfg, seed, fam)
    parts = {"imports": time.perf_counter() - t_start}
    staged = weights.make(fam.skeleton(cfg), seed, device, norms=fam.NORMS)
    parts["weights"] = time.perf_counter() - t_start
    program = fam.build(cfg, staged, inputs.labels(), device, modes)
    del staged
    _free(device)
    parts["program"] = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    session = cell.kind.Session(program, cell.mix, inputs, device)
    session.warm_up()
    parts["warm_up"] = time.perf_counter() - t_start
    tracer = (Tracer(program.denoiser, seconds / 2,
                     "cuda" if cuda else "cpu") if trace else None)
    if tracer:
        tracer.install()
    try:
        outcome = session.measure(seconds, tracer or NoTracer())
    finally:
        if tracer:
            tracer.stop()
        session.close()
    setup_s = outcome.t0 - t_start
    outcome.notes["setup_until"] = parts
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    trace_data = tracer.read() if tracer else None
    del tracer
    rng = stream(seed, _CHECK_SAMPLE)
    sample = session.sample(outcome, cell.check["requests"], rng)
    del session, program
    _free(device)
    t_check = time.perf_counter()
    checks, extra = check.compare(cell, inputs, sample, outcome.steps,
                                  outcome.guidance, device, candidates)
    outcome.notes.update(extra, check_s=time.perf_counter() - t_check)
    return Run(cell, outcome, setup_s, peak, trace_data), checks


def verdict(run: Run, checks: dict) -> bool:
    """`correct`: every compared number within its limit, and every request
    due in the window answered."""
    return (all(c["value"] <= c["limit"] for c in checks.values())
            and not run.outcome.failed)


def metrics(run: Run, trace: bool) -> dict:
    """{name: {"value", "unit"}}: with `trace` the cell's per-layer
    metrics, else its end-to-end ones; a reader that finds nothing to read
    returns None and its metric is left out."""
    out = {}
    for m in run.cell.metrics:
        if m.end_to_end == trace:
            continue
        value = m.reader.read(run)
        if value is not None:
            out[m.name] = {"value": value, "unit": m.unit}
    return out
