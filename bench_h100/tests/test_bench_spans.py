"""The readers of the program's spans on traced CPU runs of the tiny cells:
`queue_wait_s.serve` against the same mean worked out by hand from the
ring, `decode_s.gen` None off the card (with decode spans there to read),
and the trace's readers unchanged by the program's ranges (the same trace
reduced with and without its `dmoe.*` events)."""
import dataclasses

import pytest
import torch

from bench_h100.harness import loader, trace
from bench_h100.harness.cell import run_cell
from bench_h100.tests.tiny import TINY, tiny_cell
from diffusion_models_moe_tpu_torch import profiling

SEED = 2 ** 33 + 5
MIXES = {"gen-b8": {"batch": 2, "steps": 2},
         "serve-poisson": {"batch": 4, "steps": 2, "rate_per_s": 6.0,
                           "max_wait_ms": 100, "drain_s": 30}}
SECONDS = {"gen-b8": 1.0, "serve-poisson": 3.0}
TRACE_READERS = ("idle_share.gen", "idle_share.serve", "roofline.ff.gen",
                 "roofline.attn.gen")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reader(name):
    return loader.load_module(loader.BENCH / "metrics" / f"{name}.py")


@pytest.fixture(scope="module")
def runs():
    """A traced tiny run of each traffic, with the kineto events its
    tracer read."""
    out = {}
    for traffic, mix in MIXES.items():
        events, read = [], trace.Tracer.read

        def keep(self):
            events.extend(self.prof.profiler.kineto_results.events())
            return read(self)

        trace.Tracer.read = keep
        try:
            cell = tiny_cell(traffic, mix, requests=2,
                             config=dict(TINY, moe=dict(TINY["moe"],
                                                        topk_ratio=1.0)))
            run, _ = run_cell(cell, SEED, SECONDS[traffic], True, "cpu")
        finally:
            trace.Tracer.read = read
        out[traffic] = run, events
    return out


def test_queue_wait_is_the_mean_wait_of_the_first_halfs_batches(runs):
    run, _ = runs["serve-poisson"]
    o = run.outcome
    lo, hi = o.t0 * 1e9, o.t_split * 1e9
    # by hand: each batch that started in the half names its requests
    submitted = {r.attrs["request"]: r.start_ns
                 for r in profiling.spans("dmoe.serve.request")
                 if r.start_ns >= lo}
    waits = [b.start_ns - submitted[i]
             for b in profiling.spans("dmoe.serve.batch")
             if lo <= b.start_ns <= hi for i in b.attrs["requests"]]
    assert waits and min(waits) >= 0
    got = _reader("queue_wait_s.serve").read(run)
    assert got == pytest.approx(sum(waits) / len(waits) / 1e9, rel=1e-12)
    assert 0 <= got <= o.t_split - o.t0


def test_decode_seconds_are_none_off_the_card(runs):
    run, _ = runs["gen-b8"]
    o = run.outcome
    decodes = [s for s in profiling.spans("dmoe.pipe.decode")
               if o.t0 * 1e9 <= s.start_ns <= o.t_split * 1e9]
    assert decodes
    assert _reader("decode_s.gen").read(run) is None
    # the serving cell's run has no generate cell's metric
    assert _reader("decode_s.gen").read(runs["serve-poisson"][0]) is None
    assert _reader("queue_wait_s.serve").read(run) is None


def test_an_untraced_run_reads_neither(runs):
    for traffic in MIXES:
        run = dataclasses.replace(runs[traffic][0], trace=None)
        assert _reader("queue_wait_s.serve").read(run) is None
        assert _reader("decode_s.gen").read(run) is None


@pytest.mark.parametrize("traffic", sorted(MIXES))
def test_the_programs_ranges_leave_the_trace_readers_unchanged(runs, traffic):
    run, events = runs[traffic]
    # the profiler records the ranges of the thread that started it: the
    # generate's, not the serving engine's executor
    assert any(e.name().startswith("dmoe.") for e in events) == (
        traffic == "gen-b8")
    calls = run.trace["calls"]
    bare = trace.reduce([e for e in events
                         if not e.name().startswith("dmoe.")], calls)
    full = trace.reduce(events, calls)
    for key in ("window_s", "busy_s", "range_device_s", "calls",
                "device_ops"):
        assert full[key] == bare[key], key
    for name in TRACE_READERS:
        reader = _reader(name)
        assert (reader.read(dataclasses.replace(run, trace=full))
                == reader.read(dataclasses.replace(run, trace=bare))), name
