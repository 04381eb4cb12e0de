"""The port's spans and profiler ranges (`profiling.py`), on the CPU at the
tiny geometries: the tree of one generate's spans, the serving engine's
request and batch spans against its counters, the ring's bound, no
`record_function` while the profiler is off, every range name under a CPU
`torch.profiler` with each span within 1 ms of its range on the profiler's
clock, and no device seconds off the card."""
import collections
import time
import types

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.autograd import profiler as autograd_profiler

from diffusion_models_moe_tpu_torch import (SDXLPipeline,
                                            StableDiffusionPipeline,
                                            profiling, tiny_config)
from diffusion_models_moe_tpu_torch import config as pcfg
from diffusion_models_moe_tpu_torch.data.tokenize import \
    per_prompt_hash_tokenize
from diffusion_models_moe_tpu_torch.ops import _build
from diffusion_models_moe_tpu_torch.serving import ServingEngine
from torch_parity import tiny_sdxl
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

STEPS = 2
WAIT = 120          # seconds a test waits for a future before it fails
PIPE_SPANS = ("dmoe.pipe.encode", "dmoe.pipe.denoise", "dmoe.pipe.decode")
# the ranges a generate, a served batch and a kernel launch open
RANGES = ("dmoe.pipe.generate",) + PIPE_SPANS + (
    "dmoe.pipe.step", "dmoe.unet", "dmoe.unet.attn1", "dmoe.unet.ff",
    "dmoe.serve.wait", "dmoe.serve.batch", "dmoe.kernel.ff_front")


@pytest.fixture(scope="module")
def sd():
    cfg = tiny_config()
    pipe = StableDiffusionPipeline(cfg, device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    return pipe


@pytest.fixture(scope="module")
def sdxl():
    cfg, text_cfgs = tiny_sdxl(pcfg)
    pipe = SDXLPipeline(cfg, text_cfgs, device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    return pipe


def _ids(pipe, b: int = 2) -> torch.Tensor:
    tc = getattr(pipe, "text_configs", (pipe.config.text_encoder,))[0]
    return torch.randint(0, tc.vocab_size, (b, tc.max_length),
                         generator=torch.Generator().manual_seed(1))


def _generate(pipe):
    ids = _ids(pipe)
    return pipe.generate(ids, torch.zeros_like(ids), seeds=[0, 1],
                         num_steps=STEPS)


def _since(t_ns: int, name: str) -> list:
    return [s for s in profiling.spans(name) if s.start_ns >= t_ns]


def _serve(pipe, n: int = 3) -> ServingEngine:
    tc = pipe.config.text_encoder
    eng = ServingEngine(pipe, per_prompt_hash_tokenize(tc.vocab_size,
                                                       tc.max_length),
                        batch_size=2, num_steps=STEPS, max_wait_ms=300.0)
    with eng:
        futs = [eng.submit(f"prompt {i}", seed=i) for i in range(n)]
        for f in futs:
            f.result(timeout=WAIT)
    return eng


@pytest.mark.parametrize("which", ["sd", "sdxl"])
def test_a_generate_holds_encode_denoise_and_decode(which, request):
    pipe = request.getfixturevalue(which)
    t = time.perf_counter_ns()
    _generate(pipe)
    gen, = _since(t, "dmoe.pipe.generate")
    assert gen.parent is None and gen.seconds > 0
    for name in PIPE_SPANS:
        child, = _since(t, name)
        assert child.parent == gen.id and child.thread == gen.thread
        assert gen.start_ns <= child.start_ns <= child.end_ns <= gen.end_ns
    encode, denoise, decode = (_since(t, n)[0] for n in PIPE_SPANS)
    assert encode.end_ns <= denoise.start_ns
    assert denoise.end_ns <= decode.start_ns
    timesteps, _ = pipe.scheduler.set_timesteps(STEPS)
    assert denoise.attrs["unet_calls"] == len(timesteps)
    # the ring holds them in the order they ended: children first
    order = [s.name for s in profiling.spans() if s.start_ns >= t]
    assert order == list(PIPE_SPANS) + ["dmoe.pipe.generate"]


def test_each_request_carries_its_batch_and_the_counters_read_the_spans(sd):
    t = time.perf_counter_ns()
    eng = _serve(sd)
    requests = _since(t, "dmoe.serve.request")
    batches = {s.attrs["batch"]: s for s in _since(t, "dmoe.serve.batch")}
    assert len(requests) == 3 and len(batches) == eng.stats.batches == 2
    assert sorted(s.attrs["request"] for s in requests) == [0, 1, 2]
    for r in requests:
        b = batches[r.attrs["batch"]]
        assert r.attrs["request"] in b.attrs["requests"]
        assert r.start_ns <= b.start_ns and b.end_ns <= r.end_ns
    assert sum(b.attrs["real"] for b in batches.values()) == 3
    assert eng.stats.total_batch_seconds == sum(
        b.seconds for b in sorted(batches.values(), key=lambda s: s.id))


def test_the_ring_keeps_the_newest_spans_kept(monkeypatch):
    monkeypatch.setattr(profiling, "SPANS_KEPT", 8)
    monkeypatch.setattr(profiling, "_RING", collections.deque())
    for i in range(20):
        with profiling.span("test.ring", i=i):
            pass
    kept = profiling.spans("test.ring")
    assert [s.attrs["i"] for s in kept] == list(range(12, 20))
    assert profiling.spans() == kept


def test_no_record_function_while_the_profiler_is_off(sd, monkeypatch):
    entered = []

    def counting(real):
        def enter(name, *args, **kw):
            entered.append(name)
            return real(name, *args, **kw)
        return enter

    # both ways into a RecordFunction from Python
    monkeypatch.setattr(autograd_profiler, "record_function",
                        counting(autograd_profiler.record_function))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counting(torch._C._profiler._RecordFunctionFast))
    assert not autograd_profiler._is_profiler_enabled
    _generate(sd)
    _serve(sd, n=2)
    assert entered == []
    assert profiling.annotate("a") is profiling.annotate("b")
    # the count does see the port's ranges once the profiler runs
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _generate(sd)
    assert "dmoe.unet.ff" in entered


def test_every_range_is_on_the_profilers_clock_within_a_millisecond(sd):
    # a stand-in library: the launcher's host call with no kernel behind it
    lib = _build.KernelLibrary(
        types.SimpleNamespace(dmoe_ff_front=lambda *a: 0), None, 0.0, "")
    t = time.perf_counter_ns()
    # the serving engine's executor is a thread of its own
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=_ExperimentalConfig(
                profile_all_threads=True)) as prof:
        _generate(sd)
        _serve(sd, n=2)
        lib.call("dmoe_ff_front")
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        events[e.name()].append(e)
    assert set(RANGES) <= set(events), set(RANGES) - set(events)
    ring = [s for s in profiling.spans() if s.start_ns >= t
            and s.name != "dmoe.serve.request"]
    assert {s.name for s in ring} == {"dmoe.pipe.generate",
                                      "dmoe.serve.batch", *PIPE_SPANS}
    for s in ring:
        near = min(events[s.name], key=lambda e: abs(
            e.start_ns() - profiling.to_trace_ns(s.start_ns)))
        assert abs(profiling.to_trace_ns(s.start_ns) - near.start_ns()) < 1e6
        assert abs(profiling.to_trace_ns(s.end_ns) - near.end_ns()) < 1e6


def test_device_seconds_are_none_off_the_card(sd):
    t = time.perf_counter_ns()
    _generate(sd)
    for name in ("dmoe.pipe.generate",) + PIPE_SPANS:
        assert _since(t, name)[0].device_seconds() is None
    with profiling.span("test.cpu", device=torch.device("cpu")) as s:
        pass
    assert s.device_seconds() is None
    r = profiling.begin("test.open")
    assert r.seconds is None and r.device_seconds() is None
    r.end()
    assert r.seconds >= 0 and profiling.spans("test.open")[-1] is r
