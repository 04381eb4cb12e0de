"""The port's profiling helpers (`diffusion_models_moe_tpu_torch/
profiling.py`) against the JAX package's (`diffusion_models_moe_tpu/
profiling.py`): the same aggregation and report on the same events, each
package reading its own trace format; the port's device-category filter;
a traced generate on the CPU."""
import gzip
import json
import os

import pytest
import torch

from diffusion_models_moe_tpu import profiling as jprof
from diffusion_models_moe_tpu_torch import StableDiffusionPipeline, tiny_config
from diffusion_models_moe_tpu_torch import profiling as pprof

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

# host frames ($-names, source files, python), XLA-ish and CUDA kernel
# names, repeats, a zero-length event, and events that are not complete
EVENTS = [
    {"ph": "X", "name": "$main", "dur": 900.0, "ts": 0},
    {"ph": "X", "name": "stable_diffusion.py", "dur": 800.0, "ts": 1},
    {"ph": "X", "name": "PythonFunction step", "dur": 700.0, "ts": 2},
    {"ph": "X", "name": "fusion.123", "dur": 120.5, "ts": 3},
    {"ph": "X", "name": "fusion.123", "dur": 79.5, "ts": 4},
    {"ph": "X", "name": "void sd_self_attn_kernel<40, 2>(Maps, int, int, "
                        "float)", "dur": 333.25, "ts": 5},
    {"ph": "X", "name": "void sd_self_attn_kernel<40, 2>(Maps, int, int, "
                        "float)", "dur": 16.75, "ts": 6},
    {"ph": "X", "name": "ampere_bf16_s16816gemm", "dur": 42.0, "ts": 7},
    {"ph": "X", "name": "Memcpy HtoD", "dur": 3.0, "ts": 8},
    {"ph": "X", "name": "copy.7", "dur": 0.0, "ts": 9},
    {"ph": "B", "name": "fusion.123", "ts": 10},
    {"ph": "X", "name": "no duration", "ts": 11},
    {"ph": "i", "name": "instant", "ts": 12, "dur": 5.0},
]


def _write(path, payload):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump(payload, f)


@pytest.fixture
def traces(tmp_path):
    """The same events as JAX's perfetto file and as the port's trace."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    _write(str(jdir / "plugins" / "profile" / "2026_01_01" /
               "host.perfetto_trace.json.gz"), {"traceEvents": EVENTS})
    _write(str(pdir / f"{1:020d}{pprof.TRACE_SUFFIX}"),
           {"traceEvents": EVENTS, "deviceProperties": []})
    return str(jdir), str(pdir)


@pytest.mark.parametrize("device_only", [True, False])
@pytest.mark.parametrize("min_us", [0.0, 50.0, 300.0])
def test_top_ops_equal_jax(traces, device_only, min_us):
    jdir, pdir = traces
    ref = jprof.top_ops(jdir, min_us=min_us, device_only=device_only)
    got = pprof.top_ops(pdir, min_us=min_us, device_only=device_only)
    assert got == ref
    assert got, "no rows"


@pytest.mark.parametrize("top_n", [25, 2])
def test_step_time_report_equals_jax(traces, top_n):
    jdir, pdir = traces
    assert (pprof.step_time_report(pdir, top_n=top_n)
            == jprof.step_time_report(jdir, top_n=top_n))


def test_load_events_equal_jax(traces):
    jdir, pdir = traces
    assert pprof.load_events(pdir) == jprof.load_events(jdir)
    assert len(pprof.load_events(pdir)) == 10


def test_device_categories_keep_only_device_events(tmp_path):
    """A trace taken on the card tags its device events: device_only keeps
    kernels, copies and sets, whatever their names."""
    events = [dict(e, cat=cat) for e, cat in zip(EVENTS[:10], [
        "python_function", "python_function", "cpu_op", "cpu_op",
        "cuda_runtime", "kernel", "kernel", "kernel", "gpu_memcpy",
        "gpu_memset"])]
    _write(str(tmp_path / f"{2:020d}{pprof.TRACE_SUFFIX}"),
           {"traceEvents": events})
    rows = pprof.top_ops(str(tmp_path))
    names = {r["name"]: r for r in rows}
    kernel = "void sd_self_attn_kernel<40, 2>(Maps, int, int, float)"
    assert set(names) == {kernel, "ampere_bf16_s16816gemm", "Memcpy HtoD",
                          "copy.7"}
    assert names[kernel]["count"] == 2 and names[kernel]["total_us"] == 350.0
    total = 350.0 + 42.0 + 3.0
    assert names[kernel]["pct"] == round(100.0 * 350.0 / total, 2)
    assert [r["name"] for r in rows][:2] == [kernel, "ampere_bf16_s16816gemm"]
    # without the filter every complete event counts
    assert len(pprof.top_ops(str(tmp_path), device_only=False)) == 8


def test_newest_trace_is_read(tmp_path):
    _write(str(tmp_path / f"{5:020d}{pprof.TRACE_SUFFIX}"),
           {"traceEvents": EVENTS[:1]})
    _write(str(tmp_path / "sub" / f"{7:020d}{pprof.TRACE_SUFFIX}"),
           {"traceEvents": EVENTS[3:5]})
    assert [e["name"] for e in pprof.load_events(str(tmp_path))] == [
        "fusion.123", "fusion.123"]


def test_load_events_on_an_empty_directory_raises_as_jax(tmp_path):
    for prof in (jprof, pprof):
        with pytest.raises(FileNotFoundError):
            prof.load_events(str(tmp_path))


def test_trace_and_profile_generate_on_the_cpu(tmp_path):
    """`trace` around CPU work writes a gzipped chrome trace with complete
    events; `profile_generate` over a tiny CPU pipeline returns a report
    with rows."""
    with pprof.trace(str(tmp_path / "t"), cuda=False):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = pprof.load_events(str(tmp_path / "t"))
    assert any("mm" in e["name"] for e in events)

    pipe = StableDiffusionPipeline(tiny_config(), device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    cond = torch.randint(0, 1000, (1, 16),
                         generator=torch.Generator().manual_seed(1))
    report = pprof.profile_generate(pipe, cond, torch.zeros_like(cond),
                                    str(tmp_path / "g"), num_steps=2,
                                    seed=3)
    lines = report.splitlines()
    assert lines[0].split()[:2] == ["op", "total_ms"]
    assert len(lines) > 3
    rows = pprof.top_ops(str(tmp_path / "g"))
    assert rows and all(r["total_us"] >= 0 for r in rows)
    assert abs(sum(r["pct"] for r in rows) - 100.0) < 0.1 * len(rows)
    assert not any(r["name"].startswith("$") or r["name"].endswith(".py")
                   for r in rows)
    names = os.listdir(tmp_path / "g")
    assert len(names) == 1 and names[0].endswith(pprof.TRACE_SUFFIX)
