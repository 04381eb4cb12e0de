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

Spans. The port times its own layers with one recorder and two sinks:

    with span("dmoe.pipe.decode", device=pipe.device) as s:
        ...                                  # the work
    s.seconds, s.device_seconds()            # host and device seconds

Every span goes into a ring of the last `SPANS_KEPT` spans (`spans()` reads
it), always: it costs a few microseconds a span and has no switch. While
`torch.profiler` runs, a span is also a profiler range of the same name, on
the trace's own clock; `to_trace_ns` maps a span's stamps there. A range is
a RecordFunction, as `record_function` makes, entered through the
profiler's fast entry (`_RecordFunctionFast`: 1.8 against 15 µs a range on
a CPU host, under the profiler), and shows in the trace as a host op.
`annotate(name)` is such a range alone, entered only while the profiler runs.
A span with a CUDA `device` also records two CUDA events on the device's
current stream, read (and waited for) only by `device_seconds()`.
`begin(name)` / `Span.end()` make a span that ends on another thread. The
names the port records:

- `dmoe.serve.request` (ring): one request, from `ServingEngine.submit` to
  its result; attrs `request`, and `batch` once its batch starts.
- `dmoe.serve.wait` (range): the executor thread gathering a batch.
- `dmoe.serve.batch` (ring and range): one batch, from its start to its
  images on the host; attrs `batch`, `requests`, `real`.
- `dmoe.pipe.generate`, `.encode` (the text encodes), `.denoise` (attr
  `unet_calls`), `.decode` (ring and range, with device events).
- `dmoe.pipe.step` (range): one step of `denoise`'s loop.
- `dmoe.unet`, `dmoe.unet.attn1`, `dmoe.unet.ff` (ranges): a UNet call, and
  the self-attention and FF module calls of its transformer blocks.
- `dmoe.kernel.<launcher>` (range): the host call of a hand-written kernel's
  launcher, e.g. `dmoe.kernel.ff_front`.
"""
from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Optional

import torch
from torch._C import _profiler as _c_profiler
from torch.autograd import profiler as _autograd_profiler

TRACE_SUFFIX = ".pt.trace.json.gz"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# the spans kept in memory: a benchmark window records about a thousand
SPANS_KEPT = 65536
_RING: collections.deque = collections.deque()
_ids = itertools.count(1)
_open = threading.local()           # .stack: the spans open on this thread
_NULL = contextlib.nullcontext()
# perf_counter_ns -> the Unix-epoch ns of the profiler's host events
_TRACE_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


def to_trace_ns(perf_ns: int) -> int:
    """A span's stamp (`time.perf_counter_ns()`) on the profiler's clock
    (Unix-epoch ns, `time.time_ns()`'s), by one offset taken at import."""
    return perf_ns + _TRACE_OFFSET_NS


def annotate(name: str):
    """A profiler range while the profiler runs, else a shared null
    context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _c_profiler._RecordFunctionFast(name)


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class Span:
    """One timed interval: `name`, `id`, `parent` (the id of the innermost
    span open on the same thread when it began, or None), `thread`,
    `start_ns` and `end_ns` (`time.perf_counter_ns()`), `attrs`. A context
    manager (see `span`); `begin` starts one outside any `with`."""
    __slots__ = ("name", "id", "parent", "thread", "start_ns", "end_ns",
                 "attrs", "_device", "_events", "_range")

    def __init__(self, name: str, device=None, attrs: Optional[dict] = None):
        self.name, self.attrs = name, attrs if attrs is not None else {}
        self.id, self.parent = next(_ids), None
        self.thread = threading.get_ident()
        self.start_ns = self.end_ns = None
        self._device = None if device is None else torch.device(device)
        self._events = self._range = None

    def _start(self) -> "Span":
        if self._device is not None and self._device.type == "cuda":
            stream = torch.cuda.current_stream(self._device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def end(self) -> None:
        """Stamps the end and puts the span into the ring."""
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
        self.end_ns = time.perf_counter_ns()
        _RING.append(self)
        if len(_RING) > SPANS_KEPT:
            _RING.popleft()

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        # stamped before the range opens: a profiling session's first range
        # on a thread spends a millisecond setting up after its own stamp
        self._start()
        if _autograd_profiler._is_profiler_enabled:
            self._range = _c_profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.end()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _stack().pop()

    @property
    def seconds(self) -> Optional[float]:
        """Host seconds from start to end (None while open)."""
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) / 1e9

    def device_seconds(self) -> Optional[float]:
        """Device seconds between the span's two CUDA events, waiting for
        the second; None without a CUDA device or while open."""
        if self._events is None or self.end_ns is None:
            return None
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1]) / 1e3


def span(name: str, *, device=None, **attrs) -> Span:
    """`with span(name, device=..., **attrs) as s:` times the block into
    the ring, and as a profiler range while the profiler runs. `device`: a
    CUDA device also times the block on the device's current stream
    (`s.device_seconds()`); a CPU device or None does not."""
    return Span(name, device, attrs)


def begin(name: str, **attrs) -> Span:
    """A span that starts now and enters the ring at its `end()`, which
    any thread may call; it has no parent and no profiler range."""
    return Span(name, None, attrs)._start()


def spans(name: Optional[str] = None) -> list:
    """The ring's spans in the order they ended, those named `name` alone
    where given."""
    ring = list(_RING)
    return ring if name is None else [s for s in ring if s.name == name]


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
