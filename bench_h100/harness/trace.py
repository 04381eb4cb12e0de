"""The traced run: `torch.profiler` over the second part of the measured
window, ranges around the layers that per-layer metrics read, and the
reduction of the trace.

Forward hooks on the modules of the program's `denoiser` (a UNet, a DiT)
whose names end in `.ff` and `.attn1` open a `record_function` range
around each call and note its input's shape. A kernel belongs to a range
when the host call that launched it (the CUDA runtime or driver API call of
the same correlation id) lies inside the range; one thread launches all the
work in every cell, so the time of the launch decides. Device intervals are
kernels, copies and sets.
"""
from __future__ import annotations

import bisect
import collections
import heapq
import threading
import time

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_ACTIVITIES = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
RANGES = {".ff": "bench.ff", ".attn1": "bench.attn1"}
TOP = 10
NAME = 160          # characters of a kernel's name kept in the breakdown


class Tracer:
    """The traced run's window is split: its first `untraced_s` seconds run
    as an untraced run does (the host clock and the engine's counters are
    read there), then the profiler starts at the traffic's next safe point
    (`due`, `begin`) and traces the rest. The hooks are installed before the
    window and open ranges only while the profiler runs."""

    def __init__(self, denoiser: torch.nn.Module, untraced_s: float,
                 device_type: str = "cuda"):
        self.denoiser, self.device_type = denoiser, device_type
        self.untraced_s = untraced_s
        self.calls = collections.defaultdict(list)   # range -> input shapes
        self._hooks, self._open = [], threading.local()
        self.prof = None
        self.active = False
        self._window = None
        self._t0 = None

    # -- hooks
    def install(self) -> None:
        for name, module in self.denoiser.named_modules():
            for suffix, rng in RANGES.items():
                if name.endswith(suffix):
                    self._hooks.append(module.register_forward_pre_hook(
                        self._enter(rng)))
                    self._hooks.append(module.register_forward_hook(
                        self._exit))

    def _enter(self, rng: str):
        def hook(module, args):
            rf = None
            if self.active:
                self.calls[rng].append(tuple(args[0].shape))
                rf = torch.autograd.profiler.record_function(rng)
                rf.__enter__()
            stack = getattr(self._open, "stack", None)
            if stack is None:
                stack = self._open.stack = []
            stack.append(rf)
        return hook

    def _exit(self, module, args, output):
        rf = self._open.stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)

    def remove(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []

    # -- the window, as the traffic drives it
    def open(self) -> None:
        self._t0 = time.perf_counter()

    def due(self) -> bool:
        """Whether the profiler should start now."""
        return (self.prof is None
                and time.perf_counter() - self._t0 >= self.untraced_s)

    def begin(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.active = True
        self._window = torch.autograd.profiler.record_function(WINDOW)
        self._window.__enter__()

    @property
    def began(self) -> bool:
        return self.prof is not None

    def close(self) -> None:
        if self._window is None:
            raise RuntimeError("the window closed before its traced part")
        self._window.__exit__(None, None, None)

    def stop(self) -> None:
        if self.prof is not None:
            if self.device_type == "cuda":
                torch.cuda.synchronize()
            self.active = False
            self.prof.stop()
        self.remove()

    def read(self) -> dict:
        return reduce(self.prof.profiler.kineto_results.events(), self.calls)


def activity(e) -> str:
    """A kineto event's activity, told from its device, its annotation
    flag and its name."""
    name = e.name()
    on_device = str(e.device_type()).endswith("CUDA")
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    if on_device:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    if name.startswith(("cuda", "cu")):
        return "cuda_runtime"
    return "cpu_op"


def _union(intervals) -> float:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce(events, calls) -> dict:
    """The trace's numbers: `window_s`, `busy_s` (union of device
    intervals inside the window), `range_device_s` (device time of the
    kernels each range launched, over the whole trace), `calls`, and the
    breakdown's `device_ops` and `idle_gaps`."""
    window, device, launches = None, [], {}
    ranges = collections.defaultdict(list)
    cpu = collections.defaultdict(list)          # thread -> (start, end, name)
    for e in events:
        kind = activity(e)
        if kind in DEVICE_ACTIVITIES:
            device.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
        elif kind in LAUNCH_ACTIVITIES:
            launches[e.correlation_id()] = e.start_ns()
        elif kind in ("cpu_op", "user_annotation"):
            name = e.name()
            if name == WINDOW:
                window = (e.start_ns(), e.end_ns())
                continue
            if name.startswith("bench."):
                ranges[name].append((e.start_ns(), e.end_ns()))
            cpu[e.start_thread_id()].append((e.start_ns(), e.end_ns(), name))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = window
    inside = [(max(s, w0), min(e, w1)) for s, e, _, _ in device
              if e > w0 and s < w1]
    busy = _union(inside)
    by_range = {}
    for name, spans in ranges.items():
        spans.sort()
        starts = [s for s, _ in spans]
        t = 0
        for s, e, _, corr in device:
            at = launches.get(corr)
            if at is None:
                continue
            j = bisect.bisect_right(starts, at) - 1
            if j >= 0 and at <= spans[j][1]:
                t += e - s
        by_range[name] = t / 1e9
    per_name = collections.Counter()
    for s, e, name, _ in device:
        if e > w0 and s < w1:
            per_name[name[:NAME]] += (min(e, w1) - max(s, w0)) / 1e9
    host = max(cpu, key=lambda th: sum(n == "bench.ff" for _, _, n in cpu[th]),
               default=None)
    gaps = _gaps(inside, w0, w1)
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
            "range_device_s": by_range,
            "calls": {k: list(v) for k, v in calls.items()},
            "device_ops": [[n, s] for n, s in per_name.most_common(TOP)],
            "idle_gaps": _label_gaps(gaps, cpu.get(host, []))}


def _gaps(intervals, w0, w1) -> list:
    """Idle (start, end) stretches of the window between device work."""
    out, at = [], w0
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < w1:
        out.append((at, w1))
    return out


def _label_gaps(gaps, ops) -> list:
    """Idle seconds by the innermost host op open at each gap's midpoint on
    the pipeline's thread, the ten largest."""
    ops = sorted(ops)
    mids = sorted(((s + e) / 2, e - s) for s, e in gaps)
    by_label = collections.Counter()
    open_ops: list = []                     # heap of (-start, end, name)
    j = 0
    for mid, length in mids:
        while j < len(ops) and ops[j][0] <= mid:
            heapq.heappush(open_ops, (-ops[j][0], ops[j][1], ops[j][2]))
            j += 1
        # the innermost open op: the latest start whose end is still ahead
        # (an op that ended before this midpoint ended before every later
        # one: it leaves the heap for good)
        label = "(no host op)"
        while open_ops:
            top = heapq.heappop(open_ops)
            if top[1] >= mid:
                label = top[2]
                heapq.heappush(open_ops, top)
                break
        by_label[label] += length / 1e9
    return [[n, s] for n, s in by_label.most_common(TOP)]
