"""Open loop of independent clients into the port's `ServingEngine`.

Arrivals are Poisson at `rate_per_s` over the window. So that every seed
offers the same work, the inter-arrival gaps are the same set in every run,
the exponential distribution's quantiles at (j + 0.5) / n for the n = round(
rate x seconds) requests, in an order drawn from the seed; they are scaled
to end the last arrival half a gap before the window does. Each request is
timed from when it was due to its result; after the window, requests in
flight are waited for up to `drain_s`, and any unfinished count as failed.
Mix parameters: `rate_per_s`, `batch`, `max_wait_ms`, `steps`, `guidance`,
`queue_size`, `drain_s`. A traced run's profiler starts at the first
arrival past the window's half (`harness/trace.py`).
"""
from __future__ import annotations

import math
import threading
import time

import numpy as np

from bench_h100.harness.inputs import stream
from bench_h100.harness.outcome import Outcome, Request

_ARRIVALS = 4


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s after the window opens) of the window's arrivals."""
    n = max(int(round(rate * seconds)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = stream(seed, _ARRIVALS).permutation(gaps)
    due = np.cumsum(gaps)
    return due * (seconds - 0.5 * seconds / n) / due[-1]


class Session:
    def __init__(self, program, mix: dict, inputs, device):
        self.mix, self.inputs = mix, inputs
        self.engine = program.engine(
            inputs.tokenize, batch_size=mix["batch"], num_steps=mix["steps"],
            guidance_scale=mix["guidance"], max_wait_ms=mix["max_wait_ms"],
            queue_size=mix["queue_size"])
        self.engine.start()

    def warm_up(self) -> None:
        # one batch at the engine's one shape (padded), request index -1
        self.engine.submit(self.inputs.prompt(-1),
                           seed=self.inputs.request_seed(-1)).result()

    def _counters(self) -> dict:
        s = self.engine.stats
        return {"requests": s.requests, "batches": s.batches,
                "padded_slots": s.padded_slots,
                "batch_seconds": s.total_batch_seconds}

    def measure(self, seconds: float, tracer) -> Outcome:
        due = schedule(self.mix["rate_per_s"], seconds, self.inputs.seed)
        requests = [Request(i, self.inputs.request_seed(i), 0.0)
                    for i in range(len(due))]
        prompts = [self.inputs.prompt(i) for i in range(len(due))]
        left = threading.Semaphore(0)
        futures, late, split, mid = [], 0.0, None, None
        before = self._counters()

        def poll():
            nonlocal split, mid
            if tracer.due():
                split, mid = time.perf_counter(), self._counters()
                tracer.begin()

        def finish(req):
            def cb(fut):
                req.done = time.perf_counter()
                if fut.exception() is not None:
                    req.error = repr(fut.exception())
                else:
                    req.output = fut.result()
                left.release()
            return cb

        tracer.open()
        t0 = time.perf_counter()
        for req, prompt, d in zip(requests, prompts, due):
            req.due = t0 + float(d)
            wait = req.due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            poll()
            late = max(late, time.perf_counter() - req.due)
            fut = self.engine.submit(prompt, seed=req.seed)
            futures.append(fut)
            fut.add_done_callback(finish(req))
        poll()
        rest = t0 + seconds - time.perf_counter()
        if rest > 0:
            time.sleep(rest)
        t1 = time.perf_counter()
        tracer.close()
        deadline = t1 + self.mix["drain_s"]
        for _ in futures:
            if not left.acquire(timeout=max(deadline - time.perf_counter(), 0)):
                break
        after = self._counters()
        half = len(requests) // 2
        lat = [r.done - r.due if r.done is not None else math.nan
               for r in requests]
        serving = {k: after[k] - before[k] for k in after}
        untraced = (None if mid is None
                    else {k: mid[k] - before[k] for k in mid})
        return Outcome(t0, t1, requests,
                       [r for r in requests if r.done is not None
                        and r.done <= t1],
                       self.mix["steps"], self.mix["guidance"], serving,
                       t_split=split, serving_untraced=untraced,
                       notes={"max_submit_late_s": late,
                              "mean_latency_first_half_s": float(np.mean(lat[:half])),
                              "mean_latency_second_half_s": float(np.mean(lat[half:])),
                              "drain_end": time.perf_counter(),
                              "rate_per_s": self.mix["rate_per_s"],
                              "arrivals": len(due)})

    def close(self) -> None:
        self.engine.stop(drain=False)

    def sample(self, outcome: Outcome, n: int, rng) -> list:
        done = [r for r in outcome.requests
                if r.done is not None and r.error is None]
        pick = rng.permutation(len(done))[:n]
        return [done[int(j)] for j in sorted(pick)]


def latency_percentile(outcome: Outcome, q: float) -> float:
    """The q-th percentile (0-100) of every due request's latency, from due
    time to result; a request without a result counts as waiting until the
    drain ended, a lower bound of its latency."""
    end = outcome.notes["drain_end"]
    lat = sorted((r.done if r.done is not None and not r.error else end)
                 - r.due for r in outcome.requests)
    return float(np.percentile(lat, q, method="higher")) if lat else math.nan
