"""Closed loop of whole generates: one client calls the pipeline's
`generate` on `batch` requests, waits for the images on the host, and calls
again, until the window's seconds are up; the window ends when the last
generate begun in it returns. A traced run's profiler starts between two
generates, at the window's half (`harness/trace.py`). Request i has its own prompt and seed from
the run's seed. Mix parameters: `batch`, `steps`, `guidance`,
`warmup_steps` (the steps of the warm-up generate, which runs every shape
the window runs)."""
from __future__ import annotations

import time

import torch

from bench_h100.harness.outcome import Outcome, Request


class Session:
    def __init__(self, program, mix: dict, inputs, device):
        self.program, self.mix, self.inputs = program, mix, inputs
        self.device = torch.device(device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _generate(self, first: int, steps: int):
        b = self.mix["batch"]
        idx = range(first, first + b)
        cond, uncond = self.inputs.ids(idx)
        seeds = [self.inputs.request_seed(i) for i in idx]
        images = self.program.generate(cond, uncond, seeds, steps,
                                       self.mix["guidance"])
        return seeds, images.float().cpu()

    def warm_up(self) -> None:
        # requests of negative index: none of the window's
        self._generate(-self.mix["batch"], self.mix["warmup_steps"])
        self._sync()

    def measure(self, seconds: float, tracer) -> Outcome:
        b = self.mix["batch"]
        requests, first, split, traced_from = [], 0, None, None
        self._sync()
        tracer.open()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or not tracer.began:
            if tracer.due():
                # between generates: the untraced part ends here
                split = time.perf_counter()
                tracer.begin()
                traced_from = len(requests)
            start = time.perf_counter()
            seeds, images = self._generate(first, self.mix["steps"])
            done = time.perf_counter()
            requests += [Request(first + j, seeds[j], start, done, images[j])
                         for j in range(b)]
            first += b
        t1 = time.perf_counter()
        tracer.close()
        notes = {"generates": first // b}
        if split is not None:
            traced = requests[traced_from:]
            notes["img_per_s_untraced_part"] = traced_from / (split - t0)
            notes["img_per_s_traced_part"] = len(traced) / (t1 - traced[0].due)
        return Outcome(t0, t1, requests, list(requests), self.mix["steps"],
                       self.mix["guidance"], t_split=split, notes=notes)

    def close(self) -> None:
        pass

    def sample(self, outcome: Outcome, n: int, rng) -> list:
        """n requests, one from each of n equal runs of batch slots, each
        from a generate drawn from the seed: every part of the batch is
        compared."""
        b = self.mix["batch"]
        gens = len(outcome.requests) // b
        out, parts = [], min(n, b)
        for part in range(parts):
            lo, hi = part * b // parts, (part + 1) * b // parts
            g, slot = int(rng.integers(gens)), int(rng.integers(lo, hi))
            out.append(outcome.requests[g * b + slot])
        return out
