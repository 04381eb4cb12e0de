"""Batched serving engine: a micro-batching front end over the pipeline.

Counterpart of `diffusion_models_moe_tpu/serving.py`. The design decisions
carry over:

- One fixed batch shape. Requests are micro-batched and padded to
  `batch_size` with the last request, so every UNet call of an engine has
  one shape: the same cuDNN and cuBLAS algorithms and the same kernel
  grids for a request whatever it shares its batch with.
- Per-request determinism. Each request carries its own seed and its
  initial noise comes from that seed alone (`pipe.generate(seeds=...)`), so
  the image a client gets does not depend on its batch mates.
- One executor thread: one stream of work on the card at a time;
  concurrency comes from batching, not from parallel submits.
- Backpressure. The request queue is bounded; `submit` blocks when the
  engine is `queue_size` requests behind.

Interventions (MoE routing, erasure masks) pass straight through to
`generate`, so a moefied or concept-erased model serves like a plain one.

With `mesh=` (a ("dp", "tp") mesh of `parallel/mesh.py`) every rank builds
the engine and starts it. Rank 0 owns the queue: clients submit there, and
before each batch it broadcasts the batch's token ids and seeds to the
group, then joins the collective `generate(mesh=)`; at `stop` it
broadcasts a stop message. Every other rank runs a follower loop that
receives each batch and joins the same `generate`, and ends on the stop
message; `submit` refuses on a follower.

Usage:
    eng = ServingEngine(pipe, tokenize, batch_size=8, num_steps=50)
    eng.start()
    fut = eng.submit("a photo of an astronaut", seed=7)
    image = fut.result()            # (H, W, 3) uint8 numpy
    eng.stop()
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import to_uint8

# the broadcast header of a follower loop: (command, batch, id length)
_RUN, _STOP = 1, 0


@dataclasses.dataclass
class _Request:
    prompt: str
    seed: int
    future: Future


@dataclasses.dataclass
class ServingStats:
    requests: int = 0
    batches: int = 0
    padded_slots: int = 0
    total_batch_seconds: float = 0.0

    @property
    def mean_fill(self) -> float:
        """Mean fraction of batch slots holding real requests."""
        total = self.requests + self.padded_slots
        return self.requests / total if total else 0.0

    @property
    def images_per_second(self) -> float:
        return (self.requests / self.total_batch_seconds
                if self.total_batch_seconds else 0.0)


class ServingEngine:
    """Micro-batching executor over `pipe.generate`: a
    `StableDiffusionPipeline` or an `SDXLPipeline` (whose bigG tower then
    takes the same ids). `tokenize` maps a list of prompts to (B, S) token
    ids (e.g. `data.tokenize.hash_tokenize`)."""

    def __init__(self, pipe, tokenize: Callable[[Sequence[str]], torch.Tensor],
                 *, batch_size: int = 8, num_steps: int = 50,
                 guidance_scale: float = 7.5, max_wait_ms: float = 50.0,
                 queue_size: int = 64, ivs=None, decode: bool = True,
                 mesh=None):
        self.pipe = pipe
        self.mesh = mesh
        self.leader = mesh is None or dist.get_rank() == 0
        self.tokenize = tokenize
        self.batch_size = batch_size
        self.num_steps = num_steps
        self.guidance_scale = guidance_scale
        self.max_wait_ms = max_wait_ms
        self.ivs = ivs
        self.decode = decode
        self.stats = ServingStats()
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lifecycle = threading.Lock()   # serializes submit vs stop
        self._error: Optional[BaseException] = None   # a follower's failure
        self._uncond = tokenize([""])

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ServingEngine":
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop if self.leader else self._follow,
            name="dmoe-serving", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the executor. With `drain`, finish queued requests first."""
        if self._thread is None:
            return
        if not self.leader:
            # the follower loop ends on the leader's stop message
            self._thread.join()
            self._thread = None
            if self._error is not None:
                raise self._error
            return
        if drain:
            self._queue.join()
        # the lock closes the submit/stop race: no submit can pass the
        # "engine not started" check and enqueue after the sweep below
        with self._lifecycle:
            self._stop.set()
            self._thread.join()
            self._thread = None
            if self.mesh is not None:
                self._broadcast(torch.tensor([_STOP, 0, 0]))
            # fail anything that raced in after the drain
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                # same cancel guard as _fail_batch: a client cancel() on a
                # still-queued future would make set_exception raise
                # InvalidStateError here, orphaning the rest of the sweep
                if (not req.future.done()
                        and req.future.set_running_or_notify_cancel()):
                    req.future.set_exception(RuntimeError("engine stopped"))
                self._queue.task_done()

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client API --------------------------------------------------------
    def submit(self, prompt: str, seed: int = 0,
               timeout: Optional[float] = None) -> Future:
        """Enqueue one request; blocks when `queue_size` requests behind."""
        if not self.leader:
            raise RuntimeError("requests are submitted on rank 0")
        with self._lifecycle:
            if self._thread is None:
                raise RuntimeError("engine not started")
            fut: Future = Future()
            self._queue.put(_Request(prompt, seed, fut), timeout=timeout)
        return fut

    def generate_sync(self, prompts: Sequence[str],
                      seeds: Optional[Sequence[int]] = None) -> list:
        """Convenience: submit a list and wait for all results."""
        seeds = seeds if seeds is not None else [0] * len(prompts)
        futs = [self.submit(p, s) for p, s in zip(prompts, seeds)]
        return [f.result() for f in futs]

    # -- executor ----------------------------------------------------------
    def _gather(self) -> list:
        """Block for one request, then batch up to batch_size within
        max_wait_ms."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_ms / 1000.0
        while len(batch) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._gather()
            if not batch:
                continue
            try:
                self._run_batch(batch)
            except Exception as e:              # surface, don't kill the loop
                self._fail_batch(batch, e)
            finally:
                for _ in batch:
                    self._queue.task_done()

    @staticmethod
    def _fail_batch(batch: list, e: Exception) -> None:
        """Propagate a batch failure to every unresolved future.

        done() filters futures _run_batch already resolved; the
        set_running_or_notify_cancel transition then closes the race where a
        client cancel() lands between the check and set_exception (the
        InvalidStateError would kill the executor thread)."""
        for req in batch:
            if (not req.future.done()
                    and req.future.set_running_or_notify_cancel()):
                req.future.set_exception(e)

    def _run_batch(self, batch: list) -> None:
        n_real = len(batch)
        b = self.batch_size
        prompts = [r.prompt for r in batch] + [batch[-1].prompt] * (b - n_real)
        seeds = [r.seed for r in batch] + [batch[-1].seed] * (b - n_real)
        cond = torch.as_tensor(self.tokenize(prompts))
        t0 = time.monotonic()
        if self.mesh is not None:
            self._broadcast(torch.tensor([_RUN, b, cond.shape[1]]))
            self._broadcast(torch.cat([cond.long(), torch.tensor(seeds)[:, None]],
                                      dim=1))
        out = self._generate(cond, seeds)
        # the copy to the host waits for the device: the batch time ends here
        out = (to_uint8(out) if self.decode else out).cpu().numpy()
        dt = time.monotonic() - t0
        self.stats.requests += n_real
        self.stats.batches += 1
        self.stats.padded_slots += b - n_real
        self.stats.total_batch_seconds += dt
        for i, req in enumerate(batch):
            # a client may have cancel()ed the pending future; set_result on a
            # cancelled future raises and would poison the rest of the batch
            if req.future.set_running_or_notify_cancel():
                req.future.set_result(out[i])

    def _generate(self, cond: torch.Tensor, seeds: list):
        b = cond.shape[0]
        out, _ = self.pipe.generate(
            cond, self._uncond.repeat(b, 1), num_steps=self.num_steps,
            guidance_scale=self.guidance_scale, ivs=self.ivs, seeds=seeds,
            decode=self.decode, **({} if self.mesh is None
                                   else {"mesh": self.mesh}))
        return out

    # -- the group ---------------------------------------------------------
    def _broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """`t` from rank 0 to every rank (int64, on the pipeline's device
        under NCCL, else on the host)."""
        dev = (self.pipe.device if dist.get_backend() == "nccl"
               else torch.device("cpu"))
        t = t.to(dev, torch.long).contiguous()
        dist.broadcast(t, src=0)
        return t.cpu()

    def _follow(self) -> None:
        """A follower's loop: each batch rank 0 broadcasts joins the
        collective `generate`; the stop message ends it."""
        try:
            while True:
                cmd, b, s = self._broadcast(torch.zeros(3, dtype=torch.long)
                                            ).tolist()
                if cmd == _STOP:
                    return
                msg = self._broadcast(torch.zeros((b, s + 1),
                                                  dtype=torch.long))
                self._generate(msg[:, :s], msg[:, s].tolist())
                self.stats.batches += 1
        except Exception as e:      # kept for stop() to raise
            self._error = e
