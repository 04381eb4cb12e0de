"""The torch port's serving engine and per-request seeds, on the CPU.

The engine's contract (the JAX package's `serving.py`): a request's result
depends on its prompt, its seed and the engine's settings, never on what
shares its micro-batch and never on padding. Checked at `tiny_config` with 2
PNDM steps; the lifecycle cases run on a stand-in pipeline.
"""
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                            build_moe_interventions,
                                            tiny_config)
from diffusion_models_moe_tpu_torch.data.tokenize import (
    hash_tokenize, per_prompt_hash_tokenize)
from diffusion_models_moe_tpu_torch.pipelines.stable_diffusion import to_uint8
from diffusion_models_moe_tpu_torch.serving import (ServingEngine,
                                                    ServingStats, _Request)
from torch_parity import labels
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

STEPS = 2
WAIT = 120          # seconds a test waits for a future before it fails


@pytest.fixture(scope="module")
def served():
    """A tiny pipeline with both exact-tier modes on and MoE routing on all
    FFs, and its per-prompt tokenizer."""
    cfg = tiny_config(attn_absorb="1", conv_chain=True)
    pipe = StableDiffusionPipeline(cfg, device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    tok = per_prompt_hash_tokenize(cfg.text_encoder.vocab_size,
                                   cfg.text_encoder.max_length)
    ivs = build_moe_interventions(labels(cfg.unet), 0.3, device="cpu")
    return pipe, tok, ivs


def _engine(served, **kw):
    pipe, tok, ivs = served
    kw.setdefault("batch_size", 2)
    kw.setdefault("max_wait_ms", 300.0)
    return ServingEngine(pipe, tok, num_steps=STEPS, ivs=ivs, **kw)


def test_per_prompt_tokenizer_ignores_the_batch():
    tok = per_prompt_hash_tokenize(1000, 8)
    one = hash_tokenize(1000, 8)
    ids = tok(["a", "b", "a"])
    assert ids.shape == (3, 8) and ids.dtype == torch.int64
    torch.testing.assert_close(ids[0], ids[2], rtol=0, atol=0)
    torch.testing.assert_close(ids[1:2], one(["b"]), rtol=0, atol=0)
    assert not torch.equal(ids[0], ids[1])


def test_seeds_make_a_request_independent_of_its_batch(served):
    """`generate(seeds=...)`: sample 0 (same prompt, same seed) is bit-equal
    whatever seed and prompt share its batch; other seeds differ; the noise
    of a request is that of its own generator."""
    pipe, tok, ivs = served
    un = tok(["", ""])
    kw = dict(num_steps=STEPS, decode=False, ivs=ivs)
    lat1, taps = pipe.generate(tok(["a", "b"]), un, seeds=[7, 3], **kw)
    lat2, _ = pipe.generate(tok(["a", "c"]), un, seeds=[7, 1000], **kw)
    assert taps is None
    torch.testing.assert_close(lat1[0], lat2[0], rtol=0, atol=0)
    assert (lat1[1] - lat2[1]).abs().max() > 1e-3
    noise = pipe.seeded_noise([7, 3])
    own = pipe.initial_noise(1, torch.Generator().manual_seed(3))
    torch.testing.assert_close(noise[1:], own, rtol=0, atol=0)


def test_generate_takes_a_generator_or_seeds(served):
    pipe, tok, _ = served
    ids = tok(["a"])
    with pytest.raises(ValueError, match="generator or seeds"):
        pipe.generate(ids, ids)
    with pytest.raises(ValueError, match="generator or seeds"):
        pipe.generate(ids, ids, torch.Generator().manual_seed(0), seeds=[1])
    with pytest.raises(ValueError, match="2 seeds for 1"):
        pipe.generate(ids, ids, seeds=[1, 2])


def test_engine_serves_uint8_images_and_counts_padding(served):
    """3 requests through a batch of 2: one full batch, one padded with its
    last request; images (H, W, 3) uint8; the stats count the padding."""
    eng = _engine(served)
    with eng:
        futs = [eng.submit(f"prompt {i}", seed=i) for i in range(3)]
        imgs = [f.result(timeout=WAIT) for f in futs]
    side = 8 * served[0].config.sample_size
    for im in imgs:
        assert isinstance(im, np.ndarray) and im.dtype == np.uint8
        assert im.shape == (side, side, 3)
    st = eng.stats
    assert (st.requests, st.batches, st.padded_slots) == (3, 2, 1)
    assert st.mean_fill == pytest.approx(0.75)
    assert st.total_batch_seconds > 0 and st.images_per_second > 0
    assert ServingStats().mean_fill == 0.0
    assert ServingStats().images_per_second == 0.0


def test_result_is_independent_of_cobatching(served):
    """A request served alone (its batch padded with itself) and the same
    request co-batched with another give bit-equal latents: the UNet batch
    has one shape either way and no op mixes batch rows."""
    with _engine(served, decode=False) as eng:
        solo = eng.submit("the probe prompt", seed=42).result(timeout=WAIT)
    with _engine(served, decode=False, max_wait_ms=2000.0) as eng2:
        futs = [eng2.submit("the probe prompt", seed=42),
                eng2.submit("another prompt", seed=1)]
        crowded, other = (f.result(timeout=WAIT) for f in futs)
    assert eng2.stats.batches == 1 and eng2.stats.padded_slots == 0
    assert solo.shape == (4, 8, 8) and solo.dtype == np.float32
    np.testing.assert_array_equal(solo, crowded)
    assert np.abs(other - crowded).max() > 1e-3


def test_engine_result_is_generate_with_seeds(served):
    """The engine adds nothing to `generate(seeds=...)` but batching: one
    request's image equals the pipeline's own, converted by `to_uint8`."""
    pipe, tok, ivs = served
    with _engine(served, batch_size=1) as eng:
        (img,) = eng.generate_sync(["a prompt"], seeds=[5])
    ref, _ = pipe.generate(tok(["a prompt"]), tok([""]), seeds=[5],
                           num_steps=STEPS, ivs=ivs)
    np.testing.assert_array_equal(img, to_uint8(ref)[0].numpy())


def test_stop_drains_the_queue(served):
    eng = _engine(served, decode=False).start()
    futs = [eng.submit(f"p{i}", seed=i) for i in range(3)]
    eng.stop(drain=True)
    assert all(f.done() and f.exception() is None for f in futs)
    assert eng.stats.requests == 3
    with pytest.raises(RuntimeError, match="not started"):
        eng.submit("late")
    eng.stop()                                   # a second stop is a no-op


def test_engine_starts_once(served):
    eng = _engine(served).start()
    try:
        with pytest.raises(RuntimeError, match="already started"):
            eng.start()
    finally:
        eng.stop()


class _StubPipe:
    """Stands in for the pipeline: `generate` fails on its first call and
    returns the seeds as (B, 1, 1, 1) latents afterwards."""

    def __init__(self, fail_first: bool = True, delay: float = 0.0):
        self.calls = 0
        self.fail_first = fail_first
        self.delay = delay

    def generate(self, cond, uncond, *, seeds, **kw):
        self.calls += 1
        time.sleep(self.delay)
        if self.fail_first and self.calls == 1:
            raise RuntimeError("first batch fails")
        return torch.tensor(seeds, dtype=torch.float32).view(-1, 1, 1, 1), None


def _stub_engine(pipe, **kw):
    return ServingEngine(pipe, per_prompt_hash_tokenize(100, 4), num_steps=1,
                         decode=False, **kw)


def test_failing_batch_reaches_every_future_and_the_engine_lives():
    eng = _stub_engine(_StubPipe(), batch_size=2, max_wait_ms=2000.0)
    with eng:
        bad = [eng.submit("x", seed=1), eng.submit("y", seed=2)]
        for f in bad:
            assert isinstance(f.exception(timeout=WAIT), RuntimeError)
        ok = eng.submit("z", seed=3)
        assert ok.result(timeout=WAIT).item() == 3.0     # the loop survived
    assert eng.stats.requests == 1               # only served requests count


def test_fail_batch_skips_cancelled_and_resolved_futures():
    """A cancelled future inside a failing batch must not raise
    InvalidStateError out of the handler; unresolved futures get the error."""
    cancelled, pending, resolved = Future(), Future(), Future()
    assert cancelled.cancel()
    resolved.set_running_or_notify_cancel()
    resolved.set_result("already done")
    err = RuntimeError("batch exploded")
    ServingEngine._fail_batch([_Request("a", 0, cancelled),
                               _Request("b", 1, pending),
                               _Request("c", 2, resolved)], err)
    assert pending.exception() is err
    assert cancelled.cancelled()
    assert resolved.result() == "already done"


def test_cancelled_future_does_not_poison_its_batch():
    """A client cancels a queued request: the batch it lands in still
    resolves its other request, padded slots and all."""
    eng = _stub_engine(_StubPipe(fail_first=False, delay=0.3), batch_size=2,
                       max_wait_ms=2000.0)
    with eng:
        first = [eng.submit("a", seed=1), eng.submit("b", seed=2)]
        # queued behind the running batch, so still pending and cancellable
        doomed, kept = eng.submit("c", seed=3), eng.submit("d", seed=4)
        assert doomed.cancel()
        assert kept.result(timeout=WAIT).item() == 4.0
        assert [f.result(timeout=WAIT).item() for f in first] == [1.0, 2.0]
    assert doomed.cancelled()


def test_stop_sweep_tolerates_a_cancelled_future():
    """stop()'s sweep of requests that raced in needs the same cancel guard:
    a cancelled queued future must not raise out of stop(), and the next one
    still gets the 'engine stopped' error."""
    eng = _stub_engine(_StubPipe(fail_first=False))
    done = threading.Thread(target=lambda: None)
    done.start()
    done.join(timeout=10)
    assert not done.is_alive()
    eng._thread = done                 # a started engine whose loop has ended
    cancelled, pending = Future(), Future()
    assert cancelled.cancel()
    eng._queue.put(_Request("a", 0, cancelled))
    eng._queue.put(_Request("b", 1, pending))
    eng.stop(drain=False)
    assert cancelled.cancelled()
    assert isinstance(pending.exception(timeout=1), RuntimeError)
    assert eng._thread is None


def test_submit_blocks_when_the_queue_is_full():
    """Backpressure: with `queue_size` requests waiting, `submit` blocks and
    a timeout raises `queue.Full`."""
    eng = _stub_engine(_StubPipe(fail_first=False, delay=0.5), batch_size=1,
                       max_wait_ms=1.0, queue_size=1)
    with eng:
        first = eng.submit("a", seed=1)
        deadline = time.monotonic() + WAIT
        while eng._queue.qsize() and time.monotonic() < deadline:
            time.sleep(0.01)                     # the loop took the first
        second = eng.submit("b", seed=2)         # fills the queue
        with pytest.raises(queue.Full):
            eng.submit("c", seed=3, timeout=0.05)
        assert first.result(timeout=WAIT).item() == 1.0
        assert second.result(timeout=WAIT).item() == 2.0
