"""The traffic generators: the open loop's schedule is the seed's alone and
offers every seed the same work; the closed loop's sample covers every part
of the batch."""
import numpy as np

from bench_h100.harness import loader
from bench_h100.harness.inputs import Inputs, stream
from bench_h100.harness.outcome import Outcome, Request
from bench_h100.tests.tiny import TINY, TinyFamily

POISSON = loader.load_module(loader.BENCH / "traffic" / "open_poisson.py")
CLOSED = loader.load_module(loader.BENCH / "traffic" / "closed_batch.py")


def test_schedule_is_a_function_of_the_seed_alone():
    a = POISSON.schedule(3.2, 45, 2 ** 40 + 3)
    b = POISSON.schedule(3.2, 45, 2 ** 40 + 3)
    c = POISSON.schedule(3.2, 45, 2 ** 40 + 4)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert len(a) == len(c) == 144
    # the same set of gaps in another order
    assert np.allclose(np.sort(np.diff(a, prepend=0)),
                       np.sort(np.diff(c, prepend=0)))
    assert 0 < a[0] and a[-1] < 45 and np.all(np.diff(a) > 0)
    assert abs(np.mean(np.diff(a)) - 1 / 3.2) < 0.05


def test_request_inputs_are_a_function_of_the_seed_alone():
    x, y = (Inputs(TINY, 2 ** 33 + 1, TinyFamily),
            Inputs(TINY, 2 ** 33 + 1, TinyFamily))
    assert [x.request_seed(i) for i in range(300)] == [
        y.request_seed(i) for i in range(300)]
    assert x.request_seed(-1) != x.request_seed(0)
    cx, ux = x.ids([0, 5])
    cy, _ = y.ids([0, 5])
    assert (cx == cy).all() and not (cx[0] == cx[1]).all()
    assert (ux[0] == ux[1]).all()
    assert all((a == b).all() for a, b in zip(x.labels(), y.labels()))


def test_closed_sample_takes_one_request_from_each_part_of_the_batch():
    mix = {"batch": 8}
    session = CLOSED.Session.__new__(CLOSED.Session)
    session.mix = mix
    reqs = [Request(i, i, 0.0, 1.0) for i in range(40)]
    out = Outcome(0.0, 1.0, reqs, reqs, 50, 7.5)
    picked = session.sample(out, 4, stream(5, 6))
    assert sorted(r.index % 8 // 2 for r in picked) == [0, 1, 2, 3]
