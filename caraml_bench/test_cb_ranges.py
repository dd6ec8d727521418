"""The readers of the program's ranges (``cbench.ranges``) on a trace
built by hand: two threads, ``forward`` holding a ``batchnorm`` on the
caller's, ``backward`` holding one on autograd's, ``optimizer``,
kernels, a copy, and gaps inside and outside the ranges. Each reader
gives the hand-counted milliseconds; the charged idle time and the rest
add up to the window's idle share; without device operations, or
without the ranges, every reader gives None."""
import types

import pytest

from cbench import ranges, spec
from cbench.trace import Trace

MS = 1e-3
CALLER, AUTOGRAD = 1, 2
NEW = ("forward_ms", "backward_ms", "batchnorm_ms", "forward_idle_ms",
       "backward_idle_ms", "optimizer_idle_ms")

#: (name, cat, start, end, launch time, launching thread), in ms
OPS = [
    ("conv", "kernel", 1.5, 3.0, 1.0, CALLER),        # forward
    ("bn_fw", "kernel", 4.0, 6.0, 3.0, CALLER),       # forward > batchnorm
    ("Memcpy HtoD", "gpu_memcpy", 7.0, 8.0, 6.5, CALLER),   # forward
    ("dgrad", "kernel", 12.5, 14.0, 12.0, AUTOGRAD),  # backward
    ("bn_bw", "kernel", 15.0, 19.0, 15.0, AUTOGRAD),  # backward > batchnorm
    ("cast", "kernel", 29.0, 30.0, 29.0, CALLER),     # outside every range
    ("adam", "kernel", 31.0, 33.0, 31.0, CALLER),     # optimizer
    ("adam2", "kernel", 32.5, 34.0, 32.0, CALLER),    # optimizer, overlaps
    ("late", "kernel", 37.0, 38.0, 36.0, AUTOGRAD),   # no range on its thread
]
RANGES = {"forward": [(0.0, 10.0, CALLER)],
          "batchnorm": [(2.0, 5.0, CALLER), (14.0, 20.0, AUTOGRAD)],
          "backward": [(11.0, 28.0, AUTOGRAD)],
          "optimizer": [(30.0, 40.0, CALLER)]}
STEPS, WINDOW = 2, 40.0
#: per step: kernels (the copy is no kernel), then idle time; the gap
#: before ``conv`` (1.5) and after ``bn_fw`` (1.0) and ``Memcpy`` (the
#: gap 6-7 ends at it: 1.0) are forward's, 8-12.5 and 14-15 backward's,
#: 30-31 the optimizer's; 19-29 (a cast), 34-37 (another thread) and
#: the tail 38-40 no range's
WANT = {"forward_ms": 3.5 / STEPS, "backward_ms": 5.5 / STEPS,
        "batchnorm_ms": 6.0 / STEPS, "forward_idle_ms": 3.5 / STEPS,
        "backward_idle_ms": 5.5 / STEPS, "optimizer_idle_ms": 1.0 / STEPS}
REST = 15.0


def _trace(ops=OPS, names=RANGES) -> Trace:
    device = [(n, c, t0 * MS, t1 * MS, i) for i, (n, c, t0, t1, _l, _t)
              in enumerate(ops)]
    launches = {i: (t * MS, tid) for i, (*_x, t, tid) in enumerate(ops)}
    return Trace(steps=STEPS, window_s=WINDOW * MS, device=device,
                 launches=launches, host={},
                 ranges={k: [(a * MS, b * MS, tid) for a, b, tid in v]
                         for k, v in names.items()},
                 start=0.0)


def _ctx(trace):
    return types.SimpleNamespace(trace=trace)


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_the_hand_counted_ms(name):
    got = spec.metric_module(name).read(_ctx(_trace()))
    assert got == pytest.approx(WANT[name], rel=1e-9)


def test_charged_idle_and_the_rest_make_the_window_idle():
    t = _trace()
    charged, rest = ranges.charged_idle_s(t)
    assert rest == pytest.approx(REST * MS, rel=1e-9)
    idle = 1.0 - t.busy_s() / t.window_s
    assert (sum(charged.values()) + rest) / t.window_s == pytest.approx(
        idle, rel=1e-9)
    assert t.busy_s() == pytest.approx(15.0 * MS, rel=1e-9)


def test_the_innermost_range_takes_the_gap():
    ops = [("a", "kernel", 1.0, 2.0, 0.5, CALLER),
           ("b", "kernel", 4.0, 5.0, 3.0, CALLER),
           ("c", "kernel", 8.0, 9.0, 7.0, CALLER)]
    names = {"forward": [(0.0, 10.0, CALLER)],
             "optimizer": [(2.5, 6.0, CALLER)]}
    charged, rest = ranges.charged_idle_s(_trace(ops, names))
    assert charged["optimizer"] == pytest.approx(2.0 * MS)
    assert charged["forward"] == pytest.approx(4.0 * MS)
    assert charged["backward"] == 0.0
    assert rest == pytest.approx(31.0 * MS)


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_none_without_device_ops_or_ranges(name):
    read = spec.metric_module(name).read
    assert read(_ctx(None)) is None
    assert read(_ctx(_trace(ops=[]))) is None
    # the program before its forward, backward and batchnorm ranges
    # (the optimizer's it had)
    old = _trace(names={"optimizer": RANGES["optimizer"]})
    got = read(_ctx(old))
    if name == "optimizer_idle_ms":
        assert got == pytest.approx(WANT[name], rel=1e-9)
    else:
        assert got is None
