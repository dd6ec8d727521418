"""Energy from a cumulative counter: the port's ``nvml_energy`` backend.

NVML's board power reading (``nvmlDeviceGetPowerUsage``) is a one-second
average on recent cards, so the port reads the card's energy counter
(``nvmlDeviceGetTotalEnergyConsumption``) by default. On the CPU, with a
fake counter:

  * the counter is interpolated linearly between the sample times at
    which its value changed, and windows that tile a run sum exactly to
    the counter's difference over it;
  * the serve engine attributes a counter's energy per window and labels
    its samples ``energy``; power and energy methods do not mix;
  * ``MeasuredScope`` reads a counter column as last minus first and
    raises when the counter failed to read;
  * ``NvmlEnergy`` converts mJ to J and raises on an NVML error;
  * ``--power auto`` (and ``nvml``) raise off the card.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.bench import cli
from repro_torch.configs import get_config
from repro_torch.core import metrics
from repro_torch.models import lm
from repro_torch.power.ctxmgr import MeasuredScope
from repro_torch.power.methods import (
    POWER_CHOICES, NvmlEnergy, PowerMethod, SyntheticPower,
    select_power_methods,
)
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.requests import poisson_requests
from repro_torch.serve.scheduler import StepRecord

torch.set_num_threads(1)


class FakeCounter(PowerMethod):
    """A cumulative counter (joules) of ``watts`` that advances only every
    ``period`` seconds of its clock, as the card's counter steps."""

    name = "fake_counter"
    kind = "energy"

    def __init__(self, clock, watts=300.0, period=0.1, fail=False):
        self.clock, self.watts, self.period = clock, watts, period
        self.fail = fail

    def devices(self):
        return ["fake:0"]

    def read(self):
        if self.fail:
            raise RuntimeError("counter read failed")
        t = self.clock()
        return {"fake:0": self.watts * self.period * (t // self.period)}


def test_counter_nodes_keep_first_changes_and_ends():
    ts = [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    js = [10.0, 10.0, 12.0, 12.0, 15.0, 15.0]
    assert metrics.counter_nodes(ts, js) == ([0.0, 2.0, 4.0, 5.0],
                                             [10.0, 12.0, 15.0, 15.0])
    assert metrics.counter_nodes([], []) == ([], [])


def test_counter_energy_interpolates_between_changes():
    ts = [0.0, 1.0, 2.0, 3.0, 4.0]
    js = [0.0, 0.0, 3600.0, 3600.0, 7200.0]       # 1 Wh steps at t=2, 4
    e = lambda t0, t1: metrics.counter_energy_wh(ts, js, t0, t1)
    assert e(0.0, 2.0) == pytest.approx(1.0)
    assert e(0.0, 1.0) == pytest.approx(0.5)      # halfway to the change
    assert e(2.5, 3.5) == pytest.approx(0.5)
    assert e(-1.0, 0.0) == 0.0                    # clamped before the run
    assert e(4.0, 9.0) == 0.0                     # and after it
    assert e(3.0, 3.0) == 0.0
    assert metrics.energy_wh(ts, js, 0.0, 4.0, "energy") == pytest.approx(2.0)
    with pytest.raises(ValueError, match="power or energy"):
        metrics.energy_wh(ts, js, 0.0, 4.0, "volts")


def test_counter_windows_sum_to_the_total():
    rng = np.random.default_rng(0)
    ts = np.cumsum(rng.uniform(0.001, 0.05, size=200)).tolist()
    steps = np.floor(np.array(ts) / 0.1)          # a counter stepping at 10 Hz
    js = (steps * 35.0 + 1e6).tolist()
    edges = sorted(rng.uniform(ts[0], ts[-1], size=30).tolist())
    edges = [ts[0]] + edges + [ts[-1]]
    parts = [metrics.counter_energy_wh(ts, js, a, b)
             for a, b in zip(edges, edges[1:])]
    assert all(p >= 0 for p in parts)
    assert sum(parts) == pytest.approx((js[-1] - js[0]) / 3600.0, rel=1e-12)


def test_attribute_energy_splits_counter_windows():
    ts = [0.0, 1.0, 2.0]
    js = [0.0, 3600.0, 7200.0]
    steps = [StepRecord("prefill", 0.0, 1.0, (1, 2), 2),
             StepRecord("decode", 1.0, 2.0, (1, 1, 2), 3)]
    got = metrics.attribute_energy(steps, ts, js, "energy")
    assert got[1] == pytest.approx(0.5 + 2 / 3)
    assert got[2] == pytest.approx(0.5 + 1 / 3)
    # the same samples read as watts would integrate to another figure
    assert metrics.attribute_energy(steps, ts, js)[1] != got[1]


@pytest.fixture(scope="module")
def tiny():
    c = get_config("llama3.2-3b").reduced(dtype="float32",
                                          param_dtype="float32")
    return c, lm.init(c, torch.Generator().manual_seed(0), "cpu")


def test_engine_attributes_counter_energy(tiny):
    c, p = tiny
    clock = FakeClock()
    counter = FakeCounter(clock, period=0.05)
    eng = ServeEngine(c, p, n_slots=2, max_len=32, cache="paged",
                      block_size=8, device="cpu", power_methods=[counter])
    eng.clock = clock
    reqs = poisson_requests(4, 1e6, c.vocab, prompt_len=6, seed=0,
                            short=(3, 5), long=(3, 5))
    out = eng.serve(reqs)
    assert out.sample_kind == "energy"
    ts, js = out.sample_ts, out.sample_ws
    assert js == sorted(js) and js[-1] > js[0]
    s = out.summary
    assert s.total_energy_wh == pytest.approx((js[-1] - js[0]) / 3600.0)
    windows = sum(metrics.counter_energy_wh(ts, js, st.t0, st.t1)
                  for st in out.steps)
    assert s.attributed_wh == pytest.approx(windows)
    assert 0 < s.attributed_wh <= s.total_energy_wh * (1 + 1e-12)
    assert all(r.energy_wh > 0 for r in out.results)


class FakeClock:
    """Advances 7 ms a reading, so windows have width and the counter
    steps inside the run."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.007
        return self.t


def test_engine_refuses_mixed_power_kinds_and_raises_on_a_failed_read(tiny):
    c, p = tiny
    clock = FakeClock()
    with pytest.raises(ValueError, match="mixed kinds"):
        ServeEngine(c, p, device="cpu", power_methods=[
            FakeCounter(clock), SyntheticPower()])
    eng = ServeEngine(c, p, n_slots=2, max_len=32, cache="paged",
                      block_size=8, device="cpu",
                      power_methods=[FakeCounter(clock, fail=True)])
    reqs = poisson_requests(2, 1e6, c.vocab, prompt_len=6, seed=0,
                            short=(2, 3), long=(2, 3))
    with pytest.raises(RuntimeError, match="counter read failed"):
        eng.serve(reqs)


def test_measured_scope_reads_a_counter_as_its_difference():
    clock = FakeClock()
    scope = MeasuredScope([FakeCounter(clock, period=0.01),
                           SyntheticPower(base=50.0, clock=clock)],
                          interval_ms=1000.0, clock=clock)
    for _ in range(10):
        scope._sample()
    edf, _ = scope.energy()
    rows = {r["device"]: r for r in edf.records()}
    js = scope.df.col("fake_counter:fake:0")
    assert rows["fake_counter:fake:0"]["energy_wh"] == pytest.approx(
        (js[-1] - js[0]) / 3600.0)
    ts = scope.df.col("t")
    assert rows["synthetic:synthetic:0"]["energy_wh"] == pytest.approx(
        50.0 * (ts[-1] - ts[0]) / 3600.0)
    failing = MeasuredScope([FakeCounter(clock, fail=True)], 1000.0,
                            clock=clock)
    failing._sample()
    failing._sample()
    with pytest.raises(RuntimeError, match="energy counter"):
        failing.energy()


class FakeLib:
    """Stands in for ``libnvidia-ml.so.1``'s energy call."""

    def __init__(self, ret=0, mj=0):
        self.ret, self.mj = ret, mj

    def nvmlDeviceGetTotalEnergyConsumption(self, handle, ref):
        ref._obj.value = self.mj
        return self.ret

    def nvmlErrorString(self, ret):
        return b"Not Supported"


def _nvml_energy(lib):
    m = NvmlEnergy.__new__(NvmlEnergy)
    m._lib, m._handle, m.index = lib, ctypes.c_void_p(), 0
    return m


def test_nvml_energy_reads_joules_and_raises_on_error():
    m = _nvml_energy(FakeLib(mj=123_456_789_012))
    assert m.read() == {"nvml:0": 123_456_789.012}
    assert (m.name, m.kind) == ("nvml_energy", "energy")
    with pytest.raises(RuntimeError,
                       match="nvmlDeviceGetTotalEnergyConsumption failed"):
        _nvml_energy(FakeLib(ret=3)).read()


def test_auto_and_nvml_raise_off_the_card(tmp_path):
    cpu = torch.device("cpu")
    assert POWER_CHOICES == ("auto", "nvml", "rapl", "synthetic", "none")
    for prefer in ("auto", "nvml"):
        with pytest.raises(RuntimeError, match="board power"):
            select_power_methods(prefer, cpu)
        with pytest.raises(RuntimeError, match="board power"):
            cli.main(["run", "--suite", "kernels", "--smoke", "--device",
                      "cpu", "--power", prefer, "--out", str(tmp_path)])
    assert not (tmp_path / "kernels" / "results.json").exists()
