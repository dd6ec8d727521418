"""The port's RAPL and fallback power backends, on the CPU:

  * the reference's RAPL cases (``tests/test_power.py``) against the
    port's ``RaplPower``: graceful when absent, a fake powercap tree read
    as watts (first read 0.0, then the counter's difference over time),
    a counter wrap read as its post-wrap value;
  * ``select_power_methods("rapl")`` (``--power rapl``) raises when no
    zone is readable (the reference reads zero there) and selects RAPL
    when one is; ``METHODS`` / ``get_method``;
  * the reference's ``FallbackPower`` cases (``tests/test_faults.py``)
    against the port's: degrade with a labelled source, recover the
    primary, the flaky wrapper's failure window;
  * what the port adds: a fallback of another kind is converted into the
    primary's, exactly under a fake clock: an energy primary continues
    as its last good counter value plus the trapezoid of the fallback's
    watts, returns to its own counter when it recovers, and a
    ``MeasuredScope`` over the wrapper keeps one counter column whose
    energy is the exact integral; a power primary refuses an energy
    fallback.
"""
import math

import pytest
import torch

from repro.faults.schedule import FlakyPower as RefFlakyPower
from repro.power import methods as ref_methods
from repro_torch.bench import cli
from repro_torch.faults.schedule import FlakyPower
from repro_torch.power import methods as pm
from repro_torch.power.ctxmgr import MeasuredScope
from repro_torch.power.methods import (
    METHODS, FallbackPower, PowerMethod, RaplPower, SyntheticPower,
    get_method, select_power_methods,
)

CPU = torch.device("cpu")


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self):
        return self.t


class LinearPower(PowerMethod):
    """P(t) = a + b t watts under a fake clock."""

    name = "linear"

    def __init__(self, clock, a=100.0, b=10.0):
        self.clock, self.a, self.b = clock, a, b

    def devices(self):
        return ["lin:0"]

    def read(self):
        return {"lin:0": self.a + self.b * self.clock()}


class LinearEnergy(LinearPower):
    """The exact counter of ``LinearPower``: E(t) = a t + b t^2 / 2 J
    (plus an offset, as a counter since boot has)."""

    name = "counter"
    kind = "energy"

    def __init__(self, clock, a=100.0, b=10.0, offset=5000.0):
        super().__init__(clock, a, b)
        self.offset = offset

    def read(self):
        t = self.clock()
        return {"cnt:0": self.offset + self.a * t + 0.5 * self.b * t * t}

    def devices(self):
        return ["cnt:0"]


# ---------------------------------------------------------------------------
# RAPL (the reference's cases)
# ---------------------------------------------------------------------------


def test_rapl_graceful_when_absent():
    m = RaplPower(root="/nonexistent/powercap")
    assert not m.available()
    assert m.read() == {}
    ref = ref_methods.RaplPower(root="/nonexistent/powercap")
    assert (m.available(), m.read()) == (ref.available(), ref.read())


def _fake_powercap(tmp_path, uj: float):
    zone = tmp_path / "intel-rapl:0"
    zone.mkdir(exist_ok=True)
    (zone / "energy_uj").write_text(f"{int(uj)}\n")
    return tmp_path


def test_rapl_reads_fake_powercap_tree(tmp_path, monkeypatch):
    fake_t = {"t": 100.0}
    monkeypatch.setattr(pm.time, "monotonic", lambda: fake_t["t"])
    root = _fake_powercap(tmp_path, 1_000_000)
    m = RaplPower(root=str(root))
    assert m.available() and m.kind == "power"
    assert m.devices() == ["intel-rapl:0"]
    assert m.read() == {"intel-rapl:0": 0.0}   # first read: no baseline
    _fake_powercap(tmp_path, 3_000_000)        # +2 J over 2 s -> 1 W
    fake_t["t"] = 102.0
    assert m.read()["intel-rapl:0"] == pytest.approx(1.0)


def test_rapl_counter_wrap_uses_post_wrap_delta(tmp_path, monkeypatch):
    fake_t = {"t": 50.0}
    monkeypatch.setattr(pm.time, "monotonic", lambda: fake_t["t"])
    root = _fake_powercap(tmp_path, 10_000_000)
    m = RaplPower(root=str(root))
    m.read()                                   # baseline at 10 J
    _fake_powercap(tmp_path, 4_000_000)        # counter wrapped to 4 J
    fake_t["t"] = 52.0
    w = m.read()["intel-rapl:0"]
    assert w == pytest.approx(4_000_000 / 2.0 / 1e6)  # 2 W, not negative
    assert w >= 0.0


def test_power_rapl_raises_without_a_zone(tmp_path, monkeypatch):
    monkeypatch.setattr(RaplPower, "ROOT", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="no zone .* is readable"):
        select_power_methods("rapl", CPU)
    with pytest.raises(RuntimeError, match="--power rapl"):
        cli.main(["run", "--suite", "heatmap", "--smoke", "--device", "cpu",
                  "--power", "rapl", "--out", str(tmp_path / "out")])
    # the reference selects it all the same and reads nothing
    monkeypatch.setattr(ref_methods.RaplPower, "ROOT", str(tmp_path / "none"))
    ref_m, ref_label = ref_methods.select_power_methods("rapl")
    assert ref_label == "rapl" and ref_m[0].read() == {}
    monkeypatch.setattr(RaplPower, "ROOT", str(_fake_powercap(tmp_path, 7)))
    methods, label = select_power_methods("rapl", CPU)
    assert label == "rapl" and isinstance(methods[0], RaplPower)
    assert methods[0].devices() == ["intel-rapl:0"]


def test_methods_registry():
    assert {"synthetic", "rapl"} <= set(METHODS) & set(ref_methods.METHODS)
    assert set(METHODS) == {"synthetic", "rapl", "nvml", "nvml_energy"}
    m = get_method("synthetic", n_devices=2, base=40.0)
    assert isinstance(m, SyntheticPower) and m.devices() == [
        "synthetic:0", "synthetic:1"]
    assert get_method("rapl", root="/nonexistent").available() is False
    assert "rapl" in pm.POWER_CHOICES and "tpu_model" not in METHODS


# ---------------------------------------------------------------------------
# FallbackPower (the reference's cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_fallback_power_degrades_with_labeled_source(pkg):
    mod, flaky = ((pm, FlakyPower) if pkg == "port"
                  else (ref_methods, RefFlakyPower))
    primary = flaky(mod.SyntheticPower(n_devices=2, base=100.0),
                    fail_from=0, fail_count=100)
    fb = mod.FallbackPower(primary, mod.SyntheticPower(n_devices=1,
                                                       base=50.0),
                           max_failures=3)
    assert fb.label == primary.name        # untouched until a fallback read
    for i in range(4):
        out = fb.read()                    # never raises
        assert set(out) == set(primary.devices())
        assert sum(out.values()) == pytest.approx(50.0)
    assert fb.degraded and fb.fallback_reads == 4
    assert fb.label.endswith("+fallback:synthetic")


def test_fallback_power_recovers_primary():
    primary = FlakyPower(SyntheticPower(n_devices=1, base=100.0),
                         fail_from=0, fail_count=2)
    fb = FallbackPower(primary, SyntheticPower(n_devices=1, base=50.0),
                       max_failures=3)
    assert sum(fb.read().values()) == pytest.approx(50.0)   # fail 1
    assert sum(fb.read().values()) == pytest.approx(50.0)   # fail 2
    assert sum(fb.read().values()) == pytest.approx(100.0)  # primary back
    assert not fb.degraded and fb.failures == 0
    assert fb.available() and fb.kind == "power" and fb.name == "synthetic"


def test_flaky_power_window():
    p = FlakyPower(SyntheticPower(n_devices=1, base=10.0),
                   fail_from=1, fail_count=2)
    p.read()
    with pytest.raises(OSError, match="injected power-backend"):
        p.read()
    with pytest.raises(OSError):
        p.read()
    assert sum(p.read().values()) == pytest.approx(10.0)
    assert p.kind == "power"
    assert FlakyPower(LinearEnergy(FakeClock()), 0, 1).kind == "energy"


# ---------------------------------------------------------------------------
# kind conversion (the port's)
# ---------------------------------------------------------------------------


def test_energy_primary_continues_on_the_fallbacks_trapezoid():
    clock = FakeClock()
    primary = FlakyPower(LinearEnergy(clock), fail_from=3, fail_count=10**6)
    fb = FallbackPower(primary, LinearPower(clock), max_failures=2,
                       clock=clock)
    assert fb.kind == "energy" and fb.devices() == ["cnt:0"]
    exact = LinearEnergy(clock)
    seen = []
    for i, t in enumerate([0.0, 0.5, 1.25, 2.0, 3.5, 3.6, 7.0]):
        clock.t = t
        out = fb.read()
        seen.append(out["cnt:0"])
        # the trapezoid is exact for linear power, so the converted
        # counter equals the true one
        assert out["cnt:0"] == pytest.approx(exact.read()["cnt:0"],
                                             rel=1e-12), (i, t)
    assert fb.fallback_reads == 4 and fb.degraded
    assert fb.label == "counter+fallback:linear"
    assert seen == sorted(seen)


def test_energy_primary_returns_to_its_counter_after_a_gap():
    clock = FakeClock()
    inner = LinearEnergy(clock)
    primary = FlakyPower(inner, fail_from=1, fail_count=2)
    # the fallback under-reads by 10 W, so the gap's estimate is off
    fb = FallbackPower(primary, LinearPower(clock, a=90.0), clock=clock)
    clock.t = 0.0
    e0 = fb.read()["cnt:0"]
    clock.t = 1.0
    e1 = fb.read()["cnt:0"]                       # fallback: 90 + 10 t
    assert e1 == pytest.approx(e0 + 0.5 * (90.0 + 100.0) * 1.0)
    clock.t = 2.0
    fb.read()
    clock.t = 3.0
    assert fb.read()["cnt:0"] == inner.read()["cnt:0"]  # the real counter


def test_energy_primary_that_never_read_stays_continuous():
    clock = FakeClock()
    primary = FlakyPower(LinearEnergy(clock), fail_from=0, fail_count=2)
    fb = FallbackPower(primary, LinearPower(clock), clock=clock)
    vals = []
    for t in (0.0, 1.0, 2.0, 3.0):
        clock.t = t
        vals.append(fb.read()["cnt:0"])
    # 0 at the first fallback read, then the trapezoids of 100 + 10 t,
    # then the primary's counter shifted to continue the column
    assert vals[:2] == [0.0, pytest.approx(105.0)]
    assert vals[2] - vals[1] == pytest.approx(115.0)
    assert vals[3] - vals[2] == pytest.approx(125.0)


def test_power_primary_refuses_an_energy_fallback():
    clock = FakeClock()
    with pytest.raises(ValueError, match="power fallback"):
        FallbackPower(LinearPower(clock), LinearEnergy(clock))
    fb = FallbackPower(LinearEnergy(clock), LinearEnergy(clock, offset=0.0))
    clock.t = 2.0
    assert fb.read() == {"cnt:0": pytest.approx(5220.0)}   # same kind


def test_scope_over_the_wrapper_integrates_exactly():
    clock = FakeClock(10.0)
    primary = FlakyPower(LinearEnergy(clock), fail_from=4, fail_count=100)
    fb = FallbackPower(primary, LinearPower(clock), clock=clock)
    scope = MeasuredScope([fb], interval_ms=1e9, clock=clock)
    assert scope.counter_cols == {"counter:cnt:0"}
    for i in range(9):
        clock.t = 10.0 + 0.25 * i
        scope._sample()
    edf, _ = scope.energy()
    a, b, t0, t1 = 100.0, 10.0, 10.0, 12.0
    want = a * (t1 - t0) + 0.5 * b * (t1 ** 2 - t0 ** 2)
    assert math.isclose(edf.records()[0]["energy_wh"], want / 3600,
                        rel_tol=1e-12)
    assert not scope.counter_errors and fb.fallback_reads == 5
