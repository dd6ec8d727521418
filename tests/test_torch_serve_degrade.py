"""The serve engine's scripted mode and degradation paths against the
reference's, on the CPU.

Scripted engines (host callables for prefill and decode, a fake clock
and ``sleep_fn``, the triangle-wave ``SyntheticPower`` on that clock) run
the reference's own cases from ``tests/test_serve_energy.py``,
``tests/test_serve_scheduler.py`` and the serve part of
``tests/test_faults.py``: each case runs on the reference's engine and
on the port's with the same callables, and every result (tokens, finish
reasons, slots, stamps, energies), step window, power sample, summary
field, shed request and straggler event must be equal; then the case's
own assertions run on the port's result.

Model engines (reduced fp32 llama3.2-3b, the reference's weights
bridged, paged, chunked): a ``decode_fault`` schedule's slot fault
evicts the youngest decoding slot, which resumes through the replay, so
the faulted streams equal the fault-free ones and the reference's engine
under the same schedule; an overload window sheds the newest requests
as the reference's engine does.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.core import runner as ref_runner
from repro.faults import schedule as ref_schedule
from repro.models import lm as ref_lm
from repro.power import methods as ref_methods
from repro.serve import engine as ref_engine
from repro.serve import requests as ref_requests
from repro_torch import bridge
from repro_torch.core import runner
from repro_torch.faults import schedule
from repro_torch.power import methods
from repro_torch.serve import engine, requests
from repro_torch.serve.slo import SLO, evaluate_slo
from test_torch_families import configs

torch.set_num_threads(1)

J_PER_WH = 3600.0
BASE, AMP, PERIOD = 100.0, 100.0, 4.0
PKGS = {"ref": (ref_engine, ref_methods, ref_runner, ref_requests,
                ref_schedule),
        "port": (engine, methods, runner, requests, schedule)}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make(pkg, n_slots, *, prefill_dt=0.5, decode_dt=1.0, first=None,
         decode_fn=None, decode_hook=None, power=False, watchdog=None):
    """A scripted engine of ``pkg``: prefill advances the clock by
    ``prefill_dt`` and emits ``first(slot)`` (default 1), decode advances
    it by ``decode_hook()`` or ``decode_dt`` and adds 1 to each token,
    unless ``decode_fn(clock)`` builds another decode."""
    eng_mod, pw_mod, run_mod, _req_mod, _ = PKGS[pkg]
    clock = FakeClock()

    def prefill(slot, prompt):
        clock.advance(prefill_dt)
        return 1 if first is None else first(slot)

    def decode(tokens, positions, active):
        clock.advance(decode_hook() if decode_hook else decode_dt)
        return np.asarray(tokens) + 1

    kw = {}
    if power:
        kw["power_methods"] = [pw_mod.SyntheticPower(
            base=BASE, amp=AMP, period=PERIOD, clock=clock)]
    if watchdog is not None:
        kw["watchdog"] = run_mod.StragglerWatchdog(**watchdog)
    eng = eng_mod.ServeEngine(
        n_slots=n_slots, max_len=64, prefill_fn=prefill,
        decode_fn=decode_fn(clock) if decode_fn else decode, clock=clock,
        sleep_fn=clock.advance, **kw)
    return eng, clock


def reqs(pkg, n, *, budget=4, gap=0.0, prompt_len=4, eos=None,
         deadline=None):
    req_mod = PKGS[pkg][3]
    budgets = budget if isinstance(budget, (list, tuple)) else [budget] * n
    deadlines = deadline if isinstance(deadline, (list, tuple)) \
        else [deadline] * n
    return [req_mod.Request(rid=i, prompt=np.arange(prompt_len,
                                                    dtype=np.int32),
                            max_new_tokens=budgets[i], arrival_s=gap * i,
                            eos_id=eos, deadline_s=deadlines[i])
            for i in range(n)]


def overload(pkg, cap, span=10_000):
    mod = PKGS[pkg][4]
    return mod.FaultSchedule("overload", 0, 0, (mod.FaultEvent(
        "overload", at=0, n=cap, span=span),))


def _result_key(r):
    return (r.rid, r.slot, list(r.tokens), r.finish_reason, r.arrival_s,
            r.admitted_s, r.first_token_s, r.finish_s, r.prompt_len)


def assert_same_run(want, got):
    """Every result, window, sample, summary field and straggler event of
    the port's run equals the reference's."""
    assert [_result_key(r) for r in got.results] == \
        [_result_key(r) for r in want.results]
    for g, w in zip(got.results, want.results, strict=True):
        assert math.isclose(g.energy_wh, w.energy_wh, rel_tol=1e-12,
                            abs_tol=1e-15), (g.rid, g.energy_wh, w.energy_wh)
    assert [(s.kind, s.t0, s.t1, tuple(s.rids), s.n_tokens, s.n_steps)
            for s in got.steps] == \
        [(s.kind, s.t0, s.t1, tuple(s.rids), s.n_tokens, s.n_steps)
         for s in want.steps]
    assert got.sample_ts == want.sample_ts
    np.testing.assert_allclose(got.sample_ws, want.sample_ws, rtol=1e-12)
    gs, ws = dataclasses.asdict(got.summary), dataclasses.asdict(want.summary)
    assert gs.keys() == ws.keys()
    for k in ws:
        np.testing.assert_allclose(gs[k], ws[k], rtol=1e-12, atol=1e-15,
                                   err_msg=k)
    assert got.straggler_events == want.straggler_events


def both(engine_kw, req_kw, **serve_kw):
    """The case on both engines; returns the port's (run, engine)."""
    runs = {}
    for pkg in PKGS:
        eng, _ = make(pkg, **engine_kw)
        kw = dict(serve_kw)
        if "faults" in kw:
            kw["faults"] = overload(pkg, kw["faults"])
        runs[pkg] = eng.serve(reqs(pkg, **req_kw), **kw), eng
    assert_same_run(runs["ref"][0], runs["port"][0])
    assert runs["port"][1].shed == runs["ref"][1].shed
    return runs["port"]


def tri_energy_wh(t0, t1, n=200_001):
    ts = np.linspace(t0, t1, n)
    u = (ts / PERIOD) % 1.0
    ws = BASE + AMP * np.abs(2 * u - 1)
    return float(np.sum(0.5 * (ws[1:] + ws[:-1]) * np.diff(ts))) / J_PER_WH


# ---------------------------------------------------------------------------
# tests/test_serve_energy.py
# ---------------------------------------------------------------------------


def test_single_request_energy_exact():
    out, _ = both(dict(n_slots=1, prefill_dt=0.5, decode_dt=0.5, power=True),
                  dict(n=1, budget=4))
    (r,) = out.results
    want_wh = 300.0 / J_PER_WH
    assert math.isclose(r.energy_wh, want_wh, rel_tol=1e-9)
    assert math.isclose(out.summary.wh_per_token, want_wh / 4, rel_tol=1e-9)
    assert out.summary.overhead_wh == pytest.approx(0.0, abs=1e-12)


def test_energy_exact_across_triangle_vertex():
    out, _ = both(dict(n_slots=1, prefill_dt=1.0, decode_dt=1.0, power=True),
                  dict(n=1, budget=4))
    assert math.isclose(out.results[0].energy_wh, tri_energy_wh(0.0, 4.0),
                        rel_tol=1e-6)


def test_coscheduled_requests_split_window_energy():
    out, _ = both(dict(n_slots=2, prefill_dt=0.25, decode_dt=0.5,
                       power=True), dict(n=2, budget=[2, 4]))
    by = out.by_rid()
    e = tri_energy_wh
    assert math.isclose(by[0].energy_wh, e(0.0, 0.25) + e(0.5, 1.0) / 2,
                        rel_tol=1e-6)
    assert math.isclose(by[1].energy_wh,
                        e(0.25, 0.5) + e(0.5, 1.0) / 2 + e(1.0, 2.0),
                        rel_tol=1e-6)


def test_idle_energy_is_overhead_not_attributed():
    out, _ = both(dict(n_slots=1, prefill_dt=0.5, decode_dt=0.5,
                       power=True), dict(n=2, budget=2, gap=10.0))
    s = out.summary
    assert s.overhead_wh > 0.0
    assert math.isclose(s.attributed_wh + s.overhead_wh, s.total_energy_wh,
                        rel_tol=1e-9)


def test_straggler_watchdog_flags_slow_decode_step():
    def hook_factory():
        calls = {"n": 0}

        def hook():
            calls["n"] += 1
            return 5.0 if calls["n"] == 8 else 0.1   # one 50x step
        return hook

    runs = {}
    for pkg in PKGS:
        eng, _ = make(pkg, 1, prefill_dt=0.1, decode_hook=hook_factory(),
                      watchdog=dict(k=3.0, warmup=3))
        runs[pkg] = eng.serve(reqs(pkg, 1, budget=12))
    assert_same_run(runs["ref"], runs["port"])
    (ev,) = runs["port"].straggler_events
    assert ev["step"] == 7 and ev["dt"] == pytest.approx(5.0)


# ---------------------------------------------------------------------------
# tests/test_serve_scheduler.py (the engine loop)
# ---------------------------------------------------------------------------


def test_exact_token_counts_and_values():
    out, _ = both(dict(n_slots=2, first=lambda s: 1000 + 10 * s),
                  dict(n=3, budget=3))
    by = out.by_rid()
    assert by[0].tokens == [1000, 1001, 1002]
    assert by[1].tokens == [1010, 1011, 1012]
    assert len(by[2].tokens) == 3


def test_eos_early_exit_frees_slot_for_queue():
    def decode_fn(clock):
        calls = {"n": 0}

        def decode(tokens, positions, active):
            calls["n"] += 1
            clock.advance(1.0)
            out = np.asarray(tokens) + 1
            if calls["n"] == 1:
                out[0] = 99                        # slot 0 emits EOS
            return out
        return decode

    out, _ = both(dict(n_slots=2, decode_fn=decode_fn,
                       first=lambda s: 1000 + 10 * s),
                  dict(n=3, budget=10, eos=99))
    by = out.by_rid()
    assert by[0].finish_reason == "eos" and by[0].n_tokens == 2
    assert by[2].slot == 0
    assert by[2].finish_reason == "length" and by[2].n_tokens == 10


def test_queue_starvation_many_requests_few_slots():
    out, _ = both(dict(n_slots=2), dict(n=7, budget=2))
    assert all(r.n_tokens == 2 for r in out.results)
    assert [s.rids[0] for s in out.steps if s.kind == "prefill"] == \
        list(range(7))


def test_arrival_gaps_respected():
    out, _ = both(dict(n_slots=1, prefill_dt=0.25, decode_dt=0.25),
                  dict(n=2, budget=2, gap=100.0))
    by = out.by_rid()
    assert by[0].finish_s < 100.0 and by[1].admitted_s >= 100.0
    assert by[1].queue_s == pytest.approx(0.0, abs=0.06)


def test_continuous_beats_fixed_in_steps():
    n_decode = {}
    for policy in ("continuous", "fixed"):
        out, _ = both(dict(n_slots=2), dict(n=6, budget=[1, 8, 1, 8, 1, 8]),
                      policy=policy)
        n_decode[policy] = sum(1 for s in out.steps if s.kind == "decode")
    assert n_decode["continuous"] < n_decode["fixed"]


# ---------------------------------------------------------------------------
# tests/test_faults.py: serve degradation
# ---------------------------------------------------------------------------


def test_overload_sheds_newest_first_oldest_completes():
    out, eng = both(dict(n_slots=1, prefill_dt=0.05, decode_dt=0.1),
                    dict(n=5, budget=3), faults=2)
    by = out.by_rid()
    assert by[0].finish_reason != "shed" and by[0].n_tokens > 0
    assert sorted(r.rid for r in out.results
                  if r.finish_reason == "shed") == [2, 3, 4]
    assert eng.shed == 3


def test_deadline_expiry_sheds_queued_request():
    out, eng = both(dict(n_slots=1, prefill_dt=0.05, decode_dt=0.2),
                    dict(n=2, budget=[20, 2], deadline=[None, 0.5]))
    by = out.by_rid()
    assert by[0].n_tokens == 20
    assert by[1].finish_reason == "shed" and by[1].n_tokens == 0
    assert eng.shed == 1
    report = evaluate_slo(out.results, SLO(ttft_s=100.0, tpot_s=100.0))
    assert (report.n_requests, report.n_met) == (2, 1)
    assert report.goodput == pytest.approx(0.5)


def test_scripted_engines_refuse_what_they_cannot_run():
    eng, _ = make("port", 1)
    with pytest.raises(ValueError, match="phased only"):
        eng.serve(reqs("port", 1), sched="chunked")
    fault = schedule.FaultSchedule.from_preset("decode_fault", seed=0)
    with pytest.raises(ValueError, match="slot faults"):
        eng.serve(reqs("port", 1), faults=fault)
    with pytest.raises(ValueError, match="scripted mode"):
        engine.ServeEngine(prefill_fn=lambda s, p: 0)
    with pytest.raises(ValueError, match="generate runs the model"):
        eng.generate(np.zeros((1, 4), np.int32), 2)


# ---------------------------------------------------------------------------
# model engines: slot faults and overload on a reduced paged engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def llama():
    rc, c = configs("llama3.2-3b")
    rp = ref_lm.init(jax.random.key(0), rc)
    return rc, c, rp, bridge.params_from_numpy(jax.tree.map(np.asarray, rp),
                                               "cpu")


def _model_reqs(pkg, vocab, n=6):
    rng = np.random.default_rng(5)
    req_mod = PKGS[pkg][3]
    return [req_mod.Request(rid=i, prompt=rng.integers(
                0, vocab, int(rng.integers(10, 40))).astype(np.int32),
                max_new_tokens=int(rng.integers(10, 20)))
            for i in range(n)]


def _model_engine(pkg, llama, **kw):
    rc, c, rp, p = llama
    common = dict(n_slots=3, max_len=64, cache="paged", block_size=16, **kw)
    if pkg == "ref":
        return ref_engine.ServeEngine(rc, rp, **common)
    return engine.ServeEngine(c, p, device="cpu", **common)


def _streams(out):
    return {r.rid: list(r.tokens) for r in out.results}


def test_slot_fault_resumes_bit_identically(llama):
    c = llama[1]
    runs = {}
    for pkg in PKGS:
        sched_mod = PKGS[pkg][4]
        for preset in ("none", "decode_fault"):
            eng = _model_engine(pkg, llama, sched="chunked", chunk_tokens=16)
            faults = sched_mod.FaultSchedule.from_preset(preset, seed=0)
            out = eng.serve(_model_reqs(pkg, c.vocab), faults=faults)
            runs[pkg, preset] = (_streams(out), eng.injected_faults,
                                 eng.preemptions)
    faulted, n_faults, preempt = runs["port", "decode_fault"]
    assert n_faults == 1 and preempt >= 1
    assert runs["port", "none"][1] == 0
    assert faulted == runs["port", "none"][0]
    assert runs["port", "decode_fault"] == runs["ref", "decode_fault"]
    assert all(len(t) > 0 for t in faulted.values())


def test_phased_model_engine_refuses_slot_faults(llama):
    eng = _model_engine("port", llama)
    fault = schedule.FaultSchedule.from_preset("decode_fault", seed=0)
    with pytest.raises(ValueError, match="slot faults"):
        eng.serve(_model_reqs("port", llama[1].vocab), faults=fault)


@pytest.mark.parametrize("sched", ["phased", "chunked"])
def test_overload_on_a_model_engine_matches_reference(llama, sched):
    c = llama[1]
    runs = {}
    for pkg in PKGS:
        eng = _model_engine(pkg, llama, sched=sched, chunk_tokens=16)
        out = eng.serve(_model_reqs(pkg, c.vocab, n=8),
                        faults=overload(pkg, cap=2))
        runs[pkg] = (_streams(out), sorted(
            r.rid for r in out.results if r.finish_reason == "shed"),
            eng.shed)
    assert runs["port"] == runs["ref"]
    streams, shed, n_shed = runs["port"]
    assert n_shed == len(shed) > 0 and 0 not in shed
    assert all(streams[rid] == [] for rid in shed)
