"""A whole run on the CPU at a tiny size with the look for a card
skipped: the result line's schema, and ``correct`` false for each
fault a training cell can have planted under the timed path. Without a
card, or without the program, the command exits non-zero and prints no
result."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from cb_testkit import CELLS, HERE, FakeCounter, tiny
from cbench import runner

ROOT = HERE.parent


def _run(cell, traced=False, hook=None):
    return runner.run(cell, 2 ** 31 + 3, 0.2, traced, device=torch.device(
        "cpu"), counter=FakeCounter(), kind="", t_start=0.0,
        log=lambda s: None, program_hook=hook)


class Unchanged:
    """Runs the step, then puts every tensor of its state back."""

    def __init__(self, prog):
        self.prog = prog

    def step(self, batch):
        from cbench.weights import flat
        state = flat((self.prog.params, self.prog.opt_state))
        saved = {n: t.clone() for n, t in state.items()}
        m = self.prog.step(batch)
        with torch.no_grad():
            for n, t in flat((self.prog.params,
                              self.prog.opt_state)).items():
                t.copy_(saved[n])
        return m

    def __getattr__(self, name):
        return getattr(self.prog, name)


class HalfBatch(Unchanged):
    """Trains on the first half of the batch's rows (their mean)."""

    def step(self, batch):
        return self.prog.step({k: v[:v.shape[0] // 2]
                               for k, v in batch.items()})


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_its_line_has_the_schema(name):
    out = _run(tiny(name))
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    cell = tiny(name)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out, allow_nan=False)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_per_layer_metrics(name):
    out = _run(tiny(name), traced=True)
    assert list(out)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in out["breakdown"].values())
    names = {m["name"] for m in tiny(name).per_layer}
    # the CPU has no device trace and no peaks: only the (fake) power
    assert set(out["metrics"]) == {n for n in names
                                   if n.startswith("board_w.")}
    assert out["correct"] is True


@pytest.mark.parametrize("fault", [Unchanged, HalfBatch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    out = _run(tiny(name), hook=fault)
    assert out["correct"] is False
    failed = [n for n, c in out["checks"].items() if c["value"] > c["limit"]]
    assert failed


def _stub_main(monkeypatch, capsys, result, jax_free=True):
    """``run.main`` around ``result`` with no card; ``jax_free``: as if
    this process (which other test files share) had loaded no JAX."""
    import run as run_mod
    from cbench import chip
    monkeypatch.setattr(chip, "require_cards", lambda n: None)
    if jax_free:
        monkeypatch.setattr(runner, "forbidden_modules", lambda: [])

    class Counter:
        def __init__(self, uuid):
            pass

        def power_limit_w(self):
            return 700.0

        def close(self):
            pass

    monkeypatch.setattr(chip, "NvmlCounter", Counter)
    monkeypatch.setattr(chip, "cuda_uuid", lambda d=0: "0" * 32)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(runner, "run", lambda *a, **k: result)
    rc = run_mod.main(["--workload", CELLS[0], "--seed", "1",
                       "--seconds", "1"])
    return rc, capsys.readouterr()


def test_main_prints_the_line_last_and_the_checks_on_stderr(monkeypatch,
                                                            capsys):
    result = {"correct": True, "attempted": 3, "failed": 0,
              "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
              "device": {"platform": "gpu", "kind": "x", "count": 1,
                         "memory_peak_bytes": 1},
              "checks": {"loss_gap": {"value": 1e-4, "limit": 1e-3}}}
    rc, io = _stub_main(monkeypatch, capsys, result)
    assert rc == 0
    assert json.loads(io.out.strip().splitlines()[-1]) == result
    assert io.err.strip().splitlines()[-1] == "check loss_gap 0.0001 limit 0.001"


def test_main_prints_nothing_once_jax_is_loaded(monkeypatch, capsys):
    import types
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
              "device": {}, "checks": {}}
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, io = _stub_main(monkeypatch, capsys, result, jax_free=False)
    assert rc != 0 and io.out.strip() == ""
    assert "jax" in io.err


def test_main_turns_a_nan_into_null_and_not_correct(monkeypatch, capsys):
    result = {"correct": True, "attempted": 3, "failed": 0, "metrics": {},
              "device": {}, "checks": {"grad_gap": {"value": float("nan"),
                                                    "limit": 0.1}}}
    rc, io = _stub_main(monkeypatch, capsys, result)
    line = json.loads(io.out.strip().splitlines()[-1])
    assert line["correct"] is False
    assert line["checks"]["grad_gap"]["value"] is None


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_without_a_card_the_run_fails_and_prints_no_result():
    p = subprocess.run(
        [sys.executable, "caraml_bench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 1), "--seconds", "1"], cwd=ROOT,
        env=_env(), capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "card" in p.stderr


def test_without_the_program_the_run_fails_and_prints_no_result(tmp_path):
    """A checkout of ``BENCHMARK.json`` and the benchmark's folder only:
    even past the look for a card, the program is missing."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "caraml_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    code = ("import sys, runpy; sys.path.insert(0, 'caraml_bench'); "
            "import cbench.chip as c; c.require_cards = lambda n: None; "
            "sys.argv = ['run.py', '--workload', %r, '--seed', '1', "
            "'--seconds', '1']; runpy.run_path('caraml_bench/run.py', "
            "run_name='__main__')" % CELLS[0])
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "repro_torch" in p.stderr
