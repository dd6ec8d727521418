"""The port's benchmark harness (``repro_torch.bench``) against the
reference's (``repro.bench``), and its CLI on the CPU.

  * the copied pieces behave as the reference's on the same inputs:
    ``Space.expand``, ``StragglerWatchdog``, ``classify_error``,
    ``run_attempts``, ``Frame`` CSV, ``get_power`` energy on a fake
    clock, the record schema and ``point_key``;
  * ``RunContext.measure`` gives ``rel_spread=None`` at ``iters=1``;
  * ``python -m repro_torch.bench list`` shows ``kernels``, and ``run
    --suite kernels --smoke --device cpu --power none`` writes readable
    ``results.{json,csv}`` whose records are ``ok``;
  * nothing is substituted: the CLI without ``--device`` raises where
    there is no card, ``--power auto`` raises on the CPU, and a
    placement of more than one device raises.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.bench.records import ResultRecord as JResultRecord
from repro.bench.records import point_key as jpoint_key
from repro.core import runner as jrunner
from repro.core.params import Space as JSpace
from repro.power.ctxmgr import get_power as jget_power
from repro.power.frame import Frame as JFrame
from repro.power.methods import SyntheticPower as JSyntheticPower
from repro_torch.bench import cli
from repro_torch.bench.context import RunContext
from repro_torch.bench.records import (
    SCHEMA_VERSION, ResultRecord, load_records, point_key,
)
from repro_torch.bench.runner import WorkloadRunner
from repro_torch.bench.spec import Placement, unregister, workload
from repro_torch.core import runner
from repro_torch.core.params import Space
from repro_torch.power.ctxmgr import get_power
from repro_torch.power.frame import Frame
from repro_torch.power.methods import SyntheticPower, select_power_methods

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ["run", "--suite", "kernels", "--smoke", "--power", "none"]


@pytest.mark.parametrize("axes,constraints", [
    ({"case": ["a", "b", "c"], "impl": ["plain", "cuda"]}, []),
    ({"global_batch": [8, 12, 16], "micro_batch": [1, 2, 4], "dp": [1, 2]},
     [lambda p: p["global_batch"] % (p["micro_batch"] * p["dp"]) == 0]),
    ({"x": [1]}, [lambda p: False]),
])
def test_space_expand_matches_reference(axes, constraints):
    mine = Space(axes, list(constraints))
    want = JSpace(axes, list(constraints))
    assert mine.expand() == want.expand()
    assert len(mine) == len(want)


def test_copied_runner_pieces_match_reference():
    dts = [1.0, 1.2, 0.9, 1.1, 1.0, 5.0, 1.05, 0.95, 9.0, 1.0]
    mine, want = runner.StragglerWatchdog(), jrunner.StragglerWatchdog()
    assert ([mine.observe(i, d) for i, d in enumerate(dts)]
            == [want.observe(i, d) for i, d in enumerate(dts)])
    assert mine.events == want.events and mine.rel_std() == want.rel_std()
    for e in (ValueError(), RuntimeError(), KeyError(), OSError()):
        assert runner.classify_error(e) == jrunner.classify_error(e)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return {"ok": 1}

    ok, metrics, info = runner.run_attempts("step", flaky, 4)
    assert ok and metrics == {"ok": 1} and info.attempts == 3
    ok, metrics, info = runner.run_attempts(
        "step", lambda: (_ for _ in ()).throw(ValueError("bad")), 4)
    assert not ok and info.fatal and info.attempts == 1
    assert metrics == {"step_error": "ValueError: bad"}


def test_frame_and_power_scope_match_reference():
    rows = [{"a": 1, "b": 2.5}, {"a": None, "c": "x"}]
    assert Frame.from_records(rows).to_csv() == \
        JFrame.from_records(rows).to_csv()

    def fake_clock():
        t = [0.0]

        def tick():
            t[0] += 0.25
            return t[0]
        return tick

    energies = []
    for power_cls, scope_cls in ((SyntheticPower, get_power),
                                 (JSyntheticPower, jget_power)):
        clock = fake_clock()
        method = power_cls(n_devices=2, base=100.0, amp=50.0, period=1.0,
                           clock=clock)
        with scope_cls([method], interval_ms=1000.0, clock=clock) as scope:
            pass
        energies.append(scope.total_energy_wh())
    assert energies[0] == pytest.approx(energies[1]) and energies[0] > 0


def test_record_schema_and_point_key_match_reference():
    kw = dict(workload="kernels", point={"impl": "cuda", "case": "rmsnorm"},
              metrics={"us": 3.5}, power_source="none")
    mine, want = ResultRecord(**kw), JResultRecord(**kw)
    assert mine.schema_version == want.schema_version == SCHEMA_VERSION
    assert point_key(mine) == jpoint_key(want)
    assert mine.to_dict() == want.to_dict()
    assert ResultRecord.from_dict(want.to_dict()) == mine
    assert mine.flat() == want.flat()


def test_measure_rel_spread_none_at_one_iter():
    ctx = RunContext(device=torch.device("cpu"))
    x = torch.ones(64, 64)
    m = ctx.measure(torch.mm, x, x, iters=1, warmup=0, power=False)
    assert m.rel_spread is None and m.iters == 1 and m.seconds > 0
    assert ctx.last_measurement is m
    m = ctx.measure(torch.mm, x, x, iters=4, power=False)
    assert m.rel_spread is not None and m.rel_spread >= 0


def test_cli_list_shows_kernels():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.bench", "list"],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = [line.split("|")[1].strip() for line in proc.stdout.splitlines()
             if line.startswith("|")]
    assert "kernels" in names


def test_cli_run_kernels_smoke_on_cpu(tmp_path, capsys):
    assert cli.main(SMOKE + ["--device", "cpu", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("all benchmarks complete")
    records = load_records(tmp_path / "kernels" / "results.json")
    assert [(r.point["case"], r.point["impl"]) for r in records] == [
        (c, i) for c in ("flash_b1_s256", "rmsnorm", "paged_prefill",
                         "paged_prefill_int8") for i in ("plain", "cuda")]
    for r in records:
        assert r.status == "ok" and r.schema_version == SCHEMA_VERSION
        assert r.power_source == "none" and r.metrics["us"] > 0
        if r.point["impl"] == "cuda":
            # on the CPU ops is the plain version: no error at all
            assert r.metrics["max_err"] == 0.0
    header = (tmp_path / "kernels" / "results.csv").read_text().splitlines()[0]
    assert {"case", "impl", "us", "max_err"} <= set(header.split(","))
    manifest = json.loads((tmp_path / "kernels" / "manifest.json").read_text())
    assert manifest["device"] == "cpu" and manifest["torch"]
    assert cli.main(["report", "--out", str(tmp_path)]) == 0
    assert "paged_prefill_int8" in capsys.readouterr().out


def test_cli_run_without_device_raises_without_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(SMOKE + ["--out", str(tmp_path)])
    assert not (tmp_path / "kernels").exists()


def test_power_auto_on_cpu_raises_and_substitutes_nothing(tmp_path):
    with pytest.raises(RuntimeError, match="board power"):
        cli.main(["run", "--suite", "kernels", "--smoke", "--device", "cpu",
                  "--out", str(tmp_path)])
    cpu = torch.device("cpu")
    with pytest.raises(KeyError, match="unknown power method"):
        select_power_methods("rapl", cpu)
    methods, label = select_power_methods("synthetic", cpu)
    assert label == "synthetic" and methods[0].name == "synthetic"
    assert select_power_methods("none", cpu) == ([], "none")


def test_multi_device_placement_raises():
    @workload("_two_devices", analog="test", space=Space({"x": [1]}),
              placement="dp2")
    def build(pt, ctx):
        return {}

    try:
        assert Placement.of("dp2").n_devices == 2
        with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
            WorkloadRunner(build, device=torch.device("cpu"), power="none")
    finally:
        unregister("_two_devices")
