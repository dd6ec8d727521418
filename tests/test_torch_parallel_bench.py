"""The multi-rank bench cells against ``repro``'s smoke run, on the CPU.

The reference's CLI runs the smoke presets of ``llm_train``,
``resnet50``, ``heatmap`` and ``pipeline_gpt`` in a subprocess (it sizes
a forced host platform to the largest placement); the port's CLI runs
the same presets in process, each dp2 / pp4 point in gloo ranks it
spawns. Held: the ``pipeline_gpt`` spec, and per workload the points,
the statuses (every cell ``ok``) and which scaling columns each record
carries (``tok_s_per_device``, ``scaling_efficiency``,
``effective_devices``, and ``wh_per_token_scaling`` wherever the
reference's has it: the port's heatmap records also carry
``tokens_per_wh``, so they gain it where the reference's do not); and
that a process
that cannot place the ranks defers those cells with their sbatch
scripts; and that a rank that raises fails its cells at once, with its
traceback.
"""
import os
import subprocess
import sys
import time

import pytest
import torch

from repro.bench import spec as ref_spec
from repro.bench import workloads as ref_workloads  # noqa: F401 - registry
from repro.bench.records import load_records as ref_load_records
from repro_torch.bench import cli, spec
from repro_torch.bench.records import load_records
from repro_torch.bench.runner import WorkloadRunner

SUITES = ["llm_train", "resnet50", "heatmap", "pipeline_gpt"]
SCALING = {"tok_s_per_device", "scaling_efficiency", "effective_devices"}


def test_pipeline_gpt_spec_matches_reference():
    ref, got = (ref_spec.get_workload("pipeline_gpt"),
                spec.get_workload("pipeline_gpt"))
    assert dict(got.space.axes) == dict(ref.space.axes)
    for smoke in (False, True):
        assert got.space_for(smoke).expand() == ref.space_for(smoke).expand()
    assert got.placement.label == ref.placement.label == "pp4"
    assert got.placement.mesh_axes == ref.placement.mesh_axes
    for f in ("smoke_axes", "result_columns", "primary_metric", "tags",
              "analog", "compare_tols"):
        assert getattr(got, f) == getattr(ref, f), f


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_bench")
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro.bench", "run", "--suite",
         ",".join(SUITES), "--tags", "smoke", "--power", "synthetic",
         "--iters", "1", "--warmup", "0", "--out", str(tmp / "ref")],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rc = cli.main(["run", "--suite", ",".join(SUITES), "--smoke",
                   "--device", "cpu", "--power", "synthetic", "--iters", "1",
                   "--warmup", "0", "--out", str(tmp / "port"), "--quiet"])
    return rc, tmp


@pytest.mark.parametrize("name", SUITES)
def test_smoke_cells_hold_the_reference(runs, name):
    rc, tmp = runs
    assert rc == 0
    ref = ref_load_records(tmp / "ref" / name / "results.json")
    got = load_records(tmp / "port" / name / "results.json")
    assert [r.point for r in got] == [r.point for r in ref]
    assert [r.status for r in got] == [r.status for r in ref]
    assert all(r.status == "ok" for r in got), [r.error for r in got]
    assert any(r.n_devices > 1 for r in got)
    for r, w in zip(got, ref):
        assert r.placement == w.placement and r.n_devices == w.n_devices
        assert SCALING & set(r.metrics) == SCALING & set(w.metrics), r.point
        if "wh_per_token_scaling" in w.metrics:
            assert "wh_per_token_scaling" in r.metrics
        assert r.power_source == w.power_source == "synthetic"
        assert r.metrics["model_scale"] == "reduced"
    if name == "pipeline_gpt":
        assert got[0].metrics["bubble_fraction"] == 3 / 11


def test_cells_defer_where_ranks_cannot_be_placed(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_MAX_LOCAL_DEVICES", "1")
    rc = cli.main(["run", "--suite", "pipeline_gpt", "--smoke", "--device",
                   "cpu", "--power", "none", "--out", str(tmp_path),
                   "--quiet"])
    assert rc == 0
    rec, = load_records(tmp_path / "pipeline_gpt" / "results.json")
    assert rec.status == "deferred" and rec.n_devices == 4
    assert "needs 4 devices, process can place 1" in rec.error
    script = open(rec.metrics["slurm_script"]).read()
    assert "--ntasks-per-node=4" in script
    assert "python -m repro_torch.bench run --suite pipeline_gpt" in script


def test_a_rank_that_raises_fails_its_cells(tmp_path):
    import _torch_rank_fault  # noqa: F401 - registers rank_fault
    try:
        runner = WorkloadRunner(spec.get_workload("rank_fault"),
                                device=torch.device("cpu"),
                                out_dir=str(tmp_path), power="none")
        t0 = time.monotonic()
        recs = runner.run(verbose=False)
    finally:
        spec._REGISTRY.pop("rank_fault", None)
    assert time.monotonic() - t0 < 60
    assert [r.point["x"] for r in recs] == [0, 1]
    for r in recs:
        assert r.status == "error"
        assert "rank 1 of 2 failed" in r.error
        assert "rank 1 failed at point {'placement': 'dp2', 'x': 1}" in r.error
        assert "ValueError: injected fault on rank 1" in r.error
