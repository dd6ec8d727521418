"""The port's harness modules against ``repro``'s, on the CPU:

  * ``core.suite`` / ``core.runner.Runner``: the reference's
    ``tests/test_harness.py`` cases (space expansion under the paper's
    constraint, execution and persistence, power measurement, retries
    and the recorded error), on both packages where the case allows;
  * ``core.metrics``: ``Throughput`` and ``mfu`` as the reference's,
    ``mfu``'s default peak the H100's dense bf16 figure (the one
    ``resnet50`` uses);
  * ``bench.records.scaling_floor_violations``, exported from
    ``repro_torch.bench``, as ``tests/test_placement.py`` holds the
    reference's;
  * ``launch.slurm``: the reference's rendering cases
    (``tests/test_launch.py``) against the port's GPU template — one
    task a GPU, ``torch.distributed``'s rendezvous, no ``JAX_*`` or
    ``REPRO_TPU``, a ``repro_torch`` command — and the bench job a
    deferred point gets.
"""
import time

import pytest
import torch

from repro import core as ref_core
from repro.bench.records import ResultRecord as RefRecord
from repro.bench.records import stamp_scaling_metrics as ref_stamp
from repro.bench import scaling_floor_violations as ref_violations
from repro.launch import slurm as ref_slurm
from repro.power.methods import SyntheticPower as RefSyntheticPower
from repro_torch import core
from repro_torch.bench import Placement, scaling_floor_violations
from repro_torch.bench.records import ResultRecord, stamp_scaling_metrics
from repro_torch.bench.workloads import resnet50
from repro_torch.core import metrics
from repro_torch.launch import slurm
from repro_torch.power.methods import SyntheticPower

PKGS = {"ref": (ref_core, RefSyntheticPower, {}),
        "port": (core, SyntheticPower, {"device": "cpu"})}


@pytest.mark.parametrize("pkg", PKGS)
def test_space_expansion_and_constraints(pkg):
    mod = PKGS[pkg][0]
    sp = mod.Space({"global_batch": [16, 64], "dp": [4, 8],
                    "micro_batch": [4]}, [mod.divisible_batch])
    pts = sp.expand()
    assert {"global_batch": 16, "dp": 8, "micro_batch": 4} not in pts
    assert {"global_batch": 16, "dp": 4, "micro_batch": 4} in pts
    assert len(pts) == 3


@pytest.mark.parametrize("pkg", PKGS)
def test_runner_executes_and_persists(pkg, tmp_path):
    mod, _, kw = PKGS[pkg]
    calls = []

    def bench(pt, ctx):
        calls.append(pt)
        return {"tokens_per_s": 100.0 * pt["bs"]}

    suite = mod.BenchmarkSuite(name="t", space=mod.Space({"bs": [1, 2]}),
                               steps=[mod.Step("run", bench)])
    r = mod.Runner(suite, out_dir=str(tmp_path), **kw)
    recs = r.run(verbose=False)
    assert len(recs) == 2 and calls == [{"bs": 1}, {"bs": 2}]
    assert recs[1]["tokens_per_s"] == 200.0
    assert recs[1]["run_attempts"] == 1
    assert (tmp_path / "t" / "results.json").exists()
    assert (tmp_path / "t" / "results.csv").exists()
    assert (tmp_path / "t" / "manifest.json").exists()
    assert "tokens_per_s" in r.result_table()


@pytest.mark.parametrize("pkg", PKGS)
def test_runner_power_measurement(pkg, tmp_path):
    mod, synthetic, kw = PKGS[pkg]

    def bench(pt, ctx):
        time.sleep(0.03)
        return {"x": 1}

    suite = mod.BenchmarkSuite("p", mod.Space({"bs": [1]}),
                               [mod.Step("run", bench)])
    r = mod.Runner(suite, power_methods=[synthetic(base=100.0)],
                   out_dir=str(tmp_path), power_interval_ms=5, **kw)
    recs = r.run(verbose=False)
    # 100 W over at least 30 ms
    assert recs[0]["run_energy_wh"] >= 100.0 * 0.03 / 3600 * 0.99


@pytest.mark.parametrize("pkg", PKGS)
def test_runner_retries_then_records_error(pkg, tmp_path):
    mod, _, kw = PKGS[pkg]
    attempts = []

    def flaky(pt, ctx):
        attempts.append(1)
        if len(attempts) < 2:
            raise RuntimeError("transient")
        return {"ok": 1}

    suite = mod.BenchmarkSuite("f", mod.Space({"bs": [1]}),
                               [mod.Step("run", flaky, retries=3)])
    recs = mod.Runner(suite, out_dir=str(tmp_path), **kw).run(verbose=False)
    assert recs[0]["ok"] == 1 and len(attempts) == 2

    def broken(pt, ctx):
        raise ValueError("boom")

    suite2 = mod.BenchmarkSuite("g", mod.Space({"bs": [1]}),
                                [mod.Step("run", broken, retries=2),
                                 mod.Step("after", lambda pt, ctx: {"y": 1})])
    recs2 = mod.Runner(suite2, out_dir=str(tmp_path), **kw).run(
        verbose=False)
    assert "boom" in recs2[0]["run_error"]
    assert recs2[0]["run_attempts"] == 1 and "y" not in recs2[0]


def test_suite_selects_steps_by_tag():
    steps = [core.Step("a", lambda p, c: {}),
             core.Step("b", lambda p, c: {}, tags=frozenset({"smoke"})),
             core.Step("c", lambda p, c: {}, tags=frozenset({"full"}))]
    suite = core.BenchmarkSuite("s", core.Space({"x": [1, 2]}), steps)
    ref_steps = [ref_core.Step(s.name, s.fn, s.tags) for s in steps]
    ref_suite = ref_core.BenchmarkSuite("s", ref_core.Space({"x": [1, 2]}),
                                        ref_steps)
    for tags in (None, set(), {"smoke"}, {"full", "smoke"}, {"other"}):
        assert [s.name for s in suite.select_steps(tags)] == \
            [s.name for s in ref_suite.select_steps(tags)]
    assert suite.points() == ref_suite.points()


def test_runner_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    suite = core.BenchmarkSuite("d", core.Space({"x": [1]}), [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        core.Runner(suite)


@pytest.mark.parametrize("pkg", PKGS)
def test_table_heatmap_and_tokens_per_s(pkg):
    mod = PKGS[pkg][0]
    recs = [{"dp": 1, "bs": 16, "tps": 100.0},
            {"dp": 2, "bs": 16, "tps": 190.0},
            {"dp": 2, "bs": 32, "tps": 210.0}]
    t = mod.table(recs)
    assert "tps" in t and "190.00" in t
    h = mod.heatmap(recs, "dp", "bs", "tps")
    assert "OOM" in h and "210" in h
    assert mod.tokens_per_s(256, 4096, 1.0) == 256 * 4096
    assert (t, h) == (ref_core.table(recs),
                      ref_core.heatmap(recs, "dp", "bs", "tps"))


def test_mfu_and_throughput_match_reference():
    for flops, dt, n in ((1e15, 2.0, 1), (3.3e12, 0.01, 4), (0.0, 1.0, 1)):
        assert core.mfu(flops, dt, n, peak=197e12) == \
            ref_core.mfu(flops, dt, n, peak=197e12)
        assert core.mfu(flops, dt, n) == pytest.approx(
            flops / (dt * n * 989e12))
    assert core.mfu(1.0, 0.0, 1) == ref_core.mfu(1.0, 0.0, 1, peak=989e12)
    assert metrics.PEAK_FLOPS_BF16 == 989e12
    assert resnet50.PEAK_FLOPS_BF16 is metrics.PEAK_FLOPS_BF16
    for energy in (0.0, 2.5):
        got = core.Throughput("x", 1000.0, "tokens", 0.5, energy, 10.0)
        want = ref_core.Throughput("x", 1000.0, "tokens", 0.5, energy, 10.0)
        assert got.items_per_wh == want.items_per_wh
    assert core.Throughput("x", 1000.0, "tokens", 0.5, 2.5,
                           10.0).items_per_wh == 4000.0


def _sweep(mod, stamp, dp4_tok_s=400.0):
    def cell(n, tok_s, tokens_per_wh):
        return mod(workload="w", point={"bs": 8, "placement": f"dp{n}"},
                   metrics={"tokens_per_s": tok_s,
                            "tokens_per_wh": tokens_per_wh},
                   power_source="synthetic", placement={"dp": n})

    recs = [cell(1, 100.0, 2.0), cell(2, 190.0, 1.9),
            cell(4, dp4_tok_s, 4.0)]
    stamp(recs)
    return recs


def test_scaling_floor_violations_flags_collapsed_cells():
    recs = _sweep(ResultRecord, stamp_scaling_metrics, dp4_tok_s=120.0)
    viol = scaling_floor_violations(recs, floor=0.6)
    assert [(r.point["placement"], round(e, 2)) for r, e in viol] == [
        ("dp4", 0.3)]
    assert scaling_floor_violations(
        _sweep(ResultRecord, stamp_scaling_metrics), floor=0.6) == []
    ref = ref_violations(_sweep(RefRecord, ref_stamp, dp4_tok_s=120.0),
                         floor=0.6)
    assert [(r.point, e) for r, e in viol] == [(r.point, e) for r, e in ref]
    deferred = ResultRecord(workload="w", point={"placement": "dp2"},
                            status="deferred", placement={"dp": 2})
    assert scaling_floor_violations([deferred], floor=0.6) == []


def test_slurm_script_rendering():
    sys_cfg = slurm.SystemConfig(container="repro.sif", env={"FOO": "1"})
    script = slurm.render_job(job_name="train_granite",
                              module="repro_torch.launch.train",
                              args="--arch granite-8b", system=sys_cfg,
                              n_nodes=2)
    assert "#SBATCH --nodes=2" in script
    assert "#SBATCH --ntasks-per-node=4" in script    # one task a GPU
    assert "#SBATCH --gpus-per-node=4" in script
    assert "MASTER_ADDR=$(scontrol show hostnames" in script
    assert "MASTER_PORT=29500" in script and "WORLD_SIZE=$SLURM_NTASKS" \
        in script
    assert "RANK=$SLURM_PROCID" in script
    assert "SLURM_CPU_BIND=none" in script       # paper Sec V binding lesson
    assert "apptainer exec --nv repro.sif" in script
    assert "export FOO=1" in script
    assert "python -m repro_torch.launch.train --arch granite-8b" in script
    assert "JAX_" not in script and "REPRO_TPU" not in script
    ref = ref_slurm.render_job(job_name="train_granite",
                               module="repro.launch.train",
                               args="--arch granite-8b",
                               system=ref_slurm.SystemConfig(), n_pods=2)
    assert "JAX_COORDINATOR_ADDRESS" in ref and "REPRO_TPU" in ref


def test_write_launch_scripts(tmp_path):
    written = slurm.write_launch_scripts(tmp_path, ["granite-8b",
                                                    "qwen2-0.5b"])
    assert len(written) == 5  # 2 archs x 2 node counts + the dry run
    text = (tmp_path / "train_granite-8b_node2.sbatch").read_text()
    assert "--arch granite-8b" in text and "#SBATCH --nodes=2" in text
    dry = (tmp_path / "dryrun.sbatch").read_text()
    assert "repro_torch.launch.dryrun --all" in dry
    assert "#SBATCH --nodes=1" in dry and "#SBATCH --ntasks-per-node=1" in dry


@pytest.mark.parametrize("placement,nodes,tasks", [("dp2", 1, 2),
                                                   ("dp4", 1, 4),
                                                   ("dp8", 2, 4)])
def test_bench_job_is_sized_to_the_mesh(placement, nodes, tasks):
    pt = {"placement": placement, "global_batch": 8, "micro_batch": 1}
    script = slurm.render_bench_job(workload="heatmap",
                                    placement=Placement.of(placement),
                                    point=pt, power="auto", warmup=1,
                                    iters=3, job_suffix="_x")
    assert f"#SBATCH --nodes={nodes}" in script
    assert f"#SBATCH --ntasks-per-node={tasks}" in script
    assert f"#SBATCH --gpus-per-node={tasks}" in script
    assert f"--job-name=bench_heatmap_{placement}_x" in script
    assert ("python -m repro_torch.bench run --suite heatmap --out "
            "artifacts/bench_torch --power auto --warmup 1 --iters 3 "
            f"--points global_batch=8,micro_batch=1,placement={placement}"
            ) in script
