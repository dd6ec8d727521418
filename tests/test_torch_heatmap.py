"""The port's ``heatmap`` workload (the paper's Fig. 4) against
``repro``'s, on the CPU, where both train the reference's reduced
gpt-117m (2 layers, d_model 128, vocab 2048, bf16):

  * the spec has the reference's Space (expanded in the same order after
    its two constraints, full and smoke), smoke preset, result columns,
    primary metric, ``heatmap_keys``, tags and analog; the module has its
    ``SEQ``, model config and optimizer and step configs;
  * ``core.params``' ``divisible_batch`` and ``batch_at_least_dp`` give
    the reference's verdicts on a grid of points;
  * the smoke preset through both packages' runners (the port's through
    its CLI, ``--device cpu --power none``): the dp1 point ``ok`` with
    every metric of the reference's record and a falling loss, the dp2
    point ``deferred`` with its rendered sbatch file
    (``metrics["slurm_script"]``, a ``repro_torch.bench`` command), and
    the CLI's output ends with the rendered heatmap;
  * the first step's loss of the port's cell, handed the reference's
    weights (bridged), against the reference's jitted step on the same
    batch, at rtol ``LOSS_RTOL``;
  * ``core.results.heatmap`` renders the reference's text for the same
    records.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.bench.workloads  # noqa: F401 - populates the registry
from repro.bench import spec as ref_spec
from repro.bench.records import load_records as ref_load_records
from repro.bench.runner import WorkloadRunner as RefRunner
from repro.bench.workloads import heatmap as ref_heatmap
from repro.core import params as ref_params
from repro.core import results as ref_results
from repro.data.synthetic import synthetic_tokens
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.step import StepConfig as RefStepConfig
from repro.train.step import make_train_step as ref_make_step
from repro_torch import bridge
from repro_torch.bench import cli, spec
from repro_torch.bench.context import RunContext
from repro_torch.bench.records import load_records
from repro_torch.bench.workloads import heatmap
from repro_torch.core import params, results, tree
from repro_torch.train.step import StepConfig

torch.set_num_threads(1)

#: the first step's loss on the same weights and batch: both compute the
#: reduced model in bf16 and round at different points (measured 2.1e-6)
LOSS_RTOL = 1e-5


def test_spec_matches_reference():
    ref, got = ref_spec.get_workload("heatmap"), spec.get_workload("heatmap")
    assert dict(got.space.axes) == dict(ref.space.axes)
    for smoke in (False, True):
        assert got.space_for(smoke).expand() == ref.space_for(smoke).expand()
    assert len(got.space) == len(ref.space) == 12
    assert got.smoke_axes == ref.smoke_axes
    assert got.result_columns == ref.result_columns
    assert got.primary_metric == ref.primary_metric
    assert got.heatmap_keys == ref.heatmap_keys
    assert got.tags == ref.tags
    assert got.analog == ref.analog
    assert got.max_devices() == ref.max_devices() == 8


def test_constants_and_configs_match_reference():
    assert heatmap.SEQ == ref_heatmap.SEQ
    c, scale = heatmap.config(torch.device("cpu"))
    rc, roc, _, _ = ref_heatmap._setup()
    assert scale == "reduced"
    assert dataclasses.asdict(c) == dataclasses.asdict(rc)
    ctx = RunContext(device=torch.device("cpu"))
    _, oc, *_ = heatmap._setup(ctx)
    assert dataclasses.asdict(oc) == dataclasses.asdict(roc) == \
        dataclasses.asdict(RefOptConfig(warmup=1, total_steps=100))
    # the reference's ``unroll`` is its microbatch scan's, a JAX option
    # the port's Python loop has no use for
    want = dataclasses.asdict(RefStepConfig())
    assert want.pop("unroll") is False
    assert dataclasses.asdict(StepConfig()) == want


@pytest.mark.parametrize("fn", ["divisible_batch", "batch_at_least_dp"])
def test_batch_constraints_match_reference(fn):
    grid = [{"global_batch": gb, "dp": dp, "micro_batch": mb}
            for gb in (0, 1, 4, 8, 16, 24) for dp in (1, 2, 4, 8)
            for mb in (1, 2, 4)]
    grid += [{}, {"global_batch": 8}, {"dp": 4}]
    got = [getattr(params, fn)(pt) for pt in grid]
    assert got == [getattr(ref_params, fn)(pt) for pt in grid]
    assert any(got) and not all(got)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The smoke preset through both packages (the port's through its
    CLI, whose output is kept)."""
    tmp = tmp_path_factory.mktemp("heatmap_bench")
    RefRunner(ref_spec.get_workload("heatmap"), out_dir=str(tmp / "ref"),
              power="none", smoke=True, iters=2).run(verbose=False)
    return tmp, ref_load_records(tmp / "ref" / "heatmap" / "results.json")


def test_smoke_records_hold_the_reference(runs, capsys, monkeypatch):
    tmp, ref_recs = runs
    rc = cli.main(["run", "--suite", "heatmap", "--smoke", "--device", "cpu",
                   "--power", "none", "--iters", "2", "--out",
                   str(tmp / "port"), "--quiet"])
    out = capsys.readouterr().out
    assert rc == 0 and out.rstrip().endswith("all benchmarks complete")
    assert "placement\\global_batch" in out
    recs = load_records(tmp / "port" / "heatmap" / "results.json")
    assert [r.point for r in recs] == [r.point for r in ref_recs]
    # the reference's process holds one device and defers dp2; the port
    # runs it in two gloo ranks
    assert [r.status for r in ref_recs] == ["ok", "deferred"]
    assert [r.status for r in recs] == ["ok", "ok"]
    ok, dp2 = recs
    missing = set(ref_recs[0].metrics) - set(ok.metrics)
    assert not missing, missing
    assert set(dp2.metrics) == set(ok.metrics) | {"scaling_efficiency"}
    assert dp2.metrics["tok_s_per_device"] == dp2.metrics["tokens_per_s"] / 2
    assert dp2.metrics["scaling_efficiency"] > 0
    # bf16 compute; the two ranks' gradient sum rounds differently
    assert dp2.metrics["loss_first"] == pytest.approx(
        ok.metrics["loss_first"], rel=1e-4)
    m = ok.metrics
    assert ok.power_source == "none" and m["model_scale"] == "reduced"
    assert m["n_params"] == sum(x.size for x in jax.tree.leaves(
        ref_heatmap._setup()[2]))
    assert m["tok_s_per_device"] == m["tokens_per_s"] > 0
    assert m["loss_last"] < m["loss_first"] and m["iters"] == 2
    assert "mfu" not in m and "peak_mem_gb" not in m
    assert all(c in ok.flat() for c in spec.get_workload(
        "heatmap").result_columns if c in ref_recs[0].flat())
    # a process that cannot place two ranks defers dp2 with its script
    monkeypatch.setenv("REPRO_MAX_LOCAL_DEVICES", "1")
    rc = cli.main(["run", "--suite", "heatmap", "--smoke", "--device", "cpu",
                   "--power", "none", "--iters", "2", "--out",
                   str(tmp / "capped"), "--quiet", "--points",
                   "placement=dp2"])
    assert rc == 0
    deferred, = load_records(tmp / "capped" / "heatmap" / "results.json")
    assert deferred.status == "deferred"
    assert deferred.n_devices == 2 and "process can place 1" in deferred.error
    path = deferred.metrics["slurm_script"]
    assert path in deferred.error
    script = open(path).read()
    assert "python -m repro_torch.bench run --suite heatmap" in script
    assert "--points global_batch=8,micro_batch=1,placement=dp2" in script
    assert "--ntasks-per-node=2" in script and "--gpus-per-node=2" in script
    assert "JAX_" not in script and "REPRO_TPU" not in script
    ref_script = ref_recs[1].metrics["slurm_script"]
    assert path.rsplit("/", 1)[1] == ref_script.rsplit("/", 1)[1]


def test_first_loss_matches_the_reference_on_its_weights():
    """The port's cell, handed the reference's state, against the
    reference's jitted step on the same batch: the first step's loss."""
    rc, roc, rp, ro = ref_heatmap._setup()
    gb = 8
    toks = jnp.asarray(synthetic_tokens(gb, ref_heatmap.SEQ,
                                        rc.vocab)[:, :ref_heatmap.SEQ])
    _, _, m = jax.jit(ref_make_step(rc, roc, RefStepConfig()))(
        rp, ro, {"tokens": toks, "labels": jnp.roll(toks, -1, 1)})
    want = float(m["loss"])
    ctx = RunContext(device=torch.device("cpu"), warmup=0, iters=1)
    c, oc, _, _, scale, _ = heatmap._setup(ctx)
    p, o = bridge.train_state_from_numpy(
        *jax.tree.map(np.asarray, (rp, ro)), device="cpu")
    ctx.cache["heatmap"] = (c, oc, p, o, scale,
                            sum(t.numel() for t in tree.leaves(p)))
    out = spec.get_workload("heatmap").build(
        {"placement": "dp1", "global_batch": gb, "micro_batch": 1},
        ctx)["run"]()
    print(f"\nport first loss {out['loss_first']:.7f}, reference "
          f"{want:.7f}")
    np.testing.assert_allclose(out["loss_first"], want, rtol=LOSS_RTOL)


def test_heatmap_renders_the_reference_text():
    recs = [{"placement": "dp1", "global_batch": 8, "tokens_per_s": 100.4},
            {"placement": "dp1", "global_batch": 16, "tokens_per_s": 190.6},
            {"placement": "dp2", "global_batch": 16, "tokens_per_s": 333.0},
            {"placement": "dp8", "global_batch": 32},
            {"placement": "dp4", "global_batch": 32, "tokens_per_s": 1e5}]
    for fmt in ("{:.0f}", "{:.2f}"):
        got = results.heatmap(recs, "placement", "global_batch",
                              "tokens_per_s", fmt)
        assert got == ref_results.heatmap(recs, "placement", "global_batch",
                                          "tokens_per_s", fmt)
    assert "OOM" in got
    assert results.table(recs) == ref_results.table(recs)
