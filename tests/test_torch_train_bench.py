"""The port's ``llm_train`` and ``resilience`` workloads against
``repro``'s, on the CPU, where both run the reference's reduced models:

  * the specs have the reference's Space (expanded in the same order,
    full and smoke), result columns, primary metric, compare tolerances
    and tags, and the modules its constants and microbatch rule;
  * ``stamp_scaling_metrics`` derives the reference's scaling figures;
  * one ``llm_train`` point (fp32 and int8 grad sync) and its dp2 twin
    through the bench CLI (``--device cpu --power synthetic``): ``ok``
    records carrying every metric of the reference's, a falling loss,
    and the dp2 point ``deferred`` as the reference defers it;
  * the ``resilience`` smoke preset through the CLI in both packages:
    ``ok`` records, ``loss_bitmatch`` 1.0 and the reference's
    ``final_step``, ``restarts``, ``wasted_tokens`` and
    ``schedule_hash`` on every cell.
"""
import pytest
import torch

import repro.bench.workloads  # noqa: F401 - populates the registry
from repro.bench import records as ref_records
from repro.bench import spec as ref_spec
from repro.bench.records import load_records as ref_load_records
from repro.bench.runner import WorkloadRunner as RefRunner
from repro.bench.workloads import llm_train as ref_llm_train
from repro.bench.workloads import resilience as ref_resilience
from repro_torch.bench import cli, records, spec
from repro_torch.bench.records import load_records
from repro_torch.bench.workloads import llm_train, resilience

torch.set_num_threads(1)

NAMES = ["llm_train", "resilience"]


@pytest.mark.parametrize("name", NAMES)
def test_spec_matches_reference(name):
    ref, got = ref_spec.get_workload(name), spec.get_workload(name)
    assert dict(got.space.axes) == dict(ref.space.axes)
    for smoke in (False, True):
        assert got.space_for(smoke).expand() == ref.space_for(smoke).expand()
    assert got.smoke_axes == ref.smoke_axes
    assert got.result_columns == ref.result_columns
    assert got.primary_metric == ref.primary_metric
    assert got.compare_tols == ref.compare_tols
    assert got.tags == ref.tags


def test_constants_match_reference():
    assert llm_train.MICROBATCHES == ref_llm_train.MICROBATCHES
    for gb in (1, 2, 6, 8, 16, 24, 64):
        for ndev in (1, 2, 4):
            assert llm_train._microbatches(gb, ndev) == \
                ref_llm_train._microbatches(gb, ndev)
    for name in ("TOTAL_STEPS", "GLOBAL_BATCH", "SEQ", "FAULT_SEED",
                 "MAX_RESTARTS"):
        assert getattr(resilience, name) == getattr(ref_resilience, name)


def test_stamp_scaling_metrics_matches_reference():
    def recs(mod):
        out = []
        for plc, tps, twh in (("dp1", 100.0, 50.0), ("dp2", 150.0, 40.0),
                              ("dp4", 240.0, 30.0)):
            out.append(mod.ResultRecord(
                workload="w", point={"gb": 8, "placement": plc},
                metrics={"tokens_per_s": tps, "tokens_per_wh": twh},
                power_source="synthetic",
                placement={"dp": int(plc[2:])}))
        out.append(mod.ResultRecord(workload="w", point={"gb": 16,
                                                         "placement": "dp2"},
                                    status="deferred",
                                    placement={"dp": 2}))
        return out

    got, want = recs(records), recs(ref_records)
    records.stamp_scaling_metrics(got)
    ref_records.stamp_scaling_metrics(want)
    assert [r.metrics for r in got] == [r.metrics for r in want]
    assert got[1].metrics["scaling_efficiency"] == 0.75


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The llm_train point and the resilience smoke preset through both
    packages."""
    out = {}
    tmp = tmp_path_factory.mktemp("train_bench")
    pts = {"llm_train": {"global_batch": [8], "seq": [32],
                         "placement": ["dp1", "dp2"],
                         "grad_sync": ["fp32", "int8"]},
           "resilience": None}
    for name in NAMES:
        RefRunner(ref_spec.get_workload(name), out_dir=str(tmp / "ref"),
                  power="synthetic", smoke=True, iters=2,
                  point_overrides=pts[name]).run(verbose=False)
        argv = ["run", "--suite", name, "--smoke", "--device", "cpu",
                "--power", "synthetic", "--iters", "2", "--out",
                str(tmp / "port"), "--quiet"]
        if pts[name]:
            argv += ["--points", ",".join(f"{k}={v}" for k, vs in
                                          pts[name].items() for v in vs)]
        rc = cli.main(argv)
        out[name] = (rc, ref_load_records(tmp / "ref" / name /
                                          "results.json"),
                     load_records(tmp / "port" / name / "results.json"))
    return out


def test_llm_train_point_holds_the_reference(runs):
    rc, ref_recs, recs = runs["llm_train"]
    assert rc == 0
    assert [r.point for r in recs] == [r.point for r in ref_recs]
    # the reference's process holds one device and defers dp2; the port
    # runs it in two gloo ranks
    assert [r.status for r in ref_recs] == ["ok", "ok", "deferred",
                                            "deferred"]
    assert [r.status for r in recs] == ["ok"] * 4
    for ref, rec in zip(ref_recs[:2] * 2, recs):
        assert rec.power_source == "synthetic"
        missing = set(ref.metrics) - set(rec.metrics)
        assert not missing, missing
        m = rec.metrics
        assert m["model_scale"] == "reduced" and m["n_params"] > 0
        assert m["tok_s_per_device"] == m["tokens_per_s"] / rec.n_devices > 0
        assert m["loss_last"] < m["loss_first"]
        assert m["microbatches"] == 4 and "peak_mem_gb" not in m
        assert all(c in rec.flat() for c in spec.get_workload(
            "llm_train").result_columns if c in ref.flat())


def test_resilience_smoke_holds_the_reference(runs):
    rc, ref_recs, recs = runs["resilience"]
    assert rc == 0
    assert [r.point for r in recs] == [r.point for r in ref_recs]
    for ref, rec in zip(ref_recs, recs):
        assert rec.status == "ok" == ref.status
        assert rec.metrics["loss_bitmatch"] == 1.0 == \
            ref.metrics["loss_bitmatch"]
        for key in ("final_step", "restarts", "wasted_tokens",
                    "tokens_per_step", "ckpt_fallbacks", "schedule_hash"):
            assert rec.metrics[key] == ref.metrics[key], key
        assert not set(ref.metrics) - set(rec.metrics)
        assert rec.metrics["model_scale"] == "reduced"
    crash = [r for r in recs if r.point["fault_preset"] == "crash_mid"]
    assert crash and crash[0].metrics["restarts"] >= 1
