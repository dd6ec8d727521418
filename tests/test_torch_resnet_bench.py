"""The port's ``resnet50`` workload against ``repro``'s, on the CPU, where
both train the reference's reduced cell
(``CONFIG.reduced(img_size=64, width=16)``, bf16):

  * the spec has the reference's Space (expanded in the same order, full
    and smoke), smoke preset, result columns, primary metric, compare
    tolerances and tags, and is the only ``vision`` workload in both;
  * the smoke preset through both packages' runners (the port's through
    its CLI, ``--device cpu --power synthetic``): the dp1 point ``ok``
    with every metric of the reference's record, the reference's
    ``n_params``, a falling loss, ``model_scale=reduced``; the dp2 point
    ``deferred`` as the reference defers it;
  * one cell of the port's workload trained from the reference's
    weights (bridged) against the reference's jitted step on the same
    batch: the first measured loss within ``LOSS_RTOL``.
"""
import jax
import numpy as np
import pytest
import torch

import repro.bench.workloads  # noqa: F401 - populates the registry
from repro.bench import spec as ref_spec
from repro.bench.records import load_records as ref_load_records
from repro.bench.runner import WorkloadRunner as RefRunner
from repro.bench.workloads import resnet50 as ref_resnet50
from repro.data.synthetic import synthetic_images
from repro.train.step import make_resnet_train_step as ref_make_step
from repro_torch import bridge
from repro_torch.bench import cli, spec
from repro_torch.bench.context import RunContext
from repro_torch.bench.records import load_records
from repro_torch.bench.workloads import resnet50
from repro_torch.core import tree

torch.set_num_threads(1)

#: the first measured loss (after one warmup step) of the port's bf16
#: step against the reference's on the same weights and batch: both
#: compute in bf16 with fp32 BN and loss, and round activations at
#: different points of their fused graphs, so a few bf16 ulps (2**-8
#: each) part them through 16 conv layers (measured 1.2e-3; the test
#: prints both losses with ``-s``)
LOSS_RTOL = 1e-2


@pytest.fixture(scope="module")
def ref_state():
    """The reference workload's ``(config, opt config, params,
    opt_state)``, its ``_base_state`` run under ``jax.jit`` (eager, its
    init dispatches every draw on its own and takes ~10 s)."""
    box = {}
    ctx = type("Ctx", (), {"memo": staticmethod(lambda key, make: make())})

    def arrays():
        box["c"], box["oc"], p, o = ref_resnet50._base_state(ctx)
        return p, o

    p, o = jax.jit(arrays)()
    return box["c"], box["oc"], p, o


def test_spec_matches_reference():
    ref, got = ref_spec.get_workload("resnet50"), spec.get_workload("resnet50")
    assert dict(got.space.axes) == dict(ref.space.axes)
    for smoke in (False, True):
        assert got.space_for(smoke).expand() == ref.space_for(smoke).expand()
    assert got.smoke_axes == ref.smoke_axes
    assert got.result_columns == ref.result_columns
    assert got.primary_metric == ref.primary_metric
    assert got.compare_tols == ref.compare_tols
    assert got.tags == ref.tags
    assert got.analog == ref.analog
    assert [s.name for s in spec.iter_workloads(tags=["vision"])] == \
        [s.name for s in ref_spec.iter_workloads(tags=["vision"])] == \
        ["resnet50"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The smoke preset through both packages."""
    tmp = tmp_path_factory.mktemp("resnet_bench")
    RefRunner(ref_spec.get_workload("resnet50"), out_dir=str(tmp / "ref"),
              power="synthetic", smoke=True, iters=2).run(verbose=False)
    rc = cli.main(["run", "--suite", "resnet50", "--smoke", "--device", "cpu",
                   "--power", "synthetic", "--iters", "2", "--out",
                   str(tmp / "port"), "--quiet"])
    return (rc, ref_load_records(tmp / "ref" / "resnet50" / "results.json"),
            load_records(tmp / "port" / "resnet50" / "results.json"))


def test_smoke_records_hold_the_reference(runs, ref_state):
    rc, ref_recs, recs = runs
    assert rc == 0
    assert [r.point for r in recs] == [r.point for r in ref_recs]
    assert [r.status for r in recs] == ["ok", "deferred"]
    ref_ok = [r for r in ref_recs if r.ok]
    assert ref_ok, [r.error for r in ref_recs]
    ref_n = sum(x.size for x in jax.tree.leaves(ref_state[2]))
    for rec in recs:
        if rec.status == "deferred":
            assert "Queue 1 item 8" in rec.error and rec.n_devices == 2
            continue
        missing = set(ref_ok[0].metrics) - set(rec.metrics)
        assert not missing, missing
        m = rec.metrics
        assert rec.power_source == "synthetic"
        assert m["model_scale"] == "reduced"
        assert m["n_params"] == ref_n
        assert m["tok_s_per_device"] == m["images_per_s"] > 0
        assert m["images_per_wh"] > 0
        assert m["loss_last"] < m["loss_first"]
        assert "peak_mem_gb" not in m and "model_flop_share" not in m
        assert all(c in rec.flat() for c in spec.get_workload(
            "resnet50").result_columns if c in ref_ok[0].flat())


def test_first_loss_matches_the_reference_on_its_weights(ref_state):
    """The port's cell, handed the reference's state, against the
    reference's jitted step on the same batch."""
    rc, roc, rp, ro = ref_state
    gb = 8
    imgs, labels = synthetic_images(gb, rc.img_size, rc.n_classes)
    step = jax.jit(ref_make_step(rc, roc))
    want = []
    p_, o_ = rp, ro
    for _ in range(2):                   # warmup, then the first measured
        p_, o_, m = step(p_, o_, {"images": imgs, "labels": labels})
        want.append(float(m["loss"]))
    ctx = RunContext(device=torch.device("cpu"), warmup=1, iters=2)
    c, oc, *_ = resnet50.base_state(ctx)
    np_tree = jax.tree.map(np.asarray, (rp, ro))
    params, opt_state = bridge.train_state_from_numpy(*np_tree,
                                                      device="cpu")
    ctx.cache["resnet50"] = (c, oc, params, opt_state, "reduced",
                             sum(t.numel() for t in tree.leaves(params)))
    out = spec.get_workload("resnet50").build(
        {"global_batch": gb, "placement": "dp1"}, ctx)["train"]()
    print(f"\nport loss_first {out['loss_first']:.6f}, reference "
          f"{want[1]:.6f}")
    np.testing.assert_allclose(out["loss_first"], want[1], rtol=LOSS_RTOL)
    assert out["loss_last"] < out["loss_first"]
