"""The port's ``serve`` and ``serve_slo`` workloads against ``repro``'s.

On the CPU, where both run the reduced model:

  * the specs have the reference's Space (expanded in the same order,
    full and smoke), result columns, primary metric, compare tolerances
    and tags;
  * ``serve.traffic`` gives the reference's traces (``trace_hash`` and
    every request) for every preset, and ``serve.slo.evaluate_slo`` and
    ``stream_agreement`` the reference's figures on the same results;
  * one point of each workload, through the bench CLI with a handful of
    requests (the request count is patched in both packages, in this
    test only), writes an ``ok`` record carrying every metric the
    reference's record of that point carries, with equal ``n_tokens``,
    ``n_requests`` and, for ``serve_slo``, ``trace_hash``; and says which
    model scale and depth ran;
  * ``run --layers N`` serves the model's first N layers at its width.
"""
import dataclasses
import math

import pytest
import torch

import repro.bench.workloads  # noqa: F401 - populates the registry
from repro.bench import spec as ref_spec
from repro.bench.records import load_records as ref_load_records
from repro.bench.runner import WorkloadRunner as RefRunner
from repro.bench.workloads import serve as ref_serve_wl
from repro.bench.workloads import serve_slo as ref_slo_wl
from repro.serve import requests as ref_requests
from repro.serve import slo as ref_slo
from repro.serve import traffic as ref_traffic
from repro_torch.bench import cli
from repro_torch.bench import spec
from repro_torch.bench.context import RunContext
from repro_torch.configs import get_config
from repro_torch.bench.records import load_records
from repro_torch.bench.workloads import serve as serve_wl
from repro_torch.bench.workloads import serve_slo as slo_wl
from repro_torch.serve import requests, slo, traffic

torch.set_num_threads(1)

NAMES = ["serve", "serve_slo"]
SCALING = {"tok_s_per_device", "scaling_efficiency", "wh_per_token_scaling"}
#: one point per workload: the main-path cell, and the prefix-cache cell
#: whose hits run the paged prefill op
POINTS = {
    "serve": {"cache": ["paged"], "policy": ["continuous"],
              "sched": ["phased"], "kv_dtype": ["fp32"]},
    "serve_slo": {"trace": ["shared_prefix"], "cache": ["paged+prefix"],
                  "sched": ["phased"], "kv_dtype": ["fp32"]},
}


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
    for ref_mod, mod in ((ref_serve_wl, serve_wl), (ref_slo_wl, slo_wl)):
        for name in ("MAX_LEN", "BLOCK_SIZE", "N_REQUESTS",
                     "N_REQUESTS_SMOKE", "SEED"):
            assert getattr(mod, name) == getattr(ref_mod, name), name
    assert serve_wl.PROMPT_LEN == ref_serve_wl.PROMPT_LEN == 8
    assert slo_wl.N_SLOTS == ref_slo_wl.N_SLOTS
    assert slo_wl.POOL_BY_TRACE == ref_slo_wl.POOL_BY_TRACE == {
        "long_prefill": 17}
    for name in ("SLO_TIGHT", "SLO_RELAXED"):
        assert dataclasses.asdict(getattr(slo_wl, name)) == \
            dataclasses.asdict(getattr(ref_slo_wl, name))
    assert {k: dataclasses.asdict(v) for k, v in
            slo_wl.SLO_BY_TENANT.items()} == {
        k: dataclasses.asdict(v) for k, v in
        ref_slo_wl.SLO_BY_TENANT.items()}


@pytest.mark.parametrize("trace", ref_traffic.TRACE_NAMES)
def test_traffic_presets_match_reference(trace):
    assert traffic.TRACE_NAMES == ref_traffic.TRACE_NAMES
    ref_cfg = ref_traffic.preset_trace(trace, n_requests=40, vocab=512,
                                       seed=3)
    cfg = traffic.preset_trace(trace, n_requests=40, vocab=512, seed=3)
    assert cfg.config_hash() == ref_cfg.config_hash()
    want, got = ref_traffic.generate_trace(ref_cfg), traffic.generate_trace(cfg)
    assert len(got) == len(want) == 40
    for a, b in zip(got, want):
        assert (a.rid, list(a.prompt), a.max_new_tokens, a.arrival_s,
                a.tenant) == (b.rid, list(b.prompt), b.max_new_tokens,
                              b.arrival_s, b.tenant)


def _results(module):
    """A fixed result set: tenants, a shed request, a one-token one."""
    out = []
    for i in range(12):
        r = module.RequestResult(rid=i, prompt_len=4, tenant=("ab"[i % 2]
                                                               + "x"))
        r.arrival_s = 0.1 * i
        r.first_token_s = r.arrival_s + 0.05 * (i % 5 + 1)
        r.tokens = list(range(1 + i % 4))
        r.finish_s = r.first_token_s + 0.03 * (i % 3 + 1) * len(r.tokens)
        r.finish_reason = "shed" if i == 7 else "length"
        r.energy_wh = 1e-4 * (i + 1)
        out.append(r)
    return out


def test_evaluate_slo_and_stream_agreement_match_reference():
    targets = {"ax": (0.2, 0.05)}
    for default in ((0.3, 0.1), (0.1, 0.02)):
        want = ref_slo.evaluate_slo(
            _results(ref_requests),
            {k: ref_slo.SLO(*v) for k, v in targets.items()},
            default=ref_slo.SLO(*default))
        got = slo.evaluate_slo(
            _results(requests), {k: slo.SLO(*v) for k, v in targets.items()},
            default=slo.SLO(*default))
        for report_got, report_want in [(got, want)] + [
                (got.per_tenant[k], want.per_tenant[k])
                for k in want.per_tenant]:
            a = dataclasses.asdict(report_got)
            b = dataclasses.asdict(report_want)
            a.pop("per_tenant"), b.pop("per_tenant")
            assert a == b
            assert report_got.goodput == report_want.goodput
            assert report_got.wh_per_slo_request == \
                report_want.wh_per_slo_request or (
                    math.isinf(report_got.wh_per_slo_request)
                    and math.isinf(report_want.wh_per_slo_request))
    a = {0: (1, 2, 3, 4), 1: (5, 6), 2: (7,)}
    b = {0: (1, 2, 9, 4), 1: (5, 6, 8), 3: (1,)}
    assert serve_wl.stream_agreement(a, b) == \
        ref_serve_wl.stream_agreement(a, b)


@pytest.fixture(scope="module")
def one_point_runs(tmp_path_factory):
    """Each workload's point through both packages, 8 requests each."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for mod in (serve_wl, slo_wl, ref_serve_wl, ref_slo_wl):
            mp.setattr(mod, "N_REQUESTS_SMOKE", 8)
        for name in NAMES:
            tmp = tmp_path_factory.mktemp(name)
            RefRunner(ref_spec.get_workload(name), out_dir=str(tmp / "ref"),
                      power="synthetic", smoke=True,
                      point_overrides=POINTS[name]).run(verbose=False)
            pts = ",".join(f"{k}={v[0]}" for k, v in POINTS[name].items())
            rc = cli.main(["run", "--suite", name, "--smoke", "--points",
                           pts, "--device", "cpu", "--power", "synthetic",
                           "--out", str(tmp / "port"), "--quiet"])
            out[name] = (rc, ref_load_records(tmp / "ref" / name /
                                              "results.json"),
                         load_records(tmp / "port" / name / "results.json"))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", NAMES)
def test_one_point_cpu_run_holds_the_reference(one_point_runs, name):
    rc, ref_records, records = one_point_runs[name]
    assert rc == 0
    assert len(records) == len(ref_records) == 1
    ref, rec = ref_records[0], records[0]
    assert rec.status == "ok" == ref.status
    assert rec.point == ref.point
    assert rec.power_source == "synthetic"
    # the reference's runner stamps cross-placement scaling figures
    # (records.stamp_scaling_metrics), which wait for the port's
    # multi-device item; every metric of the workload itself is there
    missing = set(ref.metrics) - set(rec.metrics) - SCALING
    assert not missing, missing
    for key in ("n_tokens", "n_requests", "pool_bytes", "max_concurrency"):
        assert rec.metrics[key] == ref.metrics[key], key
    if name == "serve_slo":
        assert rec.metrics["trace_hash"] == ref.metrics["trace_hash"]
        assert rec.metrics["prefix_hit_requests"] > 0
    assert rec.metrics["model_scale"] == "reduced"
    assert rec.metrics["n_params"] > 0
    assert rec.metrics["n_layers"] == \
        get_config("llama3.2-3b").reduced().n_layers
    # on the CPU the kernel ops run their plain versions: no launch
    assert rec.metrics["decode_launches"] == 0
    assert rec.metrics["decode_micro_steps"] > 0
    flat = rec.flat()
    present = [c for c in spec.get_workload(name).result_columns
               if c in ref.flat()]
    assert all(c in flat for c in present)


@pytest.mark.parametrize("layers", [None, 1])
def test_layers_cut_the_served_model_to_its_first_layers(layers):
    """``bench run --layers N`` (``RunContext.layers``): the served
    config keeps every width and has N layers; on the CPU the scale
    stays ``reduced``."""
    ctx = RunContext(device=torch.device("cpu"), layers=layers)
    c, params, scale, n_params = serve_wl.model(ctx, "llama3.2-3b")
    full = get_config("llama3.2-3b").reduced()
    assert dataclasses.replace(c, n_layers=full.n_layers) == full
    assert c.n_layers == (layers or full.n_layers)
    assert scale == "reduced"
    stacked = params["layers"]["slot0"]["attn"]["wq"]
    assert stacked.shape[0] == c.n_layers
    assert n_params == sum(t.numel() for t in serve_wl._leaves(params))
