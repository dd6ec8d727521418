"""The port's comparison engine (``repro_torch.bench.compare``) and its
``compare`` command against the reference's, on the same record sets.

The cases of ``tests/test_bench_compare.py``, as parameters: each builds
its baseline and current sets once per package from one description,
and both engines must give the same points, verdicts, notes, deltas,
tolerances, exit codes under every gate and the same reports;
``diff_metric`` and ``effective_tolerance`` agree case by case;
``promote`` writes the reference's baseline layout (the same documents,
byte for byte) and ``load_result_set`` reads each layout alike; the
``compare`` command gives the reference's exit code, report and gate
lines; the runner stamps a workload's ``compare_tols`` into its records
as the reference's does.
"""
import json
import math

import pytest
import torch

from repro.bench import compare as ref_compare
from repro.bench import records as ref_records
from repro.bench.cli import _parse_tols as ref_parse_tols
from repro.bench.cli import main as ref_main
from repro.bench.runner import WorkloadRunner as RefRunner
from repro.bench.spec import Space as RefSpace
from repro.bench.spec import WorkloadSpec as RefSpec
from repro_torch.bench import cli, compare, records
from repro_torch.bench.runner import WorkloadRunner
from repro_torch.bench.spec import Space, WorkloadSpec

PACKAGES = {"ref": (ref_records, ref_compare), "port": (records, compare)}
INF, NAN = float("inf"), float("nan")


def rec(mod, workload="w", point=None, metrics=None, power="synthetic",
        rel_std=0.0, tols=None, **kw):
    noise = {"rel_std": rel_std}
    if tols is not None:
        noise["tols"] = tols
    return mod.ResultRecord(
        workload=workload, point=point or {"bs": 8},
        metrics=metrics if metrics is not None else {"tokens_per_s": 100.0},
        power_source=power, noise=noise, **kw)


#: name -> (baseline, current, compare_sets kwargs); each record a dict
#: of ``rec`` arguments
CASES = {
    "classification": (
        [dict(point={"bs": b}) for b in (1, 2, 3, 4)],
        [dict(point={"bs": 1}, metrics={"tokens_per_s": 50.0}),
         dict(point={"bs": 2}, metrics={"tokens_per_s": 200.0}),
         dict(point={"bs": 3}, metrics={"tokens_per_s": 101.0}),
         dict(point={"bs": 5}, metrics={"tokens_per_s": 1.0})], {}),
    "lower_is_better": (
        [dict(metrics={"seconds": 1.0, "wh_per_token": 1.0})],
        [dict(metrics={"seconds": 2.0, "wh_per_token": 0.2})], {}),
    "current_error": (
        [dict()], [dict(metrics={}, status="error", error="OOM")], {}),
    "baseline_error": (
        [dict(metrics={}, status="error", error="OOM")], [dict()], {}),
    "skipped": ([dict()], [dict(metrics={}, status="skipped")], {}),
    "deferred": ([dict()], [dict(metrics={}, status="deferred",
                                 error="mesh dp2 needs 2 devices")], {}),
    "additional_power": (
        [dict(power="synthetic")],
        [dict(power="synthetic"),
         dict(power="rapl", metrics={"tokens_per_s": 90.0})], {}),
    "dual_power_baseline": (
        [dict(power="synthetic"), dict(power="rapl")],
        [dict(power="synthetic")], {}),
    "sanitized_note": (
        [dict()],
        [dict(metrics={}, status="error",
              error="RESOURCE_EXHAUSTED\nOut of memory, pipe | char")], {}),
    "error_under_power_mismatch": (
        [dict(power="synthetic")],
        [dict(power="rapl", metrics={}, status="error", error="crash!")],
        {}),
    "power_mismatch": (
        [dict(power="rapl")],
        [dict(power="synthetic", metrics={"tokens_per_s": 1.0})], {}),
    "unknown_metrics": (
        [dict(metrics={"n_rows": 10, "tokens_per_s": 100.0})],
        [dict(metrics={"n_rows": 3, "tokens_per_s": 100.0})], {}),
    "lost_metric": (
        [dict(metrics={"tokens_per_s": 100.0, "wh_per_token": 1.0})],
        [dict(metrics={"tokens_per_s": 100.0})], {}),
    "new_point_errors": (
        [dict()],
        [dict(point={"bs": 9}, metrics={}, status="error", error="OOM")],
        {}),
    "saturated_collapse": (
        [dict(rel_std=1.0)],
        [dict(metrics={"tokens_per_s": 10.0}, rel_std=1.0)],
        {"tols": {"default": 0.6}}),
    "saturated_halved": (
        [dict(rel_std=1.0)],
        [dict(metrics={"tokens_per_s": 50.0}, rel_std=1.0)],
        {"tols": {"default": 0.6}}),
    "quiet_drop": (
        [dict()], [dict(metrics={"tokens_per_s": 70.0})], {}),
    "noisy_drop": (
        [dict()], [dict(metrics={"tokens_per_s": 70.0}, rel_std=0.15)],
        {}),
    "noisy_baseline": (
        [dict(rel_std=0.15)], [dict(metrics={"tokens_per_s": 70.0})], {}),
    "noise_k_zero": (
        [dict()], [dict(metrics={"tokens_per_s": 70.0}, rel_std=0.15)],
        {"noise_k": 0.0}),
    "declared_tols": (
        [dict(metrics={"us": 100.0}, tols={"default": "inf"})],
        [dict(metrics={"us": 900.0}, tols={"default": "inf"})], {}),
    "declared_tols_cli_default": (
        [dict(metrics={"us": 100.0}, tols={"default": "inf"})],
        [dict(metrics={"us": 900.0}, tols={"default": "inf"})],
        {"tols": {"default": 0.5}}),
    "declared_tols_cli_metric": (
        [dict(metrics={"us": 100.0}, tols={"default": "inf"})],
        [dict(metrics={"us": 900.0}, tols={"default": "inf"})],
        {"tols": {"us": 0.5}}),
    "degenerate_values": (
        [dict(point={"bs": b}, metrics=m) for b, m in enumerate([
            {"wh_per_token": 0.5}, {"seconds": 1.0},
            {"tokens_per_s": 100.0}, {"wh_per_slo_request": INF},
            {"wh_per_slo_request": 0.5}, {"wh_per_slo_request": INF},
            {"tokens_per_s": 0.0}, {"seconds": 0.0}])],
        [dict(point={"bs": b}, metrics=m) for b, m in enumerate([
            {"wh_per_token": 0.0}, {"seconds": 0.0},
            {"tokens_per_s": NAN}, {"wh_per_slo_request": INF},
            {"wh_per_slo_request": INF}, {"wh_per_slo_request": -INF},
            {"tokens_per_s": 5.0}, {"seconds": 5.0}])], {}),
    "multi_workload_placements": (
        [dict(workload="wa", point={"gb": 16}, placement={"dp": 1}),
         dict(workload="wa", point={"gb": 16}, placement={"dp": 2}),
         dict(workload="wb", point={"n": 1}, metrics={"images_per_s": 9.0})],
        [dict(workload="wa", point={"gb": 16}, placement={"dp": 1},
              metrics={"tokens_per_s": 130.0}),
         dict(workload="wa", point={"gb": 16}, placement={"dp": 2},
              metrics={"tokens_per_s": 80.0}, rel_std=0.05),
         dict(workload="wb", point={"n": 1},
              metrics={"images_per_s": 9.5, "images_per_wh": 1.0})], {}),
}


def _sets(name):
    base, cur, kw = CASES[name]
    return {pkg: ([rec(mod, **b) for b in base], [rec(mod, **c) for c in cur],
                  kw) for pkg, (mod, _cmp) in PACKAGES.items()}


def _view(cmp):
    """Everything a comparison says, NaN-safe for ``==``."""
    def num(x):
        return "nan" if isinstance(x, float) and math.isnan(x) else x

    return [(p.key, p.workload, p.point, p.power_source, p.status, p.note,
             [(d.metric, num(d.base), num(d.current), num(d.rel_delta),
               d.tolerance, d.status, d.pct) for d in p.deltas])
            for p in cmp.points]


@pytest.mark.parametrize("name", sorted(CASES))
def test_compare_sets_gives_the_reference_verdicts(name):
    got = {}
    for pkg, (base, cur, kw) in _sets(name).items():
        cmp = PACKAGES[pkg][1].compare_sets(base, cur, **kw)
        got[pkg] = (_view(cmp), cmp.counts(), cmp.summary(),
                    [cmp.exit_code(fail_on_regression=r, fail_on_missing=m)
                     for r in (False, True) for m in (False, True)],
                    cmp.to_markdown(), cmp.to_markdown(all_points=True),
                    cmp.to_csv())
    assert got["port"] == got["ref"]
    assert got["port"][0], name            # every case compares something


@pytest.mark.parametrize("metric, base, cur, tol", [
    ("tokens_per_s", 0.0, 0.0, 0.1), ("tokens_per_s", 0.0, 5.0, 0.1),
    ("seconds", 0.0, 5.0, 0.1), ("wh_per_token", 0.5, 0.0, 0.25),
    ("seconds", 1.0, 0.0, 0.2), ("tokens_per_s", 100.0, NAN, 0.2),
    ("tokens_per_s", 100.0, INF, 0.2), ("wh_per_token", NAN, 0.5, 0.2),
    ("us", 100.0, NAN, INF), ("us", 100.0, 0.0, INF),
    ("tokens_per_s", 100.0, 0.0, 0.2), ("wh_per_slo_request", INF, INF, 0.2),
    ("wh_per_slo_request", INF, -INF, 0.2), ("images_per_s", 10.0, 7.0, 0.2),
    ("images_per_wh", 10.0, 14.0, 0.2), ("ms_per_step", -1.0, 1.0, 0.2),
])
def test_diff_metric_matches_reference(metric, base, cur, tol):
    want = ref_compare.diff_metric(metric, base, cur, tol)
    got = compare.diff_metric(metric, base, cur, tol)
    assert (got.status, got.pct, got.tolerance) == \
        (want.status, want.pct, want.tolerance)
    assert got.rel_delta == want.rel_delta or (
        math.isnan(got.rel_delta) and math.isnan(want.rel_delta))


@pytest.mark.parametrize("base_std, cur_std, tols, noise_k", [
    (0.0, 5.0, None, 2.0), (0.0, 0.0, {"tokens_per_s": 0.05}, 2.0),
    (0.0, 0.0, {"default": 0.33}, 2.0), (0.1, 0.02, None, 1.0),
])
def test_effective_tolerance_matches_reference(base_std, cur_std, tols,
                                               noise_k):
    got = [compare.effective_tolerance(
        "tokens_per_s", rec(records, rel_std=base_std),
        rec(records, rel_std=cur_std), tols=tols, noise_k=noise_k)]
    want = [ref_compare.effective_tolerance(
        "tokens_per_s", rec(ref_records, rel_std=base_std),
        rec(ref_records, rel_std=cur_std), tols=tols, noise_k=noise_k)]
    assert got == want
    assert records.COMPARED_METRICS == ref_records.COMPARED_METRICS


def test_promote_writes_the_reference_layout(tmp_path):
    def recs(mod):
        return [rec(mod, workload="wa", point={"bs": b}) for b in (1, 2)] + \
            [rec(mod, workload="wb", point={"n": 1},
                 metrics={"seconds": 0.5}),
             rec(mod, workload="wb", point={"n": 2}, status="error",
                 error="x", metrics={})]

    written = {}
    for pkg, (mod, cmp) in PACKAGES.items():
        store = tmp_path / pkg / "baselines"
        written[pkg] = [p.relative_to(store) for p in
                        cmp.promote(recs(mod), store)]
        # every layout compare accepts reads the same records
        mod.save_records(recs(mod)[:1], tmp_path / pkg / "run" / "wa")
        for where in ("baselines", "baselines/wa.json", "run", "run/wa",
                      "run/wa/results.json", "missing"):
            got = cmp.load_result_set(tmp_path / pkg / where)
            written[pkg, where] = [r.to_dict() for r in got]
    assert written["port"] == written["ref"]
    assert [str(p) for p in written["port"]] == ["wa.json", "wb.json"]
    for name in ("wa.json", "wb.json"):
        assert (tmp_path / "port" / "baselines" / name).read_text() == \
            (tmp_path / "ref" / "baselines" / name).read_text()
    for where in ("baselines", "run"):
        assert written["port", where] == written["ref", where]


def _save(mod, path, specs):
    mod.save_records([rec(mod, **s) for s in specs], path)


#: name -> (runs: dir -> [(workload subdir, [rec args])], compare argv
#: lists run in order, with {dir} placeholders)
CLI_CASES = {
    "gate_on_regression": (
        {"base": [{"workload": "wa", "point": {"bs": 1}}],
         "good": [{"workload": "wa", "point": {"bs": 1},
                   "metrics": {"tokens_per_s": 98.0}}],
         "bad": [{"workload": "wa", "point": {"bs": 1},
                  "metrics": {"tokens_per_s": 40.0}}]},
        [["{base}", "{good}", "--fail-on-regression"],
         ["{base}", "{bad}", "--fail-on-regression"],
         ["{base}", "{bad}"]]),
    "promote_and_reports": (
        {"run": [{"workload": "wa", "point": {"bs": 1}}],
         "mild": [{"workload": "wa", "point": {"bs": 1},
                   "metrics": {"tokens_per_s": 90.0}}]},
        [["{store}", "{run}", "--promote"],
         ["{store}", "{run}", "--fail-on-regression", "--fail-on-missing"],
         ["{store}", "{run}", "--report", "csv", "--all-points"],
         ["{store}", "{mild}", "--fail-on-regression", "--rel-tol",
          "tokens_per_s=0.01", "--noise-k", "0"]]),
    "empty_current": (
        {"base": [{"workload": "wa", "point": {"bs": 1}}]},
        [["{base}", "{typo}", "--fail-on-regression"]]),
    "promote_all_error": (
        {"good": [{"workload": "wa", "point": {"bs": 1}}],
         "broken": [{"workload": "wa", "point": {"bs": 1}, "metrics": {},
                     "status": "error", "error": "boom"}]},
        [["{store}", "{good}", "--promote"],
         ["{store}", "{broken}", "--promote"]]),
    "stale_baseline": (
        {"old": [{"workload": "wa", "point": {"bs": 1}}],
         "renamed": [{"workload": "wb", "point": {"bs": 1}}]},
        [["{store}", "{old}", "--promote"],
         ["{store}", "{renamed}", "--promote"]]),
    "missing_gate": (
        {"base": [{"workload": "wa", "point": {"bs": 1}},
                  {"workload": "wa", "point": {"bs": 2}}],
         "cur": [{"workload": "wa", "point": {"bs": 1},
                  "metrics": {"tokens_per_s": 10.0}}]},
        [["{base}", "{cur}"], ["{base}", "{cur}", "--fail-on-missing"],
         ["{base}", "{cur}", "--fail-on-regression"],
         ["{base}", "{cur}", "--suite", "wa", "--report", "csv"]]),
}


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_compare_command_matches_reference(name, tmp_path, capsys):
    runs, calls = CLI_CASES[name]
    mains = {"ref": ref_main, "port": cli.main}
    got = {}
    for pkg, (mod, _cmp) in PACKAGES.items():
        root = tmp_path / pkg
        dirs = {"store": root / "store", "typo": root / "typo"}
        for run, specs in runs.items():
            dirs[run] = root / run
            for s in specs:
                _save(mod, root / run / s["workload"], [s])
        out = []
        for argv in calls:
            rc = mains[pkg](["compare"] + [a.format(**dirs) for a in argv])
            cap = capsys.readouterr()
            # the directories differ by package: compare the text with
            # each package's root taken out
            out.append((rc, cap.out.replace(str(root), "ROOT"),
                        cap.err.replace(str(root), "ROOT")))
        got[pkg] = out
        got[pkg, "store"] = sorted(
            (p.name, p.read_text()) for p in dirs["store"].glob("*.json"))
    assert got["port"] == got["ref"]
    assert got["port", "store"] == got["ref", "store"]


def test_parse_tols_matches_reference():
    for s in ("default=0", "tokens_per_s=0.1,default=0.3", None):
        assert cli._parse_tols(s) == ref_parse_tols(s)
    for mine, theirs in ((cli._parse_tols, ref_parse_tols),):
        for bad in ("default=-1", "oops", "x=abc"):
            with pytest.raises(SystemExit) as a:
                mine(bad)
            with pytest.raises(SystemExit) as b:
                theirs(bad)
            assert str(a.value) == str(b.value)


def test_runner_stamps_declared_tolerances_as_the_reference(tmp_path):
    def build(pt, ctx):
        return {"run": lambda: {"us": 100.0}}

    tols = {"default": INF, "ttft_s": 2.0}
    (got,) = WorkloadRunner(
        WorkloadSpec(name="toy_tols_port", analog="toy",
                     space=Space({"x": [1]}), build=build,
                     compare_tols=tols),
        device=torch.device("cpu"), out_dir=str(tmp_path),
        power="none").run(verbose=False)
    (want,) = RefRunner(
        RefSpec(name="toy_tols_ref", analog="toy",
                space=RefSpace({"x": [1]}), build=build, compare_tols=tols),
        out_dir=str(tmp_path), power="none").run(verbose=False)
    assert got.noise["tols"] == want.noise["tols"] == \
        {"default": "inf", "ttft_s": 2.0}
    # the stamped document stays RFC JSON and reads back
    text = (tmp_path / "toy_tols_port" / "results.json").read_text()
    json.loads(text, parse_constant=lambda c: (_ for _ in ()).throw(
        ValueError(c)))
    (back,) = records.load_records(tmp_path / "toy_tols_port" /
                                   "results.json")
    slow = records.ResultRecord(workload="toy_tols_port", point={"x": 1},
                                metrics={"us": 900.0}, power_source="none",
                                noise=dict(back.noise))
    assert compare.compare_sets([back], [slow]).points[0].status == \
        compare.UNCHANGED
