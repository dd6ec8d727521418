"""``python -m repro_torch.bench`` — the port's benchmark CLI.

  python -m repro_torch.bench list [--suite a,b] [--tags t1,t2]
  python -m repro_torch.bench run [--suite a,b] [--tags smoke] [--smoke]
                            [--points k=v,...]
                            [--power auto|nvml|synthetic|none]
                            [--warmup N] [--iters N] [--retries N]
                            [--out DIR] [--device cuda|cpu]
                            [--layers N] [--quiet]
  python -m repro_torch.bench report [--suite a,b] [--out DIR]
  python -m repro_torch.bench compare BASELINE CURRENT [--suite a,b]
                            [--rel-tol metric=0.1,...] [--noise-k K]
                            [--fail-on-regression] [--fail-on-missing]
                            [--promote] [--report md|csv]
                            [--report-out PATH] [--all-points]

Port of ``src/repro/bench/cli.py``: ``list``, ``run``, ``report`` and
``compare`` (``bench.compare``: the reference's verdicts, exit codes and
``--promote`` baseline store).
``run`` runs on the card unless given ``--device cpu``
and raises when there is none; ``--smoke`` (or the ``smoke`` tag, as in
the reference) selects each workload's reduced point set. One process
runs every selected workload on one device, so there is no device-count
re-exec.

Each record also prints the classic ``name,us_per_call,derived`` CSV
line. ``run`` ends with ``all benchmarks complete`` and exits non-zero
when a point has status ``error``.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
from typing import Optional, Sequence

from repro_torch.bench import workloads  # noqa: F401 - populates the registry
from repro_torch.bench.compare import (
    MISSING, NOISE_K, POWER_MISMATCH, compare_sets, load_result_set,
    promote,
)
from repro_torch.bench.records import load_records
from repro_torch.bench.runner import WorkloadRunner
from repro_torch.bench.spec import (
    UnknownWorkloadError, get_workload, iter_workloads,
)
from repro_torch.core.results import table
from repro_torch.device import resolve_device
from repro_torch.power.methods import POWER_CHOICES

DEFAULT_OUT = "artifacts/bench_torch"


def _parse_points(s: Optional[str]) -> Optional[dict]:
    """``k=v,k2=v2`` -> axis overrides, values coerced to int/float."""
    if not s:
        return None
    out: dict = {}
    for part in s.split(","):
        if "=" not in part:
            raise SystemExit(f"--points: expected k=v, got {part!r}")
        k, v = part.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out.setdefault(k.strip(), []).append(v)
    return out


def _parse_list(s: Optional[str]) -> Optional[list[str]]:
    return [x.strip() for x in s.split(",") if x.strip()] if s else None


def _select(args) -> list:
    try:
        return iter_workloads(names=_parse_list(args.suite),
                              tags=_parse_list(args.tags))
    except UnknownWorkloadError as e:
        raise SystemExit(f"error: {e}")


def _emit_lines(spec, records) -> None:
    """The classic ``name,us_per_call,derived`` CSV contract."""
    for rec in records:
        if not rec.ok:
            continue
        pt = "/".join(f"{k}={v}" for k, v in rec.point.items())
        us = float(rec.metrics.get("seconds", 0.0)) * 1e6
        derived = ""
        if spec.primary_metric and spec.primary_metric in rec.metrics:
            derived = (f"{spec.primary_metric}="
                       f"{rec.metrics[spec.primary_metric]:.4g}")
        print(f"{spec.name}/{pt},{us:.1f},{derived}")


def _render(spec, records) -> None:
    print(table([r.flat() for r in records], spec.result_columns,
                floatfmt="{:.4g}"))


def cmd_list(args) -> int:
    rows = [{"workload": s.name, "placement": s.placement.label,
             "devices": s.max_devices(),
             "points": len(s.space),
             "tags": ",".join(sorted(s.tags)),
             "paper_analog": s.analog} for s in _select(args)]
    print(table(rows))
    return 0


def cmd_run(args) -> int:
    device = resolve_device(args.device)
    specs = _select(args)
    if not specs:
        print("no workloads selected")
        return 0
    smoke = args.smoke or "smoke" in (_parse_list(args.tags) or [])
    overrides = _parse_points(args.points)
    failures = []
    for spec in specs:
        print(f"\n###### {spec.name} — {spec.analog} ######", flush=True)
        runner = WorkloadRunner(
            spec, device=device, out_dir=args.out, power=args.power,
            warmup=args.warmup, iters=args.iters, smoke=smoke,
            point_overrides=overrides, retries=args.retries,
            layers=args.layers)
        records = runner.run(verbose=args.verbose)
        _render(spec, records)
        _emit_lines(spec, records)
        bad = [r for r in records if r.status == "error"]
        if bad:
            failures.append(spec.name)
            for r in bad:
                print(f"FAILED: {spec.name} {r.point}: {r.error}",
                      file=sys.stderr)
    if failures:
        print(f"\nbenchmark failures: {failures}", file=sys.stderr)
        return 1
    print("\nall benchmarks complete")
    return 0


def cmd_report(args) -> int:
    out = pathlib.Path(args.out)
    names = _parse_list(args.suite) or sorted(
        p.parent.name for p in out.glob("*/results.json"))
    shown, bad = 0, 0
    for name in names:
        path = out / name / "results.json"
        if not path.exists():
            print(f"(no results for {name!r} under {out})")
            continue
        try:
            spec = get_workload(name)
        except UnknownWorkloadError:
            spec = None
        try:
            records = load_records(path)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            bad += 1
            continue
        print(f"\n###### {name} ######")
        if spec is not None:
            _render(spec, records)
        else:
            print(table([r.flat() for r in records], floatfmt="{:.4g}"))
        shown += 1
    if bad:
        return 2
    return 0 if shown or not names else 1


def _parse_tols(s: Optional[str]) -> Optional[dict]:
    """``metric=0.1,default=0.3`` -> per-metric tolerance overrides."""
    if not s:
        return None
    out = {}
    for part in s.split(","):
        if "=" not in part:
            raise SystemExit(f"--rel-tol: expected metric=float, "
                             f"got {part!r}")
        k, v = part.split("=", 1)
        try:
            tol = float(v)
        except ValueError:
            raise SystemExit(f"--rel-tol: {v!r} is not a float") from None
        if tol < 0.0:
            raise SystemExit(f"--rel-tol: {k.strip()}={tol} — tolerances "
                             f"must be >= 0")
        out[k.strip()] = tol
    return out


def cmd_compare(args) -> int:
    try:
        base = load_result_set(args.baseline)
        cur = load_result_set(args.current)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    suites = _parse_list(args.suite)
    if suites:
        base = [r for r in base if r.workload in suites]
        cur = [r for r in cur if r.workload in suites]
    if not cur:
        # a typo'd run dir must not read as "nothing regressed"; only an
        # unpromoted *baseline* store may legitimately be empty
        print(f"error: no results found at {args.current!r} — nothing to "
              f"compare", file=sys.stderr)
        return 2
    if not base:
        print(f"warning: empty baseline set at {args.baseline!r} "
              f"(promote one with `compare ... --promote`)",
              file=sys.stderr)
    cmp = compare_sets(base, cur, tols=_parse_tols(args.rel_tol),
                       noise_k=args.noise_k,
                       baseline_label=str(args.baseline),
                       current_label=str(args.current))
    report = (cmp.to_csv() if args.report == "csv"
              else cmp.to_markdown(all_points=args.all_points))
    if args.report_out:
        out_path = pathlib.Path(args.report_out)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(report)
        print(f"report written to {args.report_out}")
    print(report)
    print(cmp.summary())
    if args.promote:
        store = pathlib.Path(args.baseline)
        if store.is_file():
            print("error: --promote needs a baseline *directory* to "
                  "write <workload>.json files into", file=sys.stderr)
            return 2
        written = promote(cur, store)
        for p in written:
            print(f"promoted baseline: {p}")
        skipped = {r.workload for r in cur} - \
            {r.workload for r in cur if r.ok}
        for name in sorted(skipped):
            print(f"warning: {name!r} NOT promoted (no ok-status "
                  f"records); its previous baseline, if any, still "
                  f"stands", file=sys.stderr)
        # a renamed/removed workload leaves its old baseline behind, which
        # would fail --fail-on-missing forever; name the file to delete.
        # (Suppressed under --suite: a filtered run legitimately omits
        # every other workload's baseline.)
        if not suites:
            current_wl = {r.workload for r in cur}
            for f in sorted(store.glob("*.json")):
                if f.stem not in current_wl and f.name != "manifest.json":
                    print(f"warning: baseline {f} has no workload in the "
                          f"current run — delete it if the workload was "
                          f"removed or renamed", file=sys.stderr)
    rc = cmp.exit_code(fail_on_regression=args.fail_on_regression,
                       fail_on_missing=args.fail_on_missing)
    if rc:
        # name only the points the active gate flags actually counted —
        # an ungated status in a GATE line sends readers chasing the
        # wrong failure cause
        gated = []
        if args.fail_on_regression:
            gated += cmp.regressions + cmp.by_status(POWER_MISMATCH)
        if args.fail_on_missing:
            gated += cmp.by_status(MISSING)
        for p in gated:
            print(f"GATE: {p.status}: {p.key}"
                  + (f" ({p.note})" if p.note else ""), file=sys.stderr)
    return rc


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench",
        description="CARAML-style benchmark suite of the PyTorch/CUDA "
                    "port: one registry, one runner, one CLI.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_list = sub.add_parser("list", help="show registered workloads")
    p_list.add_argument("--suite", help="comma-separated workload names")
    p_list.add_argument("--tags", help="filter by tags (OR)")

    p_run = sub.add_parser("run", help="run selected workloads")
    p_run.add_argument("--suite", help="comma-separated workload names "
                                       "(default: all)")
    p_run.add_argument("--tags", help="select by tags (OR); 'smoke' also "
                                      "switches to the reduced point sets")
    p_run.add_argument("--smoke", action="store_true",
                       help="run each workload's reduced point set")
    p_run.add_argument("--points", help="axis overrides, k=v,k2=v2 "
                                        "(repeat k for multiple values)")
    p_run.add_argument("--power", default="auto", choices=POWER_CHOICES,
                       help="power backend (default: auto = the card's "
                            "NVML energy counter; nvml = NVML's board "
                            "power reading; both raise off the card)")
    p_run.add_argument("--warmup", type=int, default=1)
    p_run.add_argument("--iters", type=int, default=3)
    p_run.add_argument("--retries", type=int, default=1)
    p_run.add_argument("--out", default=DEFAULT_OUT)
    p_run.add_argument("--device", default="cuda",
                       help="cuda (default; raises without a card) or cpu")
    p_run.add_argument("--layers", type=int,
                       help="serve workloads: cut the served model to its "
                            "first N layers, widths unchanged (records "
                            "carry n_layers)")
    p_run.add_argument("--quiet", dest="verbose", action="store_false")

    p_rep = sub.add_parser("report", help="render saved results")
    p_rep.add_argument("--suite", help="comma-separated workload names")
    p_rep.add_argument("--out", default=DEFAULT_OUT)

    p_cmp = sub.add_parser(
        "compare", help="diff two result sets by point key (the JUBE "
                        "`result --compare` analog)")
    p_cmp.add_argument("baseline", help="baseline store dir, run dir, or "
                                        "results.json")
    p_cmp.add_argument("current", help="run dir or results.json to judge")
    p_cmp.add_argument("--suite", help="restrict to these workloads")
    p_cmp.add_argument("--rel-tol",
                       help="tolerance overrides, metric=0.1,...; the key "
                            "'default' replaces every base tolerance")
    p_cmp.add_argument("--noise-k", type=float, default=NOISE_K,
                       help="multiplier on the recorded step-time spread "
                            "when widening tolerances (default %(default)s)")
    p_cmp.add_argument("--fail-on-regression", action="store_true",
                       help="exit nonzero when any point regressed (or "
                            "was measured with a different power source)")
    p_cmp.add_argument("--fail-on-missing", action="store_true",
                       help="exit nonzero when a baseline point is absent "
                            "from the current run")
    p_cmp.add_argument("--promote", action="store_true",
                       help="write the current records into the baseline "
                            "store directory (one <workload>.json each)")
    p_cmp.add_argument("--report", choices=["md", "csv"], default="md")
    p_cmp.add_argument("--report-out", help="also write the report here")
    p_cmp.add_argument("--all-points", action="store_true",
                       help="include unchanged points in the md report")

    args = ap.parse_args(argv)
    if args.cmd == "list":
        return cmd_list(args)
    if args.cmd == "run":
        return cmd_run(args)
    if args.cmd == "compare":
        return cmd_compare(args)
    return cmd_report(args)
