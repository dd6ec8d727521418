"""Cross-run comparison engine — the JUBE ``result --compare`` analog.

Copy of ``src/repro/bench/compare.py`` with its imports rewritten to the
port's ``bench.records``, ``core.results`` and ``power.frame``; the
verdicts, the tolerance model and the baseline store's layout are the
reference's, so either package's records compare and promote alike.

CARAML's value is reproducible *comparison*: the same workload point
re-measured across commits, hosts, or accelerators and diffed. This
module joins two sets of :class:`ResultRecord`s by the canonical point
key (workload + sorted Space params + device count + power source),
computes per-metric relative deltas with a noise-aware tolerance model,
and classifies every point as improved / unchanged / regressed /
missing / new / power_mismatch.

Tolerance model
---------------
Each compared metric carries a direction (higher/lower is better) and a
base relative tolerance (``records.COMPARED_METRICS``, overridable per
metric or wholesale from the CLI). The effective threshold for a point
is widened by the step-time spread both runs recorded::

    tol = base_tol + noise_k * min(max(rel_std_base, rel_std_cur), cap)

so a run whose own step times wobbled 10% cannot support a 5%
regression verdict, while a pair of quiet runs keeps the tight gate.

Baseline store
--------------
``promote()`` writes the current records into a git-trackable store,
one ``<dir>/<workload>.json`` per workload in the same schema-versioned
document format as ``results.json`` (atomic replace). CI re-runs the
smoke suite and gates it against the committed store with
``python -m repro_torch.bench compare <baseline store> <run>
--fail-on-regression``.
"""
from __future__ import annotations

import math
import pathlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.bench.records import (
    ResultRecord, compare_metrics, load_records, metric_direction,
    metric_tolerance, point_key, write_result_doc,
)
from repro_torch.core.results import table
from repro_torch.power.frame import Frame

#: default multiplier on the recorded rel_std when widening tolerances
NOISE_K = 2.0
#: rel_std is capped before widening: a wildly noisy sweep (heterogeneous
#: points share one watchdog) must not disable the gate entirely
NOISE_CAP = 0.5

# classification outcomes, in render/severity order
REGRESSED = "regressed"
POWER_MISMATCH = "power_mismatch"
MISSING = "missing"
IMPROVED = "improved"
NEW = "new"
UNCHANGED = "unchanged"
STATUSES = (REGRESSED, POWER_MISMATCH, MISSING, IMPROVED, NEW, UNCHANGED)


@dataclass(frozen=True)
class MetricDelta:
    """One metric diffed at one point."""

    metric: str
    base: float
    current: float
    rel_delta: float        # signed (current - base) / |base|
    tolerance: float        # effective threshold after noise widening
    status: str             # improved | unchanged | regressed

    @property
    def pct(self) -> str:
        if math.isinf(self.rel_delta):
            return "inf"
        return f"{self.rel_delta * 100:+.1f}%"


@dataclass
class PointComparison:
    """One joined point: classification plus its per-metric deltas."""

    key: str
    workload: str
    point: dict
    power_source: str
    status: str
    deltas: List[MetricDelta] = field(default_factory=list)
    note: str = ""

    def flat(self) -> List[dict]:
        """CSV rows: one per metric delta (or one bare row for point-level
        outcomes like missing/new/power_mismatch)."""
        # "/"-joined like the classic emit lines — the CSV writer does not
        # quote fields, so the point column must stay comma-free
        head = {"workload": self.workload,
                "point": "/".join(f"{k}={v}" for k, v in
                                  sorted(self.point.items())),
                "power_source": self.power_source, "status": self.status}
        # reports are unquoted CSV rows and markdown table cells: commas,
        # newlines, and pipes in an error message would corrupt exactly
        # the failing-run report this exists to explain
        note = " ".join(self.note.replace(",", ";")
                        .replace("|", "/").split())
        if not self.deltas:
            return [{**head, "note": note}]
        return [{**head, "metric": d.metric, "baseline": d.base,
                 "current": d.current, "rel_delta": round(d.rel_delta, 6),
                 "tolerance": round(d.tolerance, 6),
                 "metric_status": d.status, "note": note}
                for d in self.deltas]


@dataclass
class Comparison:
    """The full cross-run diff: all joined points plus summary helpers."""

    points: List[PointComparison]
    baseline_label: str = "baseline"
    current_label: str = "current"

    def by_status(self, status: str) -> List[PointComparison]:
        return [p for p in self.points if p.status == status]

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in STATUSES}
        for p in self.points:
            out[p.status] = out.get(p.status, 0) + 1
        return out

    @property
    def regressions(self) -> List[PointComparison]:
        return self.by_status(REGRESSED)

    def summary(self) -> str:
        c = self.counts()
        parts = [f"{c[s]} {s}" for s in STATUSES if c[s]]
        return (f"compare {self.baseline_label} -> {self.current_label}: "
                f"{len(self.points)} points; " + (", ".join(parts) or
                                                  "nothing to compare"))

    def exit_code(self, fail_on_regression: bool = False,
                  fail_on_missing: bool = False) -> int:
        """CI gate: regressions (and errored/power-mismatched points)
        fail under --fail-on-regression; vanished points fail only under
        --fail-on-missing so partial re-runs stay usable."""
        c = self.counts()
        if fail_on_regression and (c[REGRESSED] or c[POWER_MISMATCH]):
            return 3
        if fail_on_missing and c[MISSING]:
            return 4
        return 0

    # -- reports ----------------------------------------------------------

    def to_markdown(self, *, all_points: bool = False) -> str:
        """Markdown report: summary + a table of non-unchanged points
        (every metric row with ``all_points=True``)."""
        rows = []
        for p in self.points:
            if not all_points and p.status == UNCHANGED:
                continue
            rows.extend(p.flat())
        lines = [f"## {self.summary()}", ""]
        if rows:
            cols = ["workload", "point", "status", "metric", "baseline",
                    "current", "rel_delta", "tolerance", "metric_status",
                    "note"]
            used = [c for c in cols if any(c in r for r in rows)]
            lines.append(table(rows, used, floatfmt="{:.4g}"))
        else:
            lines.append("(all points unchanged within tolerance)\n")
        return "\n".join(lines)

    def to_csv(self) -> str:
        rows = [r for p in self.points for r in p.flat()]
        return Frame.from_records(rows).to_csv()


def effective_tolerance(metric: str, base: ResultRecord,
                        cur: ResultRecord, *,
                        tols: Optional[dict] = None,
                        noise_k: float = NOISE_K) -> float:
    """Per-metric threshold, widened by the noisier run's recorded
    step-time spread (capped — see NOISE_CAP).

    Base-tolerance precedence (most specific wins): CLI per-metric
    override > per-metric tolerance the *workload declared*
    (``WorkloadSpec.compare_tols``, stamped into each record's noise
    dict — e.g. the CPU interpret-mode kernel microbench exempts its
    un-gateable absolute timings with ``inf``) > workload ``"default"``
    > CLI ``"default"`` > the registry base for the metric. The
    workload's default outranks the CLI's on purpose: a blanket
    ``--rel-tol default=...`` (the CI gate) must not re-arm a gate a
    workload exempted for cause.
    """
    tols = tols or {}
    rec_tols: dict = {}
    for r in (base, cur):     # the current run's declaration wins
        declared = r.noise.get("tols") if isinstance(r.noise, dict) else None
        if isinstance(declared, dict):
            rec_tols.update(declared)
    base_tol = metric_tolerance(metric)
    for candidate in (tols.get("default"), rec_tols.get("default"),
                      rec_tols.get(metric), tols.get(metric)):
        if candidate is not None:
            base_tol = float(candidate)
    spread = min(max(base.rel_std, cur.rel_std), NOISE_CAP)
    return base_tol + noise_k * spread


def diff_metric(metric: str, base_v: float, cur_v: float,
                tolerance: float) -> MetricDelta:
    """Classify one metric against the direction-aware threshold.

    ``rel_delta`` (reported) is the signed relative delta; the
    *classification* runs on the ratio scale: a point regresses when it
    is more than ``(1 + tol)x`` worse than baseline and improves when
    more than ``(1 + tol)x`` better. Ratios are unbounded in both
    directions, so even a saturated tolerance (noisy sweep + CI
    widening pushing tol past 1.0) still catches an order-of-magnitude
    collapse — on the relative scale a throughput drop bottoms out at
    -100% and would slip under any tol >= 1.
    """
    higher = metric_direction(metric)
    if math.isnan(base_v) or math.isnan(cur_v):
        # NaN is a measurement failure, not a delta — it must gate,
        # never slip through as "unchanged" (NaN fails every comparison)
        return MetricDelta(metric=metric, base=base_v, current=cur_v,
                           rel_delta=math.nan, tolerance=tolerance,
                           status=REGRESSED)
    if math.isinf(base_v) or math.isinf(cur_v):
        # inf can be an honest value, not a failure: wh_per_slo_request
        # is inf whenever energy was spent but nothing met the SLO. A
        # stress cell that is inf on BOTH sides (same sign) is therefore
        # unchanged — gating it would flag the baseline's own saturation
        # forever. Any finite<->inf transition still gates as a
        # regression: degenerating to inf is the metric collapsing, and
        # escaping it (a genuine recovery) changes regime enough that a
        # human must look and re-promote rather than let it slide by.
        if base_v == cur_v:
            return MetricDelta(metric=metric, base=base_v, current=cur_v,
                               rel_delta=0.0, tolerance=tolerance,
                               status=UNCHANGED)
        return MetricDelta(metric=metric, base=base_v, current=cur_v,
                           rel_delta=math.copysign(math.inf, cur_v - base_v),
                           tolerance=tolerance, status=REGRESSED)
    if not higher and cur_v == 0.0 and base_v > 0.0:
        # a time/energy metric degenerating to exactly zero is a broken
        # measurement path (e.g. a dead power scope), not a best-ever run
        return MetricDelta(metric=metric, base=base_v, current=cur_v,
                           rel_delta=-1.0, tolerance=tolerance,
                           status=REGRESSED)
    if base_v == 0.0:
        rel = 0.0 if cur_v == 0.0 else math.copysign(math.inf, cur_v)
    else:
        rel = (cur_v - base_v) / abs(base_v)
    if base_v > 0.0 and cur_v >= 0.0:
        if higher:
            worse = math.inf if cur_v == 0.0 else base_v / cur_v
        else:
            worse = cur_v / base_v
        if worse > 1.0 + tolerance:
            status = REGRESSED
        elif worse < 1.0 / (1.0 + tolerance):
            status = IMPROVED
        else:
            status = UNCHANGED
    else:
        # zero/negative baselines have no ratio; fall back to the signed
        # relative delta (inf when appearing from exactly zero)
        goodness = rel if higher else -rel
        if goodness < -tolerance:
            status = REGRESSED
        elif goodness > tolerance:
            status = IMPROVED
        else:
            status = UNCHANGED
    return MetricDelta(metric=metric, base=base_v, current=cur_v,
                       rel_delta=rel, tolerance=tolerance, status=status)


def _classify(deltas: List[MetricDelta]) -> str:
    statuses = {d.status for d in deltas}
    if REGRESSED in statuses:
        return REGRESSED
    if IMPROVED in statuses:
        return IMPROVED
    return UNCHANGED


def compare_sets(baseline: List[ResultRecord], current: List[ResultRecord],
                 *, tols: Optional[dict] = None,
                 noise_k: float = NOISE_K,
                 baseline_label: str = "baseline",
                 current_label: str = "current") -> Comparison:
    """Join two record sets by point key and classify every point.

    ``tols`` overrides relative tolerances per metric name; the special
    key ``"default"`` replaces the base tolerance for every metric.
    Error-status baseline records are ignored (a broken baseline point
    gates nothing); an error-status current record at an ok baseline
    point is itself a regression.
    """
    base_by = {point_key(r): r for r in baseline if r.ok}
    cur_by = {point_key(r): r for r in current}
    # power-stripped indexes, for mismatch detection on both sides
    base_nopower = {point_key(r, with_power=False): r
                    for r in baseline if r.ok}
    cur_nopower = {point_key(r, with_power=False): r for r in current}

    points: List[PointComparison] = []
    for key in sorted(set(base_by) | set(cur_by)):
        base, cur = base_by.get(key), cur_by.get(key)
        rec = cur or base
        pc = PointComparison(key=key, workload=rec.workload,
                             point=dict(rec.point),
                             power_source=rec.power_source, status=UNCHANGED)
        if base is None:
            twin = base_nopower.get(point_key(cur, with_power=False))
            if cur.status == "error":
                # a point that errors must not hide behind `new` (it is
                # never promoted, so it would stay green forever) nor
                # behind the power-mismatch dedup — the crash message
                # must surface, whatever power source the attempt used
                pc.status = REGRESSED
                pc.note = f"new point errored: {cur.error}"
            elif twin is not None and point_key(twin) not in cur_by:
                # the baseline side of this pair reports POWER_MISMATCH;
                # a second `new` row for the same point is just noise
                continue
            elif twin is not None:
                # the baseline matched its own-power record at full key;
                # this extra power source is genuinely additional data
                pc.status = NEW
                pc.note = "additional power source not in baseline"
            else:
                pc.status, pc.note = NEW, "point not in baseline"
        elif cur is None:
            other = cur_nopower.get(point_key(base, with_power=False))
            if other is not None and point_key(other) not in base_by:
                # the current run re-measured this point under a power
                # source the baseline does not have — a genuine mismatch.
                # (If `other` has its own full-key baseline match the
                # pair compared cleanly and this row is merely absent.)
                pc.status = POWER_MISMATCH
                pc.note = (f"baseline measured with "
                           f"power={base.power_source!r} but current run "
                           f"used power={other.power_source!r}; refusing "
                           f"to diff across power sources")
            else:
                pc.status, pc.note = MISSING, "point absent from current run"
        elif cur.status in ("skipped", "deferred"):
            # a deliberately skipped point (missing hardware, gated
            # feature) — or one deferred to a rendered Slurm job because
            # its mesh exceeds local devices — is absence, not failure;
            # --fail-on-missing governs
            pc.status = MISSING
            pc.note = (f"current run {cur.status} this point"
                       + (f": {cur.error}" if cur.error else ""))
        elif not cur.ok:
            pc.status = REGRESSED
            pc.note = f"current run errored: {cur.error}"
        else:
            base_m, cur_m = compare_metrics(base), compare_metrics(cur)
            for m in base_m:
                if m not in cur_m:
                    continue
                tol = effective_tolerance(m, base, cur, tols=tols,
                                          noise_k=noise_k)
                pc.deltas.append(diff_metric(m, base_m[m], cur_m[m], tol))
            pc.status = _classify(pc.deltas)
            lost = sorted(set(base_m) - set(cur_m))
            if lost:
                # a compared metric that vanished is a gated outcome, not
                # a footnote — otherwise breaking energy accounting would
                # silently disarm the Wh gate this engine exists for
                pc.status = REGRESSED
                pc.note = f"metrics no longer reported: {' '.join(lost)}"
        points.append(pc)
    return Comparison(points=points, baseline_label=baseline_label,
                      current_label=current_label)


# ---------------------------------------------------------------------------
# result-set loading + the baseline store
# ---------------------------------------------------------------------------


def load_result_set(path) -> List[ResultRecord]:
    """Load records from any of the three layouts compare accepts:

      * an explicit ``results.json`` (or baseline ``<workload>.json``) file
      * a run directory — ``<dir>/results.json`` or the runner's
        ``<dir>/<workload>/results.json`` tree
      * a baseline store directory of per-workload ``*.json`` documents

    A nonexistent directory yields an empty set (the bootstrap case:
    comparing against a baseline store that has not been promoted yet).
    """
    p = pathlib.Path(path)
    if p.is_file():
        return load_records(p)
    if not p.is_dir():
        if p.exists():
            raise ValueError(f"{p}: not a results file or directory")
        return []
    if (p / "results.json").exists():
        return load_records(p / "results.json")
    files = sorted(p.glob("*/results.json"))
    if not files:
        files = sorted(f for f in p.glob("*.json")
                       if f.name != "manifest.json")
    recs: List[ResultRecord] = []
    for f in files:
        recs.extend(load_records(f))
    return recs


def promote(records: List[ResultRecord], store_dir) -> List[pathlib.Path]:
    """Write ok-status records into the baseline store, one atomic
    ``<store_dir>/<workload>.json`` per workload (replacing that
    workload's previous baseline; other workloads are untouched)."""
    store = pathlib.Path(store_dir)
    by_workload: Dict[str, List[ResultRecord]] = {}
    for r in records:
        if r.ok:
            by_workload.setdefault(r.workload, []).append(r)
    written = []
    for name in sorted(by_workload):
        path = store / f"{name}.json"
        write_result_doc(by_workload[name], path)
        written.append(path)
    return written
