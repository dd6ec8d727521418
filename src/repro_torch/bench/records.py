"""ResultRecord — the normalized, schema-versioned benchmark result.

Port of ``src/repro/bench/records.py``, same schema (v3). Every workload
point produces exactly one record: the point, the metrics, the labeled
power source, the placement, attempt count, and status. The on-disk
layout under ``artifacts/bench_torch/<workload>/`` is

  results.json   {"schema_version": N, "workload": ..., "records": [...]}
  results.csv    flat rows (point + metrics columns), schema_version column
  manifest.json  host/torch/device provenance (core.manifest)

written through :mod:`repro_torch.core.results` so the files are atomic
and a partially-interrupted sweep never truncates completed points.
``stamp_scaling_metrics`` is the reference's, less its emulated-device
cap (the port has no forced host-platform devices). ``COMPARED_METRICS``,
``compare_metrics``, ``metric_direction`` and ``metric_tolerance`` are
the reference's, for the comparison engine (``bench.compare``).
"""
from __future__ import annotations

import json
import math
import pathlib
from dataclasses import asdict, dataclass, field, fields
from typing import Optional

from repro_torch.core.results import atomic_write_text
from repro_torch.power.frame import Frame

SCHEMA_VERSION = 3

#: metrics the comparison engine understands: name -> (higher_is_better,
#: default relative tolerance). Anything else a workload emits (structural
#: counts, booleans, notes) is carried in the record but not delta-gated.
COMPARED_METRICS: dict[str, tuple[bool, float]] = {
    # throughput — higher is better
    "tokens_per_s": (True, 0.20),
    "images_per_s": (True, 0.20),
    "decode_tok_s": (True, 0.20),
    "speedup_vs_fixed": (True, 0.25),
    "speedup_vs_slotted": (True, 0.25),
    # scheduler health — mean decode-step batch occupancy (active slots /
    # n_slots); a drop means admission/refill regressed even when raw
    # throughput noise hides it
    "occupancy": (True, 0.25),
    # energy efficiency — higher is better
    "tokens_per_wh": (True, 0.20),
    "images_per_wh": (True, 0.20),
    # step/latency time — lower is better
    "seconds": (False, 0.20),
    "ms_per_step": (False, 0.20),
    "ms_per_iter": (False, 0.20),
    "ms": (False, 0.20),
    "us": (False, 0.20),
    "ttft_s": (False, 0.30),
    # energy cost — lower is better
    "wh_per_token": (False, 0.25),
    "wh_per_request": (False, 0.25),
    "energy_wh_per_step": (False, 0.25),
    "energy_wh": (False, 0.25),
    # cross-placement scaling (stamp_scaling_metrics) — per-device
    # throughput, parallel efficiency vs the 1-device cell of the same
    # sweep, and the energy-per-token ratio vs that cell
    "tok_s_per_device": (True, 0.20),
    "scaling_efficiency": (True, 0.20),
    "wh_per_token_scaling": (False, 0.25),
    # SLO serving (serve_slo / repro.serve.slo) — fraction of requests
    # meeting their per-tenant TTFT+TPOT targets, tail latency
    # quantiles, and energy per SLO-met request (the MLPerf-Power
    # energy-per-useful-inference figure). Tail quantiles get wide
    # tolerances: a p99 on CPU timing is the noisiest figure gated here.
    "goodput": (True, 0.15),
    "ttft_p99": (False, 0.35),
    "tpot_p99": (False, 0.35),
    "wh_per_slo_request": (False, 0.30),
    # int8 KV pool (kv_dtype axis): pool_bytes/max_concurrency are
    # structural (deterministic functions of config + dtype — near-zero
    # tolerance so a silent layout change gates); speedup_vs_fp_kv is a
    # same-cell throughput ratio vs the fp32 twin;
    # kv_stream_prefix_agreement is the token-stream quality figure
    # (mean longest-common-prefix fraction vs the fp32 twin's streams) —
    # a drop means quantization error is steering greedy decoding.
    "pool_bytes": (False, 0.01),
    "max_concurrency": (True, 0.01),
    "speedup_vs_fp_kv": (True, 0.25),
    "kv_stream_prefix_agreement": (True, 0.10),
    # chunked-vs-phased scheduler ratios (sched axis): same-cell pairs,
    # so trace noise largely cancels — except ttft_p99_vs_phased, a
    # ratio of two SINGLE-RUN p99s whose run-to-run wobble is multiples,
    # not percent. Its wide tolerance lives on the serve_slo workload
    # (compare_tols stamp — a registry base here would be outranked by
    # the CI's blanket --rel-tol); the real cliff gate is
    # scripts/check_ttft_gate.py (median-of-3 per sched). The base
    # below only matters for compares run without a CLI default.
    "speedup_vs_phased": (True, 0.25),
    "ttft_p99_vs_phased": (False, 1.5),
    "goodput_vs_phased": (True, 0.15),
    # resilience (faults/ + bench.workloads.resilience) — crash-to-first-
    # resumed-step wall time, recompute cost in tokens, end-to-end
    # delivered-token rate including recovery, and the energy premium vs
    # the fault-free twin. recovery_s and the Wh overhead are differences
    # of CPU wall-clock quantities an order of magnitude noisier than a
    # throughput cell, hence the wide bases (the workload stamps wider
    # still via compare_tols).
    "recovery_s": (False, 0.50),
    "wasted_tokens": (False, 0.30),
    "goodput_tokens_per_s": (True, 0.25),
    "wh_overhead_resilience": (False, 2.0),
}



@dataclass
class ResultRecord:
    """One (workload x point) outcome in the normalized schema."""

    workload: str
    point: dict
    metrics: dict = field(default_factory=dict)
    power_source: str = "none"
    n_devices: int = 1
    attempts: int = 1
    status: str = "ok"            # "ok" | "error" | "skipped" | "deferred"
    error: Optional[str] = None
    git_sha: Optional[str] = None      # commit of the benchmarked tree (v2)
    noise: dict = field(default_factory=dict)  # tolerance inputs (v2)
    #: device mesh by parallelism axis, e.g. {"dp": 2, "tp": 2} (v3);
    #: None upconverts to {"dp": n_devices}
    placement: Optional[dict] = None
    schema_version: int = SCHEMA_VERSION

    def __post_init__(self):
        if self.placement is None:
            self.placement = {"dp": int(self.n_devices)}
        else:
            n = 1
            for size in self.placement.values():
                n *= int(size)
            self.n_devices = n

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def rel_std(self) -> float:
        """Recorded relative step-time spread (0.0 when not recorded)."""
        if not isinstance(self.noise, dict):
            return 0.0
        try:
            return max(float(self.noise.get("rel_std", 0.0)), 0.0)
        except (TypeError, ValueError):
            return 0.0

    def flat(self) -> dict:
        """Single-level dict for CSV/result tables: point + metrics merged,
        prefixed by the bookkeeping columns."""
        out = {"schema_version": self.schema_version,
               "workload": self.workload}
        out.update(self.point)
        out.update(self.metrics)
        out.update(power_source=self.power_source, n_devices=self.n_devices,
                   attempts=self.attempts, status=self.status)
        if "placement" not in out:     # a placement Space axis wins
            out["placement"] = placement_label(self.placement)
        if self.git_sha:
            out["git_sha"] = self.git_sha
        if self.error:
            out["error"] = self.error
        return out

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ResultRecord":
        d = dict(d)
        version = d.get("schema_version", 0)
        if version > SCHEMA_VERSION or version < 1:
            raise ValueError(
                f"ResultRecord schema_version {version} not supported "
                f"(this reader understands 1..{SCHEMA_VERSION})")
        known = {f.name for f in fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(
                f"ResultRecord v{version} has unknown fields {sorted(extra)}"
                f"; known fields: {sorted(known)}")
        if d.get("noise") is None:      # hand-edited/null noise tolerated
            d["noise"] = {}
        for name in ("point", "metrics", "noise"):
            if name in d and not isinstance(d[name], dict):
                raise ValueError(
                    f"ResultRecord field {name!r} must be an object, "
                    f"got {type(d[name]).__name__}")
        try:
            return cls(**d)
        except TypeError as e:   # missing required field etc. — corrupt
            raise ValueError(f"malformed ResultRecord: {e}") from None


def placement_label(placement: Optional[dict]) -> str:
    """Canonical compact spelling of a placement dict (axis-name order
    insensitive): ``{"tp": 2, "dp": 2}`` -> ``"dp2tp2"``."""
    from repro_torch.bench.spec import Placement
    if not placement:
        return "dp1"
    return Placement.of(dict(placement)).label


def point_key(rec: ResultRecord, *, with_power: bool = True) -> str:
    """Canonical join key for cross-run comparison: workload, Space
    parameters (order-insensitive), placement and, unless
    ``with_power=False``, power source."""
    params = ",".join(f"{k}={rec.point[k]}" for k in sorted(rec.point))
    key = f"{rec.workload}|{params}|plc={placement_label(rec.placement)}"
    if with_power:
        key += f"|power={rec.power_source}"
    return key


def compare_metrics(rec: ResultRecord) -> dict[str, float]:
    """The subset of a record's metrics the comparison engine delta-gates,
    as floats, in ``COMPARED_METRICS`` order."""
    out = {}
    for name in COMPARED_METRICS:
        if name in rec.metrics:
            try:
                out[name] = float(rec.metrics[name])
            except (TypeError, ValueError):
                continue
    return out


def metric_direction(name: str) -> bool:
    """True when higher values of ``name`` are better."""
    return COMPARED_METRICS[name][0]


def metric_tolerance(name: str) -> float:
    """Default relative tolerance for ``name``."""
    return COMPARED_METRICS[name][1]


def result_doc(records: list) -> dict:
    """The on-disk results document for a record list."""
    workload = records[0].workload if records else ""
    return {"schema_version": SCHEMA_VERSION, "workload": workload,
            "records": [r.to_dict() for r in records]}


def write_result_doc(records: list, path) -> None:
    """Atomically write the schema-versioned JSON document (no CSV)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    atomic_write_text(path, json.dumps(result_doc(records), indent=1,
                                       default=str))


def save_records(records: list, out_dir, name: str = "results") -> None:
    """Write the schema-versioned JSON + flat CSV pair (atomically)."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_result_doc(records, out / f"{name}.json")
    atomic_write_text(out / f"{name}.csv",
                      Frame.from_records([r.flat() for r in records]).to_csv())


def load_records(path) -> list:
    """Read a results.json back into ResultRecords (version-checked).

    Rejects unversioned/foreign documents and unsupported versions with a
    ValueError naming the file.
    """
    path = pathlib.Path(path)
    doc = json.loads(path.read_text())
    if isinstance(doc, list):   # pre-schema layout (plain record list)
        raise ValueError(f"{path}: unversioned legacy results; re-run the "
                         f"benchmark through `python -m repro_torch.bench "
                         f"run`")
    if not isinstance(doc, dict) or "records" not in doc:
        raise ValueError(f"{path}: not a results document (no 'records')")
    version = doc.get("schema_version")
    if not isinstance(version, int) or not 1 <= version <= SCHEMA_VERSION:
        raise ValueError(
            f"{path}: results schema_version {version!r} not supported "
            f"(this reader understands 1..{SCHEMA_VERSION})")
    try:
        return [ResultRecord.from_dict(d) for d in doc["records"]]
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


#: throughput metrics the scaling derivation reads, in preference order
THROUGHPUT_METRICS = ("tokens_per_s", "images_per_s", "decode_tok_s")
#: energy-efficiency metrics (higher is better) the wh/token scaling
#: ratio derives from
EFFICIENCY_METRICS = ("tokens_per_wh", "images_per_wh")


def scaling_base_key(rec: ResultRecord) -> tuple:
    """The join key of a record's own sweep, placement stripped: the
    1-device cell every scaled cell's efficiency is measured against."""
    params = tuple(sorted((k, str(v)) for k, v in rec.point.items()
                          if k != "placement"))
    return (rec.workload, params, rec.power_source)


def stamp_scaling_metrics(records: list) -> None:
    """Derive the cross-placement scaling metrics for one result set.

    Every ok record with a throughput metric gains ``tok_s_per_device``
    (throughput / mesh size — the paper's per-accelerator figure);
    multi-device records whose sweep also measured the 1-device cell of
    the same point gain ``scaling_efficiency`` (per-device throughput
    relative to 1 device: 1.0 = linear scaling) and
    ``wh_per_token_scaling`` (energy per token relative to 1 device:
    1.0 = energy parity).
    """
    ones = {}
    for r in records:
        if r.ok and r.n_devices == 1:
            ones.setdefault(scaling_base_key(r), r)
    for r in records:
        if not r.ok:
            continue
        tp_name = next((m for m in THROUGHPUT_METRICS if m in r.metrics),
                       None)
        if tp_name is None:
            continue
        try:
            tp = float(r.metrics[tp_name])
        except (TypeError, ValueError):
            continue
        if not math.isfinite(tp):
            continue
        n = max(r.n_devices, 1)
        r.metrics.setdefault("tok_s_per_device", tp / n)
        if n == 1:
            continue
        base = ones.get(scaling_base_key(r))
        if base is None:
            continue
        try:
            base_tp = float(base.metrics.get(tp_name))
        except (TypeError, ValueError):
            continue
        if math.isfinite(base_tp) and base_tp > 0.0:
            r.metrics["scaling_efficiency"] = (tp / n) / base_tp
        eff_name = next((m for m in EFFICIENCY_METRICS
                         if m in r.metrics and m in base.metrics), None)
        if eff_name is None:
            continue
        try:
            cur_eff = float(r.metrics[eff_name])
            base_eff = float(base.metrics[eff_name])
        except (TypeError, ValueError):
            continue
        if all(math.isfinite(v) and v > 0.0 for v in (cur_eff, base_eff)):
            # (Wh/token at n devices) / (Wh/token at 1) == eff_1 / eff_n
            r.metrics["wh_per_token_scaling"] = base_eff / cur_eff
