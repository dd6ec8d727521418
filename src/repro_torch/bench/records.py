"""ResultRecord — the normalized, schema-versioned benchmark result.

Port of ``src/repro/bench/records.py``, same schema (v3). Every workload
point produces exactly one record: the point, the metrics, the labeled
power source, the placement, attempt count, and status. The on-disk
layout under ``artifacts/bench_torch/<workload>/`` is

  results.json   {"schema_version": N, "workload": ..., "records": [...]}
  results.csv    flat rows (point + metrics columns), schema_version column
  manifest.json  host/torch/device provenance (core.manifest)

written through :mod:`repro_torch.core.results` so the files are atomic
and a partially-interrupted sweep never truncates completed points. The
reference's scaling metrics and ``compare_metrics`` wait for the
multi-device and compare items of ROADMAP Queue 1.
"""
from __future__ import annotations

import json
import pathlib
from dataclasses import asdict, dataclass, field, fields
from typing import Optional

from repro_torch.core.results import atomic_write_text
from repro_torch.power.frame import Frame

SCHEMA_VERSION = 3


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
