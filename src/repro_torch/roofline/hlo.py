"""Collective statistics of a dry-run cell.

Port of ``CollectiveStats`` from ``src/repro/roofline/hlo.py``, which is
framework-neutral; records keep the reference's ``collectives`` schema.
The reference's ``parse_collectives`` and ``shape_bytes`` read XLA's
compiled HLO text, which a PyTorch program does not have: one card runs
no collective, so its stats are zeros, and a sharded program is counted
where it calls them, through ``launch.mesh.CountingMesh``, which prices
each call by the reference's ring formulas (:func:`ring_wire_bytes`,
``src/repro/roofline/hlo.py:7-12,101-110``) and records its group: the
axes, their size and the link they take (``groups`` and
``wire_bytes_by_link`` in the record, beside the reference's keys).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field


def ring_wire_bytes(op: str, result_bytes: float, g: int) -> float:
    """Per-device wire bytes of one collective over ``g`` devices whose
    result is ``result_bytes`` (the reference's ring estimates)."""
    frac = (g - 1) / g if g > 1 else 0.0
    if op == "all-reduce":
        return 2.0 * result_bytes * frac
    if op == "reduce-scatter":
        return float(result_bytes * (g - 1))   # operand = result * g
    if op in ("all-gather", "all-to-all"):
        return result_bytes * frac
    return float(result_bytes)                 # collective-permute


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=lambda: defaultdict(int))
    result_bytes: dict = field(default_factory=lambda: defaultdict(int))
    wire_bytes: dict = field(default_factory=lambda: defaultdict(float))
    #: axes -> {"size", "link", "counts", "wire_bytes"} (counted programs)
    groups: dict = field(default_factory=dict)

    def add(self, op: str, result_bytes: int, wire: float, g: int,
            link: str, axes: str) -> None:
        """One collective over the group ``axes`` of ``g`` devices."""
        self.counts[op] += 1
        self.result_bytes[op] += result_bytes
        self.wire_bytes[op] += wire
        grp = self.groups.setdefault(axes, {"size": g, "link": link,
                                            "counts": defaultdict(int),
                                            "wire_bytes": 0.0})
        grp["counts"][op] += 1
        grp["wire_bytes"] += wire

    def wire_bytes_by_link(self) -> dict:
        out: dict = defaultdict(float)
        for grp in self.groups.values():
            out[grp["link"]] += grp["wire_bytes"]
        return dict(out)

    @property
    def total_wire_bytes(self) -> float:
        return float(sum(self.wire_bytes.values()))

    @property
    def total_result_bytes(self) -> int:
        return int(sum(self.result_bytes.values()))

    def to_dict(self) -> dict:
        return {
            "counts": dict(self.counts),
            "result_bytes": dict(self.result_bytes),
            "wire_bytes": dict(self.wire_bytes),
            "total_wire_bytes": self.total_wire_bytes,
            **({"groups": {a: dict(g, counts=dict(g["counts"]))
                           for a, g in self.groups.items()},
                "wire_bytes_by_link": self.wire_bytes_by_link()}
               if self.groups else {}),
        }
