"""Collective statistics of a dry-run cell.

Port of ``CollectiveStats`` from ``src/repro/roofline/hlo.py``, which is
framework-neutral; records keep the reference's ``collectives`` schema.
The reference's ``parse_collectives`` and ``shape_bytes`` read XLA's
compiled HLO text, which a PyTorch program does not have: one card runs
no collective, so its stats are zeros, and the multi-device port
(ROADMAP Queue 1 item 8) counts ``torch.distributed`` calls instead.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=lambda: defaultdict(int))
    result_bytes: dict = field(default_factory=lambda: defaultdict(int))
    wire_bytes: dict = field(default_factory=lambda: defaultdict(float))

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
        }
