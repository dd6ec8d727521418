"""Parameter-space expansion with constraints (JUBE's parameter sets).

Copy of ``src/repro/core/params.py``.

A ``Space`` is a dict of axis-name -> list of values; ``expand`` yields the
cartesian product, filtered by constraints (e.g. the paper's
"global batch not divisible by micro_batch x dp" exclusion) and selected by
tags, like JUBE's tag system.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class Space:
    axes: dict[str, list]
    constraints: list[Callable[[dict], bool]] = field(default_factory=list)

    def expand(self) -> list[dict]:
        names = list(self.axes)
        out = []
        for combo in itertools.product(*(self.axes[n] for n in names)):
            pt = dict(zip(names, combo))
            if all(c(pt) for c in self.constraints):
                out.append(pt)
        return out

    def __len__(self) -> int:
        return len(self.expand())


def divisible_batch(pt: dict) -> bool:
    """The paper's constraint: global_batch % (micro_batch * dp) == 0."""
    gb = pt.get("global_batch", 0)
    mb = pt.get("micro_batch", 1)
    dp = pt.get("dp", 1)
    return gb % max(mb * dp, 1) == 0


def batch_at_least_dp(pt: dict) -> bool:
    return pt.get("global_batch", 1) >= pt.get("dp", 1)
