"""Parameter-space expansion with constraints (JUBE's parameter sets).

Copy of ``src/repro/core/params.py`` (``Space`` only).

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
