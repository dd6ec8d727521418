"""BenchmarkSuite — the CARAML/JUBE automation layer.

A suite is a declarative benchmark description: a parameter Space, a set of
steps (setup -> run -> postprocess), tags for selecting subsets, and a
result specification. ``Runner`` (repro_torch.core.runner) executes it with
power measurement, retries, and straggler detection, then renders result
tables — the whole jube run/continue/result flow in one python object.

Copy of ``src/repro/core/suite.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.params import Space


@dataclass
class Step:
    """One benchmark step. ``fn(point, context) -> dict`` returns metrics."""
    name: str
    fn: Callable[[dict, dict], dict]
    tags: frozenset = frozenset()
    retries: int = 1


@dataclass
class BenchmarkSuite:
    name: str
    space: Space
    steps: list[Step]
    tags: frozenset = frozenset()
    result_columns: Optional[list[str]] = None

    def select_steps(self, tags: Optional[set] = None) -> list[Step]:
        if not tags:
            return self.steps
        return [s for s in self.steps if not s.tags or s.tags & tags]

    def points(self) -> list[dict]:
        return self.space.expand()
