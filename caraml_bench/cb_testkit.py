"""Helpers of the benchmark's CPU tests: each cell cut to its model
kind's CPU size, and an energy counter that needs no card."""
from __future__ import annotations

import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent / "src") not in sys.path:
    sys.path.insert(0, str(HERE.parent / "src"))

from cbench import spec  # noqa: E402

#: every cell of BENCHMARK.json (read once, at import, from the file)
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
#: cells kept ready beside the benchmark but out of BENCHMARK.json, as
#: (configuration, traffic) by name: gpt-800m's wait until the port
#: sums its embedding lookup's gradient in fp32 (PERF.md, Open
#: questions); they have no limits yet
STAGED = {"gpt800m-s2048-gb16": ("gpt-800m", "lm-s2048-gb16"),
          "gpt800m-s512-gb128": ("gpt-800m", "lm-s512-gb128")}


def tiny(name: str, dtype: str = "float32") -> spec.Cell:
    """Cell ``name`` (of BENCHMARK.json or staged) at a CPU size, its
    weights and compute in ``dtype``, with its own limits. The size is
    its model kind's: ``TINY`` (configuration keys) and ``TINY_TRAFFIC``
    (traffic keys) of ``cbench.models.<arch>``; a kind without them is
    refused, never run at its full size."""
    if name in STAGED:
        conf, traffic = STAGED[name]
        cell = spec.Cell(name=name, chips=1, config=spec._json(
            HERE / "configs" / f"{conf}.json"),
            traffic=spec._json(spec.traffic_file(traffic)))
    else:
        cell = spec.find_cell(spec.load_benchmark(), name)
    models = spec.arch_module("models", cell.arch)
    missing = [k for k in ("TINY", "TINY_TRAFFIC") if not hasattr(models, k)]
    if missing:
        raise ValueError(f"{models.__name__} gives no {' or '.join(missing)}"
                         ": no CPU size for its cells")
    cell.config = dict(cell.config, **models.TINY, dtype=dtype,
                       param_dtype=dtype)
    cell.traffic = dict(cell.traffic, **models.TINY_TRAFFIC)
    return cell


class FakeCounter:
    """A counter that steps by 100 J at every edge."""

    def __init__(self):
        self.j = 0.0

    def edge(self):
        self.j += 100.0
        return time.perf_counter(), self.j
