"""Helpers of the benchmark's CPU tests: each cell cut to a size the CPU
runs in a second, and an energy counter that needs no card."""
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

TINY_LM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
               d_ff=128, vocab=500)
TINY_LM_TRAFFIC = dict(seq_len=32, global_batch=4, microbatches=2)
TINY_RESNET = dict(stage_sizes=[1, 1, 1, 1], width=8, n_classes=16,
                   img_size=32)
TINY_RESNET_TRAFFIC = dict(global_batch=8)


def tiny(name: str, dtype: str = "float32") -> spec.Cell:
    """Cell ``name`` (of BENCHMARK.json or staged) at a CPU size, its
    weights and compute in ``dtype``, with its own limits."""
    if name in STAGED:
        conf, traffic = STAGED[name]
        cell = spec.Cell(name=name, chips=1, config=spec._json(
            HERE / "configs" / f"{conf}.json"),
            traffic=spec._json(spec.traffic_file(traffic)))
    else:
        cell = spec.find_cell(spec.load_benchmark(), name)
    lm = cell.arch == "lm"
    cell.config = dict(cell.config, **(TINY_LM if lm else TINY_RESNET),
                       dtype=dtype, param_dtype=dtype)
    cell.traffic = dict(cell.traffic,
                        **(TINY_LM_TRAFFIC if lm else TINY_RESNET_TRAFFIC))
    return cell


class FakeCounter:
    """A counter that steps by 100 J at every edge."""

    def __init__(self):
        self.j = 0.0

    def edge(self):
        self.j += 100.0
        return time.perf_counter(), self.j
