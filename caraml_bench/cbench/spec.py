"""Finding a cell's files by name.

``BENCHMARK.json`` sits at the root of the checkout, one level above the
benchmark's folder. A cell names a configuration (whose ``file`` holds
its sizes and its ``arch``) and a traffic mix (``traffic/<name>.json``);
the configuration's ``arch`` names the modules ``cbench.models.<arch>``,
``cbench.work.<arch>`` and ``cbench.reference.<arch>``; a per-layer
metric ``a.b`` is read by ``cbench.metrics.a``. A later cell, configuration or
metric is new files and new entries, with no edit to these.
"""
from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: Optional[Path] = None) -> dict:
    return _json(path or ROOT / "BENCHMARK.json")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict                 # the configuration file's contents
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    limits: dict = field(default_factory=dict)

    @property
    def arch(self) -> str:
        return self.config["arch"]


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with ``workloads`` applies to the cells it lists; a
    per-layer one without it, to every cell that reports the end-to-end
    metric it moves (``reported``); an end-to-end one without it, to
    every cell."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in reported
    return True


def traffic_file(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def limits_file(cell: str) -> Path:
    return BENCH_DIR / "limits" / f"{cell}.json"


def find_cell(bench: dict, name: str) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and
    metrics; ``KeyError`` for a name ``BENCHMARK.json`` lacks."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    lim = limits_file(name)
    return Cell(name=name, chips=int(entry["chips"]),
                config=_json(ROOT / conf["file"]),
                traffic=_json(traffic_file(entry["traffic"])),
                end_to_end=e2e, per_layer=per,
                limits=_json(lim) if lim.exists() else {})


def arch_module(kind: str, arch: str):
    """``cbench.<kind>.<arch>``: ``models``, ``work`` or ``reference``."""
    return importlib.import_module(f"cbench.{kind}.{arch}")


def metric_module(name: str):
    """The reader of per-layer metric ``name``: the module of the part
    before the first dot (``mfu.resnet`` -> ``cbench.metrics.mfu``)."""
    return importlib.import_module("cbench.metrics." + name.split(".")[0])
