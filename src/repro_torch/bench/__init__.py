"""repro_torch.bench — the port's WorkloadSpec benchmark subsystem.

Port of ``src/repro/bench``: one registry, one runner, one CLI.

  python -m repro_torch.bench list
  python -m repro_torch.bench run --suite kernels          # on the card
  python -m repro_torch.bench run --suite kernels --smoke --device cpu \
      --power none
  python -m repro_torch.bench report
  python -m repro_torch.bench compare BASELINE CURRENT [--promote]

Benchmarks declare a :class:`WorkloadSpec` via the :func:`workload`
decorator (see ``repro_torch.bench.workloads``); :class:`WorkloadRunner`
executes them with runner-owned power selection, warmup/iters timing,
retries, and straggler detection, emitting schema-versioned
:class:`ResultRecord`s under ``artifacts/bench_torch/<workload>/``.
"""
from repro_torch.bench.compare import (
    Comparison, MetricDelta, PointComparison, compare_sets,
    load_result_set, promote,
)
from repro_torch.bench.context import Measurement, RunContext
from repro_torch.bench.records import (
    COMPARED_METRICS, SCHEMA_VERSION, ResultRecord, compare_metrics,
    load_records, placement_label, point_key, save_records,
)
from repro_torch.bench.runner import WorkloadRunner
from repro_torch.bench.spec import (
    Placement, UnknownWorkloadError, WorkloadSpec, get_workload,
    iter_workloads, register, unregister, workload, workload_names,
)

__all__ = [
    "Comparison", "MetricDelta", "PointComparison", "compare_sets",
    "load_result_set", "promote",
    "Measurement", "RunContext", "COMPARED_METRICS", "SCHEMA_VERSION",
    "ResultRecord", "compare_metrics", "load_records", "placement_label",
    "point_key", "save_records",
    "WorkloadRunner", "Placement", "UnknownWorkloadError", "WorkloadSpec",
    "get_workload", "iter_workloads", "register", "unregister", "workload",
    "workload_names",
]
