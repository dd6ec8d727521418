"""WorkloadRunner — executes one WorkloadSpec end to end.

Port of ``src/repro/bench/runner.py``: expand the point space (smoke
preset / ``--points`` overrides applied), select the power backend once
(labeled), call ``spec.build`` per point, run each returned step thunk
with retries and straggler detection, and persist normalized
``ResultRecord``s incrementally + a manifest.

The port runs on one device. A point whose placement spans more than one
device is not an error, as in the reference: it becomes a record with
``status="deferred"`` whose ``error`` names the mesh, the device count
and ROADMAP Queue 1 item 8, and the sweep's one-device cells still
measure (the reference also renders a Slurm script for such a point,
which waits for ``launch/slurm``, Queue 1 item 9). The runner stamps the
cross-placement scaling metrics (``records.stamp_scaling_metrics``)
into every sweep. The reference's environment tuning (``envtune``) has
no port.
"""
from __future__ import annotations

import pathlib
import time
from typing import Optional

import torch

from repro_torch.bench.context import RunContext
from repro_torch.bench.records import (
    ResultRecord, save_records, stamp_scaling_metrics,
)
from repro_torch.bench.spec import WorkloadSpec
from repro_torch.core.manifest import git_sha, write_manifest
from repro_torch.core.runner import StragglerWatchdog, run_attempts
from repro_torch.power.methods import select_power_methods


#: devices one port process drives
DEVICES = 1


class WorkloadRunner:
    def __init__(self, spec: WorkloadSpec, *, device: torch.device,
                 out_dir: str = "artifacts/bench_torch",
                 power: str = "auto",
                 warmup: int = 1, iters: int = 3,
                 smoke: bool = False,
                 point_overrides: Optional[dict] = None,
                 retries: int = 1,
                 power_interval_ms: float = 20.0):
        self.spec = spec
        self.device = device
        self.out = pathlib.Path(out_dir) / spec.name
        self.smoke = smoke
        self.point_overrides = point_overrides
        self.power_methods, self.power_source = select_power_methods(
            power, device)
        self.warmup = warmup
        self.iters = iters
        self.retries = retries
        self.power_interval_ms = power_interval_ms
        self.watchdog = StragglerWatchdog()
        self.records: list[ResultRecord] = []

    def run(self, verbose: bool = True) -> list[ResultRecord]:
        spec = self.spec
        self.out.mkdir(parents=True, exist_ok=True)
        write_manifest(self.out, self.device, {
            "workload": spec.name, "analog": spec.analog,
            "placement": spec.placement.label,
            "tags": sorted(spec.tags),
            "power_source": self.power_source, "smoke": self.smoke,
        })
        ctx = RunContext(device=self.device, out_dir=self.out,
                         power_methods=self.power_methods,
                         power_source=self.power_source,
                         power_interval_ms=self.power_interval_ms,
                         warmup=self.warmup, iters=self.iters,
                         smoke=self.smoke)
        points = spec.space_for(self.smoke, self.point_overrides).expand()
        for i, pt in enumerate(points):
            rec = self._run_point(pt, ctx)
            self.records.append(rec)
            if verbose:
                print(f"[{spec.name}] {i + 1}/{len(points)} {rec.flat()}",
                      flush=True)
            # scaling metrics join cells across the sweep, so re-derive
            # over the whole record list before each incremental save
            stamp_scaling_metrics(self.records)
            save_records(self.records, self.out)
        return self.records

    def _run_point(self, pt: dict, ctx: RunContext) -> ResultRecord:
        spec = self.spec
        ctx.last_measurement = None
        placement = spec.placement_for(pt)
        rec = ResultRecord(workload=spec.name, point=dict(pt),
                           power_source=self.power_source,
                           placement=placement.dict(),
                           git_sha=git_sha())
        if placement.n_devices > DEVICES:
            rec.status = "deferred"
            rec.error = (f"mesh {placement.label} needs "
                         f"{placement.n_devices} devices, process has "
                         f"{DEVICES} ({self.device}); multi-device "
                         f"placement is ROADMAP Queue 1 item 8")
            return rec
        ctx.placement = placement
        t0 = time.perf_counter()
        backoff_total = 0.0
        ok, step_fns, info = run_attempts(
            "build", lambda: spec.build(pt, ctx), self.retries,
            log_prefix=f"[{spec.name}] ", backoff_base=0.05)
        rec.attempts = info.attempts
        backoff_total += info.backoff_s
        if not ok:
            rec.status, rec.error = "error", step_fns["build_error"]
            return rec
        for name, fn in step_fns.items():
            ok, metrics, info = run_attempts(
                name, fn, self.retries, log_prefix=f"[{spec.name}] ",
                backoff_base=0.05)
            rec.attempts = max(rec.attempts, info.attempts)
            backoff_total += info.backoff_s
            if not ok:
                rec.status, rec.error = "error", metrics[f"{name}_error"]
                break
            rec.metrics.update(metrics or {})
        if backoff_total > 0.0 or rec.attempts > 1:
            rec.metrics["retry_backoff_s"] = round(backoff_total, 6)
        dt = time.perf_counter() - t0
        if self.watchdog.observe(len(self.records), dt):
            rec.metrics["straggler"] = True
        # noise: prefer the split timed-window spread of this point's own
        # ctx.measure call (pure repetition noise); the watchdog's
        # cross-point spread is the fallback for self-timed workloads
        m = ctx.last_measurement
        if m is not None and m.rel_spread is not None:
            rel_std, noise_src, samples = m.rel_spread, "measure_split", 2
        else:
            rel_std, noise_src, samples = (self.watchdog.rel_std(),
                                           "watchdog", self.watchdog.n)
        rec.noise = {"rel_std": round(rel_std, 6), "source": noise_src,
                     "samples": samples,
                     "point_seconds": round(dt, 6)}
        return rec
