"""WorkloadRunner — executes one WorkloadSpec end to end.

Port of ``src/repro/bench/runner.py``: expand the point space (smoke
preset / ``--points`` overrides applied), select the power backend once
(labeled), call ``spec.build`` per point, run each returned step thunk
with retries and straggler detection, and persist normalized
``ResultRecord``s incrementally + a manifest.

The port runs on one device. A point whose placement spans more than one
device is not an error, as in the reference: the runner renders a
``launch.slurm`` job script sized to the point's mesh (one task per
GPU) into ``<out>/<workload>/slurm/`` and records the point with
``status="deferred"``, its ``error`` naming the mesh, the device count,
ROADMAP Queue 1 item 8 (the multi-rank launch the script starts waits
for it) and the script, and ``metrics["slurm_script"]`` its path; the
sweep's one-device cells still measure. The runner stamps the
cross-placement scaling metrics (``records.stamp_scaling_metrics``)
into every sweep, and a spec's ``compare_tols`` into each record's
``noise`` (``noise["tols"]``), which ``bench.compare`` reads, and the
applied environment tuning (``envtune``) into each record's metrics as
``env_tuning``.
"""
from __future__ import annotations

import math
import pathlib
import re
import time
from typing import Optional

import torch

from repro_torch.bench import envtune
from repro_torch.bench.context import RunContext
from repro_torch.bench.records import (
    ResultRecord, save_records, stamp_scaling_metrics,
)
from repro_torch.bench.spec import Placement, WorkloadSpec
from repro_torch.core.manifest import git_sha, write_manifest
from repro_torch.core.runner import StragglerWatchdog, run_attempts
from repro_torch.launch.slurm import render_bench_job
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
                 power_interval_ms: float = 20.0,
                 layers: Optional[int] = None):
        self.spec = spec
        self.device = device
        self.out = pathlib.Path(out_dir) / spec.name
        self.smoke = smoke
        self.point_overrides = point_overrides
        self.power = power
        self.power_methods, self.power_source = select_power_methods(
            power, device)
        self.warmup = warmup
        self.iters = iters
        self.retries = retries
        self.power_interval_ms = power_interval_ms
        self.layers = layers
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
                         smoke=self.smoke, layers=self.layers)
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

    def _defer_point(self, pt: dict, placement: Placement,
                     rec: ResultRecord) -> ResultRecord:
        """Render the Slurm script that carries an oversized mesh to a
        cluster; the record keeps the sweep's bookkeeping honest."""
        # one script per point (the placement label alone would let
        # same-mesh cells of a sweep clobber each other), forwarding this
        # run's power/out/warmup/iters so the cluster record joins the
        # local result set by point key
        slug = "_".join(f"{k}{pt[k]}" for k in sorted(pt)
                        if k != "placement")
        slug = re.sub(r"[^A-Za-z0-9._-]+", "-", slug)
        name = f"{self.spec.name}_{placement.label}" + (f"_{slug}" if slug
                                                        else "")
        script = render_bench_job(workload=self.spec.name,
                                  placement=placement, point=pt,
                                  out=str(self.out.parent), power=self.power,
                                  warmup=self.warmup, iters=self.iters,
                                  job_suffix=f"_{slug}" if slug else "")
        path = self.out / "slurm" / f"{name}.sbatch"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(script)
        rec.status = "deferred"
        rec.error = (f"mesh {placement.label} needs {placement.n_devices} "
                     f"devices, process has {DEVICES} ({self.device}); "
                     f"multi-device placement is ROADMAP Queue 1 item 8; "
                     f"sbatch script rendered to {path}")
        rec.metrics["slurm_script"] = str(path)
        return rec

    def _run_point(self, pt: dict, ctx: RunContext) -> ResultRecord:
        spec = self.spec
        ctx.last_measurement = None
        placement = spec.placement_for(pt)
        rec = ResultRecord(workload=spec.name, point=dict(pt),
                           power_source=self.power_source,
                           placement=placement.dict(),
                           git_sha=git_sha())
        if placement.n_devices > DEVICES:
            return self._defer_point(pt, placement, rec)
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
        # environment-tuning provenance (tcmalloc preload): a tuned run
        # must never silently compare against an untuned baseline as if
        # only the code changed
        tuning = envtune.active()
        if tuning:
            rec.metrics["env_tuning"] = tuning
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
        if spec.compare_tols:
            # the workload's declared tolerances ride with the record for
            # bench.compare; a non-finite one is stamped as "inf" (a bare
            # `Infinity` is not RFC JSON), which float() parses back
            rec.noise["tols"] = {
                k: v if isinstance(v, (int, float)) and math.isfinite(v)
                else "inf"
                for k, v in spec.compare_tols.items()}
        return rec
