"""WorkloadRunner — executes one WorkloadSpec end to end.

Port of ``src/repro/bench/runner.py``: expand the point space (smoke
preset / ``--points`` overrides applied), select the power backend once
(labeled), call ``spec.build`` per point, run each returned step thunk
with retries and straggler detection, and persist normalized
``ResultRecord``s incrementally + a manifest.

Placement-aware, as the reference: a point whose placement spans N
devices runs in N ranks (``launch.mesh``) when the process can start
them: on the CPU as gloo processes, up to the reference's cap
``REPRO_MAX_LOCAL_DEVICES`` (default 8); on cards as NCCL ranks, one a
card, when N is at most the card count. The runner spawns the ranks of
one placement once and runs every point of that placement in them; the
build gets the point's mesh through ``ctx.mesh()``, rank 0 measures and
returns the metrics, and this process writes the records (rank 0 alone
writes). A point that raises on any rank ends the ranks at once, and
every point of that placement is recorded ``error`` with the rank's
traceback. Under a launcher that started the ranks itself (``WORLD_SIZE``
in the environment, as ``launch/slurm.py``'s scripts set it) every rank
runs the points whose placement fills its world and rank 0 writes. The
power backend is billed for the point's N devices (``_power_for``). A
point the process cannot place is not an error: the runner renders a
``launch.slurm`` job script sized to the point's mesh (one task per GPU)
into ``<out>/<workload>/slurm/`` and records the point with
``status="deferred"``, its ``error`` naming the mesh, the device count
and the script, and ``metrics["slurm_script"]`` its path. The runner
stamps the cross-placement scaling metrics
(``records.stamp_scaling_metrics``) into every sweep, and a spec's
``compare_tols`` into each record's ``noise`` (``noise["tols"]``),
which ``bench.compare`` reads, and the applied environment tuning
(``envtune``) into each record's metrics as ``env_tuning``.
"""
from __future__ import annotations

import importlib
import math
import os
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
from repro_torch.bench.spec import Placement, WorkloadSpec, get_workload
from repro_torch.core.manifest import git_sha, write_manifest
from repro_torch.core.results import table
from repro_torch.core.runner import (
    AttemptInfo, StragglerWatchdog, run_attempts,
)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.slurm import render_bench_job
from repro_torch.power.methods import select_power_methods

#: ceiling on local CPU ranks (the reference's cap on forced host
#: devices): a dp64 point defers to a rendered Slurm job
LOCAL_DEVICE_CAP_ENV = "REPRO_MAX_LOCAL_DEVICES"
LOCAL_DEVICE_CAP = 8


def local_device_cap() -> int:
    try:
        return int(os.environ.get(LOCAL_DEVICE_CAP_ENV, LOCAL_DEVICE_CAP))
    except ValueError:
        return LOCAL_DEVICE_CAP


def local_ranks(device: torch.device) -> int:
    """Ranks one point may start here: gloo processes up to the cap on
    the CPU, one NCCL rank a card on cards."""
    if device.type == "cpu":
        return local_device_cap()
    return torch.cuda.device_count()


def _cpu_cores() -> Optional[int]:
    try:
        return len(os.sched_getaffinity(0)) or None
    except (AttributeError, OSError):
        return os.cpu_count()


def _execute(spec: WorkloadSpec, pt: dict, ctx: RunContext,
             retries: int, *, in_ranks: bool = False) -> dict:
    """Build one point and run its step thunks; a picklable outcome.

    ``in_ranks``: the point runs in one rank of a world, where an error
    propagates instead of being recorded (a retry or a skipped step on
    one rank would leave its peers in a collective)."""

    def attempt(name, fn):
        if in_ranks:
            return True, fn(), AttemptInfo()
        return run_attempts(name, fn, retries, log_prefix=f"[{spec.name}] ",
                            backoff_base=0.05)

    ctx.last_measurement = None
    t0 = time.perf_counter()
    out = {"status": "ok", "error": None, "metrics": {}, "attempts": 1,
           "backoff_s": 0.0}
    ok, step_fns, info = attempt("build", lambda: spec.build(pt, ctx))
    out["attempts"] = info.attempts
    out["backoff_s"] += info.backoff_s
    if not ok:
        out.update(status="error", error=step_fns["build_error"])
    else:
        for name, fn in step_fns.items():
            ok, metrics, info = attempt(name, fn)
            out["attempts"] = max(out["attempts"], info.attempts)
            out["backoff_s"] += info.backoff_s
            if not ok:
                out.update(status="error", error=metrics[f"{name}_error"])
                break
            out["metrics"].update(metrics or {})
    m = ctx.last_measurement
    out["rel_spread"] = None if m is None else m.rel_spread
    out["seconds"] = time.perf_counter() - t0
    return out


def _settings(runner: "WorkloadRunner") -> dict:
    return {"power": runner.power, "power_interval_ms":
            runner.power_interval_ms, "warmup": runner.warmup,
            "iters": runner.iters, "smoke": runner.smoke,
            "layers": runner.layers, "out": str(runner.out)}


def run_rank_points(world, spec_ref: tuple, placement: Placement,
                    points: list, settings: dict):
    """One rank's part of a placement's points: build the mesh, run
    every point, and return rank 0's outcomes (None on the other ranks).
    A point that raises on any rank raises out of it, so the world ends
    (:func:`launch.mesh.spawn` terminates every rank and re-raises the
    traceback). ``spec_ref`` is ``(module, name)``: importing the module
    that defines the spec registers it. Rank 0 alone holds the power
    backend, billed for the placement's devices."""
    importlib.import_module(spec_ref[0])
    spec = get_workload(spec_ref[1])
    mesh = mesh_mod.mesh_for(placement)
    methods, source = select_power_methods(
        settings["power"], world.device, n_devices=placement.n_devices)
    if world.rank != 0:
        methods = []
    ctx = RunContext(device=world.device, out_dir=settings["out"],
                     power_methods=methods, power_source=source,
                     power_interval_ms=settings["power_interval_ms"],
                     warmup=settings["warmup"], iters=settings["iters"],
                     smoke=settings["smoke"], layers=settings["layers"],
                     mesh=mesh)
    ctx.placement = placement
    outs = []
    for pt in points:
        try:
            outs.append(_execute(spec, pt, ctx, retries=1, in_ranks=True))
        except Exception as e:
            raise RuntimeError(
                f"rank {world.rank} failed at point {pt}") from e
    return outs if world.rank == 0 else None


class WorkloadRunner:
    def __init__(self, spec: WorkloadSpec, *, device: torch.device,
                 out_dir: str = "artifacts/bench_torch",
                 power: str = "auto",
                 warmup: int = 1, iters: int = 3,
                 smoke: bool = False,
                 point_overrides: Optional[dict] = None,
                 retries: int = 1,
                 power_interval_ms: float = 20.0,
                 layers: Optional[int] = None,
                 world: Optional[mesh_mod.World] = None):
        self.spec = spec
        self.device = device
        self.out = pathlib.Path(out_dir) / spec.name
        self.smoke = smoke
        self.point_overrides = point_overrides
        self.power = power
        self.power_methods, self.power_source = select_power_methods(
            power, device)
        self._power_by_n = {1: self.power_methods}
        #: a world this process joined from the environment (the ranks a
        #: launcher started); None when the runner spawns its own
        self.world = world
        #: outcomes of the points run in ranks, by placement label
        self._ranked: dict = {}
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
        cap = _cpu_cores() if self.device.type == "cpu" else None
        writer = self.world is None or self.world.rank == 0
        for i, pt in enumerate(points):
            rec = self._run_point(pt, ctx, points)
            self.records.append(rec)
            if verbose and writer:
                print(f"[{spec.name}] {i + 1}/{len(points)} {rec.flat()}",
                      flush=True)
            # scaling metrics join cells across the sweep, so re-derive
            # over the whole record list before each incremental save;
            # CPU ranks share the host's cores (the reference's cap)
            stamp_scaling_metrics(self.records, device_cap=cap)
            if writer:
                save_records(self.records, self.out)
        return self.records

    def result_table(self) -> str:
        """The last run's records as a markdown table of the spec's
        result columns (the reference's ``result_table``)."""
        return table([r.flat() for r in self.records],
                     self.spec.result_columns)

    def _power_for(self, n_devices: int) -> list:
        """Power methods sized to one point's mesh: a dpN cell is billed
        N devices."""
        if n_devices not in self._power_by_n:
            self._power_by_n[n_devices], _ = select_power_methods(
                self.power, self.device, n_devices=n_devices)
        return self._power_by_n[n_devices]

    def _outcomes_of(self, placement: Placement, points: list) -> dict:
        """Outcomes of every point of ``placement``, run in its ranks the
        first time one of them comes up; keyed by point index."""
        key = placement.label
        if key not in self._ranked:
            idx = [i for i, pt in enumerate(points)
                   if self.spec.placement_for(pt) == placement]
            mine = [points[i] for i in idx]
            ref = (self.spec.build.__module__, self.spec.name)
            if self.world is not None:
                # ranks a launcher started: a failure ends this process,
                # and the launcher the job
                outs = run_rank_points(self.world, ref, placement, mine,
                                       _settings(self))
            else:
                try:
                    outs = mesh_mod.spawn(
                        run_rank_points, placement.n_devices,
                        args=(ref, placement, mine, _settings(self)),
                        device=self.device)[0]
                except RuntimeError as e:   # a rank raised or died
                    # the world ended there: every point of it fails
                    err = f"ranks of {placement.label} failed: {e}"
                    outs = [{"status": "error", "error": err,
                             "metrics": {}, "attempts": 1,
                             "backoff_s": 0.0, "rel_spread": None,
                             "seconds": 0.0}] * len(mine)
            self._ranked[key] = dict(zip(idx, outs or [None] * len(idx)))
        return self._ranked[key]

    def _can_place(self, placement: Placement) -> bool:
        n = placement.n_devices
        if self.world is not None:
            return n == self.world.world_size
        return n == 1 or n <= local_ranks(self.device)

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
        have = (self.world.world_size if self.world is not None
                else local_ranks(self.device))
        rec.error = (f"mesh {placement.label} needs {placement.n_devices} "
                     f"devices, process can place {have} "
                     f"({self.device}); sbatch script rendered to {path}")
        rec.metrics["slurm_script"] = str(path)
        return rec

    def _run_point(self, pt: dict, ctx: RunContext,
                   points: list) -> ResultRecord:
        spec = self.spec
        placement = spec.placement_for(pt)
        rec = ResultRecord(workload=spec.name, point=dict(pt),
                           power_source=self.power_source,
                           placement=placement.dict(),
                           git_sha=git_sha())
        if not self._can_place(placement):
            return self._defer_point(pt, placement, rec)
        if placement.n_devices == 1 and self.world is None:
            ctx.placement = placement
            ctx.power_methods = self._power_for(1)
            out = _execute(spec, pt, ctx, self.retries)
        else:
            out = self._outcomes_of(placement, points)[points.index(pt)]
            if out is None:         # a rank that writes no record
                rec.status = "ok"
                return rec
        rec.status, rec.error = out["status"], out["error"]
        rec.metrics.update(out["metrics"])
        rec.attempts = out["attempts"]
        backoff_total = out["backoff_s"]
        if backoff_total > 0.0 or rec.attempts > 1:
            rec.metrics["retry_backoff_s"] = round(backoff_total, 6)
        # environment-tuning provenance (tcmalloc preload): a tuned run
        # must never silently compare against an untuned baseline as if
        # only the code changed
        tuning = envtune.active()
        if tuning:
            rec.metrics["env_tuning"] = tuning
        dt = out["seconds"]
        if self.watchdog.observe(len(self.records), dt):
            rec.metrics["straggler"] = True
        # noise: prefer the split timed-window spread of this point's own
        # ctx.measure call (pure repetition noise); the watchdog's
        # cross-point spread is the fallback for self-timed workloads
        if out["rel_spread"] is not None:
            rel_std, noise_src, samples = out["rel_spread"], "measure_split", 2
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
