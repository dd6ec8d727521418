"""One run of one cell: set-up, the measured window, the check.

Set-up builds the program once (``cbench.models.<arch>.Program``: the
port's train step, its params made from the seed and its own optimizer
state) and drives it through the first ``CHECK_STEPS`` steps on the
traffic's first batches, taking the readings that the check compares;
those steps also warm every shape the window uses. The window then
trains the same object on the following batches for ``--seconds``
seconds, a synchronise after each step, between two steps of NVML's
energy counter. With ``--trace 1`` a few more steps run under the
profiler after the window. Once the window has closed and the peak
memory is read, the program is freed and the float32 reference
(``cbench.reference``) follows the same steps from the same weights and
batches, made again from the seed.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from cbench import check, spec, weights
from cbench.chip import peaks
from cbench.reference import adamw
from cbench.reference.lowp import Precision, strict_fp32
from cbench.traffic import Feed
from cbench.work import least_seconds, total_flops

CHECK_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by whole top-level name."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    steps: int = 0
    seconds: float = 0.0
    items: int = 0
    energy_j: float = 0.0      # over the window
    power_w: float = 0.0       # the counter's mean over its two steps
    failed: int = 0


@dataclass
class Context:
    """What a per-layer metric's reader reads."""

    cell: spec.Cell
    window: Window
    trace: Optional[object] = None
    peaks: dict = field(default_factory=dict)
    ops: list = field(default_factory=list)   # cbench.work.Op, a step

    @property
    def flops_per_step(self) -> float:
        return total_flops(self.ops)

    def least_s_per_step(self) -> float:
        return least_seconds(self.ops, self.peaks["bf16_flops"],
                             self.peaks["hbm_bytes_per_s"])


def param_dtype(cell: spec.Cell) -> torch.dtype:
    """The dtype the configuration serves its weights in."""
    return getattr(torch, cell.config["param_dtype"])


def program_readings(prog, feed, specs, cell, seed, device,
                     vectors: bool = False) -> dict:
    """Run the first ``CHECK_STEPS`` steps and read them (see
    ``cbench.check``); ``vectors`` also keeps the first gradient itself,
    on the host (the window must not hold it on the card)."""
    opt = cell.config["optimizer"]
    losses, gnorm1, grad = [], None, None
    for t in range(CHECK_STEPS):
        m = prog.step(feed.next())
        losses.append(m["loss"].float())
        if t == 0:
            gnorm1 = m["gnorm"].float()
            moments = prog.first_moments()
            norms = torch.stack([moments[n].float().norm()
                                 for n, *_ in specs])
            scale = torch.clamp(opt["grad_clip"] / gnorm1.clamp_min(1e-12),
                                max=1.0)
            grad = norms / (1 - opt["b1"]) / scale
            if vectors:
                vec = {n: (moments[n].float() / (1 - opt["b1"]) / scale)
                       .cpu() for n, *_ in specs}
    init = weights.make(specs, seed, device, param_dtype(cell))
    masters = prog.masters()
    change = torch.stack([(masters[n] - init[n].float()).norm()
                          for n, *_ in specs])
    names = [n for n, *_ in specs]
    out = {"losses": torch.stack(losses).tolist(),
           "grad": dict(zip(names, grad.tolist())),
           "change": dict(zip(names, change.tolist()))}
    if vectors:
        out["grad_vec"] = vec
    return out


def reference_readings(cell, seed, device, precision="fp32",
                       half_batch=False, nudge=0.0, vectors=False,
                       frozen=False) -> dict:
    """The reference (or the control, in ``precision``) over the same
    first steps, from the weights and batches made again from the
    seed; ``half_batch`` plants the fault of half the rows left out;
    ``nudge`` scales each weight by ``1 + nudge * N(0, 1)`` (a
    perturbation far below any dtype's rounding, to see how much the
    compared numbers move by themselves); ``frozen`` plants the fault of
    a step that returns its state unchanged."""
    ref = spec.arch_module("reference", cell.arch)
    specs = spec.arch_module("models", cell.arch).leaf_specs(cell.config)
    feed = Feed(cell.traffic, cell.config, seed, device)
    batches = [feed.next() for _ in range(CHECK_STEPS)]
    if half_batch:
        batches = [{k: v[:v.shape[0] // 2] for k, v in b.items()}
                   for b in batches]
    init = weights.make(specs, seed, device, param_dtype(cell))
    if nudge:
        gen = torch.Generator(device=device).manual_seed(1)
        init = {n: w.float() * (1 + nudge * torch.randn(
            w.shape, generator=gen, device=device)) for n, w in init.items()}
    prec = Precision(precision)
    with strict_fp32():
        return adamw.follow(
            lambda P, b: ref.loss_and_grads(cell.config, P, b, prec),
            init, batches, cell.config["optimizer"], vectors, frozen)


def measure(prog, feed, seconds: float, counter, device) -> Window:
    """Train ``prog`` for ``seconds`` (whole steps, a synchronise after
    each), between two steps of the energy counter."""
    sync(device)
    t0, j0 = counter.edge()
    losses, steps = [], 0
    while True:
        m = prog.step(feed.next())
        losses.append(m["loss"])
        sync(device)
        steps += 1
        t = time.perf_counter()
        if t - t0 >= seconds:
            break
    t1, j1 = counter.edge()
    finite = torch.isfinite(torch.stack(losses).float())
    w = Window(steps=steps, seconds=t - t0,
               items=steps * feed.items_per_step(),
               failed=int((~finite).sum()))
    w.power_w = (j1 - j0) / (t1 - t0)
    w.energy_j = w.power_w * w.seconds
    return w


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, *,
        device, counter, kind: str, t_start: float, log=print,
        program_hook=None) -> dict:
    """One run; returns the result's line as a dict. ``program_hook``
    wraps the program (the fault tests break it there)."""
    models = spec.arch_module("models", cell.arch)
    specs = models.leaf_specs(cell.config)
    named = weights.make(specs, seed, device, param_dtype(cell))
    prog = models.Program(cell.config, cell.traffic, named, device)
    if program_hook is not None:
        prog = program_hook(prog)
    feed = Feed(cell.traffic, cell.config, seed, device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    vectors = check.needs_vectors(cell.limits)
    got = program_readings(prog, feed, specs, cell, seed, device, vectors)
    sync(device)
    setup_s = time.perf_counter() - t_start
    win = measure(prog, feed, seconds, counter, device)
    trace = None
    if traced:
        from cbench import trace as trace_mod
        trace = trace_mod.capture(lambda: prog.step(feed.next()),
                                  int(cell.traffic["trace_steps"]),
                                  lambda: sync(device))
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    log(f"[run] {cell.name} seed {seed}: setup {setup_s:.3f} s, window "
        f"{win.seconds:.3f} s, {win.steps} steps, {win.items} "
        f"{models.ITEMS}, {win.power_w:.1f} W, peak memory {peak} bytes")
    del prog, named, feed
    free(device)
    t_ref = time.perf_counter()
    ref = reference_readings(cell, seed, device, vectors=vectors)
    values = check.gaps(got, ref)
    correct, checks = check.verdict(values, cell.limits)
    correct = correct and win.failed == 0
    log(f"[run] reference {time.perf_counter() - t_ref:.3f} s; losses "
        f"program {got['losses']} reference {ref['losses']}")

    ctx = Context(cell=cell, window=win, trace=trace,
                  peaks=peaks(kind) if kind else {},
                  ops=spec.arch_module("work", cell.arch).step_ops(
                      cell.config, cell.traffic))
    metrics = {}
    if traced:
        for m in cell.per_layer:
            v = spec.metric_module(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = _end_to_end(m["name"], win, setup_s)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else torch.device(device).type,
           "kind": kind, "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": win.steps,
           "failed": win.failed, "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": trace.top_ops(),
                            "idle_gaps": trace.idle_gaps()}
    out["checks"] = checks
    return out


def _end_to_end(name: str, win: Window, setup_s: float):
    """The end-to-end metric ``name``: ``setup_s``, or a rate of the
    window's items (``<items>_per_s``, ``<items>_per_wh``)."""
    if name == "setup_s":
        return setup_s
    if name.endswith("_per_s"):
        return win.items / win.seconds
    if name.endswith("_per_wh"):
        return win.items / (win.energy_j / 3600.0) if win.energy_j > 0 \
            else math.nan
    return None
