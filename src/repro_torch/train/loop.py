"""Training loop with the fault-tolerance features the paper's scale needs:
auto-resume from the latest checkpoint, async periodic checkpointing,
straggler watchdog, throughput accounting.

Port of ``src/repro/train/loop.py``; the loop is the reference's, line
for line. Reading each step's loss (``float``) waits for the card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.ckpt.checkpoint import (CheckpointManager, latest_step,
                                         latest_valid_step,
                                         restore_resilient)
from repro_torch.core.metrics import tokens_per_s
from repro_torch.core.runner import StragglerWatchdog
from repro_torch.faults.schedule import (DeviceLoss, FaultSchedule,
                                         InjectedCrash, corrupt_checkpoint)

Params = Any


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    seq_len: int = 512
    global_batch: int = 8
    keep_ckpts: int = 3


@dataclass
class LoopResult:
    steps_run: int
    final_step: int
    losses: list
    tokens_per_s: float
    straggler_events: list
    resumed_from: Optional[int]
    ckpt_skipped: list = field(default_factory=list)  # corrupt steps skipped


def train_loop(train_step: Callable, params: Params, opt_state: Params,
               data_iter, cfg: LoopConfig, *,
               hooks: Optional[list[Callable]] = None,
               fail_at_step: Optional[int] = None,
               faults: Optional[FaultSchedule] = None,
               sleep_fn: Callable[[float], None] = time.sleep,
               dp=None) -> LoopResult:
    """Run training with auto-resume + async checkpointing.

    ``data_iter`` may be a plain iterator or a *step-indexed* callable
    ``data(step) -> batch``; the callable form keeps the data stream
    aligned with the step counter across crash/resume, which is what
    makes a resumed run bit-identical to an uninterrupted one.

    ``fail_at_step`` injects a simulated failure: the loop raises after
    that step, and a rerun with the same ckpt_dir resumes from the
    latest checkpoint. ``faults`` is the general form — a seeded
    :class:`FaultSchedule` whose crash-class events (crash / device loss
    / checkpoint corruption) raise here and whose slowdown events
    stretch the timed step (so the straggler watchdog sees them).
    Resume goes through ``restore_resilient``: corrupted checkpoints are
    skipped (recorded in ``ckpt_skipped``) and the previous atomic step
    is used instead.

    ``dp`` (``parallel.sharding.DpCheckpoint``) is a dp world's
    checkpoint rule: ZeRO-1 slices gathered on save, rank 0 writing, and
    cut again on restore, at whatever dp size resumes.
    """
    mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts, dp=dp) \
        if cfg.ckpt_dir else None
    start_step = 0
    resumed_from = None
    ckpt_skipped: list = []
    if mgr is not None and latest_step(cfg.ckpt_dir) is not None:
        if latest_valid_step(cfg.ckpt_dir) is not None:
            (params, opt_state), manifest, ckpt_skipped = restore_resilient(
                (params, opt_state), cfg.ckpt_dir, dp=dp)
            start_step = manifest["step"]
            resumed_from = start_step
        # else: only corrupt checkpoints exist — start from scratch

    get_batch = (data_iter if callable(data_iter)
                 else lambda _step, it=iter(data_iter): next(it))
    watchdog = StragglerWatchdog()
    losses = []
    t_start = time.perf_counter()
    step = start_step
    n_run = 0
    for step in range(start_step, cfg.total_steps):
        batch = get_batch(step)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        if faults is not None:
            slow = faults.slowdown_s(step + 1)
            if slow > 0:
                sleep_fn(slow)  # inside the timed region: watchdog sees it
        dt = time.perf_counter() - t0
        watchdog.observe(step, dt)
        losses.append(loss)
        n_run += 1
        if hooks:
            for h in hooks:
                h(step, metrics, dt)
        if cfg.log_every and (step + 1) % cfg.log_every == 0:
            tps = tokens_per_s(cfg.global_batch, cfg.seq_len, dt)
            print(f"  step {step + 1}/{cfg.total_steps} loss={loss:.4f} "
                  f"({dt * 1e3:.0f} ms, {tps:,.0f} tok/s)")
        if mgr is not None and (step + 1) % cfg.ckpt_every == 0:
            mgr.save_async((params, opt_state), step + 1)
        if fail_at_step is not None and step + 1 >= fail_at_step:
            if mgr is not None:
                mgr.wait()
            raise InjectedCrash(step + 1)
        if faults is not None:
            ev = faults.crash_at(step + 1)
            if ev is not None:
                if mgr is not None:
                    mgr.wait()  # the crash lands after any in-flight save
                if ev.kind == "ckpt_corrupt" and cfg.ckpt_dir:
                    corrupt_checkpoint(cfg.ckpt_dir)
                if ev.kind == "device_loss":
                    raise DeviceLoss(step + 1, ev.n)
                raise InjectedCrash(step + 1)
    if mgr is not None:
        mgr.save_sync((params, opt_state), cfg.total_steps)
        mgr.wait()
    wall = time.perf_counter() - t_start
    tps = (n_run * cfg.global_batch * cfg.seq_len) / max(wall, 1e-9)
    return LoopResult(n_run, step + 1 if n_run else start_step, losses, tps,
                      watchdog.events, resumed_from, ckpt_skipped)
