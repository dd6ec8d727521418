"""Supervised auto-resume: bounded restarts around the training loop.

Copy of ``src/repro/faults/supervisor.py``, imports rewritten to the
port's ``ckpt`` and ``faults.schedule``, with a rank world (below).

``run_supervised`` drives a ``run_once(hook)`` callable (build fresh
state, call ``train_loop`` with auto-resume pointed at a shared
``ckpt_dir``) through crashes: each crash costs an exponential-backoff
sleep (with seeded jitter), a resume from the newest *valid* checkpoint
(corrupted steps fall back to the previous atomic one), and — on
:class:`~repro_torch.faults.schedule.DeviceLoss` — an elastic rescale via
the caller's ``on_device_loss`` hook. The supervisor prices what resilience
costs: restarts, wasted (recomputed) steps, backoff seconds, and
``recovery_s`` — wall clock from the crash to the first completed step
of the resumed attempt.

In a rank world (``world``: ``barrier``, ``broadcast`` and ``writer``,
as ``parallel.sharding.DpCheckpoint`` has them) every rank runs the
supervisor around its own attempt. After a crash the ranks meet, so the
writer's last save and any corruption are on disk, and the writer
resolves the resume step for all of them: every rank counts fallbacks
and wasted steps from the same numbers and resumes at the same step.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.ckpt.checkpoint import resume_point
from repro_torch.faults.schedule import DeviceLoss


@dataclass
class SupervisorResult:
    result: Any                  # the final attempt's LoopResult
    restarts: int = 0
    crash_steps: list = field(default_factory=list)
    resume_steps: list = field(default_factory=list)
    wasted_steps: int = 0        # recomputed steps across all restarts
    recovery_s: float = 0.0      # crash -> first completed resumed step
    backoff_s: float = 0.0       # total injected backoff sleep
    rescales: int = 0            # device-loss rescale responses
    ckpt_fallbacks: int = 0      # resumes that skipped a corrupt newest ckpt


def run_supervised(run_once: Callable[[Callable], Any], *,
                   ckpt_dir,
                   max_restarts: int = 5,
                   backoff_base: float = 0.05,
                   backoff_factor: float = 2.0,
                   backoff_max: float = 2.0,
                   jitter: float = 0.25,
                   seed: int = 0,
                   sleep_fn: Callable[[float], None] = time.sleep,
                   clock: Callable[[], float] = time.monotonic,
                   on_device_loss: Optional[Callable] = None,
                   world=None,
                   ) -> SupervisorResult:
    """Run ``run_once(step_hook)`` to completion, restarting on crashes.

    ``run_once`` must accept one argument — a per-step hook with the
    training loop's ``(step, metrics, dt)`` signature — and re-resolve
    its resume point from ``ckpt_dir`` on every call. Crashing more
    than ``max_restarts`` times re-raises the last exception (bounded
    restarts: a deterministic bug must not loop forever). Backoff after
    restart ``k`` (1-indexed) is ``min(backoff_max, backoff_base *
    backoff_factor**(k-1))`` scaled by ``1 + jitter*U[0,1)`` from a
    ``random.Random(seed)`` — injectable ``sleep_fn``/``clock`` keep
    unit tests instant and the schedule reproducible.
    """
    out = SupervisorResult(result=None)
    rng = random.Random(seed)
    crash_t: Optional[float] = None
    step_seen = False

    def hook(step, metrics, dt):
        nonlocal step_seen
        if crash_t is not None and not step_seen:
            out.recovery_s += clock() - crash_t
        step_seen = True

    while True:
        step_seen = False
        try:
            out.result = run_once(hook)
            return out
        except Exception as e:
            out.restarts += 1
            if out.restarts > max_restarts:
                raise
            crash_step = getattr(e, "step", None)
            out.crash_steps.append(crash_step)
            crash_t = clock()
            if isinstance(e, DeviceLoss) and on_device_loss is not None:
                on_device_loss(e)
                out.rescales += 1
            if world is not None:
                world.barrier()
            newest, valid = resume_point(ckpt_dir, world) if ckpt_dir \
                else (None, None)
            resume = valid or 0
            out.resume_steps.append(resume)
            if newest is not None and resume != newest:
                out.ckpt_fallbacks += 1
            if crash_step is not None:
                out.wasted_steps += max(0, int(crash_step) - resume)
            k = out.restarts
            delay = min(backoff_max, backoff_base * backoff_factor ** (k - 1))
            delay *= 1.0 + jitter * rng.random()
            sleep_fn(delay)
            out.backoff_s += delay
