"""Suite runner: executes benchmark points with power measurement,
retries, straggler detection, and incremental result persistence.

This is the JUBE runtime analog: it expands the parameter space, runs each
(point x step), wraps execution in the jpwr-style get_power context, and
renders the final result table.

Copy of ``src/repro/core/runner.py``, with the port's power scope and
manifest: ``Runner`` takes the ``device`` its manifest records (the
card unless the caller passes ``device="cpu"``).
``repro_torch.bench.runner.WorkloadRunner`` runs every workload step
through :func:`run_attempts`.
"""
from __future__ import annotations

import logging
import pathlib
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from repro_torch.core.manifest import write_manifest
from repro_torch.core.results import save_results, table
from repro_torch.core.suite import BenchmarkSuite, Step
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.power.ctxmgr import get_power
from repro_torch.power.methods import PowerMethod

logger = logging.getLogger("repro_torch.bench")


@dataclass
class StragglerWatchdog:
    """EWMA step-time monitor: flags steps slower than mean + k*std.

    At cluster scale this drives the mitigation policy (skip shard /
    checkpoint-and-rebalance); here it records events for the report and
    is unit-tested with simulated stragglers.

    Warmup samples seed both the mean AND the variance: judging the first
    post-warmup step against a zero-variance baseline would flag ordinary
    jitter whenever the warmup steps happened to disagree.
    """
    k: float = 3.0
    alpha: float = 0.2
    warmup: int = 3
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    events: list = field(default_factory=list)
    _warmup_m2: float = 0.0     # Welford sum of squared deviations

    def observe(self, step_idx: int, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            if self.n == 1:
                self.mean = dt
            else:
                delta = dt - self.mean
                self.mean += delta / self.n
                self._warmup_m2 += delta * (dt - self.mean)
                # sample variance of the warmup window so far
                self.var = self._warmup_m2 / (self.n - 1)
            return False
        straggler = dt > self.mean + self.k * max(self.var ** 0.5,
                                                  0.05 * self.mean)
        delta = dt - self.mean
        self.mean += self.alpha * delta
        self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        if straggler:
            self.events.append({"step": step_idx, "dt": dt,
                                "mean": self.mean})
        return straggler

    def rel_std(self) -> float:
        """Observed relative step-time spread (std/mean), 0.0 until the
        warmup window has produced a variance estimate.

        This is the noise figure the cross-run comparison engine widens
        its per-metric tolerance by: a run whose own step times wobbled
        10% cannot support a 5% regression verdict.
        """
        if self.n < 2 or self.mean <= 0.0:
            return 0.0
        return max(self.var, 0.0) ** 0.5 / self.mean


#: exception types that retrying cannot fix: bad arguments/config, not
#: transient runtime conditions. Fail fast so a typo'd sweep doesn't
#: burn its retry budget per point.
_FATAL_TYPES = (ValueError, TypeError, KeyError, AssertionError)
#: transient-by-name: serve's CacheOOM is retryable but core must not
#: import serve (layering), so classify by class name.
_TRANSIENT_NAMES = ("CacheOOM",)


def classify_error(e: BaseException) -> bool:
    """True if ``e`` is worth retrying. An explicit ``transient``
    attribute (e.g. on injected faults) wins; then known-transient
    names; then known-fatal types; everything else is retried (the
    legacy default — an unknown crash may well be environmental)."""
    t = getattr(e, "transient", None)
    if t is not None:
        return bool(t)
    if type(e).__name__ in _TRANSIENT_NAMES:
        return True
    return not isinstance(e, _FATAL_TYPES)


@dataclass
class AttemptInfo:
    """How an attempted step actually went: attempts used, total backoff
    slept, and whether the final error was classified fatal."""
    attempts: int = 1
    backoff_s: float = 0.0
    fatal: bool = False


def run_attempts(name: str, fn: Callable[[], dict], retries: int,
                 *, log_prefix: str = "",
                 backoff_base: float = 0.0,
                 backoff_factor: float = 2.0,
                 backoff_max: float = 2.0,
                 jitter: float = 0.25,
                 seed: int = 0,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 classify: Callable[[BaseException], bool] = classify_error):
    """Run ``fn`` up to ``retries`` times with exponential backoff.

    Returns ``(ok, metrics, info)`` where ``info`` is an
    :class:`AttemptInfo`. Errors the ``classify`` predicate calls fatal
    (``ValueError`` and friends) fail fast — no further attempts;
    transient ones (``CacheOOM``, injected faults) are retried after
    ``min(backoff_max, backoff_base * backoff_factor**(k-1))`` seconds
    scaled by ``1 + jitter*U[0,1)`` (seeded, so sweeps are
    reproducible; ``backoff_base=0`` keeps the legacy no-sleep
    behavior). Every failed attempt is logged (message + traceback at
    debug level); on exhaustion the last exception is summarized in
    the returned metrics.
    """
    import random as _random
    last_err: Optional[BaseException] = None
    retries = max(retries, 1)
    rng = _random.Random(seed)
    info = AttemptInfo()
    for attempt in range(1, retries + 1):
        info.attempts = attempt
        try:
            return True, fn(), info
        except Exception as e:  # noqa: BLE001 - benchmark must continue
            last_err = e
            transient = classify(e)
            logger.warning("%sstep %r attempt %d/%d failed (%s): %s: %s",
                           log_prefix, name, attempt, retries,
                           "transient" if transient else "fatal",
                           type(e).__name__, e)
            logger.debug("%sstep %r attempt %d traceback:\n%s",
                         log_prefix, name, attempt,
                         traceback.format_exc())
            if not transient:
                info.fatal = True
                break
            if attempt < retries and backoff_base > 0.0:
                delay = min(backoff_max,
                            backoff_base * backoff_factor ** (attempt - 1))
                delay *= 1.0 + jitter * rng.random()
                sleep_fn(delay)
                info.backoff_s += delay
    return False, {f"{name}_error":
                   f"{type(last_err).__name__}: {last_err}"}, info


class Runner:
    def __init__(self, suite: BenchmarkSuite, *,
                 power_methods: Sequence[PowerMethod] = (),
                 out_dir: str = "artifacts/bench_torch",
                 tags: Optional[set] = None,
                 power_interval_ms: float = 50.0,
                 device: DeviceLike = None):
        self.suite = suite
        self.power_methods = list(power_methods)
        self.out = pathlib.Path(out_dir) / suite.name
        self.tags = tags
        self.power_interval_ms = power_interval_ms
        self.device = resolve_device(device)
        self.records: list[dict] = []

    def run(self, verbose: bool = True) -> list[dict]:
        self.out.mkdir(parents=True, exist_ok=True)
        write_manifest(self.out, self.device, {"suite": self.suite.name})
        steps = self.suite.select_steps(self.tags)
        points = self.suite.points()
        for i, pt in enumerate(points):
            context: dict = {"out_dir": str(self.out)}
            rec = dict(pt)
            for step in steps:
                ok, metrics = self._run_step(step, pt, context)
                rec.update(metrics)
                if not ok:
                    break
            self.records.append(rec)
            if verbose:
                print(f"[{self.suite.name}] {i + 1}/{len(points)} {rec}")
            save_results(self.records, self.out, "results")
        return self.records

    def _run_step(self, step: Step, pt: dict, context: dict):
        def attempt():
            if self.power_methods:
                with get_power(self.power_methods,
                               self.power_interval_ms) as scope:
                    metrics = step.fn(pt, context)
                edf, _ = scope.energy()
                metrics[f"{step.name}_energy_wh"] = float(
                    sum(edf.col("energy_wh")))
            else:
                metrics = step.fn(pt, context)
            return metrics

        ok, metrics, info = run_attempts(
            step.name, attempt, step.retries,
            log_prefix=f"[{self.suite.name}] ")
        metrics[f"{step.name}_attempts"] = info.attempts
        return ok, metrics

    def result_table(self) -> str:
        return table(self.records, self.suite.result_columns)
