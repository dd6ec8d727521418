"""RunContext + Measurement: the runner-owned side of a workload run.

Port of ``src/repro/bench/context.py``: the selected power backend with
its label, warmup/iters timing with trapezoid-integrated energy, and a
cross-point memo. Where the reference blocks on ``jax.block_until_ready``
the port calls ``torch.cuda.synchronize(device)`` when the run is on the
card (PyTorch returns before the card has finished). The context carries
the run's explicit ``device``; the reference's ``mesh()`` has no port
(one device only, ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import pathlib
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from repro_torch.power.ctxmgr import get_power
from repro_torch.power.methods import PowerMethod


@dataclass(frozen=True)
class Measurement:
    """One timed region: seconds and energy per iteration, labeled."""

    seconds: float              # wall seconds per iteration
    energy_wh: float            # Wh per iteration (0.0 when power="none")
    power_source: str
    iters: int
    warmup: int
    #: relative spread between the two timed half-windows — a *same-point*
    #: repetition-noise estimate. None when the region ran as a single
    #: window (iters=1): one sample cannot estimate spread.
    rel_spread: Optional[float] = None

    @property
    def us(self) -> float:
        return self.seconds * 1e6

    @property
    def ms(self) -> float:
        return self.seconds * 1e3


class RunContext:
    """Per-run services handed to ``WorkloadSpec.build``.

    ``measure`` is the single timing/energy path for every workload;
    ``memo`` caches expensive setup (inputs, weights) across the points
    of a sweep; ``device`` is where the workload puts its tensors;
    ``power_methods``/``power_source`` are available directly for
    workloads that orchestrate their own measurement.
    """

    def __init__(self, *, device: torch.device, out_dir="artifacts/bench_torch",
                 power_methods: Sequence[PowerMethod] = (),
                 power_source: str = "none",
                 power_interval_ms: float = 20.0,
                 warmup: int = 1, iters: int = 3, smoke: bool = False,
                 layers: Optional[int] = None):
        self.device = device
        self.out_dir = pathlib.Path(out_dir)
        self.power_methods = list(power_methods)
        self.power_source = power_source
        self.power_interval_ms = power_interval_ms
        self.warmup = warmup
        self.iters = iters
        self.smoke = smoke
        #: the served model's depth when the run cuts it (``--layers``)
        self.layers = layers
        self.placement = None  # the current point's Placement (runner-set)
        self.cache: dict = {}
        self.last_measurement: Optional[Measurement] = None

    def memo(self, key, factory: Callable[[], object]):
        """Cross-point cache: build once, reuse for every sweep point."""
        if key not in self.cache:
            self.cache[key] = factory()
        return self.cache[key]

    def sync(self) -> None:
        """Wait for the card's queued work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def measure(self, fn: Callable, *args, warmup: Optional[int] = None,
                iters: Optional[int] = None, power: bool = True,
                **kw) -> Measurement:
        """Warmup + timed iterations around ``fn(*args, **kw)``.

        Synchronises with the card before reading the clock, so a time
        is wall time per call between syncs, launch included; wraps the
        timed window in the jpwr-style power scope when measurement is
        enabled, charging energy per iteration.

        With ``iters >= 2`` the timed region runs as two synchronised
        half-windows; the relative disagreement of their per-iteration
        times is returned as ``rel_spread``. Calls still queue
        asynchronously within each half, so only one extra sync is added
        per measurement.
        """
        warmup = self.warmup if warmup is None else warmup
        iters = max(self.iters if iters is None else iters, 1)
        for _ in range(warmup):
            fn(*args, **kw)
        self.sync()
        methods = self.power_methods if power else []
        halves = [iters] if iters < 2 else [iters - iters // 2, iters // 2]

        def timed_window(n: int) -> float:
            t0 = time.perf_counter()
            for _ in range(n):
                fn(*args, **kw)
            self.sync()
            return time.perf_counter() - t0

        if methods:
            with get_power(methods, self.power_interval_ms) as scope:
                times = [timed_window(n) for n in halves]
            energy = scope.total_energy_wh() / iters
        else:
            times = [timed_window(n) for n in halves]
            energy = 0.0
        dt = sum(times) / iters
        rel_spread = None
        if len(times) == 2 and dt > 0.0:
            per = [t / n for t, n in zip(times, halves)]
            rel_spread = abs(per[0] - per[1]) / dt
        m = Measurement(seconds=dt, energy_wh=energy,
                        power_source=self.power_source if power
                        else "none",
                        iters=iters, warmup=warmup, rel_spread=rel_spread)
        self.last_measurement = m
        return m
