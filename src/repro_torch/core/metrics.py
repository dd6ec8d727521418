"""Serving figures of merit and energy attribution.

Copy of the serving part of ``src/repro/core/metrics.py``:
``percentile``, ``window_energy_wh``, ``attribute_energy``,
``ServeSummary`` and ``serve_summary``; and of ``tokens_per_s`` and
``images_per_s``, the training throughputs. The reference module also
imports its roofline package, so the port keeps its own copy.

The serve engine records per-step windows (``StepRecord``) plus
synchronous samples; ``attribute_energy`` takes each step window's
energy from them and splits it across the requests that received tokens
in that window, yielding Wh/token and Wh/request.

Samples are of one of two kinds (``PowerMethod.kind``): ``"power"``
(watts; a window's energy is the trapezoid of the linearly interpolated
power, as in the reference) or ``"energy"`` (a cumulative counter in
joules, which the port adds for NVML's energy counter: a window's energy
is the counter's difference across it, the counter interpolated
linearly between the sample times at which its value changed, see
:func:`counter_energy_wh`). Either way the windows of a run sum exactly
to its total.
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import Optional, Sequence

J_PER_WH = 3600.0


def tokens_per_s(global_batch: int, seq_len: int, iter_time_s: float) -> float:
    return global_batch * seq_len / max(iter_time_s, 1e-12)


def images_per_s(global_batch: int, iter_time_s: float) -> float:
    return global_batch / max(iter_time_s, 1e-12)


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (``q`` in [0, 100]); 0.0 for an empty
    sequence: the value at rank ``ceil(q/100 * n)`` (1-indexed), with the
    rank snapped to the nearest integer first so exact-multiple ranks do
    not round up a bucket."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    r = q / 100.0 * len(xs)
    if abs(r - round(r)) < 1e-9:
        r = round(r)
    i = min(max(math.ceil(r) - 1, 0), len(xs) - 1)
    return xs[i]


def _power_at(ts: Sequence[float], ws: Sequence[float], t: float) -> float:
    """Linear interpolation of sampled power at time t (clamped ends)."""
    if t <= ts[0]:
        return ws[0]
    if t >= ts[-1]:
        return ws[-1]
    i = bisect.bisect_right(ts, t)
    t0, t1 = ts[i - 1], ts[i]
    w0, w1 = ws[i - 1], ws[i]
    if t1 == t0:
        return w1
    return w0 + (w1 - w0) * (t - t0) / (t1 - t0)


def window_energy_wh(ts: Sequence[float], ws: Sequence[float],
                     t0: float, t1: float) -> float:
    """Trapezoid-integrate sampled power (watts) over [t0, t1] -> Wh."""
    if t1 <= t0 or len(ts) == 0:
        return 0.0
    if len(ts) == 1:
        return ws[0] * (t1 - t0) / J_PER_WH
    lo = bisect.bisect_right(ts, t0)
    hi = bisect.bisect_left(ts, t1)
    nodes = [t0] + list(ts[lo:hi]) + [t1]
    vals = [_power_at(ts, ws, t) for t in nodes]
    joules = sum(0.5 * (vals[i] + vals[i - 1]) * (nodes[i] - nodes[i - 1])
                 for i in range(1, len(nodes)))
    return joules / J_PER_WH


def counter_nodes(ts: Sequence[float],
                  js: Sequence[float]) -> tuple[list, list]:
    """The points a stepped cumulative counter is interpolated through:
    the first sample, each sample whose reading differs from the one
    before it (the first time a new value was seen), and the last
    sample. Between two updates the counter holds its value, so only
    these samples say when energy arrived."""
    if not len(ts):
        return [], []
    nt, nj = [ts[0]], [js[0]]
    for i in range(1, len(ts)):
        if js[i] != js[i - 1] or i == len(ts) - 1:
            nt.append(ts[i])
            nj.append(js[i])
    return nt, nj


def counter_energy_wh(ts: Sequence[float], js: Sequence[float],
                      t0: float, t1: float) -> float:
    """Energy over [t0, t1] from cumulative counter samples (joules):
    the difference of the counter interpolated linearly between the
    times at which its value changed (:func:`counter_nodes`), clamped
    to the first and last samples. Windows that tile the samples' span
    sum exactly to ``js[-1] - js[0]``."""
    if t1 <= t0 or len(ts) < 2:
        return 0.0
    nt, nj = counter_nodes(ts, js)
    return (_power_at(nt, nj, t1) - _power_at(nt, nj, t0)) / J_PER_WH


def energy_wh(ts: Sequence[float], vals: Sequence[float], t0: float,
              t1: float, kind: str = "power") -> float:
    """Energy over [t0, t1] from samples of ``kind`` ``"power"`` (watts,
    :func:`window_energy_wh`) or ``"energy"`` (cumulative joules,
    :func:`counter_energy_wh`)."""
    if kind == "energy":
        return counter_energy_wh(ts, vals, t0, t1)
    if kind != "power":
        raise ValueError(f"sample kind {kind!r}: power or energy")
    return window_energy_wh(ts, vals, t0, t1)


def attribute_energy(steps, ts: Sequence[float], ws: Sequence[float],
                     kind: str = "power") -> dict:
    """Per-request energy (Wh): each step window's energy splits equally
    across its ``rids`` (one entry per token credited). Energy outside
    any window stays unattributed (``ServeSummary.overhead_wh``).
    ``ws`` are samples of ``kind`` (see :func:`energy_wh`)."""
    out: dict = {}
    for s in steps:
        if not s.rids:
            continue
        share = energy_wh(ts, ws, s.t0, s.t1, kind) / len(s.rids)
        for rid in s.rids:
            out[rid] = out.get(rid, 0.0) + share
    return out


@dataclass
class ServeSummary:
    """Aggregate serving figures of merit over one engine run."""

    n_requests: int
    n_tokens: int               # generated tokens (all requests)
    wall_s: float               # first admission -> last finish
    decode_s: float             # sum of decode step windows
    prefill_s: float            # sum of prefill windows
    total_energy_wh: float      # integrated over the whole run
    attributed_wh: float        # sum of per-request attributions
    mean_ttft_s: float
    p95_ttft_s: float
    #: mean decode-step batch occupancy: active slots / n_slots averaged
    #: over decode micro-steps
    mean_occupancy: float = 0.0

    @property
    def decode_tok_s(self) -> float:
        """Useful generated tokens per second of wall time."""
        return self.n_tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def wh_per_token(self) -> float:
        return (self.attributed_wh / self.n_tokens) if self.n_tokens else 0.0

    @property
    def wh_per_request(self) -> float:
        return (self.attributed_wh / self.n_requests) if self.n_requests \
            else 0.0

    @property
    def overhead_wh(self) -> float:
        """Energy burned outside prefill/decode windows (idle, host)."""
        return max(self.total_energy_wh - self.attributed_wh, 0.0)


def serve_summary(results, steps, ts, ws,
                  n_slots: Optional[int] = None,
                  kind: str = "power") -> ServeSummary:
    """Build the aggregate summary from per-request results + step log;
    ``ws`` are samples of ``kind`` (see :func:`energy_wh`)."""
    results = list(results)
    ttfts = sorted(r.ttft_s for r in results) or [0.0]
    wall = (max(r.finish_s for r in results)
            - min(r.admitted_s for r in results)) if results else 0.0
    total = energy_wh(ts, ws, ts[0], ts[-1], kind) if len(ts) > 1 else 0.0
    decode = [s for s in steps if s.kind == "decode"]
    micro = sum(getattr(s, "n_steps", 1) for s in decode)
    occupancy = (sum(s.n_tokens for s in decode) / (n_slots * micro)
                 if n_slots and micro else 0.0)
    return ServeSummary(
        n_requests=len(results),
        n_tokens=sum(r.n_tokens for r in results),
        wall_s=wall,
        decode_s=sum(s.duration_s for s in decode),
        prefill_s=sum(s.duration_s for s in steps if s.kind == "prefill"),
        total_energy_wh=total,
        attributed_wh=sum(r.energy_wh for r in results),
        mean_ttft_s=sum(ttfts) / len(ttfts),
        p95_ttft_s=percentile(ttfts, 95.0),
        mean_occupancy=occupancy,
    )
