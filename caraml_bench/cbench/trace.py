"""The device trace of a few steps, and what the readers take from it.

:func:`capture` runs ``steps + 1`` steps under ``torch.profiler`` (CPU
and CUDA activity; the first step is the profiler's warm-up and is not
recorded), each step followed by a synchronise, and reads the exported
Chrome trace back into a :class:`Trace`: the device operations
(kernels, copies, fills), the kernel launches, the host ops and the
program's ``record_function`` ranges, linked by the profiler's
correlation ids. The traced window is the recorded steps' span
(``ProfilerStep#`` ranges, to the last device operation).
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")

#: kernels that compute matrix products: cuBLAS / cuBLASLt (``gemm``,
#: ``nvjet``, ``xmma``), cuDNN's convolutions, CUTLASS, and attention
#: kernels, fused or not, by name
MMA = re.compile(r"gemm|nvjet|xmma|cutlass|cublas|conv|fprop|dgrad|wgrad|"
                 r"implicit|winograd|flash|fmha|attention|splitk", re.I)
#: layout transforms that cuDNN launches beside a convolution
NOT_MMA = re.compile(r"nchwtonhwc|nhwctonchw|transpose", re.I)


def is_mma(name: str) -> bool:
    return bool(MMA.search(name)) and not NOT_MMA.search(name)


@dataclass
class Trace:
    steps: int
    window_s: float
    device: list = field(default_factory=list)   # (name, cat, t0, t1, corr)
    launches: dict = field(default_factory=dict)  # corr -> (t, tid)
    host: dict = field(default_factory=dict)      # tid -> sorted (t0, t1, name)
    ranges: dict = field(default_factory=dict)    # name -> [(t0, t1, tid)]
    start: float = 0.0

    @property
    def kernels(self) -> list:
        return [d for d in self.device if d[1] == "kernel"]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        total, end = 0.0, self.start
        for _n, _c, t0, t1, _k in sorted(self.device, key=lambda d: d[2]):
            if t1 > end:
                total += t1 - max(t0, end)
                end = t1
        return total

    def kernel_s(self, pick) -> float:
        return sum(t1 - t0 for n, c, t0, t1, _k in self.device
                   if c == "kernel" and pick(n))

    def range_kernel_s(self, name: str) -> float:
        """Device seconds of the kernels launched inside the host range
        ``name`` (on the thread that opened it)."""
        spans = defaultdict(list)
        for t0, t1, tid in self.ranges.get(name, []):
            spans[tid].append((t0, t1))
        corrs = {c for c, (t, tid) in self.launches.items()
                 if any(a <= t <= b for a, b in spans.get(tid, ()))}
        return sum(t1 - t0 for _n, cat, t0, t1, c in self.device
                   if cat == "kernel" and c in corrs)

    def top_ops(self, n: int = 10) -> list:
        """``[[name, seconds], ...]`` of the device operations that took
        the most time over the window, by name."""
        by = defaultdict(float)
        for name, _c, t0, t1, _k in self.device:
            by[name] += t1 - t0
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def _host_op(self, corr) -> str:
        """The innermost host op around the launch of ``corr``."""
        if corr not in self.launches:
            return "(no launch)"
        t, tid = self.launches[corr]
        ops = self.host.get(tid, [])
        i = bisect.bisect_right(ops, (t, float("inf"), "")) - 1
        while i >= 0:
            t0, t1, name = ops[i]
            if t1 >= t:
                return name
            i -= 1
        return "(outside any op)"

    def idle_gaps(self, n: int = 10, small_s: float = 10e-6) -> list:
        """``[[host op, seconds], ...]``: the device's idle time inside
        the window, each gap put under the host op that launched the
        operation ending it (gaps under ``small_s`` together as one
        entry), the ``n`` largest totals."""
        by = defaultdict(float)
        end = self.start
        for _n, _c, t0, t1, corr in sorted(self.device, key=lambda d: d[2]):
            if t0 > end:
                gap = t0 - end
                key = (self._host_op(corr) if gap >= small_s
                       else "(gaps under 10 us)")
                by[key] += gap
            end = max(end, t1)
        stop = self.start + self.window_s
        if stop > end:
            by["(after the last device op of a step)"] += stop - end
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


def parse(events: list) -> Trace:
    steps, device, launches = [], [], {}
    host, ranges = defaultdict(list), defaultdict(list)
    for e in events:
        cat, ph = e.get("cat"), e.get("ph")
        if ph != "X":
            continue
        t0 = float(e["ts"]) * 1e-6
        t1 = t0 + float(e.get("dur", 0.0)) * 1e-6
        args = e.get("args") or {}
        name = e.get("name", "")
        if cat in DEVICE_CATS:
            device.append((name, cat, t0, t1, args.get("correlation")))
        elif cat in RUNTIME_CATS and "correlation" in args:
            launches[args["correlation"]] = (t0, e.get("tid"))
        elif cat == "user_annotation":
            if name.startswith("ProfilerStep#"):
                steps.append((t0, t1))
            else:
                ranges[name].append((t0, t1, e.get("tid")))
        elif cat == "cpu_op":
            host[e.get("tid")].append((t0, t1, name))
    if not steps:
        raise ValueError("the trace holds no ProfilerStep range")
    start = min(a for a, _b in steps)
    stop = max([b for _a, b in steps] + [d[3] for d in device])
    device = [d for d in device if start <= d[2] <= stop]
    return Trace(steps=len(steps), window_s=stop - start, device=device,
                 launches=launches,
                 host={tid: sorted(v) for tid, v in host.items()},
                 ranges=dict(ranges), start=start)


def capture(step, steps: int, sync) -> Trace:
    """``step()`` ``steps + 1`` times under the profiler, each followed
    by ``sync()``; the first is the profiler's warm-up."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=steps,
                                       repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            for _ in range(steps + 1):
                step()
                sync()
                prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events)
