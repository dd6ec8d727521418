"""What the readers of the program's ranges share: device time launched
inside a range, and device idle time charged to ranges.

The program opens ``forward`` around the loss function's call,
``backward`` around every backward node of it (on the thread autograd
runs them on), ``batchnorm`` around each BatchNorm call and its
backward, and ``optimizer`` around the optimizer's update
(``repro_torch.core.ranges``). Idle time follows the rule of
``Trace.idle_gaps``, keyed by program range instead of host op and with
no floor: each gap between device operations inside the traced window
goes to the innermost of :data:`LAYERS` that holds, on the launching
thread, the launch of the operation that ends the gap. A gap that ends
at an operation launched outside them, and the tail after the window's
last operation, go to none.
"""
from __future__ import annotations

LAYERS = ("forward", "backward", "optimizer")


def range_ms(ctx, name: str):
    """Device ms a step of the kernels launched inside the range
    ``name``; None without kernels or without that range."""
    t = ctx.trace
    if t is None or not t.kernels or name not in t.ranges:
        return None
    return t.range_kernel_s(name) / t.steps * 1e3


def charged_idle_s(trace) -> tuple:
    """``({name: seconds}, rest)``: the window's idle seconds charged to
    each of :data:`LAYERS`, and those charged to none."""
    spans: dict = {}
    for name in LAYERS:
        for t0, t1, tid in trace.ranges.get(name, []):
            spans.setdefault(tid, []).append((t0, t1, name))
    charged = dict.fromkeys(LAYERS, 0.0)
    rest, end = 0.0, trace.start

    def owner(corr):
        if corr not in trace.launches:
            return None
        t, tid = trace.launches[corr]
        inside = [(t0, name) for t0, t1, name in spans.get(tid, ())
                  if t0 <= t <= t1]
        return max(inside)[1] if inside else None

    for _n, _c, t0, t1, corr in sorted(trace.device, key=lambda d: d[2]):
        if t0 > end:
            name = owner(corr)
            if name is None:
                rest += t0 - end
            else:
                charged[name] += t0 - end
        end = max(end, t1)
    rest += max(trace.start + trace.window_s - end, 0.0)
    return charged, rest


def idle_ms(ctx, name: str):
    """Device idle ms a step charged to the range ``name``; None
    without device operations or without that range."""
    t = ctx.trace
    if t is None or not t.device or name not in t.ranges:
        return None
    return charged_idle_s(t)[0][name] / t.steps * 1e3
