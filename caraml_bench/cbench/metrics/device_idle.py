"""The share of the traced steps' wall time in which no device operation
ran (one minus the union of kernel, copy and fill intervals over the
window), in percent."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
