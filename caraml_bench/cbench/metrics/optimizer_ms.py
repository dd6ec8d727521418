"""Device milliseconds a step of the kernels that the program launches
inside its ``optimizer`` range (``train/optimizer.py``)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels \
            or "optimizer" not in ctx.trace.ranges:
        return None
    return ctx.trace.range_kernel_s("optimizer") / ctx.trace.steps * 1e3
