"""Kernel launches a step of the train step's host dispatch: the kernels
in the device trace of the traced steps, over the steps (an exact
count)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.trace.steps
