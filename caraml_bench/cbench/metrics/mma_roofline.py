"""The matrix-product kernels' share of their roofline: the least time
of the step's needed products (``cbench.work``: operations at the bf16
peak or bytes at the memory bandwidth, whichever is longer, for each
product) over the device time of the kernels that compute products
(``cbench.trace.is_mma``), a step, in percent. Recomputed products and
work that the formulas do not need count in the time only."""
from cbench.trace import is_mma


def read(ctx):
    if ctx.trace is None or not ctx.ops:
        return None
    spent = ctx.trace.kernel_s(is_mma) / ctx.trace.steps
    if spent <= 0:
        return None
    return 100.0 * ctx.least_s_per_step() / spent
