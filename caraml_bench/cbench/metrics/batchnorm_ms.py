"""Device milliseconds a step of the kernels that the program launches
inside its ``batchnorm`` ranges (``models/resnet.py::batchnorm``): each
call, with its fp32 casts, and its backward, the casts' backward too.
Part of ``forward_ms`` and of ``backward_ms``."""
from cbench.ranges import range_ms


def read(ctx):
    return range_ms(ctx, "batchnorm")
