"""Device milliseconds a step of the kernels that the program launches
inside its ``forward`` range: the loss function's call in
``train/step.py::value_and_grad``, on the calling thread (ResNet's
BatchNorm forward included)."""
from cbench.ranges import range_ms


def read(ctx):
    return range_ms(ctx, "forward")
