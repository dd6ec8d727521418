"""Device milliseconds a step of the kernels that the program launches
inside its ``backward`` range: every backward node of the loss in
``train/step.py::value_and_grad``, on the thread autograd runs them on
(ResNet's BatchNorm backward included)."""
from cbench.ranges import range_ms


def read(ctx):
    return range_ms(ctx, "backward")
