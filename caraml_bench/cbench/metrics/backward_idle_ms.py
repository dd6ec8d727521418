"""Device idle milliseconds a step charged to the program's ``backward``
range: the gaps that end at an operation launched inside it, on the
thread autograd runs the backward on (``cbench.ranges``)."""
from cbench.ranges import idle_ms


def read(ctx):
    return idle_ms(ctx, "backward")
