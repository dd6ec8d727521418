"""Device idle milliseconds a step charged to the program's
``optimizer`` range (``train/optimizer.py``): the gaps that end at an
operation launched inside it (``cbench.ranges``)."""
from cbench.ranges import idle_ms


def read(ctx):
    return idle_ms(ctx, "optimizer")
