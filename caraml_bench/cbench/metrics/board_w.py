"""The card's mean board power over the untraced window: NVML's energy
counter's difference between its steps around the window, over their
time."""


def read(ctx):
    w = ctx.window
    return w.power_w if w.power_w > 0 else None
