"""The whole step's share of the card's bf16 peak: the needed products'
operations (``cbench.work``) a step, times the untraced window's steps a
second, over the published peak, in percent."""


def read(ctx):
    w = ctx.window
    if not ctx.ops or w.steps == 0 or not ctx.peaks:
        return None
    return (100.0 * ctx.flops_per_step * w.steps / w.seconds
            / ctx.peaks["bf16_flops"])
