"""device: the share of the traced span in which no operation ran on the
card, in percent."""


def read(ctx):
    tl = ctx.timeline
    if tl is None or not tl.ops or tl.window_us <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_us() / tl.window_us)
