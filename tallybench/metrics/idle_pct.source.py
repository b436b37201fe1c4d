"""The share of the traced window in which no kernel, copy or memset ran
on the card, in %, from the profiler's device events."""


def read(ctx):
    red = ctx.reduced
    if red.window_s <= 0:
        return None
    return 100.0 * (1.0 - red.busy_s / red.window_s)
