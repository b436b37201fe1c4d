"""The source loop's host time a fused move, in ms: the host clock of every
step PumiTally.step_clock records inside run_source_moves (the flight
draw, the walk, the physics, the folds, the tail read), summed, over the
traced moves."""


def read(ctx):
    if not ctx.step_ms:
        return None
    return sum(ctx.step_ms) / len(ctx.step_ms)
