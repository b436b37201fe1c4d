"""The walk kernels' share of their roofline, in %: the least time of the
traced walks' bytes (each element row once, each lane's inputs and outputs
once) over the device time of every kernel of csrc/walk.cu."""


def read(ctx):
    dev = ctx.csrc_seconds("walk")
    if not dev:
        return None
    least = ctx.roofline.walk_least_s(ctx.walks, ctx.ntet, ctx.item,
                                      ctx.layout)
    return 100.0 * least / dev
