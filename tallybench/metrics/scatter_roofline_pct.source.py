"""The ordered scatter's share of its roofline, in %: the least time of
the traced walks' records (each read once) and scored bins (each pair read
and written once) over the device time of every kernel of
csrc/scatter.cu."""


def read(ctx):
    dev = ctx.csrc_seconds("scatter")
    if not dev:
        return None
    least = ctx.roofline.scatter_least_s(ctx.walks, ctx.nbins, ctx.item)
    return 100.0 * least / dev
