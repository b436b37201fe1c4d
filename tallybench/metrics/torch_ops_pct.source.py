"""The share of the card's op time in the traced window spent in kernels
that are not the program's own (csrc/*.cu): torch's elementwise and
reduction kernels of the physics and the folds, in %."""


def read(ctx):
    total = ctx.device_seconds()
    if not total:
        return None
    ours = set().union(*ctx.csrc.values())
    other = sum(s for name, s in ctx.kernel_seconds().items()
                if ctx.kernel_id(name) not in ours)
    return 100.0 * other / total
