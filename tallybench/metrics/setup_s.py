"""Seconds from the process's start to the first timed moment: the
imports, the mesh, the tally, the warm-up batch and, in a checkout's first
run, the kernels' build."""


def read(ctx):
    return ctx.setup_s
