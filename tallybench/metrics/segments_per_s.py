"""Every segment the window's whole batches scored (the program's own
stats, as the drive returns them), over the window's seconds: from the
first timed moment to the end of the batch in progress at the close."""


def read(ctx):
    return ctx.segments / ctx.window_s
