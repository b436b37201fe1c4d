"""The walk wrapper's host waits a walk, in ms: the read of the record
count (walk_cuda.LAST_WAIT_S) plus the read of the bucket information
(scatter.LAST_BUCKETS["wait_s"]), summed over the traced walks."""


def read(ctx):
    walks = sum(n for _, n in ctx.waits)
    if not walks:
        return None
    return 1e3 * sum(s for s, _ in ctx.waits) / walks
