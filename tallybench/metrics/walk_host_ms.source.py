"""The walk wrapper's host time a fused move less its two waits, in ms:
the program's walk span (the lane schedule, the buffers and kernel
entries, the scatter's host side, the result's reductions) less its
count_wait and bucket_wait, summed over the traced window and divided by
its fused moves."""
from tallybench.program_clock import source_totals

WAITS = ("count_wait", "bucket_wait")


def read(ctx):
    got = source_totals()
    if got is None:
        return None
    call, moves = got
    waits = sum(call.get(name, {}).get("host_ns", 0) for name in WAITS)
    return (call["walk"]["host_ns"] - waits) * 1e-6 / moves
