"""Blocking device→host reads a fused move inside run_source_moves: every
read the program counts where it reads (utils/timing.py::count: the walk's
record count, the bucket information, the crowded scatter's large bins,
the invariant checks' bits, the tail's event wait), over the traced
window's fused moves."""
from tallybench.program_clock import source_totals


def read(ctx):
    got = source_totals()
    if got is None:
        return None
    call, moves = got
    return sum(t["count"] for name, t in call.items()
               if name.startswith("read:")) / moves
