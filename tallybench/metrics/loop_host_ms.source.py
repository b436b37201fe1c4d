"""The source loop's own host time a fused move, in ms: the self time of
the program's spans run_source_moves, stage lanes, chunk and bookkeeping
(staging, the chunk's dispatch, the tail split, the state update, the
stats and the flight record), summed over the traced window and divided by
its fused moves: the host time that host_step_ms.source leaves out."""
from tallybench.program_clock import source_totals

LOOP = ("run_source_moves", "stage lanes", "chunk", "bookkeeping")


def read(ctx):
    got = source_totals()
    if got is None:
        return None
    call, moves = got
    own = sum(call.get(name, {}).get("self_ns", 0) for name in LOOP)
    return own * 1e-6 / moves
