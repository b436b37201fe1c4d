"""The sparse fold's share of the ordered scatter's bucket-path calls, in
%: the program's ``scatter.sparse`` spans over its ``scatter.sparse`` and
``scatter.fold`` spans (the sparse and the dense fold) under
run_source_moves in the traced window. A program without the sparse fold
(no ``ops.scatter.SPARSE_LAUNCHES``), or a window with no fold, gives
nothing."""
from tallybench.program_clock import source_totals


def read(ctx):
    from pumiumtally_tpu_torch.ops import scatter

    if not hasattr(scatter, "SPARSE_LAUNCHES"):
        return None
    got = source_totals()
    if got is None:
        return None
    call, _ = got
    sparse = call.get("scatter.sparse", {}).get("count", 0)
    dense = call.get("scatter.fold", {}).get("count", 0)
    return 100.0 * sparse / (sparse + dense) if sparse + dense else None
