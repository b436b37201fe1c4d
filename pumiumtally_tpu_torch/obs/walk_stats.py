"""Schema of the walk stats vector.

Counterpart of ``pumiumtally_tpu/obs/walk_stats.py``: every walk returns
one [8] int64 vector of counters, and the facade reads segments and
truncations from it with one small device-to-host copy per move.
"""
from __future__ import annotations

import numpy as np

WALK_STATS_FIELDS = (
    # Real element-boundary crossings summed over all lanes (relocation-
    # chase hops excluded).
    "crossings",
    # Max real crossings by any single lane.
    "max_crossings",
    # Relocation-chase hops executed (0 on a clean mesh).
    "chase_hops",
    # In-flight walks not finished when the walk returned (truncated at
    # max_crossings).
    "truncated",
    # Straggler-compaction occupancy of the JAX walk; the port has no
    # compaction, so both are always 0.
    "occ_active",
    "occ_slots",
    # Scored particle-segments.
    "segments",
    # Loop iterations (the most any lane ran).
    "loop_iters",
)

WALK_STATS_LEN = len(WALK_STATS_FIELDS)


def stats_to_dict(vec) -> dict:
    """Host view of one stats vector: named integer fields plus the derived
    mean compaction ``occupancy`` (None when compaction never ran)."""
    v = np.asarray(vec)
    if v.shape != (WALK_STATS_LEN,):
        raise ValueError(
            f"expected a [{WALK_STATS_LEN}] stats vector, got {v.shape}"
        )
    d = {f: int(v[i]) for i, f in enumerate(WALK_STATS_FIELDS)}
    d["occupancy"] = (
        round(d["occ_active"] / d["occ_slots"], 4) if d["occ_slots"] else None
    )
    return d


def reduce_chip_stats(mat) -> dict:
    """One run-level dict from a per-part ``[n_parts, LEN]`` stats matrix:
    sums everywhere except ``max_crossings`` (the max over parts)."""
    m = np.asarray(mat)
    if m.ndim != 2 or m.shape[1] != WALK_STATS_LEN:
        raise ValueError(
            f"expected [n_parts, {WALK_STATS_LEN}] chip stats, got {m.shape}"
        )
    d = {f: int(m[:, i].sum()) for i, f in enumerate(WALK_STATS_FIELDS)}
    d["max_crossings"] = int(m[:, WALK_STATS_FIELDS.index("max_crossings")]
                             .max(initial=0))
    d["occupancy"] = (
        round(d["occ_active"] / d["occ_slots"], 4) if d["occ_slots"] else None
    )
    return d
