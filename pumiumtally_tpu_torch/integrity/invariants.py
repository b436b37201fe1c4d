"""Schema and host-side evaluation of the walk's integrity invariants.

Own copy of ``pumiumtally_tpu/integrity/invariants.py`` (single-device
part): the layout here is the one source of the vector that the walk
computes on the device (``ops/walk.py::integrity_vector``, with
``TallyConfig(integrity != "off")``) and that the packed readback carries
(``ops/staging.py``).

Vector (walk dtype, ``INTEGRITY_FIELDS``):

  * ``scored_wlen`` / ``path_wlen`` — Σ weight·(scored track length) and
    Σ weight·|final − origin| over lanes that were in flight AND
    finished. All movement is along the origin→dest ray, so the two sums
    agree to rounding and the robust bump's unscored ulp-scale hops; a
    mis-scored, missed or double-scored segment splits them. Zero on the
    initial search (nothing is scored there).
  * ``max_residual`` — max over completed lanes of
    |track_length − |final − origin||, the per-lane form of the sum check
    (a +x/−x cancellation across lanes cannot hide).
  * ``bad_flux`` — count of non-finite or negative flux entries after the
    walk's scores (the reference's non-negative tally assert as a
    per-move count). A flipped sign or exponent bit in the accumulator
    shows here on the next move.
  * ``lanes_flying`` / ``lanes_done`` — lane-count conservation: the
    device's count of lanes that walked and that finished, checked against
    the host's flying count and the truncation count, so done + truncated
    + parked (or quarantined) == n.

The vector rides the packed readback's tail, so the checks add no
host↔device transfer.

Partitioned per-part vector (int64, ``PART_INTEGRITY_FIELDS``):
``bad_flux`` / ``lanes_valid`` / ``lanes_done``, the on-device half (flux
health and slot accounting) of each part after the halo fold; the
conservation half is checked on the host from the track lengths that
migrate with each particle, against the facade's pre-move positions.
"""
from __future__ import annotations

import numpy as np

INTEGRITY_FIELDS = (
    "scored_wlen",
    "path_wlen",
    "max_residual",
    "bad_flux",
    "lanes_flying",
    "lanes_done",
)
INTEGRITY_LEN = len(INTEGRITY_FIELDS)
IIDX = {name: i for i, name in enumerate(INTEGRITY_FIELDS)}

PART_INTEGRITY_FIELDS = ("bad_flux", "lanes_valid", "lanes_done")
PART_INTEGRITY_LEN = len(PART_INTEGRITY_FIELDS)


def integrity_to_dict(vec) -> dict:
    """Host view of one integrity vector: float conservation scalars and
    integer counts (the counts travel as walk-dtype floats, exact up to
    2^24 lanes in float32)."""
    v = np.asarray(vec, np.float64)
    if v.shape != (INTEGRITY_LEN,):
        raise ValueError(
            f"expected a [{INTEGRITY_LEN}] integrity vector, got {v.shape}"
        )
    d = {f: float(v[i]) for i, f in enumerate(INTEGRITY_FIELDS)}
    for f in ("bad_flux", "lanes_flying", "lanes_done"):
        d[f] = int(d[f])
    return d


def _eps(dtype) -> float:
    """Machine epsilon of a walk dtype given as numpy or torch dtype."""
    if not isinstance(dtype, np.dtype) and hasattr(dtype, "is_floating_point"):
        dtype = str(dtype).replace("torch.", "")
    return float(np.finfo(np.dtype(dtype)).eps)


def mesh_scale(coords) -> float:
    """1 + bounding-box diagonal — the coordinate scale every default
    tolerance here is proportional to. ``coords`` is a host array (or a
    CPU tensor)."""
    c = np.asarray(coords, np.float64)
    return 1.0 + float(np.linalg.norm(c.max(axis=0) - c.min(axis=0)))


def conservation_tolerance(
    configured: float | None, dtype, scale: float, walk_tolerance: float
) -> float:
    """Per-lane residual threshold for the conservation invariant.

    The honest error envelope is crossings·(walk tolerance + ulp bumps)
    (see the debug_checks bound in ops/walk.py); a bit-flip or dropped
    segment is orders of magnitude above it. The default is deliberately
    generous — a false positive halts production runs, a small true SDC
    merely needs to beat the envelope to be seen:
    ``max(64·walk_tolerance, 1e4·eps(dtype)) · scale``.
    """
    if configured is not None:
        return float(configured)
    eps = _eps(dtype)
    return max(64.0 * walk_tolerance, 1e4 * eps) * scale


def audit_tolerance(
    configured: float | None, dtype, scale: float, walk_tolerance: float
) -> float:
    """Shadow-audit comparison threshold (production walk-dtype result
    vs the float64 host reference): covers the walk dtype's rounding,
    the tolerance-band clip choices and the robust bump's unscored hops.
    """
    if configured is not None:
        return float(configured)
    eps = _eps(dtype)
    return max(128.0 * walk_tolerance, 2e4 * eps) * scale


def check_move(
    fields: dict,
    n_flying: int,
    n_truncated: int,
    tol: float,
) -> list[str]:
    """Evaluate one move's invariant vector → violated check names. ``n_flying`` is the host-side in-flight count staged for this
    move (after quarantine masking); ``n_truncated`` the move's final
    truncation count (post-escalation)."""
    violations = []
    if fields["max_residual"] > tol:
        violations.append("conservation")
    if fields["bad_flux"] > 0:
        violations.append("flux")
    # Device/host lane agreement AND done + truncated == flying (parked
    # and quarantined lanes are the n − flying remainder by definition).
    if (
        fields["lanes_flying"] != int(n_flying)
        or fields["lanes_done"] + int(n_truncated) != int(n_flying)
    ):
        violations.append("lanes")
    return violations


def check_megastep(
    fields: dict,
    n_truncated: int,
    tol: float,
    *,
    dtype=np.float64,
    n_moves: int = 1,
) -> list[str]:
    """Evaluate one MEGASTEP's reduced invariant vector → violated
    check names (``ops/walk.py::merge_megastep_integrity`` semantics: the
    conservation sums and lane counts are summed over the fused moves,
    the residual is the max, ``bad_flux`` reflects the final
    accumulator). The lane check is the device's own self-consistency
    — Σ per-move completions + Σ per-move truncations must equal
    Σ per-move in-flight counts — since the host never sees the
    intra-megastep flying counts."""
    violations = []
    if fields["max_residual"] > tol:
        violations.append("conservation")
    if fields["bad_flux"] > 0:
        violations.append("flux")
    # The lane counts are integer counts accumulated in the WALK dtype
    # over the fused moves: exact while the running totals stay below
    # 1/eps (2^24 in f32), after which each of the ~2·n_moves additions
    # can round by up to ulp(total). Allow exactly that rounding slack —
    # zero in the exact range, so a genuine lane miscount still trips.
    total = float(fields["lanes_flying"])
    eps = _eps(dtype)
    slack = 2.0 * max(int(n_moves), 1) * eps * max(abs(total), 1.0)
    if slack < 1.0:
        slack = 0.0
    if abs(
        fields["lanes_done"] + float(n_truncated) - total
    ) > slack:
        violations.append("lanes")
    return violations
