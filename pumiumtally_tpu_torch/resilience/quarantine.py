"""Bad-particle quarantine: mask poisonous inputs out of the walk.

Counterpart of ``pumiumtally_tpu/resilience/quarantine.py``, with the
same reasons, thresholds and counters. The flux accumulator is additive:
one NaN source particle scattered into it poisons every later read of its
bins. With ``TallyConfig(quarantine=True)`` the facade scans each call's
host inputs before anything reaches the device:

  * non-finite destination coordinates (``nonfinite_dest``),
  * non-finite statistical weights (``nonfinite_weight``),
  * destinations far outside the mesh, beyond the bounding box inflated
    by one diagonal (``out_of_mesh``; out-of-domain destinations that
    merely clip at the boundary pass).

Quarantined lanes are parked exactly like ``flying=0`` lanes, before the
move's record is packed: not walked, not scored, position held, and the
caller's out-params get the held position back. Counts flow per lane
(``tally.quarantined_lanes()``) and per reason into the registry
(``pumi_quarantined_lanes_total``) and ``telemetry()["quarantined"]``.

Host code over arrays the facade already touches; the device pays
nothing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.staging import host_tensor

REASONS = ("nonfinite_dest", "nonfinite_weight", "out_of_mesh")


@dataclasses.dataclass
class QuarantineReport:
    """One call's quarantine verdicts.

    mask: [n] bool — True where the lane must be parked this move.
    reasons: reason name → lane count (a lane bad for several reasons
      counts once per reason; ``count`` deduplicates).
    """

    mask: np.ndarray
    reasons: dict

    @property
    def count(self) -> int:
        return int(self.mask.sum())


def inflated_bounds(coords) -> tuple[np.ndarray, np.ndarray]:
    """Mesh bounding box inflated by one diagonal on every side — the
    out-of-mesh threshold. Anything a caller legitimately sends (even
    destinations that overshoot the domain and clip at the boundary)
    lands well inside; only garbage coordinates land outside."""
    c = np.asarray(coords, np.float64)
    lo, hi = c.min(axis=0), c.max(axis=0)
    diag = float(np.linalg.norm(hi - lo)) or 1.0
    return lo - diag, hi + diag


def scan(
    dest3: np.ndarray,
    weights: np.ndarray | None,
    bounds: tuple[np.ndarray, np.ndarray],
) -> QuarantineReport | None:
    """Scan one call's inputs; returns None when everything is clean.
    ``weights`` is None on the initial location search (nothing is
    scored there, so only the coordinates can poison anything).

    A clean call, the common case, costs a finite check of the weights
    and the min and max of each coordinate column (``torch.aminmax`` on
    the host's threads): the coordinates are all finite and inside the
    bounds exactly when every column's min and max are (a NaN propagates
    into both and an infinity lies outside, so either fails the test).
    Only otherwise are the per-lane verdicts computed, by numpy row
    reductions that cost some ten times more."""
    lo, hi = bounds
    if dest3.shape[0] == 0:
        return None
    if weights is None or np.isfinite(weights).all():
        cols = host_tensor(dest3)
        if all(lo[k] <= mn and mx <= hi[k]
               for k, (mn, mx) in enumerate(
                   torch.aminmax(cols[:, j]) for j in range(3))):
            return None
    finite_dest = np.isfinite(dest3).all(axis=1)
    bad_dest = ~finite_dest
    bad_w = (
        ~np.isfinite(np.asarray(weights))
        if weights is not None
        else np.zeros(dest3.shape[0], bool)
    )
    oob = finite_dest & (
        (dest3 < lo) | (dest3 > hi)
    ).any(axis=1)
    mask = bad_dest | bad_w | oob
    if not mask.any():
        return None
    return QuarantineReport(
        mask=mask,
        reasons={
            "nonfinite_dest": int(bad_dest.sum()),
            "nonfinite_weight": int(bad_w.sum()),
            "out_of_mesh": int(oob.sum()),
        },
    )


def sanitize(
    report: QuarantineReport,
    dest3: np.ndarray,
    weights: np.ndarray | None,
) -> None:
    """Overwrite quarantined rows with inert finite values in place, so
    nothing non-finite reaches a device array. Both arrays must be the
    facade's staging copies, never the caller's buffers: a retried move
    must see the original inputs again."""
    dest3[report.mask] = 0.0
    if weights is not None:
        weights[report.mask] = 0.0


def setup(tally, coords, num_particles: int) -> None:
    """Constructor hook (``TallyConfig.quarantine``): the out-of-mesh
    threshold and the per-lane count array live on the tally."""
    tally._qbounds = inflated_bounds(coords)
    tally._quarantined = np.zeros(int(num_particles), np.int64)


def lanes(tally) -> np.ndarray:
    """``quarantined_lanes()``: cumulative per-lane counts, host particle
    order."""
    if tally._quarantined is None:
        raise ValueError(
            "set TallyConfig(quarantine=True) to track quarantined "
            "lanes (off by default: parity runs fail loudly)"
        )
    return tally._quarantined.copy()


def apply(tally, dest3, weights, move):
    """The facade's entry point: scan one call's inputs against
    ``tally._qbounds``; on a hit, sanitize staging copies of ``dest3``
    and ``weights`` (the caller's buffers keep their values until the
    facade's own copy-back) and fold per-lane counts into
    ``tally._quarantined`` and the telemetry counters. A clean call
    copies nothing.

    ``weights`` is None on the initial location search. Returns
    ``(dest3_for_staging, weights_for_staging, mask_or_None)``.
    """
    rep = scan(dest3, weights, tally._qbounds)
    if rep is None:
        return dest3, weights, None
    dest3 = dest3.copy()
    if weights is not None:
        weights = weights.copy()
    sanitize(rep, dest3, weights)
    tally._quarantined += rep.mask
    tally._telemetry.record_quarantine(move, rep.count, rep.reasons)
    return dest3, weights, rep.mask
