"""Shadow-audit sampling: an independent float64 re-walk of a few lanes.

Own copy of ``pumiumtally_tpu/integrity/audit.py``. The invariants
(invariants.py) catch corruption the walk can see about itself, but a
kernel regression that mis-scores consistently (a wrong face choice after
a compiler upgrade, a broken table layout) keeps its own books
consistent. The shadow audit is the independent witness: every audited
move a K-lane random sample is walked again by ``HostReference``, a
separate plain NumPy float64 walk over the same plane tables, and the
production result's final position and scored track length are compared
within a dtype-aware tolerance (invariants.audit_tolerance). A mismatch
is an ``sdc_audit`` violation, escalated by the facade like any invariant
breach.

Cost: host Python over K lanes × crossings per audited move (K is small,
``TallyConfig(audit_lanes=K)``, off by default), plus one gather of the
sampled lanes' inputs and outputs on the device and one small
device→host copy. A run with auditing off pays nothing.

The reference walker skips the production walk's robust-mode recovery
(chase, escalated bump): in float64 on meshes the mesh build accepted, the
plain walk with the entry-face mask terminates; a lane the reference
walker cannot finish within the crossing budget is counted ``skipped``
(inconclusive), never a mismatch.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AuditOutcome:
    """One move's shadow-audit result (flight-recorder payload)."""

    audited: int
    mismatches: int
    skipped: int
    max_dev: float


def _host(t, dtype) -> np.ndarray:
    """A host numpy copy of a tensor (on any device) or array."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype)


class HostReference:
    """Float64 host copies of the walk tables + the reference walker."""

    def __init__(self, mesh):
        self.normals = _host(mesh.face_normals, np.float64)
        self.face_d = _host(mesh.face_d, np.float64)
        self.tet2tet = _host(mesh.tet2tet, np.int64)
        self.class_id = _host(mesh.class_id, np.int32)
        self.ntet = int(self.tet2tet.shape[0])

    def walk_lane(
        self,
        origin: np.ndarray,
        dest: np.ndarray,
        elem: int,
        tolerance: float,
        max_crossings: int,
    ) -> tuple[np.ndarray, int, float, bool]:
        """Walk one lane origin→dest from parent ``elem``; returns
        ``(final_pos, final_elem, scored_track, finished)``.

        Mirrors the walk's per-crossing semantics (ops/walk.py):
        score every active segment, stop on destination-reached /
        domain exit / material boundary, exclude the entry face from
        exit candidates (with the stranded fallback of
        ops/geometry.py::exit_face).
        """
        cur = np.asarray(origin, np.float64).copy()
        dest = np.asarray(dest, np.float64)
        elem = int(elem)
        tol_floor = 8.0 * np.finfo(np.float64).eps
        track = 0.0
        prev = -1
        for _ in range(int(max_crossings)):
            dirv = dest - cur
            dnorm = float(np.linalg.norm(dirv))
            n = self.normals[elem]
            denom = n @ dirv
            num = self.face_d[elem] - n @ cur
            qual = denom > 0
            t_all = np.where(
                qual, num / np.where(qual, denom, 1.0), np.inf
            )
            t_all = np.maximum(t_all, 0.0)
            nbrs = self.tet2tet[elem]
            t = t_all.copy()
            if prev >= 0:
                t[nbrs == prev] = np.inf
            face = int(np.argmin(t))
            t_exit = float(t[face])
            if not np.isfinite(t_exit) and np.isfinite(t_all.min()):
                face = int(np.argmin(t_all))  # stranded fallback
                t_exit = float(t_all[face])
            has_exit = np.isfinite(t_exit)
            tol_eff = max(
                tolerance / (dnorm if dnorm > 0 else 1.0), tol_floor
            )
            reached = (t_exit >= 1.0 - tol_eff) or not has_exit
            t_step = min(t_exit, 1.0)
            track += t_step * dnorm
            cur = cur + t_step * dirv
            crossed = has_exit and not reached
            nbr = int(nbrs[face]) if crossed else -1
            if reached:
                return cur, elem, track, True
            if nbr == -1:  # domain exit: clipped at the wall
                return cur, elem, track, True
            material_stop = self.class_id[nbr] != self.class_id[elem]
            prev, elem = elem, nbr  # hop even on a material stop (cpp:445)
            if material_stop:
                return cur, elem, track, True
        return cur, elem, track, False


def audit_sample(
    ref: HostReference,
    origins: np.ndarray,
    dests: np.ndarray,
    elems: np.ndarray,
    prod_pos: np.ndarray,
    prod_track: np.ndarray,
    *,
    tolerance: float,
    max_crossings: int,
    tol: float,
) -> AuditOutcome:
    """Re-walk each sampled lane in float64 and compare against the
    production result. ``prod_pos``/``prod_track`` are the kernel's
    final positions and scored track lengths for the same lanes; a
    deviation above ``tol`` in either is a mismatch."""
    mismatches = skipped = 0
    max_dev = 0.0
    k = int(np.asarray(elems).shape[0])
    for i in range(k):
        pos, _el, track, finished = ref.walk_lane(
            origins[i], dests[i], int(elems[i]), tolerance, max_crossings
        )
        if not finished:
            skipped += 1
            continue
        dev = max(
            float(np.linalg.norm(pos - np.asarray(prod_pos[i], np.float64))),
            abs(track - float(prod_track[i])),
        )
        max_dev = max(max_dev, dev)
        if dev > tol:
            mismatches += 1
    return AuditOutcome(
        audited=k - skipped,
        mismatches=mismatches,
        skipped=skipped,
        max_dev=max_dev,
    )
