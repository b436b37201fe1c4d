"""Predicted seconds and the calibration join of the port's autotuner.

Counterpart of the slice of ``pumiumtally_tpu/analysis/costmodel.py`` that
the JAX tuner calls (its own copy): ``NOMINAL_COEFFS``,
``predict_seconds`` and ``calibrate_points``.

The JAX tuner reads a candidate's ``(flops, bytes_accessed)`` from the
compiled XLA program. The port launches hand-written kernels and has no
compiled signature to read, so it counts them from a move's outputs
(``walk_metrics``), with the byte counts of K1's bound in chip_smoke.py
(table rows, flux bins, lanes) and ``FLOPS_PER_ITER`` operations a lane
iteration; the megastep adds the flight kernel's operations a lane
(``FLIGHT_OPS_PER_LANE``). ``dispatches`` is the kernel launches a move
makes (the wrappers' counts; none on the CPU). The block widths walk the
same lanes through the same rows, so their counts are equal: in the
rehearsal mode (ranked by the predicted seconds) they tie, and the tie
breaks to the canonical order, 128 (the kernel's default width) first.
The nominal coefficients only order candidates against each other; they
are not a measurement of any card.
"""
from __future__ import annotations

import math

import torch

# Floating-point operations a lane iteration of the walk does, counted
# from csrc/walk.cu (chip_smoke.py's bounds use them too): 4 faces x
# (denominator 5, numerator 6, division 1), the ray norm 6, tolerance 2,
# crossing point 6, score 4, escalated bump 14.
FLOPS_PER_ITER = 4 * 12 + 6 + 2 + 6 + 4 + 14
# Bytes a lane reads and writes once in one walk launch, by the float's
# bytes: origin, dest, weight, fly, group and element in; position,
# element, material, done, track length and four counts out.
LANE_IN = {4: 12 + 12 + 4 + 1 + 4 + 4, 8: 24 + 24 + 4 + 1 + 8 + 4}
LANE_OUT = {4: 12 + 4 + 4 + 1 + 4 + 16, 8: 24 + 4 + 4 + 1 + 8 + 16}
# Integer operations a lane of the flight kernel (csrc/source.cu) does:
# six threefry2x32 blocks (the lane key and five draws), each 2 + 2 key
# words + 20 rounds x 3 (add, funnel shift, xor) + 5 injections x 3 adds;
# the clip of pid.
THREEFRY_OPS = 2 + 2 + 20 * 3 + 5 * 3
FLIGHT_OPS_PER_LANE = 6 * THREEFRY_OPS + 2

NOMINAL_COEFFS = {
    "flops_per_s": 2.0e11,   # effective throughput
    "bytes_per_s": 5.0e10,   # effective memory rate
    "dispatch_s": 5.0e-5,    # per launch
}


def predict_seconds(metrics: dict, coeffs: dict, *,
                    dispatches: float = 0.0) -> float:
    """Roofline-style seconds of one program from its ``flops`` and
    ``bytes_accessed``: compute time + memory time + ``dispatches``
    launches. A coefficient ``calibrate_points`` could not fit (None)
    contributes no term."""
    t = dispatches * (coeffs.get("dispatch_s") or 0.0)
    f = coeffs.get("flops_per_s")
    if f:
        t += metrics["flops"] / f
    b = coeffs.get("bytes_per_s")
    if b:
        t += metrics["bytes_accessed"] / b
    return t


def walk_metrics(w: dict, iters: float, segments: float) -> dict:
    """``(flops, bytes_accessed)`` of one move of the workload ``w``
    (``tuning/search.py::build_workload``) from its lane iterations and
    scored segments: each iteration's operations; each table row read
    once (a geo20 row of 20 floats, at most the table), each scored bin's
    pair read and written once (at most the flux), each lane's inputs and
    outputs once."""
    item = torch.finfo(w["dtype"]).bits // 8
    ntet, n = w["mesh"].ntet, w["n_particles"]
    rows = min(float(iters), float(ntet))
    bins = min(float(segments), float(ntet * w["n_groups"]))
    return dict(
        flops=float(iters) * FLOPS_PER_ITER,
        bytes_accessed=(rows * 20 * item + bins * 2 * 2 * item
                        + n * (LANE_IN[item] + LANE_OUT[item])),
    )


def calibrate_points(points: list[dict]) -> dict | None:
    """Fit effective throughput and memory rate from measured
    ``(flops, bytes_accessed, seconds)`` points of one shape class:
    ``t ≈ flops·x + bytes·y`` by 2×2 least squares. A degenerate or
    unphysical fit (singular system, a coefficient <= 0, as when every
    candidate has the same counts) falls back to the single-term fit that
    explains the timings best, the other coefficient None. None with no
    points."""
    pts = [
        (float(p["flops"]), float(p["bytes_accessed"]),
         float(p["seconds"]))
        for p in points
        if p.get("seconds") and p["seconds"] > 0
    ]
    if not pts:
        return None

    def _one_term(idx):
        # t ≈ v·x, so x = Σ v·t / Σ v² (least squares through 0)
        num = sum(p[idx] * p[2] for p in pts)
        den = sum(p[idx] * p[idx] for p in pts)
        return (num / den) if den > 0 and num > 0 else None

    def _rmse(x, y):
        err = [
            (f * (x or 0.0) + b * (y or 0.0) - t) ** 2
            for f, b, t in pts
        ]
        return math.sqrt(sum(err) / len(err))

    x = y = None
    if len(pts) >= 2:
        sff = sum(f * f for f, _, _ in pts)
        sbb = sum(b * b for _, b, _ in pts)
        sfb = sum(f * b for f, b, _ in pts)
        sft = sum(f * t for f, _, t in pts)
        sbt = sum(b * t for _, b, t in pts)
        det = sff * sbb - sfb * sfb
        if det > 0 and abs(det) > 1e-12 * max(sff * sbb, 1.0):
            x = (sft * sbb - sbt * sfb) / det
            y = (sbt * sff - sft * sfb) / det
    if x is None or y is None or x <= 0 or y <= 0:
        xf, yb = _one_term(0), _one_term(1)
        cand = []
        if xf is not None:
            cand.append((xf, None))
        if yb is not None:
            cand.append((None, yb))
        if not cand:
            return None
        x, y = min(cand, key=lambda c: _rmse(*c))
    return {
        "flops_per_s": (1.0 / x) if x else None,
        "bytes_per_s": (1.0 / y) if y else None,
        "rmse_s": _rmse(x, y),
        "points": len(pts),
        "model": "seconds = flops/flops_per_s + bytes/bytes_per_s",
    }
