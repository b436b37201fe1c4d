"""A candidate's counts for the port's autotuner.

The roofline the JAX tuner calls from ``pumiumtally_tpu/analysis/
costmodel.py`` (``NOMINAL_COEFFS``, ``predict_seconds``,
``calibrate_points``) lives in the port's own
``analysis/costmodel.py``; this module imports it for the tuner.

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

import torch

from ..analysis.costmodel import (  # noqa: F401  (the tuner's names)
    NOMINAL_COEFFS,
    calibrate_points,
    predict_seconds,
)

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
