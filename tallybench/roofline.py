"""The card's peaks and the least bytes of the walk and the ordered scatter.

A frozen copy of the repo's bound arithmetic (the walk's ``walk_bound`` and
``walk_metrics``): a walk reads each element row it visits once (at most the
table), and each lane's inputs and outputs once; the ordered scatter reads
each tally record once and reads and writes each scored bin's pair once (at
most the flux). A kernel's least time is the larger of its bytes over the
memory bandwidth and its operations over the rate of its float type; its
roofline share is that least time over the device time the profiler gave
its kernels. The peaks are NVIDIA's data sheet figures for the H100 SXM at
its 700 W limit; ``card_line`` reads the card's own limit to print beside
them.
"""
from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12                 # HBM3
FLOPS_PER_S = {4: 67e12, 8: 34e12}        # float32 / float64, no tensor cores
# Operations of one lane iteration of the walk: 4 faces x (denominator 5,
# numerator 6, division 1), the ray norm 6, tolerance 2, crossing point 6,
# score 4, escalated bump 14.
FLOPS_PER_ITER = 4 * 12 + 6 + 2 + 6 + 4 + 14
# A walked lane's bytes read (origin, dest, weight, flag, group, element)
# and written (position, element, material, done, track, four counts).
LANE_BYTES = {4: (12 + 12 + 4 + 1 + 4 + 4) + (12 + 4 + 4 + 1 + 4 + 16),
              8: (24 + 24 + 4 + 1 + 8 + 4) + (24 + 4 + 4 + 1 + 8 + 16)}
# One element row: the packed geo20 row (16 plane floats and 4 code
# words), or the unpacked layout's planes, 4 neighbours and a class index.
ROW_BYTES = {"geo20": {4: 20 * 4, 8: 20 * 8},
             "unpacked": {4: 16 * 4 + 5 * 4, 8: 16 * 8 + 5 * 4}}
# One tally record as the walk hands it to the scatter: bin (int32), order
# key (int64) and contribution.
RECORD_BYTES = {4: 4 + 8 + 4, 8: 4 + 8 + 8}


def walk_least_s(walks, ntet: int, item: int, layout: str) -> float:
    """Least seconds of the walks: ``walks`` is a sequence of dicts with
    ``lanes`` (lanes walked) and ``iters`` (lane iterations)."""
    total = 0.0
    for w in walks:
        rows = min(float(w["iters"]), float(ntet))
        nbytes = rows * ROW_BYTES[layout][item] + w["lanes"] * LANE_BYTES[item]
        ops = float(w["iters"]) * FLOPS_PER_ITER
        total += max(nbytes / HBM_BYTES_PER_S, ops / FLOPS_PER_S[item])
    return total


def scatter_least_s(walks, nbins: int, item: int) -> float:
    """Least seconds of the scatters of the walks' records (``segments``
    a walk): each record read once, each scored bin's pair read and
    written once."""
    total = 0.0
    for w in walks:
        seg = float(w["segments"])
        nbytes = seg * RECORD_BYTES[item] + min(seg, float(nbins)) * 2 * 2 * item
        total += nbytes / HBM_BYTES_PER_S
    return total


def card_line() -> str | None:
    """``name, power.limit`` of the card from ``nvidia-smi`` (None where
    it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None
