"""Compaction-ladder planning from crossing-count statistics.

Counterpart of ``pumiumtally_tpu/utils/ladder.py`` (its own copy, the same
arithmetic). A compaction schedule ``((start, width), ...)`` narrows the
walk to its stragglers stage by stage; its cost is the executed slots
(Σ stage width × stage span) plus a fixed cost per round, both set by the
distribution of boundary crossings per move (the decay curve):

  * :func:`survivors`: the decay curve from measured per-particle crossing
    counts;
  * :func:`exp_survivors`: the analytic curve of exponentially distributed
    crossings at a given mean;
  * :func:`simulate_ladder`: the executional model, a histogram of
    remaining iterations advanced stage by stage as the JAX walk schedules
    lanes;
  * :func:`plan_stages`: a hill-climb over schedules under that model,
    seeded with a stage at every halving of the survivors.

The port's single-device walk refills its threads lane after lane and
ignores a schedule; ``PartitionedTally``'s step walks the schedule's
rounds (``ops/walk_partitioned.py``), bitwise equal to a step without one.
The round cost defaults to the JAX package's fit on its TPU (1.3 ·
n_particles slot-equivalents a round); it ranks schedules, it is not a
time of the port's.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "survivors",
    "exp_survivors",
    "simulate_ladder",
    "plan_stages",
]


def survivors(counts: np.ndarray, kmax: int | None = None) -> np.ndarray:
    """active[k] = lanes needing body iteration k, from measured
    per-particle crossing counts (a lane with c crossings executes c + 1
    iterations; the last reaches the destination)."""
    counts = np.asarray(counts)
    iters = counts + 1
    if kmax is None:
        kmax = int(iters.max()) + 1
    hist = np.bincount(np.minimum(iters, kmax), minlength=kmax + 1)
    return (iters.size - np.cumsum(hist)).astype(float)


def exp_survivors(n: int, mean_crossings: float,
                  kmax: int | None = None) -> np.ndarray:
    """Analytic decay curve: crossings a move ~ Exponential(mean)."""
    m = max(float(mean_crossings), 0.25)
    if kmax is None:
        kmax = int(np.ceil(m * 12)) + 2
    k = np.arange(kmax + 1, dtype=float)
    # iterations = crossings + 1, so survivors(k) = P(crossings >= k - 1).
    return n * np.exp(-np.maximum(k - 1, 0) / m)


def _chunk(span: int, unroll: int) -> int:
    return -(-max(span, 0) // unroll) * unroll


def _advance(hist: np.ndarray, width: float, span: int, unroll: int = 1):
    """Advance min(width, active) lanes of ``hist`` (remaining-iteration
    histogram; index 0 = done) by ``span`` iterations, taking lanes in
    proportion across buckets. Returns (new_hist, executed_span); the
    executed span stops at the selected lanes' largest remainder rounded
    up to an unroll chunk."""
    active = hist[1:].sum()
    if active <= 0:
        return hist, 0
    nz = np.nonzero(hist[1:])[0]
    max_rem = int(nz[-1]) + 1
    run = min(span, _chunk(max_rem, unroll))
    f = min(width / active, 1.0)
    sel = hist * f
    sel[0] = 0.0
    out = hist - sel
    # Selected lanes with remaining r move to max(r - run, 0).
    shifted = np.zeros_like(out)
    r = np.arange(len(hist))
    dst = np.maximum(r - run, 0)
    np.add.at(shifted, dst, sel)
    return out + shifted, run


def simulate_ladder(
    active_or_hist: np.ndarray,
    n: float,
    stages: tuple,
    *,
    unroll: int = 8,
    round_cost: float | None = None,
    max_crossings: int | None = None,
) -> tuple[float, int]:
    """Executed (slots, rounds) of ``stages`` under the executional model.

    ``active_or_hist`` is a survivors curve (monotone non-increasing) or a
    remaining-iteration histogram. Every phase runs in ``unroll``-sized
    chunks. With ``round_cost`` the first value is slots plus rounds times
    that cost."""
    a = np.asarray(active_or_hist, float)
    if len(a) >= 2 and np.all(np.diff(a) <= 1e-9):
        # survivors a[k] = #{iterations > k} → histogram hist[r] =
        # a[r-1] - a[r] for r >= 1, hist[0] = 0, plus a tail bucket a[-1].
        hist = np.concatenate([[0.0], -np.diff(a), [a[-1]]])
    else:
        hist = a.copy()
    kmax = len(hist) + 2
    slots, rounds = 0.0, 0

    stages = tuple(stages)
    first = stages[0][0] if stages else (max_crossings or kmax)
    # Phase 1: full width to the first stage's start.
    h, run = _advance(hist, n, _chunk(first, unroll), unroll)
    slots += n * run
    hist = h
    for i, st in enumerate(stages):
        start, width = int(st[0]), float(st[1])
        if hist[1:].sum() <= 0:
            break
        if i + 1 < len(stages):
            span = _chunk(int(stages[i + 1][0]) - start, unroll)
            hist, run = _advance(hist, width, span, unroll)
            slots += width * run
            rounds += 1
        else:
            # Final stage: rounds of ``width`` to completion, bounded as
            # the walk bounds them (ceil(n / width) + 1).
            guard = int(-(-n // max(width, 1))) + 2
            while hist[1:].sum() > 0 and guard > 0:
                hist, run = _advance(
                    hist, width, _chunk(kmax, unroll), unroll
                )
                slots += width * run
                rounds += 1
                guard -= 1
    if round_cost is not None:
        return slots + rounds * round_cost, rounds
    return slots, rounds


def plan_stages(
    n_particles: int,
    mean_crossings: float,
    *,
    counts: np.ndarray | None = None,
    unroll: int = 8,
    round_cost: float | None = None,
    width_floor: int | None = None,
    passes: int = 4,
) -> tuple:
    """Plan a compaction ladder for the given crossing statistics: the
    measured decay (``counts``, per-particle crossing counts) when given,
    else the exponential family at ``mean_crossings``. ``round_cost``
    defaults to 1.3 · n_particles slot-equivalents.

    Seeded with a stage wherever the survivor count halves (each width the
    live count rounded up), then hill-climbed under
    :func:`simulate_ladder`'s score (starts shifted, widths rescaled,
    stages dropped) until no move improves. Returns ((start, width), ...),
    empty when no ladder beats the flat loop (small batches)."""
    n = float(n_particles)
    if counts is not None:
        act = survivors(np.asarray(counts))
        act = act * (n / act[0])
    else:
        act = exp_survivors(n, mean_crossings)
    if round_cost is None:
        round_cost = 1.3 * n
    if width_floor is None:
        width_floor = max(int(n) // 128, 64)
    kmax = len(act) - 1
    gran = 4096 if n >= 65536 else 64

    def hug(a):
        w = -(-int(np.ceil(a)) // gran) * gran
        return int(min(max(w, width_floor), n))

    def score(stages):
        slots, rounds = simulate_ladder(
            act, n, stages, unroll=unroll, max_crossings=kmax + 2
        )
        return slots + rounds * round_cost

    # Seed: a stage wherever the survivor count halves, its width hugging
    # the live count from above.
    starts = []
    j = 1
    while n / 2**j >= width_floor and j < 32:
        k = int(np.searchsorted(-act, -(n / 2**j), side="left"))
        k = max(4, -(-k // 4) * 4)
        if k >= kmax:
            break
        if not starts or k > starts[-1]:
            starts.append(k)
        j += 1
    sched = tuple((k, hug(act[min(k, kmax)])) for k in starts)
    if not sched:
        return ()
    best = (score(sched), sched)

    def neighbors(stages):
        for i in range(len(stages)):
            k, w = stages[i]
            lo = stages[i - 1][0] if i else 0
            hi = stages[i + 1][0] if i + 1 < len(stages) else kmax
            for dk in (-8, -4, 4, 8):
                k2 = k + dk
                if lo < k2 < hi:
                    yield stages[:i] + ((k2, hug(act[min(k2, kmax)])),
                                        ) + stages[i + 1:]
            for f in (0.5, 0.75, 1.5):
                w2 = int(min(max(w * f, width_floor), n))
                if w2 != w:
                    yield stages[:i] + ((k, w2),) + stages[i + 1:]
            yield stages[:i] + stages[i + 1:]  # drop the stage

    for _ in range(passes):
        improved = False
        for cand in list(neighbors(best[1])):
            s = score(cand)
            if s < best[0] - 1e-6:
                best = (s, cand)
                improved = True
        if not improved:
            break
    if score(()) <= best[0]:
        return ()
    return best[1]
