"""Statistical convergence: batch statistics on the card, their summary,
and the ConvergenceMonitor.

Counterpart of ``pumiumtally_tpu/obs/convergence.py``, with the same
estimator, summary fields, gauges and records:

  * **batch statistics**: the run is divided into batches (every
    ``TallyConfig.batch_moves`` moves, or an explicit
    ``tally.end_batch()``), and the per-bin batch totals T_b of the flux
    accumulator's even (Σc) entries are folded into S1 = Σ T_b and
    S2 = Σ T_b², so the relative error is the N-batch estimator

        R = sqrt((N·S2 − S1²)/(N − 1)) / S1        per scored bin.

    S1 is exactly the even entries at the last batch boundary, so the
    state is a snapshot and Σ T² (two bin-sized tensors on the card) and
    the batch and move counts (host integers: the cadence is the
    facade's own count of its moves, so reading it costs nothing).
  * **the summary**: ``fold_and_reduce`` (torch ops on the card) folds a
    completed batch and reduces the per-bin relative error to a
    [CONV_LEN] vector (batches, scored bins, Σ rel-err, max rel-err,
    converged bins) that rides the packed readback's tail
    (``ops/staging.py``): no extra transfer, one H2D and one D2H a
    packed move still.
  * **ConvergenceMonitor**: folds each summary into the gauges
    ``pumi_rel_err_max`` / ``pumi_rel_err_mean`` /
    ``pumi_converged_fraction`` / ``pumi_fom``, records one flight record
    per completed batch, and answers ``tally.converged()``.

The reductions read the accumulator and never write it: the flux is bit
for bit that of a run without convergence.

Counts travel as walk-dtype floats through the readback tail. Float32
holds every integer up to 2^24 exactly, so the summary's counts are exact
below 16,777,216 bins (the 55^3-cell box's 7,986,000 bins of 8 groups
are); above it a float32 count may lose ulps, which a monitor can bear,
and float64 is exact.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Field order of the convergence summary vector (the staging tail's too).
CONV_FIELDS = (
    # Completed batches N.
    "n_batches",
    # Bins with a nonzero accumulated score (the rel-err population).
    "scored",
    # Σ over scored bins of the per-bin relative error (bins with N < 2
    # batches report 1, unconverged).
    "sum_rel_err",
    # max over scored bins of the per-bin relative error.
    "max_rel_err",
    # Scored bins with rel-err <= TallyConfig.rel_err_target.
    "converged",
)

CONV_LEN = len(CONV_FIELDS)

CONV_IDX = {name: i for i, name in enumerate(CONV_FIELDS)}


@dataclasses.dataclass
class ConvState:
    """The batch accumulators of one tally: the even-entry snapshot S1
    and Σ T² on the flux's device, the completed batches and the moves
    since the last batch end, and the last summary (unchanged until the
    next batch ends)."""

    snap: torch.Tensor
    sumsq: torch.Tensor
    n_batches: int = 0
    moves: int = 0
    summary: torch.Tensor | None = None

    @classmethod
    def zeros(cls, nbins: int, dtype, device) -> "ConvState":
        z = dict(dtype=dtype, device=device)
        return cls(torch.zeros(nbins, **z), torch.zeros(nbins, **z))


def conv_reduce(snap, sumsq, nb: int, rel_err_target: float):
    """Per-bin relative error reduced to the [CONV_LEN] summary vector in
    ``snap.dtype``, on ``snap``'s device, over the last axis (``[P, L]``
    accumulators give one vector a part, ``[P, CONV_LEN]``). Bins with
    fewer than 2 batches have no variance estimate: scored bins there
    report rel-err 1, unscored bins 0 and are excluded everywhere."""
    dtype = snap.dtype
    lead = tuple(snap.shape[:-1])
    nbf = float(max(nb, 1))
    scored = snap > 0
    var_num = (nbf * sumsq - snap * snap).clamp_min_(0.0)
    rel = (var_num / max(nbf - 1.0, 1.0)).sqrt_() / torch.where(
        scored, snap, torch.ones((), dtype=dtype, device=snap.device))
    defined = nb >= 2
    rel = torch.where(scored, rel if defined else torch.ones_like(rel),
                      torch.zeros_like(rel))
    n_scored = scored.sum(-1)
    n_conv = (scored & (rel <= rel_err_target)).sum(-1) if defined else (
        torch.zeros(lead, dtype=torch.int64, device=snap.device))
    return torch.stack([
        torch.full(lead, nb, dtype=dtype, device=snap.device),
        n_scored.to(dtype),
        rel.sum(-1),
        rel.amax(-1),
        n_conv.to(dtype),
    ], dim=-1)


def fold_and_reduce(flux, state: ConvState, *, batch_moves: int,
                    rel_err_target: float, force: bool = False,
                    enable: bool = True):
    """One move's (or one explicit ``end_batch``'s) convergence step, in
    place on ``state``.

    ``flux`` is the stride-2 accumulator with the (Σc, Σc²) pairs on its
    last axis (flat, or ``[P, 2L]`` per-part slabs with ``[P, L]``
    accumulators); only its even (Σc) entries are read, so convergence
    composes with ``score_squares=False`` and ``sd_mode="batch"`` alike.
    A batch completes when the moves since the last batch end reach a
    multiple of ``batch_moves``, or always with ``force`` (``end_batch``,
    which restarts the cadence). ``enable`` False (the partitioned
    facade's initial search and re-walks) leaves the cadence and the
    accumulators alone. A completed batch adds (even − S1)² to Σ T², sets
    S1 to the even entries and recomputes the summary; otherwise the last
    summary stands. Returns the summary vector (``[..., CONV_LEN]``, the
    flux's dtype and device)."""
    if force:
        state.moves, end = 0, True
    elif enable:
        state.moves += 1
        end = state.moves % batch_moves == 0
    else:
        end = False
    if end:
        even = flux[..., 0::2]
        delta = even - state.snap
        state.sumsq += delta * delta
        state.snap.copy_(even)
        state.n_batches += 1
    if end or state.summary is None:
        state.summary = conv_reduce(state.snap, state.sumsq,
                                    state.n_batches, rel_err_target)
    return state.summary


def conv_to_dict(vec) -> dict:
    """Named host view of one summary vector."""
    v = np.asarray(vec, np.float64)
    if v.shape != (CONV_LEN,):
        raise ValueError(
            f"expected a [{CONV_LEN}] convergence vector, got {v.shape}"
        )
    return {
        "n_batches": int(v[CONV_IDX["n_batches"]]),
        "scored": int(v[CONV_IDX["scored"]]),
        "sum_rel_err": float(v[CONV_IDX["sum_rel_err"]]),
        "max_rel_err": float(v[CONV_IDX["max_rel_err"]]),
        "converged": int(v[CONV_IDX["converged"]]),
    }


def reduce_chip_conv(mat) -> dict:
    """Per-part ``[n_parts, CONV_LEN]`` summaries as one run-level dict:
    counts and sums add (each bin is owned by exactly one part),
    ``max_rel_err`` is the max, ``n_batches`` the same in every part."""
    m = np.asarray(mat, np.float64)
    if m.ndim != 2 or m.shape[1] != CONV_LEN:
        raise ValueError(
            f"expected [n_parts, {CONV_LEN}] part summaries, got {m.shape}"
        )
    return {
        "n_batches": int(m[:, CONV_IDX["n_batches"]].max(initial=0)),
        "scored": int(m[:, CONV_IDX["scored"]].sum()),
        "sum_rel_err": float(m[:, CONV_IDX["sum_rel_err"]].sum()),
        "max_rel_err": float(m[:, CONV_IDX["max_rel_err"]].max(initial=0)),
        "converged": int(m[:, CONV_IDX["converged"]].sum()),
    }


def host_relative_error(snap, sumsq, nb: int) -> np.ndarray:
    """Per-bin relative error in host float64: the estimator of
    ``conv_reduce``, for ``tally.relative_error()`` and the VTK
    uncertainty fields. Unscored bins report 0; scored bins with fewer
    than 2 batches report 1."""
    s1 = np.asarray(snap, np.float64)
    s2 = np.asarray(sumsq, np.float64)
    n = int(nb)
    scored = s1 > 0
    if n < 2:
        return np.where(scored, 1.0, 0.0)
    var_num = np.maximum(n * s2 - s1 * s1, 0.0)
    rel = np.sqrt(var_num / (n - 1)) / np.where(scored, s1, 1.0)
    return np.where(scored, rel, 0.0)


class ConvergenceMonitor:
    """Folds per-move convergence summaries into gauges, per-batch flight
    records, and the ``converged()`` early-stop answer. One per tally:
    the gauges land in the tally's private registry."""

    def __init__(
        self,
        telemetry,
        *,
        rel_err_target: float,
        converged_fraction: float,
        batch_moves: int,
    ):
        self.telemetry = telemetry
        self.rel_err_target = float(rel_err_target)
        self.converged_fraction = float(converged_fraction)
        self.batch_moves = int(batch_moves)
        r = telemetry.registry
        self._g_max = r.gauge(
            "pumi_rel_err_max",
            "max per-bin relative error over scored tally bins",
        )
        self._g_mean = r.gauge(
            "pumi_rel_err_mean",
            "mean per-bin relative error over scored tally bins",
        )
        self._g_frac = r.gauge(
            "pumi_converged_fraction",
            "fraction of scored tally bins with relative error at or "
            "below TallyConfig.rel_err_target",
        )
        self._g_fom = r.gauge(
            "pumi_fom",
            "figure of merit 1/(rel_err_mean^2 * tally_seconds) — "
            "constant once a run is variance-dominated",
        )
        self._c_batches = r.counter(
            "pumi_batches_total",
            "statistical batches completed (batch_moves cadence plus "
            "explicit end_batch calls)",
        )
        self._last: dict = {}
        self._batches_seen = 0

    def update(self, fields: dict, seconds: float) -> dict:
        """Fold one summary (``conv_to_dict`` output). ``seconds`` is the
        cumulative tally wall clock driving the figure of merit. Records
        one flight record per completed batch."""
        nb = int(fields["n_batches"])
        scored = int(fields["scored"])
        mean = fields["sum_rel_err"] / scored if scored else 0.0
        frac = fields["converged"] / scored if scored else 0.0
        fom = (
            1.0 / (mean * mean * seconds)
            if mean > 0 and seconds > 0
            else 0.0
        )
        self._g_max.set(float(fields["max_rel_err"]))
        self._g_mean.set(mean)
        self._g_frac.set(frac)
        self._g_fom.set(fom)
        self._last = {
            "n_batches": nb,
            "scored": scored,
            "rel_err_mean": mean,
            "rel_err_max": float(fields["max_rel_err"]),
            "converged_fraction": frac,
            "fom": fom,
            "seconds": float(seconds),
        }
        if nb > self._batches_seen:
            self._c_batches.inc(nb - self._batches_seen)
            self._batches_seen = nb
            self.telemetry.recorder.record(
                "convergence",
                batch=nb,
                scored=scored,
                rel_err_mean=round(mean, 9),
                rel_err_max=round(float(fields["max_rel_err"]), 9),
                converged_fraction=round(frac, 6),
                fom=round(fom, 3),
            )
        return self._last

    @property
    def converged(self) -> bool:
        """True once at least 2 batches exist, something scored, and the
        converged fraction has reached ``converged_fraction``."""
        d = self._last
        return bool(
            d
            and d["n_batches"] >= 2
            and d["scored"] > 0
            and d["converged_fraction"] >= self.converged_fraction
        )

    def reset(self) -> None:
        """Forget the statistical history (the facade's
        ``_reset_convergence`` re-bases the batch accumulators)."""
        self._last = {}
        self._batches_seen = 0
        for g in (self._g_max, self._g_mean, self._g_frac, self._g_fom):
            g.set(0.0)

    def snapshot(self) -> dict:
        """The ``telemetry()["convergence"]`` payload."""
        out = {
            "enabled": True,
            "rel_err_target": self.rel_err_target,
            "converged_fraction_target": self.converged_fraction,
            "batch_moves": self.batch_moves,
            "converged": self.converged,
        }
        out.update(
            self._last
            or {
                "n_batches": 0,
                "scored": 0,
                "rel_err_mean": 0.0,
                "rel_err_max": 0.0,
                "converged_fraction": 0.0,
                "fom": 0.0,
                "seconds": 0.0,
            }
        )
        return out
