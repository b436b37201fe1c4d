"""Runtime configuration of a port ``PumiTally`` run.

Counterpart of ``pumiumtally_tpu/utils/config.py::TallyConfig`` with the
same field names and defaults, so a configuration reads the same in both
packages. What the port does with each field:

* read by the main path: ``n_groups``, ``tolerance``, ``max_crossings``,
  ``dtype`` (``torch.float32`` or ``torch.float64``), ``output_filename``,
  ``score_squares``, ``robust``, ``ledger``, ``walk_stats``,
  ``measure_time``, ``io_pipeline`` (``resolve_io_pipeline``);
* read by the run statistics and recovery: ``sd_mode`` ("segment" or
  "batch"), ``convergence`` with ``rel_err_target``, ``batch_moves`` and
  ``converged_fraction`` (``resolve_convergence``),
  ``truncation_retries`` and ``quarantine``;
* read by the walk's feature tails: ``record_xpoints`` (the intersection
  points), ``sort_by_element`` with ``migration_period`` (the periodic
  element sort) and ``checkify_invariants`` (the walk's invariant checks);
* accepted and ignored, because in the JAX package they only schedule the
  same arithmetic (straggler compaction, loop unrolling, scatter and
  gather strategies): ``compact_after``, ``compact_size``,
  ``compact_stages``, ``unroll``, ``tally_scatter``, ``gathers``. One
  difference shows at the crossing bound: the JAX walk tests
  ``max_crossings`` once per block of ``unroll`` iterations, the port
  every iteration (as the JAX walk with ``unroll=1``), so with a bound
  small enough to truncate walks the JAX walk lets lanes run past it;
* every other field is a feature the port does not have yet: setting it
  away from its default raises ``NotImplementedError`` naming the
  ROADMAP.md item that ports it. Nothing computes something else
  silently.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

IO_PIPELINES = ("packed", "overlap", "legacy")
SD_MODES = ("segment", "batch")

# Field → the ROADMAP.md port item that brings it.
_UNPORTED = {
    "integrity": "A8 (integrity)",
    "integrity_tol": "A8 (integrity)",
    "audit_lanes": "A8 (integrity audit)",
    "audit_every": "A8 (integrity audit)",
    "audit_tol": "A8 (integrity audit)",
    "audit_seed": "A8 (integrity audit)",
    "move_deadline_s": "A8 (watchdog)",
    "megastep": "A7 (megastep)",
    "kernel": "B1 (the port's walk kernel is csrc/walk.cu; there is no "
              "Pallas backend to select)",
    "pallas_lane_block": "B1 (no Pallas backend)",
    "tuning": "A10 (tuning)",
}


@dataclasses.dataclass(frozen=True)
class TallyConfig:
    """Static configuration of a port :class:`PumiTally` run (see the module
    docstring for which fields the port reads)."""

    n_groups: int = 2
    tolerance: float = 1e-8
    max_crossings: int | None = None
    compact_after: int | None = 32
    compact_size: int | None = None
    compact_stages: tuple | str | None = None
    unroll: int = 8
    migration_period: int = 100
    sort_by_element: bool = False
    dtype: Any = torch.float32
    output_filename: str = "fluxresult.vtk"
    score_squares: bool = True
    measure_time: bool = False
    checkify_invariants: bool = False
    record_xpoints: int | None = None
    robust: bool = True
    tally_scatter: str = "auto"
    gathers: str = "merged"
    ledger: bool = True
    walk_stats: bool = True
    sd_mode: str = "segment"
    quarantine: bool = False
    truncation_retries: int = 0
    io_pipeline: str = "packed"
    integrity: str = "off"
    integrity_tol: float | None = None
    audit_lanes: int = 0
    audit_every: int = 1
    audit_tol: float | None = None
    audit_seed: int = 0
    move_deadline_s: float | None = None
    convergence: bool = False
    rel_err_target: float = 0.05
    batch_moves: int | None = None
    converged_fraction: float = 0.95
    megastep: int | None = None
    kernel: str = "xla"
    pallas_lane_block: int | None = None
    tuning: str | None = None

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if f.name in _UNPORTED and getattr(self, f.name) != f.default:
                raise NotImplementedError(
                    f"TallyConfig.{f.name}={getattr(self, f.name)!r} is not "
                    "ported to pumiumtally_tpu_torch yet (ROADMAP.md "
                    f"{_UNPORTED[f.name]}); leave it at its default "
                    f"{f.default!r}"
                )
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(
                f"dtype must be torch.float32 or torch.float64: {self.dtype!r}"
            )
        if self.n_groups < 1:
            raise ValueError(f"n_groups must be >= 1: {self.n_groups}")
        if self.sd_mode not in SD_MODES:
            raise ValueError(
                f"sd_mode must be 'segment' or 'batch': {self.sd_mode!r}"
            )
        if self.truncation_retries < 0:
            raise ValueError(
                "truncation_retries must be >= 0: "
                f"{self.truncation_retries}"
            )

    def resolve_convergence(self) -> int | None:
        """Validate the convergence knobs and return the moves per batch
        (None when convergence is off), as the JAX package does."""
        if not self.convergence:
            if self.batch_moves is not None:
                raise ValueError(
                    "batch_moves only applies to convergence "
                    "observability: set convergence=True or drop it"
                )
            return None
        if not self.rel_err_target > 0:
            raise ValueError(
                f"rel_err_target must be positive: {self.rel_err_target}"
            )
        if not 0 < self.converged_fraction <= 1:
            raise ValueError(
                "converged_fraction must be in (0, 1]: "
                f"{self.converged_fraction}"
            )
        bm = 1 if self.batch_moves is None else int(self.batch_moves)
        if bm < 1:
            raise ValueError(f"batch_moves must be >= 1: {bm}")
        if self.checkify_invariants:
            # As in the JAX package: the two debug surfaces do not compose.
            raise ValueError(
                "convergence observability does not compose with "
                "checkify_invariants (the checkified walk cannot carry "
                "the batch accumulators); disable one of them"
            )
        return bm

    def resolve_io_pipeline(self) -> str:
        """The effective move-loop I/O mode (``api.py``): the environment
        variable ``PUMI_TPU_IO_PIPELINE`` beats the field; the debug
        surfaces that need the unpacked result (``record_xpoints``,
        ``checkify_invariants``) force ``"legacy"``, as in the JAX
        package."""
        mode = os.environ.get("PUMI_TPU_IO_PIPELINE") or self.io_pipeline
        if mode not in IO_PIPELINES:
            raise ValueError(
                f"io_pipeline must be 'packed', 'overlap' or 'legacy': "
                f"{mode!r}"
            )
        if self.record_xpoints is not None or self.checkify_invariants:
            return "legacy"
        return mode

    def resolve_max_crossings(self, ntet: int) -> int:
        if self.max_crossings is not None:
            return self.max_crossings
        # A straight segment meets a convex tet in one interval, so a walk
        # enters each element at most once: ntet (+ slack) always suffices.
        return ntet + 64
