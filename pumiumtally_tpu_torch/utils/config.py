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
* read by the device-sourced move loop: ``megastep``
  (``resolve_megastep``, the moves a ``run_source_moves`` chunk runs);
* read by the integrity layer (``resolve_integrity``, with the JAX
  package's validation and messages): ``integrity`` ("off", "warn",
  "retry" or "halt"), ``integrity_tol``, the shadow audit's
  ``audit_lanes``, ``audit_every``, ``audit_tol`` and ``audit_seed``,
  and the watchdog's ``move_deadline_s``;
* accepted and ignored, because in the JAX package they only schedule the
  same arithmetic (straggler compaction, loop unrolling, scatter and
  gather strategies): ``compact_after``, ``compact_size``,
  ``compact_stages``, ``unroll``, ``tally_scatter``, ``gathers``, with
  the JAX package's refusals of unknown values (``tally_scatter``,
  ``gathers`` and a ``compact_stages`` string, at construction). One
  difference shows at the crossing bound: the JAX walk tests
  ``max_crossings`` once per block of ``unroll`` iterations, the port
  every iteration (as the JAX walk with ``unroll=1``), so with a bound
  small enough to truncate walks the JAX walk lets lanes run past it;
* accepted with the JAX package's validation and refusals, and then
  ignored: ``kernel`` ("xla", "pallas" or "auto", env
  ``PUMI_TPU_KERNEL``; ``resolve_kernel``) and ``pallas_lane_block``
  (``resolve_lane_block``). The JAX package selects between two walk
  backends with them; the port has one walk, whatever the value: the
  plain PyTorch walk on the CPU and ``csrc/walk.cu`` on the card;
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
    "tuning": "A10 (tuning)",
}
INTEGRITY_MODES = ("off", "warn", "retry", "halt")
KERNELS = ("xla", "pallas", "auto")
TALLY_SCATTERS = ("auto", "interleaved", "pair")
GATHERS = ("merged", "split")
COMPACT_STAGE_NAMES = ("auto", "plan", "adaptive")


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
        # The scheduling knobs are ignored, but a value the JAX package
        # refuses is refused here too, with its message.
        if self.tally_scatter not in TALLY_SCATTERS:
            raise ValueError(
                f"tally_scatter must be 'auto', 'interleaved' or 'pair': "
                f"{self.tally_scatter!r}"
            )
        if self.gathers not in GATHERS:
            raise ValueError(
                f"gathers must be 'merged' or 'split': {self.gathers!r}")
        if (isinstance(self.compact_stages, str)
                and self.compact_stages not in COMPACT_STAGE_NAMES):
            raise ValueError(
                "unknown compact_stages string "
                f"{self.compact_stages!r}; expected 'auto', 'plan', "
                "'adaptive' or an explicit "
                "((start, size[, unroll]), ...) schedule"
            )

    def resolve_kernel(self) -> str:
        """The walk-backend knob as the JAX package resolves it ("xla",
        "pallas" or "auto"; env ``PUMI_TPU_KERNEL`` beats the field),
        with its resolve-time refusals: an explicit "pallas" with
        ``record_xpoints``, ``checkify_invariants`` or ``megastep``
        raises ValueError, and an env-forced "pallas" over such a config
        resolves to "xla". The port has one walk whatever the value."""
        env = os.environ.get("PUMI_TPU_KERNEL")
        kernel = env or self.kernel
        if kernel not in KERNELS:
            raise ValueError(
                f"kernel must be 'xla', 'pallas' or 'auto': {kernel!r}"
            )
        if kernel != "pallas":
            return kernel
        conflict = None
        if self.record_xpoints is not None:
            conflict = (
                "kernel='pallas' cannot record intersection points "
                "(the Mosaic kernel keeps no per-crossing recording "
                "buffers); use kernel='xla' or drop record_xpoints"
            )
        elif self.checkify_invariants:
            conflict = (
                "kernel='pallas' cannot thread checkify device "
                "asserts through the Mosaic kernel; use "
                "kernel='xla' or drop checkify_invariants"
            )
        elif self.megastep is not None:
            conflict = (
                "kernel='pallas' does not compose with the fused "
                "megastep program (megastep=K fuses source sampling "
                "+ walk + physics into one scanned XLA body); use "
                "kernel='xla' for device-sourced megastep runs, or "
                "drop megastep and drive per-move dispatches"
            )
        if conflict is None:
            return kernel
        if env and self.kernel != "pallas":
            return "xla"
        raise ValueError(conflict)

    def resolve_lane_block(self, n_particles: int | None = None
                           ) -> int | None:
        """The Pallas block width as the JAX package validates it (env
        ``PUMI_TPU_PALLAS_LANE_BLOCK`` beats the field; a positive power
        of two, clamped to the batch), or None. The port's walk ignores
        it."""
        env = os.environ.get("PUMI_TPU_PALLAS_LANE_BLOCK")
        if env:
            lb = int(env)
        elif self.pallas_lane_block is not None:
            lb = int(self.pallas_lane_block)
        else:
            return None
        if lb < 1 or (lb & (lb - 1)) != 0:
            raise ValueError(
                f"pallas_lane_block must be a positive power of two "
                f"(the one-hot block tiles the MXU): {lb}"
            )
        if n_particles is not None:
            lb = min(lb, max(int(n_particles), 1))
        return lb

    def resolve_megastep(self, *, tuned=None) -> int:
        """The moves a ``run_source_moves`` chunk runs, K: env
        ``PUMI_TPU_MEGASTEP`` beats the field, the field beats ``tuned``
        (a tuning decision with a ``megastep`` attribute; None until the
        tuning database is ported, ROADMAP.md A10), else 1. Any K gives
        the same bits as K = 1. Recorded intersection points and the
        invariant checks are per-move facade surfaces, refused here for
        any K, as in the JAX package."""
        env = os.environ.get("PUMI_TPU_MEGASTEP")
        if env:
            k = int(env)
        elif self.megastep is not None:
            k = int(self.megastep)
        elif tuned is not None and tuned.megastep:
            k = int(tuned.megastep)
        else:
            k = 1
        if k < 1:
            raise ValueError(f"megastep must be >= 1: {k}")
        if self.record_xpoints is not None:
            raise ValueError(
                "the device-sourced megastep program cannot record "
                "intersection points (record_xpoints); use the per-move "
                "facade path (move_to_next_location) or drop "
                "record_xpoints"
            )
        if self.checkify_invariants:
            raise ValueError(
                "the device-sourced megastep program cannot thread "
                "checkify device asserts (checkify_invariants); use the "
                "per-move facade path (move_to_next_location) or drop "
                "checkify_invariants"
            )
        return k

    def resolve_integrity(self) -> str:
        """Validate and return the integrity mode (``integrity/policy.py``
        escalation ladder), as the JAX package does: the conservation
        check needs the track-length ledger, and the audit and watchdog
        knobs must be coherent."""
        mode = self.integrity
        if mode not in INTEGRITY_MODES:
            raise ValueError(
                "integrity must be 'off', 'warn', 'retry' or 'halt': "
                f"{mode!r}"
            )
        if mode != "off" and not self.ledger:
            raise ValueError(
                "integrity checks need the track-length conservation "
                "ledger: keep ledger=True (the default) or set "
                "integrity='off'"
            )
        if self.audit_lanes < 0:
            raise ValueError(
                f"audit_lanes must be >= 0: {self.audit_lanes}"
            )
        if self.audit_every < 1:
            raise ValueError(
                f"audit_every must be >= 1: {self.audit_every}"
            )
        if self.audit_lanes and not self.ledger:
            raise ValueError(
                "shadow audits compare the track-length ledger: keep "
                "ledger=True (the default) or set audit_lanes=0"
            )
        if (
            self.move_deadline_s is not None
            and self.move_deadline_s <= 0
        ):
            raise ValueError(
                f"move_deadline_s must be positive: {self.move_deadline_s}"
            )
        return mode

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
