"""Facade-level telemetry: one registry and one flight recorder per tally.

Counterpart of ``pumiumtally_tpu/obs/telemetry.py``, with the same metric
names, help texts and record schemas, so the two packages' telemetry
reads the same. The facade calls:

  * ``record_walk(kind, move, stats, seconds=..., **extra)`` once per
    walk (initial search or move) with the host view of the walk stats
    vector (``obs/walk_stats.py::stats_to_dict``) and the transfers the
    call made;
  * ``record_quarantine`` and ``record_rewalk`` from the quarantine and
    the truncation escalation;
  * ``record_integrity`` and ``record_audit`` from the integrity checks
    (``integrity/``);
  * ``record_memory(phase)`` at phase boundaries (construction, VTK
    write) to capture the card's memory peaks;
  * ``snapshot(times=...)`` from ``tally.telemetry()``.

Metric families (a private registry per tally, so concurrent tallies do
not interleave):
  pumi_moves_total, pumi_segments_total, pumi_crossings_total,
  pumi_truncated_walks_total, pumi_chase_hops_total,
  pumi_migration_rounds_total, pumi_compaction_occupancy,
  pumi_move_seconds, pumi_device_peak_bytes{device=...},
  pumi_quarantined_lanes_total, pumi_quarantine_reasons_total{reason=...},
  pumi_rewalked_lanes_total, pumi_lost_walks_total, the transfer counters
  pumi_{h2d,d2h}_{bytes,transfers}_total, and the integrity families
  pumi_integrity_violations_total{check=...}, pumi_audited_lanes_total
  and pumi_audit_mismatches_total.
"""
from __future__ import annotations

import dataclasses

from ..utils.profiling import device_memory_stats
from .recorder import FlightRecorder
from .registry import MetricsRegistry


class TallyTelemetry:
    def __init__(
        self,
        facade: str,
        registry: MetricsRegistry | None = None,
        recorder: FlightRecorder | None = None,
    ):
        self.facade = facade
        self.registry = registry if registry is not None else MetricsRegistry()
        self.recorder = recorder if recorder is not None else FlightRecorder()
        r = self.registry
        self._moves = r.counter(
            "pumi_moves_total", "facade move_to_next_location calls"
        )
        self._segments = r.counter(
            "pumi_segments_total", "scored particle-segments"
        )
        self._crossings = r.counter(
            "pumi_crossings_total", "real element-boundary crossings"
        )
        self._truncated = r.counter(
            "pumi_truncated_walks_total",
            "walks not finished within max_crossings / the round bound",
        )
        self._chase = r.counter(
            "pumi_chase_hops_total",
            "stuck-escape (relocation chase) activations",
        )
        self._rounds = r.counter(
            "pumi_migration_rounds_total",
            "partitioned walk/exchange rounds executed",
        )
        self._occ = r.gauge(
            "pumi_compaction_occupancy",
            "mean post-compaction active occupancy of the last trace",
        )
        self._move_s = r.histogram(
            "pumi_move_seconds", "wall-clock seconds per facade move"
        )
        self._hbm = r.gauge(
            "pumi_device_peak_bytes", "peak device memory in use"
        )
        self._quarantined = r.counter(
            "pumi_quarantined_lanes_total",
            "lanes masked out of the walk by the bad-particle "
            "quarantine (each lane once per move, however many "
            "reasons it trips)",
        )
        self._quarantine_reasons = r.counter(
            "pumi_quarantine_reasons_total",
            "quarantine verdicts by reason (a lane tripping several "
            "reasons counts once per reason)",
        )
        self._rewalked = r.counter(
            "pumi_rewalked_lanes_total",
            "truncated lanes re-walked by the escalation policy",
        )
        self._lost = r.counter(
            "pumi_lost_walks_total",
            "walks declared lost after bounded re-walk retries (or "
            "immediately, with the escalation policy off)",
        )
        # Move-loop I/O accounting (ops/staging.py): bytes and transfer
        # counts the facade staged per walk. Under io_pipeline="packed"
        # a move makes one H2D and one D2H.
        self._h2d_bytes = r.counter(
            "pumi_h2d_bytes_total",
            "host-to-device bytes staged by the move loop",
        )
        self._d2h_bytes = r.counter(
            "pumi_d2h_bytes_total",
            "device-to-host bytes read back by the move loop",
        )
        self._h2d_transfers = r.counter(
            "pumi_h2d_transfers_total",
            "host-to-device transfers issued by the move loop",
        )
        self._d2h_transfers = r.counter(
            "pumi_d2h_transfers_total",
            "device-to-host transfers issued by the move loop",
        )
        # Self-verification families: violations by check, shadow-audit
        # volume, and the worst conservation residual seen this run.
        self._integ_violations = r.counter(
            "pumi_integrity_violations_total",
            "integrity-check violations (labeled by check: "
            "conservation, flux, lanes, sdc_audit, watchdog)",
        )
        self._audited = r.counter(
            "pumi_audited_lanes_total",
            "lanes re-walked by the float64 shadow audit",
        )
        self._audit_mismatch = r.counter(
            "pumi_audit_mismatches_total",
            "shadow-audit lanes disagreeing with the host reference "
            "beyond tolerance",
        )
        self._max_residual = 0.0

    # ------------------------------------------------------------------ #
    def record_walk(
        self,
        kind: str,
        move: int,
        stats: dict | None,
        seconds: float | None = None,
        **extra,
    ) -> dict:
        """Fold one trace's stats into the counters and the recorder.
        ``stats`` is the named dict from the on-device stats vector (or
        None when walk stats are disabled); ``seconds`` is the facade
        phase time for this call where measured."""
        fields = dict(extra)
        fields["move"] = int(move)
        if seconds is not None:
            fields["seconds"] = round(float(seconds), 6)
            if kind == "move":
                self._move_s.observe(float(seconds))
        if kind == "move":
            self._moves.inc()
        elif kind == "megastep":
            # One record covers the chunk's K device moves; the moves
            # counter advances by K, so totals count moves in either loop.
            self._moves.inc(int(extra.get("moves", 1)))
        if stats is not None:
            fields.update(stats)
            self._segments.inc(stats["segments"])
            self._crossings.inc(stats["crossings"])
            self._truncated.inc(stats["truncated"])
            self._chase.inc(stats["chase_hops"])
            if stats.get("occupancy") is not None:
                self._occ.set(stats["occupancy"])
        if "rounds" in extra:
            self._rounds.inc(int(extra["rounds"]))
        # I/O accounting riding the same record (what the facade
        # staged: packed, one record each way; legacy, one copy per
        # array).
        for key, counter in (
            ("h2d_bytes", self._h2d_bytes),
            ("d2h_bytes", self._d2h_bytes),
            ("h2d_transfers", self._h2d_transfers),
            ("d2h_transfers", self._d2h_transfers),
        ):
            if key in extra:
                counter.inc(int(extra[key]))
        return self.recorder.record(kind, **fields)

    def record_quarantine(
        self, move: int, lanes: int, reasons: dict
    ) -> dict:
        """Fold one move's quarantine verdicts: ``lanes`` is the
        deduplicated parked-lane count (the headline number, agrees
        with ``quarantined_lanes()``); ``reasons`` maps reason name →
        verdict count (``resilience/quarantine.py::REASONS``)."""
        self._quarantined.inc(lanes)
        for reason, count in reasons.items():
            if count:
                self._quarantine_reasons.inc(count, reason=reason)
        return self.recorder.record(
            "quarantine", move=int(move), lanes=int(lanes), **reasons
        )

    def record_rewalk(self, move: int, retried: int, lost: int) -> dict:
        """Fold one move's truncation-escalation outcome: lanes
        re-walked (summed over attempts) and lanes finally lost."""
        if retried:
            self._rewalked.inc(retried)
        if lost:
            self._lost.inc(lost)
        return self.recorder.record(
            "rewalk", move=int(move), retried=int(retried),
            lost=int(lost),
        )

    def record_integrity(
        self, move: int, fields: dict, violations: list
    ) -> dict:
        """Fold one move's integrity evaluation: the invariant scalars
        (``integrity/invariants.py`` field names; empty for a watchdog
        event) and the violated check names. Counted here, before the
        policy escalates, so the counters agree whichever rung fires."""
        for check in violations:
            self._integ_violations.inc(check=check)
        if fields.get("max_residual") is not None:
            self._max_residual = max(
                self._max_residual, float(fields["max_residual"])
            )
        return self.recorder.record(
            "integrity",
            move=int(move),
            violations=list(violations),
            **fields,
        )

    def record_audit(
        self, move: int, audited: int, mismatches: int, skipped: int,
        max_dev: float,
    ) -> dict:
        """Fold one move's shadow-audit outcome (``integrity/audit.py``)
        into the counters and the flight recorder."""
        if audited:
            self._audited.inc(audited)
        if mismatches:
            self._audit_mismatch.inc(mismatches)
        return self.recorder.record(
            "audit",
            move=int(move),
            audited=int(audited),
            mismatches=int(mismatches),
            skipped=int(skipped),
            max_dev=float(max_dev),
        )

    def record_memory(self, phase: str) -> dict:
        """Sample the card's memory at a phase boundary (nothing off the
        card; ``utils/profiling.py``)."""
        mem = device_memory_stats()
        for dev, rec in mem.items():
            if "peak_bytes_in_use" in rec:
                self._hbm.set(rec["peak_bytes_in_use"], device=dev)
        return self.recorder.record("memory", phase=phase, devices=mem)

    # ------------------------------------------------------------------ #
    def snapshot(self, times=None, tail: int = 64) -> dict:
        """The ``tally.telemetry()`` payload: counter totals, the last
        ``tail`` flight records, a fresh memory sample, phase times, and
        the full registry snapshot."""
        quarantined = self._quarantined.value()
        out = {
            "facade": self.facade,
            "totals": {
                "moves": self._moves.value(),
                "segments": self._segments.value(),
                "crossings": self._crossings.value(),
                "truncated": self._truncated.value(),
                "chase_hops": self._chase.value(),
                "migration_rounds": self._rounds.value(),
                "quarantined": quarantined,
                "rewalked": self._rewalked.value(),
                "lost": self._lost.value(),
                "h2d_bytes": self._h2d_bytes.value(),
                "d2h_bytes": self._d2h_bytes.value(),
                "h2d_transfers": self._h2d_transfers.value(),
                "d2h_transfers": self._d2h_transfers.value(),
            },
            # The headline resilience count, also at the top level.
            "quarantined": quarantined,
            # Self-verification block: violations by check, shadow-audit
            # volume, worst conservation residual.
            "integrity": {
                "violations": {
                    s["labels"].get("check", ""): s["value"]
                    for s in self._integ_violations.snapshot()["series"]
                },
                "audited_lanes": self._audited.value(),
                "audit_mismatches": self._audit_mismatch.value(),
                "max_residual": self._max_residual,
            },
            "per_move": self.recorder.tail(tail),
            "memory": device_memory_stats(),
            "metrics": self.registry.snapshot(),
        }
        if times is not None:
            out["times"] = dataclasses.asdict(times)
        return out
