"""Self-verifying tallies: detect a wrong answer, not just a dead run.

Counterpart of ``pumiumtally_tpu/integrity/`` (single device), threaded
through the facade by ``TallyConfig``:

  * ``invariants`` — the schema and host-side checks of the conservation
    vector the walk computes on the device (``ops/walk.py::
    integrity_vector``) and the packed readback carries;
  * ``audit`` — shadow audits: a K-lane sample walked again by a float64
    host walker each audited move (``audit_lanes``);
  * ``policy`` — the escalation ladder of ``integrity="off" | "warn" |
    "retry" | "halt"``;
  * ``watchdog`` — a deadline around a move's device work
    (``move_deadline_s``).

Each detector is proven by a fault of ``resilience/faultinject.py``
(``PUMI_TPU_FAULTS``: ``bitflip_flux``, ``sdc_walk``, ``hang_at_move``).
"""
from .audit import AuditOutcome, HostReference, audit_sample
from .invariants import (
    IIDX,
    INTEGRITY_FIELDS,
    INTEGRITY_LEN,
    audit_tolerance,
    check_megastep,
    check_move,
    conservation_tolerance,
    integrity_to_dict,
    mesh_scale,
)
from .policy import (
    FatalIntegrityViolation,
    IntegrityViolation,
    TransientIntegrityViolation,
    escalate,
)
from .watchdog import DispatchTimeoutError, run_with_deadline

__all__ = [
    "INTEGRITY_FIELDS",
    "INTEGRITY_LEN",
    "IIDX",
    "integrity_to_dict",
    "check_move",
    "check_megastep",
    "conservation_tolerance",
    "audit_tolerance",
    "mesh_scale",
    "HostReference",
    "AuditOutcome",
    "audit_sample",
    "IntegrityViolation",
    "TransientIntegrityViolation",
    "FatalIntegrityViolation",
    "escalate",
    "DispatchTimeoutError",
    "run_with_deadline",
]
