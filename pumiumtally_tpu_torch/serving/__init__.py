"""Tally-as-a-service: the library bank, the journal, the shape-bucketed
scheduler, the serving fleet and the saturation runs.

Counterpart of ``pumiumtally_tpu/serving``. ``ProgramBank`` keeps the
built kernel libraries on disk per environment so that a warm server
process builds nothing; ``TallyScheduler`` multiplexes jobs over one card
by quanta of ``run_source_moves``, with convergence eviction, checkpoint
preemption, per-job failure isolation, admission backpressure and the
crash-safe ``JOBS.json`` journal (``SchedulerJournal``,
``TallyScheduler.recover``); ``FleetRouter`` owns N journaled members
behind the ``FLEET.json`` routing journal (idempotent acceptance,
crash-safe placement, migration, member-death absorption, recovery);
``FleetSupervisor`` evicts wedged, slow or disk-pressured members on its
health probes; ``TallyGateway`` is the HTTP ingress in front of the
router; ``run_saturation`` and ``run_fleet_saturation`` drive the
synthetic many-job workload (``python -m pumiumtally_tpu_torch.serving``).
"""
from .bank import ProgramBank
from .fleet import FleetJournal, FleetMember, FleetRouter
from .gateway import TallyGateway, decode_result
from .journal import SchedulerJournal
from .saturate import (
    run_fleet_saturation,
    run_saturation,
    synthetic_requests,
)
from .scheduler import JobRequest, TallyScheduler
from .supervisor import FleetSupervisor

__all__ = [
    "FleetJournal",
    "FleetMember",
    "FleetRouter",
    "FleetSupervisor",
    "JobRequest",
    "ProgramBank",
    "SchedulerJournal",
    "TallyGateway",
    "TallyScheduler",
    "decode_result",
    "run_fleet_saturation",
    "run_saturation",
    "synthetic_requests",
]
