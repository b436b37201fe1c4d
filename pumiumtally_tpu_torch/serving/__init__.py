"""Tally-as-a-service on one card: the library bank, the journal, the
shape-bucketed scheduler and the saturation run.

Counterpart of the single-server half of ``pumiumtally_tpu/serving``.
``ProgramBank`` keeps the built kernel libraries on disk per environment
so that a warm server process builds nothing; ``TallyScheduler``
multiplexes jobs over one card by quanta of ``run_source_moves``, with
convergence eviction, checkpoint preemption, per-job failure isolation,
admission backpressure and the crash-safe ``JOBS.json`` journal
(``SchedulerJournal``, ``TallyScheduler.recover``); ``run_saturation``
drives the synthetic many-job workload (``python -m
pumiumtally_tpu_torch.serving``).
"""
from .bank import ProgramBank
from .journal import SchedulerJournal
from .saturate import run_saturation, synthetic_requests
from .scheduler import JobRequest, TallyScheduler

__all__ = [
    "JobRequest",
    "ProgramBank",
    "SchedulerJournal",
    "TallyScheduler",
    "run_saturation",
    "synthetic_requests",
]
