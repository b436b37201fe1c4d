"""The synthetic many-job workload and its drain.

Counterpart of ``pumiumtally_tpu/serving/saturate.py`` (its single-server
part): N jobs spread in turn over a ladder of request sizes (each a
shape class of its own after padding), every job with its own source
seed, drained by one ``TallyScheduler``. ``python -m
pumiumtally_tpu_torch.serving --demo`` drives it.
"""
from __future__ import annotations

import time

import numpy as np

from ..resilience.faultinject import InjectedKill


def synthetic_requests(
    mesh,
    n_jobs: int,
    *,
    class_sizes: tuple = (96, 192),
    n_moves: int = 8,
    seed: int = 0,
) -> list:
    """Build ``n_jobs`` JobRequests cycling over ``class_sizes``
    particle counts (each size pads to its own shape bucket).  Origins
    are element centroids sampled per-job; each job gets its own
    source seed, so jobs are statistically independent streams."""
    from ..ops.source import SourceParams
    from .scheduler import JobRequest

    centroids = mesh.centroids().cpu().numpy().astype(np.float64)
    out = []
    for i in range(n_jobs):
        n = int(class_sizes[i % len(class_sizes)])
        rng = np.random.default_rng([seed, i])
        elems = rng.integers(0, mesh.ntet, n)
        out.append(
            JobRequest(
                origins=centroids[elems],
                n_moves=int(n_moves),
                source=SourceParams(seed=seed + 1000 + i),
                job_id=f"sat-{i:04d}",
            )
        )
    return out


def run_saturation(
    mesh,
    config=None,
    *,
    bank=None,
    n_jobs: int = 8,
    class_sizes: tuple = (96, 192),
    n_moves: int = 8,
    seed: int = 0,
    max_resident: int = 2,
    quantum_moves: int | None = None,
    preempt_after: int | None = None,
    checkpoint_dir: str | None = None,
    max_queued: int | None = None,
    job_retries: int = 2,
    quantum_deadline_s: float | None = None,
    journal_dir: str | None = None,
    blackbox_dir: str | None = None,
    resume: bool = False,
    faults=None,
    device=None,
) -> dict:
    """Submit the synthetic workload, drain the scheduler, and return
    the measurement record: ``jobs_per_sec`` over the drain window
    (submission is instant; the window prices scheduling + dispatch),
    the scheduler/bank counter summary, and per-job rows.

    ``resume=True`` with a populated ``journal_dir`` recovers the
    previous process's job table first (``TallyScheduler.recover``)
    and only submits jobs the journal does not already know —
    the restart path of a killed server re-runs the SAME call and
    loses nothing."""
    import os

    t_enter = time.perf_counter()
    from .journal import JOURNAL_FILE
    from .scheduler import TallyScheduler

    kwargs = dict(
        bank=bank,
        max_resident=max_resident,
        quantum_moves=quantum_moves,
        preempt_after=preempt_after,
        checkpoint_dir=checkpoint_dir,
        max_queued=max_queued,
        job_retries=job_retries,
        quantum_deadline_s=quantum_deadline_s,
        blackbox_dir=blackbox_dir,
        faults=faults,
        device=device,
    )
    if (
        resume
        and journal_dir is not None
        and os.path.exists(os.path.join(journal_dir, JOURNAL_FILE))
    ):
        sched = TallyScheduler.recover(journal_dir, mesh, config, **kwargs)
    else:
        sched = TallyScheduler(
            mesh, config, journal_dir=journal_dir, **kwargs
        )
    crashed = False
    try:
        requests = synthetic_requests(
            mesh, n_jobs, class_sizes=class_sizes, n_moves=n_moves,
            seed=seed,
        )
        known = {j.id for j in sched.jobs()}
        ids = [
            r.job_id if r.job_id in known else sched.submit(r)
            for r in requests
        ]
        t0 = time.perf_counter()
        try:
            sched.run()
        except InjectedKill:
            # A modeled server crash: skip close() and its graceful
            # checkpoint parking — recovery must work from the
            # write-ahead journal ALONE (the chaos-campaign contract).
            # abandon() still releases device state and the signal
            # handlers, which a real dead process would not hold.
            crashed = True
            sched.abandon()
            raise
        elapsed = time.perf_counter() - t0
        stats = sched.stats()
        per_job = [
            {
                "job": j.id,
                "shape_key": j.shape_key,
                "outcome": j.outcome,
                "moves": j.moves_done,
                "preemptions": j.preemptions,
                "retries": j.retries,
                "recovery_seconds": round(j.recovery_seconds, 4),
                "device_seconds": round(j.device_seconds, 4),
                "trace_id": j.trace_id,
                "error": j.error,
                # Seconds from this call's start (scheduler, recovery
                # and submission included) to the job's first quantum;
                # None for a job that never ran one.
                "first_quantum_s": (
                    None if j.first_dispatch_s is None
                    else round(j.first_dispatch_s - t_enter, 4)
                ),
            }
            for j in (sched.job(i) for i in ids)
        ]
        return {
            "n_jobs": n_jobs,
            "class_sizes": list(class_sizes),
            "n_moves": n_moves,
            "elapsed_s": round(elapsed, 4),
            "jobs_per_sec": round(n_jobs / elapsed, 3),
            "scheduler": stats,
            "per_job": per_job,
            # Raw flux per job id — callers that verify bitwise parity
            # (tests, the bench's off-vs-warm check) read these; JSON
            # writers drop the arrays first.  Poisoned/rejected jobs
            # have no flux and no entry.
            "results": {
                i: sched.result(i) for i in ids
                if sched.job(i).result is not None
            },
        }
    finally:
        if not crashed:
            sched.close()
