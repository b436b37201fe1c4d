"""The synthetic many-job workload and its drain.

Counterpart of ``pumiumtally_tpu/serving/saturate.py``: N jobs spread in
turn over a ladder of request sizes (each a shape class of its own after
padding), every job with its own source seed, drained by one
``TallyScheduler`` (``run_saturation``) or by a ``FleetRouter`` behind
the HTTP gateway (``run_fleet_saturation``). ``python -m
pumiumtally_tpu_torch.serving --demo`` drives them.
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
            # checkpoint parking, so that recovery works from the
            # write-ahead journal alone (as run_fleet_saturation's
            # router crash below). abandon() still releases device
            # state and the signal handlers, which a dead process would
            # not hold.
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


def run_fleet_saturation(
    mesh,
    config=None,
    *,
    fleet_dir: str,
    n_members: int = 2,
    port: int = 0,
    bank=None,
    n_jobs: int = 8,
    class_sizes: tuple = (96, 192),
    n_moves: int = 8,
    seed: int = 0,
    resume: bool = False,
    faults=None,
    absorb_member_kills: bool = False,
    via_http: bool = True,
    device=None,
    **member_kwargs,
) -> dict:
    """The fleet's twin of ``run_saturation``: the same workload, each
    job POSTed to a ``TallyGateway`` (with an idempotency key) in front
    of a ``FleetRouter`` of ``n_members`` schedulers on ``device``, then
    drained.

    Every submission carries ``idempotency_key="key-<job_id>"``, so
    ``resume=True`` (the restart of a crashed router) re-POSTs the whole
    workload and FLEET.json's key map dedups every job the previous
    process accepted. ``via_http=False`` calls ``router.submit``
    directly. An ``InjectedKill`` that no member absorbs crashes the
    router: it is abandoned (no journal write) and the kill propagates."""
    import json as _json
    import os
    import urllib.request

    from .fleet import FLEET_FILE, FleetRouter
    from .gateway import TallyGateway
    from .journal import request_to_json

    kwargs = dict(
        bank=bank,
        faults=faults,
        absorb_member_kills=absorb_member_kills,
        device=device,
        **member_kwargs,
    )
    if resume and os.path.exists(os.path.join(fleet_dir, FLEET_FILE)):
        router = FleetRouter.recover(fleet_dir, mesh, config, **kwargs)
    else:
        router = FleetRouter(
            mesh, config, fleet_dir=fleet_dir, n_members=n_members,
            **kwargs,
        )
    gateway = TallyGateway(router, port=port) if via_http else None
    crashed = False
    try:
        requests = synthetic_requests(
            mesh, n_jobs, class_sizes=class_sizes, n_moves=n_moves,
            seed=seed,
        )
        ids = []
        for r in requests:
            key = f"key-{r.job_id}"
            if gateway is not None:
                body = _json.dumps(
                    dict(request_to_json(r), idempotency_key=key)
                ).encode()
                with urllib.request.urlopen(
                    urllib.request.Request(
                        f"{gateway.url}/submit", data=body,
                        method="POST",
                        headers={"Content-Type": "application/json"},
                    ),
                    timeout=30,
                ) as resp:
                    ids.append(_json.loads(resp.read())["job"])
            else:
                ids.append(router.submit(r, idempotency_key=key))
        t0 = time.perf_counter()
        try:
            router.run()
        except InjectedKill:
            # A modeled router crash (no member absorbed it): recovery
            # works from FLEET.json and the member journals alone.
            crashed = True
            router.abandon()
            raise
        elapsed = time.perf_counter() - t0
        stats = router.stats()
        per_job = [
            {
                "job": j.id,
                "shape_key": j.shape_key,
                "outcome": j.outcome,
                "member": router.member_of(j.id),
                "moves": j.moves_done,
                "preemptions": j.preemptions,
                "retries": j.retries,
                "device_seconds": round(j.device_seconds, 4),
                "trace_id": j.trace_id,
                "error": j.error,
            }
            for j in (router.job(i) for i in ids)
        ]
        return {
            "n_jobs": n_jobs,
            "n_members": stats["members"],
            "class_sizes": list(class_sizes),
            "n_moves": n_moves,
            "elapsed_s": round(elapsed, 4),
            "jobs_per_sec": round(n_jobs / elapsed, 3),
            "via_http": gateway is not None,
            "fleet": stats,
            "per_job": per_job,
            # Raw flux per job id (bitwise comparisons; JSON writers
            # drop the arrays first).
            "results": {
                i: router.result(i) for i in ids
                if router.job(i).result is not None
            },
        }
    finally:
        if gateway is not None:
            gateway.stop()
        if not crashed:
            router.close()
