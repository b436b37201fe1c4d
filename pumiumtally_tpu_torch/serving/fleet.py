"""The serving fleet: crash-safe routing over member schedulers.

Counterpart of ``pumiumtally_tpu/serving/fleet.py``, with the same
journal grammar, write-ahead orderings and metrics. One ``FleetRouter``
owns N journaled ``TallyScheduler`` members, places every job by load
with shape-class warmth as the tie-break, and survives a member's death
or its own without losing or running twice any job. Every member runs on
the router's ``device`` (default: the CUDA card; a machine of one card
gives every member ``cuda:0``, as the JAX router gives no member a
device of its own).

Layout, one directory a fleet::

  <fleet_dir>/FLEET.json          the routing journal (atomic
                                  tmp+fsync+rename, like JOBS.json)
  <fleet_dir>/TRACE.jsonl         the shared span stream (one tracer for
                                  every member, so a migrated job's trace
                                  reads as one)
  <fleet_dir>/member-K/           member K's own scheduler journal
                                  (serving/journal.py layout)
  <fleet_dir>/FLEETSTATS.json     the observability plane's snapshot

FLEET.json (schema 1)::

  {"schema": 1, "members": N, "n_submitted": M,
   "accepted":    {idempotency_key: job_id},
   "requests":    {job_id: request_json},   # journaled, not yet
                                            # dispatched to a member
   "assignments": {job_id: {"member": K, "migrations": J}},
   "evicted":     {member_index: {"cause": ...}},
   "breaches":    {member_index: [{"slo": ..., "burn": ...}]}}

Write-ahead orderings:

  * idempotency-record-before-accept (``FleetRouter.submit``): the key
    and the request are flushed before any member sees the job, so a
    client retrying a POST after any crash gets the same job id back
    and never starts a second run.
  * assignment-record-before-dispatch (``FleetRouter._place``): the
    assignment is flushed before the member's scheduler sees the job.
    A crash between the two leaves an assignment no member journal
    knows, and recovery dispatches it again from the journaled request.
  * eviction-record-before-drain (``FleetSupervisor._evict``,
    serving/supervisor.py): the eviction is flushed before the member's
    jobs are drained; recovery replays an interrupted drain from the
    evicted member's journal (``_replace_from_disk``).

The assignment record also arbitrates duplicates: a migration adopts the
job on member B before it drops it from member A, which briefly leaves
it in two member journals; recovery keeps the copy the assignment names.

Migration rides the checkpoints: preempt on member A at the quantum
boundary, copy the side files, ``adopt_job`` on member B; the flux is
bitwise the uninterrupted run's, since the source loop's random stream
is keyed by the move counter the checkpoint carries and every member
shares one mesh, configuration and bank. The trace goes on across the
hop with a ``migrated`` link event.

Member death (``absorb_member_kills=True`` or ``kill_member``) is
absorbed by placing the dead member's journaled jobs on the survivors:
its journal on disk is the authority for what it owned.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading

import numpy as np

from ..obs import (
    FLIGHT_SCHEMA,
    FlightRecorder,
    MetricsRegistry,
    SpanTracer,
    maybe_start_exporter,
)
from ..obs.aggregate import (
    FLEETSTATS_FILE,
    FLEETSTATS_SCHEMA,
    FleetAggregator,
)
from ..obs.profile import FleetProfiler
from ..obs.slo import SLOEvaluator, default_slos
from ..resilience.faultinject import FaultInjector, InjectedKill
from ..tuning.shapes import bucket, classify
from ..utils.checkpoint import atomic_write_bytes, atomic_write_json
from ..utils.log import log_info, log_warn
from ..utils.platform import resolve_device
from .bank import ProgramBank
from .journal import (
    JOURNAL_FILE,
    TRACE_FILE,
    RequestTexts,
    SchedulerJournal,
    check_job_id,
    request_from_json,
    request_to_json,
)
from .scheduler import (
    JobRequest,
    TallyScheduler,
    _jobs_limit,
    _quiet_exporter,
)

FLEET_SCHEMA = 1
FLEET_FILE = "FLEET.json"

# The observability plane (aggregation, SLO evaluation, profiler
# sampling, FLEETSTATS.json) is on by default; PUMI_TPU_FLEET_OBS=off
# runs the fleet without it.
ENV_FLEET_OBS = "PUMI_TPU_FLEET_OBS"


def _fleet_obs_enabled() -> bool:
    return os.environ.get(ENV_FLEET_OBS, "").strip().lower() != "off"


class FleetJournal:
    """The atomic FLEET.json routing journal (module docstring format).
    The router is the single writer; recovery is the single reader."""

    def __init__(self, dirname: str):
        self.dir = str(dirname)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, FLEET_FILE)
        self._texts = RequestTexts()

    def member_dir(self, index: int) -> str:
        return os.path.join(self.dir, f"member-{int(index):02d}")

    def trace_path(self) -> str:
        """The fleet-wide span sink: every member (and every lifetime of
        the router) appends to one TRACE.jsonl."""
        return os.path.join(self.dir, TRACE_FILE)

    def flush(self, doc: dict) -> None:
        """``atomic_write_json`` of ``{"schema": 1, **doc}``; the pending
        requests' texts are kept between flushes (``RequestTexts``)."""
        requests = doc.get("requests") or {}
        doc = dict(doc, schema=FLEET_SCHEMA, requests={
            k: RequestTexts.token(k) for k in requests})
        text = self._texts.dumps(doc, requests)
        atomic_write_bytes(self.path, (text + "\n").encode())

    def load(self) -> dict | None:
        """The committed routing document, or None before the first
        flush. An unreadable document is refused: the atomic writer
        cannot tear it, so something else wrote it, and recovering over
        it could run accepted jobs twice or drop them."""
        if not os.path.exists(self.path):
            return None
        with open(self.path) as fh:
            try:
                doc = json.load(fh)
            except ValueError as e:
                raise ValueError(
                    f"fleet journal {self.path} is not valid JSON "
                    f"({e}) — the atomic writer cannot tear it, so "
                    "this document was written by something else; "
                    "refusing to recover over it"
                ) from e
        if not isinstance(doc, dict) or doc.get("schema") != FLEET_SCHEMA:
            raise ValueError(
                f"fleet journal {self.path}: schema "
                f"{doc.get('schema') if isinstance(doc, dict) else doc!r}"
                f" != {FLEET_SCHEMA}"
            )
        return doc


class FleetMember:
    """One member: a journaled TallyScheduler and the router's view of
    it (liveness, placements, the shape classes it has served: the
    warmth signal; the supervisor's health view).

    ``scheduler`` is None for a slot the routing journal records as
    evicted: recovery keeps the index (assignments name it) but builds
    nothing for it, and ``alive`` is False.
    """

    def __init__(self, index: int, scheduler: TallyScheduler | None,
                 registry: MetricsRegistry | None = None):
        self.index = index
        self.scheduler = scheduler
        #: This member's own metrics registry. It outlives the
        #: scheduler, so an evicted member's counters stay in the fleet
        #: rollup and the rollup's counters never go back.
        self.registry = registry
        self.alive = scheduler is not None
        #: healthy / brownout / wedged / disk-pressured / slo-burn while
        #: alive, "evicted" once drained (serving/supervisor.py).
        self.health = "healthy" if scheduler is not None else "evicted"
        #: A quarantined member takes no new placement but runs the
        #: jobs it holds (the supervisor's grace before eviction).
        self.quarantined = False
        self.placed = 0            # jobs dispatched here (lifetime)
        self.warm: set[str] = set()  # shape classes served here

    @property
    def load(self) -> int:
        return self.scheduler.queue_depth + self.scheduler.resident_count


class FleetRouter:
    """Crash-safe job routing over ``n_members`` schedulers sharing one
    mesh, configuration, library bank, tracer and recorder, all on
    ``device``. Each member keeps its own metrics registry; the router's
    holds the fleet, supervisor and SLO families, and the observability
    plane (obs/aggregate.py) merges the members' into ``/fleetz`` and
    FLEETSTATS.json.

    Threads: the scheduling loop (``step``/``run``) and the gateway's
    handler threads (serving/gateway.py) serialize on ``self.lock``, so
    the member schedulers only ever run on one thread at a time.
    """

    def __init__(
        self,
        mesh,
        config=None,
        *,
        fleet_dir: str,
        n_members: int = 2,
        bank: ProgramBank | str | None = None,
        registry: MetricsRegistry | None = None,
        faults: FaultInjector | None = None,
        absorb_member_kills: bool = False,
        slos: tuple | None = None,
        device=None,
        _recover: bool = False,
        _evicted: tuple = (),
        **member_kwargs,
    ):
        if int(n_members) < 1:
            raise ValueError(f"n_members must be >= 1: {n_members}")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.config = config
        self.journal = FleetJournal(fleet_dir)
        self.registry = (
            registry if registry is not None else MetricsRegistry()
        )
        self.recorder = FlightRecorder(schema=FLIGHT_SCHEMA)
        self.tracer = SpanTracer(sink=self.journal.trace_path())
        self.absorb_member_kills = bool(absorb_member_kills)
        self.lock = threading.RLock()
        if isinstance(bank, str):
            bank = ProgramBank(
                bank, registry=self.registry, recorder=self.recorder,
                tracer=self.tracer,
            )
        self.bank = bank
        r = self.registry
        self._members_gauge = r.gauge(
            "pumi_fleet_members",
            "alive fleet members (schedulers accepting dispatch)",
        )
        self._migrations_total = r.counter(
            "pumi_fleet_migrations_total",
            "jobs re-placed across members (explicit cross-chip "
            "migration + dead-member re-placement onto survivors)",
        )
        self._fleet_queue_depth = r.gauge(
            "pumi_fleet_queue_depth",
            "per-member scheduler queue depth (labeled by member; "
            "dead members report 0)",
        )
        # The in-memory mirror of FLEET.json, touched under self.lock.
        self._accepted: dict[str, str] = {}     # idempotency key -> id
        self._requests: dict[str, dict] = {}    # journaled, undispatched
        self._pending: dict[str, JobRequest] = {}
        self._assignments: dict[str, dict] = {}
        self._evicted: dict[int, dict] = {}     # member index -> {cause}
        #: SLO breaches the supervisor journals before the quarantine
        #: they explain: {member index: [{"slo": ..., "burn": ...}]}.
        self._breaches: dict[int, list] = {}
        self._n_submitted = 0
        # Alert edges already handed to the profiler, keyed by
        # (slo, since), so that an alert that fires again captures again.
        self._seen_alerts: set = set()
        # Members bind no scrape port (the router's exporter serves the
        # fleet) and install no signal handler (their journals are
        # flushed at every transition).
        self.members: list[FleetMember] = []
        for i in range(int(n_members)):
            if i in _evicted:
                self.members.append(FleetMember(i, None))
                continue
            mdir = self.journal.member_dir(i)
            mreg = MetricsRegistry()
            mkw = dict(
                member_kwargs,
                bank=self.bank,
                registry=mreg,
                tracer=self.tracer,
                recorder=self.recorder,
                blackbox_dir=self.journal.dir,
                faults=faults,
                handle_signals=False,
                member_index=i,
                device=self.device,
            )
            with _quiet_exporter():
                if _recover and os.path.exists(
                    os.path.join(mdir, JOURNAL_FILE)
                ):
                    sched = TallyScheduler.recover(
                        mdir, mesh, config, **mkw
                    )
                else:
                    sched = TallyScheduler(
                        mesh, config, journal_dir=mdir, **mkw
                    )
            member = FleetMember(i, sched, registry=mreg)
            for j in sched.jobs():
                member.warm.add(j.shape_key)
            # A recovered member's journaled jobs count as its
            # placements: the stats reflect ownership.
            member.placed = len(sched.jobs())
            self.members.append(member)
        self.obs_enabled = _fleet_obs_enabled()
        self.aggregator: FleetAggregator | None = None
        self.slo: SLOEvaluator | None = None
        self.profiler: FleetProfiler | None = None
        if self.obs_enabled:
            self.aggregator = FleetAggregator(self._obs_registries)
            self.slo = SLOEvaluator(
                default_slos() if slos is None else slos,
                self.registry, self.recorder,
            )
            self.profiler = FleetProfiler(
                self.registry, journal_dir=self.journal.dir,
            )
        endpoints = {
            "/jobs": self._jobs_json,
            "/trace": self.tracer.chrome,
            "/fleet": self.fleet_json,
        }
        if self.aggregator is not None:
            endpoints["/fleetz"] = self.aggregator.render_prometheus
        self._exporter = maybe_start_exporter(
            self.registry, endpoints=endpoints,
        )
        self._update_gauges()
        # FLEETSTATS.json from round zero: a router killed before its
        # first step still leaves a picture on disk.
        self.obs_tick()

    # ------------------------------------------------------------------ #
    # The routing journal
    # ------------------------------------------------------------------ #
    def _flush_fleet(self) -> None:
        self.journal.flush({
            "members": len(self.members),
            "n_submitted": self._n_submitted,
            "accepted": dict(self._accepted),
            "requests": dict(self._requests),
            "assignments": {
                k: dict(v) for k, v in self._assignments.items()
            },
            "evicted": {
                str(k): dict(v) for k, v in self._evicted.items()
            },
            "breaches": {
                str(k): [dict(b) for b in v]
                for k, v in self._breaches.items()
            },
        })

    def record_breach(self, index: int, alert: dict) -> None:
        """Journal an SLO breach against member ``index`` before the
        supervisor quarantines it (breach-record-before-quarantine): the
        quarantine is explained by FLEET.json alone, even if the process
        dies right after it."""
        with self.lock:
            self._breaches.setdefault(int(index), []).append({
                "slo": str(alert.get("slo")),
                "burn": dict(alert.get("burn") or {}),
            })
            self._flush_fleet()

    def record_eviction(self, index: int, cause: str) -> None:
        """Journal the eviction of member ``index`` before any drain
        (eviction-record-before-drain); a crash after this record replays
        the drain at recovery from the member's journal."""
        with self.lock:
            self._evicted[int(index)] = {"cause": str(cause)}
            self._flush_fleet()

    # ------------------------------------------------------------------ #
    # Submission (serving/gateway.py calls this)
    # ------------------------------------------------------------------ #
    def submit(self, request: JobRequest, *,
               idempotency_key: str | None = None) -> str:
        """Accept one job and place it on a member. A key seen before
        returns the original job id and touches no scheduler; a new key
        is journaled before the job is placed
        (idempotency-record-before-accept)."""
        with self.lock:
            if idempotency_key is not None:
                try:
                    check_job_id(idempotency_key)
                except ValueError:
                    raise ValueError(
                        f"idempotency key {idempotency_key!r} is not "
                        "journal-safe (allowed: 1-128 chars of "
                        "[A-Za-z0-9._-])"
                    ) from None
                known = self._accepted.get(idempotency_key)
                if known is not None:
                    self.recorder.record(
                        "fleet_dedup", job=known, job_id=known,
                        idempotency_key=idempotency_key,
                    )
                    return known
            # Validation comes before the acceptance record: a bad
            # request must not journal a key no member will ever run.
            origins = np.asarray(
                request.origins, np.float64
            ).reshape(-1, 3)
            n = origins.shape[0]
            if n < 1:
                raise ValueError("a job needs at least one particle")
            if request.n_moves < 1:
                raise ValueError(
                    f"n_moves must be >= 1: {request.n_moves}"
                )
            for name, arr in (
                ("weights", request.weights),
                ("groups", request.groups),
            ):
                if (
                    arr is not None
                    and np.asarray(arr).reshape(-1).size != n
                ):
                    raise ValueError(
                        f"{name} has "
                        f"{np.asarray(arr).reshape(-1).size} entries "
                        f"for {n} particles"
                    )
            job_id = request.job_id or f"fleet-{self._n_submitted:05d}"
            check_job_id(job_id)
            if job_id in self._assignments or job_id in self._requests:
                raise ValueError(f"duplicate job id {job_id!r}")
            request = dataclasses.replace(request, job_id=job_id)
            shape_key = self._shape_key(n)
            self._n_submitted += 1
            if idempotency_key is not None:
                self._accepted[idempotency_key] = job_id
            self._requests[job_id] = request_to_json(request)
            self._pending[job_id] = request
            # Idempotency-record-before-accept.
            self._flush_fleet()
            self._place(job_id, shape_key)
            return job_id

    def _shape_key(self, n: int) -> str:
        cfg = next(
            m.scheduler.config for m in self.members
            if m.scheduler is not None
        )
        return classify(
            self.mesh.ntet, bucket(n), cfg.n_groups, cfg.dtype,
            getattr(self.mesh, "geo20", None) is not None,
        ).key()

    # ------------------------------------------------------------------ #
    # Placement
    # ------------------------------------------------------------------ #
    def _choose(self, shape_key: str,
                exclude: tuple = ()) -> FleetMember | None:
        """The least-loaded alive member, warm members first on a tie (a
        member that served this shape class holds its libraries loaded).
        Quarantined members rank last: they get new work only when no
        healthy member is left."""
        best = None
        best_score = None
        for m in self.members:
            if not m.alive or m.index in exclude:
                continue
            score = (
                1 if m.quarantined else 0,
                m.load,
                0 if shape_key in m.warm else 1,
                m.placed,
                m.index,
            )
            if best_score is None or score < best_score:
                best, best_score = m, score
        return best

    def _place(self, job_id: str, shape_key: str, *, entry: dict | None = None,
               src_dir: str | None = None, member: int | None = None,
               exclude: tuple = (), link: str = "migrated") -> int:
        """Assign ``job_id`` to a member, then dispatch it there: the
        assignment is flushed before the member sees the job
        (assignment-record-before-dispatch). A submission dispatches its
        pending request; a migration (``entry``, ``src_dir``) adopts the
        journaled entry, the trace going on with the ``link`` event
        (``migrated``, or the supervisor's ``evicted``)."""
        if member is not None:
            target = self.members[member]
            if not target.alive:
                raise ValueError(f"member {member} is not alive")
        else:
            target = self._choose(shape_key, exclude)
        if target is None:
            raise RuntimeError(
                f"no alive fleet member to place {job_id} on"
            )
        prev = self._assignments.get(job_id)
        self._assignments[job_id] = {
            "member": target.index,
            "migrations": (
                int(prev["migrations"]) + 1 if prev is not None else 0
            ),
        }
        self._flush_fleet()
        self._dispatch_job(
            target, job_id, entry=entry, src_dir=src_dir, link=link
        )
        return target.index

    def _dispatch_job(self, member: FleetMember, job_id: str, *,
                      entry: dict | None = None,
                      src_dir: str | None = None,
                      link: str = "migrated") -> None:
        if entry is not None:
            member.scheduler.adopt_job(entry, src_dir=src_dir, link=link)
            self._migrations_total.inc()
        else:
            member.scheduler.submit(self._pending.pop(job_id),
                                    request_json=self._requests.get(job_id))
            # The member's journal holds the request now; the router's
            # copy leaves FLEET.json at the next flush.
            self._requests.pop(job_id, None)
        member.placed += 1
        member.warm.add(member.scheduler.job(job_id).shape_key)
        self.recorder.record(
            "fleet_placed", job=job_id, job_id=job_id,
            member=member.index, migrated=entry is not None,
        )
        self._update_gauges()

    # ------------------------------------------------------------------ #
    # Migration and member death
    # ------------------------------------------------------------------ #
    def migrate(self, job_id: str, to_member: int | None = None) -> int:
        """Move one job that has not ended to another member: preempt it
        on its owner (quantum boundary), journal the assignment, adopt it
        on the target from the copied side files (bitwise: the
        checkpoint's move counter keys the random stream), then drop the
        source copy (adopt before drop: a crash in between leaves two
        journaled copies, and the assignment names the one recovery
        keeps). Returns the new member index."""
        with self.lock:
            assignment = self._assignments[job_id]
            src = self.members[assignment["member"]]
            if not src.alive:
                raise ValueError(
                    f"job {job_id} is on dead member {src.index}"
                )
            job = src.scheduler.job(job_id)
            if job.terminal:
                raise ValueError(
                    f"job {job_id} is terminal ({job.outcome}) — "
                    "nothing to migrate"
                )
            src.scheduler.preempt_job(job_id)
            fleet_entry = src.scheduler.export_entry(job_id)
            new_index = self._place(
                job_id, job.shape_key, entry=fleet_entry,
                src_dir=src.scheduler.journal.dir,
                member=to_member, exclude=(src.index,),
            )
            src.scheduler.drop_job(job_id)
            log_info(
                f"fleet migration: {job_id} member {src.index} -> "
                f"{new_index} at move {job.moves_done}"
            )
            return new_index

    def kill_member(self, index: int, reason: str = "killed") -> None:
        """Let member ``index`` die now (crash-model teardown, no journal
        write) and place its journaled jobs on the survivors."""
        with self.lock:
            member = self.members[index]
            if not member.alive:
                return
            self._absorb_death(member, reason=reason)

    def _absorb_death(self, member: FleetMember, *, reason: str) -> None:
        member.scheduler.abandon()
        member.alive = False
        self._update_gauges()
        log_warn(
            f"fleet member {member.index} died ({reason}); re-placing "
            "its journaled jobs onto survivors"
        )
        if not any(m.alive for m in self.members):
            raise RuntimeError(
                f"fleet member {member.index} died ({reason}) and no "
                "members survive"
            )
        # The dead member's journal is the authority for what it owned.
        # Terminal jobs move too (their fluxes with them), so every
        # accepted job stays owned by an alive member.
        moved = self._replace_from_disk(member.index)
        self.recorder.record(
            "member_death", member=member.index, reason=reason,
            replaced=moved,
        )
        log_info(
            f"fleet member {member.index}: {moved} journaled jobs "
            "re-placed onto survivors"
        )

    def _replace_from_disk(self, index: int, *,
                           link: str = "migrated") -> int:
        """Place member ``index``'s journaled jobs on survivors. A copy
        whose assignment names another member is skipped: it is the
        stale half of an interrupted migration, drain or eviction."""
        mdir = self.journal.member_dir(index)
        doc = SchedulerJournal(mdir).load() or {"jobs": {}}
        moved = 0
        for entry in sorted(
            doc.get("jobs", {}).values(), key=lambda e: e["index"]
        ):
            jid = entry["id"]
            assignment = self._assignments.get(jid)
            if assignment is not None and (
                assignment["member"] != index
            ):
                continue
            self._place(
                jid, entry["shape_key"], entry=entry, src_dir=mdir,
                exclude=(index,), link=link,
            )
            moved += 1
        return moved

    # ------------------------------------------------------------------ #
    # Eviction (serving/supervisor.py drives these)
    # ------------------------------------------------------------------ #
    def drain_member(self, index: int, *, cause: str) -> int:
        """Evict an alive member that still answers (brownout, disk
        pressure): park and export each of its jobs onto healthy peers
        (``evicted`` trace link), then retire it. Its in-memory table
        hands the jobs over, a degraded disk's unpersisted results
        included. Callers flush ``record_eviction`` first."""
        with self.lock:
            member = self.members[index]
            if not member.alive:
                return 0
            if not any(
                m.alive and m.index != member.index
                for m in self.members
            ):
                raise RuntimeError(
                    f"cannot drain member {index} ({cause}): no other "
                    "alive member to take its jobs"
                )
            src = member.scheduler
            moved = 0
            for job in sorted(src.jobs(), key=lambda j: j.index):
                # park_job: as preempt_job on a healthy disk; under disk
                # pressure it frees the slot without a checkpoint and the
                # job resumes from its last committed one (or move 0),
                # bitwise either way.
                src.park_job(job.id)
                assignment = self._assignments.get(job.id)
                if assignment is not None and (
                    assignment["member"] != member.index
                ):
                    src.drop_job(job.id)
                    continue
                entry = src.export_entry(job.id)
                self._place(
                    job.id, job.shape_key, entry=entry,
                    src_dir=src.journal.dir,
                    exclude=(member.index,), link="evicted",
                )
                target = self.members[
                    self._assignments[job.id]["member"]
                ]
                adopted = target.scheduler.job(job.id)
                if (job.terminal and job.result is not None
                        and adopted.result is None):
                    # The source finished the job but could not persist
                    # its flux: persist it from memory on the adopter.
                    adopted.result = job.result.copy()
                    adopted.flux_name = target.scheduler.journal.write_flux(
                        job.id, adopted.result
                    )
                    target.scheduler._flush_journal()
                src.drop_job(job.id)
                moved += 1
            src.abandon()
            member.alive = False
            member.health = "evicted"
            member.quarantined = False
            self._update_gauges()
            self.recorder.record(
                "member_evicted", member=member.index, cause=cause,
                replaced=moved, cooperative=True,
            )
            log_warn(
                f"fleet member {member.index} evicted ({cause}): "
                f"{moved} jobs drained onto healthy peers"
            )
            return moved

    def drain_member_from_journal(self, index: int, *,
                                  cause: str) -> int:
        """Evict a wedged member: it answers no probe, so its in-memory
        table is not trusted; abandon it and place its jobs from its
        journal, as for a death, under the ``evicted`` link. Callers
        flush ``record_eviction`` first."""
        with self.lock:
            member = self.members[index]
            if not member.alive:
                return 0
            member.scheduler.abandon()
            member.alive = False
            member.health = "evicted"
            member.quarantined = False
            self._update_gauges()
            if not any(m.alive for m in self.members):
                raise RuntimeError(
                    f"cannot evict wedged member {index} ({cause}): "
                    "no members survive"
                )
            moved = self._replace_from_disk(member.index, link="evicted")
            self.recorder.record(
                "member_evicted", member=member.index, cause=cause,
                replaced=moved, cooperative=False,
            )
            log_warn(
                f"fleet member {member.index} evicted ({cause}): "
                f"{moved} journaled jobs re-placed onto survivors"
            )
            return moved

    # ------------------------------------------------------------------ #
    # The observability plane (obs/aggregate.py, slo.py, profile.py)
    # ------------------------------------------------------------------ #
    def _obs_registries(self) -> list:
        """Every member that ever had a registry, dead ones included, so
        the fleet rollup never goes back."""
        return [
            (f"m{m.index}", m.registry)
            for m in self.members if m.registry is not None
        ]

    def _obs_members(self) -> list:
        """The SLO and profiler view: (index, label, registry, alive)."""
        return [
            (m.index, f"m{m.index}", m.registry, m.alive)
            for m in self.members
        ]

    def fleetstats_path(self) -> str:
        return os.path.join(self.journal.dir, FLEETSTATS_FILE)

    def slo_alerts_by_member(self) -> dict:
        """Active SLO alerts by attributed member: the supervisor's
        advisory input (empty with the plane off)."""
        with self.lock:
            if self.slo is None:
                return {}
            return self.slo.alerts_by_member()

    def obs_tick(self) -> None:
        """One pass of the observability plane at quantum cadence:
        evaluate the SLOs' burn rates (a new alert arms the profiler's
        capture), sample each member's utilization, and write the merged
        picture to FLEETSTATS.json. No-op with PUMI_TPU_FLEET_OBS=off."""
        with self.lock:
            if not self.obs_enabled:
                return
            members = self._obs_members()
            alerts = self.slo.evaluate(members)
            for alert in list(alerts.values()):
                edge = (alert["slo"], alert["since"])
                if edge not in self._seen_alerts:
                    self._seen_alerts.add(edge)
                    self.profiler.on_alert(alert)
            self.profiler.sample(members)
            atomic_write_json(self.fleetstats_path(), {
                "schema": FLEETSTATS_SCHEMA,
                "fleet": self.fleet_json(),
                "slo": self.slo.status(),
                "profile": self.profiler.status(),
                "metrics": self.aggregator.merge(),
                "router_metrics": self.registry.snapshot(),
            })

    # ------------------------------------------------------------------ #
    # The scheduling loop
    # ------------------------------------------------------------------ #
    def step(self) -> bool:
        """One round over every alive member. An ``InjectedKill`` from a
        member's quantum is a member's death: with
        ``absorb_member_kills`` the router absorbs it and serves on;
        without, it propagates (the router's own crash)."""
        with self.lock:
            pending = False
            for member in list(self.members):
                if not member.alive:
                    continue
                if member.scheduler.wedged:
                    # A wedged member holds its jobs and makes no
                    # progress: the fleet is not drained until the
                    # supervisor evicts it.
                    pending = True
                    continue
                try:
                    pending = member.scheduler.step() or pending
                except InjectedKill:
                    if not self.absorb_member_kills:
                        raise
                    self._absorb_death(member, reason="injected-kill")
                    pending = True
            self._update_gauges()
            self.obs_tick()
            return pending

    def run(self, max_rounds: int = 100000) -> None:
        for _ in range(max_rounds):
            if not self.step():
                return
        raise RuntimeError(
            f"fleet did not drain within {max_rounds} rounds"
        )

    def backpressured(self) -> bool:
        """True when no member would admit a new job now: none is alive,
        or every alive member that is not quarantined (any alive member
        when all are) is at its queue bound. The gateway answers 503 with
        Retry-After before anything is journaled."""
        with self.lock:
            candidates = [
                m for m in self.members
                if m.alive and not m.quarantined
            ]
            if not candidates:
                candidates = [m for m in self.members if m.alive]
            if not candidates:
                return True
            return all(
                m.scheduler.max_queued is not None
                and m.scheduler.queue_depth >= m.scheduler.max_queued
                for m in candidates
            )

    # ------------------------------------------------------------------ #
    # Recovery
    # ------------------------------------------------------------------ #
    @classmethod
    def recover(cls, fleet_dir: str, mesh, config=None, **kwargs):
        """Rebuild a fleet over FLEET.json and the member journals: each
        member recovers its own job table (``TallyScheduler.recover``,
        checkpoint resumes bitwise), then the router reconciles the
        routing journal with what the members know, closing the crash
        windows the write-ahead order leaves open."""
        journal = FleetJournal(fleet_dir)
        doc = journal.load()
        if doc is None:
            raise ValueError(
                f"no fleet journal at {journal.path} — nothing to "
                "recover"
            )
        evicted = {
            int(k): dict(v)
            for k, v in doc.get("evicted", {}).items()
        }
        router = cls(
            mesh, config, fleet_dir=fleet_dir,
            n_members=int(doc["members"]), _recover=True,
            _evicted=tuple(sorted(evicted)), **kwargs,
        )
        try:
            with router.lock:
                router._accepted = {
                    str(k): str(v)
                    for k, v in doc.get("accepted", {}).items()
                }
                router._requests = dict(doc.get("requests", {}))
                router._assignments = {
                    k: {"member": int(v["member"]),
                        "migrations": int(v.get("migrations", 0))}
                    for k, v in doc.get("assignments", {}).items()
                }
                router._evicted = evicted
                router._breaches = {
                    int(k): [dict(b) for b in v]
                    for k, v in doc.get("breaches", {}).items()
                }
                router._n_submitted = int(doc.get("n_submitted", 0))
                router._reconcile()
        except BaseException:
            router.abandon()
            raise
        return router

    def _reconcile(self) -> None:
        """After recovery: drop the stale copies an interrupted migration
        left, replay interrupted drains, and dispatch every accepted job
        no alive member knows."""
        # (i) A member's copy whose assignment names another member is
        # the stale half of an interrupted migration.
        for m in self.members:
            if not m.alive:
                continue
            for j in list(m.scheduler.jobs()):
                assignment = self._assignments.get(j.id)
                if assignment is None:
                    # A job the router never recorded cannot happen
                    # under the write-ahead order; keep the member's
                    # view rather than orphan the work.
                    self._assignments[j.id] = {
                        "member": m.index, "migrations": 0,
                    }
                elif assignment["member"] != m.index:
                    log_warn(
                        f"fleet recovery: dropping stale copy of "
                        f"{j.id} from member {m.index} (assigned to "
                        f"member {assignment['member']})"
                    )
                    m.scheduler.drop_job(j.id)
        # (ii) A journaled eviction whose drain the crash interrupted:
        # replay it from the evicted member's journal. Jobs already
        # moved carry assignments naming their new owner and are
        # skipped (eviction-record-before-drain's recovery half).
        for idx in sorted(self._evicted):
            if idx < len(self.members) and not self.members[idx].alive:
                self._replace_from_disk(idx, link="evicted")
        # (iii) Accepted jobs nobody knows: the crash fell between the
        # acceptance or assignment record and the dispatch; the
        # journaled request replays it.
        owned = {
            j.id for m in self.members if m.alive
            for j in m.scheduler.jobs()
        }
        for jid in sorted(set(self._assignments) | set(self._requests)):
            if jid in owned:
                self._requests.pop(jid, None)
                continue
            req_json = self._requests.get(jid)
            if req_json is None:  # pragma: no cover - defensive
                log_warn(
                    f"fleet recovery: {jid} assigned but neither "
                    "dispatched nor journaled as a request — lost to "
                    "a pre-journal crash window that should not exist"
                )
                continue
            self._pending[jid] = request_from_json(req_json)
            assignment = self._assignments.get(jid)
            n = np.asarray(req_json["origins"]).reshape(-1, 3).shape[0]
            self._place(
                jid, self._shape_key(n),
                member=(
                    assignment["member"]
                    if assignment is not None
                    and self.members[assignment["member"]].alive
                    else None
                ),
            )
        self._flush_fleet()
        log_info(
            f"fleet recovery: {len(self.members)} members, "
            f"{len(owned)} jobs owned, "
            f"{len(self._accepted)} idempotency keys restored"
        )

    # ------------------------------------------------------------------ #
    # Introspection (the gateway's and the exporter's surfaces)
    # ------------------------------------------------------------------ #
    def owner_of(self, job_id: str) -> FleetMember | None:
        assignment = self._assignments.get(job_id)
        if assignment is None:
            return None
        member = self.members[assignment["member"]]
        return member if member.alive else None

    def job(self, job_id: str):
        with self.lock:
            member = self.owner_of(job_id)
            if member is None:
                raise KeyError(job_id)
            return member.scheduler.job(job_id)

    def jobs(self) -> list:
        with self.lock:
            return [
                j for m in self.members if m.alive
                for j in m.scheduler.jobs()
            ]

    def result(self, job_id: str) -> np.ndarray:
        with self.lock:
            member = self.owner_of(job_id)
            if member is None:
                raise KeyError(job_id)
            return member.scheduler.result(job_id)

    def cancel(self, job_id: str) -> bool:
        with self.lock:
            member = self.owner_of(job_id)
            if member is None:
                raise KeyError(job_id)
            return member.scheduler.cancel(job_id)

    def member_of(self, job_id: str) -> int | None:
        with self.lock:
            assignment = self._assignments.get(job_id)
            return None if assignment is None else assignment["member"]

    def progress(self, job_id: str,
                 since: int = -1) -> tuple[list[dict], bool]:
        """One job's flight records with seq > ``since`` (the shared
        recorder spans every member, so a migrated job's progress is one
        stream) and whether it has ended: the gateway's stream polls
        this."""
        with self.lock:
            member = self.owner_of(job_id)
            if member is None:
                raise KeyError(job_id)
            records = [
                r for r in self.recorder.records()
                if r.get("job") == job_id and r.get("seq", -1) > since
            ]
            return records, member.scheduler.job(job_id).terminal

    def _update_gauges(self) -> None:
        self._members_gauge.set(
            sum(1 for m in self.members if m.alive)
        )
        for m in self.members:
            self._fleet_queue_depth.set(
                m.scheduler.queue_depth if m.alive else 0,
                member=f"m{m.index}",
            )

    def _jobs_json(self, query: dict | None = None) -> dict:
        """The exporter's ``/jobs``: every alive member's rows with the
        owning member, at most ``?limit=`` rows (default 500), newest
        first, as the single scheduler's table."""
        limit = _jobs_limit(query)
        with self.lock:
            rows = []
            total = 0
            for m in self.members:
                if not m.alive:
                    continue
                table = m.scheduler._jobs_json({"limit": limit})
                total += table["total_jobs"]
                for row in table["jobs"]:
                    rows.append(dict(row, member=m.index))
            # Newest first across members by the member's submission
            # ordinal, ids breaking ties.
            rows.sort(
                key=lambda r: (r["index"], r["id"]), reverse=True
            )
            return {
                "schema": FLIGHT_SCHEMA,
                "queue_depth": sum(
                    m.scheduler.queue_depth
                    for m in self.members if m.alive
                ),
                "resident": sum(
                    m.scheduler.resident_count
                    for m in self.members if m.alive
                ),
                "total_jobs": total,
                "limit": limit,
                "jobs": rows[:limit],
            }

    def fleet_json(self) -> dict:
        """The ``/fleet`` endpoint: routing and liveness."""
        with self.lock:
            return {
                "schema": FLIGHT_SCHEMA,
                "members": [
                    {
                        "member": m.index,
                        "alive": m.alive,
                        "health": m.health,
                        "quarantined": m.quarantined,
                        "queue_depth": (
                            m.scheduler.queue_depth if m.alive else 0
                        ),
                        "resident": (
                            m.scheduler.resident_count
                            if m.alive else 0
                        ),
                        "placed": m.placed,
                        "jobs": (
                            len(m.scheduler.jobs()) if m.alive else 0
                        ),
                        "warm_classes": sorted(m.warm),
                        "journal": self.journal.member_dir(m.index),
                    }
                    for m in self.members
                ],
                "assignments": len(self._assignments),
                "accepted_keys": len(self._accepted),
                "migrations": int(self._migrations_total.value()),
            }

    def stats(self) -> dict:
        """The fleet's summary (the serving CLI's JSON), placements by
        member included."""
        with self.lock:
            all_jobs = [
                j for m in self.members if m.alive
                for j in m.scheduler.jobs()
            ]
            outcomes: dict[str, int] = {}
            for j in all_jobs:
                if j.outcome is not None:
                    outcomes[j.outcome] = outcomes.get(j.outcome, 0) + 1
            return {
                "members": len(self.members),
                "alive": sum(1 for m in self.members if m.alive),
                "jobs": len(all_jobs),
                "outcomes": outcomes,
                "queue_depth": sum(
                    m.scheduler.queue_depth
                    for m in self.members if m.alive
                ),
                "placements": {
                    f"member-{m.index}": m.placed for m in self.members
                },
                "migrations": int(self._migrations_total.value()),
                "retries": sum(j.retries for j in all_jobs),
                "recovered": sum(
                    m.scheduler._n_recovered
                    for m in self.members if m.alive
                ),
                "journal": self.journal.dir,
                "aot": (
                    self.bank.stats() if self.bank is not None else None
                ),
            }

    # ------------------------------------------------------------------ #
    # Teardown
    # ------------------------------------------------------------------ #
    def close(self) -> None:
        """Graceful shutdown: every alive member parks its residents and
        flushes its journal, then the routing journal commits last."""
        with self.lock:
            for m in self.members:
                if m.alive:
                    m.scheduler.close()
            self._flush_fleet()
            # The last fleet picture (any open capture closed) before
            # the exporter goes.
            if self.profiler is not None:
                self.profiler.stop_capture()
            self.obs_tick()
            if self._exporter is not None:
                self._exporter.stop()
                self._exporter = None

    def abandon(self) -> None:
        """Crash-model teardown: release every member's device state and
        write no journal; recovery works from what the journals already
        committed."""
        with self.lock:
            for m in self.members:
                if m.alive:
                    m.scheduler.abandon()
            if self.profiler is not None:
                self.profiler.stop_capture()
            if self._exporter is not None:
                self._exporter.stop()
                self._exporter = None
