"""Shape-bucketed multi-tenant scheduler: many tally jobs over one card.

Counterpart of ``pumiumtally_tpu/serving/scheduler.py``, with the same
constructor, job lifecycle, journal, metrics and spans:

  * Requests are padded onto the tuning ladder (``tuning/shapes.py``'s
    power-of-two ``bucket``) and queued by shape class. Pad lanes sit at
    the request's first origin with zero weight and ``alive=False``.
  * Up to ``max_resident`` jobs are resident at once (a ``PumiTally``
    each: lanes and flux on the card). Admission takes one job a class
    in turn, so one busy class cannot starve the others.
  * The card is time-sliced by quantum: each round gives every resident
    job one ``run_source_moves`` call of up to ``quantum_moves`` moves
    (the job's ``TallyConfig.megastep`` is the quantum, so a quantum is
    one chunk), the fairness grain and the preemption boundary.
  * A job ends when its moves ran or every lane died (``completed``), or
    early at its requested precision with ``TallyConfig(convergence=
    True)`` (``converged``).
  * Preemption: when jobs queue and a resident job held its slot for
    ``preempt_after`` quanta, it is checkpointed to disk, its tally
    closed, and it re-queues; re-admitted it restores and continues bit
    for bit (the random stream is keyed by the restored move counter).

Failure isolation: every failed quantum is classified through
``resilience/coordinator.py``. A ``transient`` verdict (an injected
transient, a device error or a watchdog timeout with the card still
answering its probe) replays the quantum bit for bit from the job's own
pre-quantum ``snapshot_state``, with bounded exponential backoff,
counted in ``pumi_job_retries_total{cause}``; a ``persistent`` verdict
(a fatal integrity violation, an injected poison job) or a spent retry
budget poisons that job only (``outcome="poisoned"``, its slot freed)
and every other job continues bit for bit. ``max_queued`` rejects a
submission beyond it (``outcome="rejected"``); ``quantum_deadline_s``
arms the facades' dispatch watchdog (``move_deadline_s``).

The journal (``journal_dir``, ``serving/journal.py``): the job table in
``JOBS.json``, flushed after every transition, each resident job's
checkpoint written at its quantum boundary before the flush that names
it, a SIGTERM/SIGINT flush (``utils/signals.py``), and
``TallyScheduler.recover(journal_dir)``, which re-queues interrupted
jobs from their checkpoints; finished fluxes persist beside it.

Observability: ``pumi_jobs_total{outcome}``, ``pumi_queue_depth``,
``pumi_preemptions_total``, ``pumi_quanta_total``,
``pumi_job_retries_total{cause}``, ``pumi_job_queue_seconds``,
``pumi_jobs_recovered_total{source}``, ``pumi_job_device_seconds`` (the
wall around each quantum's blocked ``run_source_moves``, whose tail copy
waits for the card), ``pumi_quantum_wall_seconds_total``, the SLO
histograms ``pumi_job_e2e_seconds`` and
``pumi_job_time_to_first_quantum_seconds``, and the bank's
``pumi_aot_*`` on one registry; per-job flight records (schema
``FLIGHT_SCHEMA``); and one span tracer (``obs/trace.py``): ``submit`` →
``queued`` → ``admit`` → a ``quantum`` span a quantum (``retry`` events
under it) → ``preempted`` / ``recovered`` → the terminal ``job`` root
span, the bank's and the coordinator's spans bound into the same trace.
The journal keeps each job's ``trace_id``, so a recovered job continues
its trace; spans stream to ``<journal_dir>/TRACE.jsonl``. The tracer's
ring is dumped as a black box on poison, on the signal flush and at
close. With ``PUMI_TPU_PROM_PORT`` set the exporter serves ``/metrics``,
``/jobs`` and ``/trace``. Tracing wraps host control flow only: served
fluxes are bitwise equal with ``PUMI_TPU_TRACE=off``.

The scheduler runs on the card unless ``device="cpu"`` is passed (the
mesh must live on the same device).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
import types

import numpy as np

from ..integrity.watchdog import DispatchTimeoutError
from ..obs import (
    FLIGHT_SCHEMA,
    FlightRecorder,
    MetricsRegistry,
    SpanTracer,
    maybe_start_exporter,
)
from ..resilience.coordinator import ResilienceCoordinator
from ..resilience.faultinject import FaultInjector, InjectedKill
from ..tuning.shapes import bucket, classify
from ..utils.checkpoint import (
    restore_state,
    snapshot_state,
    verify_checkpoint,
)
from ..utils.config import TallyConfig
from ..utils.log import log_info, log_warn
from ..utils.platform import resolve_device
from ..utils.signals import (
    install_preemption_handlers,
    resume_previous_handler,
    uninstall_preemption_handlers,
)
from .bank import ProgramBank
from .journal import (
    DISK_FULL_ERRNOS,
    SchedulerJournal,
    check_job_id,
    request_from_json,
    request_to_json,
)

# Job lifecycle: queued -> resident -> (preempted -> queued ->)* -> done
QUEUED, RESIDENT, PREEMPTED, DONE = (
    "queued", "resident", "preempted", "done",
)

# /jobs scrape cap: rows returned by the exporter's job table unless
# the scrape overrides with ?limit= (newest rows first).
JOBS_JSON_LIMIT = 500


def _jobs_limit(query: dict | None) -> int:
    """Resolve ``?limit=`` from a parsed query dict; malformed values
    fall back to the default rather than 500-ing a scrape."""
    try:
        limit = int((query or {}).get("limit", JOBS_JSON_LIMIT))
    except (TypeError, ValueError):
        return JOBS_JSON_LIMIT
    return max(0, limit)


@dataclasses.dataclass
class JobRequest:
    """One tally job: walk ``n_moves`` device-sourced moves for the
    given source particles and return the raw flux.  ``origins`` is
    [n, 3] float64 (host order); ``weights``/``groups`` default to
    ones/zeros.  ``source`` is an ``ops.source.SourceParams`` (its
    ``seed`` keys the job's RNG stream)."""

    origins: np.ndarray
    n_moves: int
    source: object | None = None
    weights: np.ndarray | None = None
    groups: np.ndarray | None = None
    job_id: str | None = None
    #: Caller-supplied trace identity: the job joins this trace instead
    #: of minting one, so a client can follow its job end to end.
    trace_id: str | None = None


class Job:
    """Scheduler-internal job state."""

    def __init__(self, job_id: str, request: JobRequest, n: int,
                 padded_n: int, shape_key: str, index: int = 0):
        self.id = job_id
        self.index = index         # submission ordinal (fault targeting)
        self.request = request
        self.n = n
        self.padded_n = padded_n
        self.shape_key = shape_key
        self.state = QUEUED
        self.outcome: str | None = None
        self.error: str | None = None
        self.tally = None
        self.moves_done = 0
        self.quanta = 0            # quanta run since last admission
        self.preemptions = 0
        self.retries = 0           # transient quanta replayed
        self.recovery_seconds = 0.0
        self.needs_stage = True    # first quantum stages the lanes
        self.checkpoint: str | None = None
        #: The move counter the checkpoint file holds, when this process
        #: wrote it at a quantum boundary (None: not known).
        self.checkpoint_moves: int | None = None
        self.result: np.ndarray | None = None
        self.flux_name: str | None = None   # journal-relative, if any
        self.request_json: dict | None = None  # serialized-once cache
        self.totals: dict = collections.defaultdict(float)
        self.submitted_s = time.perf_counter()
        self.enqueued_s = self.submitted_s
        self.finished_s: float | None = None
        # Trace identity and device-time attribution (obs/trace.py;
        # persisted in the schema-2 journal so both survive a server
        # crash). A caller-supplied request trace id is joined.
        self.trace_id: str = request.trace_id or SpanTracer.new_trace()
        self.device_seconds = 0.0  # wall around blocked dispatches
        self.first_dispatch_s: float | None = None

    @property
    def terminal(self) -> bool:
        return self.state == DONE


@contextlib.contextmanager
def _quiet_exporter():
    """Suppress the per-tally Prometheus endpoint while the scheduler
    constructs job facades — the SCHEDULER's registry owns the scrape
    port; dozens of short-lived job tallies racing to bind it would
    only warn-spam."""
    prev = os.environ.pop("PUMI_TPU_PROM_PORT", None)
    try:
        yield
    finally:
        if prev is not None:
            os.environ["PUMI_TPU_PROM_PORT"] = prev


class TallyScheduler:
    """Multi-tenant quantum scheduler over one mesh on one device.

    Args:
      mesh: the served TetMesh (on ``device``, shared by every job).
      config: per-job TallyConfig template.  ``megastep`` is overridden
        by the resolved quantum so facade chunking and scheduler
        quanta coincide (a preemption boundary is always a megastep
        boundary).
      bank: a ProgramBank, a bank root path (constructed with the
        scheduler's registry), or None (each job's facade loads the
        package's own build of the kernel libraries).
      max_resident: resident-job cap (device memory bound: each
        resident job holds padded lanes + one flux accumulator).
      quantum_moves: fused moves per scheduling quantum (default: the
        config/env/tuning-resolved megastep K).
      preempt_after: quanta a resident job may hold its slot while
        other jobs queue before it is checkpoint-preempted (None: run
        to completion).
      checkpoint_dir: where preemption checkpoints live (required when
        ``preempt_after`` is set and no journal_dir is given — a
        journaled scheduler preempts into its journal directory).
      max_queued: admission backpressure — a submission arriving with
        this many jobs already waiting is finished
        ``outcome="rejected"`` instead of queued (None: unbounded).
      job_retries: bounded per-quantum replay budget for transient
        failures (0 disables snapshots and retries — any dispatch
        failure poisons the job).
      quantum_deadline_s: per-quantum dispatch watchdog deadline
        (integrity/watchdog.py via the job configs' move_deadline_s);
        a timeout is classified like any transient.
      journal_dir: the JOBS.json write-ahead journal directory
        (serving/journal.py); enables ``recover`` and the
        SIGTERM/SIGINT flush.
      blackbox_dir: where crash-postmortem black boxes land
        (``<tag>.blackbox.json`` — the tracer ring dumped atomically
        on poison, on the signal flush, and at close).  Defaults to
        the journal directory; None without a journal disables dumps.
      faults: the scheduler-level FaultInjector driving the per-job
        fault hooks (poison_job / transient_quantum /
        kill_server_at_quantum) and the per-member hooks
        (wedge_member / slow_member / disk_full_at); default: one
        built from PUMI_TPU_FAULTS.
      member_index: this scheduler's member index in a fleet, the
        identity the per-member fault hooks and metric labels key on;
        None for a standalone scheduler ("solo").
      device: where the jobs' tallies live (default: the CUDA card;
        pass "cpu" to run the plain PyTorch walk).
    """

    def __init__(
        self,
        mesh,
        config: TallyConfig | None = None,
        *,
        bank: ProgramBank | str | None = None,
        max_resident: int = 2,
        quantum_moves: int | None = None,
        preempt_after: int | None = None,
        checkpoint_dir: str | None = None,
        max_queued: int | None = None,
        job_retries: int = 2,
        backoff_base: float = 0.05,
        backoff_max: float = 2.0,
        quantum_deadline_s: float | None = None,
        journal_dir: str | None = None,
        blackbox_dir: str | None = None,
        faults: FaultInjector | None = None,
        member_index: int | None = None,
        handle_signals: bool = True,
        registry: MetricsRegistry | None = None,
        tracer: SpanTracer | None = None,
        recorder: FlightRecorder | None = None,
        sleep=time.sleep,
        device=None,
    ):
        self.device = resolve_device(device)
        if mesh.device != self.device:
            raise ValueError(
                f"mesh is on {mesh.device}, the scheduler on {self.device}"
            )
        self.mesh = mesh
        base = config or TallyConfig()
        self.quantum = int(
            quantum_moves
            if quantum_moves is not None
            else base.resolve_megastep()
        )
        if self.quantum < 1:
            raise ValueError(f"quantum_moves must be >= 1: {self.quantum}")
        # Facade chunking == scheduler quantum: run_source_moves(k)
        # with megastep=quantum runs one chunk per quantum, and a job
        # interleaved with others chains bit for bit like the same
        # chunks run back to back.
        self.config = dataclasses.replace(base, megastep=self.quantum)
        if quantum_deadline_s is not None:
            self.config = dataclasses.replace(
                self.config, move_deadline_s=float(quantum_deadline_s)
            )
        self.max_resident = int(max_resident)
        if self.max_resident < 1:
            raise ValueError(
                f"max_resident must be >= 1: {self.max_resident}"
            )
        self.max_queued = None if max_queued is None else int(max_queued)
        if self.max_queued is not None and self.max_queued < 1:
            raise ValueError(
                f"max_queued must be >= 1: {self.max_queued}"
            )
        self.job_retries = int(job_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self._sleep = sleep
        self.faults = faults if faults is not None else FaultInjector()
        self.member_index = (
            None if member_index is None else int(member_index)
        )
        self.journal = (
            SchedulerJournal(journal_dir)
            if journal_dir is not None else None
        )
        # Per-quantum wall seconds (successful quanta only): the
        # window a fleet's brownout check compares across members.
        self.recent_quantum_seconds: collections.deque = (
            collections.deque(maxlen=64)
        )
        self.preempt_after = preempt_after
        self.checkpoint_dir = checkpoint_dir
        if (
            preempt_after is not None
            and checkpoint_dir is None
            and self.journal is None
        ):
            raise ValueError(
                "preempt_after needs checkpoint_dir or journal_dir "
                "(preemption persists job state through the "
                "checkpoint subsystem)"
            )
        if checkpoint_dir is not None:
            # Fail at construction, not at the first mid-run
            # preemption (the atomic checkpoint writer mkstemps into
            # this directory and does not create it).
            os.makedirs(checkpoint_dir, exist_ok=True)
        self.registry = (
            registry if registry is not None else MetricsRegistry()
        )
        self.recorder = (
            recorder if recorder is not None
            else FlightRecorder(schema=FLIGHT_SCHEMA)
        )
        # One tracer for the whole serving path (scheduler + bank +
        # coordinator share it via the ambient binding); journaled
        # schedulers stream spans to <journal_dir>/TRACE.jsonl so both
        # process lifetimes of a crashed server append to one stream.
        # Several schedulers may share one tracer and recorder.
        self.tracer = tracer if tracer is not None else SpanTracer(
            sink=(
                self.journal.trace_path()
                if self.journal is not None else None
            ),
        )
        self.blackbox_dir = (
            blackbox_dir if blackbox_dir is not None
            else (self.journal.dir if self.journal is not None else None)
        )
        if self.blackbox_dir is not None:
            os.makedirs(self.blackbox_dir, exist_ok=True)
        if isinstance(bank, str):
            bank = ProgramBank(
                bank, registry=self.registry, recorder=self.recorder,
                tracer=self.tracer,
            )
        self.bank = bank
        r = self.registry
        self._jobs_total = r.counter(
            "pumi_jobs_total",
            "served tally jobs by outcome (completed: move budget "
            "exhausted or all particles terminated; converged: "
            "evicted early at the requested precision; poisoned: "
            "isolated after a persistent per-job failure or an "
            "exhausted retry budget; rejected: admission "
            "backpressure at max_queued; cancelled: terminated by "
            "an explicit cancel request)",
        )
        self._queue_depth = r.gauge(
            "pumi_queue_depth",
            "jobs waiting for a resident slot (preempted jobs "
            "re-queue and count)",
        )
        self._preempt_total = r.counter(
            "pumi_preemptions_total",
            "resident jobs checkpoint-preempted to admit queued work",
        )
        self._quanta_total = r.counter(
            "pumi_quanta_total",
            "scheduling quanta executed (one megastep-K dispatch "
            "window per resident job per round)",
        )
        self._job_seconds = r.histogram(
            "pumi_job_seconds",
            "wall seconds from job submission to completion",
        )
        self._retries_total = r.counter(
            "pumi_job_retries_total",
            "per-job quantum replays after a transient-classified "
            "dispatch failure (labeled by cause: transient, timeout)",
        )
        self._queue_seconds = r.histogram(
            "pumi_job_queue_seconds",
            "wall seconds a job waited in the admission queue before "
            "each (re)admission to a device slot",
        )
        self._recovered_total = r.counter(
            "pumi_jobs_recovered_total",
            "jobs re-queued from the JOBS.json journal at recovery "
            "(labeled by source: checkpoint = resumed mid-run, "
            "scratch = request replayed from move 0, migrated = "
            "adopted from another fleet member's journal, evicted = "
            "adopted from a member the supervisor drained)",
        )
        self._device_seconds = r.counter(
            "pumi_job_device_seconds",
            "wall seconds spent inside blocked quantum dispatches "
            "(labeled by fleet member — per-JOB attribution lives on "
            "Job.device_seconds and the /jobs rows; a per-job-id "
            "label here would grow the family without bound)",
        )
        self._quantum_wall_seconds = r.counter(
            "pumi_quantum_wall_seconds_total",
            "cumulative wall seconds inside scheduling quanta "
            "(device dispatch + host overhead + retries + injected "
            "latency), labeled by fleet member — the fleet profiler's "
            "dispatch-wait breakdown reads device vs quantum wall",
        )
        self._e2e_seconds = r.histogram(
            "pumi_job_e2e_seconds",
            "SLO: wall seconds from submission to terminal state "
            "(completed/converged/poisoned/rejected)",
        )
        self._ttfq_seconds = r.histogram(
            "pumi_job_time_to_first_quantum_seconds",
            "SLO: wall seconds from submission to the first quantum "
            "dispatch (queue wait + admission + staging)",
        )
        self._journal_degraded_gauge = r.gauge(
            "pumi_journal_degraded",
            "1 while this scheduler's journal is in disk-pressure "
            "degraded mode (ENOSPC-class durable-write failure — "
            "flushes frozen, residents parked; serving/journal.py "
            "'Degraded mode'), labeled by fleet member",
        )
        self._journal_degraded_gauge.set(
            0.0, member=self._member_label()
        )
        if self.journal is not None:
            # Resolve the injector at gate time (a caller may swap
            # ``self.faults`` mid-run) and surface the degraded
            # transition through this scheduler's metrics/recorder.
            self.journal.faults = lambda: self.faults
            self.journal.on_degraded = self._on_journal_degraded
        # The failure taxonomy, shared with ResilientRunner: one
        # coordinator on the scheduler's registry, rebound to the
        # failing job's facade at classification time.
        self._coordinator = ResilienceCoordinator(
            self._server_view(), faults=self.faults, tracer=self.tracer,
        )
        # Per-class FIFO queues + a rotation pointer: admission takes
        # one job per class in turn, so a burst in one shape bucket
        # cannot starve the others.
        self._queues: dict[str, collections.deque] = {}
        self._class_order: list[str] = []
        self._next_class = 0
        self._resident: list[Job] = []
        self._jobs: dict[str, Job] = {}
        self._n_submitted = 0
        self._n_quanta = 0          # lifetime quanta (fault targeting)
        self._n_recovered = 0
        self._in_step = False
        self._pending_signal: int | None = None
        self._prev_handlers: dict = {}
        if self.journal is not None and handle_signals:
            self._install_signal_handlers()
        self._exporter = maybe_start_exporter(
            self.registry,
            endpoints={
                "/jobs": self._jobs_json,
                "/trace": self.tracer.chrome,
            },
        )

    def _member_label(self) -> str:
        return (
            "solo" if self.member_index is None
            else f"m{self.member_index}"
        )

    def _on_journal_degraded(self, op: str, exc: OSError) -> None:
        """Journal's degraded-mode transition callback: hang the gauge
        and a flight record off the first ENOSPC-class failure."""
        self._journal_degraded_gauge.set(
            1.0, member=self._member_label()
        )
        self.recorder.record(
            "journal_degraded", member=self._member_label(),
            op=op, error=str(exc)[:200],
        )

    def _server_view(self):
        """What the coordinator needs of a tally, for the server itself
        (its registry and device)."""
        return types.SimpleNamespace(metrics=self.registry,
                                     device=self.device)

    # -- health probes ------------------------------------------------- #
    @property
    def wedged(self) -> bool:
        """True while the ``wedge_member`` fault holds this member: it
        answers no probe and makes no progress, but keeps its jobs and
        device state (the silent-wedge failure mode)."""
        return self.faults.member_wedged(self.member_index)

    def heartbeat(self) -> bool:
        """One liveness probe: False when this member is wedged, else
        the per-chip health probe verdict (every device of the served
        device answers a round trip — resilience/coordinator.py)."""
        if self.wedged:
            return False
        return all(self._coordinator.probe_chips().values())

    # ------------------------------------------------------------------ #
    # Submission
    # ------------------------------------------------------------------ #
    def submit(self, request: JobRequest, *,
               request_json: dict | None = None) -> str:
        """Enqueue one job; returns its id.  The job is padded onto the
        shape ladder here — its bucket decides which queue it joins
        and which bank entries will serve it. ``request_json`` is the
        request's journal form when the caller made it already (a fleet
        router: both journals then share its text)."""
        origins = np.asarray(request.origins, np.float64).reshape(-1, 3)
        n = origins.shape[0]
        if n < 1:
            raise ValueError("a job needs at least one particle")
        if request.n_moves < 1:
            raise ValueError(f"n_moves must be >= 1: {request.n_moves}")
        for name, arr in (
            ("weights", request.weights), ("groups", request.groups),
        ):
            if arr is not None and np.asarray(arr).reshape(-1).size != n:
                # A silent [:n] truncation would scale the flux by the
                # wrong source weights — reject the mismatch up front.
                raise ValueError(
                    f"{name} has {np.asarray(arr).reshape(-1).size} "
                    f"entries for {n} particles — per-lane arrays must "
                    "match the request's UNPADDED particle count"
                )
        padded_n = bucket(n)
        cfg = self.config
        shape = classify(
            self.mesh.ntet, padded_n, cfg.n_groups, cfg.dtype,
            getattr(self.mesh, "geo20", None) is not None,
        )
        job_id = request.job_id or f"job-{self._n_submitted:05d}"
        if job_id in self._jobs:
            raise ValueError(f"duplicate job id {job_id!r}")
        # The id becomes filenames (journal sidefiles AND the
        # preemption checkpoint path) — refuse path tricks up front,
        # journaled or not.
        check_job_id(job_id)
        # Serialize the (immutable) request ONCE; every journal flush
        # reuses the dict instead of re-walking the float64 payload.
        if self.journal is None:
            request_json = None
        elif request_json is None:
            request_json = request_to_json(request)
        job = Job(
            job_id, request, n, padded_n, shape.key(),
            index=self._n_submitted,
        )
        job.request_json = request_json
        self._n_submitted += 1
        self._jobs[job_id] = job
        # The trace starts at submission for EVERY outcome — a
        # rejected job's (short) trace still reads submit → job.
        self.tracer.event(
            "submit", trace_id=job.trace_id,
            parent=SpanTracer.root_id(job.trace_id), job_id=job_id,
            shape_key=job.shape_key, n=n, padded_n=padded_n,
            n_moves=int(request.n_moves),
        )
        if (
            self.max_queued is not None
            and self.queue_depth >= self.max_queued
        ):
            # Named backpressure: the job is terminal on arrival — the
            # caller sees outcome="rejected" instead of an unbounded
            # queue absorbing work the server cannot promise to run.
            job.state = DONE
            job.outcome = "rejected"
            job.finished_s = time.perf_counter()
            self._jobs_total.inc(outcome="rejected")
            self._job_seconds.observe(job.finished_s - job.submitted_s)
            self.recorder.record(
                "job_rejected", job=job_id, job_id=job_id,
                shape_key=job.shape_key,
                queue_depth=self.queue_depth,
                max_queued=self.max_queued,
            )
            self._trace_terminal(
                job, "rejected", queue_depth=self.queue_depth
            )
            self._flush_journal()
            return job_id
        self._enqueue(job)
        self.recorder.record(
            "job_submitted", job=job_id, job_id=job_id,
            shape_key=job.shape_key,
            n=n, padded_n=padded_n, n_moves=int(request.n_moves),
        )
        self._flush_journal()
        return job_id

    def _enqueue(self, job: Job) -> None:
        q = self._queues.get(job.shape_key)
        if q is None:
            q = self._queues[job.shape_key] = collections.deque()
            self._class_order.append(job.shape_key)
        q.append(job)
        job.state = QUEUED if job.checkpoint is None else PREEMPTED
        job.enqueued_s = time.perf_counter()
        self._queue_depth.set(self.queue_depth)

    @property
    def queue_depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def resident_count(self) -> int:
        return len(self._resident)

    def _pop_next(self) -> Job | None:
        """Round-robin across shape-class queues."""
        if not self._class_order:
            return None
        for _ in range(len(self._class_order)):
            key = self._class_order[
                self._next_class % len(self._class_order)
            ]
            self._next_class += 1
            q = self._queues[key]
            if q:
                return q.popleft()
        return None

    # ------------------------------------------------------------------ #
    # Crash-safe journal + recovery
    # ------------------------------------------------------------------ #
    def _journal_entry(self, job: Job) -> dict:
        done = job.state == DONE
        if job.request_json is None:
            job.request_json = request_to_json(job.request)
        return {
            "id": job.id,
            "index": job.index,
            "state": "done" if done else "pending",
            "outcome": job.outcome,
            "error": job.error,
            "shape_key": job.shape_key,
            "n": job.n,
            "padded_n": job.padded_n,
            "moves_done": job.moves_done,
            "preemptions": job.preemptions,
            "retries": job.retries,
            # Terminal records never reference a checkpoint: the side
            # file is deleted AFTER the flush that marks the job done
            # (write-ahead order — a crash between the two must not
            # leave a record pointing at a removed file).
            "checkpoint": (
                os.path.basename(job.checkpoint)
                if job.checkpoint is not None and not done else None
            ),
            "flux": job.flux_name,
            # Schema-2 trace fields: the id lets the NEXT process
            # continue this job's distributed trace after a crash.
            "trace_id": job.trace_id,
            "device_seconds": round(job.device_seconds, 6),
            "request": job.request_json,
        }

    def _flush_journal(self) -> None:
        if self.journal is None:
            return
        self.journal.flush(
            [
                self._journal_entry(j)
                for j in sorted(
                    self._jobs.values(), key=lambda j: j.index
                )
            ],
            quantum_moves=self.quantum,
        )

    def _journal_checkpoint(self, job: Job) -> None:
        """Quantum-boundary checkpoint into the journal dir (written
        BEFORE the journal flush that references it — the write-ahead
        discipline serving/journal.py documents).  An ENOSPC-class
        failure degrades the journal instead of crashing the serving
        loop: the job keeps its previous checkpoint (if any), whose
        own move counter makes a later resume bitwise."""
        if self.journal is None or job.tally is None:
            return
        if self.journal.degraded:
            return
        path = self.journal.checkpoint_path(job.id)
        try:
            self.journal._gate_durable()
            job.tally.save_checkpoint(path)
        except OSError as exc:
            if exc.errno not in DISK_FULL_ERRNOS:
                raise
            self.journal.note_disk_failure("quantum checkpoint", exc)
            return
        job.checkpoint = path
        job.checkpoint_moves = job.moves_done

    @classmethod
    def recover(cls, journal_dir: str, mesh,
                config: TallyConfig | None = None, **kwargs):
        """Build a scheduler over an existing journal and re-queue
        every interrupted job: terminal jobs come back with their
        outcome (and their persisted flux, so results survive the
        process that computed them); pending jobs resume from their
        quantum-boundary checkpoint when it verifies — BITWISE, since
        the random stream is keyed by the restored move counter — or
        replay from move 0 when it does not (also bitwise: the whole
        trajectory re-runs).  Over a warm program bank the recovered
        process builds no library."""
        sched = cls(mesh, config, journal_dir=journal_dir, **kwargs)
        try:
            doc = sched.journal.load()
            if not doc:
                return sched
            for entry in sorted(
                doc.get("jobs", {}).values(), key=lambda e: e["index"]
            ):
                sched._recover_job(entry)
            sched._n_submitted = max(
                (j.index + 1 for j in sched._jobs.values()),
                default=sched._n_submitted,
            )
            sched.recorder.record(
                "journal_recovery", jobs=len(sched._jobs),
                recovered=sched._n_recovered,
                quantum_moves=doc.get("quantum_moves"),
            )
            log_info(
                f"scheduler recovery: {len(sched._jobs)} journaled "
                f"jobs, {sched._n_recovered} re-queued from "
                f"{journal_dir}"
            )
            sched._flush_journal()
        except BaseException:
            # Construction already installed the preemption handlers;
            # a failed recovery (unreadable journal, bad entry) must
            # not leak them — a stale handler would route the NEXT
            # signal into this dead half-recovered scheduler.  abandon
            # (not close): the journal on disk stays exactly as the
            # crashed process committed it, never rewritten with a
            # half-recovered table.
            sched.abandon()
            raise
        return sched

    def _recover_job(self, entry: dict) -> None:
        self._import_entry(entry, src_dir=None, link="recovered")

    def _copy_sidefile(self, src: str, dst: str) -> bool:
        """Copy one journal side file (checkpoint/flux) from another
        member's journal directory into this one — atomically, so a
        crash mid-migration never leaves a torn file under the real
        name.  Returns False when the source is missing."""
        if not os.path.exists(src):
            return False
        with open(src, "rb") as fh:
            data = fh.read()
        from ..utils.checkpoint import atomic_write_bytes

        atomic_write_bytes(dst, data)
        return True

    def _import_entry(self, entry: dict, *, src_dir: str | None,
                      link: str) -> Job:
        """Rebuild one journaled job in this scheduler.  ``link`` names
        the cross-lifetime trace event: ``recovered`` (same journal,
        new process), ``migrated`` (another member's journal — side
        files are copied in from ``src_dir`` first), or ``evicted``
        (same copy-in, but the hop was forced by the supervisor
        draining an unhealthy member)."""
        request = request_from_json(entry["request"])
        origins = np.asarray(request.origins, np.float64).reshape(-1, 3)
        n = origins.shape[0]
        padded_n = bucket(n)
        cfg = self.config
        shape_key = classify(
            self.mesh.ntet, padded_n, cfg.n_groups, cfg.dtype,
            getattr(self.mesh, "geo20", None) is not None,
        ).key()
        if entry["id"] in self._jobs:
            raise ValueError(
                f"duplicate job id {entry['id']!r} (already owned by "
                "this scheduler)"
            )
        job = Job(
            entry["id"], request, n, padded_n, shape_key,
            index=int(entry["index"]),
        )
        job.request_json = entry["request"]
        job.preemptions = int(entry.get("preemptions", 0))
        job.retries = int(entry.get("retries", 0))
        job.error = entry.get("error")
        # Continue the crashed process's trace: same trace_id, new
        # spans (schema-1 journals predate tracing — those jobs start
        # a fresh trace here).  Device-time attribution accumulates
        # across lifetimes.
        if entry.get("trace_id"):
            job.trace_id = str(entry["trace_id"])
        job.device_seconds = float(entry.get("device_seconds", 0.0))
        self._jobs[job.id] = job
        if entry["state"] == "done":
            job.state = DONE
            job.outcome = entry.get("outcome")
            job.moves_done = int(entry.get("moves_done", 0))
            job.finished_s = job.submitted_s
            if entry.get("flux"):
                if src_dir is not None:
                    self._copy_sidefile(
                        os.path.join(src_dir, entry["flux"]),
                        self.journal.flux_path(job.id),
                    )
                job.result = self.journal.load_flux(job.id)
                job.flux_name = entry["flux"]
            return job
        source = "scratch"
        if entry.get("checkpoint"):
            ck = self.journal.checkpoint_path(job.id)
            if src_dir is not None:
                self._copy_sidefile(
                    os.path.join(src_dir, entry["checkpoint"]), ck
                )
            try:
                verify_checkpoint(ck)
                job.checkpoint = ck
                job.moves_done = int(entry.get("moves_done", 0))
                source = "checkpoint"
            except Exception as e:
                # Torn/corrupt/missing checkpoint: the request is
                # still intact in the journal — replay from move 0
                # (bitwise: the whole stream re-runs on the same
                # counter keys) instead of losing the job.
                log_warn(
                    f"scheduler recovery: checkpoint for {job.id} "
                    f"unusable ({e}); replaying from move 0"
                )
        self._enqueue(job)
        self._n_recovered += 1
        self._recovered_total.inc(
            source=link if link in ("migrated", "evicted") else source
        )
        # The explicit cross-lifetime link: this span's pid (or, for a
        # migration, member) differs from the spans the previous owner
        # emitted, and both parent onto the same deterministic root id.
        self.tracer.event(
            link, trace_id=job.trace_id,
            parent=SpanTracer.root_id(job.trace_id), job_id=job.id,
            source=source, moves_done=job.moves_done,
        )
        self.recorder.record(
            "journal_recovered", job=job.id, job_id=job.id,
            shape_key=job.shape_key, link=link,
            source=source, moves_done=job.moves_done,
        )
        return job

    # ------------------------------------------------------------------ #
    # Cross-member migration primitives (serving/fleet.py)
    # ------------------------------------------------------------------ #
    def preempt_job(self, job_id: str) -> None:
        """Checkpoint-preempt one RESIDENT job at its megastep boundary
        (no-op for queued/preempted/terminal jobs) — the export half of
        a cross-chip migration."""
        job = self._jobs[job_id]
        if job.state == RESIDENT:
            self._preempt(job)

    def park_job(self, job_id: str) -> None:
        """Degraded-safe preempt of one RESIDENT job (no-op
        otherwise): checkpoint-preempt when the disk allows; under
        disk pressure, release the device slot WITHOUT a durable
        checkpoint.  The job then resumes from its previous
        quantum-boundary checkpoint if one exists on disk (its own
        move counter makes that bitwise), else replays from move 0
        (also bitwise — the whole stream re-runs).  The supervisor's
        disk-pressure drain and the scheduler's own degraded parking
        both route through here."""
        job = self._jobs[job_id]
        if job.state != RESIDENT:
            return
        if self.journal is None or not self.journal.degraded:
            try:
                self._preempt(job)
                return
            except OSError as exc:
                if exc.errno not in DISK_FULL_ERRNOS:
                    raise
                if self.journal is not None:
                    self.journal.note_disk_failure(
                        "preempt checkpoint", exc
                    )
        # Disk-pressure fallback: free the slot, keep (at most) the
        # last durable checkpoint as the resume point.
        if job.tally is not None:
            try:
                job.tally.close()
            except Exception:  # pragma: no cover - teardown best-effort
                pass
            job.tally = None
        if job in self._resident:
            self._resident.remove(job)
        job.preemptions += 1
        if job.checkpoint is None or not os.path.exists(job.checkpoint):
            job.checkpoint = None
            job.moves_done = 0
            job.needs_stage = True
        self._preempt_total.inc()
        self.recorder.record(
            "job_parked", job=job.id, job_id=job.id,
            shape_key=job.shape_key, moves=job.moves_done,
            degraded=True,
        )
        self._enqueue(job)
        self._flush_journal()

    def _park_degraded(self) -> None:
        """Degraded-mode quantum boundary (satellite contract): park
        every resident so device memory is released and all state is
        journaled-or-replayable, then hold admission until a
        supervisor drains this member or an operator intervenes."""
        for job in list(self._resident):
            self.park_job(job.id)

    def export_entry(self, job_id: str) -> dict:
        """This job's journal entry — exactly what recovery would read;
        ``adopt_job`` on another member rebuilds the job from it."""
        return self._journal_entry(self._jobs[job_id])

    def adopt_job(self, entry: dict, *, src_dir: str | None = None,
                  link: str = "migrated") -> Job:
        """Adopt one job journaled by ANOTHER fleet member (cross-chip
        migration / dead-member re-placement / supervisor eviction):
        side files are copied from ``src_dir`` into this journal, a
        pending job re-queues from its checkpoint (bitwise — the move
        counter keys the RNG), a done job lands terminal with its
        persisted flux, and the trace continues across the hop with a
        ``migrated`` (or ``evicted``) link.  The adopted job is
        journaled here BEFORE the caller drops it from the source
        member (write-ahead: two journals briefly know the job; the
        fleet's assignment record names the owner)."""
        if self.journal is None:
            raise ValueError(
                "adopt_job needs a journaled scheduler (fleet members "
                "always journal)"
            )
        if link not in ("migrated", "evicted"):
            raise ValueError(
                f"adopt_job link must be 'migrated' or 'evicted': "
                f"{link!r}"
            )
        entry = dict(entry, index=self._n_submitted)
        job = self._import_entry(entry, src_dir=src_dir, link=link)
        self._n_submitted += 1
        self._flush_journal()
        return job

    def drop_job(self, job_id: str) -> None:
        """Forget one job after another member adopted it: remove it
        from the queue and the journal document, then its side files
        (record first, delete after — the same write-ahead edge as
        every terminal transition).  Resident jobs must be
        checkpoint-preempted (``preempt_job``) first."""
        job = self._jobs[job_id]
        if job.state == RESIDENT:
            raise ValueError(
                f"job {job_id} is resident — preempt_job() before "
                "drop_job()"
            )
        q = self._queues.get(job.shape_key)
        if q is not None and job in q:
            q.remove(job)
        del self._jobs[job_id]
        self._queue_depth.set(self.queue_depth)
        self._flush_journal()
        if self.journal is not None:
            self.journal.remove_sidefiles(job_id, flux=True)

    def cancel(self, job_id: str) -> bool:
        """Terminate one non-terminal job (outcome="cancelled"): free
        its slot or queue position and journal the terminal record
        before its checkpoint is removed.  Returns False when the job
        is already terminal (cancel is idempotent, never un-finishes
        work)."""
        job = self._jobs[job_id]
        if job.terminal:
            return False
        if job.tally is not None:
            try:
                job.tally.close()
            except Exception:  # pragma: no cover - teardown best-effort
                pass
            job.tally = None
        if job in self._resident:
            self._resident.remove(job)
        q = self._queues.get(job.shape_key)
        if q is not None and job in q:
            q.remove(job)
        job.state = DONE
        job.outcome = "cancelled"
        job.finished_s = time.perf_counter()
        self._jobs_total.inc(outcome="cancelled")
        self._job_seconds.observe(job.finished_s - job.submitted_s)
        self._queue_depth.set(self.queue_depth)
        self._trace_terminal(job, "cancelled")
        self.recorder.record(
            "job_cancelled", job=job_id, job_id=job_id,
            shape_key=job.shape_key, moves=job.moves_done,
        )
        self._flush_journal()
        self._remove_checkpoint(job)
        return True

    # ------------------------------------------------------------------ #
    # Preemption-signal flush (journaled schedulers only)
    # ------------------------------------------------------------------ #
    def _install_signal_handlers(self) -> None:
        self._prev_handlers = install_preemption_handlers(
            self._on_signal, "TallyScheduler"
        )

    def _uninstall_signal_handlers(self) -> None:
        uninstall_preemption_handlers(
            self._prev_handlers, mine=self._on_signal
        )
        self._prev_handlers = {}

    def _on_signal(self, signum, frame) -> None:
        if self._in_step:
            # Mid-quantum: defer to the quantum boundary so the
            # flushed checkpoints are consistent post-dispatch states.
            self._pending_signal = signum
            return
        self._signal_flush(signum, frame)

    def _signal_flush(self, signum, frame) -> None:
        """One final checkpoint of every resident job + a journal
        flush, then die the way the process would have without us —
        the next process's ``recover`` resumes every job."""
        for job in list(self._resident):
            try:
                self._journal_checkpoint(job)
            except Exception as e:  # pragma: no cover - best-effort
                log_warn(f"preemption checkpoint of {job.id} failed: {e}")
        try:
            self._flush_journal()
            log_info(
                f"scheduler preemption flush: journal written on "
                f"signal {signum}"
            )
        except Exception as e:  # pragma: no cover - flush best-effort
            log_warn(f"scheduler preemption flush failed: {e}")
        # Black box last (the journal is the recovery-critical write):
        # the tracer ring dumped atomically, lock-free — this path is
        # signal-handler-reachable, and the dump must not
        # block on a lock an interrupted appender still holds.
        self._blackbox("shutdown", reason=f"signal-{signum}")
        prev = self._prev_handlers.get(signum)
        self._uninstall_signal_handlers()
        resume_previous_handler(prev, signum, frame)

    # ------------------------------------------------------------------ #
    # Padding helpers
    # ------------------------------------------------------------------ #
    def _padded_inputs(self, job: Job):
        """Host arrays padded to the shape bucket: pad lanes sit at the
        first request position with zero weight and alive=False — they
        are initialized (parent-element search needs a valid position)
        but never walk, never score, and never sample."""
        req, n, N = job.request, job.n, job.padded_n
        origins = np.asarray(req.origins, np.float64).reshape(-1, 3)
        pad = np.broadcast_to(origins[0], (N - n, 3))
        origins_p = np.concatenate([origins, pad], axis=0)
        w = (
            np.ones(n) if req.weights is None
            else np.asarray(req.weights, np.float64).reshape(-1)[:n]
        )
        g = (
            np.zeros(n, np.int32) if req.groups is None
            else np.asarray(req.groups, np.int32).reshape(-1)[:n]
        )
        weights_p = np.concatenate([w, np.zeros(N - n)])
        groups_p = np.concatenate([g, np.zeros(N - n, np.int32)])
        alive_p = np.concatenate(
            [np.ones(n, bool), np.zeros(N - n, bool)]
        )
        return origins_p, weights_p, groups_p, alive_p

    # ------------------------------------------------------------------ #
    # Residency
    # ------------------------------------------------------------------ #
    def _admit(self, job: Job) -> bool:
        from ..api import PumiTally

        root = SpanTracer.root_id(job.trace_id)
        wait = time.perf_counter() - job.enqueued_s
        self._queue_seconds.observe(wait)
        # The queue wait as a closed span (it just ended), then the
        # admission itself with a PRE-allocated span id: the ambient
        # binding parents everything emitted during admission — the
        # bank's resolve/compile spans, the coordinator's
        # classify on failure — onto the admit span.
        self.tracer.span_record(
            "queued", wait, trace_id=job.trace_id, parent=root,
            job_id=job.id, preempted=job.checkpoint is not None,
        )
        aid = self.tracer.next_id()
        a0 = time.perf_counter()
        tally = None
        attrs: dict = {}
        try:
            with self.tracer.bind(job.trace_id, job.id, aid):
                try:
                    with _quiet_exporter():
                        tally = PumiTally(
                            self.mesh, job.padded_n, self.config,
                            program_bank=self.bank, device=self.device,
                        )
                    restored = False
                    if job.checkpoint is not None:
                        # Preempted/recovered job: restore the exact
                        # megastep boundary it was parked at — the move
                        # counter keys the RNG stream, so the
                        # continuation is bitwise the uninterrupted
                        # run.  An unusable checkpoint falls back to a
                        # from-scratch replay (also bitwise) instead of
                        # failing the job.
                        try:
                            tally.restore_checkpoint(job.checkpoint)
                            restored = True
                        except Exception as e:
                            log_warn(
                                f"checkpoint restore for {job.id} failed "
                                f"({e}); replaying from move 0"
                            )
                            job.checkpoint = None
                            job.moves_done = 0
                    if restored:
                        # The checkpoint's own counter is the truth — a
                        # journal written just before a crash may lag
                        # it by one quantum.
                        job.moves_done = int(tally.iter_count)
                        job.needs_stage = False
                    else:
                        origins_p, _, _, _ = self._padded_inputs(job)
                        tally.initialize_particle_location(
                            origins_p.reshape(-1).copy()
                        )
                        job.needs_stage = True
                except InjectedKill:
                    raise
                except Exception as e:
                    if tally is not None:
                        # Constructed but never handed to the job:
                        # release its device buffers before deciding
                        # the job's fate.
                        try:
                            tally.close()
                        except Exception:  # pragma: no cover - best-effort
                            pass
                    # Admission failures go through the SAME taxonomy
                    # as quantum failures: a transient verdict
                    # (retryable runtime error, timeout with healthy
                    # chips) re-queues the job against its bounded
                    # retry budget instead of permanently poisoning
                    # work one replay would have saved.
                    attrs["error"] = f"{type(e).__name__}: {e}"[:200]
                    self._coordinator.rebind(self._server_view())
                    verdict = self._coordinator.classify(e)
                    if (
                        verdict == "transient"
                        and job.retries < self.job_retries
                    ):
                        job.retries += 1
                        cause = (
                            "timeout"
                            if isinstance(e, DispatchTimeoutError)
                            else "transient"
                        )
                        self._retries_total.inc(cause=cause)
                        log_warn(
                            f"admission of {job.id} failed transiently "
                            f"({e}); re-queueing (attempt "
                            f"{job.retries}/{self.job_retries})"
                        )
                        self.tracer.event(
                            "retry", cause=cause, attempt=job.retries,
                            at="admission",
                        )
                        self.recorder.record(
                            "job_retry", job=job.id, job_id=job.id,
                            shape_key=job.shape_key,
                            cause=cause, attempt=job.retries,
                            at="admission", error=str(e)[:200],
                        )
                        self._sleep(min(
                            self.backoff_base * 2 ** (job.retries - 1),
                            self.backoff_max,
                        ))
                        self._enqueue(job)
                    else:
                        self._poison(
                            job, e,
                            cause=(
                                "retries-exhausted"
                                if verdict == "transient" else verdict
                            ),
                        )
                    return False
                job.tally = tally
                job.quanta = 0
                job.state = RESIDENT
                self._resident.append(job)
                attrs["restored"] = not job.needs_stage
                self.recorder.record(
                    "job_admitted", job=job.id, job_id=job.id,
                    shape_key=job.shape_key,
                    restored=job.checkpoint is not None,
                )
                return True
        finally:
            self.tracer.span_record(
                "admit", time.perf_counter() - a0,
                trace_id=job.trace_id, parent=root, job_id=job.id,
                span_id=aid, **attrs,
            )

    def _quantum(self, job: Job) -> None:
        """One scheduling quantum: up to ``quantum_moves`` fused moves
        for one resident job, then the completion checks.  The
        dispatch runs under the per-job failure containment loop
        (module docstring): transient-classified failures replay the
        quantum bitwise from the job's pre-quantum snapshot with
        bounded backoff; everything else poisons THIS job only."""
        remaining = job.request.n_moves - job.moves_done
        if remaining <= 0:
            # A recovered checkpoint already at the move budget (the
            # crash landed between the final checkpoint and the finish
            # record): nothing to dispatch — the restored accumulator
            # IS the result.
            self._finish(job, "completed")
            return
        k = min(self.quantum, remaining)
        kw = {}
        if job.needs_stage:
            _, w, g, alive = self._padded_inputs(job)
            kw = dict(weights=w, groups=g, alive=alive)
        self._n_quanta += 1
        # Crash model: the injected server kill propagates raw — no
        # flush, no cleanup.  The write-ahead journal must already
        # hold everything recovery needs (that is the contract the
        # recovery tests prove).
        self.faults.maybe_kill_server(self._n_quanta)
        snap = (
            snapshot_state(job.tally)
            if self.job_retries > 0 else None
        )
        # Pre-allocated quantum span id: retry events and the
        # coordinator's classify spans emitted mid-quantum parent onto
        # the quantum span via the ambient binding (the span itself is
        # emitted when the quantum closes — including by poison).
        qid = self.tracer.next_id()
        qattrs: dict = {"k": k, "move_start": job.moves_done}
        t0 = time.perf_counter()
        fail_t0 = None
        attempt = 0
        disp_s = 0.0  # wall inside blocked dispatches (device time)
        poison: tuple | None = None
        try:
            with self.tracer.bind(
                job.trace_id, job.id, qid
            ):
                while True:
                    d0 = time.perf_counter()
                    try:
                        self.faults.maybe_poison_job(job.index)
                        self.faults.maybe_transient_quantum(job.index)
                        totals = job.tally.run_source_moves(
                            k, job.request.source, **kw
                        )
                        disp_s += time.perf_counter() - d0
                        qattrs["moves"] = int(totals["moves"])
                        qattrs["alive"] = int(totals["alive"])
                        break
                    except InjectedKill:
                        raise
                    except Exception as e:
                        # A failed attempt still held the device — its
                        # wall time stays attributed to this job.
                        disp_s += time.perf_counter() - d0
                        if fail_t0 is None:
                            fail_t0 = time.perf_counter()
                        self._coordinator.rebind(job.tally)
                        verdict = self._coordinator.classify(e)
                        if (
                            verdict != "transient"
                            or attempt >= self.job_retries
                            or snap is None
                        ):
                            cause = (
                                "retries-exhausted"
                                if verdict == "transient" else verdict
                            )
                            qattrs["error"] = (
                                f"{type(e).__name__}: {e}"[:200]
                            )
                            # Deferred past the finally so the failing
                            # quantum's span is in the ring BEFORE the
                            # poison black box snapshots it.
                            poison = (e, cause)
                            break
                        attempt += 1
                        job.retries += 1
                        cause = (
                            "timeout"
                            if isinstance(e, DispatchTimeoutError)
                            else "transient"
                        )
                        self._retries_total.inc(cause=cause)
                        log_warn(
                            f"job {job.id} quantum failed transiently "
                            f"({e}); replaying from its snapshot "
                            f"(attempt {attempt}/{self.job_retries})"
                        )
                        # Bitwise replay anchor: the snapshot is the
                        # same payload the checkpoint subsystem
                        # persists, and the restore rebuilds every
                        # donated buffer from host copies — a
                        # half-consumed dispatch leaves nothing behind.
                        restore_state(job.tally, snap)
                        self.tracer.event(
                            "retry", cause=cause, attempt=attempt,
                            error=str(e)[:200],
                        )
                        self.recorder.record(
                            "job_retry", job=job.id, job_id=job.id,
                            shape_key=job.shape_key,
                            cause=cause, attempt=attempt,
                            error=str(e)[:200],
                        )
                        self._sleep(min(
                            self.backoff_base * 2 ** (attempt - 1),
                            self.backoff_max,
                        ))
                # Injected brownout (slow_member:M:F): stretch this
                # quantum's WALL time to ~F× its dispatch time.  Pure
                # host-side latency — device results are untouched, so
                # the job stays bitwise; only the supervisor's latency
                # SLO sees it.
                if poison is None:
                    extra = self.faults.slow_quantum_extra(
                        self.member_index, disp_s
                    )
                    if extra > 0.0:
                        self._sleep(extra)
        finally:
            # Device-time attribution survives every exit path
            # (success, poison return, injected kill unwinding).
            job.device_seconds += disp_s
            if disp_s > 0:
                self._device_seconds.inc(
                    disp_s, member=self._member_label()
                )
            self._quantum_wall_seconds.inc(
                time.perf_counter() - t0, member=self._member_label()
            )
            if job.first_dispatch_s is None and disp_s > 0:
                job.first_dispatch_s = time.perf_counter()
                self._ttfq_seconds.observe(
                    job.first_dispatch_s - job.submitted_s
                )
            self.tracer.span_record(
                "quantum", time.perf_counter() - t0,
                trace_id=job.trace_id,
                parent=SpanTracer.root_id(job.trace_id),
                job_id=job.id, span_id=qid, retries=attempt,
                device_seconds=round(disp_s, 6), **qattrs,
            )
        if poison is not None:
            self._poison(job, poison[0], cause=poison[1])
            return
        if fail_t0 is not None:
            job.recovery_seconds += time.perf_counter() - fail_t0
        job.needs_stage = False
        job.moves_done += totals["moves"]
        job.quanta += 1
        for key, v in totals.items():
            job.totals[key] += v
        job.totals["alive"] = totals["alive"]
        self._quanta_total.inc()
        # Successful quanta feed the supervisor's brownout window
        # (wall time, injected latency included).
        self.recent_quantum_seconds.append(time.perf_counter() - t0)
        self.recorder.record(
            "quantum", job=job.id, job_id=job.id,
            shape_key=job.shape_key,
            moves=int(totals["moves"]), move_total=job.moves_done,
            alive=int(totals["alive"]), retries=attempt,
            device_seconds=round(disp_s, 6),
            seconds=round(time.perf_counter() - t0, 6),
        )
        if totals["alive"] == 0 or job.moves_done >= job.request.n_moves:
            self._finish(job, "completed")
        elif self.config.convergence and job.tally.converged():
            self._finish(job, "converged")
        elif self.journal is not None:
            # Write-ahead: checkpoint the quantum boundary, THEN the
            # journal record that references it.
            self._journal_checkpoint(job)
            self._flush_journal()

    def _trace_terminal(self, job: Job, outcome: str, **attrs) -> None:
        """Emit the trace's ROOT span (deterministic id — spans from
        every process lifetime already parent onto it) and observe the
        end-to-end SLO histogram.  ``parent=NO_PARENT`` because this
        is usually emitted inside a bind whose parent the root must
        not inherit."""
        from ..obs import NO_PARENT

        e2e = max(0.0, (job.finished_s or time.perf_counter())
                  - job.submitted_s)
        self._e2e_seconds.observe(e2e)
        self.tracer.span_record(
            "job", e2e, trace_id=job.trace_id, parent=NO_PARENT,
            job_id=job.id, span_id=SpanTracer.root_id(job.trace_id),
            outcome=outcome, moves=job.moves_done,
            device_seconds=round(job.device_seconds, 6),
            preemptions=job.preemptions, retries=job.retries,
            **attrs,
        )

    def _blackbox(self, tag: str, *, reason: str,
                  meta: dict | None = None) -> str | None:
        """Dump the tracer ring as a postmortem black box (atomic
        write).  Best-effort by design — a failed dump must never take
        the serving loop (or the signal path) down with it."""
        if self.blackbox_dir is None:
            return None
        path = os.path.join(self.blackbox_dir, f"{tag}.blackbox.json")
        try:
            self.tracer.dump(path, reason=reason, meta=meta)
        except Exception as e:  # pragma: no cover - dump best-effort
            log_warn(f"black-box dump {path} failed: {e}")
            return None
        return path

    def _finish(self, job: Job, outcome: str) -> None:
        job.result = job.tally.raw_flux.copy()
        job.tally.close()
        job.tally = None
        if job in self._resident:
            self._resident.remove(job)
        job.state = DONE
        job.outcome = outcome
        job.finished_s = time.perf_counter()
        self._jobs_total.inc(outcome=outcome)
        self._job_seconds.observe(job.finished_s - job.submitted_s)
        self._trace_terminal(job, outcome)
        if self.journal is not None:
            # Results survive the process: flux first, then the journal
            # record that references it.
            job.flux_name = self.journal.write_flux(job.id, job.result)
        self.recorder.record(
            "job_done", job=job.id, job_id=job.id,
            shape_key=job.shape_key,
            outcome=outcome, moves=job.moves_done,
            preemptions=job.preemptions, retries=job.retries,
            device_seconds=round(job.device_seconds, 6),
            seconds=round(job.finished_s - job.submitted_s, 6),
        )
        # Write-ahead order: commit the terminal record (with its
        # flux) BEFORE deleting the checkpoint — a crash between the
        # two must cost a redundant file, never the finished work.
        self._flush_journal()
        self._remove_checkpoint(job)

    def _remove_checkpoint(self, job: Job) -> None:
        if job.checkpoint is not None:
            try:
                os.remove(job.checkpoint)
            except OSError:
                pass
            job.checkpoint = None
        if self.journal is not None:
            self.journal.remove_sidefiles(job.id)

    def _poison(self, job: Job, exc: BaseException, cause: str) -> None:
        """Isolate one failed job: free its device slot, mark it
        terminal with ``outcome="poisoned"``, and keep serving — every
        other resident and queued job continues bitwise-identical to a
        fault-free run (jobs are facade-isolated)."""
        if job.tally is not None:
            try:
                job.tally.close()
            except Exception:  # pragma: no cover - teardown best-effort
                pass
            job.tally = None
        if job in self._resident:
            self._resident.remove(job)
        job.state = DONE
        job.outcome = "poisoned"
        job.error = f"{type(exc).__name__}: {exc}"
        job.finished_s = time.perf_counter()
        self._jobs_total.inc(outcome="poisoned")
        self._job_seconds.observe(job.finished_s - job.submitted_s)
        log_warn(
            f"job {job.id} poisoned ({cause}): {job.error} — slot "
            "freed, remaining jobs unaffected"
        )
        self._trace_terminal(
            job, "poisoned", cause=cause, error=job.error[:200],
        )
        self.recorder.record(
            "job_poisoned", job=job.id, job_id=job.id,
            shape_key=job.shape_key,
            cause=cause, error=job.error[:200], moves=job.moves_done,
            retries=job.retries,
        )
        # The postmortem: the ring now holds the job's terminal root
        # span and its final quanta/retries/classify spans — dump it
        # before the journal commits the poisoned state.
        self._blackbox(
            job.id, reason=f"poisoned:{cause}",
            meta={
                "job_id": job.id, "trace_id": job.trace_id,
                "cause": cause, "error": job.error[:200],
            },
        )
        self._flush_journal()
        self._remove_checkpoint(job)

    @staticmethod
    def _checkpoint_current(job: Job, path: str) -> bool:
        """Whether ``path`` already holds ``job``'s state at this
        boundary: a journaled job preempted at the boundary its quantum
        checkpoint was written at (a fleet migration) has that state on
        disk, and no quantum ran since. The protocol lint reads this
        call as the effect ``checkpoint.current``, which stands in for
        the save before the preemption's journal flush."""
        return (job.checkpoint == path
                and job.checkpoint_moves == job.moves_done
                and os.path.exists(path))

    def _preempt(self, job: Job) -> None:
        """Checkpoint-preempt one resident job (megastep boundary —
        quanta never split) and re-queue it.  Journaled schedulers
        park the checkpoint in the journal directory, where recovery
        already looks."""
        path = (
            self.journal.checkpoint_path(job.id)
            if self.journal is not None
            else os.path.join(self.checkpoint_dir, f"{job.id}.ckpt.npz")
        )
        if not self._checkpoint_current(job, path):
            job.tally.save_checkpoint(path)
            job.checkpoint_moves = job.moves_done
        job.tally.close()
        job.tally = None
        job.checkpoint = path
        job.preemptions += 1
        self._resident.remove(job)
        self._preempt_total.inc()
        self.tracer.event(
            "preempted", trace_id=job.trace_id,
            parent=SpanTracer.root_id(job.trace_id), job_id=job.id,
            moves=job.moves_done, quanta=job.quanta,
        )
        self.recorder.record(
            "job_preempted", job=job.id, job_id=job.id,
            shape_key=job.shape_key,
            moves=job.moves_done, quanta=job.quanta,
        )
        self._enqueue(job)
        self._flush_journal()

    # ------------------------------------------------------------------ #
    # The scheduling loop
    # ------------------------------------------------------------------ #
    def step(self) -> bool:
        """One scheduling round: admit to capacity, run one quantum per
        resident job (round-robin fairness), then apply the preemption
        policy.  Returns True while any job is non-terminal.  A
        preemption signal landing mid-round defers to the next quantum
        boundary, where the journal flush writes consistent state.

        A DEGRADED journal (disk pressure) parks every resident and
        holds the round: the member neither admits nor dispatches
        until a fleet supervisor drains it (or an operator clears the
        disk and restarts).  Returns False then — a degraded member
        cannot make progress on its own."""
        if self.journal is not None and self.journal.degraded:
            self._park_degraded()
            return False
        self._in_step = True
        try:
            while len(self._resident) < self.max_resident:
                nxt = self._pop_next()
                if nxt is None:
                    break
                self._admit(nxt)
                self._queue_depth.set(self.queue_depth)
            for job in list(self._resident):
                if self._pending_signal is not None:
                    break
                self._quantum(job)
            if (
                self.preempt_after is not None
                and self.queue_depth > 0
                and len(self._resident) >= self.max_resident
            ):
                # Yield the slot held longest (most quanta since
                # admission, oldest first on ties) — one per round
                # keeps the policy simple and the churn bounded.
                ripe = [
                    j for j in self._resident
                    if j.quanta >= self.preempt_after
                ]
                if ripe:
                    self._preempt(max(ripe, key=lambda j: j.quanta))
            self._queue_depth.set(self.queue_depth)
        finally:
            self._in_step = False
            if self._pending_signal is not None:
                sig, self._pending_signal = self._pending_signal, None
                self._signal_flush(sig, None)
        return any(not j.terminal for j in self._jobs.values())

    def run(self, max_rounds: int = 100000) -> None:
        """Drive scheduling rounds until every submitted job is done."""
        for _ in range(max_rounds):
            if not self.step():
                return
        raise RuntimeError(
            f"scheduler did not drain within {max_rounds} rounds "
            f"({self.queue_depth} queued, {len(self._resident)} "
            "resident)"
        )

    # ------------------------------------------------------------------ #
    # Introspection
    # ------------------------------------------------------------------ #
    def job(self, job_id: str) -> Job:
        return self._jobs[job_id]

    def jobs(self) -> list[Job]:
        return list(self._jobs.values())

    def _jobs_json(self, query: dict | None = None) -> dict:
        """The live job table for the exporter's ``/jobs`` endpoint
        (and teleview): one JSON row per job with its trace identity
        and device-time attribution.  The table is capped at
        ``?limit=`` rows (default ``JOBS_JSON_LIMIT``), NEWEST first —
        a long-lived server accumulates terminal rows without bound
        and a scrape surface must stay scrape-sized."""
        limit = _jobs_limit(query)
        rows = sorted(
            self._jobs.values(), key=lambda j: j.index, reverse=True
        )
        return {
            "schema": FLIGHT_SCHEMA,
            "queue_depth": self.queue_depth,
            "resident": len(self._resident),
            "total_jobs": len(rows),
            "limit": limit,
            "jobs": [
                {
                    "id": j.id,
                    "index": j.index,
                    "state": j.state,
                    "outcome": j.outcome,
                    "error": j.error,
                    "shape_key": j.shape_key,
                    "n": j.n,
                    "n_moves": int(j.request.n_moves),
                    "moves_done": j.moves_done,
                    "preemptions": j.preemptions,
                    "retries": j.retries,
                    "trace_id": j.trace_id,
                    "device_seconds": round(j.device_seconds, 6),
                }
                for j in rows[:limit]
            ],
        }

    def result(self, job_id: str) -> np.ndarray:
        """Raw flux [ntet, n_groups, 2] of one finished job."""
        job = self._jobs[job_id]
        if job.result is None:
            raise RuntimeError(
                f"job {job_id} has no result (state={job.state}, "
                f"outcome={job.outcome})"
            )
        return job.result

    def stats(self) -> dict:
        """Summary for the bench / serve.py JSON."""
        outcomes = {
            s["labels"].get("outcome", ""): int(s["value"])
            for s in self._jobs_total.snapshot()["series"]
        }
        out = {
            "jobs": len(self._jobs),
            "outcomes": outcomes,
            "queue_depth": self.queue_depth,
            "resident": len(self._resident),
            "preemptions": int(
                sum(s["value"]
                    for s in self._preempt_total.snapshot()["series"])
            ),
            "retries": int(
                sum(s["value"]
                    for s in self._retries_total.snapshot()["series"])
            ),
            "recovered": self._n_recovered,
            "journal": (
                self.journal.dir if self.journal is not None else None
            ),
            "quanta": int(self._quanta_total.value()),
            "device_seconds": round(
                sum(j.device_seconds for j in self._jobs.values()), 6
            ),
            "quantum_moves": self.quantum,
            "max_resident": self.max_resident,
            "max_queued": self.max_queued,
            "classes": {
                key: sum(
                    1 for j in self._jobs.values()
                    if j.shape_key == key
                )
                for key in self._class_order
            },
            "aot": self.bank.stats() if self.bank is not None else None,
        }
        return out

    def abandon(self) -> None:
        """Crash-model teardown: release device state, signal handlers
        and the exporter WITHOUT any journal write — what a modeled
        server kill leaves behind must be exactly what the write-ahead
        journal already committed (otherwise a stale handler chained
        from a later scheduler in the same process could rewrite the
        journal with this scheduler's dead job table)."""
        for job in list(self._resident):
            if job.tally is not None:
                try:
                    job.tally.close()
                except Exception:  # pragma: no cover - best-effort
                    pass
                job.tally = None
            self._resident.remove(job)
        self._uninstall_signal_handlers()
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None

    def close(self) -> None:
        """Stop the exporter and drop any resident device state.  A
        journaled scheduler parks every resident job's checkpoint
        first, so a graceful shutdown is as resumable as a crash."""
        for job in list(self._resident):
            if job.tally is not None:
                if self.journal is not None:
                    try:
                        self._journal_checkpoint(job)
                    except Exception as e:  # pragma: no cover
                        log_warn(
                            f"close checkpoint of {job.id} failed: {e}"
                        )
                job.tally.close()
                job.tally = None
            self._resident.remove(job)
        self._flush_journal()
        # Every serving campaign leaves a postmortem artifact, crashed
        # or not — a graceful close dumps the same black box a signal
        # or a poison would have.
        self._blackbox("shutdown", reason="close")
        self._uninstall_signal_handlers()
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None
