"""Fault-injection harness: prove each failure mode recovers.

Own copy of ``pumiumtally_tpu/resilience/faultinject.py`` (the seeded
multi-fault ``ChaosPlan``/``ChaosInjector`` of the chaos campaigns are
ROADMAP.md A11). A resilience subsystem that is only exercised by real
preemptions is untested code on the critical path. This module injects
the failure modes the ``ResilientRunner`` claims to survive,
deterministically, from one env knob::

    PUMI_TPU_FAULTS=nan_src:0.01,die_at_move:3,corrupt_ckpt

Grammar: comma-separated ``name[:value]`` clauses —

  ``nan_src:P``           each move, each lane's destination is NaN'd
                          with probability P (deterministic per
                          (seed, move) — replays reproduce the faults);
  ``die_at_move:K``       the K-th facade move (1-based over the run,
                          i.e. ``iter_count + 1 == K``) raises
                          ``InjectedKill`` BEFORE the walk runs — a
                          preemption mid-campaign. Fires once per
                          injector (the resumed process is a new one);
  ``transient_at_move:K`` the K-th move raises
                          ``InjectedTransientFault`` once — the
                          retry-with-backoff path must absorb it;
  ``corrupt_ckpt``        every checkpoint the supervisor writes is
                          bit-flipped right after the write — the
                          ``find_latest`` fallback must skip it;
  ``bitflip_flux:K``      after the K-th facade move, one flux entry
                          gets its sign flipped (or NaN'd when the
                          accumulator is still empty) — a single-bit
                          SDC the integrity layer's on-device flux
                          invariant must catch on the NEXT move
                          (integrity/invariants.py);
  ``sdc_walk:K``          at the K-th move's shadow audit, one sampled
                          lane's production track length is perturbed —
                          a mis-scored segment the float64 audit
                          re-walk must flag (integrity/audit.py);
  ``hang_at_move:K``      the K-th move's device dispatch sleeps
                          ``hang_seconds`` (a wedged dispatch) — the
                          watchdog deadline must surface it as a
                          retryable DispatchTimeoutError
                          (integrity/watchdog.py);
  ``hang_seconds:S``      how long the injected hang sleeps (default
                          5.0; tests use fractions of a second so the
                          abandoned watchdog thread dies quickly);
  ``chip_down_at_move:K`` the K-th move raises ``ChipLostError`` once,
                          and the chip stays DOWN for every subsequent
                          health probe (``downed``) — the coordinator
                          must classify it chip-lost and the elastic
                          layer must re-partition onto the survivors
                          (resilience/coordinator.py, elastic.py);
  ``chip:C``              which chip ``chip_down_at_move`` kills
                          (default -1 = the last chip of the mesh);
  ``preempt_at_move:K``   the K-th move raises ``InjectedPreemption``
                          MID-MOVE (inside the supervised dispatch) —
                          the runner must flush the LAST-GOOD
                          generation, never the in-flight state, then
                          let it propagate like a real SIGTERM;
  ``torn_shard:G``        the G-th checkpoint generation the
                          supervisor writes is TORN right after the
                          commit: one shard file is truncated
                          mid-payload (single-file generations get the
                          corrupt_ckpt byte-flip), so its manifest
                          digest fails and find_latest must reject the
                          WHOLE generation atomically;
  ``poison_job:K``        the job with submission index K is POISON:
                          every scheduling quantum it dispatches
                          raises ``InjectedPoisonFault`` — a
                          persistent per-job failure the serving
                          scheduler must isolate (finish the job
                          ``poisoned``, free its slot) while every
                          other job continues bitwise
                          (serving/scheduler.py);
  ``transient_quantum:K`` job K's next scheduling quantum raises
                          ``InjectedTransientFault`` once — the
                          scheduler's bounded per-job retry must
                          replay the quantum bitwise from the job's
                          own snapshot;
  ``kill_server_at_quantum:Q`` the Q-th scheduling quantum the server
                          executes (1-based, counted across all jobs)
                          raises ``InjectedKill`` BEFORE the dispatch
                          — a server crash mid-run. Fires once per
                          injector (the restarted process is a new
                          one); recovery is the JOBS.json journal's
                          ``TallyScheduler.recover`` path;
  ``wedge_member:M``      fleet member M stops answering health probes
                          but HOLDS its jobs (no raise, no progress) —
                          the silent-wedge failure mode only the
                          supervisor's missed-heartbeat detection can
                          see (serving/supervisor.py). Persists until
                          the injector is swapped out;
  ``slow_member:M:F``     fleet member M's scheduling quanta run F×
                          their natural wall time (host-side injected
                          latency; device results are untouched, so
                          the job stays bitwise) — a brownout the
                          supervisor's latency SLO must flag without
                          false-positively evicting;
  ``disk_full_at:N``      the N-th durable write this injector gates
                          (journal flush, flux persist, quantum
                          checkpoint) — and every one after it, the
                          disk stays full — raises an ENOSPC OSError;
                          the journal must degrade instead of crash
                          (serving/journal.py);
  ``seed:S``              rng seed for nan_src lane choice (default 0).

The supervisor modes (nan_src/die/transient/corrupt_ckpt/preempt) are
driven by the ``ResilientRunner``'s injector; the integrity modes
(bitflip_flux/sdc_walk/hang_at_move) are driven by the FACADE's own
injector so the detectors they target see the corruption whether or not
a supervisor wraps the run. The serving and fleet modes (poison_job,
transient_quantum, kill_server_at_quantum, wedge_member, slow_member,
disk_full_at) parse and answer as in the JAX package; the port's serving
layer that drives them is ROADMAP.md A11; ``chip_down_at_move`` drives
the runner's elastic mesh shrink (resilience/elastic.py).

The injector is a no-op when the plan is empty, so production code can
call its hooks unconditionally.
"""
from __future__ import annotations

import dataclasses
import errno
import os

import numpy as np


class InjectedFault(RuntimeError):
    """Base class for injected failures."""


class InjectedKill(InjectedFault):
    """Simulated preemption: NOT retryable — the supervisor must let it
    propagate (the process is 'dead'); recovery is the next process's
    auto-resume."""


class InjectedTransientFault(InjectedFault):
    """Simulated transient device/runtime error: retryable — the
    supervisor's backoff path must absorb it."""


class InjectedPreemption(InjectedKill):
    """Simulated preemption notice landing MID-MOVE: the supervisor
    flushes the last-GOOD generation (never the in-flight state) and
    then lets it propagate — the process is being evicted; recovery is
    the next process's auto-resume."""


class InjectedPoisonFault(InjectedFault):
    """Simulated persistent per-job failure (a poison job): NOT
    retryable — replaying the same request hits the same failure every
    time. The serving scheduler must isolate it (job finished
    ``poisoned``, device slot freed) instead of retrying forever or
    taking the server down with it."""


class ChipLostError(RuntimeError):
    """A device dropped out of the mesh. Raised by the injector
    (``chip_down_at_move``) and by the coordinator when a health probe
    finds a dead chip behind a runtime error. NOT plain-retryable: an
    in-place replay would re-dispatch onto the dead chip — recovery is
    the coordinated rollback + elastic mesh-shrink path
    (resilience/coordinator.py, elastic.py)."""

    def __init__(self, message: str, chip: int = -1):
        super().__init__(message)
        self.chip = int(chip)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    nan_src: float = 0.0
    die_at_move: int | None = None
    transient_at_move: int | None = None
    corrupt_ckpt: bool = False
    bitflip_flux: int | None = None
    sdc_walk: int | None = None
    hang_at_move: int | None = None
    hang_seconds: float = 5.0
    chip_down_at_move: int | None = None
    chip: int = -1
    preempt_at_move: int | None = None
    torn_shard: int | None = None
    poison_job: int | None = None
    transient_quantum: int | None = None
    kill_server_at_quantum: int | None = None
    wedge_member: int | None = None
    slow_member: int | None = None
    slow_factor: float = 1.0
    disk_full_at: int | None = None
    seed: int = 0

    def any(self) -> bool:
        return bool(
            self.nan_src
            or self.die_at_move is not None
            or self.transient_at_move is not None
            or self.corrupt_ckpt
            or self.bitflip_flux is not None
            or self.sdc_walk is not None
            or self.hang_at_move is not None
            or self.chip_down_at_move is not None
            or self.preempt_at_move is not None
            or self.torn_shard is not None
            or self.poison_job is not None
            or self.transient_quantum is not None
            or self.kill_server_at_quantum is not None
            or self.wedge_member is not None
            or self.slow_member is not None
            or self.disk_full_at is not None
        )


def parse_faults(spec: str) -> FaultPlan:
    """Parse the ``PUMI_TPU_FAULTS`` grammar (module docstring). Raises
    ``ValueError`` on unknown clauses or malformed values — a typo'd
    fault spec silently injecting nothing would defeat the tests."""
    fields: dict = {}
    for clause in filter(None, (c.strip() for c in spec.split(","))):
        name, _, value = clause.partition(":")
        if name == "nan_src":
            fields["nan_src"] = float(value)
            if not 0.0 <= fields["nan_src"] <= 1.0:
                raise ValueError(
                    f"nan_src must be a probability: {value!r}"
                )
        elif name == "die_at_move":
            fields["die_at_move"] = int(value)
        elif name == "transient_at_move":
            fields["transient_at_move"] = int(value)
        elif name == "corrupt_ckpt":
            if value:
                raise ValueError("corrupt_ckpt takes no value")
            fields["corrupt_ckpt"] = True
        elif name == "bitflip_flux":
            fields["bitflip_flux"] = int(value)
        elif name == "sdc_walk":
            fields["sdc_walk"] = int(value)
        elif name == "hang_at_move":
            fields["hang_at_move"] = int(value)
        elif name == "hang_seconds":
            fields["hang_seconds"] = float(value)
            if fields["hang_seconds"] <= 0:
                raise ValueError(
                    f"hang_seconds must be positive: {value!r}"
                )
        elif name == "chip_down_at_move":
            fields["chip_down_at_move"] = int(value)
        elif name == "chip":
            fields["chip"] = int(value)
        elif name == "preempt_at_move":
            fields["preempt_at_move"] = int(value)
        elif name == "torn_shard":
            fields["torn_shard"] = int(value)
            if fields["torn_shard"] < 1:
                raise ValueError(
                    f"torn_shard counts generations from 1: {value!r}"
                )
        elif name == "poison_job":
            fields["poison_job"] = int(value)
        elif name == "transient_quantum":
            fields["transient_quantum"] = int(value)
        elif name == "kill_server_at_quantum":
            fields["kill_server_at_quantum"] = int(value)
            if fields["kill_server_at_quantum"] < 1:
                raise ValueError(
                    "kill_server_at_quantum counts quanta from 1: "
                    f"{value!r}"
                )
        elif name == "wedge_member":
            fields["wedge_member"] = int(value)
        elif name == "slow_member":
            member, _, factor = value.partition(":")
            fields["slow_member"] = int(member)
            fields["slow_factor"] = float(factor) if factor else 4.0
            if fields["slow_factor"] < 1.0:
                raise ValueError(
                    f"slow_member factor must be >= 1: {value!r}"
                )
        elif name == "disk_full_at":
            fields["disk_full_at"] = int(value)
            if fields["disk_full_at"] < 1:
                raise ValueError(
                    f"disk_full_at counts durable writes from 1: "
                    f"{value!r}"
                )
        elif name == "seed":
            fields["seed"] = int(value)
        else:
            raise ValueError(
                f"unknown fault {name!r} in PUMI_TPU_FAULTS "
                f"(known: nan_src, die_at_move, transient_at_move, "
                f"corrupt_ckpt, bitflip_flux, sdc_walk, hang_at_move, "
                f"hang_seconds, chip_down_at_move, chip, "
                f"preempt_at_move, torn_shard, poison_job, "
                f"transient_quantum, kill_server_at_quantum, "
                f"wedge_member, slow_member, disk_full_at, seed)"
            )
    return FaultPlan(**fields)


def plan_from_env() -> FaultPlan:
    return parse_faults(os.environ.get("PUMI_TPU_FAULTS", ""))


class FaultInjector:
    """Stateful per-process injector over a FaultPlan.

    ``die_at_move`` / ``transient_at_move`` fire at most once per
    injector instance — the model is one failure per process life, and
    a resumed run constructs a fresh injector (usually with a fresh
    env)."""

    def __init__(self, plan: FaultPlan | None = None):
        self.plan = plan if plan is not None else plan_from_env()
        self._died = False
        self._transient_fired = False
        self._bitflip_fired = False
        self._sdc_fired = False
        self._hang_fired = False
        self._preempt_fired = False
        #: Chip indices this injector has killed (the once-only guard;
        #: the runner forwards each raise to
        #: ``ResilienceCoordinator.note_down``, which pins the DEVICE
        #: so later probes keep it dead across reshards — the CPU test
        #: mesh has no way to actually lose a device).
        self.downed: set[int] = set()
        self._ckpt_writes = 0
        self._torn_fired = False
        self._quantum_transient_fired = False
        self._server_killed = False
        self._durable_writes = 0

    # ------------------------------------------------------------------ #
    def maybe_die(self, move: int) -> None:
        if (
            self.plan.die_at_move is not None
            and move == self.plan.die_at_move
            and not self._died
        ):
            self._died = True
            raise InjectedKill(
                f"injected preemption at move {move} "
                f"(PUMI_TPU_FAULTS die_at_move)"
            )

    def maybe_transient(self, move: int) -> None:
        if (
            self.plan.transient_at_move is not None
            and move == self.plan.transient_at_move
            and not self._transient_fired
        ):
            self._transient_fired = True
            raise InjectedTransientFault(
                f"injected transient device error at move {move} "
                f"(PUMI_TPU_FAULTS transient_at_move)"
            )

    def maybe_chip_down(self, move: int) -> None:
        """``chip_down_at_move``: lose a chip at the matching move —
        raises ``ChipLostError`` once and marks the chip permanently
        down for the health probe."""
        if (
            self.plan.chip_down_at_move is not None
            and move == self.plan.chip_down_at_move
            and self.plan.chip not in self.downed
        ):
            self.downed.add(self.plan.chip)
            raise ChipLostError(
                f"injected chip loss at move {move} "
                f"(PUMI_TPU_FAULTS chip_down_at_move, chip "
                f"{self.plan.chip})",
                chip=self.plan.chip,
            )

    def maybe_preempt(self, move: int) -> None:
        """``preempt_at_move``: a preemption notice landing mid-move
        (inside the supervised dispatch), once."""
        if (
            self.plan.preempt_at_move is not None
            and move == self.plan.preempt_at_move
            and not self._preempt_fired
        ):
            self._preempt_fired = True
            raise InjectedPreemption(
                f"injected preemption at move {move} "
                f"(PUMI_TPU_FAULTS preempt_at_move)"
            )

    # -- serving-scheduler hooks (per-JOB fault targeting) ------------- #
    def maybe_poison_job(self, job_index: int) -> None:
        """``poison_job:K``: job K's quantum dispatches raise a
        PERSISTENT fault — every time, not once; a poison request does
        not get better on replay. The scheduler must classify it
        persistent and isolate the job."""
        if (
            self.plan.poison_job is not None
            and job_index == self.plan.poison_job
        ):
            raise InjectedPoisonFault(
                f"injected poison job at index {job_index} "
                f"(PUMI_TPU_FAULTS poison_job)"
            )

    def maybe_transient_quantum(self, job_index: int) -> None:
        """``transient_quantum:K``: job K's next quantum raises a
        transient once — the scheduler's bounded retry must absorb it
        with a bitwise replay from the job's own snapshot."""
        if (
            self.plan.transient_quantum is not None
            and job_index == self.plan.transient_quantum
            and not self._quantum_transient_fired
        ):
            self._quantum_transient_fired = True
            raise InjectedTransientFault(
                f"injected transient quantum for job {job_index} "
                f"(PUMI_TPU_FAULTS transient_quantum)"
            )

    def maybe_kill_server(self, quantum: int) -> None:
        """``kill_server_at_quantum:Q``: the server 'crashes' before
        dispatching its Q-th scheduling quantum (1-based, across all
        jobs), once per injector. The write-ahead journal must make
        the next process's ``recover`` resume every job."""
        if (
            self.plan.kill_server_at_quantum is not None
            and quantum == self.plan.kill_server_at_quantum
            and not self._server_killed
        ):
            self._server_killed = True
            raise InjectedKill(
                f"injected server kill at quantum {quantum} "
                f"(PUMI_TPU_FAULTS kill_server_at_quantum)"
            )

    # -- fleet-supervisor hooks (per-MEMBER fault targeting) ----------- #
    def member_wedged(self, member_index: int | None) -> bool:
        """``wedge_member:M``: True while member M is wedged — it
        answers no health probe and makes no progress, but holds its
        jobs and device state. Not once-only: a wedge persists until
        the member's injector is replaced (chaos harnesses model
        un-wedging by swapping in a clean injector)."""
        return (
            self.plan.wedge_member is not None
            and member_index == self.plan.wedge_member
        )

    def slow_quantum_extra(
        self, member_index: int | None, base_s: float
    ) -> float:
        """``slow_member:M:F``: extra host-side seconds to sleep after
        member M's quantum so the quantum's wall time is ~F× its
        natural duration. Device results are untouched — the brownout
        is pure latency, and the job stays bitwise."""
        if (
            self.plan.slow_member is None
            or member_index != self.plan.slow_member
        ):
            return 0.0
        return max(0.0, (self.plan.slow_factor - 1.0) * float(base_s))

    def maybe_disk_full(self) -> None:
        """``disk_full_at:N``: the N-th durable write this injector
        gates — and every write after it; an injected full disk stays
        full — raises an ENOSPC ``OSError``. The journal layer must
        convert it into degraded mode, never a crash."""
        if self.plan.disk_full_at is None:
            return
        self._durable_writes += 1
        if self._durable_writes >= self.plan.disk_full_at:
            raise OSError(
                errno.ENOSPC,
                f"injected disk full at durable write "
                f"{self._durable_writes} (PUMI_TPU_FAULTS disk_full_at)",
            )

    def bitflip_at(self, move: int) -> bool:
        """``bitflip_flux``: True exactly once, after the matching move
        — the facade then flips one accumulator entry so the NEXT
        move's on-device flux invariant must catch it."""
        if (
            self.plan.bitflip_flux is not None
            and move == self.plan.bitflip_flux
            and not self._bitflip_fired
        ):
            self._bitflip_fired = True
            return True
        return False

    def sdc_at(self, move: int) -> bool:
        """``sdc_walk``: True exactly once, at the matching move's
        shadow audit — the audit then perturbs one sampled lane's
        production result so the float64 re-walk must flag it."""
        if (
            self.plan.sdc_walk is not None
            and move == self.plan.sdc_walk
            and not self._sdc_fired
        ):
            self._sdc_fired = True
            return True
        return False

    def maybe_hang(self, move: int) -> bool:
        """``hang_at_move``: sleep ``hang_seconds`` inside the dispatch
        closure at the matching move (once) — a wedged device dispatch
        the watchdog deadline must convert into a retryable timeout.
        Returns True when the hang fired (for fault accounting)."""
        if (
            self.plan.hang_at_move is not None
            and move == self.plan.hang_at_move
            and not self._hang_fired
        ):
            self._hang_fired = True
            import time

            time.sleep(self.plan.hang_seconds)
            return True
        return False

    def corrupt_destinations(self, dest, move: int) -> int:
        """NaN destination lanes IN PLACE with probability ``nan_src``,
        deterministically per (seed, move). ``dest`` must be the
        caller's float64 destination buffer (an out-param — the facade
        overwrites it at copy-back). Returns the lane count hit."""
        p = self.plan.nan_src
        if not p:
            return 0
        d = np.asarray(dest)
        if d.dtype != np.float64:
            # asarray would silently copy, NaN the copy, and report
            # lanes the caller's buffer never saw — refuse instead.
            raise TypeError(
                "nan_src needs the float64 destination out-param "
                f"buffer (in-place injection); got dtype {d.dtype}"
            )
        d = d.reshape(-1, 3)
        rng = np.random.default_rng([self.plan.seed, int(move)])
        bad = rng.random(d.shape[0]) < p
        d[bad] = np.nan
        return int(bad.sum())

    @staticmethod
    def _flip_bytes(path: str) -> None:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size // 2)
            chunk = f.read(16)
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in chunk))

    @staticmethod
    def _shard_files(dirname: str) -> list[str]:
        return sorted(
            os.path.join(dirname, n)
            for n in os.listdir(dirname)
            if n.startswith("shard-") and n.endswith(".npz")
        )

    def corrupt_file(self, path: str) -> bool:
        """``corrupt_ckpt``: flip bytes in the middle of the file (past
        the zip header, inside a compressed member) so the container
        still opens but the payload fails its digest/CRC. Sharded
        generations (directories) get one shard flipped — the manifest
        digest check must then reject the whole generation."""
        if not self.plan.corrupt_ckpt:
            return False
        if os.path.isdir(path):
            path = self._shard_files(path)[0]
        self._flip_bytes(path)
        return True

    def maybe_tear(self, path: str) -> bool:
        """``torn_shard:G``: tear the G-th generation this injector
        sees written — truncate one shard file mid-payload (a torn
        concurrent multi-shard write surfacing AFTER the manifest
        commit), or byte-flip a single-file generation. The store's
        digest checks must reject the whole generation atomically."""
        if self.plan.torn_shard is None:
            return False
        self._ckpt_writes += 1
        if self._ckpt_writes != self.plan.torn_shard or self._torn_fired:
            return False
        self._torn_fired = True
        if os.path.isdir(path):
            target = self._shard_files(path)[-1]
            with open(target, "r+b") as f:
                f.truncate(os.path.getsize(target) // 2)
        else:
            self._flip_bytes(path)
        return True
