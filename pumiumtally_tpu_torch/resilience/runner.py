"""ResilientRunner: the auto-checkpointing run supervisor.

Own copy of ``pumiumtally_tpu/resilience/runner.py`` for a
``PumiTally`` or a ``PartitionedTally`` on one device. It wraps the tally behind the same
``initialize_particle_location`` / ``move_to_next_location`` /
``run_source_moves`` surface and adds the fault-tolerance loop:

  * **auto-checkpoint** every ``every_moves`` moves or ``every_seconds``
    seconds into a rotating ``CheckpointStore`` (atomic writes,
    per-array sha256, keep-N);
  * **auto-resume**: construction restores the newest valid generation
    (corrupt ones are skipped) and the calling loop replays from
    ``tally.iter_count``; a replayed run is bitwise the uninterrupted one
    because checkpoint round trips are exact;
  * **preemption flush**: SIGTERM/SIGINT write one last checkpoint before
    the process dies, so at most the move in flight is lost;
  * **transient retry**: a retryable error from a move (injected
    transients, ``torch.AcceleratorError``, watchdog timeouts,
    ``integrity="retry"`` violations) rolls the tally back to the last
    good snapshot (clones on the device, ``utils/checkpoint.py``) and
    retries with exponential backoff, at most ``max_retries`` times;
  * **failure taxonomy** (``resilience/coordinator.py``): ``transient``
    replays bit for bit; ``preempted`` flushes the last good generation
    and propagates; ``chip-lost`` on one device flushes the last good
    generation and raises NotImplementedError, since the elastic mesh
    shrink onto the surviving devices is ROADMAP.md A9c (with
    ``elastic=False`` the ChipLostError itself propagates);
  * **fault injection**: every hook of ``faultinject.py`` threads
    through here, so the tests can prove each failure mode recovers.

The resume-aware loop::

    t = PumiTally(mesh, n, TallyConfig(quarantine=True))
    with ResilientRunner(t, "ckpts/", every_moves=25) as run:
        run.initialize_particle_location(pos)   # no-op after a resume
        for i in range(1, n_moves + 1):
            if t.iter_count >= i:
                continue                         # already replayed
            run.move_to_next_location(*inputs(i))
"""
from __future__ import annotations

import time

import numpy as np

from ..integrity.policy import (
    FatalIntegrityViolation,
    TransientIntegrityViolation,
)
from ..integrity.watchdog import DispatchTimeoutError
from ..utils.checkpoint import restore_state, snapshot_state
from ..utils.log import log_info, log_warn
from ..utils.signals import (
    install_preemption_handlers,
    resume_previous_handler,
    uninstall_preemption_handlers,
)
from .coordinator import DeviceError, ResilienceCoordinator
from .faultinject import (
    ChipLostError,
    FaultInjector,
    InjectedPreemption,
    InjectedTransientFault,
)
from .store import CheckpointStore

#: Error types a move retry can plausibly fix: injected transients, the
#: card's runtime errors (``torch.AcceleratorError``), watchdog timeouts
#: (integrity/watchdog.py: a hung step re-arms and replays instead of
#: wedging), and integrity="retry" violations (a one-shot SDC does not
#: recur on replay; a deterministic bug exhausts the bounded retries and
#: propagates). Anything else, InjectedKill and integrity="halt"
#: violations included, propagates. ``ChipLostError`` is not here: a
#: replay would run on the dead device.
RETRYABLE = (
    InjectedTransientFault,
    DispatchTimeoutError,
    TransientIntegrityViolation,
    DeviceError,
)


class ResilientRunner:
    def __init__(
        self,
        tally,
        store: CheckpointStore | str,
        *,
        every_moves: int | None = 25,
        every_seconds: float | None = None,
        keep: int = 3,
        max_retries: int = 3,
        backoff_base: float = 0.25,
        backoff_max: float = 8.0,
        resume: bool = True,
        handle_signals: bool = True,
        retry_snapshots: bool = True,
        elastic: bool = True,
        faults: FaultInjector | None = None,
        sleep=time.sleep,
    ):
        self.tally = tally
        self.store = (
            store if isinstance(store, CheckpointStore)
            else CheckpointStore(store, keep=keep)
        )
        self.every_moves = every_moves
        self.every_seconds = every_seconds
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        # The retry anchor costs one clone of the flux and the particle
        # state on the device per move. That is the price of an exact
        # transient rollback; runs that would rather lose the window
        # since the last file can turn it off: transient errors then
        # propagate like any other (the next process auto-resumes).
        self.retry_snapshots = bool(retry_snapshots)
        # Elastic mesh-shrink recovery (partitioned tallies, ROADMAP.md
        # A9c): on one device a chip-lost verdict flushes the last good
        # generation and raises NotImplementedError naming A9c; off, the
        # ChipLostError itself propagates (declared degradation).
        self.elastic = bool(elastic)
        self.faults = faults if faults is not None else FaultInjector()
        self._sleep = sleep
        self._prev_handlers: dict = {}
        self._in_move = False
        self._pending_signal: int | None = None
        # True while a dispatch may have half-mutated tally state (set
        # around every supervised body() call): the preemption flush
        # consults it so a signal surfacing on an ERROR path writes the
        # LAST-GOOD generation, never the in-flight rolled-back state.
        self._dirty = False
        #: Recovery accounting: rollbacks (and reshards, 0 on one
        #: device), moves lost to rollback rewinds, and wall-clock
        #: seconds spent inside recovery (classify, probe, rollback,
        #: backoff).
        self.recovery_stats = {
            "rollbacks": 0,
            "reshards": 0,
            "lost_moves": 0,
            "recovery_seconds": 0.0,
        }
        # Failure taxonomy and device health probe; registers the
        # pumi_rollbacks_total / pumi_elastic_reshards_total /
        # pumi_chip_health families on the tally's registry.
        self.coordinator = ResilienceCoordinator(
            tally, faults=self.faults
        )
        r = tally.metrics
        self._c_ckpt = r.counter(
            "pumi_checkpoints_total",
            "checkpoint generations written by the supervisor",
        )
        self._c_retry = r.counter(
            "pumi_move_retries_total",
            "transient move failures retried by the supervisor",
        )
        self._c_resume = r.counter(
            "pumi_resumes_total",
            "startup auto-resumes from a checkpoint generation",
        )
        self._c_fault = r.counter(
            "pumi_injected_faults_total",
            "faults injected through PUMI_TPU_FAULTS (labeled by kind)",
        )
        self._c_shards = r.counter(
            "pumi_checkpoint_shards_written_total",
            "shard files written by sharded (two-phase manifest) "
            "checkpoint generations",
        )

        self.resumed_from: int | None = None
        if resume:
            it = self.store.restore_latest(tally)
            if it is not None:
                self.resumed_from = it
                self._c_resume.inc()
        # Last good state: the transient-retry anchor. Taken whenever
        # the tally holds a consistent post-move (or restored) state.
        self._good = (
            snapshot_state(tally) if self._want_snapshot() else None
        )
        self._last_ckpt_iter = tally.iter_count
        self._last_ckpt_time = time.monotonic()
        if handle_signals:
            self._install_signal_handlers()

    # ------------------------------------------------------------------ #
    # Facade surface
    # ------------------------------------------------------------------ #
    def initialize_particle_location(self, positions, size=None) -> None:
        """Delegates the initial parent-element search; after a resume
        this is a NO-OP (the restored state already holds located
        particles — re-searching would clobber it), so callers can call
        it unconditionally."""
        if self.resumed_from is not None and self.tally._initialized:
            log_info(
                "initialize_particle_location skipped: resumed from "
                f"iteration {self.resumed_from}"
            )
            return
        self.tally.initialize_particle_location(positions, size)
        if self._want_snapshot():
            self._good = snapshot_state(self.tally)
        # Generation 0: guarantees auto-resume has a base to fall back
        # to even if the run dies before the first cadence checkpoint.
        self.checkpoint()

    def move_to_next_location(
        self, particle_destinations, flying, weights, groups,
        material_ids, size=None,
    ) -> None:
        move = self.tally.iter_count + 1
        self.faults.maybe_die(move)
        n_nan = self.faults.corrupt_destinations(
            particle_destinations, move
        )
        if n_nan:
            self._c_fault.inc(n_nan, kind="nan_src")
        self._in_move = True
        try:
            self._move_with_retry(
                move, particle_destinations, flying, weights, groups,
                material_ids, size,
            )
            if self._want_snapshot():
                self._good = snapshot_state(self.tally)
            self._maybe_checkpoint()
        finally:
            self._in_move = False
            if self._pending_signal is not None:
                # A preemption signal landed mid-move: flush and die at
                # the move boundary — whether the move completed (a
                # consistent post-move state) or raised (the last good
                # generation still stands). Swallowing the signal on
                # the error path would leave a process that ignores
                # SIGTERM forever.
                sig, self._pending_signal = self._pending_signal, None
                self._on_signal(sig, None)

    def run_source_moves(self, n_moves, source=None, **kwargs) -> dict:
        """Supervised device-sourced move loop: the tally's
        ``run_source_moves`` under the same transient-retry /
        last-good-rollback / cadence-checkpoint contract as
        ``move_to_next_location``, at MEGASTEP granularity — the call
        is chunked into megastep-K dispatches with the snapshot +
        cadence-checkpoint step BETWEEN dispatches, so a long call
        (n_moves ≫ K) still bounds the retry-replay window and the
        preemption loss window to one megastep. A transient failure
        rolls the in-flight megastep back to the last good snapshot
        and replays it (bitwise identical: the RNG stream is keyed by
        the persisted move counter). There are no out-params to re-arm
        — the megastep's inputs are device-resident state the rollback
        rebuilds. ``weights``/``groups``/``alive`` re-stage on the
        FIRST chunk only; later chunks continue from device state,
        exactly like the facade's own internal chunking."""
        # The facade's own K, so the supervisor's chunks are the
        # facade's chunks.
        k = self.tally.config.resolve_megastep()
        totals = {
            "moves": 0, "segments": 0, "collisions": 0, "escaped": 0,
            "rouletted": 0, "absorbed_weight": 0.0, "alive": 0,
            "truncated": 0,
        }
        done = 0
        first = True
        self._in_move = True
        try:
            while done < int(n_moves):
                chunk = min(k, int(n_moves) - done)
                move = self.tally.iter_count + 1
                self.faults.maybe_die(move)
                out = self._source_chunk_with_retry(
                    move, chunk, source, kwargs if first else {}
                )
                first = False
                done += chunk
                for f in ("moves", "segments", "collisions", "escaped",
                          "rouletted", "truncated"):
                    totals[f] += out[f]
                totals["absorbed_weight"] += out["absorbed_weight"]
                totals["alive"] = out["alive"]
                if self._want_snapshot():
                    self._good = snapshot_state(self.tally)
                self._maybe_checkpoint()
                if out["alive"] == 0 or self._pending_signal is not None:
                    break
            return totals
        finally:
            self._in_move = False
            if self._pending_signal is not None:
                sig, self._pending_signal = self._pending_signal, None
                self._on_signal(sig, None)

    def _retry_loop(self, what: str, body, rearm=None):
        """Shared escalation skeleton for one supervised step. A fatal
        integrity halt and a preemption notice flush the last GOOD
        generation before propagating; every other failure is
        CLASSIFIED by the coordinator: ``transient`` rolls back to the
        last good snapshot and replays with bounded exponential backoff,
        ``chip-lost`` flushes the last good generation and raises.
        ``rearm`` re-seeds caller-owned inputs the step may have mutated
        before failing. The per-move and megastep paths share this so
        the two contracts cannot drift apart."""
        attempt = 0
        while True:
            self._dirty = True
            try:
                out = body()
                self._dirty = False
                return out
            except FatalIntegrityViolation:
                # integrity="halt": flush the last GOOD generation —
                # never the suspect post-violation state — so the
                # campaign can be resumed from verified data, then let
                # the halt propagate.
                self._flush_last_good("integrity", what)
                raise
            except InjectedPreemption:
                # A preemption notice mid-move: same flush discipline
                # as a real SIGTERM on an error path — the generation
                # on disk must be the last GOOD state, never the
                # in-flight one.
                self._flush_last_good("preempted", what)
                raise
            except (ChipLostError,) + RETRYABLE as e:
                attempt += 1
                if isinstance(e, InjectedTransientFault):
                    self._c_fault.inc(kind="transient")
                if isinstance(e, ChipLostError):
                    self._c_fault.inc(kind="chip_down")
                    self.coordinator.note_down(e.chip)
                verdict = self.coordinator.classify(e)
                if verdict == "chip-lost":
                    # Nothing to shrink onto on one device: flush the
                    # last good generation and propagate.
                    self._flush_last_good("chip-lost", what)
                    if self.elastic:
                        raise NotImplementedError(
                            f"chip loss in {what}: elastic recovery "
                            "re-partitions a PartitionedTally onto the "
                            "surviving devices, which is not ported yet "
                            "(ROADMAP.md A9c); the last good generation "
                            "is flushed for the next process to resume"
                        ) from e
                    raise
                if attempt > self.max_retries or self._good is None:
                    # No anchor to roll back to (retry_snapshots off,
                    # or nothing completed yet): an in-place retry
                    # could silently run on a donated/half-updated
                    # accumulator — propagate instead; the next
                    # process's auto-resume is the recovery path.
                    raise
                self._c_retry.inc()
                t0 = time.monotonic()
                iter_before = self.tally.iter_count
                delay = min(
                    self.backoff_base * 2 ** (attempt - 1),
                    self.backoff_max,
                )
                log_warn(
                    f"{what} failed transiently ({e}); restoring "
                    f"last good state and retrying in {delay:.2f}s "
                    f"(attempt {attempt}/{self.max_retries})"
                )
                restore_state(self.tally, self._good)
                self._dirty = False
                self.coordinator.note_rollback("transient")
                self.recovery_stats["rollbacks"] += 1
                if rearm is not None:
                    rearm()
                self._sleep(delay)
                self.recovery_stats["lost_moves"] += max(
                    0, iter_before - self.tally.iter_count
                )
                self.recovery_stats["recovery_seconds"] += (
                    time.monotonic() - t0
                )

    def _flush_last_good(self, cause: str, what: str) -> None:
        """Roll back to the last good snapshot (when the in-flight
        state may be inconsistent) and flush one generation, so the
        failure about to propagate leaves verified data on disk."""
        if self._good is None:
            return
        restore_state(self.tally, self._good)
        self._dirty = False
        self.coordinator.note_rollback(cause)
        self.recovery_stats["rollbacks"] += 1
        try:
            path = self.checkpoint()
            log_warn(
                f"{cause} in {what}: flushed last-good checkpoint "
                f"{path} before raising"
            )
        except Exception as e:  # pragma: no cover - flush best-effort
            log_warn(f"{cause} flush failed: {e}")

    def _source_chunk_with_retry(
        self, move, chunk, source, kwargs
    ) -> dict:
        def body():
            self.faults.maybe_transient(move)
            self.faults.maybe_chip_down(move)
            self.faults.maybe_preempt(move)
            return self.tally.run_source_moves(chunk, source, **kwargs)

        # No out-params to re-arm: the megastep's inputs are
        # device-resident state the rollback rebuilds.
        return self._retry_loop(f"megastep at move {move}", body)

    def _move_with_retry(
        self, move, particle_destinations, flying, weights, groups,
        material_ids, size,
    ) -> None:
        # The facade mutates the caller's out-params (copy-back writes
        # dest/material_ids, zeroes flying) BEFORE its last device
        # fetches can fail — a retry must re-see the ORIGINAL inputs or
        # it would walk zero particles and silently drop the move.
        saved = (
            tuple(
                np.array(a, copy=True)
                for a in (particle_destinations, flying, material_ids)
            )
            if self._good is not None
            else None
        )

        def body():
            self.faults.maybe_transient(move)
            self.faults.maybe_chip_down(move)
            self.faults.maybe_preempt(move)
            self.tally.move_to_next_location(
                particle_destinations, flying, weights, groups,
                material_ids, size,
            )

        def rearm():
            for dst, src in zip(
                (particle_destinations, flying, material_ids),
                saved, strict=True,
            ):
                np.copyto(np.asarray(dst), src)

        self._retry_loop(f"move {move}", body, rearm)

    def _want_snapshot(self) -> bool:
        return (
            self.retry_snapshots
            and self.max_retries > 0
            and self.tally._initialized
        )

    # ------------------------------------------------------------------ #
    # Checkpointing
    # ------------------------------------------------------------------ #
    def checkpoint(self) -> str:
        """Write one generation now (cadence-independent). Re-flushing
        an iteration that already has a VALID generation (a rollback
        flush landing on a cadence write's iteration) is a no-op: the
        runner is its store's single writer and the iteration keys the
        trajectory, so the bytes are already safe."""
        existing = self.store.valid_path_for(self.tally.iter_count)
        if existing is not None:
            self._last_ckpt_iter = self.tally.iter_count
            self._last_ckpt_time = time.monotonic()
            return existing
        path = self.store.save(self.tally)
        if self.faults.corrupt_file(path):
            self._c_fault.inc(kind="corrupt_ckpt")
        if self.faults.maybe_tear(path):
            self._c_fault.inc(kind="torn_shard")
        if self.store.last_shards:
            self._c_shards.inc(self.store.last_shards)
        self._c_ckpt.inc()
        self._last_ckpt_iter = self.tally.iter_count
        self._last_ckpt_time = time.monotonic()
        return path

    def _maybe_checkpoint(self) -> None:
        due = (
            self.every_moves is not None
            and self.tally.iter_count - self._last_ckpt_iter
            >= self.every_moves
        ) or (
            self.every_seconds is not None
            and time.monotonic() - self._last_ckpt_time
            >= self.every_seconds
        )
        if due:
            self.checkpoint()

    # ------------------------------------------------------------------ #
    # Preemption handling
    # ------------------------------------------------------------------ #
    def _install_signal_handlers(self) -> None:
        self._prev_handlers = install_preemption_handlers(
            self._on_signal, "ResilientRunner"
        )

    def _uninstall_signal_handlers(self) -> None:
        uninstall_preemption_handlers(
            self._prev_handlers, mine=self._on_signal
        )
        self._prev_handlers = {}

    def _on_signal(self, signum, frame) -> None:
        """Preemption flush: one final checkpoint, then die the way the
        process would have died without us. Mid-move delivery defers to
        the move boundary so the flushed generation is consistent; if
        that boundary was reached by an ERROR path (retries exhausted
        mid-flight — the dirty flag is still up), the tally is first
        rolled back to the last good snapshot so the flush writes the
        last-GOOD generation, never the in-flight state."""
        if self._in_move:
            self._pending_signal = signum
            return
        if self._dirty and self._good is not None:
            try:
                restore_state(self.tally, self._good)
                self._dirty = False
                self.coordinator.note_rollback("preempted")
                self.recovery_stats["rollbacks"] += 1
            except Exception as e:  # pragma: no cover - best-effort
                log_warn(f"preemption rollback failed: {e}")
        try:
            path = self.checkpoint()
            log_info(
                f"preemption flush: checkpoint {path} written on "
                f"signal {signum}"
            )
        except Exception as e:  # pragma: no cover - flush best-effort
            log_warn(f"preemption flush failed: {e}")
        prev = self._prev_handlers.get(signum)
        self._uninstall_signal_handlers()
        resume_previous_handler(prev, signum, frame)

    # ------------------------------------------------------------------ #
    def close(self, final_checkpoint: bool = True) -> None:
        """Flush a final generation (when anything advanced since the
        last one) and release the signal handlers."""
        if final_checkpoint and self.tally._initialized and (
            self.tally.iter_count != self._last_ckpt_iter
            or not self.store.entries()
        ):
            self.checkpoint()
        self._uninstall_signal_handlers()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # On an exception the tally state may be mid-move; the cadence
        # checkpoints are the trustworthy generations — flush only on
        # clean exit.
        self.close(final_checkpoint=exc_type is None)
        return False

    # ------------------------------------------------------------------ #
    def __getattr__(self, name):
        """Everything else (telemetry, write_pumi_tally_mesh, raw_flux,
        ...) passes through to the wrapped tally."""
        if name == "tally":  # guard pre-__init__ access recursion
            raise AttributeError(name)
        return getattr(self.tally, name)
