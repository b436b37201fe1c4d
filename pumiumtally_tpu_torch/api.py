"""Public facade: the PumiTally class, on PyTorch.

Counterpart of ``pumiumtally_tpu/api.py::PumiTally`` with the same four
entry points and numpy array contracts:

  * ``PumiTally(mesh, num_particles, config, device=...)`` — builds or
    takes the mesh, seeds every particle at element 0's centroid;
  * ``initialize_particle_location(pos, size)`` — the initial parent
    element search, never tallied;
  * ``move_to_next_location(dest, flying, weights, groups, material_ids,
    size)`` — walks every in-flight particle to its destination, scores
    track-length flux, clips at domain and material boundaries, writes the
    final positions and material ids back into the caller's arrays and
    resets ``flying`` to 0;
  * ``write_pumi_tally_mesh(filename)`` — normalizes and writes VTK.

The mesh, the particle state and the flux stay on ``device`` (by default
the CUDA card) between calls. On the card the walk is the CUDA kernel
``csrc/walk.cu``; on the CPU it is the plain PyTorch walk.

How a call moves its data follows ``TallyConfig.io_pipeline``
(``resolve_io_pipeline``), as in the JAX facade:

  * ``"packed"`` (the default): the move's inputs are packed on the host
    into one record of carrier words (``ops/staging.py``), in a pinned
    buffer on the card, copied host→device once with
    ``non_blocking=True``; the walk unpacks it and packs positions,
    material ids, done flags and the stats vector into one readback
    (``walk_cuda.trace_packed``), copied device→host once into a pinned
    buffer and waited on by a CUDA event before the write-back. Packing
    and the write-backs use torch's threaded CPU copies.
  * ``"overlap"``: ``"packed"`` with two pinned buffers per record kind
    used in turns, and the move's telemetry fold (its flight record,
    counters and convergence gauges) deferred past the move: it runs
    after the next call's walk is queued, or at any read of the
    telemetry, as the JAX facade does it.
  * ``"legacy"``: four pageable host→device copies (destinations, flags,
    weights, groups, each converted by numpy first) and one
    device→host copy of the stats, positions and material ids.

``PumiTally.io`` counts the facade's transfers (``h2d_transfers``,
``h2d_bytes``, ``d2h_transfers``, ``d2h_bytes``), and ``telemetry()``'s
totals count the same: a packed move makes one each way, a legacy
move four host→device and one device→host. The ordered walk's own host
reads on the card (the record count in ``ops/walk_cuda.py``, the bucket
information in ``ops/scatter.py``) happen inside the walk wrapper and are
not counted (ROADMAP.md B2). ``PumiTally.step_clock`` set to a
``utils/timing.py::StepClock`` times each host step of a call.

Run statistics and recovery, as in the JAX facade (``TallyConfig``):

  * ``telemetry()`` / ``metrics``: a private registry and flight recorder
    per tally (``obs/telemetry.py``), fed from the stats vector the
    readback already carries: no host read of its own;
  * ``sd_mode="batch"``: moves walk with per-segment squares off (the
    ordered scatter writes even entries only) and each move folds its
    squared bin totals into the odd entries once
    (``core/tally.py::accumulate_batch_squares``);
  * ``convergence=True``: batch statistics on the card
    (``obs/convergence.py``), whose summary rides the packed readback's
    tail; ``end_batch``, ``converged``, ``relative_error``;
  * ``truncation_retries``: truncated lanes are walked again from where
    they stopped with doubled ``max_crossings``
    (``ops/walk.py::rewalk_truncated``) before they count as lost;
  * ``quarantine=True``: lanes with non-finite or absurd inputs are
    parked before the pack (``resilience/quarantine.py``).

The walk's feature tails, as in the JAX facade:

  * ``record_xpoints=K``: ``intersection_points()`` returns the last
    walk's crossing points and counts (the tracer's
    ``getIntersectionPoints()``), in host particle order;
  * ``sort_by_element`` with ``migration_period``: every
    ``migration_period`` moves the particle state is sorted by parent
    element on the card (``torch.argsort(..., stable=True)``, so equal
    elements keep their order and the flux its bits from run to run).
    The device then holds particles in slot order: slot i holds particle
    ``_perm[i]`` (``ParticleState.particle_id``). The packed records are
    permuted on the card (``ops/staging.py``); legacy inputs and
    write-backs, the stored points and ``element_ids`` on the host;
  * ``checkify_invariants``: host inputs must be finite
    (``_check_finite``) and every walk of a call, re-walks included,
    evaluates the walk's invariant checks (``ops/walk.py CHECKS``); a
    violation raises ``WalkInvariantError`` with the JAX message.

``record_xpoints`` and ``checkify_invariants`` force
``io_pipeline="legacy"`` (``TallyConfig.resolve_io_pipeline``).

Integrity, checkpoints and the watchdog, as in the JAX facade:

  * ``integrity="warn" | "retry" | "halt"``: every walk also computes the
    conservation vector on the card (``ops/walk.py::integrity_vector``),
    which rides the move's one readback (no host read of its own); the
    host checks it (``integrity/invariants.py``) and escalates
    (``integrity/policy.py``). ``audit_lanes=K`` walks K sampled lanes
    again every ``audit_every`` moves on a float64 host walker
    (``integrity/audit.py``; one out-of-band gather of the sampled lanes,
    not counted in ``io``). Off, a move runs exactly as without the
    integrity layer;
  * ``move_deadline_s``: each move's walk and readback run on a worker
    thread under a deadline (``integrity/watchdog.py``; the first call of
    each kind, which builds the kernels, runs without one);
  * ``save_checkpoint`` / ``restore_checkpoint``: the JAX package's
    single-file format (``utils/checkpoint.py``), so either package
    restores the other's files; ``resilience/runner.py::ResilientRunner``
    supervises a run with them;
  * ``PUMI_TPU_FAULTS``: the facade's fault hooks (``bitflip_flux``,
    ``sdc_walk``, ``hang_at_move``; ``resilience/faultinject.py``).

The device-sourced move loop, as in the JAX facade:
``run_source_moves(n_moves, source, weights, groups, alive)`` runs the
inner loop of ``models/transport.py`` on the card, in chunks of
``TallyConfig.megastep`` = K moves (``ops/walk.py::megastep``): each move
samples every alive lane's flight (``csrc/source.cu``), walks it and
applies the collision and roulette physics, with the per-lane state and
the flux kept on the card. A chunk copies one tail to the host (its
stats, convergence summary and physics counters) and nothing to the
card: the move counter reaches the sampling kernel as an argument. The
walk's own host reads stay (ROADMAP.md B2), so a chunk is a host loop of
K moves: any K gives the bits of K = 1 and saves no launches.

The tuning database, as in the JAX facade: ``TallyConfig.tuning`` (or
env ``PUMI_TPU_TUNING``) names a ``TUNING_TORCH.json`` that construction
consults once (``tuning/db.py::resolve_tuned``) for this workload's shape
class (``shape_key``, which the flight records carry too). Its ``block``
is the walk kernel's threads per block where neither
``PUMI_TPU_PALLAS_LANE_BLOCK`` nor ``pallas_lane_block`` sets one
(``TallyConfig.resolve_lane_block``, mapped by
``walk_cuda.block_for``); the width rides the instantiations built at
every width, the packed, robust initial search and move without feature
tails, and every other walk runs at 128. Its ``megastep`` is K where
neither ``PUMI_TPU_MEGASTEP`` nor ``megastep`` sets one. Every width and
every K give the same bits, so a tuned run equals the default one.
``compact_stages`` resolves as in the JAX facade ("adaptive" replans once
from the first move's crossings, ``_maybe_replan``) and rides
checkpoints; the walk refills its threads and ignores the schedule.
"""
from __future__ import annotations

import dataclasses
import threading
import warnings

import numpy as np
import torch

from .core.state import ParticleState, make_particle_state, seed_at_element_centroid
from .core.tally import (
    accumulate_batch_squares,
    make_flux,
    normalize_flux_host,
    reaction_rate_host,
)
from .io.vtk import write_flux_vtk
from .mesh.core import TetMesh
from .mesh.io import load_mesh
from .obs.convergence import (
    ConvergenceMonitor,
    ConvState,
    conv_to_dict,
    fold_and_reduce,
    host_relative_error,
)
from .obs.telemetry import TallyTelemetry
from .obs.walk_stats import stats_to_dict
from .ops import staging, walk_cuda
from .ops.staging import HostStager, host_tensor
from .resilience import quarantine
from .tuning.db import resolve_tuned
from .tuning.shapes import classify
from .utils.config import TallyConfig
from .utils.ladder import plan_stages
from .utils.platform import resolve_device
from .utils.timing import StepClock, TallyTimes, clock_step, phase_timer

_NP_DTYPES = {
    torch.float32: np.float32, torch.float64: np.float64,
    torch.int32: np.int32, torch.int64: np.int64,
}


def _check_group_range(group: np.ndarray, n_groups: int) -> None:
    """Host-side group-bounds rejection (the reference hard-asserts on
    device)."""
    if group.size and (group.min() < 0 or group.max() >= n_groups):
        bad = group[(group < 0) | (group >= n_groups)]
        raise ValueError(
            f"energy group indices out of range [0, {n_groups}): "
            f"{np.unique(bad)!r}"
        )


def _out_param(arr, name: str, expected_dtypes, min_size: int) -> np.ndarray:
    """Validate an out-param array the way the reference's raw-pointer ABI
    implies: writable, C-contiguous, correctly typed and sized. Returns a
    flat view that shares memory with the caller's array."""
    if not isinstance(arr, np.ndarray):
        raise TypeError(
            f"{name} must be a numpy.ndarray (it is written back in place); "
            f"got {type(arr).__name__}"
        )
    if arr.dtype not in [np.dtype(d) for d in expected_dtypes]:
        raise TypeError(
            f"{name} must have dtype in {expected_dtypes}, got {arr.dtype}"
        )
    if not arr.flags.writeable:
        raise ValueError(f"{name} must be writable (it is an out-param)")
    flat = arr.reshape(-1)
    if flat.size < min_size:
        raise ValueError(f"{name} must hold {min_size} entries, got {flat.size}")
    if not np.shares_memory(flat, arr):
        raise ValueError(
            f"{name} must be C-contiguous so in-place write-back reaches the "
            "caller's buffer"
        )
    return flat


def _convert(host: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """A contiguous host copy of ``host`` in the walk's dtype."""
    return np.ascontiguousarray(host, _NP_DTYPES[dtype])


def _particle_order(slots: np.ndarray, perm) -> np.ndarray:
    """Per-slot host values in particle order: slot i holds particle
    ``perm[i]`` (None: the identity)."""
    if perm is None:
        return slots
    out = np.empty_like(slots)
    out[perm] = slots
    return out


def _present(*tensors) -> list:
    """The tensors that are not None."""
    return [t for t in tensors if t is not None]


def _to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Bring several tensors to the host in ONE copy: their bytes are
    concatenated on the device, copied, and split into numpy views."""
    raw = torch.cat(
        [t.contiguous().view(-1).view(torch.uint8) for t in tensors]
    ).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        out.append(
            raw[off:off + nbytes].view(_NP_DTYPES[t.dtype]).reshape(t.shape)
        )
        off += nbytes
    return out


def flip_largest(flux: torch.Tensor) -> None:
    """Flip, in place through an integer view, the sign bit of the entry
    of largest magnitude of a flat accumulator (the first, on a tie), or
    write NaN into entry 0 of an empty one: the fault the flux check must
    catch."""
    j = int(torch.argmax(flux.abs()))
    it = {torch.float32: torch.int32, torch.float64: torch.int64}[flux.dtype]
    bits = flux.view(it)
    if float(flux[j]) == 0.0:
        bits[j] = int(torch.tensor(float("nan"), dtype=flux.dtype).view(it))
    else:
        bits[j] ^= torch.iinfo(it).min


class PumiTally:
    """Track-length flux tally on an unstructured tet mesh."""

    def __init__(
        self,
        mesh: TetMesh | str,
        num_particles: int,
        config: TallyConfig | None = None,
        *,
        device=None,
    ):
        self.config = config or TallyConfig()
        cfg = self.config
        self.device = resolve_device(device)
        self.tally_times = TallyTimes()
        # A private registry and flight recorder per tally; every walk
        # folds its stats vector here.
        self._telemetry = TallyTelemetry("PumiTally")
        with phase_timer(
            self.tally_times, "initialization_time", True
        ) as timer:
            if isinstance(mesh, str):
                mesh = load_mesh(mesh, dtype=cfg.dtype, device=self.device)
            if mesh.dtype != cfg.dtype:
                raise ValueError(
                    f"mesh dtype {mesh.dtype} != config dtype {cfg.dtype}"
                )
            if mesh.device != self.device:
                raise ValueError(
                    f"mesh is on {mesh.device}, the tally on {self.device}"
                )
            self.mesh = mesh
            self.num_particles = int(num_particles)
            self._max_crossings = cfg.resolve_max_crossings(mesh.ntet)
            self._io = cfg.resolve_io_pipeline()
            # The compaction schedule as the JAX facade resolves it; the
            # walk ignores it ("adaptive" replans after the first move).
            self._compact_stages = cfg.resolve_compact_stages(
                self.num_particles, ntet=mesh.ntet)
            self._replanned = cfg.compact_stages != "adaptive"
            # The tuning database, consulted once here for the knobs no
            # env variable or field sets; a miss (or no database)
            # changes nothing.
            packed = mesh.geo20 is not None
            self._tuned = resolve_tuned(
                cfg, ntet=mesh.ntet, n_particles=self.num_particles,
                n_groups=cfg.n_groups, dtype=cfg.dtype, packed=packed,
                device=self.device)
            self.shape_key = classify(mesh.ntet, self.num_particles,
                                      cfg.n_groups, cfg.dtype, packed).key()
            # The walk-backend knobs, validated and refused as in the JAX
            # facade's construction; the port has one walk either way, and
            # the block width is its threads per block on the card.
            self._kernel_policy = cfg.resolve_kernel()
            self._lane_block = cfg.resolve_lane_block(self.num_particles,
                                                      tuned=self._tuned)
            self._block = walk_cuda.launch_block(
                self._lane_block, packed=packed, robust=cfg.robust,
                feature=(cfg.record_xpoints is not None
                         or cfg.checkify_invariants))
            self._stager = HostStager(
                depth=2 if self._io == "overlap" else 1, device=self.device
            )
            self.state: ParticleState = seed_at_element_centroid(
                make_particle_state(
                    self.num_particles, cfg.dtype, device=self.device
                ),
                mesh,
            )
            self.flux = make_flux(
                mesh.ntet, cfg.n_groups, cfg.dtype, device=self.device
            )
            nbins = mesh.ntet * cfg.n_groups
            # sd_mode="batch": the even (Σc) entries as of the previous
            # move, for the per-move squared-delta fold. score_squares=
            # False means no squares work at all, in either mode.
            self._prev_even = (
                torch.zeros(nbins, dtype=cfg.dtype, device=self.device)
                if cfg.sd_mode == "batch" and cfg.score_squares
                else None
            )
            # Convergence: the batch accumulators on the card and the
            # monitor that feeds the gauges; None when off.
            self._batch_moves = cfg.resolve_convergence()
            self._conv: ConvState | None = None
            self._monitor: ConvergenceMonitor | None = None
            if self._batch_moves is not None:
                self._conv = ConvState.zeros(nbins, cfg.dtype, self.device)
                self._monitor = ConvergenceMonitor(
                    self._telemetry,
                    rel_err_target=cfg.rel_err_target,
                    converged_fraction=cfg.converged_fraction,
                    batch_moves=self._batch_moves,
                )
            # Bad-particle quarantine: per-lane counts and the
            # out-of-mesh threshold (host numpy).
            self._quarantined: np.ndarray | None = None
            if cfg.quarantine:
                quarantine.setup(self, mesh.coords.cpu().numpy(),
                                 self.num_particles)
            # Telemetry folds deferred by io_pipeline="overlap", in call
            # order.
            self._pending_folds: list = []
            # Integrity layer: the escalation mode, the checks'
            # tolerances, the shadow audit's host walker and the
            # facade's fault hooks (bitflip_flux, sdc_walk, hang_at_move
            # target its detectors). None or off by default: a move then
            # runs as without it.
            self._integrity = cfg.resolve_integrity()
            self._finj = None
            self._auditor = None
            # Kinds of call (init, move, megastep:k) whose first,
            # un-deadlined call has run.
            self._watchdog_warm: set = set()
            if (self._integrity != "off" or cfg.audit_lanes
                    or cfg.move_deadline_s is not None):
                from .integrity import invariants
                from .resilience.faultinject import FaultInjector

                self._finj = FaultInjector()
                scale = invariants.mesh_scale(mesh.coords.cpu().numpy())
                self._integrity_tol = invariants.conservation_tolerance(
                    cfg.integrity_tol, cfg.dtype, scale, cfg.tolerance)
                self._audit_tol = invariants.audit_tolerance(
                    cfg.audit_tol, cfg.dtype, scale, cfg.tolerance)
            if cfg.audit_lanes:
                from .integrity.audit import HostReference

                self._auditor = HostReference(mesh)
            self.iter_count = 0
            self.total_segments = 0
            # Host view of the last walk's stats vector (None with
            # walk_stats=False).
            self.last_stats: dict | None = None
            # Scored segments of the last move: the ordered walk makes at
            # most one tally record per segment, so the next move's record
            # buffers are sized from it. Before the first move they are
            # sized from the face rate and the path from the initial
            # search's destinations (a host copy).
            self._last_segments: int | None = None
            self._face_rate = walk_cuda.face_rate(mesh)
            # The last megastep walk's tally records on the card (the next
            # chunk's first record buffers are sized from it).
            self._mega_records: int | None = None
            self._origin_h: np.ndarray | None = None
            self._initialized = False
            # The element sort's slot permutation: slot i holds particle
            # _perm[i] (host) / _perm_dev[i] (the card, int64); None
            # while the layout is the identity. Both are taken from
            # state.particle_id when a sort fires, never per move.
            self._perm: np.ndarray | None = None
            self._perm_dev: torch.Tensor | None = None
            self._traces_since_sort = 0
            # record_xpoints: the last walk's (points, counts) and the
            # permutation of its slots, on the card until
            # intersection_points() asks for them.
            self._last_xpoints: tuple | None = None
            # Host↔device transfers the facade made (the telemetry
            # totals count the same).
            self.io = dict(h2d_transfers=0, h2d_bytes=0, d2h_transfers=0,
                           d2h_bytes=0)
            # Set to a StepClock to time each host step of the calls.
            self.step_clock: StepClock | None = None
            timer.sync(self.device)
        # Phase-boundary memory sample (construction allocated the mesh
        # tables and the flux).
        self._telemetry.record_memory("initialization")

    # ------------------------------------------------------------------ #
    def _walk_kw(self, initial: bool) -> dict:
        cfg = self.config
        return dict(
            initial=initial,
            max_crossings=self._max_crossings,
            n_groups=cfg.n_groups,
            # sd_mode="batch" skips the per-segment squares; each move
            # folds its squared bin totals instead.
            score_squares=cfg.score_squares and (
                initial or cfg.sd_mode == "segment"),
            tolerance=cfg.tolerance,
            robust=cfg.robust,
            ledger=cfg.ledger,
            stats=cfg.walk_stats,
            record_xpoints=cfg.record_xpoints,
            debug_checks=cfg.checkify_invariants,
            integrity=self._integrity != "off",
            block=self._block,
        )

    def _maybe_replan(self, n_segments: int, n_moving: int) -> None:
        """compact_stages="adaptive": after the first move, plan the
        ladder again from the measured crossings a move (a mover scores
        crossings + 1 segments) instead of the mesh-density estimate, as
        the JAX facade does. The port's walk ignores the schedule, so
        only the facade's state (and its checkpoints) change."""
        if self._replanned or n_moving == 0:
            return
        self._replanned = True
        if self.num_particles < 1024:
            return  # tiny batches stay on the flat loop
        mean = max(n_segments / n_moving - 1.0, 0.25)
        self._compact_stages = plan_stages(
            self.num_particles, mean, unroll=self.config.unroll) or None

    def _trace(self, *args, _packed: bool = False, **kwargs):
        """The facade's one walk entry for its initial search and moves:
        ``walk_cuda.trace_packed`` (``_packed``) or ``walk_cuda.trace``,
        so a wrapper around it sees packed and legacy moves alike."""
        if _packed:
            return walk_cuda.trace_packed(*args, **kwargs)
        return walk_cuda.trace(*args, **kwargs)

    def _dispatch(self, fn, move: int, kind: str | None = None):
        """Run one call's device work, ``fn`` (the walk and its blocking
        readback), under the watchdog deadline when
        ``TallyConfig.move_deadline_s`` is set (``integrity/watchdog.py``).
        ``fn`` must not mutate facade state: after a timeout its
        abandoned thread may still finish, and nothing applies that; the
        supervisor's rollback assigns fresh tensors.

        The worker thread runs on the caller's CUDA stream, so the
        record's host→device copy, the walk and the readback stay
        ordered as on the calling thread, and the caller returns only
        after the readback's event. The first call of each kind (initial
        search, move, megastep chunk length) runs without a deadline: it
        builds the kernels. After a timeout the facade takes fresh host
        staging buffers (the abandoned worker may still write the old
        ones), and an injected hang that outlived its deadline runs no
        device work."""
        if self.config.move_deadline_s is None:
            return fn()
        key = kind or ("init" if move == 0 else "move")
        abandoned = threading.Event()
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def body():
            if self._finj is not None and self._finj.maybe_hang(move):
                self._count_fault("hang")
            if abandoned.is_set():
                return None
            if stream is None:
                return fn()
            with torch.cuda.device(self.device), torch.cuda.stream(stream):
                return fn()

        if key not in self._watchdog_warm:
            self._watchdog_warm.add(key)
            return body()
        from .integrity.watchdog import DispatchTimeoutError, run_with_deadline

        try:
            return run_with_deadline(body, self.config.move_deadline_s)
        except DispatchTimeoutError:
            abandoned.set()
            self._stager = HostStager(depth=self._stager.depth,
                                      device=self.device)
            self._telemetry.record_integrity(move, {}, ["watchdog"])
            raise

    def _count_fault(self, kind: str) -> None:
        self.metrics.counter(
            "pumi_injected_faults_total",
            "faults injected through PUMI_TPU_FAULTS (labeled by kind)",
        ).inc(kind=kind)

    def _self_verify(self, move, integ, fly_h, n_lost, s_before, result,
                     dest_dev, done_h, pos_out) -> None:
        """Check the move's integrity vector and, every ``audit_every``
        moves, a shadow audit, and escalate per ``TallyConfig.integrity``
        (the JAX facade's ``_self_verify``). Violations are counted and
        recorded before the policy escalates, so "warn" and "halt" leave
        the same telemetry."""
        cfg = self.config
        if self._integrity == "off" and not cfg.audit_lanes:
            return
        from .integrity import invariants, policy

        fields: dict = {}
        violations: list = []
        if integ is not None:
            fields = invariants.integrity_to_dict(integ)
            violations += invariants.check_move(
                fields, np.count_nonzero(fly_h), int(n_lost),
                self._integrity_tol)
        if (cfg.audit_lanes and self._auditor is not None and move >= 1
                and move % cfg.audit_every == 0):
            out = self._run_audit(move, s_before, result, dest_dev, fly_h,
                                  done_h, pos_out)
            if out is not None:
                self._telemetry.record_audit(
                    move, out.audited, out.mismatches, out.skipped,
                    out.max_dev)
                if out.mismatches:
                    violations.append("sdc_audit")
        if fields or violations:
            self._telemetry.record_integrity(move, fields, violations)
        policy.escalate(self._integrity, violations, move)

    def _run_audit(self, move, s_before, result, dest_dev, fly_h, done_h,
                   pos_out):
        """Shadow-audit one move (``integrity/audit.py``): sample up to
        ``audit_lanes`` lanes that flew and finished, as the JAX facade
        does (``np.random.default_rng([audit_seed, move])`` over the same
        candidates, so both packages audit the same lanes), gather their
        pre-move state and the walk's outputs on the card into one small
        device→host copy, walk them again in float64 on the host and
        compare. ``done_h`` is the readback's done words (nonzero: done,
        particle order), or None under legacy I/O (the done flags are
        read here)."""
        cfg = self.config
        if done_h is None:
            done_h = _particle_order(result.done.cpu().numpy(), self._perm)
        cand = np.nonzero(fly_h & (done_h != 0))[0]
        if cand.size == 0:
            return None
        rng = np.random.default_rng([cfg.audit_seed, int(move)])
        pids = rng.choice(cand, size=min(cfg.audit_lanes, cand.size),
                          replace=False)
        if self._perm is None:
            slots = pids
        else:
            inv = np.empty(self.num_particles, np.int64)
            inv[self._perm] = np.arange(self.num_particles)
            slots = inv[pids]
        sl = torch.as_tensor(slots, device=self.device)
        origins, elems, dests, track = _to_host(
            s_before.origin[sl], s_before.elem[sl], dest_dev[sl],
            result.track_length[sl])
        track = track.astype(np.float64)
        prod_pos = np.asarray(pos_out[pids], np.float64)
        if self._finj is not None and self._finj.sdc_at(move):
            # Injected SDC: one mis-scored segment on the first sampled
            # lane; the float64 walk must flag it.
            track[0] += 1e3 * self._audit_tol
            self._count_fault("sdc_walk")
        from .integrity.audit import audit_sample

        return audit_sample(
            self._auditor, origins.astype(np.float64),
            dests.astype(np.float64), elems, prod_pos, track,
            tolerance=cfg.tolerance, max_crossings=self._max_crossings,
            tol=self._audit_tol,
        )

    def _maybe_inject_bitflip(self, move: int) -> None:
        """``PUMI_TPU_FAULTS=bitflip_flux:K``: after move K flip the sign
        bit of the flux entry of largest magnitude (``flip_largest``), the
        JAX hook's bit on the JAX hook's entry. The next move's flux check
        must catch it."""
        if self._finj is None or not self._finj.bitflip_at(move):
            return
        flip_largest(self.flux)
        self._count_fault("bitflip_flux")

    def _record_capacity(self, dest, in_flight) -> int:
        """Tally records the ordered walk's buffers hold for this move
        (``walk_cuda.record_capacity``; a walk that makes more runs
        again). The estimate is the last move's segments; before the first
        move, ``walk_cuda.path_records`` from the initial search's
        destinations. ``dest`` and ``in_flight`` are on the host (numpy
        arrays or CPU tensors), so the estimate reads nothing from the
        card."""
        if self._last_segments is not None:
            est = self._last_segments
        else:
            est = walk_cuda.path_records(self._face_rate, self._origin_h,
                                         dest, in_flight)
        return walk_cuda.record_capacity(self.num_particles, est)

    def _step(self, name: str):
        """The context of one timed host step (nothing without a clock)."""
        return clock_step(self.step_clock, name)

    def _count(self, way: str, nbytes: int) -> None:
        self.io[f"{way}_transfers"] += 1
        self.io[f"{way}_bytes"] += int(nbytes)

    def _io_since(self, before: dict) -> dict:
        """The transfers made since ``before`` (a copy of ``self.io``)."""
        return {k: v - before[k] for k, v in self.io.items()}

    def _put(self, host: np.ndarray) -> torch.Tensor:
        """Host→device copy of one per-particle input array (legacy), in
        device slot order (``_gather_in``)."""
        host = np.ascontiguousarray(self._gather_in(host))
        self._count("h2d", host.nbytes)
        return torch.from_numpy(host).to(self.device)

    def _gather_in(self, host: np.ndarray) -> np.ndarray:
        """Per-particle host input in device slot order."""
        return host if self._perm is None else host[self._perm]

    def _check_finite(self, name: str, arr: np.ndarray) -> None:
        """``checkify_invariants``: refuse non-finite host inputs."""
        if self.config.checkify_invariants and not np.isfinite(arr).all():
            raise ValueError(f"{name} contains non-finite values")

    def _to_host(self, *tensors: torch.Tensor) -> list[np.ndarray]:
        """``_to_host``, counted as one device→host transfer (legacy)."""
        self._count("d2h", sum(t.numel() * t.element_size()
                               for t in tensors))
        return _to_host(*tensors)

    def _count_to_host(self, host: list) -> None:
        """Count a legacy walk's one device→host copy, made by the module's
        ``_to_host`` inside the dispatched step."""
        self._count("d2h", sum(a.nbytes for a in host))

    def _put_record(self, rec: torch.Tensor) -> torch.Tensor:
        """The packed record's one host→device copy."""
        self._count("h2d", rec.numel() * rec.element_size())
        return rec.to(self.device, non_blocking=True)

    def _views(self, host: torch.Tensor, convergence: bool = False):
        """Count a packed readback's device→host copy (made by
        ``staging.to_host``) and return its parts as views
        (``staging.readback_views``: positions, material ids, done words,
        tail, integrity vector or None, convergence summary or None)."""
        self._count("d2h", host.numel() * host.element_size())
        return staging.readback_views(
            host, self.num_particles, self.config.dtype,
            self._integrity != "off", convergence)

    def _packed_summary(self, tail: np.ndarray, done_words: np.ndarray):
        """The legacy summary from a packed readback: the stats vector, or
        (segments, truncated) when walk_stats is off."""
        if self.config.walk_stats:
            return tail
        return np.array([tail[0], np.count_nonzero(done_words == 0)])

    def _summary(self, result) -> torch.Tensor:
        """The device vector the host reads after a walk: the [8] stats
        vector, or (segments, truncated) when walk_stats is off."""
        if result.stats is not None:
            return result.stats
        return torch.stack(
            [result.n_segments, (~result.done).sum(dtype=torch.int64)]
        )

    def _read_summary(self, summary: np.ndarray):
        """A walk's host summary as ``(stats dict or None, segments,
        truncated lanes)``; sets ``last_stats``."""
        if self.config.walk_stats:
            self.last_stats = stats_to_dict(summary)
            return (self.last_stats, self.last_stats["segments"],
                    self.last_stats["truncated"])
        return None, int(summary[0]), int(summary[1])

    def _warn_if_truncated(self, n_lost: int) -> None:
        if n_lost:
            warnings.warn(
                f"{n_lost} particle walk(s) truncated at max_crossings="
                f"{self._max_crossings}; tallies for them are incomplete. "
                "Raise TallyConfig.max_crossings or set "
                "truncation_retries for bounded re-walk escalation.",
                RuntimeWarning,
                stacklevel=3,
            )

    def _escalate_truncated(self, result, dest, weight, group, n_tr: int,
                            kw: dict, move: int, packed: bool):
        """Truncation escalation (``TallyConfig.truncation_retries``):
        walk the truncated lanes again from the device-resident result
        with doubled ``max_crossings`` (``ops/walk.py::rewalk_truncated``)
        before declaring them lost. After a re-walk the host views are
        refreshed by one more device→host copy: a packed readback
        (``packed``; no convergence tail, the move's summary stands) or
        the legacy summary, positions, material ids and integrity vector
        (None with integrity off). Returns ``(result, refreshed views or
        None, n_lost)``."""
        if not n_tr:
            return result, None, 0
        n_lost, n_retried, parts = n_tr, 0, None
        if self.config.truncation_retries > 0:
            kw = {k: v for k, v in kw.items() if k != "capacity"}
            result, n_retried, n_lost = walk_cuda.rewalk_truncated(
                self.mesh, result, dest, weight, group,
                retries=self.config.truncation_retries, **kw,
            )
            if packed:
                parts = self._views(staging.to_host(
                    self._stager,
                    staging.pack_trace_readback(
                        result.position, result.material_id, result.done,
                        result.stats, result.n_segments, self._perm_dev,
                        integrity=result.integrity),
                    "rewalk"))[:5]
            else:
                summary, pos, mats, *integ = self._to_host(
                    self._summary(result), result.position,
                    result.material_id, *_present(result.integrity))
                parts = (summary, pos, mats, integ[0] if integ else None)
        if n_retried or n_lost:
            self._telemetry.record_rewalk(move, n_retried, n_lost)
        return result, parts, n_lost

    def _store_xpoints(self, result) -> None:
        """Keep the walk's crossing points and counts, with the
        permutation of that walk (a later sort must not re-map them); they
        stay on the card until ``intersection_points`` reads them."""
        if result.xpoints is not None:
            self._last_xpoints = (result.xpoints, result.n_xpoints,
                                  self._perm)

    def _resort_by_element(self) -> None:
        """The periodic locality sort (the reference's migrate-every-100):
        the particle state sorted by parent element on the card, stably,
        so equal elements keep their slot order and the ordered tally's
        keys, and with them the flux's bits, are the same from run to
        run. The permutation is taken from ``state.particle_id`` (one
        device→host copy). Skipped when no walk ran since the last sort:
        the elements cannot have changed."""
        if self._traces_since_sort == 0:
            return
        s = self.state
        order = torch.argsort(s.elem, stable=True)
        self.state = type(s)(**{f.name: getattr(s, f.name)[order]
                                for f in dataclasses.fields(s)})
        self._traces_since_sort = 0
        (self._perm,) = self._to_host(self.state.particle_id)
        self._perm_dev = self.state.particle_id.long()

    def _fold(self, fold) -> None:
        """Run a telemetry fold now, or after the next call's walk under
        ``io_pipeline="overlap"``."""
        if self._io == "overlap":
            self._pending_folds.append(fold)
        else:
            fold()

    def _drain_pending(self) -> None:
        """Run the deferred telemetry folds in call order (after the next
        move's walk is queued, and at every read of the telemetry)."""
        pending, self._pending_folds = self._pending_folds, []
        for fold in pending:
            fold()

    # ------------------------------------------------------------------ #
    def initialize_particle_location(
        self, init_particle_positions: np.ndarray, size: int | None = None
    ) -> None:
        """Fly all particles from their current positions (element 0's
        centroid after construction) to their source positions to find
        their parent elements; nothing is tallied."""
        pos = np.ascontiguousarray(
            init_particle_positions, dtype=np.float64
        ).reshape(-1)
        if size is None:
            size = pos.size
        n = self.num_particles
        if size != n * 3:
            raise ValueError(f"expected {n * 3} coordinates, got {size}")
        cfg = self.config
        pos3 = pos[:size].reshape(n, 3)
        fly_h = np.ones(n, bool)
        qmask = None
        if cfg.quarantine:
            pos3, _, qmask = quarantine.apply(self, pos3, None, 0)
            if qmask is not None:
                fly_h &= ~qmask  # masked lanes stay at the seed
        self._check_finite("init_particle_positions", pos3)
        self._origin_h = pos3.copy()
        s = self.state
        io0 = dict(self.io)
        t_before = self.tally_times.initialization_time
        with phase_timer(
            self.tally_times, "initialization_time", True
        ) as timer:
            kw = self._walk_kw(True)
            packed = self._io != "legacy"
            # The walk's inputs, bound now: an abandoned watchdog worker
            # must walk into these, never into what a rollback restored.
            flux_in, perm_in, stager = self.flux, self._perm_dev, self._stager
            if packed:
                rec = staging.pack_init_record(
                    self._stager, pos3, fly_h, cfg.dtype
                )
                rec_dev = self._put_record(rec)

                def walk():
                    out = self._trace(
                        self.mesh, s.origin, s.elem, s.material_id, rec_dev,
                        flux_in, perm_in, weight=s.weight, group=s.group,
                        _packed=True, **kw,
                    )
                    return out, staging.to_host(stager, out[1], "readback")

                (r, _, dest, _, _, _), host = self._dispatch(walk, 0)
                _, _, done_h, tail, integ, _ = self._views(host)
                summary = self._packed_summary(tail, done_h)
            else:
                dest = self._put(_convert(pos3, cfg.dtype))
                fly = (torch.ones(n, dtype=torch.bool, device=self.device)
                       if qmask is None else self._put(fly_h))

                def walk():
                    r = self._trace(
                        self.mesh, s.origin, dest, s.elem, fly, s.weight,
                        s.group, s.material_id, flux_in, **kw,
                    )
                    return r, _to_host(self._summary(r),
                                       *_present(r.integrity))

                r, host = self._dispatch(walk, 0)
                self._count_to_host(host)
                summary, *rest = host
                integ = rest[0] if rest else None
            stats_d, _, n_tr = self._read_summary(summary)
            r, parts, n_lost = self._escalate_truncated(
                r, dest, s.weight, s.group, n_tr, kw, 0, packed=packed)
            if parts is not None:
                stats_d, _, _ = self._read_summary(
                    self._packed_summary(parts[3], parts[2])
                    if packed else parts[0])
                integ = parts[4] if packed else parts[3]
            self.flux = r.flux
            self.state = s.replace(origin=r.position, dest=dest, elem=r.elem)
            self._traces_since_sort += 1
            self._store_xpoints(r)
            self._initialized = True
            self._warn_if_truncated(n_lost)
            # The search scores nothing: the flux must stay clean and
            # the lane counts close (the audit starts with move 1).
            self._self_verify(0, integ, fly_h, n_lost, s, r, dest, None,
                              None)
            if cfg.measure_time:
                timer.sync(self.device)
        self._telemetry.record_walk(
            "initial_search", 0, stats_d,
            seconds=self.tally_times.initialization_time - t_before,
            synced=cfg.measure_time, shape_key=self.shape_key,
            **self._io_since(io0),
        )

    def move_to_next_location(
        self,
        particle_destinations: np.ndarray,
        flying: np.ndarray,
        weights: np.ndarray,
        groups: np.ndarray,
        material_ids: np.ndarray,
        size: int | None = None,
    ) -> None:
        """Advance every in-flight particle to its destination, tally flux,
        and write the (possibly boundary-clipped) final positions and
        material ids back into the caller's arrays; ``flying`` is reset to
        0."""
        if not self._initialized:
            raise RuntimeError(
                "initialize_particle_location must run before moves"
            )
        n = self.num_particles
        cfg = self.config
        step = self._step
        with step("checks"):
            dest_flat = _out_param(
                particle_destinations, "particle_destinations", [np.float64],
                n * 3,
            )
            if size is None:
                size = dest_flat.size
            if size != n * 3:
                raise ValueError(f"expected {n * 3} coordinates, got {size}")
            flying_flat = _out_param(flying, "flying", [np.int8], n)
            mats_flat = _out_param(material_ids, "material_ids", [np.int32],
                                   n)
            weights_h = np.asarray(weights, dtype=np.float64).reshape(-1)[:n]
            groups_h = np.asarray(groups, dtype=np.int32).reshape(-1)[:n]
            _check_group_range(groups_h, cfg.n_groups)
            fly_h = flying_flat[:n] != 0
            # The caller's buffer, written back at the end of the move;
            # dest_in is what the walk is given (a sanitized copy when the
            # quarantine parks a lane).
            dest3_h = dest_flat[: n * 3].reshape(n, 3)
            dest_in = dest3_h
        if cfg.quarantine:
            with step("quarantine"):
                dest_in, weights_h, qmask = quarantine.apply(
                    self, dest3_h, weights_h, self.iter_count + 1)
                if qmask is not None:
                    fly_h = fly_h & ~qmask  # quarantined lanes are parked
        self._check_finite("particle_destinations", dest_in)
        self._check_finite("weights", weights_h)

        io0 = dict(self.io)
        t_before = self.tally_times.total_time_to_tally
        move = self.iter_count + 1
        # Movers for the one-shot adaptive replan (only while it waits).
        n_moving = int(fly_h.sum()) if not self._replanned else 0
        with phase_timer(
            self.tally_times, "total_time_to_tally", True
        ) as timer:
            s = self.state
            with step("capacity"):
                kw = dict(self._walk_kw(False),
                          capacity=self._record_capacity(dest_in, fly_h))
            # The convergence fold rides the move's main walk only: the
            # re-walks score into the same flux, and the next batch's
            # delta picks their scores up.
            ckw = {}
            if self._conv is not None:
                ckw = dict(conv_state=self._conv,
                           batch_moves=self._batch_moves,
                           rel_err_target=cfg.rel_err_target)
            conv_h = None
            # The walk's inputs, bound now: an abandoned watchdog worker
            # must walk into these, never into what a rollback restored.
            flux_in, perm_in, stager = self.flux, self._perm_dev, self._stager
            deadline = cfg.move_deadline_s is not None
            if self._io != "legacy":
                with step("pack"):
                    rec = staging.pack_move_record(
                        self._stager, dest_in, weights_h, groups_h, fly_h,
                        cfg.dtype,
                    )
                with step("put record"):
                    rec_dev = self._put_record(rec)

                def walk():
                    with step("walk"):
                        out = self._trace(
                            self.mesh, s.origin, s.elem, s.material_id,
                            rec_dev, flux_in, perm_in, _packed=True, **kw,
                            **ckw,
                        )
                    if self._io == "overlap" and not deadline:
                        # The previous move's telemetry fold, while this
                        # move's work runs on the card (after the step
                        # under a deadline: the step mutates nothing).
                        with step("deferred fold"):
                            self._drain_pending()
                    with step("readback"):
                        host = staging.to_host(stager, out[1], "readback")
                    return out, host

                out, host = self._dispatch(walk, move)
                r, _, dest, in_flight, weight, group = out
                if self._io == "overlap" and deadline:
                    with step("deferred fold"):
                        self._drain_pending()
                final_pos, final_mats, done_h, tail, integ, conv_h = (
                    self._views(host, convergence=self._conv is not None))
                stats_d, segs, n_tr = self._read_summary(
                    self._packed_summary(tail, done_h))
                with step("escalate"):
                    r, parts, n_lost = self._escalate_truncated(
                        r, dest, weight, group, n_tr, kw, move, packed=True)
                if parts is not None:
                    final_pos, final_mats, done_h, tail, integ = parts
                    stats_d, segs, _ = self._read_summary(
                        self._packed_summary(tail, done_h))
                with step("write-back"):
                    # Copy-back contract: clipped final positions and
                    # material ids into the caller's arrays, flying flags
                    # reset to 0 (threaded torch copies, the first a cast).
                    host_tensor(dest3_h).copy_(torch.from_numpy(final_pos))
                    host_tensor(mats_flat[:n]).copy_(
                        torch.from_numpy(final_mats)
                    )
                    flying_flat[:n] = 0
            else:
                with step("convert"):
                    dest_c = _convert(dest_in, cfg.dtype)
                    weight_c = _convert(weights_h, cfg.dtype)
                    group_c = np.ascontiguousarray(groups_h)
                with step("put dest"):
                    dest = self._put(dest_c)
                with step("put flying"):
                    in_flight = self._put(fly_h)
                with step("put weight"):
                    weight = self._put(weight_c)
                with step("put group"):
                    group = self._put(group_c)
                conv_in = self._conv

                def walk():
                    with step("walk"):
                        r = self._trace(
                            self.mesh, s.origin, dest, s.elem, in_flight,
                            weight, group, s.material_id, flux_in, **kw,
                        )
                        extra = _present(r.integrity)
                        if conv_in is not None:
                            extra.append(fold_and_reduce(r.flux, conv_in, **{
                                k: v for k, v in ckw.items()
                                if k != "conv_state"}))
                    with step("to_host"):
                        host = _to_host(self._summary(r), r.position,
                                        r.material_id, *extra)
                    return r, host

                r, host = self._dispatch(walk, move)
                self._count_to_host(host)
                summary, final_pos, final_mats, *rest = host
                integ = rest.pop(0) if r.integrity is not None else None
                if rest:
                    conv_h = rest[0].astype(np.float64)
                stats_d, segs, n_tr = self._read_summary(summary)
                with step("escalate"):
                    r, parts, n_lost = self._escalate_truncated(
                        r, dest, weight, group, n_tr, kw, move,
                        packed=False)
                if parts is not None:
                    summary, final_pos, final_mats, integ = parts
                    stats_d, segs, _ = self._read_summary(summary)
                done_h = None
                with step("write-back"):
                    # Copy-back contract, as above (numpy casts), from
                    # slot order into particle order.
                    if self._perm is None:
                        dest3_h[:] = final_pos
                        mats_flat[:n] = final_mats
                    else:
                        dest3_h[self._perm] = final_pos
                        mats_flat[:n][self._perm] = final_mats
                    flying_flat[:n] = 0
            self.flux = r.flux
            if self._prev_even is not None:
                with step("batch squares"):
                    accumulate_batch_squares(self.flux, self._prev_even)
            self.state = s.replace(
                origin=r.position,
                dest=dest,
                in_flight=in_flight,
                weight=weight,
                group=group,
                elem=r.elem,
                material_id=r.material_id,
            )
            self.iter_count += 1
            self._traces_since_sort += 1
            self._last_segments = segs
            self.total_segments += segs
            self._maybe_replan(segs, n_moving)
            self._store_xpoints(r)
            # The truncation warning stays in the call in every mode;
            # only the telemetry fold is deferred under "overlap".
            self._warn_if_truncated(n_lost)
            # The integrity checks and the shadow audit, escalated per
            # TallyConfig.integrity; then the bitflip fault hook (the
            # next move's flux check must catch it).
            if self._integrity != "off" or cfg.audit_lanes:
                with step("verify"):
                    self._self_verify(self.iter_count, integ, fly_h,
                                      n_lost, s, r, dest, done_h, dest3_h)
            self._maybe_inject_bitflip(self.iter_count)
            if (cfg.sort_by_element
                    and self.iter_count % cfg.migration_period == 0):
                with step("sort"):
                    self._resort_by_element()
            if cfg.measure_time:
                timer.sync(self.device)
        self.tally_times.n_moves += 1
        seconds = self.tally_times.total_time_to_tally - t_before
        io = self._io_since(io0)
        synced = cfg.measure_time
        self._fold(lambda: self._telemetry.record_walk(
            "move", move, stats_d, seconds=seconds, synced=synced,
            shape_key=self.shape_key, **io))
        if conv_h is not None:
            fields = conv_to_dict(conv_h)
            secs_total = self.tally_times.total_time_to_tally
            self._fold(lambda: self._monitor.update(fields, secs_total))

    # ------------------------------------------------------------------ #
    # The device-sourced move loop (ops/walk.py::megastep)
    # ------------------------------------------------------------------ #
    def _source_tables(self, src):
        """The Σt and absorption tables of one SourceParams on the card,
        staged once per physics identity, and the least Σt of the mesh's
        regions (a host float, for the record buffers' first estimate)."""
        from .ops.source import least_sigma_t, staged_tables

        cache = getattr(self, "_src_tables", None)
        # The tables depend on the regions only through the largest class
        # id, so the mesh's distinct class values (a few words) stand in
        # for its per-element class ids.
        self._src_tables = staged_tables(
            src, self.mesh.class_values, self.config.dtype, self.device,
            cache)
        if self._src_tables is not cache:
            self._sigma_min = least_sigma_t(src, self.mesh.class_values)
        _, sig, ab = self._src_tables
        return sig, ab, self._sigma_min

    def _rng_key(self, seed: int):
        """The key words of one source seed (host ints, kept per seed)."""
        from .ops.source import staged_rng_key

        self._rng_key_cache = staged_rng_key(
            seed, getattr(self, "_rng_key_cache", None))
        return self._rng_key_cache[1]

    def _megastep_statics(self, src) -> dict:
        cfg = self.config
        from .ops.source import near_epsilon

        if getattr(self, "_eps_near", None) is None:
            # One read of the mesh's coordinates a tally, not one a call.
            self._eps_near = near_epsilon(self.mesh.coords)
        return dict(
            n_groups=cfg.n_groups,
            survival_weight=float(src.survival_weight),
            downscatter=float(src.downscatter),
            eps_near=self._eps_near,
            max_crossings=self._max_crossings,
            score_squares=cfg.score_squares and cfg.sd_mode == "segment",
            tolerance=cfg.tolerance,
            robust=cfg.robust,
            ledger=cfg.ledger,
            stats=cfg.walk_stats,
            integrity=self._integrity != "off",
            rel_err_target=cfg.rel_err_target,
            batch_moves=self._batch_moves or 1,
        )

    def _stage_source_lanes(self, weights, groups, alive) -> int | None:
        """Stage caller-given physics lanes (host particle order) into the
        device state, in slot order (``_gather_in``), one host→device copy
        each, counted in ``self.io`` (so in the chunk that stages them).
        Returns the alive lanes' count when ``alive`` is given, else
        None."""
        n, cfg = self.num_particles, self.config
        repl, n_alive = {}, None
        if weights is not None:
            w = np.asarray(weights, np.float64).reshape(-1)[:n]
            repl["weight"] = self._put(_convert(w, cfg.dtype))
        if groups is not None:
            g = np.asarray(groups, np.int32).reshape(-1)[:n]
            _check_group_range(g, cfg.n_groups)
            repl["group"] = self._put(g)
        if alive is not None:
            a = np.asarray(alive).astype(bool).reshape(-1)[:n]
            repl["in_flight"] = self._put(a)
            n_alive = int(a.sum())
        if repl:
            self.state = self.state.replace(**repl)
        return n_alive

    def _verify_megastep(self, integ, n_truncated: int, k: int) -> None:
        """Check a chunk's reduced integrity vector
        (``integrity/invariants.py::check_megastep``) and escalate."""
        from .integrity import invariants, policy

        fields = invariants.integrity_to_dict(integ)
        violations = invariants.check_megastep(
            fields, n_truncated, self._integrity_tol,
            dtype=self.config.dtype, n_moves=k)
        self._telemetry.record_integrity(self.iter_count, fields, violations)
        policy.escalate(self._integrity, violations, self.iter_count)

    def run_source_moves(
        self,
        n_moves: int,
        source=None,
        weights: np.ndarray | None = None,
        groups: np.ndarray | None = None,
        alive: np.ndarray | None = None,
    ) -> dict:
        """Run ``n_moves`` device-sourced moves, as the JAX facade's
        ``run_source_moves``: per-lane flight sampling keyed by (seed,
        move, particle id) over the per-region Σt table, the walk, and
        the collision and roulette physics of ``models/transport.py``'s
        inner loop, in chunks of ``TallyConfig.megastep`` = K moves
        (``resolve_megastep``), until ``n_moves`` ran or no lane is alive.

        ``weights``/``groups``/``alive`` (host particle order) re-stage
        the physics lanes when given; omitted, the lanes continue from
        the device state (``state.in_flight`` is the alive flag), so
        consecutive calls chain bit for bit like one longer call. The
        random stream is keyed by ``iter_count``, so any K gives the same
        bits. A chunk makes one device→host copy (the tail) and, but for
        the staging of given lanes, no host→device copy. Truncated lanes
        stay alive and continue next move (counted and warned); re-walks,
        the element sort, the quarantine and the shadow audit do not run
        inside a call. With integrity on, each chunk's reduced integrity
        vector rides its tail and is checked after it.
        Returns the accumulated counters (``ops/source.py``
        MEGA_PHYS_FIELDS, ``moves``, ``segments``)."""
        if not self._initialized:
            raise RuntimeError(
                "initialize_particle_location must run before source moves"
            )
        cfg = self.config
        K = cfg.resolve_megastep(tuned=self._tuned)
        if self._kernel_policy == "pallas" and cfg.kernel == "pallas":
            raise NotImplementedError(
                "run_source_moves fuses source sampling + walk + "
                "physics into one scanned XLA program; kernel='pallas' "
                "does not ride it (TallyConfig.resolve_kernel) — use "
                "kernel='auto' (XLA fallback) or 'xla' for "
                "device-sourced runs"
            )
        from .ops import walk_cuda as wc
        from .ops.source import SourceParams, phys_to_dict
        from .ops.walk import megastep

        src = source if source is not None else SourceParams()
        sig_dev, ab_dev, sig_min = self._source_tables(src)
        rng_key = self._rng_key(src.seed)
        statics = self._megastep_statics(src)
        totals = {
            "moves": 0, "segments": 0, "collisions": 0, "escaped": 0,
            "rouletted": 0, "absorbed_weight": 0.0, "alive": 0,
            "truncated": 0,
        }
        io0 = dict(self.io)
        n_alive = self._stage_source_lanes(weights, groups, alive)
        if self._mega_records is None or n_alive is not None:
            lanes = self.num_particles if n_alive is None else n_alive
            est = wc.source_records(self._face_rate, lanes, sig_min)
        else:
            est = self._mega_records
        capacity = wc.record_capacity(self.num_particles, est)
        step = self._step
        done_moves = 0
        while done_moves < n_moves:
            k = min(K, n_moves - done_moves)
            t_before = self.tally_times.total_time_to_tally
            with phase_timer(self.tally_times, "total_time_to_tally",
                             True) as timer:
                s = self.state
                # Bound now, as in the per-move step (``_dispatch``).
                flux_in, prev_in, conv_in = (self.flux, self._prev_even,
                                             self._conv)
                stager, move0 = self._stager, self.iter_count

                def chunk():
                    out = megastep(
                        self.mesh, s.origin, s.elem, s.material_id, s.weight,
                        s.group, s.in_flight, s.particle_id, flux_in,
                        move0, rng_key, sig_dev, ab_dev, prev_in, conv_in,
                        n_moves=k, capacity=capacity, clock=self.step_clock,
                        **statics,
                    )
                    with step("tail read"):
                        host = staging.to_host(stager, out.readback,
                                               "megastep")
                    return out, host

                out, host_rb = self._dispatch(chunk, move0 + 1,
                                              kind=f"megastep:{k}")
                self._count("d2h", host_rb.numel() * host_rb.element_size())
                tail, integ, conv_h, phys = staging.split_megastep_tail(
                    host_rb, cfg.dtype, cfg.walk_stats, statics["integrity"],
                    self._conv is not None)
                self.flux = out.flux
                self.state = s.replace(
                    origin=out.position, dest=out.dest,
                    in_flight=out.alive, weight=out.weight,
                    group=out.group, elem=out.elem,
                    material_id=out.material_id,
                )
                if out.n_records is not None:
                    self._mega_records = out.n_records
                    capacity = wc.record_capacity(self.num_particles,
                                                  out.n_records)
                self.iter_count += k
                self._traces_since_sort += 1
                stats_d = stats_to_dict(tail) if cfg.walk_stats else None
                segs = (stats_d["segments"] if stats_d is not None
                        else int(tail[0]))
                self.total_segments += segs
                self._last_segments = segs // k
                p = phys_to_dict(phys)
                self._warn_if_truncated(p["truncated"])
                if integ is not None:
                    self._verify_megastep(integ, p["truncated"], k)
                self._maybe_inject_bitflip(self.iter_count)
                if cfg.measure_time:
                    timer.sync(self.device)
            self.tally_times.n_moves += k
            seconds = self.tally_times.total_time_to_tally - t_before
            self._telemetry.record_walk(
                "megastep", self.iter_count, stats_d, seconds=seconds,
                synced=cfg.measure_time, moves=k, shape_key=self.shape_key,
                collisions=p["collisions"], escaped=p["escaped"],
                rouletted=p["rouletted"], alive=p["alive"],
                **self._io_since(io0),
            )
            io0 = dict(self.io)
            if self._monitor is not None and conv_h is not None:
                self._monitor.update(conv_to_dict(conv_h),
                                     self.tally_times.total_time_to_tally)
            totals["moves"] += k
            totals["segments"] += segs
            for f in ("collisions", "escaped", "rouletted", "truncated"):
                totals[f] += p[f]
            totals["absorbed_weight"] += p["absorbed_weight"]
            totals["alive"] = p["alive"]
            done_moves += k
            if p["alive"] == 0:
                break
        return totals

    # ------------------------------------------------------------------ #
    @property
    def raw_flux(self) -> np.ndarray:
        """Unnormalized [ntet, n_groups, 2] (Σ w·len, and Σ (w·len)² per
        segment or, under sd_mode="batch", Σ of squared per-move bin
        totals), a host copy."""
        return self.flux.to("cpu", copy=True).numpy().reshape(
            self.mesh.ntet, self.config.n_groups, 2
        )

    @property
    def element_ids(self) -> np.ndarray:
        """Current parent element per particle, in particle order (a host
        copy)."""
        return _particle_order(self.state.elem.to("cpu", copy=True).numpy(),
                               self._perm)

    def intersection_points(self) -> tuple[np.ndarray, np.ndarray]:
        """The last walk's boundary-crossing points, the tracer's
        ``getIntersectionPoints()``: ``(points [n, K, 3] float64, counts
        [n] int32)`` in particle order. Needs ``record_xpoints=K``; a
        count above K means the walk crossed more faces than the buffer
        keeps (the first K are kept)."""
        if self.config.record_xpoints is None:
            raise ValueError(
                "set TallyConfig.record_xpoints=K to record intersection "
                "points (off by default: the hot path pays nothing)"
            )
        if self._last_xpoints is None:
            raise RuntimeError(
                "no trace has run yet: call initialize_particle_location "
                "(and move_to_next_location) before intersection_points"
            )
        xp, counts, perm = self._last_xpoints
        if isinstance(xp, torch.Tensor):  # first read: one device→host copy
            xp, counts = self._to_host(xp, counts)
            self._last_xpoints = (
                _particle_order(xp.astype(np.float64), perm),
                _particle_order(counts.astype(np.int32), perm), None)
        return self._last_xpoints[:2]

    def normalized_flux(self) -> np.ndarray:
        """[ntet, n_groups, 3] (mean, second moment, sd) after
        ``TallyConfig.sd_mode``, on the host."""
        return normalize_flux_host(
            self.raw_flux,
            self.mesh.volumes.cpu().numpy(),
            self.num_particles,
            max(self.iter_count, 1),
            sd_mode=self.config.sd_mode,
        )

    def reaction_rate(self, sigma: np.ndarray) -> np.ndarray:
        """Reaction-rate tally (raw Σ w·l·σ and its squares) for a
        [n_regions, n_groups] response table, derived from the flux on the
        host (``core/tally.py::reaction_rate_host``)."""
        if self.config.sd_mode != "segment":
            # The squares column is σ²·(slot 1), the documented Σ(w·l·σ)²
            # only when slot 1 holds per-segment squares.
            raise NotImplementedError(
                "reaction_rate requires sd_mode='segment' (batch mode's "
                "slot 1 holds per-move batch squares, not per-segment "
                f"squares); config has sd_mode={self.config.sd_mode!r}"
            )
        return reaction_rate_host(
            self.raw_flux,
            self.mesh.class_id.cpu().numpy(),
            np.asarray(sigma, _NP_DTYPES[self.config.dtype]),
        )

    # ------------------------------------------------------------------ #
    # Bad-particle quarantine and statistical convergence
    # ------------------------------------------------------------------ #
    def quarantined_lanes(self) -> np.ndarray:
        """Cumulative per-lane quarantine counts, host particle order."""
        return quarantine.lanes(self)

    def _require_convergence(self) -> ConvergenceMonitor:
        if self._monitor is None:
            raise ValueError(
                "convergence observability is off: construct with "
                "TallyConfig(convergence=True)"
            )
        return self._monitor

    def _reset_convergence(self) -> None:
        """Re-base the batch statistics on the current accumulator (after
        the flux was replaced, as a checkpoint restore does): the batch
        history restarts from here."""
        if self._monitor is None:
            return
        self._drain_pending()
        self._conv = ConvState(self.flux[0::2].clone(),
                               torch.zeros_like(self._conv.sumsq))
        self._monitor.reset()

    def end_batch(self) -> dict:
        """Close the current statistical batch now, whatever the
        ``batch_moves`` cadence (which restarts from here), and return the
        refreshed convergence summary: a fold on the card and one
        [CONV_LEN] read."""
        monitor = self._require_convergence()
        self._drain_pending()
        vec = fold_and_reduce(self.flux, self._conv, batch_moves=1,
                              rel_err_target=self.config.rel_err_target,
                              force=True)
        return monitor.update(
            conv_to_dict(vec.cpu().numpy().astype(np.float64)),
            self.tally_times.total_time_to_tally,
        )

    def converged(self) -> bool:
        """True once at least 2 batches are folded and the fraction of
        scored bins with relative error at or below ``rel_err_target`` has
        reached ``converged_fraction``."""
        monitor = self._require_convergence()
        self._drain_pending()
        return monitor.converged

    def relative_error(self) -> np.ndarray:
        """Per-bin [ntet, n_groups] float64 relative error from the batch
        accumulators, on the host (unscored bins 0, scored bins with fewer
        than 2 batches 1)."""
        self._require_convergence()
        self._drain_pending()
        rel = host_relative_error(self._conv.snap.cpu().numpy(),
                                  self._conv.sumsq.cpu().numpy(),
                                  self._conv.n_batches)
        return rel.reshape(self.mesh.ntet, self.config.n_groups)

    def write_pumi_tally_mesh(self, filename: str | None = None,
                              uncertainty: bool = False) -> str:
        """Normalize the flux, write one ``flux_group_<g>`` cell field per
        group plus ``volume`` (.vtu, or legacy .vtk by extension), and log
        the phase times. ``uncertainty=True`` also writes each group's
        relative error (``rel_err_group_<g>``; needs convergence)."""
        self._drain_pending()
        rel = self.relative_error() if uncertainty else None
        with phase_timer(
            self.tally_times, "vtk_file_write_time", True
        ):
            out = filename or self.config.output_filename
            write_flux_vtk(out, self.mesh, self.normalized_flux(),
                           rel_err=rel)
        self._telemetry.record_memory("vtk_write")
        self.tally_times.print_times()
        return out

    # ------------------------------------------------------------------ #
    def telemetry(self) -> dict:
        """Run-wide telemetry snapshot, the JAX facade's payload: counter
        totals (segments, crossings, truncated, lost, rewalked,
        quarantined, transfers), the last flight records, phase times, a
        fresh memory sample, the convergence block and the registry."""
        self._drain_pending()
        out = self._telemetry.snapshot(times=self.tally_times)
        out["convergence"] = (
            self._monitor.snapshot()
            if self._monitor is not None
            else {"enabled": False}
        )
        return out

    @property
    def metrics(self):
        """This tally's MetricsRegistry (Prometheus text via
        ``tally.metrics.render_prometheus()``)."""
        return self._telemetry.registry

    # ------------------------------------------------------------------ #
    def save_checkpoint(self, filename: str,
                        n_shards: int | None = None) -> None:
        """Persist the resumable state (flux, particle state, move
        counter) in the JAX package's single-file format
        (``utils/checkpoint.py``); either package restores it. A
        ``.shards`` name writes the sharded two-phase layout
        (``n_shards`` splits, default one)."""
        from .utils.checkpoint import save_checkpoint

        self._drain_pending()
        save_checkpoint(filename, self, n_shards=n_shards)

    def restore_checkpoint(self, filename: str) -> None:
        """Resume from a checkpoint written (by either package) against
        the same mesh and configuration; a single-device ``.shards``
        generation restores too."""
        from .utils.checkpoint import restore_checkpoint

        self._drain_pending()
        restore_checkpoint(filename, self)
