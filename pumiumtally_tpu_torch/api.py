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
"""
from __future__ import annotations

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
from .utils.config import TallyConfig
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
            self._origin_h: np.ndarray | None = None
            self._initialized = False
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
        )

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
        """Host→device copy of one input array (legacy)."""
        self._count("h2d", host.nbytes)
        return torch.from_numpy(host).to(self.device)

    def _to_host(self, *tensors: torch.Tensor) -> list[np.ndarray]:
        """``_to_host``, counted as one device→host transfer (legacy)."""
        self._count("d2h", sum(t.numel() * t.element_size()
                               for t in tensors))
        return _to_host(*tensors)

    def _put_record(self, rec: torch.Tensor) -> torch.Tensor:
        """The packed record's one host→device copy."""
        self._count("h2d", rec.numel() * rec.element_size())
        return rec.to(self.device, non_blocking=True)

    def _fetch(self, readback: torch.Tensor, tag: str = "readback",
               convergence: bool = False):
        """A packed readback's one device→host copy, as views
        (``staging.readback_views``: positions, material ids, done words,
        tail, convergence summary or None)."""
        self._count("d2h", readback.numel() * readback.element_size())
        host = staging.to_host(self._stager, readback, tag)
        return staging.readback_views(host, self.num_particles,
                                      self.config.dtype, convergence)

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
        the legacy summary, positions and material ids. Returns
        ``(result, refreshed views or None, n_lost)``."""
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
                parts = self._fetch(
                    staging.pack_trace_readback(
                        result.position, result.material_id, result.done,
                        result.stats, result.n_segments),
                    tag="rewalk",
                )[:4]
            else:
                parts = self._to_host(self._summary(result),
                                      result.position, result.material_id)
        if n_retried or n_lost:
            self._telemetry.record_rewalk(move, n_retried, n_lost)
        return result, parts, n_lost

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
        self._origin_h = pos3.copy()
        s = self.state
        io0 = dict(self.io)
        t_before = self.tally_times.initialization_time
        with phase_timer(
            self.tally_times, "initialization_time", True
        ) as timer:
            kw = self._walk_kw(True)
            if self._io != "legacy":
                rec = staging.pack_init_record(
                    self._stager, pos3, fly_h, cfg.dtype
                )
                r, readback, dest, _, _, _ = walk_cuda.trace_packed(
                    self.mesh, s.origin, s.elem, s.material_id,
                    self._put_record(rec), self.flux, None,
                    weight=s.weight, group=s.group, **kw,
                )
                _, _, done_h, tail, _ = self._fetch(readback)
                summary = self._packed_summary(tail, done_h)
            else:
                dest = self._put(_convert(pos3, cfg.dtype))
                fly = (torch.ones(n, dtype=torch.bool, device=self.device)
                       if qmask is None else self._put(fly_h))
                r = walk_cuda.trace(
                    self.mesh, s.origin, dest, s.elem, fly, s.weight,
                    s.group, s.material_id, self.flux, **kw,
                )
                (summary,) = self._to_host(self._summary(r))
            stats_d, _, n_tr = self._read_summary(summary)
            r, parts, n_lost = self._escalate_truncated(
                r, dest, s.weight, s.group, n_tr, kw, 0,
                packed=self._io != "legacy",
            )
            if parts is not None:
                stats_d, _, _ = self._read_summary(
                    self._packed_summary(parts[3], parts[2])
                    if self._io != "legacy" else parts[0])
            self.flux = r.flux
            self.state = s.replace(origin=r.position, dest=dest, elem=r.elem)
            self._initialized = True
            self._warn_if_truncated(n_lost)
            if cfg.measure_time:
                timer.sync(self.device)
        self._telemetry.record_walk(
            "initial_search", 0, stats_d,
            seconds=self.tally_times.initialization_time - t_before,
            synced=cfg.measure_time, **self._io_since(io0),
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

        io0 = dict(self.io)
        t_before = self.tally_times.total_time_to_tally
        move = self.iter_count + 1
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
            if self._io != "legacy":
                with step("pack"):
                    rec = staging.pack_move_record(
                        self._stager, dest_in, weights_h, groups_h, fly_h,
                        cfg.dtype,
                    )
                with step("put record"):
                    rec_dev = self._put_record(rec)
                with step("walk"):
                    r, readback, dest, in_flight, weight, group = (
                        walk_cuda.trace_packed(
                            self.mesh, s.origin, s.elem, s.material_id,
                            rec_dev, self.flux, None, **kw, **ckw,
                        )
                    )
                if self._io == "overlap":
                    # The previous move's telemetry fold, while this
                    # move's work runs on the card.
                    with step("deferred fold"):
                        self._drain_pending()
                with step("readback"):
                    final_pos, final_mats, done_h, tail, conv_h = (
                        self._fetch(readback,
                                    convergence=self._conv is not None)
                    )
                stats_d, segs, n_tr = self._read_summary(
                    self._packed_summary(tail, done_h))
                with step("escalate"):
                    r, parts, n_lost = self._escalate_truncated(
                        r, dest, weight, group, n_tr, kw, move, packed=True)
                if parts is not None:
                    final_pos, final_mats, done_h, tail = parts
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
                with step("walk"):
                    r = walk_cuda.trace(
                        self.mesh, s.origin, dest, s.elem, in_flight, weight,
                        group, s.material_id, self.flux, **kw,
                    )
                    extra = []
                    if self._conv is not None:
                        extra = [fold_and_reduce(r.flux, self._conv, **{
                            k: v for k, v in ckw.items()
                            if k != "conv_state"})]
                with step("to_host"):
                    summary, final_pos, final_mats, *conv = self._to_host(
                        self._summary(r), r.position, r.material_id, *extra
                    )
                    if conv:
                        conv_h = conv[0].astype(np.float64)
                stats_d, segs, n_tr = self._read_summary(summary)
                with step("escalate"):
                    r, parts, n_lost = self._escalate_truncated(
                        r, dest, weight, group, n_tr, kw, move,
                        packed=False)
                if parts is not None:
                    summary, final_pos, final_mats = parts
                    stats_d, segs, _ = self._read_summary(summary)
                with step("write-back"):
                    # Copy-back contract, as above (numpy casts).
                    dest3_h[:] = final_pos
                    mats_flat[:n] = final_mats
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
            self._last_segments = segs
            self.total_segments += segs
            # The truncation warning stays in the call in every mode;
            # only the telemetry fold is deferred under "overlap".
            self._warn_if_truncated(n_lost)
            if cfg.measure_time:
                timer.sync(self.device)
        self.tally_times.n_moves += 1
        seconds = self.tally_times.total_time_to_tally - t_before
        io = self._io_since(io0)
        synced = cfg.measure_time
        self._fold(lambda: self._telemetry.record_walk(
            "move", move, stats_d, seconds=seconds, synced=synced, **io))
        if conv_h is not None:
            fields = conv_to_dict(conv_h)
            secs_total = self.tally_times.total_time_to_tally
            self._fold(lambda: self._monitor.update(fields, secs_total))

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
        """Current parent element per particle (a host copy)."""
        return self.state.elem.to("cpu", copy=True).numpy()

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
