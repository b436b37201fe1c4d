"""PumiTally-shaped facade over the halo-partitioned walk.

Counterpart of ``pumiumtally_tpu/parallel/partitioned_api.py``: the same
four calls over a mesh split into Morton blocks with a buffered halo
(``parallel/mesh_partition.py``), each part walking its own particles
with migration between parts (``ops/walk_partitioned.py``):

    t = PartitionedTally(mesh, N, TallyConfig(...), n_parts=4)
    t.initialize_particle_location(pos, 3*N)
    t.move_to_next_location(dest, flying, w, g, mats, 3*N)   # repeat
    t.write_pumi_tally_mesh("flux.vtu")

As in the JAX facade, the particle state lives on the host between calls
and is distributed to its owner parts each call, and the flux accumulates
in per-part owned slabs (halo rows return zeroed from every step);
``raw_flux`` assembles the global ``[ntet, G, 2]`` view. The parts are
stacked on one device (``device=``, the CUDA card by default): on the card
every walk phase is the walk kernel's partitioned layout, on the CPU its
plain version. The facade runs in one process; the step over the ranks
of a process group is ``ops/walk_partitioned.make_partitioned_step`` with
a mesh of ``ranks.MeshEntry`` entries.

``TallyConfig.io_pipeline``: "packed" (default) and "overlap" stage the
slot distribution as ONE carrier record (``staging.pack_partitioned_
record``) and read ONE readback a call; "legacy" copies each distributed
array and each collected one. The three give the same bits.

``run_source_moves`` is the device-sourced move loop
(``walk_partitioned.make_partitioned_megastep``): the slot state stays on
the device between chunks of ``TallyConfig.megastep`` moves and is folded
back into the host mirrors (positions, elements, materials, weights,
groups, alive flags) before every per-move call, a re-stage of lanes and
a checkpoint. The run features of the JAX facade ride both loops as
there: integrity checks (per-part device counters, the host's
conservation check over the migrating track ledger, particle-id
coverage), shadow audits, ``move_deadline_s``, quarantine, truncation
re-walks, convergence and checkpoints (the flux stored assembled, so a
checkpoint resumes under another part count or halo depth).

The debug surfaces are the JAX facade's: ``record_xpoints=K`` records
each particle's first K crossing points of every call through the walk
phases (their buffers migrate with the particles), merged across
re-walks and served in host order by ``intersection_points``;
``checkify_invariants`` refuses non-finite positions, destinations and
weights on the host; ``sort_by_element`` is accepted and has no effect
(no partitioned module reads it, as in JAX). The first two force
``io_pipeline="legacy"`` (``TallyConfig.resolve_io_pipeline``).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..api import PumiTally, _check_group_range, _out_param, flip_largest
from ..core.tally import (
    accumulate_batch_squares,
    normalize_flux_host,
    reaction_rate_host,
)
from ..io.vtk import write_flux_vtk
from ..obs.convergence import (
    ConvergenceMonitor,
    ConvState,
    fold_and_reduce,
    host_relative_error,
    reduce_chip_conv,
)
from ..obs.telemetry import TallyTelemetry
from ..obs.walk_stats import WALK_STATS_FIELDS, reduce_chip_stats
from ..ops import staging, walk_cuda
from ..ops.walk import merge_recorded_xpoints
from ..ops.walk_partitioned import (
    collect_by_particle_id,
    distribute_particles,
    make_partitioned_step,
)
from ..resilience import quarantine
from ..utils.config import TallyConfig
from ..utils.platform import resolve_device
from ..utils.timing import StepClock, TallyTimes, clock_step, phase_timer
from .mesh_partition import assemble_global_flux, partition_mesh
from .particle_sharding import make_device_mesh
from .ranks import rank_layout

_SEGMENTS = WALK_STATS_FIELDS.index("segments")
_CROSSINGS = WALK_STATS_FIELDS.index("crossings")
# The per-call stats that add across a move's re-walk attempts.
_SUMMED = ("rounds", "dropped", "migrated", "adopted", "h2d_bytes",
           "h2d_transfers", "d2h_bytes", "d2h_transfers")


def _merge_agg(a: dict, b: dict) -> dict:
    """Fold a re-walk attempt's reduced stats into the move's: sums
    everywhere but ``max_crossings`` (the max) and ``truncated`` (the
    latest attempt saw every lane still unfinished)."""
    out = {f: a[f] + b[f] for f in WALK_STATS_FIELDS}
    out["max_crossings"] = max(a["max_crossings"], b["max_crossings"])
    out["truncated"] = b["truncated"]
    out["occupancy"] = (round(out["occ_active"] / out["occ_slots"], 4)
                        if out["occ_slots"] else None)
    return out


def _merge_got(got: dict, sub_trunc: np.ndarray, got2: dict) -> None:
    """Fold a re-walk attempt's collected outputs (rows: the re-walked
    lanes in particle order, the rows ``sub_trunc`` selects) into the
    move's ``got`` in place; track lengths add, recorded points append
    (``merge_recorded_xpoints``)."""
    for name in ("position", "material_id", "elem", "done", "elem_global"):
        got[name][sub_trunc] = got2[name]
    got["track_length"][sub_trunc] += got2["track_length"]
    if "xpoints" in got:
        rows_a = np.nonzero(sub_trunc)[0]
        merge_recorded_xpoints(got["xpoints"], got["n_xpoints"],
                               got2["xpoints"], got2["n_xpoints"], rows_a,
                               np.arange(rows_a.size))


class PartitionedTally:
    """The four-call tally contract over a partitioned mesh (see the
    module docstring): element-0-centroid seeding, an initial search that
    scores nothing, and per-move write-back of clipped positions, material
    ids and zeroed flying flags, as ``PumiTally``."""

    def __init__(
        self,
        mesh,
        num_particles: int,
        config: TallyConfig | None = None,
        *,
        n_parts: int | None = None,
        device_mesh=None,
        halo_layers: int = 1,
        cap: int | None = None,
        exchange_size: int | None = None,
        max_rounds: int | None = None,
        telemetry: TallyTelemetry | None = None,
        device=None,
    ):
        self.mesh = mesh
        self.num_particles = int(num_particles)
        self.config = cfg = config if config is not None else TallyConfig()
        self.tally_times = TallyTimes()
        self._telemetry = (telemetry if telemetry is not None
                           else TallyTelemetry("PartitionedTally"))
        if cfg.compact_stages == "adaptive":
            raise NotImplementedError(
                "compact_stages='adaptive' replans via PumiTally's "
                "post-move hook, which PartitionedTally does not have; "
                "use 'plan' (density-estimated) or an explicit schedule"
            )
        if cfg.compact_stages is not None:
            raise NotImplementedError(
                "PartitionedTally: a compact_stages schedule is not ported "
                "yet (ROADMAP.md A10); compact_after and compact_size are")
        if cfg.sd_mode not in ("segment", "batch"):
            raise ValueError(
                f"sd_mode must be 'segment' or 'batch': {cfg.sd_mode!r}")
        if mesh.dtype != cfg.dtype:
            raise ValueError(
                f"mesh dtype {mesh.dtype} != config dtype {cfg.dtype}")
        self._kernel_policy = cfg.resolve_kernel()
        if self._kernel_policy == "pallas" and cfg.kernel == "pallas":
            raise ValueError(
                "kernel='pallas' is a single-chip walk backend "
                "(ops/walk_pallas.py: VMEM-resident geo20 table, "
                "small/medium-mesh regime); the mesh-partitioned walk "
                "runs its own fused per-chip program over halo tables "
                "with no packed layout to tile into VMEM. Use "
                "PumiTally(kernel='pallas') for meshes inside the VMEM "
                "budget, or kernel='auto'/'xla' here"
            )
        self.device = resolve_device(device)
        if mesh.device != self.device:
            raise ValueError(
                f"mesh is on {mesh.device}, the tally on {self.device}")
        if device_mesh is None:
            device_mesh = make_device_mesh(n_parts, self.device)
        lay = rank_layout(device_mesh)
        if lay.hi - lay.lo != len(device_mesh):
            raise ValueError(
                "PartitionedTally runs every part in one process; spread "
                "the step over ranks with make_partitioned_step")
        self.device_mesh = device_mesh
        self.n_parts = len(device_mesh)
        self.partition = partition_mesh(mesh, self.n_parts,
                                        halo_layers=halo_layers)
        self.cap = int(cap) if cap is not None else self.num_particles
        if self.cap < self.num_particles:
            raise ValueError(
                f"cap={self.cap} < num_particles={self.num_particles}: "
                "the element-0 seeding of initialize_particle_location "
                "needs every particle to fit one chip"
            )
        self._integrity = cfg.resolve_integrity()
        self._batch_moves = cfg.resolve_convergence()
        # The first walk phase's compacted rounds resolve against the
        # slots a part sweeps (cap), as the JAX facade resolves them.
        compact = cfg.resolve_compaction(self.cap)
        self._step_kwargs = dict(
            n_groups=cfg.n_groups,
            max_crossings=cfg.resolve_max_crossings(mesh.ntet),
            tolerance=cfg.tolerance,
            # sd_mode="batch": the walk scatters only Σc; each move folds
            # its squared bin totals (accumulate_batch_squares).
            score_squares=cfg.score_squares and cfg.sd_mode == "segment",
            unroll=cfg.unroll,
            robust=cfg.robust,
            tally_scatter=cfg.tally_scatter,
            record_xpoints=cfg.record_xpoints,
            compact_after=compact[0],
            compact_size=compact[1],
            exchange_size=exchange_size,
            max_rounds=max_rounds,
            integrity=self._integrity != "off",
            convergence=self._batch_moves is not None,
            rel_err_target=cfg.rel_err_target,
            batch_moves=self._batch_moves or 1,
        )
        self._steps: dict = {}
        # record_xpoints: the last call's (points, counts) in host order.
        self._last_xpoints: tuple | None = None
        self._io = cfg.resolve_io_pipeline()
        self._stager = staging.HostStager(
            depth=2 if self._io == "overlap" else 1, device=self.device)
        self._pending_folds: list = []
        L = self.partition.max_local * cfg.n_groups
        self.flux_slabs = torch.zeros(self.n_parts, L * 2, dtype=cfg.dtype,
                                      device=self.device)
        # sd_mode="batch": the even (Σc) entries as of the previous move.
        self._prev_even = (
            torch.zeros(self.n_parts * L, dtype=cfg.dtype,
                        device=self.device)
            if cfg.sd_mode == "batch" and cfg.score_squares else None)
        # Host particle state, seeded at element 0's centroid.
        coords = mesh.coords.cpu().numpy().astype(np.float64)
        c0 = coords[mesh.tet2vert[0].cpu().numpy()].mean(
            axis=0, keepdims=True)
        self.positions = np.repeat(c0, self.num_particles, axis=0)
        self.elem_global = np.zeros(self.num_particles, np.int64)
        self.material_id = np.full(self.num_particles, -1, np.int32)
        self.iter_count = 0
        self.total_segments = 0
        self.total_rounds = 0
        self._initialized = False
        # The device-sourced move loop: the physics lanes (host particle
        # order; the per-move calls take them as arguments, the megastep
        # carries them), the slot state on the device between chunks (a
        # dict of [n_parts·cap] tensors, or None while the host mirrors
        # hold the state) and the megastep per (physics, chunk length).
        self.weights = np.ones(self.num_particles)
        self.groups = np.zeros(self.num_particles, np.int32)
        self.alive = np.ones(self.num_particles, bool)
        self._src: dict | None = None
        self._mega_progs: dict = {}
        # Bad-particle quarantine: per-lane counts and the out-of-mesh
        # threshold (host numpy), PumiTally's.
        self._quarantined: np.ndarray | None = None
        if cfg.quarantine:
            quarantine.setup(self, coords, self.num_particles)
        # Integrity layer: the escalation mode, the checks' tolerances,
        # the shadow audit's float64 host walker and the fault hooks.
        self._finj = None
        self._auditor = None
        self._watchdog_warm: set = set()
        if (self._integrity != "off" or cfg.audit_lanes
                or cfg.move_deadline_s is not None):
            from ..integrity import invariants
            from ..resilience.faultinject import FaultInjector

            self._finj = FaultInjector()
            scale = invariants.mesh_scale(coords)
            self._integrity_tol = invariants.conservation_tolerance(
                cfg.integrity_tol, cfg.dtype, scale, cfg.tolerance)
            self._audit_tol = invariants.audit_tolerance(
                cfg.audit_tol, cfg.dtype, scale, cfg.tolerance)
        if cfg.audit_lanes:
            from ..integrity.audit import HostReference

            self._auditor = HostReference(mesh)
        # Convergence: per-part batch accumulators [n_parts, L] on the
        # device (the batch and move counts are host ints, the same in
        # every part) and the monitor; None when off.
        self._conv: ConvState | None = None
        self._monitor: ConvergenceMonitor | None = None
        if self._batch_moves is not None:
            self._conv = ConvState.zeros((self.n_parts, L), cfg.dtype,
                                         self.device)
            self._monitor = ConvergenceMonitor(
                self._telemetry, rel_err_target=cfg.rel_err_target,
                converged_fraction=cfg.converged_fraction,
                batch_moves=self._batch_moves)
        # The first walk phase's record buffers on the card: sized from
        # the last move's segments, before the first move from the face
        # rate and the move's paths; the later phases' from the face rate
        # and the pending lanes' remaining paths (the step's face_rate).
        self._face_rate = (walk_cuda.face_rate(mesh)
                           if self.device.type == "cuda" else 0.0)
        self._last_segments: int | None = None
        # The last call's [n_parts, 6, rounds] exchange counts (pending,
        # sent, received, free, adopted, the follow-up walk's iterations).
        self.last_round_stats: np.ndarray | None = None
        # Set to a StepClock to time each host step of the calls.
        self.step_clock: StepClock | None = None
        self._telemetry.record_memory("initialization")

    # ------------------------------------------------------------------ #
    def _step(self, initial: bool):
        key = (bool(initial), self._io != "legacy")
        if key not in self._steps:
            self._steps[key] = make_partitioned_step(
                self.device_mesh, self.partition, initial=initial,
                packed_io=self._io != "legacy",
                face_rate=(self._face_rate if self.device.type == "cuda"
                           else None), **self._step_kwargs)
        return self._steps[key]

    def _drain_pending(self) -> None:
        """Run the telemetry folds deferred by io_pipeline="overlap"."""
        pending, self._pending_folds = self._pending_folds, []
        for fold in pending:
            fold()

    def _capacity(self, moving, dest, initial: bool):
        if initial or self.device.type != "cuda":
            return None
        m = int(moving.sum())
        if self._last_segments is None:
            est = walk_cuda.path_records(self._face_rate,
                                         self.positions[moving],
                                         dest[moving], np.ones(m, bool))
        else:
            est = self._last_segments
        return walk_cuda.record_capacity(m, est)

    # PumiTally's watchdog dispatch and fault counter: they read only
    # config, device, the fault injector, the staging ring and telemetry;
    # and its checkify_invariants host check (the JAX facade's too).
    _dispatch = PumiTally._dispatch
    _count_fault = PumiTally._count_fault
    _check_finite = PumiTally._check_finite

    def _self_verify(self, move, initial, got, moving, stats, pos_before,
                     weights, n_lost) -> None:
        """The JAX facade's integrity evaluation of one partitioned move:
        each part's device counters (flux health, slot accounting), the
        host's per-lane conservation over the migrating track ledger
        against the pre-move positions, particle-id coverage (each moving
        particle collected once), and the shadow audit; escalates per
        ``TallyConfig.integrity``."""
        cfg = self.config
        if self._integrity == "off" and not cfg.audit_lanes:
            return
        from ..integrity import policy

        fields: dict = {}
        violations: list = []
        ivec = stats.pop("integrity_dev", None)
        if self._integrity != "off" and ivec is not None:
            ivec = np.asarray(ivec, np.int64)
            done = got["done"].astype(bool)
            n_moving = int(moving.sum())
            fields["bad_flux"] = int(ivec[:, 0].sum())
            fields["lanes_flying"] = n_moving
            fields["lanes_done"] = int(done.sum())
            if fields["bad_flux"] > 0:
                violations.append("flux")
            if (stats.get("pid_seen") != n_moving
                    or stats.get("pid_unique") != n_moving
                    or fields["lanes_done"] + int(n_lost) != n_moving):
                violations.append("lanes")
            if not initial:
                track = np.asarray(got["track_length"], np.float64)
                disp = np.linalg.norm(
                    np.asarray(got["position"], np.float64) - pos_before,
                    axis=1)
                resid = np.where(done, np.abs(track - disp), 0.0)
                w = np.asarray(weights, np.float64)[moving]
                fields["scored_wlen"] = float(
                    (w * np.where(done, track, 0.0)).sum())
                fields["path_wlen"] = float(
                    (w * np.where(done, disp, 0.0)).sum())
                fields["max_residual"] = (float(resid.max()) if resid.size
                                          else 0.0)
                if fields["max_residual"] > self._integrity_tol:
                    violations.append("conservation")
        if (cfg.audit_lanes and self._auditor is not None and not initial
                and move >= 1 and move % cfg.audit_every == 0):
            out = self._run_audit(move, got, pos_before)
            if out is not None:
                self._telemetry.record_audit(
                    move, out.audited, out.mismatches, out.skipped,
                    out.max_dev)
                if out.mismatches:
                    violations.append("sdc_audit")
        if fields or violations:
            self._telemetry.record_integrity(move, fields, violations)
        policy.escalate(self._integrity, violations, move)

    def _run_audit(self, move, got, pos_before):
        """Shadow-audit a sample of this move's finished lanes from arrays
        the facade holds on the host (origins, global elements, collected
        positions and track lengths): no extra transfer. The sample is the
        JAX facade's (``np.random.default_rng([audit_seed, move])`` over
        the same rows)."""
        cfg = self.config
        rows = np.nonzero(got["done"].astype(bool))[0]
        if rows.size == 0:
            return None
        rng = np.random.default_rng([cfg.audit_seed, int(move)])
        sel = rng.choice(rows, size=min(cfg.audit_lanes, rows.size),
                         replace=False)
        prod_pos = np.asarray(got["position"], np.float64)[sel]
        track = np.asarray(got["track_length"], np.float64)[sel].copy()
        if self._finj is not None and self._finj.sdc_at(move):
            track[0] += 1e3 * self._audit_tol
            self._count_fault("sdc_walk")
        from ..integrity.audit import audit_sample

        return audit_sample(
            self._auditor, pos_before[sel], self._audit_dest[sel],
            self._audit_elem_before[sel], prod_pos, track,
            tolerance=cfg.tolerance,
            max_crossings=self._step_kwargs["max_crossings"],
            tol=self._audit_tol)

    def _maybe_inject_bitflip(self, move: int) -> None:
        """``PUMI_TPU_FAULTS=bitflip_flux:K``: after move K flip the slab
        entry of largest magnitude (``api.flip_largest``), the JAX
        facade's entry; the next move's flux check must catch it."""
        if self._finj is None or not self._finj.bitflip_at(move):
            return
        flip_largest(self.flux_slabs.view(-1))
        self._count_fault("bitflip_flux")

    def _run(self, dest, in_flight, weight, group, initial):
        # The per-move calls own the host state: a megastep's slot state
        # on the device folds back first.
        if self._src is not None:
            self._drop_source_state()
        field = "initialization_time" if initial else "total_time_to_tally"
        t_before = getattr(self.tally_times, field)
        with phase_timer(self.tally_times, field, True) as timer:
            got, moving, stats = self._run_inner(dest, in_flight, weight,
                                                 group, initial)
            if self.config.measure_time:
                timer.sync(self.device)
        kind = "initial_search" if initial else "move"
        move_no = self.iter_count + (0 if initial else 1)
        agg = stats.pop("agg")
        conv_dev = stats.pop("conv_dev", None)
        seconds = getattr(self.tally_times, field) - t_before

        def fold():
            self._telemetry.record_walk(kind, move_no, agg, seconds=seconds,
                                        synced=self.config.measure_time,
                                        **stats)

        self._fold(fold, initial)
        if self._monitor is not None and not initial and conv_dev is not None:
            fields = reduce_chip_conv(conv_dev)
            secs = self.tally_times.total_time_to_tally
            self._fold(lambda: self._monitor.update(fields, secs), initial)
        return got, moving

    def _fold(self, fold, initial: bool) -> None:
        """Run a host fold now, or after the next step's dispatch under
        io_pipeline="overlap" (drained at every read surface)."""
        if self._io == "overlap" and not initial:
            self._pending_folds.append(fold)
        else:
            fold()

    def _run_inner(self, dest, in_flight, weight, group, initial):
        moving = in_flight != 0
        pos_before = None
        if self._integrity != "off" or self.config.audit_lanes:
            # The walk folds positions back in place: keep the pre-move
            # ones for the conservation check (and the audit's inputs).
            pos_before = self.positions[moving].copy()
            if self.config.audit_lanes:
                self._audit_dest = np.asarray(dest[moving],
                                              np.float64).copy()
                self._audit_elem_before = self.elem_global[moving].copy()
        got, stats = self._walk_once(dest, moving, weight, group, initial)
        n_lost = stats["agg"]["truncated"]
        n_re = 0
        retries = self.config.truncation_retries
        while n_lost and retries > 0:
            # Re-walk only the truncated lanes with the same step (a
            # fresh crossing and round budget); their positions and
            # elements were folded back, so each continues where it
            # stopped. Re-walks never advance the batch cadence.
            retries -= 1
            sub_trunc = ~got["done"].astype(bool)
            trunc = np.zeros(self.num_particles, bool)
            trunc[np.nonzero(moving)[0][sub_trunc]] = True
            n_re += int(trunc.sum())
            got2, stats2 = self._walk_once(dest, trunc, weight, group,
                                           initial, first=False)
            _merge_got(got, sub_trunc, got2)
            stats["agg"] = _merge_agg(stats["agg"], stats2["agg"])
            if "integrity_dev" in stats2:
                # The latest attempt's counters carry the final flux
                # health; the particle-id coverage keeps the first
                # attempt's view of every moving lane.
                stats["integrity_dev"] = stats2["integrity_dev"]
            for f in _SUMMED:
                stats[f] += stats2[f]
            for f in ("per_chip_segments", "per_chip_crossings"):
                stats[f] = [x + y for x, y in zip(stats[f], stats2[f])]
            n_lost = stats2["agg"]["truncated"]
        if self._prev_even is not None and not initial:
            # One squared per-move delta, after the re-walks: the move's
            # whole bin totals enter slot 1.
            accumulate_batch_squares(self.flux_slabs.view(-1),
                                     self._prev_even)
        move = self.iter_count + (0 if initial else 1)
        if n_re or n_lost:
            self._telemetry.record_rewalk(move, n_re, n_lost)
        if self.config.record_xpoints is not None:
            # Host order; parked lanes record nothing (count 0).
            n = self.num_particles
            xp = np.zeros((n, int(self.config.record_xpoints), 3))
            counts = np.zeros(n, np.int32)
            xp[moving] = got["xpoints"]
            counts[moving] = got["n_xpoints"]
            self._last_xpoints = (xp, counts)
        if n_lost:
            warnings.warn(
                f"{n_lost} partitioned walk(s) truncated (max_crossings="
                f"{self._step_kwargs['max_crossings']} or the migration "
                "round bound); tallies for them are incomplete. Raise "
                "TallyConfig.max_crossings / max_rounds or set "
                "truncation_retries for bounded re-walk escalation.",
                RuntimeWarning,
                stacklevel=4,
            )
        self._self_verify(move, initial, got, moving, stats, pos_before,
                          weight, n_lost)
        if not initial:
            self._maybe_inject_bitflip(move)
        return got, moving, stats

    def _conv_in(self, initial: bool, first: bool):
        """The step's convergence input, ``(ConvState, enable)``, or None
        with convergence off. The gate is closed for the initial search
        and the re-walks: they do not advance the batch cadence, and the
        next closed batch's delta picks their scores up."""
        if self._conv is None:
            return None
        return self._conv, first and not initial

    def _fields(self, dest, moving, weight, group) -> dict:
        return dict(origin=self.positions[moving], dest=dest[moving],
                    weight=weight[moving], group=group[moving],
                    material_id=self.material_id[moving])

    def _walk_once(self, dest, moving, weight, group, initial, first=True):
        """One distribute → partitioned step → collect pass over the
        ``moving`` subset; packed unless io_pipeline="legacy"."""
        n_moving = int(moving.sum())
        capacity = self._capacity(moving, dest, initial)
        clock = self.step_clock
        step = self._step(initial)
        conv = self._conv_in(initial, first)
        flux_in = self.flux_slabs
        integ = self._integrity != "off"
        move = self.iter_count + (0 if initial else 1)
        extra = {}
        if self._io != "legacy":
            with clock_step(clock, "pack"):
                rec_h = staging.pack_partitioned_record(
                    self.partition, self.elem_global[moving],
                    self._fields(dest, moving, weight, group), self.cap,
                    self.config.dtype, self._stager)
            stager = self._stager
            # The previous move's deferred folds run while this step's
            # kernels do, but never inside a supervised call: an
            # abandoned worker must not touch the telemetry.
            drain = self._io == "overlap"
            inside = drain and self.config.move_deadline_s is None

            def go():
                with clock_step(clock, "h2d"):
                    rec = rec_h.to(self.device, non_blocking=True)
                with clock_step(clock, "step"):
                    res = step(rec, flux_in, conv=conv, capacity=capacity)
                if inside:
                    self._drain_pending()
                with clock_step(clock, "readback"):
                    return staging.to_host(stager, res.readback,
                                           "part_readback")

            host_rb = self._dispatch(go, move)
            if drain and not inside:
                self._drain_pending()
            io = dict(h2d_bytes=rec_h.numel() * rec_h.element_size(),
                      h2d_transfers=1,
                      d2h_bytes=host_rb.numel() * host_rb.element_size(),
                      d2h_transfers=1)
            with clock_step(clock, "collect"):
                parsed = staging.split_partitioned_readback(
                    host_rb, self.n_parts, self.cap, self.config.dtype,
                    integrity=integ, convergence=conv is not None)
                got = staging.collect_packed(parsed, n_moving,
                                             self.partition)
            sv, rs = parsed["stats"], parsed["round_stats"]
            n_rounds = int(parsed["n_rounds"][0])
            n_dropped = int(parsed["n_dropped"].sum())
            if integ:
                extra["integrity_dev"] = parsed["integrity"]
                pid_h, valid_h = parsed["particle_id"], parsed["valid"]
            if conv is not None:
                extra["conv_dev"] = parsed["convergence"]
        else:
            with clock_step(clock, "distribute"):
                placed = distribute_particles(
                    self.partition, self.device_mesh,
                    self.elem_global[moving],
                    self._fields(dest, moving, weight, group), cap=self.cap)
            dt = self.config.dtype

            def go():
                with clock_step(clock, "step"):
                    res = step(
                        placed["origin"].to(dt), placed["dest"].to(dt),
                        placed["elem"], torch.zeros_like(placed["valid"]),
                        placed["material_id"], placed["weight"].to(dt),
                        placed["group"], placed["particle_id"],
                        placed["valid"], flux_in, conv=conv,
                        capacity=capacity)
                with clock_step(clock, "collect"):
                    got = collect_by_particle_id(res, n_moving,
                                                 self.partition)
                    reads = [res.stats, res.round_stats, res.n_rounds,
                             res.n_dropped]
                    for t in (res.integrity, res.convergence):
                        if t is not None:
                            reads.append(t)
                    host = [t.cpu().numpy() for t in reads]
                return res, got, reads, host

            res, got, reads, host = self._dispatch(go, move)
            sv, rs, nr, nd = host[:4]
            n_rounds, n_dropped = int(nr[0]), int(nd.sum())
            collected = ("particle_id", "valid", "position", "material_id",
                         "done", "elem", "weight", "group", "track_length")
            if res.xpoints is not None:
                collected += ("xpoints", "n_xpoints")
            d2h = [getattr(res, f) for f in collected] + reads
            io = dict(
                h2d_bytes=sum(t.numel() * t.element_size()
                              for t in placed.values()),
                h2d_transfers=len(placed),
                d2h_bytes=sum(t.numel() * t.element_size() for t in d2h),
                d2h_transfers=len(d2h))
            rest = host[4:]
            if integ:
                extra["integrity_dev"] = rest.pop(0)
                pid_h = res.particle_id.cpu().numpy()
                valid_h = res.valid.cpu().numpy()
            if conv is not None:
                extra["conv_dev"] = rest.pop(0).astype(np.float64)
        if n_dropped != 0:
            raise RuntimeError(
                "partitioned walk dropped immigrants: raise cap")
        if integ:
            sel = valid_h & (pid_h >= 0)
            extra["pid_seen"] = int(sel.sum())
            extra["pid_unique"] = int(np.unique(pid_h[sel]).size)
        # Fold the moved particles back into host order.
        with clock_step(clock, "write-back"):
            self.positions[moving] = got["position"]
            self.elem_global[moving] = got["elem_global"]
            if not initial:
                self.material_id[moving] = got["material_id"]
        agg = reduce_chip_stats(sv)
        self.last_round_stats = rs
        if not initial:
            self._last_segments = agg["segments"]
        stats = {
            "agg": agg,
            "rounds": n_rounds,
            "dropped": n_dropped,
            "migrated": int(rs[:, 1].sum()),
            "adopted": int(rs[:, 4].sum()),
            "per_chip_segments": sv[:, _SEGMENTS].tolist(),
            "per_chip_crossings": sv[:, _CROSSINGS].tolist(),
            **io,
            **extra,
        }
        self.total_segments += agg["segments"]
        self.total_rounds += n_rounds
        return got, stats

    # ------------------------------------------------------------------ #
    # The device-sourced move loop (ops/walk_partitioned.py
    # make_partitioned_megastep)
    # ------------------------------------------------------------------ #
    def _ensure_source_state(self, weights, groups, alive) -> int:
        """Install the caller's physics lanes (host particle order) and
        build the slot state on the device from the host mirrors when it
        is not there: one distribute. Re-staging some lanes must not
        rewind the others, so live device state folds back into the
        mirrors first. Returns the bytes staged (0 when nothing was)."""
        n = self.num_particles
        given = [a is not None for a in (weights, groups, alive)]
        if self._src is not None and any(given):
            self._sync_source_state()
        if weights is not None:
            self.weights = np.asarray(weights,
                                      np.float64).reshape(-1)[:n].copy()
        if groups is not None:
            g = np.asarray(groups, np.int32).reshape(-1)[:n]
            _check_group_range(g, self.config.n_groups)
            self.groups = g.copy()
        if alive is not None:
            self.alive = np.asarray(alive).astype(bool).reshape(-1)[:n].copy()
        if any(given):
            self._src = None
        if self._src is not None:
            return 0
        placed = distribute_particles(
            self.partition, self.device_mesh, self.elem_global,
            dict(origin=self.positions, weight=self.weights,
                 group=self.groups, material_id=self.material_id),
            cap=self.cap)
        pid_h = placed["particle_id"].cpu().numpy()
        alive_slot = np.zeros(pid_h.shape[0], bool)
        sel = pid_h >= 0
        alive_slot[sel] = self.alive[pid_h[sel]]
        dt = self.config.dtype
        self._src = {
            "pos": placed["origin"].to(dt), "elem": placed["elem"],
            "material_id": placed["material_id"],
            "weight": placed["weight"].to(dt), "group": placed["group"],
            "pid": placed["particle_id"], "valid": placed["valid"],
            "alive": torch.from_numpy(alive_slot).to(self.device),
        }
        return sum(t.numel() * t.element_size() for t in self._src.values())

    def _sync_source_state(self) -> None:
        """Fold the device slot state back into the host mirrors
        (positions, elem_global, material_id, weights, groups, alive);
        the device state stays live for the next chunk."""
        if self._src is None:
            return
        src = {k: v.cpu().numpy() for k, v in self._src.items()}
        pid, valid = src["pid"], src["valid"]
        sel = valid & (pid >= 0)
        idx = pid[sel]
        self.positions[idx] = src["pos"][sel].astype(np.float64)
        self.material_id[idx] = src["material_id"][sel]
        self.weights[idx] = src["weight"][sel].astype(np.float64)
        self.groups[idx] = src["group"][sel]
        alive = np.zeros(self.num_particles, bool)
        alive[idx] = src["alive"][sel]
        self.alive = alive
        cap = pid.shape[0] // self.n_parts
        part = (np.arange(pid.shape[0]) // cap)[sel]
        self.elem_global[idx] = self.partition.local2global[
            part, src["elem"][sel]]

    def _drop_source_state(self) -> None:
        """Sync, then let the host mirrors hold the state (the per-move
        calls and restores into another layout)."""
        self._sync_source_state()
        self._src = None

    def _rng_key(self, seed: int):
        """The key words of one source seed (host ints, kept per seed)."""
        from ..ops.source import staged_rng_key

        self._rng_key_cache = staged_rng_key(
            seed, getattr(self, "_rng_key_cache", None))
        return self._rng_key_cache[1]

    def _mega_prog(self, src, k: int):
        """The megastep for (source physics, chunk length), built once
        each; the seed is a run-time input."""
        key = (src.physics_key(), int(k))
        if key not in self._mega_progs:
            from ..ops.source import least_sigma_t, near_epsilon
            from ..ops.walk_partitioned import make_partitioned_megastep

            cfg = self.config
            class_id = self.mesh.class_id.cpu().numpy()
            sig, ab = src.tables(class_id)
            l2g = np.clip(self.partition.local2global, 0,
                          self.mesh.ntet - 1)
            cls_local = np.clip(class_id[l2g], 0, sig.shape[0] - 1)
            kw = dict(self._step_kwargs)
            for dup in ("integrity", "convergence", "n_groups",
                        "record_xpoints"):
                kw.pop(dup)
            mega = make_partitioned_megastep(
                self.device_mesh, self.partition, n_moves=int(k),
                n_total=self.num_particles, n_groups=cfg.n_groups,
                class_local=cls_local, sigma_t=sig, absorb_t=ab,
                eps_near=near_epsilon(self.mesh.coords),
                survival_weight=float(src.survival_weight),
                downscatter=float(src.downscatter), dtype=cfg.dtype,
                integrity=self._integrity != "off",
                convergence=self._conv is not None,
                face_rate=(self._face_rate if self.device.type == "cuda"
                           else None), **kw)
            capacity = None
            if self.device.type == "cuda":
                # Each move's first walk phase: a segment a lane plus the
                # faces a mean flight of the longest mean free path
                # crosses (a walk that makes more walks again).
                est = walk_cuda.source_records(
                    self._face_rate, self.num_particles,
                    least_sigma_t(src, self.mesh.class_values))
                capacity = walk_cuda.record_capacity(self.num_particles,
                                                     est)
            self._mega_progs[key] = (mega, capacity)
        return self._mega_progs[key]

    def run_source_moves(
        self,
        n_moves: int,
        source=None,
        weights: np.ndarray | None = None,
        groups: np.ndarray | None = None,
        alive: np.ndarray | None = None,
    ) -> dict:
        """Run ``n_moves`` device-sourced moves over the partitioned walk,
        the JAX facade's contract: chunks of ``TallyConfig.megastep`` = K
        moves (``resolve_megastep``), each move the re-source keyed by
        (seed, move, particle id), the partitioned step with its
        migration and halo fold, and the physics, until ``n_moves`` ran or
        no lane is alive. The slot state stays on the device between
        chunks; ``weights``/``groups``/``alive`` (host particle order)
        re-stage those lanes (the others continue from the device state).
        A chunk makes one device→host copy (its tail) and, but for the
        staging of the slot state, no host→device copy (the move counter
        is a kernel argument; the JAX facade copies it). The random
        stream is keyed by ``iter_count``, so any K gives the same bits,
        and so does a restore into the same layout. Integrity rides the
        tail (each part's flux check and slot counts); shadow audits,
        re-walks and the host's conservation check belong to the per-move
        calls. Returns the accumulated counters (``ops/source.py``
        MEGA_PHYS_FIELDS, ``moves``, ``segments``)."""
        if not self._initialized:
            raise RuntimeError(
                "initialize_particle_location must run before source moves"
            )
        cfg = self.config
        K = cfg.resolve_megastep()
        from ..ops.source import SourceParams, phys_to_dict

        src = source if source is not None else SourceParams()
        rng_key = self._rng_key(src.seed)
        stage = dict(h2d_bytes=0, h2d_transfers=0)
        if self._src is None or any(
                a is not None for a in (weights, groups, alive)):
            nbytes = self._ensure_source_state(weights, groups, alive)
            stage = dict(h2d_bytes=nbytes, h2d_transfers=len(self._src))
        totals = {
            "moves": 0, "segments": 0, "collisions": 0, "escaped": 0,
            "rouletted": 0, "absorbed_weight": 0.0, "alive": 0,
            "truncated": 0,
        }
        integ = self._integrity != "off"
        done_moves = 0
        while done_moves < n_moves:
            k = min(K, n_moves - done_moves)
            mega, capacity = self._mega_prog(src, k)
            t_before = self.tally_times.total_time_to_tally
            with phase_timer(self.tally_times, "total_time_to_tally",
                             True) as timer:
                s, move0 = self._src, self.iter_count
                flux_in, prev_in, conv = (self.flux_slabs, self._prev_even,
                                          self._conv)
                stager = self._stager

                def go():
                    res = mega(s["pos"], s["elem"], s["material_id"],
                               s["weight"], s["group"], s["pid"], s["valid"],
                               s["alive"], flux_in, move0, rng_key,
                               conv=conv, prev_even=prev_in,
                               capacity=capacity)
                    return res, staging.to_host(stager, res.readback,
                                                "megastep")

                res, host_rb = self._dispatch(go, move0 + 1,
                                              kind=f"megastep:{k}")
                io = dict(h2d_bytes=stage["h2d_bytes"],
                          h2d_transfers=stage["h2d_transfers"],
                          d2h_bytes=host_rb.numel() * host_rb.element_size(),
                          d2h_transfers=1)
                stage = dict(h2d_bytes=0, h2d_transfers=0)
                self._src = {
                    "pos": res.position, "elem": res.elem,
                    "material_id": res.material_id, "weight": res.weight,
                    "group": res.group, "pid": res.particle_id,
                    "valid": res.valid, "alive": res.alive,
                }
                self.iter_count += k
                parsed = staging.split_partitioned_megastep_tail(
                    host_rb, cfg.dtype, integrity=integ,
                    convergence=conv is not None)
                agg = reduce_chip_stats(parsed["stats"])
                n_rounds = int(parsed["n_rounds"][0])
                if int(parsed["n_dropped"].sum()):
                    raise RuntimeError(
                        "partitioned megastep dropped immigrants: raise cap")
                segs = agg["segments"]
                self.total_segments += segs
                self.total_rounds += n_rounds
                p = phys_to_dict(parsed["phys"])
                if p["truncated"]:
                    warnings.warn(
                        f"{p['truncated']} fused-move walk(s) truncated "
                        "inside the megastep (max_crossings or the round "
                        "bound); the lanes stay alive and continue next "
                        "move, but their tallies for the truncated move "
                        "are incomplete.",
                        RuntimeWarning,
                        stacklevel=2,
                    )
                if integ:
                    from ..integrity import policy

                    ivec = np.asarray(parsed["integrity"], np.int64)
                    fields = {"bad_flux": int(ivec[:, 0].sum()),
                              "lanes_done": int(ivec[:, 2].sum())}
                    violations = ["flux"] if fields["bad_flux"] > 0 else []
                    self._telemetry.record_integrity(self.iter_count,
                                                     fields, violations)
                    policy.escalate(self._integrity, violations,
                                    self.iter_count)
                self._maybe_inject_bitflip(self.iter_count)
                if cfg.measure_time:
                    timer.sync(self.device)
            self.tally_times.n_moves += k
            seconds = self.tally_times.total_time_to_tally - t_before
            self._telemetry.record_walk(
                "megastep", self.iter_count, agg, seconds=seconds,
                synced=cfg.measure_time, moves=k, rounds=n_rounds,
                collisions=p["collisions"], escaped=p["escaped"],
                rouletted=p["rouletted"], alive=p["alive"], **io)
            if self._monitor is not None and "convergence" in parsed:
                self._monitor.update(reduce_chip_conv(parsed["convergence"]),
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
    def initialize_particle_location(
        self, init_particle_positions: np.ndarray, size: int | None = None
    ) -> None:
        """Parent-element search: every particle flies from the element-0
        seed to its source position; nothing is tallied. Quarantined
        lanes stay at the seed."""
        n = self.num_particles
        pos = np.ascontiguousarray(init_particle_positions,
                                   np.float64).reshape(-1)
        if size is None:
            size = pos.size
        if size != n * 3:
            raise ValueError(f"expected {n * 3} coordinates, got {size}")
        flags = np.ones(n, np.int8)
        dest = pos[:size].reshape(-1, 3)
        if self.config.quarantine:
            dest, _, qmask = quarantine.apply(self, dest, None, 0)
            if qmask is not None:
                flags[qmask] = 0
        self._check_finite("init_particle_positions", dest)
        self._run(dest, flags, np.ones(n), np.zeros(n, np.int32),
                  initial=True)
        self._initialized = True

    def move_to_next_location(
        self,
        particle_destinations: np.ndarray,
        flying: np.ndarray,
        weights: np.ndarray,
        groups: np.ndarray,
        material_ids: np.ndarray,
        size: int | None = None,
    ) -> None:
        """Advance the in-flight particles, tally, and write the clipped
        positions and material ids back into the caller's arrays; the
        flying flags are reset to 0 (parked and quarantined particles
        report their held position and material)."""
        if not self._initialized:
            raise RuntimeError(
                "initialize_particle_location must run before moves")
        n = self.num_particles
        dest_flat = _out_param(particle_destinations,
                               "particle_destinations", [np.float64], n * 3)
        if size is None:
            size = dest_flat.size
        if size != n * 3:
            raise ValueError(f"expected {n * 3} coordinates, got {size}")
        flying_flat = _out_param(flying, "flying", [np.int8], n)
        mats_flat = _out_param(material_ids, "material_ids", [np.int32], n)
        weights_h = np.asarray(weights, np.float64).reshape(-1)[:n]
        groups_h = np.asarray(groups, np.int32).reshape(-1)[:n]
        _check_group_range(groups_h, self.config.n_groups)
        fly = flying_flat[:n]
        dest = dest_flat[: n * 3].reshape(n, 3)
        if self.config.quarantine:
            # Sanitized copies: the caller's buffers (and a supervisor's
            # retry) keep the original inputs.
            dest, weights_h, qmask = quarantine.apply(
                self, dest, weights_h, self.iter_count + 1)
            if qmask is not None:
                fly = np.where(qmask, np.int8(0), fly)
        self._check_finite("particle_destinations", dest)
        self._check_finite("weights", weights_h)
        got, moving = self._run(dest, fly, weights_h, groups_h,
                                initial=False)
        self.iter_count += 1
        self.tally_times.n_moves += 1
        out_pos = dest_flat[: n * 3].reshape(n, 3)
        out_pos[moving] = got["position"]
        out_pos[~moving] = self.positions[~moving]
        mats_flat[:n][moving] = got["material_id"]
        mats_flat[:n][~moving] = self.material_id[~moving]
        flying_flat[:n] = 0

    # ------------------------------------------------------------------ #
    @property
    def raw_flux(self) -> np.ndarray:
        """The assembled global ``[ntet, n_groups, 2]`` accumulator (a
        host copy)."""
        slabs = self.flux_slabs.cpu().numpy().reshape(
            self.n_parts, self.partition.max_local, self.config.n_groups, 2)
        return assemble_global_flux(self.partition, slabs)

    def normalized_flux(self) -> np.ndarray:
        """[ntet, n_groups, 3] (mean, second moment, sd), on the host."""
        return normalize_flux_host(
            self.raw_flux, self.mesh.volumes.cpu().numpy(),
            self.num_particles, max(self.iter_count, 1),
            sd_mode=self.config.sd_mode)

    def reaction_rate(self, sigma: np.ndarray) -> np.ndarray:
        """Reaction-rate tally from the assembled flux (``PumiTally``'s)."""
        if self.config.sd_mode != "segment":
            raise NotImplementedError(
                "reaction_rate requires sd_mode='segment'; config has "
                f"sd_mode={self.config.sd_mode!r}")
        return reaction_rate_host(
            self.raw_flux, self.mesh.class_id.cpu().numpy(),
            np.asarray(sigma, np.float32 if self.config.dtype
                       == torch.float32 else np.float64))

    def quarantined_lanes(self) -> np.ndarray:
        """Cumulative per-lane quarantine counts, host particle order."""
        return quarantine.lanes(self)

    def intersection_points(self) -> tuple[np.ndarray, np.ndarray]:
        """Each particle's crossing points of the last call in host order,
        ``(points [n, K, 3] float64, counts [n] int32)``: the points
        migrate with their particles, so each sequence is the particle's
        path in order across parts; counts past K mean points were not
        kept. Needs ``record_xpoints=K`` and a call that ran."""
        if self.config.record_xpoints is None:
            raise ValueError(
                "set TallyConfig.record_xpoints=K to record intersection "
                "points (off by default: the hot path pays nothing)")
        if self._last_xpoints is None:
            raise RuntimeError(
                "no trace has run yet: call initialize_particle_location "
                "(and move_to_next_location) before intersection_points")
        return self._last_xpoints

    def save_checkpoint(self, filename: str,
                        n_shards: int | None = None) -> None:
        """Persist the assembled flux (layout independent), the particle
        state, the megastep's slot state and the counters
        (``utils/checkpoint.py``); resumable under another part count or
        halo depth. A ``.shards`` name writes the sharded two-phase
        layout, ``n_shards`` splits (default one a part)."""
        from ..utils.checkpoint import save_partitioned_checkpoint

        self._drain_pending()
        save_partitioned_checkpoint(filename, self, n_shards=n_shards)

    def restore_checkpoint(self, filename: str) -> None:
        """Inverse of ``save_checkpoint`` (of either package): checks the
        mesh fingerprint and the run shape before overwriting any
        state."""
        from ..utils.checkpoint import restore_partitioned_checkpoint

        self._drain_pending()
        restore_partitioned_checkpoint(filename, self)
        # The recorded points are the last call's before the restore.
        self._last_xpoints = None

    # ------------------------------------------------------------------ #
    # Convergence (obs/convergence.py; PumiTally's contract)
    # ------------------------------------------------------------------ #
    def _require_convergence(self) -> ConvergenceMonitor:
        if self._monitor is None:
            raise ValueError(
                "convergence observability is off: construct with "
                "TallyConfig(convergence=True)")
        return self._monitor

    def _reset_convergence(self) -> None:
        """Re-base the batch statistics on the current slabs (checkpoint
        restore, supervisor rollback)."""
        if self._monitor is None:
            return
        self._drain_pending()
        self._conv = ConvState(self.flux_slabs[:, 0::2].clone(),
                               torch.zeros_like(self._conv.sumsq))
        self._monitor.reset()

    def end_batch(self) -> dict:
        """Close the current batch now (the ``batch_moves`` cadence
        restarts), fold it into the per-part accumulators and return the
        refreshed convergence summary."""
        self._require_convergence()
        self._drain_pending()
        vec = fold_and_reduce(self.flux_slabs, self._conv, batch_moves=1,
                              rel_err_target=self.config.rel_err_target,
                              force=True)
        return self._monitor.update(
            reduce_chip_conv(vec.cpu().numpy()),
            self.tally_times.total_time_to_tally)

    def converged(self) -> bool:
        """Caller-driven early stop (``PumiTally.converged``)."""
        self._require_convergence()
        self._drain_pending()
        return self._monitor.converged

    def relative_error(self) -> np.ndarray:
        """Per-bin ``[ntet, n_groups]`` float64 relative error, assembled
        from the per-part accumulators (a permutation, as ``raw_flux``)."""
        self._require_convergence()
        self._drain_pending()
        g = self.config.n_groups

        def assemble(t):
            return assemble_global_flux(
                self.partition, t.cpu().numpy().reshape(
                    self.n_parts, self.partition.max_local, g, 1))[:, :, 0]

        return host_relative_error(assemble(self._conv.snap),
                                   assemble(self._conv.sumsq),
                                   self._conv.n_batches)

    def write_pumi_tally_mesh(self, filename: str | None = None,
                              uncertainty: bool = False) -> str:
        """Single-file VTK of the assembled normalized flux (with the
        ``uncertainty=True`` relative-error fields), with the phase-time
        report (``PumiTally``'s contract)."""
        self._drain_pending()
        rel = self.relative_error() if uncertainty else None
        with phase_timer(self.tally_times, "vtk_file_write_time", True):
            name = filename or self.config.output_filename
            write_flux_vtk(name, self.mesh, self.normalized_flux(),
                           rel_err=rel)
        self._telemetry.record_memory("vtk_write")
        self.tally_times.print_times()
        return name

    # ------------------------------------------------------------------ #
    def telemetry(self) -> dict:
        """Run-wide telemetry snapshot with the partitioned walk's
        per-move extras (rounds, emigrants sent, immigrants adopted,
        per-part segments and crossings) in the flight records and the
        convergence block."""
        self._drain_pending()
        out = self._telemetry.snapshot(times=self.tally_times)
        out["convergence"] = (self._monitor.snapshot()
                              if self._monitor is not None
                              else {"enabled": False})
        return out

    @property
    def metrics(self):
        """This tally's MetricsRegistry."""
        return self._telemetry.registry

    def close(self) -> None:
        """Flush the deferred telemetry folds."""
        self._drain_pending()
