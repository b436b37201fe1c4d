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
plain version. Parts on several devices (NCCL) are ROADMAP.md A9b.

``TallyConfig.io_pipeline``: "packed" (default) and "overlap" stage the
slot distribution as ONE carrier record (``staging.pack_partitioned_
record``) and read ONE readback a call; "legacy" copies each distributed
array and each collected one. The three give the same bits.

Not ported with this slice (each raises NotImplementedError naming
ROADMAP.md A9b when asked for): integrity checks, shadow audits and
``move_deadline_s``; quarantine; truncation re-walks (when a lane
truncates); convergence; ``record_xpoints``, ``checkify_invariants`` and
``sort_by_element``; checkpoints; ``run_source_moves``.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..api import _check_group_range, _out_param
from ..core.tally import (
    accumulate_batch_squares,
    normalize_flux_host,
    reaction_rate_host,
)
from ..io.vtk import write_flux_vtk
from ..obs.telemetry import TallyTelemetry
from ..obs.walk_stats import WALK_STATS_FIELDS, reduce_chip_stats
from ..ops import staging, walk_cuda
from ..ops.walk_partitioned import (
    A9B,
    collect_by_particle_id,
    distribute_particles,
    make_partitioned_step,
)
from ..utils.config import TallyConfig
from ..utils.platform import resolve_device
from ..utils.timing import StepClock, TallyTimes, clock_step, phase_timer
from .mesh_partition import assemble_global_flux, partition_mesh
from .particle_sharding import make_device_mesh

_SEGMENTS = WALK_STATS_FIELDS.index("segments")
_CROSSINGS = WALK_STATS_FIELDS.index("crossings")


def _unported(what: str):
    return NotImplementedError(
        f"PartitionedTally: {what} is not ported yet ({A9B})")


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
        if cfg.sd_mode not in ("segment", "batch"):
            raise ValueError(
                f"sd_mode must be 'segment' or 'batch': {cfg.sd_mode!r}")
        if mesh.dtype != cfg.dtype:
            raise ValueError(
                f"mesh dtype {mesh.dtype} != config dtype {cfg.dtype}")
        for what, asked in (
            ("integrity", cfg.resolve_integrity() != "off"),
            ("the shadow audit (audit_lanes)", bool(cfg.audit_lanes)),
            ("move_deadline_s", cfg.move_deadline_s is not None),
            ("quarantine", bool(cfg.quarantine)),
            ("convergence", cfg.resolve_convergence() is not None),
            ("record_xpoints", cfg.record_xpoints is not None),
            ("checkify_invariants", bool(cfg.checkify_invariants)),
            ("sort_by_element", bool(cfg.sort_by_element)),
        ):
            if asked:
                raise _unported(what)
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
            compact_after=cfg.compact_after,
            compact_size=cfg.compact_size,
            exchange_size=exchange_size,
            max_rounds=max_rounds,
        )
        self._steps: dict = {}
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

    def _run(self, dest, in_flight, weight, group, initial):
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
        seconds = getattr(self.tally_times, field) - t_before

        def fold():
            self._telemetry.record_walk(kind, move_no, agg, seconds=seconds,
                                        synced=self.config.measure_time,
                                        **stats)

        if self._io == "overlap" and not initial:
            self._pending_folds.append(fold)
        else:
            fold()
        return got, moving

    def _run_inner(self, dest, in_flight, weight, group, initial):
        moving = in_flight != 0
        got, stats = self._walk_once(dest, moving, weight, group, initial)
        n_lost = stats["agg"]["truncated"]
        if n_lost and self.config.truncation_retries > 0:
            raise _unported("the truncation re-walk")
        if self._prev_even is not None and not initial:
            accumulate_batch_squares(self.flux_slabs.view(-1),
                                     self._prev_even)
        if n_lost:
            self._telemetry.record_rewalk(
                self.iter_count + (0 if initial else 1), 0, n_lost)
            warnings.warn(
                f"{n_lost} partitioned walk(s) truncated (max_crossings="
                f"{self._step_kwargs['max_crossings']} or the migration "
                "round bound); tallies for them are incomplete. Raise "
                "TallyConfig.max_crossings / max_rounds or set "
                "truncation_retries for bounded re-walk escalation.",
                RuntimeWarning,
                stacklevel=4,
            )
        return got, moving, stats

    def _fields(self, dest, moving, weight, group) -> dict:
        return dict(origin=self.positions[moving], dest=dest[moving],
                    weight=weight[moving], group=group[moving],
                    material_id=self.material_id[moving])

    def _walk_once(self, dest, moving, weight, group, initial):
        """One distribute → partitioned step → collect pass over the
        ``moving`` subset; packed unless io_pipeline="legacy"."""
        n_moving = int(moving.sum())
        capacity = self._capacity(moving, dest, initial)
        clock = self.step_clock
        if self._io != "legacy":
            with clock_step(clock, "pack"):
                rec_h = staging.pack_partitioned_record(
                    self.partition, self.elem_global[moving],
                    self._fields(dest, moving, weight, group), self.cap,
                    self.config.dtype, self._stager)
            with clock_step(clock, "h2d"):
                rec = rec_h.to(self.device, non_blocking=True)
            with clock_step(clock, "step"):
                res = self._step(initial)(rec, self.flux_slabs,
                                          capacity=capacity)
            if self._io == "overlap":
                self._drain_pending()
            with clock_step(clock, "readback"):
                host_rb = staging.to_host(self._stager, res.readback,
                                          "part_readback")
            io = dict(h2d_bytes=rec_h.numel() * rec_h.element_size(),
                      h2d_transfers=1,
                      d2h_bytes=host_rb.numel() * host_rb.element_size(),
                      d2h_transfers=1)
            with clock_step(clock, "collect"):
                parsed = staging.split_partitioned_readback(
                    host_rb, self.n_parts, self.cap, self.config.dtype)
                got = staging.collect_packed(parsed, n_moving,
                                             self.partition)
            sv, rs = parsed["stats"], parsed["round_stats"]
            n_rounds = int(parsed["n_rounds"][0])
            n_dropped = int(parsed["n_dropped"].sum())
        else:
            with clock_step(clock, "distribute"):
                placed = distribute_particles(
                    self.partition, self.device_mesh,
                    self.elem_global[moving],
                    self._fields(dest, moving, weight, group), cap=self.cap)
            dt = self.config.dtype
            with clock_step(clock, "step"):
                res = self._step(initial)(
                    placed["origin"].to(dt), placed["dest"].to(dt),
                    placed["elem"], torch.zeros_like(placed["valid"]),
                    placed["material_id"], placed["weight"].to(dt),
                    placed["group"], placed["particle_id"],
                    placed["valid"], self.flux_slabs, capacity=capacity)
            with clock_step(clock, "collect"):
                got = collect_by_particle_id(res, n_moving, self.partition)
                reads = [res.stats, res.round_stats, res.n_rounds,
                         res.n_dropped]
                sv, rs, nr, nd = (t.cpu().numpy() for t in reads)
            n_rounds, n_dropped = int(nr[0]), int(nd.sum())
            collected = ("particle_id", "valid", "position", "material_id",
                         "done", "elem", "weight", "group", "track_length")
            d2h = [getattr(res, f) for f in collected] + reads
            io = dict(
                h2d_bytes=sum(t.numel() * t.element_size()
                              for t in placed.values()),
                h2d_transfers=len(placed),
                d2h_bytes=sum(t.numel() * t.element_size() for t in d2h),
                d2h_transfers=len(d2h))
        if n_dropped != 0:
            raise RuntimeError(
                "partitioned walk dropped immigrants: raise cap")
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
        }
        self.total_segments += agg["segments"]
        self.total_rounds += n_rounds
        return got, stats

    # ------------------------------------------------------------------ #
    def initialize_particle_location(
        self, init_particle_positions: np.ndarray, size: int | None = None
    ) -> None:
        """Parent-element search: every particle flies from the element-0
        seed to its source position; nothing is tallied."""
        n = self.num_particles
        pos = np.ascontiguousarray(init_particle_positions,
                                   np.float64).reshape(-1)
        if size is None:
            size = pos.size
        if size != n * 3:
            raise ValueError(f"expected {n * 3} coordinates, got {size}")
        self._run(pos[:size].reshape(-1, 3), np.ones(n, np.int8),
                  np.ones(n), np.zeros(n, np.int32), initial=True)
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
        flying flags are reset to 0 (parked particles report their held
        position and material)."""
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
        dest = dest_flat[: n * 3].reshape(n, 3)
        got, moving = self._run(dest, flying_flat[:n], weights_h, groups_h,
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

    def intersection_points(self) -> tuple[np.ndarray, np.ndarray]:
        """Recorded crossing points: ``record_xpoints`` is refused at
        construction (ROADMAP.md A9b), so this raises as without it."""
        raise ValueError(
            "set TallyConfig.record_xpoints=K to record intersection "
            "points (off by default: the hot path pays nothing)")

    def save_checkpoint(self, filename: str,
                        n_shards: int | None = None) -> None:
        raise _unported("save_checkpoint")

    def restore_checkpoint(self, filename: str) -> None:
        raise _unported("restore_checkpoint")

    def run_source_moves(self, *args, **kwargs):
        raise _unported("run_source_moves (the partitioned megastep)")

    def _require_convergence(self):
        raise ValueError(
            "convergence observability is off: construct with "
            "TallyConfig(convergence=True)")

    def end_batch(self) -> dict:
        return self._require_convergence()

    def converged(self) -> bool:
        return self._require_convergence()

    def relative_error(self) -> np.ndarray:
        return self._require_convergence()

    def write_pumi_tally_mesh(self, filename: str | None = None,
                              uncertainty: bool = False) -> str:
        """Single-file VTK of the assembled normalized flux, with the
        phase-time report (``PumiTally``'s contract)."""
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
        per-part segments and crossings) in the flight records."""
        self._drain_pending()
        out = self._telemetry.snapshot(times=self.tally_times)
        out["convergence"] = {"enabled": False}
        return out

    @property
    def metrics(self):
        """This tally's MetricsRegistry."""
        return self._telemetry.registry

    def close(self) -> None:
        """Flush the deferred telemetry folds."""
        self._drain_pending()
