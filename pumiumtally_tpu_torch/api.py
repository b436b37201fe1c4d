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
    used in turns. The JAX facade also defers its telemetry fold past the
    move there; the port has no telemetry to fold yet (A10), so the two
    modes differ only in their buffers.
  * ``"legacy"``: four pageable host→device copies (destinations, flags,
    weights, groups, each converted by numpy first) and one
    device→host copy of the stats, positions and material ids.

``PumiTally.io`` counts the facade's transfers (``h2d_transfers``,
``h2d_bytes``, ``d2h_transfers``, ``d2h_bytes``) as the JAX facade's
telemetry totals count them: a packed move makes one each way, a legacy
move four host→device and one device→host. The ordered walk's own host
reads on the card (the record count in ``ops/walk_cuda.py``, the bucket
information in ``ops/scatter.py``) happen inside the walk wrapper and are
not counted (ROADMAP.md B2). ``PumiTally.step_clock`` set to a
``utils/timing.py::StepClock`` times each host step of a call.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .core.state import ParticleState, make_particle_state, seed_at_element_centroid
from .core.tally import make_flux, normalize_flux_host
from .io.vtk import write_flux_vtk
from .mesh.core import TetMesh
from .mesh.io import load_mesh
from .obs.walk_stats import stats_to_dict
from .ops import staging, walk_cuda
from .ops.staging import HostStager, host_tensor
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
            # Host↔device transfers the facade made, as the JAX facade's
            # telemetry totals count them.
            self.io = dict(h2d_transfers=0, h2d_bytes=0, d2h_transfers=0,
                           d2h_bytes=0)
            # Set to a StepClock to time each host step of the calls.
            self.step_clock: StepClock | None = None
            timer.sync(self.device)

    # ------------------------------------------------------------------ #
    def _walk_kw(self, initial: bool) -> dict:
        cfg = self.config
        return dict(
            initial=initial,
            max_crossings=self._max_crossings,
            n_groups=cfg.n_groups,
            score_squares=cfg.score_squares,
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

    def _fetch(self, readback: torch.Tensor):
        """The packed readback's one device→host copy, as views
        (``staging.readback_views``: positions, material ids, done words,
        tail)."""
        self._count("d2h", readback.numel() * readback.element_size())
        host = staging.to_host(self._stager, readback)
        return staging.readback_views(host, self.num_particles,
                                      self.config.dtype)

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

    def _account(self, summary: np.ndarray) -> int:
        """Fold a walk's host summary; returns its scored segments and
        warns on truncated walks."""
        if self.config.walk_stats:
            self.last_stats = stats_to_dict(summary)
            segs = self.last_stats["segments"]
            n_lost = self.last_stats["truncated"]
        else:
            segs, n_lost = int(summary[0]), int(summary[1])
        if n_lost:
            warnings.warn(
                f"{n_lost} particle walk(s) truncated at max_crossings="
                f"{self._max_crossings}; tallies for them are incomplete. "
                "Raise TallyConfig.max_crossings.",
                RuntimeWarning,
                stacklevel=3,
            )
        return segs

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
        self._origin_h = pos3.copy()
        s = self.state
        with phase_timer(
            self.tally_times, "initialization_time", True
        ) as timer:
            if self._io != "legacy":
                rec = staging.pack_init_record(
                    self._stager, pos3, np.ones(n, bool), cfg.dtype
                )
                r, readback, dest, _, _, _ = walk_cuda.trace_packed(
                    self.mesh, s.origin, s.elem, s.material_id,
                    self._put_record(rec), self.flux, None,
                    weight=s.weight, group=s.group, **self._walk_kw(True),
                )
                _, _, done_h, tail = self._fetch(readback)
                summary = self._packed_summary(tail, done_h)
            else:
                dest = self._put(_convert(pos3, cfg.dtype))
                fly = torch.ones(n, dtype=torch.bool, device=self.device)
                r = walk_cuda.trace(
                    self.mesh, s.origin, dest, s.elem, fly, s.weight,
                    s.group, s.material_id, self.flux,
                    **self._walk_kw(True),
                )
                (summary,) = self._to_host(self._summary(r))
            self.flux = r.flux
            self.state = s.replace(origin=r.position, dest=dest, elem=r.elem)
            self._account(summary)
            self._initialized = True
            if cfg.measure_time:
                timer.sync(self.device)

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
            dest3_h = dest_flat[: n * 3].reshape(n, 3)

        with phase_timer(
            self.tally_times, "total_time_to_tally", True
        ) as timer:
            s = self.state
            with step("capacity"):
                kw = dict(self._walk_kw(False),
                          capacity=self._record_capacity(dest3_h, fly_h))
            if self._io != "legacy":
                with step("pack"):
                    rec = staging.pack_move_record(
                        self._stager, dest3_h, weights_h, groups_h, fly_h,
                        cfg.dtype,
                    )
                with step("put record"):
                    rec_dev = self._put_record(rec)
                with step("walk"):
                    r, readback, dest, in_flight, weight, group = (
                        walk_cuda.trace_packed(
                            self.mesh, s.origin, s.elem, s.material_id,
                            rec_dev, self.flux, None, **kw,
                        )
                    )
                with step("readback"):
                    final_pos, final_mats, done_h, tail = self._fetch(
                        readback
                    )
                with step("write-back"):
                    # Copy-back contract: clipped final positions and
                    # material ids into the caller's arrays, flying flags
                    # reset to 0 (threaded torch copies, the first a cast).
                    host_tensor(dest3_h).copy_(torch.from_numpy(final_pos))
                    host_tensor(mats_flat[:n]).copy_(
                        torch.from_numpy(final_mats)
                    )
                    flying_flat[:n] = 0
                summary = self._packed_summary(tail, done_h)
            else:
                with step("convert"):
                    dest_c = _convert(dest3_h, cfg.dtype)
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
                with step("to_host"):
                    summary, final_pos, final_mats = self._to_host(
                        self._summary(r), r.position, r.material_id
                    )
                with step("write-back"):
                    # Copy-back contract, as above (numpy casts).
                    dest3_h[:] = final_pos
                    mats_flat[:n] = final_mats
                    flying_flat[:n] = 0
            self.flux = r.flux
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
            self._last_segments = self._account(summary)
            self.total_segments += self._last_segments
            if cfg.measure_time:
                timer.sync(self.device)
        self.tally_times.n_moves += 1

    # ------------------------------------------------------------------ #
    @property
    def raw_flux(self) -> np.ndarray:
        """Unnormalized [ntet, n_groups, 2] (Σ w·len, Σ (w·len)²), a host
        copy."""
        return self.flux.to("cpu", copy=True).numpy().reshape(
            self.mesh.ntet, self.config.n_groups, 2
        )

    @property
    def element_ids(self) -> np.ndarray:
        """Current parent element per particle (a host copy)."""
        return self.state.elem.to("cpu", copy=True).numpy()

    def normalized_flux(self) -> np.ndarray:
        """[ntet, n_groups, 3] (mean, second moment, sd), on the host."""
        return normalize_flux_host(
            self.raw_flux,
            self.mesh.volumes.cpu().numpy(),
            self.num_particles,
            max(self.iter_count, 1),
        )

    def write_pumi_tally_mesh(self, filename: str | None = None) -> str:
        """Normalize the flux, write one ``flux_group_<g>`` cell field per
        group plus ``volume`` (.vtu, or legacy .vtk by extension), and log
        the phase times."""
        with phase_timer(
            self.tally_times, "vtk_file_write_time", True
        ):
            out = filename or self.config.output_filename
            write_flux_vtk(out, self.mesh, self.normalized_flux())
        self.tally_times.print_times()
        return out
