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
the CUDA card) between calls. Each move copies its inputs host→device
and brings positions, material ids and the walk stats vector back in one
device→host copy. On the card the walk is the CUDA kernel
``csrc/walk.cu``; on the CPU it is the plain PyTorch walk.
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
from .ops import walk_cuda
from .utils.config import TallyConfig
from .utils.platform import resolve_device
from .utils.timing import TallyTimes, phase_timer

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
            # buffers are sized from it.
            self._last_segments: int | None = None
            self._initialized = False
            timer.sync(self.device)

    # ------------------------------------------------------------------ #
    def _walk(self, dest, in_flight, weight, group, *, initial: bool):
        cfg = self.config
        s = self.state
        capacity = None if initial else self._record_capacity(dest, in_flight)
        return walk_cuda.trace(
            self.mesh, s.origin, dest, s.elem, in_flight, weight, group,
            s.material_id, self.flux,
            initial=initial,
            max_crossings=self._max_crossings,
            n_groups=cfg.n_groups,
            score_squares=cfg.score_squares,
            tolerance=cfg.tolerance,
            robust=cfg.robust,
            ledger=cfg.ledger,
            stats=cfg.walk_stats,
            capacity=capacity,
        )

    def _record_capacity(self, dest, in_flight) -> int:
        """Tally records the ordered walk's buffers hold for this move
        (a walk that makes more runs again): 5/4 of an estimate, at least
        4 per lane. The estimate is the last move's segments; before the
        first move, one segment per flying lane plus the faces its straight
        path crosses at the mesh's rate for an isotropic line, S/(4V) with
        S the elements' summed face areas and V their volume."""
        n = self.num_particles
        if self._last_segments is not None:
            est = self._last_segments
        else:
            # Elementwise ops in the mesh dtype, sums in float64.
            f64 = torch.float64
            v = self.mesh.coords[self.mesh.tet2vert.long()]
            area = 0.0
            for a, b, c in ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)):
                p, q = v[:, b] - v[:, a], v[:, c] - v[:, a]
                x = p[:, 1] * q[:, 2] - p[:, 2] * q[:, 1]
                y = p[:, 2] * q[:, 0] - p[:, 0] * q[:, 2]
                z = p[:, 0] * q[:, 1] - p[:, 1] * q[:, 0]
                area = area + (x * x + y * y + z * z).sqrt().sum(dtype=f64)
            rate = area / 2 / (4 * self.mesh.volumes.sum(dtype=f64))
            d = dest - self.state.origin
            path = ((d * d).sum(dim=1).sqrt() * in_flight).sum(dtype=f64)
            est = float(in_flight.sum() + rate * path)
        return max(4 * n, int(np.ceil(1.25 * est)))

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

    def _put(self, host: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """Host→device copy of one input array (converted on the host)."""
        return torch.from_numpy(
            np.ascontiguousarray(host, _NP_DTYPES.get(dtype, host.dtype))
        ).to(self.device)

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
        with phase_timer(
            self.tally_times, "initialization_time", True
        ) as timer:
            dest = self._put(pos[:size].reshape(n, 3), cfg.dtype)
            fly = torch.ones(n, dtype=torch.bool, device=self.device)
            s = self.state
            r = self._walk(dest, fly, s.weight, s.group, initial=True)
            self.flux = r.flux
            self.state = s.replace(origin=r.position, dest=dest, elem=r.elem)
            (summary,) = _to_host(self._summary(r))
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
        dest_flat = _out_param(
            particle_destinations, "particle_destinations", [np.float64], n * 3
        )
        if size is None:
            size = dest_flat.size
        if size != n * 3:
            raise ValueError(f"expected {n * 3} coordinates, got {size}")
        flying_flat = _out_param(flying, "flying", [np.int8], n)
        mats_flat = _out_param(material_ids, "material_ids", [np.int32], n)
        weights_h = np.asarray(weights, dtype=np.float64).reshape(-1)[:n]
        groups_h = np.asarray(groups, dtype=np.int32).reshape(-1)[:n]
        _check_group_range(groups_h, cfg.n_groups)
        fly_h = flying_flat[:n] != 0
        dest3_h = dest_flat[: n * 3].reshape(n, 3)

        with phase_timer(
            self.tally_times, "total_time_to_tally", True
        ) as timer:
            dest = self._put(dest3_h, cfg.dtype)
            in_flight = self._put(fly_h, torch.bool)
            weight = self._put(weights_h, cfg.dtype)
            group = self._put(groups_h, torch.int32)
            r = self._walk(dest, in_flight, weight, group, initial=False)
            self.flux = r.flux
            self.state = self.state.replace(
                origin=r.position,
                dest=dest,
                in_flight=in_flight,
                weight=weight,
                group=group,
                elem=r.elem,
                material_id=r.material_id,
            )
            self.iter_count += 1
            summary, final_pos, final_mats = _to_host(
                self._summary(r), r.position, r.material_id
            )
            # Copy-back contract: clipped final positions and material
            # ids into the caller's arrays, flying flags reset to 0.
            dest_flat[: n * 3].reshape(n, 3)[:] = final_pos
            mats_flat[:n] = final_mats
            flying_flat[:n] = 0
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
