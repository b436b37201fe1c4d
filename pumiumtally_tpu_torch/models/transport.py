"""Synthetic event-based Monte Carlo transport over the port's facade.

Counterpart of ``pumiumtally_tpu/models/transport.py``: it stands in for
OpenMC's event-based loop and drives ``PumiTally`` through the call
sequence the reference receives (construct, ``initialize_particle_location``,
a move per advance event, ``write_pumi_tally_mesh``), with one-speed
physics: isotropic directions, exponential free flights from a
per-material total cross-section, survival-weighting absorption,
downscatter and Russian roulette. A move that stops at a region boundary
is re-sampled in the new material, as OpenMC asks for the next advance
after a surface crossing.

Two drive modes:

  * ``mode="megastep"`` (the default): the inner event loop runs on the
    card through ``tally.run_source_moves``: flight sampling (counter-based
    random numbers keyed by (seed, move, particle id), the kernel
    ``csrc/source.cu``), the walk and the physics, ``TallyConfig.megastep``
    moves a chunk, until every particle is dead. The draws are the JAX
    package's; its outcomes differ from host mode's statistically, not
    physically.
  * ``mode="host"``: the per-event host loop, the OpenMC call pattern
    (``move_to_next_location`` per advance event, numpy draws).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..api import PumiTally
from ..ops.source import SourceParams, near_epsilon


@dataclasses.dataclass(frozen=True)
class Material:
    """One-speed material of a mesh region (class id)."""

    sigma_t: float = 1.0       # total macroscopic cross-section [1/cm]
    absorption: float = 0.3    # absorbed fraction per collision


@dataclasses.dataclass
class TransportStats:
    batches: int = 0
    events: int = 0
    collisions: int = 0
    absorbed_weight: float = 0.0
    boundary_escapes: int = 0
    roulette_kills: int = 0


class SyntheticTransport:
    """Event-based transport of the tally's particles, a batch at a time.

    Args:
      tally: the PumiTally to drive.
      materials: class id → Material; other ids use ``Material()``.
      source_box: (lo, hi) corners of the uniform source region (default
        the mesh's box less 5% on each side).
      survival_weight: weight floor below which Russian roulette fires.
      max_events: cap on advance events a batch.
      seed: numpy seed of the source positions (and, in host mode, of the
        flights; in megastep mode each batch draws its source seed from
        it).
      mode: "megastep" (the default) or "host".
    """

    def __init__(
        self,
        tally: PumiTally,
        materials: dict[int, Material] | None = None,
        source_box: tuple[np.ndarray, np.ndarray] | None = None,
        survival_weight: float = 0.1,
        max_events: int = 1000,
        seed: int = 0,
        mode: str = "megastep",
    ):
        if mode not in ("megastep", "host"):
            raise ValueError(
                f"mode must be 'megastep' or 'host': {mode!r}"
            )
        self.mode = mode
        self.tally = tally
        self.materials = materials or {}
        self.default_material = Material()
        coords = tally.mesh.coords.cpu().numpy().astype(np.float64)
        if source_box is None:
            lo, hi = coords.min(axis=0), coords.max(axis=0)
            pad = 0.05 * (hi - lo)
            source_box = (lo + pad, hi - pad)
        self.source_box = source_box
        self.survival_weight = float(survival_weight)
        self.max_events = int(max_events)
        self.rng = np.random.default_rng(seed)
        self.stats = TransportStats()
        self._class_id = tally.mesh.class_id.cpu().numpy().astype(np.int64)
        self._eps = near_epsilon(tally.mesh.coords)

    # ------------------------------------------------------------------ #
    def _by_material(self, material_ids: np.ndarray, field: str
                     ) -> np.ndarray:
        out = np.full(material_ids.shape,
                      getattr(self.default_material, field), np.float64)
        for cid, mat in self.materials.items():
            out[material_ids == cid] = getattr(mat, field)
        return out

    def _isotropic(self, n: int) -> np.ndarray:
        mu = self.rng.uniform(-1.0, 1.0, n)
        phi = self.rng.uniform(0.0, 2 * np.pi, n)
        s = np.sqrt(1.0 - mu * mu)
        return np.stack([s * np.cos(phi), s * np.sin(phi), mu], axis=1)

    def _source_params(self) -> SourceParams:
        """The Material map as the megastep's SourceParams, with a seed
        drawn per batch (batches independent, runs reproducible)."""
        return SourceParams(
            sigma_t={int(c): m.sigma_t for c, m in self.materials.items()},
            absorption={int(c): m.absorption
                        for c, m in self.materials.items()},
            default_sigma_t=self.default_material.sigma_t,
            default_absorption=self.default_material.absorption,
            survival_weight=self.survival_weight,
            seed=int(self.rng.integers(0, 2**31 - 1)),
        )

    def start_batch(self) -> np.ndarray:
        """Sample the batch's source positions and locate them; returns
        the positions ``[n, 3]``."""
        t = self.tally
        lo, hi = self.source_box
        pos = self.rng.uniform(lo, hi, (t.num_particles, 3))
        t.initialize_particle_location(pos.ravel())
        return pos

    def run_batch(self) -> None:
        """One source batch: sample sources, then advance events until
        every particle is absorbed, escaped or rouletted."""
        pos = self.start_batch()
        if self.mode == "megastep":
            n = self.tally.num_particles
            out = self.tally.run_source_moves(
                self.max_events, self._source_params(),
                weights=np.ones(n), groups=np.zeros(n, np.int32),
                alive=np.ones(n, bool),
            )
            self.stats.events += out["moves"]
            self.stats.collisions += out["collisions"]
            self.stats.absorbed_weight += out["absorbed_weight"]
            self.stats.boundary_escapes += out["escaped"]
            self.stats.roulette_kills += out["rouletted"]
            self.stats.batches += 1
            return
        state = self.host_state(pos)
        for _ in range(self.max_events):
            if not self.host_event(state):
                break
        self.stats.batches += 1

    def host_state(self, pos: np.ndarray) -> dict:
        """Host-mode particle bookkeeping (OpenMC's side of the pairing)
        of a batch that starts at ``pos``: the material at the source site
        is the parent element's region."""
        n = self.tally.num_particles
        return dict(cur=pos.copy(), weight=np.ones(n),
                    alive=np.ones(n, bool), group=np.zeros(n, np.int32),
                    material=self._class_id[
                        self.tally.element_ids].astype(np.int32))

    def host_event(self, st: dict) -> bool:
        """One host-mode advance event (one ``move_to_next_location``);
        False, without a move, when no particle is alive."""
        t, n = self.tally, self.tally.num_particles
        cur, weight, alive = st["cur"], st["weight"], st["alive"]
        group, material = st["group"], st["material"]
        if not alive.any():
            return False
        sigma = self._by_material(material, "sigma_t")
        dist = self.rng.exponential(1.0 / np.maximum(sigma, 1e-30))
        dest = cur + self._isotropic(n) * dist[:, None]
        flying = alive.astype(np.int8)
        mats_out = material.copy()
        t.move_to_next_location(dest, flying, weight, group, mats_out)
        self.stats.events += 1

        # The reference's out-param contract: material id >= 0 is a stop
        # at a region boundary; -1 a reached destination or an exit, told
        # apart by whether the walked distance covers the sampled flight.
        traveled = np.linalg.norm(dest - cur, axis=1)
        near = dist - traveled < self._eps
        reached = alive & (mats_out < 0) & near
        crossed = alive & (mats_out >= 0)
        escaped = alive & (mats_out < 0) & ~near

        self.stats.collisions += int(reached.sum())
        absorb = self._by_material(material, "absorption")
        self.stats.absorbed_weight += float(
            (weight[reached] * absorb[reached]).sum())
        weight[reached] *= 1.0 - absorb[reached]
        if t.config.n_groups > 1:
            down = reached & (self.rng.random(n) < 0.5)
            group[down] = np.minimum(group[down] + 1, t.config.n_groups - 1)

        material[crossed] = mats_out[crossed]
        self.stats.boundary_escapes += int(escaped.sum())
        alive[escaped] = False

        low = alive & (weight < self.survival_weight)
        lucky = low & (self.rng.random(n) < 0.5)
        killed = low & ~lucky
        weight[lucky] *= 2.0
        alive[killed] = False
        self.stats.roulette_kills += int(killed.sum())
        st["cur"] = dest
        return True

    def run(self, batches: int, output: str | None = None) -> TransportStats:
        for _ in range(batches):
            self.run_batch()
        if output is not None:
            self.tally.write_pumi_tally_mesh(output)
        return self.stats
