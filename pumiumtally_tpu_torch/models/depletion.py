"""A toy depletion loop: transport → reaction rates → density update →
repeat.

Counterpart of ``pumiumtally_tpu/models/depletion.py``: each depletion
step runs a batch of synthetic transport (``models/transport.py``) into
a fresh flux, derives the absorption reaction rate per element from it
(``PumiTally.reaction_rate``), integrates the rate over each region to
burn the region's number density, and rebuilds the materials for the
next step. The physics is minimal (one nuclide a region, N' =
N·exp(−c·rate·dt)); the point is the workflow a depletion driver needs:
repeated accumulate / derive / mutate cycles over the same mesh on the
device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..api import PumiTally
from .transport import Material, SyntheticTransport


@dataclasses.dataclass
class RegionNuclide:
    """One-nuclide region inventory: number density N [atoms/b-cm] and
    microscopic cross-sections [barns]."""

    density: float = 1.0
    micro_total: float = 2.0
    micro_absorption: float = 0.8


@dataclasses.dataclass
class DepletionStepResult:
    step: int
    densities: dict[int, float]
    absorption_rate: dict[int, float]
    total_flux: float


class DepletionLoop:
    """Run coupled transport/depletion steps.

    Args:
      tally: PumiTally on a mesh whose class ids key ``inventory``; its
        num_particles is the batch of each transport solve.
      inventory: region id → RegionNuclide (updated in place).
      dt: depletion time step (rates are per unit flux).
      seed: the transport driver's seed (step i uses seed + i).
      mode: the transport drive, "megastep" (the device-sourced fused
        loop, TallyConfig(megastep=K) moves a dispatch) or "host" (the
        per-event loop); see models/transport.py.
    """

    def __init__(self, tally: PumiTally,
                 inventory: dict[int, RegionNuclide], dt: float = 0.1,
                 seed: int = 0, mode: str = "megastep"):
        self.tally = tally
        self.inventory = inventory
        self.dt = float(dt)
        self.seed = seed
        self.mode = mode
        self.history: list[DepletionStepResult] = []
        cls = tally.mesh.class_id.cpu().numpy()
        self._region_elems = {rid: cls == rid for rid in inventory}

    def _materials(self) -> dict[int, Material]:
        return {
            rid: Material(
                sigma_t=max(inv.density * inv.micro_total, 1e-6),
                absorption=inv.micro_absorption / inv.micro_total)
            for rid, inv in self.inventory.items()
        }

    def _sigma_abs_table(self) -> np.ndarray:
        sig = np.zeros((max(self.inventory) + 1,
                        self.tally.config.n_groups))
        for rid, inv in self.inventory.items():
            sig[rid, :] = inv.density * inv.micro_absorption
        return sig

    def step(self) -> DepletionStepResult:
        i = len(self.history)
        # A fresh accumulator a step, so the rates are this step's.
        self.tally.flux = self.tally.flux * 0
        SyntheticTransport(self.tally, materials=self._materials(),
                           seed=self.seed + i, mode=self.mode).run_batch()
        rates = self.tally.reaction_rate(self._sigma_abs_table())
        abs_rate = {}
        for rid, mask in self._region_elems.items():
            abs_rate[rid] = float(rates[mask, :, 0].sum())
            inv = self.inventory[rid]
            # N' = N·exp(−(rate/N)·dt): the per-atom burn from the
            # region's integrated absorption, kept above zero.
            burn = abs_rate[rid] / max(inv.density, 1e-12)
            inv.density = max(inv.density * float(np.exp(-burn * self.dt)),
                              1e-6)
        result = DepletionStepResult(
            step=i,
            densities={r: inv.density for r, inv in self.inventory.items()},
            absorption_rate=abs_rate,
            total_flux=float(self.tally.raw_flux[..., 0].sum()))
        self.history.append(result)
        return result

    def run(self, n_steps: int) -> list[DepletionStepResult]:
        for _ in range(n_steps):
            self.step()
        return self.history
