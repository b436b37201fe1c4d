"""Particle state as flat structure-of-arrays torch tensors.

Counterpart of ``pumiumtally_tpu/core/state.py``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class ParticleState:
    origin: torch.Tensor       # [n, 3] mesh dtype
    dest: torch.Tensor         # [n, 3]
    particle_id: torch.Tensor  # [n] int32
    in_flight: torch.Tensor    # [n] bool
    weight: torch.Tensor       # [n]
    group: torch.Tensor        # [n] int32
    elem: torch.Tensor         # [n] int32 parent element
    material_id: torch.Tensor  # [n] int32

    @property
    def capacity(self) -> int:
        return int(self.origin.shape[0])

    def replace(self, **changes) -> "ParticleState":
        return dataclasses.replace(self, **changes)


def make_particle_state(
    n: int, dtype: torch.dtype = torch.float32, device=None
) -> ParticleState:
    """n unplaced particles on ``device`` (default the CUDA card;
    ``utils/platform.py::resolve_device``)."""
    device = resolve_device(device)

    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=device)

    return ParticleState(
        origin=full((n, 3), 0, dtype),
        dest=full((n, 3), 0, dtype),
        particle_id=torch.arange(n, dtype=torch.int32, device=device),
        in_flight=full((n,), True, torch.bool),
        weight=full((n,), 0, dtype),
        group=full((n,), 0, torch.int32),
        elem=full((n,), 0, torch.int32),
        material_id=full((n,), -1, torch.int32),
    )


def seed_at_element_centroid(
    state: ParticleState, mesh, elem_id: int = 0
) -> ParticleState:
    """Seed every particle at the centroid of one element (the reference
    starts all particles at element 0's centroid so the initial search can
    walk them to their true source positions). The centroid is summed in
    vertex order in the mesh dtype."""
    v = mesh.coords[mesh.tet2vert[elem_id].long()]
    centroid = (((v[0] + v[1]) + v[2]) + v[3]) / 4.0
    n = state.capacity
    return state.replace(
        origin=centroid.to(state.origin.dtype).expand(n, 3).contiguous(),
        elem=torch.full_like(state.elem, elem_id),
        in_flight=torch.ones_like(state.in_flight),
    )
