"""The benchmark problems' geometries (the BASELINE.md ladder).

Counterpart of ``pumiumtally_tpu/models/problems.py``, with the same
class ids (0 = moderator, 1..k = pins; the reference's class_id tag on
every input mesh):

  * ``unit_cube`` — config 1: a homogeneous unit cube;
  * ``pincell`` — config 2: one absorber pin in moderator;
  * ``assembly`` — configs 3/4: an N×N pin lattice (material-boundary
    stops on every pin surface).

Regions are decided on the host from the elements' float64 centroids, so
a mesh here has the JAX package's class ids bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..mesh.box import build_box, build_box_arrays
from ..mesh.core import TetMesh


def unit_cube(cells: int = 12, dtype=torch.float32, device=None) -> TetMesh:
    """Homogeneous unit cube; 6·cells³ tets."""
    return build_box(1.0, 1.0, 1.0, cells, cells, cells, dtype=dtype,
                     device=device)


def pincell(cells: int = 16, pin_radius: float = 0.25,
            dtype=torch.float32, device=None) -> TetMesh:
    """One z-aligned absorber pin (region 1) centred in moderator
    (region 0)."""
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, cells, cells, cells)
    centroids = coords[tets].mean(axis=1)
    r = np.linalg.norm(centroids[:, :2] - 0.5, axis=1)
    class_id = (r < pin_radius).astype(np.int32)
    return TetMesh.from_numpy(coords, tets, class_id, dtype=dtype,
                              device=device)


def assembly(cells: int = 32, lattice: int = 3,
             pin_radius_frac: float = 0.35, dtype=torch.float32,
             device=None) -> TetMesh:
    """An N×N pin lattice in a unit box: pin (i, j) is region
    1 + i·lattice + j, moderator region 0; 6·cells³ tets."""
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, cells, cells, cells)
    centroids = coords[tets].mean(axis=1)
    pitch = 1.0 / lattice
    radius = pin_radius_frac * pitch
    ij = np.clip(np.floor(centroids[:, :2] / pitch).astype(np.int64), 0,
                 lattice - 1)
    center = (ij + 0.5) * pitch
    in_pin = np.linalg.norm(centroids[:, :2] - center, axis=1) < radius
    class_id = np.where(in_pin, 1 + ij[:, 0] * lattice + ij[:, 1],
                        0).astype(np.int32)
    return TetMesh.from_numpy(coords, tets, class_id, dtype=dtype,
                              device=device)
