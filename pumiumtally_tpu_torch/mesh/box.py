"""Structured box mesh generator (Freudenthal/Kuhn 6-tet subdivision).

Counterpart of ``pumiumtally_tpu/mesh/box.py``, with the same element
numbering: element 0 has centroid (0.5, 0.75, 0.25), point (0.1, 0.4, 0.5)
lies in element 2, and the +x ray at y=0.4, z=0.5 crosses elements 2, 3, 4
of the unit cube (the reference test fixture's oracle).
"""
from __future__ import annotations

import numpy as np
import torch

from .core import TetMesh

# Cell-local cube vertices (as (x, y, z) unit offsets) of the 6 Freudenthal
# tets, ordered to match the reference element numbering.
_CELL_TETS = np.array(
    [
        [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)],  # y >= x >= z
        [(0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)],  # x >= y >= z
        [(0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)],  # z >= y >= x
        [(0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)],  # z >= x >= y
        [(0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)],  # x >= z >= y
        [(0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)],  # y >= z >= x
    ],
    dtype=np.int64,
)


def build_box_arrays(
    lx: float = 1.0,
    ly: float = 1.0,
    lz: float = 1.0,
    nx: int = 1,
    ny: int = 1,
    nz: int = 1,
):
    """Vertex coordinates and tet connectivity for an nx×ny×nz cell box.

    Returns (coords [nverts,3] float64, tet2vert [6*ncells,4] int64).
    Vertex ids are x-fastest: id = i + (nx+1)*(j + (ny+1)*k).
    Element ids are cell-major: elem = 6*cell + t, cell = ci + nx*(cj + ny*ck).
    """
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    zs = np.linspace(0.0, lz, nz + 1)
    gz, gy, gx = np.meshgrid(zs, ys, xs, indexing="ij")
    coords = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)

    ci, cj, ck = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    ci = np.transpose(ci, (2, 1, 0)).ravel()
    cj = np.transpose(cj, (2, 1, 0)).ravel()
    ck = np.transpose(ck, (2, 1, 0)).ravel()

    def vid(i, j, k):
        return i + (nx + 1) * (j + (ny + 1) * k)

    ncells = nx * ny * nz
    tet2vert = np.empty((ncells, 6, 4), dtype=np.int64)
    for t in range(6):
        for v in range(4):
            dx, dy, dz = _CELL_TETS[t, v]
            tet2vert[:, t, v] = vid(ci + dx, cj + dy, ck + dz)
    return coords, tet2vert.reshape(ncells * 6, 4)


def build_box(
    lx: float = 1.0,
    ly: float = 1.0,
    lz: float = 1.0,
    nx: int = 1,
    ny: int = 1,
    nz: int = 1,
    class_id: np.ndarray | None = None,
    dtype: torch.dtype = torch.float32,
    device=None,
    packed: bool = True,
) -> TetMesh:
    """Build a TetMesh box on ``device`` (default: the CUDA card). All
    elements share class_id 0 unless given; ``packed=False`` leaves the
    mesh without its geo20 table (``TetMesh.from_numpy``)."""
    coords, tet2vert = build_box_arrays(lx, ly, lz, nx, ny, nz)
    return TetMesh.from_numpy(
        coords, tet2vert, class_id=class_id, dtype=dtype, device=device,
        packed=packed,
    )
