"""The cells' meshes as raw arrays, made by the benchmark.

Both sides get these arrays: the program builds its mesh tables from them
(``TetMesh.from_numpy``), and the reference builds its own
(``reference/mesh.py``). A unit box of ``cells``³ cubes, each split into the
6 Freudenthal (Kuhn) tets, x-fastest vertices, cell-major elements; regions
are decided from each element's float64 centroid. The element numbering and
region rules are those of the upstream ladder's box, pincell and assembly
problems, written out here so that the yardstick does not move when the
program's own generators change.
"""
from __future__ import annotations

import numpy as np

# Cell-local cube vertex offsets of the 6 tets, in element order.
CELL_TETS = np.array(
    [
        [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)],
        [(0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)],
        [(0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)],
        [(0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)],
        [(0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)],
        [(0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)],
    ],
    dtype=np.int64,
)


def box_arrays(cells: int):
    """``(coords [(c+1)³, 3] float64, tets [6c³, 4] int64)`` of the unit
    box with ``cells`` cubes a side."""
    c = int(cells)
    g = np.linspace(0.0, 1.0, c + 1)
    gz, gy, gx = np.meshgrid(g, g, g, indexing="ij")
    coords = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
    ck, cj, ci = np.meshgrid(np.arange(c), np.arange(c), np.arange(c),
                             indexing="ij")
    ci, cj, ck = ci.ravel(), cj.ravel(), ck.ravel()
    tets = np.empty((c ** 3, 6, 4), dtype=np.int64)
    for t in range(6):
        for v in range(4):
            dx, dy, dz = CELL_TETS[t, v]
            tets[:, t, v] = (ci + dx) + (c + 1) * ((cj + dy)
                                                   + (c + 1) * (ck + dz))
    return coords, tets.reshape(-1, 4)


def regions(coords, tets, mesh: dict) -> np.ndarray:
    """Each element's region (int32): 0 is moderator, 1.. are pins.

    ``mesh["kind"]`` is ``pincell`` (one pin of radius ``pin_radius``
    centred in the box) or ``assembly`` (a ``lattice``² pin lattice, pin
    (i, j) region ``1 + i·lattice + j``, radius ``pin_radius_frac`` of the
    pitch)."""
    cen = coords[tets].mean(axis=1)[:, :2]
    kind = mesh["kind"]
    if kind == "pincell":
        r = np.linalg.norm(cen - 0.5, axis=1)
        return (r < float(mesh["pin_radius"])).astype(np.int32)
    if kind == "assembly":
        n = int(mesh["lattice"])
        pitch = 1.0 / n
        ij = np.clip(np.floor(cen / pitch).astype(np.int64), 0, n - 1)
        inside = (np.linalg.norm(cen - (ij + 0.5) * pitch, axis=1)
                  < float(mesh["pin_radius_frac"]) * pitch)
        return np.where(inside, 1 + ij[:, 0] * n + ij[:, 1], 0).astype(
            np.int32)
    raise ValueError(f"unknown mesh kind {kind!r}")


def build(mesh: dict):
    """``(coords, tets, class_id)`` of a configuration's ``mesh`` group."""
    coords, tets = box_arrays(mesh["cells"])
    return coords, tets, regions(coords, tets, mesh)


def candidates(points, cells: int):
    """``[m, 6]`` int64 ids of the 6 elements of the cube that holds each
    point (clipped into the box): one of them holds the point."""
    c = int(cells)
    ijk = np.clip(np.floor(np.asarray(points) * c).astype(np.int64), 0,
                  c - 1)
    cell = ijk[:, 0] + c * (ijk[:, 1] + c * ijk[:, 2])
    return cell[:, None] * 6 + np.arange(6)[None, :]
