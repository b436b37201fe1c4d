"""Carry state across from the JAX package, as plain numpy arrays.

The port imports nothing of ``pumiumtally_tpu``: callers (the comparison
tests) pull the JAX objects' arrays out with ``numpy.asarray`` and hand
them over here, so both packages walk identical tables and state.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh.core import TetMesh
from .utils.platform import resolve_device

MESH_FIELDS = (
    "coords", "tet2vert", "tet2tet", "class_id", "face_normals", "face_d",
    "volumes", "geo20", "class_values",
)


def mesh_from_jax_arrays(d: dict, device=None) -> TetMesh:
    """A port TetMesh from the JAX TetMesh's tables given as numpy arrays
    (``{field: np.asarray(getattr(jax_mesh, field))}`` for the
    ``MESH_FIELDS``). Every array keeps its dtype and its bits; the
    geo20 codes in particular are copied as bytes, never converted."""
    dev = resolve_device(device)
    missing = [f for f in MESH_FIELDS if f not in d]
    if missing:
        raise ValueError(f"missing mesh arrays: {missing}")

    def put(name):
        a = d[name]
        if a is None:
            return None
        return torch.from_numpy(np.array(a, copy=True, order="C")).to(dev)

    mesh = TetMesh(**{f: put(f) for f in MESH_FIELDS})
    ints = ("tet2vert", "tet2tet", "class_id", "class_values")
    for f in ints:
        if getattr(mesh, f).dtype != torch.int32:
            raise TypeError(f"{f} must be int32, got {getattr(mesh, f).dtype}")
    for f in ("face_normals", "face_d", "volumes", "geo20"):
        t = getattr(mesh, f)
        if t is not None and t.dtype != mesh.dtype:
            raise TypeError(f"{f} must be {mesh.dtype}, got {t.dtype}")
    return mesh


def load_tally_arrays(tally, flux, origin, elem, material_id) -> None:
    """Seed a port ``PumiTally`` with a JAX facade's state, given as numpy
    arrays in host particle order: the raw flux (``[ntet, G, 2]`` or
    flat), particle positions ``[n, 3]``, parent elements and material
    ids. Marks the tally as located, so moves may follow."""
    dev, dtype = tally.device, tally.config.dtype
    n = tally.num_particles

    def put(a, shape, dt):
        return torch.from_numpy(
            np.array(a, copy=True, order="C").reshape(shape)
        ).to(dev, dt)

    flux = np.asarray(flux).reshape(-1)
    if flux.shape != tuple(tally.flux.shape):
        raise ValueError(
            f"flux has {flux.shape[0]} entries, tally {tally.flux.shape[0]}"
        )
    tally.flux = put(flux, (-1,), dtype)
    tally._origin_h = np.array(origin, np.float64).reshape(n, 3)
    tally.state = tally.state.replace(
        origin=put(origin, (n, 3), dtype),
        elem=put(elem, (n,), torch.int32),
        material_id=put(material_id, (n,), torch.int32),
    )
    tally._initialized = True
