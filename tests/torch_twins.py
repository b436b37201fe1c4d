"""Shared set-up of the port's cross-package tests: the same mesh and the
same configuration in the JAX package and in the port.

The port's mesh is built from the JAX mesh's arrays
(``convert.mesh_from_jax_arrays``), so both packages walk identical
tables (the JAX ``TetMesh.from_numpy`` goes through a native library
that differs from numpy by ~1e-14)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.mesh.box import build_box_arrays
from pumiumtally_tpu_torch import PumiTally, TallyConfig
from pumiumtally_tpu_torch.convert import MESH_FIELDS, mesh_from_jax_arrays

JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}
# Tolerances of a tally compared across the packages (positions atol,
# flux rtol, flux atol): XLA:CPU contracts multiply-adds into FMAs and the
# port does not, so the two agree to rounding; in float64 the flux meets
# the parity bar of 1e-10 relative.
TOL = {
    torch.float64: (1e-12, 1e-10, 1e-12),
    torch.float32: (1e-5, 1e-4, 1e-5),
}


def twin_meshes(dtype=torch.float64, nx=4, jitter=0.0, seed=11,
                classes=None):
    """(JAX mesh, port mesh on the CPU) of an nx^3 unit box, interior
    vertices jittered by ``jitter`` cells from numpy ``seed``; with
    ``classes=(a, b)`` the elements' class ids are a for x < 0.5 and b
    beyond (by centroid)."""
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, nx, nx, nx)
    coords = coords.copy()
    if jitter:
        rng = np.random.default_rng(seed)
        inner = (coords > 1e-9).all(axis=1) & (coords < 1 - 1e-9).all(axis=1)
        coords[inner] += rng.uniform(-jitter / nx, jitter / nx,
                                     (int(inner.sum()), 3))
    cid = None
    if classes is not None:
        cid = np.where(coords[tets].mean(axis=1)[:, 0] > 0.5,
                       classes[1], classes[0]).astype(np.int32)
    jmesh = jpt.TetMesh.from_numpy(coords, tets, cid, dtype=JDT[dtype])
    pmesh = mesh_from_jax_arrays(
        {f: np.asarray(getattr(jmesh, f)) for f in MESH_FIELDS}, "cpu")
    return jmesh, pmesh


def twin_tallies(meshes, n, dtype=torch.float64, **cfg):
    """(JAX PumiTally, port PumiTally on the CPU) with the same
    configuration fields ``cfg``."""
    jmesh, pmesh = meshes
    jt = jpt.PumiTally(jmesh, n, jpt.TallyConfig(dtype=JDT[dtype], **cfg))
    pt = PumiTally(pmesh, n, TallyConfig(dtype=dtype, **cfg), device="cpu")
    return jt, pt


def move_both(tallies, inputs):
    """One move of every tally on copies of ``inputs`` (dest, flying,
    weights, groups, material ids); returns each call's write-backs."""
    outs = []
    for t in tallies:
        args = [np.array(a, copy=True) for a in inputs]
        t.move_to_next_location(*args)
        outs.append((args[0], args[1], args[4]))
    return outs


def assert_tallies_agree(jt, pt, dtype=torch.float64):
    """Raw flux and element ids of the two packages' tallies."""
    _, rtol, atol = TOL[dtype]
    np.testing.assert_array_equal(pt.element_ids, np.asarray(jt.element_ids))
    np.testing.assert_allclose(pt.raw_flux, np.asarray(jt.raw_flux),
                               rtol=rtol, atol=atol)
