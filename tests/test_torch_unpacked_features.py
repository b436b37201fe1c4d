"""The walk's feature tails (recorded crossing points, the invariant
checks) on the unpacked table layout: a box built ``packed=False`` and a
65-class mesh past the packing limits, against the JAX walk on the same
mesh, on the CPU.

Mirrors tests/test_walk_variants.py's unpacked fallback with the feature
cases of tests/test_debug_checks.py (:43 a NaN destination, :55 a wrong
parent element) and tests/test_record_xpoints.py, on a mesh without
geo20. On the card these take the walk kernel's feature instantiations
of the unpacked layout (tests/test_torch_cuda.py); ``walk_cuda``'s
argument checks no longer refuse them there.

Tolerances (float64): counts equal, points within 1e-12 of the JAX walk's
(the JAX tests' bar), and bitwise the port's packed walk on the same
box. The checks raise the JAX walk's checkify message (float32, the JAX
test's box), and a clean checked run gives the unchecked run's bits.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.mesh.box import build_box_arrays
from pumiumtally_tpu.mesh.core import TetMesh as JTetMesh
from pumiumtally_tpu.ops.walk import checked_trace, trace_impl
from pumiumtally_tpu_torch import PumiTally, TallyConfig
from pumiumtally_tpu_torch.convert import MESH_FIELDS, mesh_from_jax_arrays
from pumiumtally_tpu_torch.ops import walk_cuda
from pumiumtally_tpu_torch.ops.walk import CHECKS, WalkInvariantError

from torch_twins import JDT

K = 6
ATOL = 1e-12


def _twins(nx, cid_of, dtype, packed=False):
    """(JAX mesh, port mesh from its arrays) of an nx^3 box with the
    class ids ``cid_of(coords, tets)``, built ``packed`` (a 65-class
    mesh is unpacked either way)."""
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, nx, nx, nx)
    jm = JTetMesh.from_numpy(coords, tets, cid_of(coords, tets),
                             dtype=JDT[dtype], packed=packed)
    arrays = {f: (None if getattr(jm, f) is None
                  else np.asarray(getattr(jm, f))) for f in MESH_FIELDS}
    return jm, mesh_from_jax_arrays(arrays, "cpu")


def _two_regions(coords, tets):
    return (coords[tets].mean(axis=1)[:, 0] > 0.5).astype(np.int32)


def _classes65(coords, tets):
    """65 classes, one past the packing limit: one class for most of the
    box and 64 more on its first elements, so lanes cross many faces."""
    values = np.random.default_rng(5).choice(5000, size=65, replace=False)
    cid = np.full(len(tets), values[0], np.int32)
    cid[:64] = values[1:]
    return cid


MESHES = {"packed_false": (4, _two_regions, False),
          "classes65": (4, _classes65, True)}


def _lanes(mesh, n, seed):
    rng = np.random.default_rng(seed)
    elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
    origin = mesh.centroids().numpy()[elem].astype(np.float64)
    # Destinations clipped to a distinct bound per axis (no ties on the
    # box's diagonal faces).
    dest = np.clip(rng.uniform(-0.1, 1.1, (n, 3)), [0.01, 0.02, 0.03],
                   [0.97, 0.98, 0.99])
    return (elem, origin, dest, rng.uniform(0.5, 2.0, n),
            rng.integers(0, 2, n).astype(np.int32))


def _port(mesh, lanes, **kw):
    elem, origin, dest, weight, group = lanes
    n, t = len(elem), torch.from_numpy
    return walk_cuda.trace(
        mesh, t(origin), t(dest), t(elem), torch.ones(n, dtype=torch.bool),
        t(weight), t(group), torch.full((n,), -1, dtype=torch.int32),
        torch.zeros(mesh.ntet * 4, dtype=torch.float64), initial=False,
        max_crossings=mesh.ntet + 8, n_groups=2, tolerance=1e-8, **kw)


@pytest.mark.parametrize("which", list(MESHES))
def test_unpacked_record_xpoints_matches_jax(which):
    """Recorded points on a mesh without geo20: the JAX walk's counts
    and points; with the checks on too, the same bits and no error; the
    packed twin of the box gives the same bits."""
    nx, cid_of, packed = MESHES[which]
    jm, pm = _twins(nx, cid_of, torch.float64, packed)
    assert jm.geo20 is None and pm.geo20 is None
    lanes = _lanes(pm, 96, seed=11)
    elem, origin, dest, weight, group = lanes
    n = len(elem)
    mesh_args = (pm, torch.from_numpy(origin), torch.from_numpy(dest),
                 torch.from_numpy(elem), torch.ones(n, dtype=torch.bool),
                 torch.from_numpy(weight), torch.from_numpy(group),
                 torch.full((n,), -1, dtype=torch.int32),
                 torch.zeros(pm.ntet * 4, dtype=torch.float64))
    # walk_cuda's argument checks take the features on this layout.
    walk_cuda._check_cuda(*mesh_args, 2, pm.ntet + 8)
    ref = trace_impl(
        jm, jnp.asarray(origin), jnp.asarray(dest), jnp.asarray(elem),
        jnp.ones(n, bool), jnp.asarray(weight), jnp.asarray(group),
        jnp.full(n, -1, jnp.int32), jnp.zeros(pm.ntet * 4), n_groups=2,
        initial=False, max_crossings=pm.ntet + 8, tolerance=1e-8,
        record_xpoints=K)
    got = _port(pm, lanes, record_xpoints=K)
    np.testing.assert_array_equal(got.n_xpoints.numpy(),
                                  np.asarray(ref.n_xpoints))
    np.testing.assert_allclose(got.xpoints.numpy(), np.asarray(ref.xpoints),
                               rtol=0, atol=ATOL)
    assert int(got.n_xpoints.max()) >= 2
    both = _port(pm, lanes, record_xpoints=K, debug_checks=True)
    off = _port(pm, lanes)
    for f in ("xpoints", "n_xpoints"):
        assert torch.equal(getattr(both, f), getattr(got, f)), f
    for f in ("flux", "position", "elem", "material_id"):
        assert torch.equal(getattr(both, f), getattr(off, f)), f
        assert torch.equal(getattr(got, f), getattr(off, f)), f
    if which == "packed_false":
        _, pk = _twins(nx, cid_of, torch.float64, packed=True)
        assert pk.geo20 is not None
        ref_p = _port(pk, lanes, record_xpoints=K)
        for f in ("xpoints", "n_xpoints", "flux", "position"):
            assert torch.equal(getattr(ref_p, f), getattr(got, f)), f


@pytest.mark.parametrize("which", list(MESHES))
def test_unpacked_facade_intersection_points_match_jax(which):
    """PumiTally on a mesh without geo20 with record_xpoints and
    checkify_invariants: intersection_points are the JAX PumiTally's,
    the flux the unchecked run's bits."""
    nx, cid_of, packed = MESHES[which]
    jm, pm = _twins(nx, cid_of, torch.float64, packed)
    n = 64
    rng = np.random.default_rng(3)
    src = rng.uniform(0.05, 0.95, (n, 3))
    dest = np.clip(rng.uniform(-0.1, 1.1, (n, 3)), [0.01, 0.02, 0.03],
                   [0.97, 0.98, 0.99])
    w = rng.uniform(0.5, 2.0, n)
    g = rng.integers(0, 2, n).astype(np.int32)
    fly = np.ones(n, np.int8)
    fly[::7] = 0
    cfg = dict(n_groups=2, tolerance=1e-8, record_xpoints=K)

    def drive(t):
        t.initialize_particle_location(src.ravel().copy())
        t.move_to_next_location(dest.ravel().copy(), fly.copy(), w, g,
                                np.zeros(n, np.int32))
        return t

    jt = drive(jpt.PumiTally(jm, n, jpt.TallyConfig(dtype=jnp.float64,
                                                    **cfg)))
    pt = drive(PumiTally(pm, n, TallyConfig(dtype=torch.float64,
                                            checkify_invariants=True, **cfg),
                         device="cpu"))
    plain = drive(PumiTally(pm, n, TallyConfig(dtype=torch.float64,
                                               n_groups=2, tolerance=1e-8),
                            device="cpu"))
    xp, cp = pt.intersection_points()
    xj, cj = jt.intersection_points()
    np.testing.assert_array_equal(cp, np.asarray(cj))
    np.testing.assert_allclose(xp, np.asarray(xj), rtol=0, atol=ATOL)
    assert cp[fly == 0].max() == 0 and cp.max() >= 2
    np.testing.assert_array_equal(pt.raw_flux, plain.raw_flux)


def _checked(meshes, origin, dest, elem):
    """JAX's checked_trace message and the port's raised error, the port's
    flux left at ones, on the unpacked twins."""
    jm, pm = meshes
    n = origin.shape[0]
    err, _ = checked_trace(
        jm, jnp.asarray(origin, jnp.float32), jnp.asarray(dest, jnp.float32),
        jnp.asarray(elem), jnp.ones(n, bool), jnp.ones(n, jnp.float32),
        jnp.zeros(n, jnp.int32), jnp.full(n, -1, jnp.int32),
        jpt.make_flux(jm.ntet, 1, jnp.float32), initial=False,
        max_crossings=jm.ntet + 8, tolerance=1e-6)
    flux = torch.ones(pm.ntet * 2, dtype=torch.float32)
    t = torch.from_numpy
    with pytest.raises(WalkInvariantError) as e:
        walk_cuda.trace(
            pm, t(origin.astype(np.float32)), t(dest.astype(np.float32)),
            t(elem), torch.ones(n, dtype=torch.bool),
            torch.ones(n, dtype=torch.float32),
            torch.zeros(n, dtype=torch.int32),
            torch.full((n,), -1, dtype=torch.int32), flux, initial=False,
            max_crossings=pm.ntet + 8, n_groups=1, tolerance=1e-6,
            debug_checks=True)
    assert torch.equal(flux, torch.ones_like(flux))  # left as it was
    return err.get(), str(e.value)


@pytest.mark.parametrize("which", list(MESHES))
@pytest.mark.parametrize("fault", ["nan_destination", "wrong_parent"])
def test_unpacked_checks_raise_jax_messages(which, fault):
    """The checks on a mesh without geo20 (float32, the JAX test's 3^3
    box): a NaN destination and a lane that claims the element farthest
    from it raise the JAX walk's checkify messages."""
    _, cid_of, packed = MESHES[which]
    meshes = _twins(3, cid_of, torch.float32, packed)
    assert meshes[1].geo20 is None
    rng = np.random.default_rng(2)
    n = 16
    elem = rng.integers(0, meshes[1].ntet, n).astype(np.int32)
    cents = meshes[1].centroids().numpy().astype(np.float64)
    origin = cents[elem]
    dest = rng.uniform(0.1, 0.9, (n, 3))
    if fault == "nan_destination":
        dest[5] = np.nan
        want = CHECKS[1]
    else:
        elem[0] = int(np.argmax(np.linalg.norm(cents - origin[0], axis=1)))
        want = CHECKS[0]
    jerr, msg = _checked(meshes, origin, dest, elem)
    assert msg == want
    assert jerr is not None and msg in jerr
