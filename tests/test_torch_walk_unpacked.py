"""The port's unpacked walk table layout against its packed one and the
JAX walk's four-gather fallback.

Mirrors tests/test_walk_variants.py (``test_unpacked_fallback_matches_
packed``, the unpacked bodies of ``test_robust_off_matches_on_clean_mesh``
and ``test_score_squares_off_drops_only_squares``, ``test_packing_limits``,
``test_exactly_64_classes_packs_and_matches``) and tests/test_jittered_
mesh.py's ``test_jittered_mesh_packed_equals_unpacked``, and adds a
65-class mesh (past the packing limit) walked per lane against the JAX
walk.

Tolerances. Within the port the two layouts hold the same values in the
same dtype and the walk does the same operations on them, so the
unpacked walk equals the packed one bitwise (flux, elements, materials,
positions). Against the JAX walk: positions atol 1e-12 and the flux rtol
1e-10, atol 1e-12 in float64; positions 1e-5 and the flux rtol 1e-4
with an absolute allowance of 1e-5 in float32 (tests/torch_twins.py
``TOL``: XLA:CPU contracts multiply-adds into FMAs, the port does not);
elements and material ids equal.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumiumtally_tpu.mesh.box import build_box_arrays
from pumiumtally_tpu.mesh.core import TetMesh as JTetMesh
from pumiumtally_tpu.ops.walk import trace_impl
from pumiumtally_tpu_torch import PumiTally, TallyConfig
from pumiumtally_tpu_torch.convert import MESH_FIELDS, mesh_from_jax_arrays
from pumiumtally_tpu_torch.mesh.core import TetMesh, can_pack_walk_tables
from pumiumtally_tpu_torch.ops import walk

from torch_twins import JDT, TOL

DTYPES = [torch.float64, torch.float32]


def _mesh(coords, tets, cid, dtype, packed=True):
    return TetMesh.from_numpy(coords, tets, cid, dtype=dtype, device="cpu",
                              packed=packed)


def _twins(coords, tets, cid, dtype):
    """(JAX mesh, port mesh from its arrays), both as the JAX
    ``TetMesh.from_numpy`` leaves them (unpacked past the limits)."""
    jm = JTetMesh.from_numpy(coords, tets, cid, dtype=JDT[dtype])
    arrays = {f: (None if getattr(jm, f) is None
                  else np.asarray(getattr(jm, f))) for f in MESH_FIELDS}
    return jm, mesh_from_jax_arrays(arrays, "cpu")


def _lanes(mesh, n, seed, spread=(-0.1, 1.1)):
    rng = np.random.default_rng(seed)
    elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
    origin = mesh.centroids().numpy()[elem].astype(np.float64)
    dest = rng.uniform(*spread, (n, 3))
    weight = rng.uniform(0.5, 2.0, n)
    group = rng.integers(0, 2, n).astype(np.int32)
    return elem, origin, dest, weight, group


def _walk(mesh, lanes, **kw):
    elem, origin, dest, weight, group = lanes
    dt = mesh.dtype
    n = elem.shape[0]
    return walk.trace(
        mesh, torch.tensor(origin, dtype=dt), torch.tensor(dest, dtype=dt),
        torch.tensor(elem), torch.ones(n, dtype=torch.bool),
        torch.tensor(weight, dtype=dt), torch.tensor(group),
        torch.full((n,), -1, dtype=torch.int32),
        torch.zeros(mesh.ntet * 4, dtype=dt),
        **{**dict(initial=False, max_crossings=mesh.ntet + 8, n_groups=2,
                  tolerance=1e-6), **kw})


def _assert_bitwise(a, b):
    for name in ("flux", "elem", "material_id", "position", "done",
                 "track_length", "n_segments"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _box(nx=4):
    return build_box_arrays(1.0, 1.0, 1.0, nx, nx, nx)


@pytest.mark.parametrize("dtype", DTYPES)
def test_unpacked_fallback_matches_packed(dtype):
    coords, tets = _box()
    cid = (coords[tets].mean(axis=1)[:, 0] > 0.5).astype(np.int32)
    packed = _mesh(coords, tets, cid, dtype)
    unpacked = _mesh(coords, tets, cid, dtype, packed=False)
    assert packed.geo20 is not None and unpacked.geo20 is None
    lanes = _lanes(packed, 96, seed=0)
    a, b = _walk(packed, lanes), _walk(unpacked, lanes)
    _assert_bitwise(a, b)
    assert (b.material_id >= 0).any()  # material stops happened


@pytest.mark.parametrize("knob", [dict(robust=False),
                                  dict(score_squares=False)],
                         ids=["robust_off", "squares_off"])
def test_unpacked_knobs_match_packed(knob):
    coords, tets = _box()
    cid = (coords[tets].mean(axis=1)[:, 0] > 0.5).astype(np.int32)
    dtype = torch.float32
    lanes = _lanes(_mesh(coords, tets, cid, dtype), 96, seed=0)
    a = _walk(_mesh(coords, tets, cid, dtype), lanes, **knob)
    b = _walk(_mesh(coords, tets, cid, dtype, packed=False), lanes, **knob)
    _assert_bitwise(a, b)
    if "score_squares" in knob:
        assert not b.flux[1::2].any()


def test_packing_limits():
    assert can_pack_walk_tables((1 << 24) - 1, 64, 4)
    assert not can_pack_walk_tables(1 << 24, 64, 4)
    assert can_pack_walk_tables(1000, 64, 8)
    assert not can_pack_walk_tables(1000, 65, 8)
    assert not can_pack_walk_tables(1000, 8, 2)
    coords, tets = _box(3)  # 162 elements
    cid65 = (np.arange(len(tets)) % 65).astype(np.int32)
    for dtype in DTYPES:
        assert _mesh(coords, tets, cid65, dtype).geo20 is None
        assert _mesh(coords, tets, None, dtype, packed=False).geo20 is None
        assert _mesh(coords, tets, None, dtype).geo20 is not None


def test_exactly_64_classes_packs_and_matches():
    coords, tets = _box()
    ntet = tets.shape[0]
    rng = np.random.default_rng(7)
    values = np.sort(rng.choice(10_000, size=64, replace=False)).astype(
        np.int32)
    cid = values[np.arange(ntet) % 64]
    dtype = torch.float32
    packed = _mesh(coords, tets, cid, dtype)
    assert packed.geo20 is not None
    unpacked = _mesh(coords, tets, cid, dtype, packed=False)
    lanes = _lanes(packed, 64, seed=3)
    a, b = _walk(packed, lanes), _walk(unpacked, lanes)
    _assert_bitwise(a, b)
    stopped = b.material_id[b.material_id >= 0].numpy()
    assert stopped.size and np.isin(stopped, values).all()  # class values
    cid65 = cid.copy()
    cid65[0] = 10_001
    assert _mesh(coords, tets, cid65, dtype).geo20 is None


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_65_classes_match_jax_per_lane(dtype, initial):
    """A mesh one class past the packing limit walks in both packages;
    per lane the port's unpacked walk agrees with the JAX four-gather
    body."""
    coords, tets = _box()
    rng = np.random.default_rng(5)
    values = rng.choice(5000, size=65, replace=False).astype(np.int32)
    cid = values[np.arange(len(tets)) % 65]
    jm, pm = _twins(coords, tets, cid, dtype)
    assert jm.geo20 is None and pm.geo20 is None
    # Destinations clipped to a distinct bound per axis (no ties on the
    # box's diagonal faces).
    lanes = list(_lanes(pm, 96, seed=11))
    lanes[2] = np.clip(lanes[2], [0.01, 0.02, 0.03], [0.97, 0.98, 0.99])
    elem, origin, dest, weight, group = lanes
    n = elem.shape[0]
    jdt = JDT[dtype]
    kw = dict(initial=initial, max_crossings=pm.ntet + 8, tolerance=1e-6)
    ref = trace_impl(
        jm, jnp.asarray(origin, jdt), jnp.asarray(dest, jdt),
        jnp.asarray(elem), jnp.ones(n, bool), jnp.asarray(weight, jdt),
        jnp.asarray(group), jnp.full(n, -1, jnp.int32),
        jnp.zeros(pm.ntet * 4, jdt), n_groups=2, **kw)
    got = _walk(pm, lanes, **kw)
    pos_tol, rtol, atol = TOL[dtype]
    np.testing.assert_array_equal(got.elem.numpy(), np.asarray(ref.elem))
    np.testing.assert_array_equal(got.material_id.numpy(),
                                  np.asarray(ref.material_id))
    np.testing.assert_allclose(got.position.numpy(),
                               np.asarray(ref.position), atol=pos_tol)
    np.testing.assert_allclose(got.flux.numpy(), np.asarray(ref.flux),
                               rtol=rtol, atol=atol)
    if not initial:
        assert np.isin(got.material_id.numpy(), np.append(values, -1)).all()
        assert (got.material_id.numpy() >= 0).any()


def test_jittered_mesh_packed_equals_unpacked():
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, 5, 5, 5)
    rng = np.random.default_rng(3)
    interior = (coords > 1e-9).all(axis=1) & (coords < 1 - 1e-9).all(axis=1)
    coords = coords.copy()
    coords[interior] += rng.uniform(-0.06, 0.06, (interior.sum(), 3))
    cid = (coords[tets].mean(axis=1)[:, 2] > 0.5).astype(np.int32)
    dtype = torch.float32
    packed = _mesh(coords, tets, cid, dtype)
    unpacked = _mesh(coords, tets, cid, dtype, packed=False)
    lanes = _lanes(packed, 256, seed=4, spread=(-0.05, 1.05))
    _assert_bitwise(_walk(packed, lanes), _walk(unpacked, lanes))


@pytest.mark.parametrize("io", ["packed", "legacy"])
def test_facade_on_unpacked_mesh_matches_packed(io):
    """The four calls on a mesh without geo20 give the packed mesh's
    write-backs and flux bitwise."""
    coords, tets = _box()
    cid = (coords[tets].mean(axis=1)[:, 1] > 0.5).astype(np.int32)
    n = 48
    rng = np.random.default_rng(9)
    src = rng.uniform(0.05, 0.95, (n, 3))
    dest = rng.uniform(-0.1, 1.1, (n, 3))
    w = rng.uniform(0.5, 2.0, n)
    g = rng.integers(0, 2, n).astype(np.int32)
    outs = []
    for packed in (True, False):
        t = PumiTally(_mesh(coords, tets, cid, torch.float64, packed), n,
                      TallyConfig(dtype=torch.float64, n_groups=2,
                                  io_pipeline=io), device="cpu")
        t.initialize_particle_location(src.copy())
        d, m = dest.copy(), np.zeros(n, np.int32)
        t.move_to_next_location(d, np.ones(n, np.int8), w, g, m)
        outs.append((d, m, t.raw_flux))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert (outs[1][1] >= 0).any()
