"""The port's point location (``ops/geometry.py::locate_points``,
``point_in_tet``, ``face_signed_distance``) and mesh snapshots
(``mesh/io.py::save_npz``) on ``device="cpu"``.

Mirrors test_mesh's point-location cases (``test_oracle_point_locations``,
``test_outside_point_not_located``, ``test_point_in_tet``) on the port's
unit box, and holds ``locate_points`` to the JAX package's on the same
points as equal integers: random points on jittered meshes, and points on
shared faces and edges, where several elements tie and the first one
must win (``jnp.argmin``'s rule). ``save_npz`` writes the JAX package's
snapshot layout.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumiumtally_tpu.mesh.io import save_npz as jsave_npz
from pumiumtally_tpu.ops import geometry as jgeom
from pumiumtally_tpu_torch import build_box, load_mesh
from pumiumtally_tpu_torch.mesh.io import load_npz_arrays, save_npz
from pumiumtally_tpu_torch.ops.geometry import (
    face_signed_distance,
    locate_points,
    point_in_tet,
)
from torch_twins import JDT, twin_meshes


@pytest.fixture(scope="module")
def unit_box():
    return build_box(dtype=torch.float64, device="cpu")


def test_oracle_point_locations(unit_box):
    # The reference white-box test's parent elements: (0.1,0.4,0.5) in
    # elem 2, the +x ray through 2, 3, 4; (0.15,0.05,0.2) in 3 and
    # (0.85,0.05,0.1) in 4.
    pts = torch.tensor([
        [0.1, 0.4, 0.5],
        [0.45, 0.4, 0.5],
        [0.7, 0.4, 0.5],
        [0.15, 0.05, 0.2],
        [0.85, 0.05, 0.1],
    ], dtype=torch.float64)
    elems = locate_points(unit_box, pts, tol=1e-12)
    np.testing.assert_array_equal(elems.numpy(), [2, 3, 4, 3, 4])


def test_outside_point_not_located(unit_box):
    pts = torch.tensor([[1.5, 0.5, 0.5], [-0.1, 0.2, 0.2]],
                       dtype=torch.float64)
    np.testing.assert_array_equal(
        locate_points(unit_box, pts, tol=1e-12).numpy(), [-1, -1])


def test_point_in_tet(unit_box):
    pts = torch.tensor([[0.1, 0.4, 0.5]], dtype=torch.float64)
    assert bool(point_in_tet(unit_box, torch.tensor([2]), pts, 1e-12)[0])
    assert not bool(point_in_tet(unit_box, torch.tensor([0]), pts,
                                 1e-12)[0])
    sd = face_signed_distance(unit_box, torch.tensor([2]), pts)
    assert sd.shape == (1, 4) and bool((sd <= 0).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_locate_points_matches_jax(dtype):
    """Random interior and outside points on a jittered mesh: the same
    element ids as the JAX package's locate_points."""
    jm, pm = twin_meshes(dtype, nx=4, jitter=0.2, seed=5)
    rng = np.random.default_rng(7)
    pts = np.concatenate([rng.uniform(0.02, 0.98, (200, 3)),
                          rng.uniform(1.01, 1.2, (8, 3))])
    want = np.asarray(jgeom.locate_points(
        jm, jnp.asarray(pts, JDT[dtype]), tol=1e-9))
    got = locate_points(pm, torch.as_tensor(pts, dtype=dtype), tol=1e-9)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:200] >= 0).all() and (want[200:] == -1).all()


def test_shared_face_ties_take_the_first_element():
    """Points on faces, edges and vertices shared by several elements of a
    regular box (their signed distances are exact zeros, so the elements
    tie): the lowest element id wins, as in the JAX package."""
    jm, pm = twin_meshes(torch.float64, nx=2)
    pts = np.array([
        [0.5, 0.3, 0.2],    # on the x = 0.5 grid plane
        [0.25, 0.5, 0.7],   # on y = 0.5
        [0.2, 0.6, 0.5],    # on z = 0.5
        [0.5, 0.5, 0.3],    # on a grid edge
        [0.5, 0.5, 0.5],    # on the central vertex
    ])
    worst = (np.einsum("tfc,pc->tpf", np.asarray(jm.face_normals), pts)
             - np.asarray(jm.face_d)[:, None, :]).max(axis=-1)
    # Each point ties exactly between at least two elements.
    assert ((worst == 0).sum(axis=0) >= 2).all()
    want = np.asarray(jgeom.locate_points(jm, jnp.asarray(pts), tol=1e-12))
    got = locate_points(pm, torch.as_tensor(pts), tol=1e-12).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.argmax(worst == 0, axis=0))


def test_save_npz_round_trip_matches_jax(tmp_path):
    """save_npz writes the JAX package's snapshot layout (float64 coords,
    int64 connectivity, int32 class ids) atomically; load_mesh reads it
    back into the same mesh."""
    mesh = build_box(1.0, 2.0, 0.5, 2, 3, 1, dtype=torch.float64,
                     device="cpu")
    ours, theirs = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    save_npz(ours, mesh.coords, mesh.tet2vert, mesh.class_id)
    jsave_npz(theirs, mesh.coords.numpy(), mesh.tet2vert.numpy(),
              mesh.class_id.numpy())
    for a, b in zip(load_npz_arrays(ours), load_npz_arrays(theirs)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert not [p for p in os.listdir(tmp_path) if ".tmp-" in p]
    back = load_mesh(ours, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(back.coords.numpy(), mesh.coords.numpy())
    np.testing.assert_array_equal(back.tet2vert.numpy(),
                                  mesh.tet2vert.numpy())
