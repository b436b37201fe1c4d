"""float32 against float64 on the port's walk (``ops/walk.py::trace``) on
``device="cpu"``.

Mirrors test_precision: on the analytic two-region box, the float32 walk
stays within the envelope the JAX package pins (total track length within
1e-4 relative, per-element flux within 5e-4 of the largest, positions
within 1e-4, the same material decisions); float64 runs are bitwise
reproducible; and a float32 destination within the geometric tolerance
band of an interior face counts as inside the near element, while one
past the band crosses and stops on the material boundary. The float64
flux is also held to the JAX walk's on the same inputs (the parity bar,
1e-10 relative).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumiumtally_tpu import make_flux as jmake_flux
from pumiumtally_tpu.mesh.box import build_box_arrays
from pumiumtally_tpu.mesh.core import TetMesh as JTetMesh
from pumiumtally_tpu.ops.walk import trace_impl
from pumiumtally_tpu_torch.core.tally import make_flux
from pumiumtally_tpu_torch.mesh.core import TetMesh
from pumiumtally_tpu_torch.ops.walk import trace


def _box(nx, ny, nz, classes):
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, nx, ny, nz)
    cid = classes(coords[tets].mean(axis=1)[:, 0]).astype(np.int32)
    return coords, tets, cid


def _inputs(mesh, n=256):
    rng = np.random.default_rng(3)
    elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
    origin = mesh.centroids().double().numpy()[elem]
    return dict(
        elem=elem, origin=origin, dest=rng.uniform(-0.05, 1.05, (n, 3)),
        weight=rng.uniform(0.5, 2.0, n),
        group=rng.integers(0, 2, n).astype(np.int32),
    )


def _run(dtype, tol):
    coords, tets, cid = _box(5, 5, 5, lambda x: x > 0.5)
    mesh = TetMesh.from_numpy(coords, tets, cid, dtype=dtype, device="cpu")
    a = _inputs(mesh)
    n = a["elem"].shape[0]
    return trace(
        mesh, torch.as_tensor(a["origin"], dtype=dtype),
        torch.as_tensor(a["dest"], dtype=dtype), torch.as_tensor(a["elem"]),
        torch.ones(n, dtype=torch.bool),
        torch.as_tensor(a["weight"], dtype=dtype),
        torch.as_tensor(a["group"]), torch.full((n,), -1, dtype=torch.int32),
        make_flux(mesh.ntet, 2, dtype, device="cpu"),
        initial=False, max_crossings=mesh.ntet + 8, n_groups=2,
        tolerance=tol,
    )


def test_f32_tracks_f64_envelope():
    r64 = _run(torch.float64, 1e-8)
    r32 = _run(torch.float32, 1e-6)
    f64 = r64.flux.numpy().reshape(-1, 2, 2)[..., 0]
    f32 = r32.flux.numpy().reshape(-1, 2, 2)[..., 0].astype(np.float64)
    assert abs(f32.sum() - f64.sum()) <= 1e-4 * f64.sum()
    np.testing.assert_allclose(f32, f64, atol=5e-4 * f64.max())
    np.testing.assert_allclose(r32.position.numpy(), r64.position.numpy(),
                               atol=1e-4)
    np.testing.assert_array_equal(r32.material_id.numpy(),
                                  r64.material_id.numpy())
    assert bool(r32.done.all())


def test_f64_run_to_run_reproducible():
    a = _run(torch.float64, 1e-8)
    b = _run(torch.float64, 1e-8)
    np.testing.assert_array_equal(a.flux.numpy(), b.flux.numpy())


def test_f64_matches_jax_walk():
    """The same scenario through the JAX walk (its mesh tables handed to
    the port bit for bit): flux within the parity bar."""
    coords, tets, cid = _box(5, 5, 5, lambda x: x > 0.5)
    jm = JTetMesh.from_numpy(coords, tets, cid, dtype=jnp.float64)
    from pumiumtally_tpu_torch.convert import (
        MESH_FIELDS,
        mesh_from_jax_arrays,
    )

    pm = mesh_from_jax_arrays({f: np.asarray(getattr(jm, f))
                               for f in MESH_FIELDS}, "cpu")
    a = _inputs(pm)
    n = a["elem"].shape[0]
    jr = trace_impl(
        jm, jnp.asarray(a["origin"]), jnp.asarray(a["dest"]),
        jnp.asarray(a["elem"]), jnp.ones(n, bool), jnp.asarray(a["weight"]),
        jnp.asarray(a["group"]), jnp.full(n, -1, jnp.int32),
        jmake_flux(jm.ntet, 2, jnp.float64), initial=False,
        max_crossings=jm.ntet + 8, tolerance=1e-8, unroll=1,
    )
    pr = trace(
        pm, torch.as_tensor(a["origin"]), torch.as_tensor(a["dest"]),
        torch.as_tensor(a["elem"]), torch.ones(n, dtype=torch.bool),
        torch.as_tensor(a["weight"]), torch.as_tensor(a["group"]),
        torch.full((n,), -1, dtype=torch.int32),
        make_flux(pm.ntet, 2, torch.float64, device="cpu"),
        initial=False, max_crossings=pm.ntet + 8, n_groups=2,
        tolerance=1e-8,
    )
    np.testing.assert_allclose(pr.flux.numpy(),
                               np.asarray(jr.flux).reshape(-1),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(pr.material_id.numpy(),
                                  np.asarray(jr.material_id))


def test_f32_grazing_ray_tolerance_semantics():
    """float32, tolerance 1e-6: a destination within the band of the
    x = 0.5 face (also a material boundary, class 3 | class 9) is reached
    in the near element; past the band the walk crosses and stops on the
    plane with the far side's class id."""
    coords, tets, cid = _box(2, 1, 1, lambda x: np.where(x < 0.5, 3, 9))
    mesh = TetMesh.from_numpy(coords, tets, cid, dtype=torch.float32,
                              device="cpu")
    cents = mesh.centroids().double().numpy()
    e0 = int(np.argmin(np.abs(cents[:, 0] - 0.25)))
    origin = cents[e0:e0 + 1]
    tol = 1e-6
    class_id = mesh.class_id.numpy()

    def run(d_beyond):
        dest = origin.copy()
        dest[0, 0] = 0.5 + d_beyond
        r = trace(
            mesh, torch.as_tensor(origin, dtype=torch.float32),
            torch.as_tensor(dest, dtype=torch.float32),
            torch.tensor([e0], dtype=torch.int32),
            torch.ones(1, dtype=torch.bool), torch.ones(1),
            torch.zeros(1, dtype=torch.int32),
            torch.full((1,), -1, dtype=torch.int32),
            make_flux(mesh.ntet, 1, torch.float32, device="cpu"),
            initial=False, max_crossings=mesh.ntet + 8, n_groups=1,
            tolerance=tol,
        )
        assert bool(r.done.all())
        return int(r.elem[0]), int(r.material_id[0]), r.position.numpy()[0]

    for d in (1e-8, 1e-7, 5e-7):
        elem, mat, pos = run(d)
        assert class_id[elem] == 3, d
        assert mat == -1
        assert abs(pos[0] - np.float32(0.5 + d)) <= tol + 2e-7
    elem, mat, pos = run(1e-3)
    assert class_id[elem] == 9
    assert mat == 9
    assert abs(pos[0] - 0.5) < 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_run_statistics_match_across_dtypes(dtype):
    """Every lane finishes in either dtype and the scored segments agree
    with the float64 walk's count."""
    r = _run(dtype, 1e-6 if dtype == torch.float32 else 1e-8)
    r64 = _run(torch.float64, 1e-8)
    assert bool(r.done.all())
    assert abs(int(r.n_segments) - int(r64.n_segments)) <= 2
