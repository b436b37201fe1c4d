"""The port's walk on irregular tets (``ops/walk.py::trace``) on
``device="cpu"``: box meshes with jittered interior vertices.

Mirrors test_jittered_mesh's conservation, fuzz termination and
truncate-fails-safe cases: every walk terminates and the scored track
length equals the path walked (float64 and float32); random jittered
meshes with adversarial rays (axis-aligned, vertex-aimed, leaving the
domain) terminate and conserve in float32; and with ``robust=False`` a
degenerate ray may truncate but fails safe (finite positions inside the
domain, elements in range, finite non-negative flux, the ledger equal to
the net displacement). The conservation case also holds the port's flux
to the JAX walk's on the same mesh tables (1e-10 relative in float64,
1e-4 in float32). The packed-against-unpacked case waits for the port's
unpacked table layout (ROADMAP.md B1).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumiumtally_tpu import make_flux as jmake_flux
from pumiumtally_tpu.ops.walk import trace_impl
from pumiumtally_tpu_torch.core.tally import make_flux
from pumiumtally_tpu_torch.ops.walk import trace
from torch_twins import JDT, TOL, twin_meshes


def _walk(mesh, origin, dest, elem, dtype, n_groups=1, **kw):
    n = elem.shape[0]
    return trace(
        mesh, torch.as_tensor(origin, dtype=dtype),
        torch.as_tensor(dest, dtype=dtype),
        torch.as_tensor(elem, dtype=torch.int32),
        torch.ones(n, dtype=torch.bool), torch.ones(n, dtype=dtype),
        torch.zeros(n, dtype=torch.int32),
        torch.full((n,), -1, dtype=torch.int32),
        make_flux(mesh.ntet, n_groups, dtype, device="cpu"),
        initial=False, n_groups=n_groups, **kw,
    )


@pytest.mark.parametrize("dtype,tol,atol", [
    (torch.float64, 1e-8, 1e-9),
    (torch.float32, 1e-6, 5e-4),
])
def test_jittered_mesh_conserves_tracklength(dtype, tol, atol):
    jm, pm = twin_meshes(dtype, nx=6, jitter=0.25, seed=11, classes=(0, 1))
    assert float(pm.volumes.min()) > 0
    n = 512
    rng = np.random.default_rng(4)
    elem = rng.integers(0, pm.ntet, n).astype(np.int32)
    origin = pm.centroids().numpy()[elem]
    dest = rng.uniform(0.02, 0.98, (n, 3)).astype(origin.dtype)
    r = _walk(pm, origin, dest, elem, dtype,
              max_crossings=pm.ntet + 8, tolerance=tol)
    assert bool(r.done.all()), "walk must terminate everywhere"
    path = np.linalg.norm(r.position.double().numpy()
                          - origin.astype(np.float64), axis=1).sum()
    tallied = float(r.flux.double().numpy().reshape(-1, 2)[:, 0].sum())
    assert tallied == pytest.approx(path, abs=max(atol, 1e-7 * path))
    mats = r.material_id.numpy()
    assert np.isin(mats, (-1, 0, 1)).all() and (mats >= 0).any()
    # The JAX walk on the same tables and inputs.
    jr = trace_impl(
        jm, jnp.asarray(origin), jnp.asarray(dest), jnp.asarray(elem),
        jnp.ones(n, bool), jnp.ones(n, JDT[dtype]), jnp.zeros(n, jnp.int32),
        jnp.full(n, -1, jnp.int32), jmake_flux(jm.ntet, 1, JDT[dtype]),
        initial=False, max_crossings=jm.ntet + 8, tolerance=tol, unroll=1,
    )
    _, rtol, ftol = TOL[dtype]
    np.testing.assert_allclose(r.flux.numpy(),
                               np.asarray(jr.flux).reshape(-1),
                               rtol=rtol, atol=ftol)
    np.testing.assert_array_equal(mats, np.asarray(jr.material_id))


def _adversarial(rng, pm, n, n_axis, n_vert, n_out):
    elem = rng.integers(0, pm.ntet, n).astype(np.int32)
    origin = pm.centroids().numpy()[elem].astype(np.float64)
    dest = rng.uniform(0.02, 0.98, (n, 3))
    dest[:n_axis, 1:] = origin[:n_axis, 1:]  # pure-x rays
    verts = pm.coords.numpy().astype(np.float64)
    k = n_axis + n_vert
    dest[n_axis:k] = (verts[rng.integers(0, verts.shape[0], n_vert)]
                      + rng.normal(0, 1e-7, (n_vert, 3)))
    dest[k:k + n_out] = rng.uniform(1.0, 1.1, (n_out, 3))  # outside
    return elem, origin, dest


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_walk_termination_and_conservation(seed):
    rng = np.random.default_rng(100 + seed)
    nx = int(rng.integers(3, 7))
    jitter = float(rng.uniform(0.05, 0.25))
    _, pm = twin_meshes(torch.float32, nx=nx, jitter=jitter, seed=200 + seed,
                        classes=(0, 1))
    n = 384
    elem, origin, dest = _adversarial(rng, pm, n, 96, 96, 96)
    r = _walk(pm, origin, dest, elem, torch.float32,
              max_crossings=pm.ntet + 8, tolerance=1e-6)
    assert bool(r.done.all()), f"walk truncated (nx={nx}, jitter={jitter:.3f})"
    path = np.linalg.norm(r.position.double().numpy()
                          - origin.astype(np.float32), axis=1).sum()
    tallied = float(r.flux.double().numpy().reshape(-1, 2)[:, 0].sum())
    assert tallied == pytest.approx(path, abs=max(5e-4, 1e-5 * path))


@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_truncate_mode_fails_safe(seed):
    rng = np.random.default_rng(300 + seed)
    _, pm = twin_meshes(torch.float32, nx=5, jitter=0.2, seed=400 + seed,
                        classes=(0, 1))
    n = 256
    elem, origin, dest = _adversarial(rng, pm, n, 64, 64, 0)
    r = _walk(pm, origin, dest, elem, torch.float32, max_crossings=192,
              tolerance=1e-6, robust=False)
    pos = r.position.numpy()
    assert np.isfinite(pos).all()
    assert (pos > -0.01).all() and (pos < 1.01).all()
    el = r.elem.numpy()
    assert ((el >= 0) & (el < pm.ntet)).all()
    flux = r.flux.numpy()
    assert np.isfinite(flux).all() and (flux >= 0).all()
    disp = np.linalg.norm(pos.astype(np.float64)
                          - origin.astype(np.float32), axis=1)
    np.testing.assert_allclose(r.track_length.numpy(), disp, atol=2e-4)
