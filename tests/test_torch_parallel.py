"""The port's particle sharding (replicated mesh, per-shard partial flux,
one reduction) against the single-device walk, on the CPU.

Mirrors tests/test_parallel.py: the sharded walk agrees with the JAX
single-chip walk and with the port's, and the reduced flux accumulates
across steps to the total track length. Tolerances (float64, the JAX
test's own): flux and positions atol 1e-12; elements, material ids,
segments and done flags equal. Against the port's single-device walk the
per-lane outputs are bitwise (each lane walks the same arithmetic; only
the flux's add order differs across shards).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumiumtally_tpu import trace as jtrace
from pumiumtally_tpu import make_flux as jmake_flux
from pumiumtally_tpu_torch.ops import walk
from pumiumtally_tpu_torch.ops.geometry import locate_points
from pumiumtally_tpu_torch.parallel.particle_sharding import (
    make_device_mesh,
    make_sharded_flux,
    make_sharded_trace,
    n_shards,
    reduce_flux,
    replicate,
    shard_particles,
)

from torch_twins import twin_meshes

N_DEV = 8


@pytest.fixture(scope="module")
def setup():
    jm, pm = twin_meshes(torch.float64, nx=3)
    return jm, pm, make_device_mesh(N_DEV, "cpu")


def _batch(n, rng):
    origin = rng.uniform(0.1, 0.9, (n, 3))
    dest = origin + rng.normal(scale=0.4, size=(n, 3))
    return origin, dest, rng.uniform(0.5, 2.0, n), rng.integers(0, 2, n)


def test_device_mesh_is_one_device_listed():
    dm = make_device_mesh(4, "cpu")
    assert n_shards(dm) == 4 and set(dm) == {torch.device("cpu")}


def test_sharded_trace_matches_single_chip(setup):
    jm, pm, dm = setup
    n = 64
    origin_h, dest_h, weight_h, group_h = _batch(n, np.random.default_rng(7))
    elem_h = locate_points(pm, torch.from_numpy(origin_h), 1e-12).numpy()
    assert (elem_h >= 0).all()
    r1 = jtrace(
        jm, jnp.asarray(origin_h), jnp.asarray(dest_h),
        jnp.asarray(elem_h, jnp.int32), jnp.ones(n, bool),
        jnp.asarray(weight_h), jnp.asarray(group_h, jnp.int32),
        jnp.full(n, -1, jnp.int32), jmake_flux(jm.ntet, 2, jnp.float64),
        initial=False, max_crossings=jm.ntet + 64)
    step = make_sharded_trace(dm, initial=False, max_crossings=pm.ntet + 64)
    args = shard_particles(
        dm, origin_h, dest_h, elem_h.astype(np.int32), np.ones(n, bool),
        weight_h, group_h.astype(np.int32), np.full(n, -1, np.int32))
    flux = make_sharded_flux(dm, pm.ntet, 2, torch.float64)
    r8 = step(replicate(dm, pm), *args, flux)
    assert r8.flux.shape == (N_DEV, pm.ntet, 2, 2)
    np.testing.assert_allclose(reduce_flux(r8.flux).numpy(),
                               np.asarray(r1.flux), atol=1e-12)
    np.testing.assert_allclose(r8.position.numpy(), np.asarray(r1.position),
                               atol=1e-12)
    np.testing.assert_array_equal(r8.elem.numpy(), np.asarray(r1.elem))
    np.testing.assert_array_equal(r8.material_id.numpy(),
                                  np.asarray(r1.material_id))
    assert int(r8.n_segments.sum()) == int(r1.n_segments)
    assert bool(r8.done.all()) and r8.stats.shape == (N_DEV, 8)
    # Each lane walks the single-device walk's arithmetic.
    one = walk.trace(pm, *args, torch.zeros(pm.ntet * 4,
                                            dtype=torch.float64),
                     initial=False, max_crossings=pm.ntet + 64, n_groups=2)
    for f in ("position", "elem", "material_id", "track_length"):
        assert torch.equal(getattr(r8, f), getattr(one, f)), f


def test_sharded_flux_accumulates_across_steps(setup):
    _, pm, dm = setup
    n = 32
    step = make_sharded_trace(dm, initial=False, max_crossings=pm.ntet + 64)
    flux = make_sharded_flux(dm, pm.ntet, 2, torch.float64, flat=True)
    origin_h, _, _, _ = _batch(n, np.random.default_rng(11))
    pos = torch.from_numpy(origin_h)
    elem = locate_points(pm, pos, 1e-12).to(torch.int32)
    total_len = 0.0
    step_flat = make_sharded_trace(dm, initial=False,
                                   max_crossings=pm.ntet + 64, n_groups=2)
    for i in range(3):
        _, dest_h, _, group_h = _batch(n, np.random.default_rng(i))
        dest, weight, group, fly, mat = shard_particles(
            dm, dest_h, np.ones(n), group_h.astype(np.int32),
            np.ones(n, bool), np.full(n, -1, np.int32))
        r = step_flat(pm, pos, dest, elem, fly, weight, group, mat, flux)
        total_len += float(torch.linalg.vector_norm(r.position - pos,
                                                    dim=1).sum())
        pos, elem = r.position, r.elem
    total = reduce_flux(flux).view(-1, 2)[:, 0].sum().item()
    assert total == pytest.approx(total_len, abs=1e-9)
    with pytest.raises(ValueError, match="n_groups"):
        step(pm, pos, dest, elem, fly, weight, group, mat, flux)


def test_shard_count_must_divide_the_lanes(setup):
    _, _, dm = setup
    with pytest.raises(ValueError, match="shards"):
        shard_particles(dm, np.zeros(10))
