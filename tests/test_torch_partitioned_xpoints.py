"""Recorded crossing points on the port's partitioned walk, against the
JAX package, on the CPU.

Mirrors tests/test_mesh_partition.py::
test_partitioned_record_xpoints_matches_single_chip (halo 0 and 1, its
``compact_stages=((4, 64), (8, 32))`` on the step) and
tests/test_partitioned_api.py::
test_partitioned_tally_intersection_points_matches_single, and adds:

  * the crossing budget's later rounds (ROADMAP.md C3) at
    ``max_crossings=5``, and the lanes those rounds never take (put back
    to their state before the phase's last launch), with points on;
  * re-walked lanes through ``PartitionedTally`` with
    ``truncation_retries``: each re-walk's points follow the last
    attempt's (``merge_recorded_xpoints``);
  * the point columns in the exchange's send rows.

Tolerances (float64): counts equal, points within 1e-12 of the JAX
partitioned step, of the JAX single-chip walk and of the port's
single-device walk (the JAX tests' own bar); the port's partitioned step
against its single-device walk bitwise where both take the same path.
"""
from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import pumiumtally_tpu as jpt
from pumiumtally_tpu.ops import walk_partitioned as jwp
from pumiumtally_tpu.ops.walk import trace_impl
from pumiumtally_tpu.parallel.mesh_partition import partition_mesh as jpartition
from pumiumtally_tpu.parallel.partitioned_api import (
    PartitionedTally as JPartitionedTally,
)
from pumiumtally_tpu.parallel.particle_sharding import (
    make_device_mesh as jdevice_mesh,
)
from pumiumtally_tpu_torch import PartitionedTally, PumiTally, TallyConfig
from pumiumtally_tpu_torch.ops import walk_cuda
from pumiumtally_tpu_torch.ops import walk_partitioned as pwp
from pumiumtally_tpu_torch.parallel.mesh_partition import partition_mesh
from pumiumtally_tpu_torch.parallel.particle_sharding import make_device_mesh
from torch_twins import twin_meshes

ATOL = 1e-12
K = 8
STAGES = ((4, 64), (8, 32))


@pytest.fixture(scope="module")
def box():
    return twin_meshes(torch.float64, nx=4)


def _batch(mesh, n, seed, spread=0.9, wrong_every=0):
    """Lanes from element centroids toward far points; with
    ``wrong_every`` every such lane claims a parent two element sizes
    from its start (a chase across cuts)."""
    rng = np.random.default_rng(seed)
    cen = mesh.centroids().numpy().astype(np.float64)
    elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
    origin = cen[elem].copy()
    if wrong_every:
        wrong = np.arange(n) % wrong_every == 0
        origin[wrong] = np.clip(origin[wrong] + rng.normal(
            0, 0.2, (int(wrong.sum()), 3)), 0.01, 0.99)
    dest = np.clip(origin + rng.uniform(-spread, spread, (n, 3)), -0.2, 1.2)
    return (elem, origin, dest, rng.uniform(0.5, 2.0, n),
            rng.integers(0, 2, n).astype(np.int32))


def _fields(batch):
    elem, origin, dest, weight, group = batch
    return elem, dict(origin=origin, dest=dest, weight=weight, group=group,
                      material_id=np.full(len(elem), -1, np.int32))


def _jax_step(jmesh, n_parts, halo, batch, **kw):
    jpart = jpartition(jmesh, n_parts, halo_layers=halo)
    dm = jdevice_mesh(n_parts)
    elem, fields = _fields(batch)
    placed = jwp.distribute_particles(jpart, dm, elem, fields)
    step = jwp.make_partitioned_step(dm, jpart, n_groups=2, tolerance=1e-8,
                                     **kw)
    flux = jax.device_put(jnp.zeros((n_parts, jpart.max_local * 4)),
                          NamedSharding(dm, JP("p")))
    res = step(placed["origin"], placed["dest"], placed["elem"],
               jnp.zeros_like(placed["valid"]), placed["material_id"],
               placed["weight"], placed["group"], placed["particle_id"],
               placed["valid"], flux)
    return res, jwp.collect_by_particle_id(res, len(elem))


def _port_step(pmesh, n_parts, halo, batch, **kw):
    part = partition_mesh(pmesh, n_parts, halo_layers=halo)
    dm = make_device_mesh(n_parts, "cpu")
    elem, fields = _fields(batch)
    placed = pwp.distribute_particles(part, dm, elem, fields)
    step = pwp.make_partitioned_step(dm, part, n_groups=2, tolerance=1e-8,
                                     **kw)
    res = step(placed["origin"], placed["dest"], placed["elem"],
               torch.zeros_like(placed["valid"]), placed["material_id"],
               placed["weight"], placed["group"], placed["particle_id"],
               placed["valid"],
               torch.zeros(n_parts, part.max_local * 4,
                           dtype=torch.float64))
    return res, pwp.collect_by_particle_id(res, len(elem), part)


def _assert_points(got, want_x, want_n):
    np.testing.assert_array_equal(got["n_xpoints"], np.asarray(want_n))
    np.testing.assert_allclose(got["xpoints"], np.asarray(want_x), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("halo", [0, 1])
def test_partitioned_record_xpoints_matches_single_chip(box, halo):
    """The buffers migrate with their particles: each particle's points
    are its whole path in order across parts, the single-chip walk's
    (a cut face is an interior face, recorded once, by the part the
    lane leaves). Against the JAX step, the JAX single-chip walk and the
    port's single-device walk."""
    jm, pm = box
    batch = _batch(pm, 96, seed=3)
    elem, origin, dest, weight, group = batch
    n = len(elem)
    bound = pm.ntet + 8
    ref = trace_impl(
        jm, jnp.asarray(origin), jnp.asarray(dest), jnp.asarray(elem),
        jnp.ones(n, bool), jnp.asarray(weight), jnp.asarray(group),
        jnp.full(n, -1, jnp.int32), jnp.zeros(jm.ntet * 4), n_groups=2,
        initial=False, max_crossings=bound, tolerance=1e-8,
        record_xpoints=K)
    single = walk_cuda.trace(
        pm, torch.from_numpy(origin), torch.from_numpy(dest),
        torch.from_numpy(elem), torch.ones(n, dtype=torch.bool),
        torch.from_numpy(weight), torch.from_numpy(group),
        torch.full((n,), -1, dtype=torch.int32),
        torch.zeros(pm.ntet * 4, dtype=torch.float64), initial=False,
        max_crossings=bound, n_groups=2, tolerance=1e-8, record_xpoints=K)
    kw = dict(max_crossings=bound, record_xpoints=K, compact_stages=STAGES)
    jres, jgot = _jax_step(jm, 8, halo, batch, **kw)
    res, got = _port_step(pm, 8, halo, batch, **kw)
    assert got["done"].all()
    assert int(res.round_stats[:, 1].sum()) > 0  # lanes migrated
    _assert_points(got, jgot["xpoints"], jgot["n_xpoints"])
    _assert_points(got, ref.xpoints, ref.n_xpoints)
    _assert_points(got, single.xpoints.numpy(), single.n_xpoints.numpy())
    assert np.asarray(ref.n_xpoints).max() >= 2
    # The slots hold JAX's points slot by slot, the step's results stand.
    np.testing.assert_array_equal(res.n_xpoints.numpy(),
                                  np.asarray(jres.n_xpoints))
    np.testing.assert_allclose(res.xpoints.numpy(), np.asarray(jres.xpoints),
                               rtol=0, atol=ATOL)
    off, _ = _port_step(pm, 8, halo, batch, max_crossings=bound,
                        compact_stages=STAGES)
    assert off.xpoints is None and off.n_xpoints is None
    for f in ("position", "elem", "material_id", "done", "flux",
              "track_length", "n_segments", "round_stats"):
        assert torch.equal(getattr(res, f), getattr(off, f)), f


@pytest.mark.parametrize("case", ["later_rounds", "starved"])
def test_budget_rounds_record_like_jax(case):
    """max_crossings=5: lanes that run out of budget walk on in the JAX
    step's later rounds, continuing their points; with rounds of 8 lanes
    (max_crossings=2) some lanes are never taken, and their points go
    back to the count before the phase's compacted rounds."""
    if case == "later_rounds":
        jm, pm = twin_meshes(torch.float64, nx=4, classes=(1, 2))
        batch = _batch(pm, 128, seed=5, wrong_every=4)
        kw, n_parts = dict(max_crossings=5), 4
        counter = "BUDGET_RELAUNCHES"
    else:
        jm, pm = twin_meshes(torch.float64, nx=6, classes=(1, 2))
        batch = _batch(pm, 256, seed=5, wrong_every=8)
        kw = dict(max_crossings=2, compact_after=1, compact_size=8,
                  followup_compact_size=8)
        n_parts, counter = 2, "BUDGET_STARVED"
    kw["record_xpoints"] = 6
    jres, jgot = _jax_step(jm, n_parts, 1, batch, **kw)
    c0 = getattr(pwp, counter)
    res, got = _port_step(pm, n_parts, 1, batch, **kw)
    assert getattr(pwp, counter) > c0
    np.testing.assert_array_equal(res.done.numpy(), np.asarray(jres.done))
    np.testing.assert_array_equal(res.n_xpoints.numpy(),
                                  np.asarray(jres.n_xpoints))
    np.testing.assert_allclose(res.xpoints.numpy(), np.asarray(jres.xpoints),
                               rtol=0, atol=ATOL)
    _assert_points(got, jgot["xpoints"], jgot["n_xpoints"])
    assert int(res.n_xpoints.max()) >= 2


def _drive(t, n, seed=31, moves=1, park=True, far=False):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.05, 0.95, (n, 3))
    t.initialize_particle_location(pos.ravel().copy())
    flying = np.ones(n, np.int8)
    if park:
        flying[::5] = 0
    for _ in range(moves):
        dest = (rng.uniform(0.05, 0.95, (n, 3)) if far else
                np.clip(pos + rng.normal(0, 0.3, (n, 3)), -0.1, 1.1))
        t.move_to_next_location(dest.ravel().copy(), flying.copy(),
                                np.ones(n), np.zeros(n, np.int32),
                                np.zeros(n, np.int32))
        pos = dest
    return flying


def test_partitioned_tally_intersection_points_matches_single(box):
    """The facade's intersection_points equals PumiTally's (the port's and
    JAX's) and the JAX PartitionedTally's for the same move; parked lanes
    record nothing; the initial search records too."""
    jm, pm = box
    n = 128
    cfg = dict(n_groups=2, tolerance=1e-8, record_xpoints=6)
    single = PumiTally(pm, n, TallyConfig(dtype=torch.float64, **cfg),
                       device="cpu")
    parted = PartitionedTally(pm, n, TallyConfig(dtype=torch.float64, **cfg),
                              n_parts=8, halo_layers=1, device="cpu")
    jparted = JPartitionedTally(jm, n, jpt.TallyConfig(dtype=jnp.float64,
                                                       **cfg),
                                n_parts=8, halo_layers=1)
    with pytest.raises(RuntimeError, match="no trace has run"):
        parted.intersection_points()
    rng = np.random.default_rng(31)
    pos = rng.uniform(0.05, 0.95, (n, 3))
    for t in (single, parted):
        t.initialize_particle_location(pos.ravel().copy())
    xs, cs = single.intersection_points()
    xp, cp = parted.intersection_points()
    np.testing.assert_array_equal(cp, cs)
    np.testing.assert_allclose(xp, xs, rtol=0, atol=ATOL)
    flying = None
    for t in (single, parted, jparted):
        flying = _drive(t, n)
    xs, cs = single.intersection_points()
    xp, cp = parted.intersection_points()
    xj, cj = jparted.intersection_points()
    assert xp.dtype == np.float64 and cp.dtype == np.int32
    np.testing.assert_array_equal(cp, cs)
    np.testing.assert_allclose(xp, xs, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(cp, np.asarray(cj))
    np.testing.assert_allclose(xp, np.asarray(xj), rtol=0, atol=ATOL)
    assert cp[flying == 0].max() == 0 and (xp[flying == 0] == 0).all()
    assert cs.max() >= 2
    assert parted._io == "legacy"
    np.testing.assert_allclose(parted.raw_flux, single.raw_flux, rtol=0,
                               atol=1e-11)


def test_rewalked_lanes_continue_their_points(box):
    """max_crossings=5 and one migration round with re-walks: a truncated
    lane's later attempts append their points after the first attempt's
    (counts add), as the JAX facade merges them."""
    jm, pm = box
    n = 64
    cfg = dict(n_groups=2, tolerance=1e-8, max_crossings=5, unroll=1,
               truncation_retries=8, record_xpoints=12)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        t = PartitionedTally(pm, n, TallyConfig(dtype=torch.float64, **cfg),
                             n_parts=4, halo_layers=1, max_rounds=1,
                             device="cpu")
        _drive(t, n, seed=11, park=False, far=True)
        jt = JPartitionedTally(jm, n, jpt.TallyConfig(dtype=jnp.float64,
                                                      **cfg),
                               n_parts=4, halo_layers=1, max_rounds=1)
        _drive(jt, n, seed=11, park=False, far=True)
    assert t.telemetry()["totals"]["rewalked"] > 0
    xp, cp = t.intersection_points()
    xj, cj = jt.intersection_points()
    np.testing.assert_array_equal(cp, np.asarray(cj))
    np.testing.assert_allclose(xp, np.asarray(xj), rtol=0, atol=ATOL)
    assert cp.max() > 5  # a re-walked lane kept its first attempt's


def test_refusals_keep_jax_messages(box, tmp_path):
    """The packed-I/O step and the megastep refuse the points with JAX's
    messages; without record_xpoints intersection_points raises; a
    restore forgets the last call's points."""
    _, pm = box
    part = partition_mesh(pm, 2)
    with pytest.raises(NotImplementedError, match="packed_io does not"):
        pwp.make_partitioned_step(make_device_mesh(2, "cpu"), part,
                                  n_groups=2, record_xpoints=4,
                                  packed_io=True)
    t = PartitionedTally(pm, 32, TallyConfig(dtype=torch.float64, n_groups=2,
                                             record_xpoints=4),
                         n_parts=2, device="cpu")
    _drive(t, 32)
    assert t.intersection_points()[1].max() > 0
    t.save_checkpoint(str(tmp_path / "c.npz"))
    t.restore_checkpoint(str(tmp_path / "c.npz"))
    with pytest.raises(RuntimeError, match="no trace has run"):
        t.intersection_points()
    with pytest.raises(ValueError, match="intersection points"):
        t.run_source_moves(1)
