"""The partitioned walk phase's crossing budget (ROADMAP.md C3) against
the JAX step, on the CPU.

The JAX step walks its later phases (and, with ``compact_after``, its
first phase past it) in compacted rounds: each takes a part's first S
active slots and gives them a fresh ``max_crossings`` budget and a fresh
loop counter, which the stuck-lane chase hash reads. The port's step
reproduces that schedule lane for lane (``ops/walk_partitioned.py``).
Here both steps walk the same batch at ``max_crossings`` 5 and 8, 4 and 8
parts, both dtypes, with the default ``max_rounds`` (and with the first
phase compacted, one stage or a ladder): a quarter of the lanes start two
element sizes off their claimed parent, so they chase across cuts.

Tolerances, those of the partitioned tests (tests/torch_twins.py TOL):
particle ids, validity, elements, material ids and done flags slot by
slot, hence the truncation set, equal; positions and track lengths within
the position tolerance; the flux slabs within the flux tolerances. The
facade cases (per move and the megastep, default ``max_rounds``) hold
the port's ``PartitionedTally`` to the JAX facade's as the truncation
tests of tests/test_torch_partitioned_features.py and
tests/test_torch_partitioned_megastep.py do with ``max_rounds`` 0 or 1.
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
from pumiumtally_tpu.ops import source as jsource
from pumiumtally_tpu.ops import walk_partitioned as jwp
from pumiumtally_tpu.parallel.mesh_partition import partition_mesh as jpartition
from pumiumtally_tpu.parallel.partitioned_api import (
    PartitionedTally as JPartitionedTally,
)
from pumiumtally_tpu.parallel.particle_sharding import (
    make_device_mesh as jdevice_mesh,
)
from pumiumtally_tpu_torch import PartitionedTally, TallyConfig
from pumiumtally_tpu_torch.ops import source
from pumiumtally_tpu_torch.ops import walk_partitioned as pwp
from pumiumtally_tpu_torch.parallel.mesh_partition import partition_mesh
from pumiumtally_tpu_torch.parallel.particle_sharding import make_device_mesh
from torch_twins import JDT, TOL, twin_meshes

N = 128
SLOT_EQUAL = ("particle_id", "valid", "elem", "material_id", "done")


@pytest.fixture(scope="module")
def meshes():
    return {dt: twin_meshes(dt, nx=4, classes=(1, 2))
            for dt in (torch.float32, torch.float64)}


def _batch(mesh, seed=5):
    """Lanes from element centroids toward far points; every fourth lane
    claims a parent two element sizes from its start (a chase)."""
    rng = np.random.default_rng(seed)
    cen = mesh.centroids().numpy().astype(np.float64)
    elem = rng.integers(0, mesh.ntet, N).astype(np.int32)
    origin = cen[elem].copy()
    wrong = np.arange(N) % 4 == 0
    origin[wrong] = np.clip(origin[wrong] + rng.normal(0, 0.2, (
        int(wrong.sum()), 3)), 0.01, 0.99)
    dest = np.clip(origin + rng.uniform(-0.9, 0.9, (N, 3)), -0.2, 1.2)
    return (elem, origin, dest, rng.uniform(0.5, 2.0, N),
            rng.integers(0, 2, N).astype(np.int32))


def _fields(batch, dtype):
    elem, origin, dest, weight, group = batch
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    return elem, dict(origin=origin.astype(np_dt), dest=dest.astype(np_dt),
                      weight=weight.astype(np_dt), group=group,
                      material_id=np.full(len(elem), -1, np.int32))


def _jax_step(jmesh, n_parts, batch, dtype, **kw):
    jpart = jpartition(jmesh, n_parts, halo_layers=1)
    dm = jdevice_mesh(n_parts)
    elem, fields = _fields(batch, dtype)
    placed = jwp.distribute_particles(jpart, dm, elem, fields)
    step = jwp.make_partitioned_step(dm, jpart, n_groups=2,
                                     tolerance=1e-8, **kw)
    flux = jax.device_put(jnp.zeros((n_parts, jpart.max_local * 4),
                                    JDT[dtype]), NamedSharding(dm, JP("p")))
    return step(placed["origin"], placed["dest"], placed["elem"],
                jnp.zeros_like(placed["valid"]), placed["material_id"],
                placed["weight"], placed["group"], placed["particle_id"],
                placed["valid"], flux)


def _port_step(pmesh, n_parts, batch, dtype, **kw):
    part = partition_mesh(pmesh, n_parts, halo_layers=1)
    dm = make_device_mesh(n_parts, "cpu")
    elem, fields = _fields(batch, dtype)
    placed = pwp.distribute_particles(part, dm, elem, fields)
    step = pwp.make_partitioned_step(dm, part, n_groups=2, tolerance=1e-8,
                                     **kw)
    flux = torch.zeros(n_parts, part.max_local * 4, dtype=dtype)
    return step(placed["origin"], placed["dest"], placed["elem"],
                torch.zeros_like(placed["valid"]), placed["material_id"],
                placed["weight"], placed["group"], placed["particle_id"],
                placed["valid"], flux)


def _assert_steps_agree(res, jres, dtype):
    pos_tol, rtol, atol = TOL[dtype]
    for f in SLOT_EQUAL:
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(jres, f)), f)
    for f in ("position", "track_length"):
        np.testing.assert_allclose(getattr(res, f).numpy(),
                                   np.asarray(getattr(jres, f)), rtol=0,
                                   atol=pos_tol, err_msg=f)
    np.testing.assert_allclose(res.flux.numpy(), np.asarray(jres.flux),
                               rtol=rtol, atol=atol)
    np.testing.assert_array_equal(res.n_rounds.numpy(),
                                  np.asarray(jres.n_rounds))
    np.testing.assert_array_equal(res.n_segments.numpy(),
                                  np.asarray(jres.n_segments))


@pytest.mark.parametrize("max_crossings", [5, 8])
@pytest.mark.parametrize("n_parts", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_budget_matches_jax_lane_for_lane(meshes, dtype, n_parts,
                                          max_crossings):
    """Default max_rounds: the later phases' lanes that run out of budget
    walk on in the JAX step's later rounds; the port re-launches them."""
    jm, pm = meshes[dtype]
    batch = _batch(pm)
    jres = _jax_step(jm, n_parts, batch, dtype, max_crossings=max_crossings)
    r0 = pwp.BUDGET_RELAUNCHES
    res = _port_step(pm, n_parts, batch, dtype, max_crossings=max_crossings)
    _assert_steps_agree(res, jres, dtype)  # the truncation sets too
    if max_crossings == 5:
        assert pwp.BUDGET_RELAUNCHES > r0  # later rounds walked lanes
    assert pwp.BUDGET_STARVED == 0


@pytest.mark.parametrize("kw", [
    dict(compact_after=3, compact_size=32),
    dict(compact_stages=((2, 96), (4, 48), (6, 24))),
    dict(followup_compact_size=8),
], ids=["compact_after", "ladder", "followup"])
def test_compacted_first_phase_matches_jax(meshes, kw):
    """The first phase's compacted rounds (a fresh count from
    compact_after, one stage or a ladder) and narrow later rounds."""
    dtype = torch.float64
    jm, pm = meshes[dtype]
    batch = _batch(pm, seed=9)
    jres = _jax_step(jm, 4, batch, dtype, max_crossings=6, **kw)
    res = _port_step(pm, 4, batch, dtype, max_crossings=6, **kw)
    _assert_steps_agree(res, jres, dtype)


def test_compacted_chases_restart_their_count():
    """Sources 0.25 off their claimed parents on a jittered 5^3 box (512
    lanes, numpy seed 10): most lanes chase, and past compact_after=3
    the JAX step's compacted round restarts the loop count the chase hash
    reads. The port's step follows it lane for lane; without the
    compaction 74 lanes end elsewhere, so the restart is what agrees."""
    dtype = torch.float64
    jm, pm = twin_meshes(dtype, nx=5, jitter=0.2, seed=4)
    rng = np.random.default_rng(10)
    n = 512
    cen = pm.centroids().numpy()
    elem = rng.integers(0, pm.ntet, n).astype(np.int32)
    src = np.clip(cen[elem] + rng.normal(0, 0.25, (n, 3)), 0.02, 0.98)
    dest = np.clip(src + rng.normal(0, 0.3, (n, 3)), 0.02, 0.98)
    batch = (elem, src, dest, np.ones(n), np.zeros(n, np.int32))
    bound = pm.ntet + 64
    kw = dict(max_crossings=bound, compact_after=3, compact_size=128)
    jres = _jax_step(jm, 4, batch, dtype, **kw)
    res = _port_step(pm, 4, batch, dtype, **kw)
    _assert_steps_agree(res, jres, dtype)
    assert int(res.stats[:, 2].sum()) > 0  # chase hops
    other = _port_step(pm, 4, batch, dtype, max_crossings=bound)
    assert not torch.equal(res.position, other.position)


def test_starved_lanes_keep_their_state_like_jax():
    """Two parts, max_crossings=2, the first phase compacted from
    crossing 1 into rounds of 8 lanes (and later phases too) on a 6^3
    box: lanes that ran out fill every round, so the JAX rounds never
    take some active lanes, which keep their state from before the
    phase's compacted rounds. The port walks every lane's first round in
    one launch, so it puts those lanes back (state, counters, records)
    and still agrees lane for lane."""
    dtype = torch.float64
    jm, pm = twin_meshes(dtype, nx=6, classes=(1, 2))
    elem, origin, dest, weight, group = _batch(pm)
    rng = np.random.default_rng(5)
    extra = rng.integers(0, pm.ntet, N).astype(np.int32)
    cen = pm.centroids().numpy()
    batch = (np.concatenate([elem, extra]),
             np.concatenate([origin, cen[extra]]),
             np.concatenate([dest, np.clip(cen[extra] + rng.uniform(
                 -0.9, 0.9, (N, 3)), -0.2, 1.2)]),
             np.concatenate([weight, rng.uniform(0.5, 2.0, N)]),
             np.concatenate([group, rng.integers(0, 2, N).astype(np.int32)]))
    kw = dict(max_crossings=2, compact_after=1, compact_size=8,
              followup_compact_size=8)
    jres = _jax_step(jm, 2, batch, dtype, **kw)
    s0 = pwp.BUDGET_STARVED
    res = _port_step(pm, 2, batch, dtype, **kw)
    _assert_steps_agree(res, jres, dtype)
    assert pwp.BUDGET_STARVED > s0


def test_default_bound_adds_no_launch(meshes, monkeypatch):
    """At the default bound (ntet + 64) no lane runs out: one walk a
    phase, as before the repair."""
    from pumiumtally_tpu_torch.ops import walk_cuda

    dtype = torch.float64
    _, pm = meshes[dtype]
    calls = []

    def walk_rows(*args, **kw):
        calls.append(args[1].shape[0])
        return pwp.walk_rows_plain(*args, **kw)

    monkeypatch.setattr(walk_cuda, "walk_rows", walk_rows)
    r0 = pwp.BUDGET_RELAUNCHES
    res = _port_step(pm, 4, _batch(pm), dtype, max_crossings=pm.ntet + 64,
                     compact_after=3, compact_size=32)
    assert bool(res.done[res.valid].all())
    assert len(calls) == int(res.n_rounds[0]) + 1
    assert pwp.BUDGET_RELAUNCHES == r0


# --------------------------------------------------------------------- #
# The facades at the default max_rounds
# --------------------------------------------------------------------- #
M = 64


def _facade_inputs(rng):
    dest = rng.uniform(0.05, 0.95, (M, 3))
    return (dest.ravel().copy(), np.ones(M, np.int8),
            rng.uniform(0.5, 2.0, M), rng.integers(0, 2, M).astype(np.int32),
            np.full(M, -1, np.int32))


def _facade_drive(t, moves=2):
    rng = np.random.default_rng(11)
    t.initialize_particle_location(rng.uniform(0.05, 0.95, (M, 3)).ravel())
    outs = []
    for _ in range(moves):
        dest, fly, w, g, mats = _facade_inputs(rng)
        t.move_to_next_location(dest, fly, w, g, mats)
        outs.append((dest.reshape(M, 3).copy(), mats.copy()))
    return outs


@pytest.mark.parametrize("retries", [0, 8])
def test_facade_truncation_default_rounds_matches_jax(meshes, retries):
    """max_crossings=5 through PartitionedTally with the default
    max_rounds, with and without re-walks: the positions, materials,
    flux and the re-walk totals agree with the JAX facade's."""
    jm, pm = meshes[torch.float64]
    cfg = dict(n_groups=2, tolerance=1e-8, max_crossings=5, unroll=1,
               truncation_retries=retries)
    r0 = pwp.BUDGET_RELAUNCHES
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        t = PartitionedTally(pm, M, TallyConfig(dtype=torch.float64, **cfg),
                             n_parts=4, halo_layers=1, device="cpu")
        outs = _facade_drive(t)
        jt = JPartitionedTally(jm, M, jpt.TallyConfig(dtype=jnp.float64,
                                                      **cfg),
                               n_parts=4, halo_layers=1)
        jouts = _facade_drive(jt)
    pos_tol, rtol, atol = TOL[torch.float64]
    for (pa, ma), (pb, mb) in zip(outs, jouts):
        np.testing.assert_allclose(pa, pb, rtol=0, atol=pos_tol)
        np.testing.assert_array_equal(ma, mb)
    np.testing.assert_allclose(t.raw_flux, np.asarray(jt.raw_flux),
                               rtol=rtol, atol=atol)
    np.testing.assert_array_equal(t.elem_global, np.asarray(jt.elem_global))
    tm, jtm = t.telemetry()["totals"], jt.telemetry()["totals"]
    for f in ("rewalked", "lost", "segments"):
        assert tm[f] == jtm[f], f
    assert pwp.BUDGET_RELAUNCHES > r0  # later rounds walked lanes


def test_megastep_truncation_default_rounds_matches_jax(meshes):
    """The partitioned megastep at max_crossings=5 with the default
    max_rounds: counters, state and flux agree with the JAX facade's."""
    jm, pm = meshes[torch.float64]
    kw = dict(sigma_t={1: 4.0, 2: 9.0}, absorption={1: 0.3, 2: 0.5},
              survival_weight=0.2, seed=13)
    cfg = dict(n_groups=2, max_crossings=5, tolerance=1e-6, unroll=1,
               megastep=2)
    pos = np.random.default_rng(3).uniform(0.1, 0.9, (M, 3)).ravel()
    r0 = pwp.BUDGET_RELAUNCHES
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        t = PartitionedTally(pm, M, TallyConfig(dtype=torch.float64, **cfg),
                             n_parts=4, halo_layers=1, device="cpu")
        t.initialize_particle_location(pos.copy())
        out = t.run_source_moves(4, source.SourceParams(**kw),
                                 weights=np.ones(M))
        jt = JPartitionedTally(jm, M, jpt.TallyConfig(dtype=jnp.float64,
                                                      **cfg),
                               n_parts=4, halo_layers=1)
        jt.initialize_particle_location(pos.copy())
        jout = jt.run_source_moves(4, jsource.SourceParams(**kw),
                                   weights=np.ones(M))
    for f in ("moves", "segments", "collisions", "escaped", "rouletted",
              "alive", "truncated"):
        assert out[f] == jout[f], f
    assert pwp.BUDGET_RELAUNCHES > r0  # later rounds walked lanes
    pos_tol, rtol, atol = TOL[torch.float64]
    t._sync_source_state()
    jt._sync_source_state()
    np.testing.assert_allclose(t.positions, np.asarray(jt.positions),
                               rtol=0, atol=pos_tol)
    for f in ("elem_global", "material_id", "groups", "alive"):
        np.testing.assert_array_equal(getattr(t, f),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    np.testing.assert_allclose(t.raw_flux, np.asarray(jt.raw_flux),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("stages", ["auto", ((8, 512), (16, 256))],
                         ids=["auto", "schedule"])
def test_facade_refuses_stage_schedules(meshes, stages):
    """A ``compact_stages`` schedule is no longer refused (A10): the
    facade resolves it against its slots as the JAX facade does
    (``resolve_compact_stages(cap, ntet)``) and hands it to the step,
    whose first walk phase walks its crossing budgets. The name is kept
    from when the facade refused it."""
    _, pm = meshes[torch.float64]
    t = PartitionedTally(pm, 2048, TallyConfig(dtype=torch.float64,
                                               compact_stages=stages),
                         n_parts=2, device="cpu")
    want = jpt.TallyConfig(dtype=jnp.float64, compact_stages=stages
                           ).resolve_compact_stages(2048, ntet=pm.ntet)
    assert want and t._step_kwargs["compact_stages"] == want


def test_timed_launch_is_the_steps_first_phase(meshes):
    """What chip_smoke.py and turns.py time as the first walk phase, one
    ``walk_rows`` launch with the step's budget (``compact_after`` +
    ``max_crossings``, the chase count restarting at ``compact_after``)
    and ``fold_records`` of its records, is the step's first walk phase:
    the lanes' outputs and the slab flux bitwise (``max_rounds=0``, no
    halo, so nothing else scores)."""
    from pumiumtally_tpu_torch.ops import walk_cuda

    dtype = torch.float64
    _, pm = meshes[dtype]
    part = partition_mesh(pm, 4, halo_layers=0)
    dm = make_device_mesh(4, "cpu")
    elem, fields = _fields(_batch(pm), dtype)
    placed = pwp.distribute_particles(part, dm, elem, fields)
    mc, ca = pm.ntet + 64, 3
    step = pwp.make_partitioned_step(
        dm, part, n_groups=2, tolerance=1e-8, max_crossings=mc,
        max_rounds=0, compact_after=ca, compact_size=32)
    res = step(placed["origin"], placed["dest"], placed["elem"],
               torch.zeros_like(placed["valid"]), placed["material_id"],
               placed["weight"], placed["group"], placed["particle_id"],
               placed["valid"],
               torch.zeros(4, part.max_local * 4, dtype=dtype))
    slots = torch.nonzero(placed["valid"])[:, 0]
    total = placed["valid"].shape[0]
    rows = ((slots // (total // 4)) * part.max_local
            + placed["elem"][slots]).to(torch.int32)
    m = slots.numel()
    flux = torch.zeros(4 * part.max_local * 4, dtype=dtype)
    out, rec = walk_cuda.walk_rows(
        pwp.stacked_tables(part), placed["origin"][slots],
        placed["dest"][slots], rows, placed["weight"][slots],
        placed["group"][slots], placed["material_id"][slots],
        torch.zeros(m, dtype=dtype), torch.full((m,), -1, dtype=torch.int32),
        torch.zeros(m, dtype=torch.int32), slots, flux, stride=total,
        max_local=part.max_local, initial=False, max_crossings=mc + ca,
        n_groups=2, tolerance=1e-8, reset=ca)
    pwp.fold_records(flux, [rec], True, flux.numel() // 2, False)
    assert (out["target"] >= 0).any()  # lanes froze at cuts
    assert torch.equal(flux, res.flux.view(-1))
    for name, f in (("pos", "position"), ("elem", "elem"),
                    ("mat", "material_id"), ("done", "done"),
                    ("pseg", "track_length")):
        assert torch.equal(out[name], getattr(res, f)[slots]), name
