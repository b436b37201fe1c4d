"""The port's mesh partition and partitioned walk step against the JAX
package, on the CPU.

Mirrors tests/test_mesh_partition.py but for its recorded-points cases
(ROADMAP.md A9b): the partition's cover, balance, adjacency and halo
tables (here also bit-equal to the JAX partition's), the step against the
single-chip walk (plain, with material boundaries, a small exchange
buffer, the ignored unroll/compaction/scatter/ladder knobs, flat slabs
with halo 0 and 1, 64 groups, halo 1 and 2, a jittered mesh) and the
float64 conservation ledger under relocation chases. One JAX partitioned
step per halo depth is compiled (a module fixture) and the port's step
is held to it slot by slot.

Tolerances (float64, the JAX tests' own): positions and track lengths
atol 1e-12, the assembled flux atol 1e-11 against the single-chip walk;
elements, material ids, done flags, segment counts, slots, rounds and the
exchange counts equal. The knobs the port ignores leave its results
bitwise unchanged.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from pumiumtally_tpu.ops import walk_partitioned as jwp
from pumiumtally_tpu.ops.walk import trace_impl
from pumiumtally_tpu.parallel.mesh_partition import partition_mesh as jpartition
from pumiumtally_tpu.parallel.particle_sharding import (
    make_device_mesh as jdevice_mesh,
)
from pumiumtally_tpu_torch.ops import walk_partitioned as pwp
from pumiumtally_tpu_torch.parallel.mesh_partition import (
    assemble_global_flux,
    decode_remote,
    disassemble_global_flux,
    morton_order,
    partition_mesh,
)
from pumiumtally_tpu_torch.parallel.particle_sharding import make_device_mesh

from torch_twins import twin_meshes

N_DEV = 8
ATOL = 1e-12
FLUX_ATOL = 1e-11
HOST_FIELDS = ("owner", "global2local", "local2global", "counts")
TABLE_FIELDS = ("face_normals", "face_d", "tet2tet_enc", "class_id",
                "nbr_class", "volumes", "row_owner", "row_owner_local",
                "halo_send_rows", "halo_recv_rows")


@pytest.fixture(scope="module")
def box():
    return twin_meshes(torch.float64, nx=4)  # 384 tets


@pytest.fixture(scope="module")
def two_region():
    return twin_meshes(torch.float64, nx=4, classes=(1, 2))


def _batch(mesh, n, seed, spread=0.9):
    rng = np.random.default_rng(seed)
    elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
    origin = mesh.centroids().numpy()[elem]
    dest = np.clip(origin + rng.uniform(-spread, spread, (n, 3)), -0.2, 1.2)
    weight = rng.uniform(0.5, 2.0, n)
    group = rng.integers(0, 2, n).astype(np.int32)
    return elem, origin, dest, weight, group


def _single_chip(jmesh, batch, n_groups=2):
    elem, origin, dest, weight, group = batch
    n = len(elem)
    return trace_impl(
        jmesh, jnp.asarray(origin), jnp.asarray(dest), jnp.asarray(elem),
        jnp.ones(n, bool), jnp.asarray(weight), jnp.asarray(group),
        jnp.full(n, -1, jnp.int32),
        jnp.zeros(jmesh.ntet * n_groups * 2), n_groups=n_groups,
        initial=False, max_crossings=jmesh.ntet + 8, tolerance=1e-8)


def _partitioned(pmesh, part, batch, n_groups=2, flat=True, **kw):
    elem, origin, dest, weight, group = batch
    n = len(elem)
    dm = make_device_mesh(part.n_parts, "cpu")
    placed = pwp.distribute_particles(part, dm, elem, dict(
        origin=origin, dest=dest, weight=weight, group=group,
        material_id=np.full(n, -1, np.int32)))
    step = pwp.make_partitioned_step(dm, part, n_groups=n_groups,
                                     max_crossings=pmesh.ntet + 8,
                                     tolerance=1e-8, **kw)
    L = part.max_local
    shape = (part.n_parts, L * n_groups * 2) if flat else (
        part.n_parts, L, n_groups, 2)
    res = step(placed["origin"], placed["dest"], placed["elem"],
               torch.zeros_like(placed["valid"]), placed["material_id"],
               placed["weight"], placed["group"], placed["particle_id"],
               placed["valid"], torch.zeros(shape, dtype=torch.float64))
    return res, pwp.collect_by_particle_id(res, n, part)


def _global_flux(part, res, n_groups=2):
    return assemble_global_flux(
        part, res.flux.reshape(part.n_parts, part.max_local, n_groups, 2))


def _assert_matches_single(part, res, got, ref, n_groups=2):
    assert int(res.n_dropped.sum()) == 0
    assert got["done"].all()
    np.testing.assert_allclose(
        _global_flux(part, res, n_groups),
        np.asarray(ref.flux).reshape(-1, n_groups, 2), rtol=0,
        atol=FLUX_ATOL)
    np.testing.assert_allclose(got["position"], np.asarray(ref.position),
                               atol=ATOL)
    np.testing.assert_array_equal(got["material_id"],
                                  np.asarray(ref.material_id))
    np.testing.assert_array_equal(got["elem_global"], np.asarray(ref.elem))
    np.testing.assert_allclose(got["track_length"],
                               np.asarray(ref.track_length), atol=ATOL)
    assert int(res.n_segments.sum()) == int(ref.n_segments)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_parts,halo", [(8, 0), (4, 1), (8, 2), (2, 1)])
def test_partition_bit_equal_to_jax(n_parts, halo, dtype):
    jm, pm = twin_meshes(dtype, nx=4)
    a = jpartition(jm, n_parts, halo_layers=halo)
    b = partition_mesh(pm, n_parts, halo_layers=halo)
    assert (a.n_parts, a.max_local, a.halo_layers) == (
        b.n_parts, b.max_local, b.halo_layers)
    for f in HOST_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in TABLE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, f
            continue
        x, y = np.asarray(x), y.numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_partition_covers_and_balances(box):
    _, pm = box
    part = partition_mesh(pm, N_DEV)
    assert part.owner.shape == (pm.ntet,)
    assert part.counts.sum() == pm.ntet
    assert part.counts.max() - part.counts.min() <= 1
    for p in range(N_DEV):
        l2g = part.local2global[p, : part.counts[p]]
        assert np.all(part.owner[l2g] == p)
        assert np.all(part.global2local[l2g] == np.arange(part.counts[p]))


def test_partition_adjacency_encoding(box):
    _, pm = box
    part = partition_mesh(pm, N_DEV)
    t2t, cls = pm.tet2tet.numpy(), pm.class_id.numpy()
    enc, ncls = part.tet2tet_enc.numpy(), part.nbr_class.numpy()
    for p in range(N_DEV):
        for li in range(int(part.counts[p])):
            g = part.local2global[p, li]
            for f in range(4):
                nb, e = t2t[g, f], enc[p, li, f]
                if nb < 0:
                    assert e == -1 and ncls[p, li, f] == cls[g]
                elif part.owner[nb] == p:
                    assert e == part.global2local[nb]
                else:
                    owner, loc = decode_remote(e, part.max_local)
                    assert owner == part.owner[nb]
                    assert part.local2global[owner, loc] == nb
                if nb >= 0:
                    assert ncls[p, li, f] == cls[nb]
        assert np.all(enc[p, int(part.counts[p]):] == -1)


def test_morton_order_is_permutation():
    pts = np.random.default_rng(0).uniform(size=(500, 3))
    assert sorted(morton_order(pts).tolist()) == list(range(500))


def test_partition_halo_tables(box):
    _, pm = box
    part0 = partition_mesh(pm, N_DEV)
    part = partition_mesh(pm, N_DEV, halo_layers=1)
    t2t = pm.tet2tet.numpy()
    assert part.halo_layers == 1 and np.array_equal(part.counts,
                                                    part0.counts)
    ro, rol = part.row_owner.numpy(), part.row_owner_local.numpy()
    for p in range(N_DEV):
        n_owned = int(part.counts[p])
        rows = part.local2global[p]
        n_rows = int((rows >= 0).sum())
        assert n_rows > n_owned
        assert np.all(part.owner[rows[n_owned:n_rows]] != p)
        assert np.all(ro[p, :n_rows] == part.owner[rows[:n_rows]])
        assert np.all(rol[p, :n_rows] == part.global2local[rows[:n_rows]])
        expect = {int(nb) for g in rows[:n_owned] for nb in t2t[g]
                  if nb >= 0 and part.owner[nb] != p}
        assert set(rows[n_owned:n_rows].tolist()) == expect
    hs, hr = part.halo_send_rows.numpy(), part.halo_recv_rows.numpy()
    for p in range(N_DEV):
        for q in range(N_DEV):
            sl = hs[p, q][hs[p, q] < part.max_local]
            rl = hr[q, p][hr[q, p] < part.max_local]
            assert len(sl) == len(rl)
            for s, r in zip(sl, rl):
                g = part.local2global[p, s]
                assert part.local2global[q, r] == g


def test_disassemble_inverts_assemble(box):
    _, pm = box
    part = partition_mesh(pm, 4, halo_layers=1)
    flux = np.random.default_rng(2).uniform(size=(pm.ntet, 3, 2))
    slabs = disassemble_global_flux(part, flux)
    for p in range(4):
        assert not slabs[p, int(part.counts[p]):].any()
    np.testing.assert_array_equal(assemble_global_flux(part, slabs), flux)


@pytest.fixture(scope="module", params=[0, 1], ids=["halo0", "halo1"])
def jax_step(request, box):
    """The JAX partitioned step (8 virtual devices) on one batch, with the
    port's step on the same inputs."""
    jm, pm = box
    halo = request.param
    batch = _batch(pm, 96, seed=3)
    elem, origin, dest, weight, group = batch
    n = len(elem)
    jpart = jpartition(jm, N_DEV, halo_layers=halo)
    dm = jdevice_mesh(N_DEV)
    placed = jwp.distribute_particles(jpart, dm, elem, dict(
        origin=origin, dest=dest, weight=weight, group=group,
        material_id=np.full(n, -1, np.int32)))
    step = jwp.make_partitioned_step(dm, jpart, n_groups=2,
                                     max_crossings=jm.ntet + 8,
                                     tolerance=1e-8)
    flux = jax.device_put(jnp.zeros((N_DEV, jpart.max_local * 4)),
                          NamedSharding(dm, JP("p")))
    jres = step(placed["origin"], placed["dest"], placed["elem"],
                jnp.zeros_like(placed["valid"]), placed["material_id"],
                placed["weight"], placed["group"], placed["particle_id"],
                placed["valid"], flux)
    part = partition_mesh(pm, N_DEV, halo_layers=halo)
    res, got = _partitioned(pm, part, batch)
    return jres, res, got, part, batch


def test_step_matches_jax_slot_by_slot(jax_step):
    jres, res, _, _, _ = jax_step
    for f in ("particle_id", "valid", "elem", "material_id", "done",
              "group"):
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(jres, f)), f)
    for f in ("position", "track_length", "weight"):
        np.testing.assert_allclose(getattr(res, f).numpy(),
                                   np.asarray(getattr(jres, f)), atol=ATOL)
    np.testing.assert_allclose(res.flux.numpy(), np.asarray(jres.flux),
                               rtol=0, atol=FLUX_ATOL)
    np.testing.assert_array_equal(res.n_rounds.numpy(),
                                  np.asarray(jres.n_rounds))
    np.testing.assert_array_equal(res.n_segments.numpy(),
                                  np.asarray(jres.n_segments))
    R = res.round_stats.shape[2]
    np.testing.assert_array_equal(res.round_stats.numpy()[:, :5],
                                  np.asarray(jres.round_stats)[:, :5, :R])
    assert int(res.n_rounds[0]) >= 1


def test_partitioned_matches_single_chip(jax_step, box):
    jm, _ = box
    _, res, got, part, batch = jax_step
    _assert_matches_single(part, res, got, _single_chip(jm, batch))
    if part.halo_layers:  # guest rows come back zeroed
        slabs = res.flux.numpy().reshape(N_DEV, part.max_local, -1)
        for p in range(N_DEV):
            assert not slabs[p, int(part.counts[p]):].any()


@pytest.mark.parametrize("halo", [0, 1])
def test_partitioned_material_boundaries(two_region, halo):
    jm, pm = two_region
    part = partition_mesh(pm, N_DEV, halo_layers=halo)
    batch = list(_batch(pm, 40, seed=7))
    batch[2][:, 0] = np.where(batch[1][:, 0] < 0.5, 0.95, 0.05)
    res, got = _partitioned(pm, part, batch)
    _assert_matches_single(part, res, got, _single_chip(jm, batch))
    assert (got["material_id"] >= 1).any()


def test_partitioned_small_exchange_buffer(box):
    jm, pm = box
    part = partition_mesh(pm, N_DEV)
    batch = _batch(pm, 64, seed=11)
    res, got = _partitioned(pm, part, batch, exchange_size=2,
                            max_rounds=256)
    _assert_matches_single(part, res, got, _single_chip(jm, batch))
    assert int(res.n_rounds[0]) > 1
    rs = res.round_stats.numpy()
    assert (rs[:, 1] < rs[:, 0]).any()  # some emigrants waited a round


def test_later_phases_sized_from_remaining_paths(box, monkeypatch):
    """With ``face_rate`` every walk phase after the first gets a record
    capacity of at least 4 a lane and at least the records it makes, read
    with the round's stop test (one host read a round either way); the
    results are bitwise those of the step without it."""
    from pumiumtally_tpu_torch.ops import walk_cuda

    _, pm = box
    part = partition_mesh(pm, N_DEV, halo_layers=1)
    batch = _batch(pm, 96, seed=3)
    seen = []

    def walk_rows(*args, capacity=None, **kw):
        out, rec = pwp.walk_rows_plain(*args, **kw)
        seen.append((capacity, args[1].shape[0], int(out["nseg"].sum())))
        return out, rec

    monkeypatch.setattr(walk_cuda, "walk_rows", walk_rows)
    w0 = pwp.ROUND_WAITS
    a, _ = _partitioned(pm, part, batch, face_rate=walk_cuda.face_rate(pm))
    waits = pwp.ROUND_WAITS - w0
    b, _ = _partitioned(pm, part, batch)
    assert pwp.ROUND_WAITS - w0 - waits == waits == int(a.n_rounds[0]) + 1
    assert seen[0][0] is None and len(seen) > 2
    for capacity, lanes, records in seen[1:len(seen) // 2]:
        assert capacity >= max(4 * lanes, records), (capacity, lanes)
    assert all(c is None for c, _, _ in seen[len(seen) // 2:])
    for f in ("position", "elem", "material_id", "done", "particle_id",
              "track_length", "flux", "n_rounds", "round_stats"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("knob", [
    dict(unroll=4),
    dict(compact_after=4, compact_size=16),
    dict(tally_scatter="interleaved"),
    dict(compact_stages=((4, 64), (8, 48, 4), (16, 24, 8))),
    dict(followup_compact_size=8),
], ids=["unroll", "compaction", "scatter", "ladder", "followup"])
def test_scheduling_knobs_leave_results_bitwise(box, knob):
    _, pm = box
    part = partition_mesh(pm, N_DEV, halo_layers=1)
    batch = _batch(pm, 96, seed=3)
    a, _ = _partitioned(pm, part, batch)
    b, _ = _partitioned(pm, part, batch, **knob)
    for f in ("position", "elem", "material_id", "done", "particle_id",
              "track_length", "flux", "n_rounds", "round_stats"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("halo", [0, 1])
def test_partitioned_flat_flux_matches(box, halo):
    _, pm = box
    part = partition_mesh(pm, N_DEV, halo_layers=halo)
    batch = _batch(pm, 96, seed=3)
    r3, g3 = _partitioned(pm, part, batch, flat=False)
    rf, gf = _partitioned(pm, part, batch, flat=True)
    assert rf.flux.shape == (N_DEV, part.max_local * 4)
    assert torch.equal(rf.flux.view(r3.flux.shape), r3.flux)
    for f in ("position", "material_id", "track_length"):
        np.testing.assert_array_equal(gf[f], g3[f])


def test_partitioned_64_groups_matches_single_chip(box):
    jm, pm = box
    g = 64
    part = partition_mesh(pm, N_DEV, halo_layers=1)
    batch = list(_batch(pm, 96, seed=21))
    batch[4] = np.random.default_rng(22).integers(0, g, 96).astype(np.int32)
    res, got = _partitioned(pm, part, batch, n_groups=g)
    _assert_matches_single(part, res, got, _single_chip(jm, batch, g), g)


@pytest.mark.parametrize("halo", [1, 2])
def test_partitioned_halo_matches_single_chip(box, halo):
    jm, pm = box
    batch = _batch(pm, 96, seed=3)
    res0, _ = _partitioned(pm, partition_mesh(pm, N_DEV), batch)
    part = partition_mesh(pm, N_DEV, halo_layers=halo)
    res, got = _partitioned(pm, part, batch)
    _assert_matches_single(part, res, got, _single_chip(jm, batch))
    assert int(res.n_rounds[0]) <= int(res0.n_rounds[0])


def test_partitioned_halo_jittered_mesh_parity():
    jm, pm = twin_meshes(torch.float64, nx=5, jitter=0.2, seed=4)
    part = partition_mesh(pm, 4, halo_layers=1)
    batch = _batch(pm, 128, seed=8, spread=0.7)
    res, got = _partitioned(pm, part, batch)
    _assert_matches_single(part, res, got, _single_chip(jm, batch))


def test_ledger_exact_in_f64_under_wrong_parent_relocation():
    """Sources two element sizes off their claimed parent: relocation
    chases cross cuts before scoring starts; the migrated ledger equals
    |final - source| within the walk's geometric envelope."""
    _, pm = twin_meshes(torch.float64, nx=6)
    part = partition_mesh(pm, 8, halo_layers=1)
    n = 512
    rng = np.random.default_rng(11)
    cen = pm.centroids().numpy()
    elem = rng.integers(0, pm.ntet, n).astype(np.int32)
    src = np.clip(cen[elem] + rng.normal(0, 0.2, (n, 3)), 0.002, 0.998)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    dest = src + u * rng.exponential(0.4, (n, 1))
    batch = (elem, src, dest, np.ones(n),
             rng.integers(0, 2, n).astype(np.int32))
    res, got = _partitioned(pm, part, batch)
    assert got["done"].all() and int(res.n_dropped.sum()) == 0
    assert int(res.stats[:, 2].sum()) > 0  # relocation chases ran
    disp = np.linalg.norm(got["position"] - src, axis=1)
    np.testing.assert_allclose(got["track_length"], disp, atol=1e-6)
