"""The port's multi-process layer (``parallel/multihost.py``) and the
partitioned step over ranks, on the CPU with gloo.

Mirrors tests/test_multihost.py: ``TestInitDistributed``,
``TestHostLocalBatch``, ``TestAllreduceFlux``, ``TestWriteParallelVtk``
in one process with the rank functions patched, and two gloo processes
(subprocesses joined through a ``file://`` rendezvous under ``tmp_path``,
so parallel test workers never race for a port):

  * ``test_two_process_allreduce``: each process walks its
    ``host_local_batch`` share; the collective and the host-gather sums
    agree to 1e-12, the two processes' totals to 1e-10 relative, and the
    total equals the JAX single-device walk of the whole batch to 1e-10
    relative (the JAX test's bars); each process writes its VTK piece,
    rank 0 the index.
  * ``test_two_process_partitioned_migration``: 8 parts over 2 ranks (4
    each, each rank building only its own parts' tables) on the 4×4×4 box
    in float64: the per-slot state, rounds, segments and assembled flux
    equal the port's stacked step bit for bit, and the flux is within
    1e-12 absolute of the JAX partitioned step and of the JAX
    single-device walk (segments equal).
  * ``test_one_rank_group_is_the_stacked_step``: the step in a group of
    one rank (the code path the card runs under NCCL) equals the stacked
    step bit for bit.
  * ``test_two_process_partitioned_xpoints``: the same step over 2 ranks
    with ``record_xpoints=4`` bit for bit the stacked step, the points
    and counts included (their columns ride the exchange's send rows).
  * ``test_two_process_partitioned_megastep``: the partitioned megastep
    (K = 3 device-sourced moves, 8 parts, the 4×4×4 two-region box,
    float64) over 2 gloo ranks, each rank holding its parts' slot state,
    class rows and per-part tail, bit for bit the stacked megastep: slot
    state, slab flux and readback, the physics sums included (both add
    per-part partial sums in part order); and a group of one rank too.

Every worker has its own timeout (120 s); a timeout fails the test with
the worker's stderr.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumiumtally_tpu.ops import walk_partitioned as jwp
from pumiumtally_tpu.ops.walk import trace_impl
from pumiumtally_tpu.parallel.mesh_partition import partition_mesh as jpartition
from pumiumtally_tpu.parallel.particle_sharding import (
    make_device_mesh as jdevice_mesh,
)
from pumiumtally_tpu_torch.parallel import multihost
from torch_twins import twin_meshes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120

WORKER_ALLREDUCE = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    init, rank, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    from pumiumtally_tpu_torch.parallel.multihost import (
        allreduce_flux, host_local_batch, init_distributed,
        write_parallel_vtk)
    assert init_distributed(init, 2, rank, device="cpu", timeout_s=60)
    from pumiumtally_tpu_torch import build_box, make_flux
    from pumiumtally_tpu_torch.core.tally import normalize_flux_host
    from pumiumtally_tpu_torch.ops import walk_cuda

    mesh = build_box(1.0, 1.0, 1.0, 3, 3, 3, dtype=torch.float64,
                     device="cpu")
    N = 64
    rng = np.random.default_rng(0)  # the same batch in every process
    elem = rng.integers(0, mesh.ntet, N).astype(np.int32)
    origin = mesh.centroids().numpy()[elem]
    dest = rng.uniform(0.02, 0.98, (N, 3))
    weight = rng.uniform(0.5, 2.0, N)
    start, count = host_local_batch(N)
    sl = slice(start, start + count)
    flux = make_flux(mesh.ntet, 1, torch.float64, device="cpu")
    r = walk_cuda.trace(
        mesh, torch.from_numpy(origin[sl].copy()),
        torch.from_numpy(dest[sl].copy()), torch.from_numpy(elem[sl]),
        torch.ones(count, dtype=torch.bool),
        torch.from_numpy(weight[sl].copy()),
        torch.zeros(count, dtype=torch.int32),
        torch.full((count,), -1, dtype=torch.int32), flux,
        initial=False, max_crossings=mesh.ntet + 8, n_groups=1,
        tolerance=1e-8)
    total = allreduce_flux(r.flux.view(mesh.ntet, 1, 2))
    total_host = allreduce_flux(r.flux.view(mesh.ntet, 1, 2),
                                in_program=False)
    assert np.allclose(total, total_host, rtol=0, atol=1e-12)
    norm = normalize_flux_host(total, mesh.volumes.numpy(), N, 1)
    piece = write_parallel_vtk(os.path.join(outdir, "flux"), mesh, norm)
    assert os.path.getsize(piece) > 100
    print("RESULT", rank, repr(float(total[..., 0].sum())), count)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
""")

WORKER_PARTITIONED = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    init, rank, world, out = (sys.argv[1], int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    K = int(sys.argv[5]) or None
    from pumiumtally_tpu_torch.parallel.multihost import (
        global_device_mesh, init_distributed)
    assert init_distributed(init, world, rank, device="cpu",
                            group_of_one=True, timeout_s=60)
    from pumiumtally_tpu_torch.mesh.box import build_box_arrays
    from pumiumtally_tpu_torch.mesh.core import TetMesh
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp
    from pumiumtally_tpu_torch.parallel.mesh_partition import (
        assemble_global_flux, partition_mesh)
    from pumiumtally_tpu_torch.parallel.ranks import rank_layout

    n_parts = 8
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, 4, 4, 4)
    mesh = TetMesh.from_numpy(coords, tets, dtype=torch.float64,
                              device="cpu")
    dm = global_device_mesh(n_parts // world, "cpu")
    lay = rank_layout(dm)
    part = partition_mesh(mesh, n_parts, halo_layers=1,
                          parts=(lay.lo, lay.hi))
    assert part.n_held == n_parts // world
    n = 64
    rng = np.random.default_rng(0)
    elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
    origin = mesh.centroids().numpy()[elem]
    dest = np.clip(origin + rng.uniform(-0.6, 0.6, (n, 3)), -0.1, 1.1)
    weight = rng.uniform(0.5, 2.0, n)
    group = rng.integers(0, 2, n).astype(np.int32)
    placed = wp.distribute_particles(part, dm, elem, dict(
        origin=origin, dest=dest, weight=weight, group=group,
        material_id=np.full(n, -1, np.int32)))
    step = wp.make_partitioned_step(dm, part, n_groups=2,
                                    max_crossings=mesh.ntet + 8,
                                    tolerance=1e-8, record_xpoints=K)
    flux = torch.zeros(lay.hi - lay.lo, part.max_local * 4,
                       dtype=torch.float64)
    res = step(placed["origin"], placed["dest"], placed["elem"],
               torch.zeros_like(placed["valid"]), placed["material_id"],
               placed["weight"], placed["group"], placed["particle_id"],
               placed["valid"], flux)
    names = ("position", "elem", "material_id", "done", "valid",
             "particle_id", "track_length", "n_segments", "n_rounds",
             "n_dropped", "round_stats", "stats", "flux")
    if K:
        names += ("xpoints", "n_xpoints")
    got = wp.gather_parts({k: getattr(res, k).numpy() for k in names}, dm)
    if rank == 0:
        np.savez(out, **got)
    print("PRESULT", rank, int(got["n_segments"].sum()),
          int(got["n_rounds"][0]))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
""")

MEGA_N, MEGA_K = 64, 3

# K = 3 partitioned megastep moves over a device mesh (this process's
# parts) on the 4×4×4 box with two regions split at x = 0.5, float64:
# this process's slot state, slabs and readback (numpy). Run by the
# workers and, stacked, by the test.
MEGA_CASE = textwrap.dedent("""
    import numpy as np
    import torch


    def megastep_case(device_mesh, n_parts, n=64, k=3):
        from pumiumtally_tpu_torch.mesh.box import build_box_arrays
        from pumiumtally_tpu_torch.mesh.core import TetMesh
        from pumiumtally_tpu_torch.ops import source
        from pumiumtally_tpu_torch.ops import walk_partitioned as pwp
        from pumiumtally_tpu_torch.parallel.mesh_partition import (
            partition_mesh)
        from pumiumtally_tpu_torch.parallel.ranks import rank_layout

        coords, tets = build_box_arrays(1.0, 1.0, 1.0, 4, 4, 4)
        cid = np.where(coords[tets].mean(axis=1)[:, 0] < 0.5, 1,
                       2).astype(np.int32)
        mesh = TetMesh.from_numpy(coords, tets, cid, dtype=torch.float64,
                                  device="cpu")
        lay = rank_layout(device_mesh)
        part = partition_mesh(mesh, n_parts, halo_layers=1,
                              parts=(lay.lo, lay.hi))
        rng = np.random.default_rng(7)
        elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
        placed = pwp.distribute_particles(part, device_mesh, elem, dict(
            origin=mesh.centroids().numpy()[elem],
            weight=rng.uniform(0.5, 2.0, n),
            group=rng.integers(0, 2, n).astype(np.int32),
            material_id=np.full(n, -1, np.int32)))
        src = source.SourceParams(sigma_t={1: 4.0, 2: 9.0},
                                  absorption={1: 0.3, 2: 0.5},
                                  survival_weight=0.2, seed=13)
        sig, ab = src.tables(cid)
        l2g = np.clip(part.local2global, 0, mesh.ntet - 1)
        mega = pwp.make_partitioned_megastep(
            device_mesh, part, n_moves=k, n_total=n, n_groups=2,
            class_local=np.clip(cid[l2g], 0, sig.shape[0] - 1),
            sigma_t=sig, absorb_t=ab,
            eps_near=source.near_epsilon(mesh.coords),
            survival_weight=src.survival_weight,
            downscatter=src.downscatter, dtype=torch.float64,
            max_crossings=mesh.ntet + 64, tolerance=1e-8)
        flux = torch.zeros(lay.hi - lay.lo, part.max_local * 4,
                           dtype=torch.float64)
        r = mega(placed["origin"], placed["elem"], placed["material_id"],
                 placed["weight"], placed["group"], placed["particle_id"],
                 placed["valid"], placed["valid"].clone(), flux, 0,
                 source.prng_key(src.seed))
        names = ("position", "dest", "elem", "material_id", "weight",
                 "group", "particle_id", "valid", "alive", "flux",
                 "readback")
        return {name: getattr(r, name).numpy() for name in names}
""")

WORKER_MEGASTEP = MEGA_CASE + textwrap.dedent("""
    import sys
    init, rank, world, out = (sys.argv[1], int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    from pumiumtally_tpu_torch.parallel.multihost import (
        global_device_mesh, init_distributed)
    assert init_distributed(init, world, rank, device="cpu",
                            group_of_one=True, timeout_s=60)
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp

    dm = global_device_mesh(8 // world, "cpu")
    got = wp.gather_parts(megastep_case(dm, 8), dm)
    if rank == 0:
        np.savez(out, **got)
    print("MRESULT", rank, got["readback"].tobytes().hex()[-96:])
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
""")


def _run_workers(script, args_of, n, tmp_path):
    """Run ``n`` workers; their stdouts, or a failure with the stderr of
    each that failed or ran past TIMEOUT."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, *args_of(i)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
        for i in range(n)]
    outs, errs = [], []
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            err = "".join(q.communicate()[1] or "" for q in procs)
            pytest.fail(f"worker {i} ran past {TIMEOUT} s:\n{err[-3000:]}")
        if p.returncode != 0:
            errs.append(f"worker {i} exited {p.returncode}:\n{err[-3000:]}")
        outs.append(out)
    if errs:
        for q in procs:
            q.kill()
        pytest.fail("\n".join(errs))
    return outs


def _init_method(tmp_path) -> str:
    return "file://" + str(tmp_path / "rendezvous")


def test_two_process_allreduce(tmp_path):
    init = _init_method(tmp_path)
    outs = _run_workers(WORKER_ALLREDUCE,
                        lambda i: (init, str(i), str(tmp_path)), 2, tmp_path)
    results, counts = {}, {}
    for out in outs:
        for m in re.finditer(r"^RESULT (\d+) (\S+) (\d+)\s*$", out,
                             re.MULTILINE):
            results[int(m.group(1))] = float(m.group(2))
            counts[int(m.group(1))] = int(m.group(3))
    assert set(results) == {0, 1}
    assert counts[0] + counts[1] == 64
    assert results[0] == pytest.approx(results[1], rel=1e-10)
    assert (tmp_path / "flux_p0000.vtu").exists()
    assert (tmp_path / "flux_p0001.vtu").exists()
    index = (tmp_path / "flux.pvtu").read_text()
    assert "flux_p0000.vtu" in index and "flux_p0001.vtu" in index
    # The JAX single-device walk of the whole batch.
    import pumiumtally_tpu as jpt

    mesh = jpt.build_box(1.0, 1.0, 1.0, 3, 3, 3, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    N = 64
    elem = rng.integers(0, mesh.ntet, N).astype(np.int32)
    origin = np.asarray(mesh.centroids())[elem]
    dest = rng.uniform(0.02, 0.98, (N, 3))
    weight = rng.uniform(0.5, 2.0, N)
    r = trace_impl(
        mesh, jnp.asarray(origin), jnp.asarray(dest), jnp.asarray(elem),
        jnp.ones(N, bool), jnp.asarray(weight), jnp.zeros(N, jnp.int32),
        jnp.full(N, -1, jnp.int32), jpt.make_flux(mesh.ntet, 1, jnp.float64),
        initial=False, max_crossings=mesh.ntet + 8, tolerance=1e-8)
    expect = float(np.asarray(r.flux)[..., 0].sum())
    assert results[0] == pytest.approx(expect, rel=1e-10)


# --------------------------------------------------------------------- #
# The partitioned step over ranks
# --------------------------------------------------------------------- #
def _batch(mesh):
    n = 64
    rng = np.random.default_rng(0)
    elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
    origin = mesh.centroids().numpy()[elem]
    dest = np.clip(origin + rng.uniform(-0.6, 0.6, (n, 3)), -0.1, 1.1)
    weight = rng.uniform(0.5, 2.0, n)
    group = rng.integers(0, 2, n).astype(np.int32)
    return elem, origin, dest, weight, group


def _stacked(pm, batch, n_parts=8, k=None):
    """The port's stacked step (every part in this process)."""
    from pumiumtally_tpu_torch.ops import walk_partitioned as pwp
    from pumiumtally_tpu_torch.parallel.mesh_partition import partition_mesh
    from pumiumtally_tpu_torch.parallel.particle_sharding import (
        make_device_mesh,
    )

    elem, origin, dest, weight, group = batch
    part = partition_mesh(pm, n_parts, halo_layers=1)
    dm = make_device_mesh(n_parts, "cpu")
    placed = pwp.distribute_particles(part, dm, elem, dict(
        origin=origin, dest=dest, weight=weight, group=group,
        material_id=np.full(len(elem), -1, np.int32)))
    step = pwp.make_partitioned_step(dm, part, n_groups=2,
                                     max_crossings=pm.ntet + 8,
                                     tolerance=1e-8, record_xpoints=k)
    res = step(placed["origin"], placed["dest"], placed["elem"],
               torch.zeros_like(placed["valid"]), placed["material_id"],
               placed["weight"], placed["group"], placed["particle_id"],
               placed["valid"],
               torch.zeros(n_parts, part.max_local * 4, dtype=torch.float64))
    return res, part


def _assert_bitwise(got, res):
    for k in got.files:
        np.testing.assert_array_equal(got[k], getattr(res, k).numpy(),
                                      err_msg=k)


def _ranked(tmp_path, world, k=0):
    init = _init_method(tmp_path)
    out = str(tmp_path / "rank0.npz")
    outs = _run_workers(
        WORKER_PARTITIONED,
        lambda i: (init, str(i), str(world), out, str(k)), world, tmp_path)
    seen = {}
    for o in outs:
        for m in re.finditer(r"^PRESULT (\d+) (\d+) (\d+)\s*$", o,
                             re.MULTILINE):
            seen[int(m.group(1))] = (int(m.group(2)), int(m.group(3)))
    assert set(seen) == set(range(world))
    assert len(set(seen.values())) == 1  # the ranks agree
    return np.load(out)


def test_two_process_partitioned_migration(tmp_path):
    """8 parts over 2 gloo ranks: bitwise the stacked step; within 1e-12
    of the JAX step and of the single-device walk."""
    from pumiumtally_tpu_torch.parallel.mesh_partition import (
        assemble_global_flux,
    )

    jm, pm = twin_meshes(torch.float64, nx=4)
    got = _ranked(tmp_path, 2)
    batch = _batch(pm)
    res, part = _stacked(pm, batch)
    _assert_bitwise(got, res)
    assert int(got["n_dropped"].sum()) == 0
    assert not (got["valid"] & ~got["done"]).any()
    g_flux = assemble_global_flux(part, got["flux"].reshape(
        8, part.max_local, 2, 2))
    elem, origin, dest, weight, group = batch
    n = len(elem)
    ref = trace_impl(
        jm, jnp.asarray(origin), jnp.asarray(dest), jnp.asarray(elem),
        jnp.ones(n, bool), jnp.asarray(weight), jnp.asarray(group),
        jnp.full(n, -1, jnp.int32), jnp.zeros(jm.ntet * 4),
        n_groups=2, initial=False, max_crossings=jm.ntet + 8,
        tolerance=1e-8)
    assert int(ref.n_segments) == int(got["n_segments"].sum())
    np.testing.assert_allclose(g_flux, np.asarray(ref.flux).reshape(
        -1, 2, 2), rtol=0, atol=1e-12)
    # The JAX partitioned step (8 virtual devices) on the same inputs.
    from jax.sharding import NamedSharding, PartitionSpec as JP

    jpart = jpartition(jm, 8, halo_layers=1)
    dm = jdevice_mesh(8)
    placed = jwp.distribute_particles(jpart, dm, elem, dict(
        origin=origin, dest=dest, weight=weight, group=group,
        material_id=np.full(n, -1, np.int32)))
    step = jwp.make_partitioned_step(dm, jpart, n_groups=2,
                                     max_crossings=jm.ntet + 8,
                                     tolerance=1e-8)
    jres = step(placed["origin"], placed["dest"], placed["elem"],
                jnp.zeros_like(placed["valid"]), placed["material_id"],
                placed["weight"], placed["group"], placed["particle_id"],
                placed["valid"], jax.device_put(
                    jnp.zeros((8, jpart.max_local * 4)),
                    NamedSharding(dm, JP("p"))))
    np.testing.assert_allclose(got["flux"], np.asarray(jres.flux), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got["position"], np.asarray(jres.position),
                               rtol=0, atol=1e-12)
    for k in ("elem", "done", "particle_id", "n_rounds", "n_segments"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jres, k)),
                                      err_msg=k)


def test_one_rank_group_is_the_stacked_step(tmp_path):
    """The collectives in a group of one rank leave the step's bits."""
    _, pm = twin_meshes(torch.float64, nx=4)
    got = _ranked(tmp_path, 1)
    res, _ = _stacked(pm, _batch(pm))
    _assert_bitwise(got, res)



def test_two_process_partitioned_xpoints(tmp_path):
    """record_xpoints=4 over 2 gloo ranks: bitwise the stacked step, the
    points and counts included."""
    _, pm = twin_meshes(torch.float64, nx=4)
    got = _ranked(tmp_path, 2, k=4)
    res, _ = _stacked(pm, _batch(pm), k=4)
    assert "xpoints" in got.files
    _assert_bitwise(got, res)
    assert int(got["n_xpoints"].sum()) > 0
    assert int(got["round_stats"][:, 1].sum()) > 0  # lanes migrated


@pytest.mark.parametrize("world", [2, 1])
def test_two_process_partitioned_megastep(tmp_path, world):
    """The partitioned megastep over ``world`` gloo ranks: bitwise the
    stacked megastep (slot state, slabs, readback with its physics
    sums)."""
    from pumiumtally_tpu_torch.parallel.particle_sharding import (
        make_device_mesh,
    )

    init = _init_method(tmp_path)
    out = str(tmp_path / "mega0.npz")
    outs = _run_workers(
        WORKER_MEGASTEP, lambda i: (init, str(i), str(world), out), world,
        tmp_path)
    seen = {m.group(2) for o in outs for m in re.finditer(
        r"^MRESULT (\d+) (\S+)\s*$", o, re.MULTILINE)}
    assert len(seen) == 1  # every rank has the same physics sums
    got = np.load(out)
    ns: dict = {}
    exec(MEGA_CASE, ns)
    want = ns["megastep_case"](make_device_mesh(8, "cpu"), 8, MEGA_N,
                               MEGA_K)
    assert set(got.files) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["readback"].shape[0] == 8
    assert int(want["valid"].sum()) == MEGA_N
    assert 0 < int(want["alive"].sum()) < MEGA_N  # the physics acted


# --------------------------------------------------------------------- #
# Per-function coverage in one process, the ranks patched.
# --------------------------------------------------------------------- #
class TestInitDistributed:
    def test_single_process_is_noop(self, monkeypatch):
        for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(v, raising=False)
        assert multihost.init_distributed(device="cpu") is False
        # world_size=1 is a no-op even with an address.
        assert multihost.init_distributed("tcp://127.0.0.1:1", 1, 0,
                                          device="cpu") is False
        # No address → no-op whatever the process count.
        assert multihost.init_distributed(None, 4, 0, device="cpu") is False

    def test_idempotent_after_init(self, monkeypatch):
        monkeypatch.setattr(multihost, "_initialized", True)

        def boom(*a, **kw):  # pragma: no cover - must not be reached
            raise AssertionError("re-initialized a live group")

        monkeypatch.setattr(multihost.dist, "init_process_group", boom)
        assert multihost.init_distributed("tcp://127.0.0.1:1", 2, 0,
                                          device="cpu") is True

    def test_env_var_contract(self, monkeypatch):
        calls = {}

        def fake_init(backend, init_method, world_size, rank, **kw):
            calls.update(backend=backend, init=init_method, n=world_size,
                         rank=rank)

        monkeypatch.setattr(multihost, "_initialized", False)
        monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
        monkeypatch.setattr(multihost.dist, "init_process_group", fake_init)
        monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "1234")
        monkeypatch.setenv("WORLD_SIZE", "4")
        monkeypatch.setenv("RANK", "3")
        assert multihost.init_distributed(device="cpu") is True
        assert calls == {"backend": "gloo", "init": "env://", "n": 4,
                         "rank": 3}

    def test_backend_follows_the_device_without_fallback(self, monkeypatch):
        """NCCL for a CUDA device, gloo for the CPU; a CUDA device on a
        box without one raises instead of taking gloo."""
        seen = []
        monkeypatch.setattr(multihost, "_initialized", False)
        monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
        monkeypatch.setattr(multihost.dist, "init_process_group",
                            lambda backend, **kw: seen.append(backend))
        assert multihost.init_distributed("file:///x", 2, 0, device="cpu")
        assert seen == ["gloo"]
        assert multihost._backend(torch.device("cuda", 0)) == "nccl"
        if not torch.cuda.is_available():
            monkeypatch.setattr(multihost, "_initialized", False)
            with pytest.raises(RuntimeError, match="cuda"):
                multihost.init_distributed("file:///x", 2, 0)
            assert seen == ["gloo"]


class TestHostLocalBatch:
    @pytest.mark.parametrize(
        "size,n", [(1, 7), (2, 64), (3, 64), (3, 2), (4, 0), (8, 101)])
    def test_split_covers_disjointly(self, monkeypatch, size, n):
        spans = []
        for rank in range(size):
            monkeypatch.setattr(multihost, "_rank_size",
                                lambda r=rank: (r, size))
            start, count = multihost.host_local_batch(n)
            assert count >= 0
            spans.append((start, count))
        pos = 0
        for start, count in spans:
            assert start == pos
            pos += count
        assert pos == n
        counts = [c for _, c in spans]
        assert max(counts) - min(counts) <= 1


class TestAllreduceFlux:
    def test_single_process_identity(self):
        flux = np.arange(24, dtype=np.float64).reshape(2, 6, 2)
        for in_program in (True, False):
            out = multihost.allreduce_flux(flux, in_program=in_program)
            np.testing.assert_array_equal(out, flux)
        out = multihost.allreduce_flux(torch.from_numpy(flux))
        np.testing.assert_array_equal(out, flux)

    def test_collective_failure_raises(self, monkeypatch):
        """No silent fallback: a failing all_reduce raises; the host
        gather runs only when asked for."""
        monkeypatch.setattr(multihost, "_rank_size", lambda: (0, 2))
        monkeypatch.setattr(multihost, "group_device",
                            lambda: torch.device("cpu"))

        def broken(t):
            raise RuntimeError("no collectives here")

        gathered = {}

        def fake_allgather(out, obj):
            gathered["called"] = True
            out[0], out[1] = obj, obj

        monkeypatch.setattr(multihost.dist, "all_reduce", broken)
        monkeypatch.setattr(multihost.dist, "all_gather_object",
                            fake_allgather)
        flux = np.ones((3, 1, 2))
        with pytest.raises(RuntimeError, match="no collectives"):
            multihost.allreduce_flux(flux, in_program=True)
        assert not gathered
        out = multihost.allreduce_flux(flux, in_program=False)
        assert gathered.get("called")
        np.testing.assert_array_equal(out, 2 * flux)


class TestWriteParallelVtk:
    def test_piece_and_index_match_jax(self, tmp_path, monkeypatch):
        """The piece and the rank-0 index, byte for byte the JAX
        function's (relative piece names)."""
        import pumiumtally_tpu as jpt
        from pumiumtally_tpu.parallel import multihost as jmh

        jm, pm = twin_meshes(torch.float64, nx=2)
        flux = np.random.default_rng(0).random((pm.ntet, 2, 2))
        monkeypatch.setattr(multihost, "_rank_size", lambda: (0, 3))
        piece = multihost.write_parallel_vtk(str(tmp_path / "out"), pm,
                                             flux)
        assert piece == str(tmp_path / "out_p0000.vtu")
        index = (tmp_path / "out.pvtu").read_text()
        for r in range(3):
            assert f"out_p{r:04d}.vtu" in index
        assert str(tmp_path) not in index
        monkeypatch.setattr(jax, "process_index", lambda: 0)
        monkeypatch.setattr(jax, "process_count", lambda: 3)
        jmh.write_parallel_vtk(str(tmp_path / "jax"), jm, flux)
        assert ((tmp_path / "out_p0000.vtu").read_bytes()
                == (tmp_path / "jax_p0000.vtu").read_bytes())
        assert index.replace("out_", "jax_") == (
            tmp_path / "jax.pvtu").read_text()
        del jpt

    def test_nonzero_rank_writes_no_index(self, tmp_path, monkeypatch):
        _, pm = twin_meshes(torch.float64, nx=2)
        flux = np.zeros((pm.ntet, 1, 2))
        monkeypatch.setattr(multihost, "_rank_size", lambda: (1, 2))
        multihost.write_parallel_vtk(str(tmp_path / "out"), pm, flux,
                                     elem_slice=slice(0, pm.ntet // 2))
        assert (tmp_path / "out_p0001.vtu").exists()
        assert not (tmp_path / "out.pvtu").exists()
        body = (tmp_path / "out_p0001.vtu").read_text()
        assert f'NumberOfCells="{pm.ntet // 2}"' in body


class TestShardsOverRanks:
    def test_reduce_flux_sums_the_ranks(self, monkeypatch):
        """particle_sharding.reduce_flux ends in one all_reduce when the
        mesh spans ranks (here two patched ranks)."""
        from pumiumtally_tpu_torch.parallel import particle_sharding as ps
        from pumiumtally_tpu_torch.parallel.ranks import MeshEntry, RankLayout

        mesh = [MeshEntry(0, torch.device("cpu")),
                MeshEntry(1, torch.device("cpu"))]
        monkeypatch.setattr(
            ps, "rank_layout",
            lambda dm: RankLayout(0, 1, torch.device("cpu"),
                                  ((0, 1), (1, 2)), 0))
        seen = []

        def all_reduce(t):
            seen.append(t.clone())
            t.mul_(2)

        monkeypatch.setattr(torch.distributed, "all_reduce", all_reduce)
        partial = torch.arange(12, dtype=torch.float64).view(1, 6, 2)
        out = ps.reduce_flux(partial, mesh)
        assert len(seen) == 1
        assert torch.equal(out, 2 * partial[0])
        assert ps.make_sharded_flux(mesh, 5, 2).shape == (1, 5, 2, 2)
