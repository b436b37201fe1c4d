"""The port's partitioned device-sourced move loop
(``PartitionedTally.run_source_moves``,
``ops/walk_partitioned.py::make_partitioned_megastep``) on
``device="cpu"``.

Mirrors the partitioned cases of tests/test_megastep.py: megastep-K bit
for bit K megastep-1 with the transfers of a steady chunk, a checkpoint
restored mid-run continuing bit for bit, and a re-stage of some lanes
continuing from the device state. The port's chunk makes no host→device
copy (the move counter is a kernel argument; the JAX facade copies it)
and one device→host copy, the tail, as PR 11 counted the single-device
megastep.

Against the JAX package (float64 and float32, 4 parts, halo 1, the
jittered two-region 4^3 box of tests/test_megastep.py): the port's
megastep body fed the JAX draws reproduces each JAX fused move slot by
slot (particle ids, validity, elements, materials, alive flags and groups
equal; positions and weights within 1e-12 in float64, 1e-5 in float32;
flux within 1e-10 relative per bin in float64, the sliver allowance of
tests/test_torch_megastep.py in float32; counters equal), and the whole
``run_source_moves`` with the port's own draws agrees the same way.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.ops import source as jsource
from pumiumtally_tpu.parallel.partitioned_api import (
    PartitionedTally as JPartitionedTally,
)
from pumiumtally_tpu_torch import PartitionedTally, TallyConfig
from pumiumtally_tpu_torch.ops import source, staging
from pumiumtally_tpu_torch.ops.walk_partitioned import (
    make_partitioned_megastep,
)
from torch_twins import JDT, TOL, twin_meshes

N = 64
MOVES = 3
SRC_KW = dict(sigma_t={1: 4.0, 2: 9.0}, absorption={1: 0.3, 2: 0.5},
              survival_weight=0.2, seed=13)
SRC = source.SourceParams(**SRC_KW)
PHYS = ("collisions", "escaped", "rouletted", "alive", "truncated")
MIRRORS = ("positions", "elem_global", "material_id", "weights", "groups",
           "alive")


@pytest.fixture(scope="module")
def meshes():
    return {dt: twin_meshes(dt, nx=4, jitter=0.2, seed=11, classes=(1, 2))
            for dt in (torch.float32, torch.float64)}


def _pos(seed=3):
    return np.random.default_rng(seed).uniform(0.1, 0.9, (N, 3))


def _tally(pmesh, dtype=torch.float64, n_parts=4, halo=1, **kw):
    kw.setdefault("tolerance", 1e-8)
    t = PartitionedTally(pmesh, N, TallyConfig(n_groups=2, dtype=dtype,
                                               **kw),
                         n_parts=n_parts, halo_layers=halo, device="cpu")
    t.initialize_particle_location(_pos().ravel().copy())
    return t


def _assert_out_equal(oa, ob):
    for f in ("moves", "segments") + PHYS:
        assert oa[f] == ob[f], f
    assert np.isclose(oa["absorbed_weight"], ob["absorbed_weight"],
                      rtol=1e-5)


def _assert_mirrors_equal(a, b):
    a._sync_source_state()
    b._sync_source_state()
    for name in MIRRORS:
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=name)


# --------------------------------------------------------------------- #
# The port against itself
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("io", ["packed", "legacy"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_partitioned_megastep_bitwise_and_transfers(meshes, dtype, io):
    pmesh = meshes[dtype][1]
    w0, g0 = np.ones(N), np.zeros(N, np.int32)

    def run(k):
        t = _tally(pmesh, dtype, megastep=k, io_pipeline=io)
        return t, t.run_source_moves(MOVES, SRC, weights=w0, groups=g0)

    a, oa = run(1)
    b, ob = run(3)
    _assert_out_equal(oa, ob)
    np.testing.assert_array_equal(b.raw_flux, a.raw_flux)
    _assert_mirrors_equal(a, b)
    assert a.total_segments == b.total_segments
    assert a.total_rounds == b.total_rounds >= 1
    assert a.iter_count == b.iter_count == MOVES
    # A steady chunk: no host→device copy, one device→host copy (the
    # tail), three moves.
    tot0 = b.telemetry()["totals"]
    b.run_source_moves(3, SRC)
    tot1 = b.telemetry()["totals"]
    assert tot1["h2d_transfers"] - tot0["h2d_transfers"] == 0
    assert tot1["d2h_transfers"] - tot0["d2h_transfers"] == 1
    assert tot1["moves"] - tot0["moves"] == 3
    rec = [r for r in b.telemetry()["per_move"] if r["kind"] == "megastep"]
    assert rec[-1]["moves"] == 3 and rec[-1]["rounds"] >= 0


def test_partitioned_megastep_checkpoint_restore(meshes, tmp_path):
    pmesh = meshes[torch.float64][1]
    a = _tally(pmesh, megastep=2)
    a.run_source_moves(2, SRC, weights=np.ones(N))
    ck = str(tmp_path / "mega_part.npz")
    a.save_checkpoint(ck)
    a.run_source_moves(2, SRC)
    b = PartitionedTally(pmesh, N, TallyConfig(n_groups=2,
                                               dtype=torch.float64,
                                               tolerance=1e-8, megastep=2),
                         n_parts=4, halo_layers=1, device="cpu")
    b.restore_checkpoint(ck)
    assert b._src is not None  # the same layout restores the slots
    b.run_source_moves(2, SRC)
    np.testing.assert_array_equal(b.raw_flux, a.raw_flux)
    _assert_mirrors_equal(a, b)


def test_partitioned_restage_continues_from_device_state(meshes):
    """Re-staging some physics lanes mid-run must not rewind the rest:
    positions and elements (and every lane not given) continue from the
    device state, not from the stale host mirrors."""
    pmesh = meshes[torch.float64][1]
    w1 = np.random.default_rng(9).uniform(0.5, 2.0, N)
    a = _tally(pmesh, megastep=2)
    pos0 = a.positions.copy()
    a.run_source_moves(2, SRC)
    a.run_source_moves(2, SRC, weights=w1)
    b = _tally(pmesh, megastep=2)
    b.run_source_moves(2, SRC)
    b._sync_source_state()
    b.run_source_moves(2, SRC, weights=w1)
    a._sync_source_state()
    assert not np.array_equal(a.positions, pos0)
    np.testing.assert_array_equal(a.raw_flux, b.raw_flux)
    _assert_mirrors_equal(a, b)


def test_per_move_call_folds_the_slot_state_back(meshes):
    """A per-move call after device-sourced moves starts from the device
    state: the same move on a tally synced by hand gives the same bits."""
    pmesh = meshes[torch.float64][1]
    dest = np.random.default_rng(4).uniform(0.1, 0.9, (N, 3)).ravel()
    outs = []
    for sync in (False, True):
        t = _tally(pmesh, megastep=2)
        t.run_source_moves(2, SRC)
        if sync:
            t._sync_source_state()
        buf = dest.copy()
        t.move_to_next_location(buf, np.ones(N, np.int8), np.ones(N),
                                np.zeros(N, np.int32), np.zeros(N, np.int32))
        assert t._src is None
        outs.append((buf, t.raw_flux))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_early_stop_and_refusals(meshes):
    pmesh = meshes[torch.float64][1]
    t = _tally(pmesh, megastep=4)
    out = t.run_source_moves(40, SRC, alive=np.zeros(N, bool))
    assert out["moves"] == 4 and out["alive"] == 0 and out["segments"] == 0
    fresh = PartitionedTally(pmesh, N, TallyConfig(n_groups=2,
                                                   dtype=torch.float64),
                             n_parts=2, device="cpu")
    with pytest.raises(RuntimeError, match="initialize"):
        fresh.run_source_moves(1, SRC)
    with pytest.raises(ValueError, match="group"):
        t.run_source_moves(1, SRC, groups=np.full(N, 7, np.int32))


# --------------------------------------------------------------------- #
# Against the JAX package
# --------------------------------------------------------------------- #
def _jax_slots(jt):
    return {k: np.array(v) for k, v in jt._src.items()}


@pytest.fixture(scope="module")
def jax_runs(meshes):
    """Per dtype: the JAX facade's slot state and flux before and after
    each of MOVES single-move ``run_source_moves`` calls (megastep=1),
    and its counters."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        jmesh = meshes[dtype][0]
        jt = JPartitionedTally(jmesh, N, jpt.TallyConfig(
            n_groups=2, dtype=JDT[dtype], tolerance=1e-6, megastep=1),
            n_parts=4, halo_layers=1)
        jt.initialize_particle_location(_pos().ravel().copy())
        w0 = np.random.default_rng(5).uniform(0.5, 2.0, N)
        g0 = np.random.default_rng(6).integers(0, 2, N).astype(np.int32)
        jsrc = jsource.SourceParams(**SRC_KW)
        states, outs = [], []
        for m in range(MOVES):
            kw = dict(weights=w0, groups=g0) if m == 0 else {}
            if m == 0:
                jt._ensure_source_state(w0, g0, None)
            states.append(dict(_jax_slots(jt),
                               flux=np.array(jt.flux_slabs)))
            outs.append(jt.run_source_moves(1, jsrc, **kw))
        states.append(dict(_jax_slots(jt), flux=np.array(jt.flux_slabs)))
        jt._sync_source_state()
        mirrors = {f: np.array(getattr(jt, f)) for f in MIRRORS}
        out[dtype] = dict(states=states, outs=outs, w0=w0, g0=g0,
                          mirrors=mirrors, flux=np.array(jt.raw_flux),
                          rounds=jt.total_rounds)
    return out


def _flux_atol(dtype, weight):
    pos_tol, _, atol = TOL[dtype]
    return atol if dtype == torch.float64 else pos_tol * float(weight.max())


def _assert_slots_close(got, want, dtype, label):
    pos_tol, rtol, _ = TOL[dtype]
    for f in ("pid", "valid", "elem", "material_id", "alive", "group"):
        np.testing.assert_array_equal(got[f], want[f],
                                      err_msg=f"{label} {f}")
    for f in ("pos", "weight"):
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=pos_tol,
                                   err_msg=f"{label} {f}")
    np.testing.assert_allclose(
        got["flux"], want["flux"], rtol=rtol,
        atol=_flux_atol(dtype, want["weight"]), err_msg=f"{label} flux")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_megastep_body_fed_jax_draws_matches_jax(meshes, jax_runs, dtype):
    """Each JAX fused move, replayed from the JAX slot state before it
    through the port's partitioned megastep with the JAX draws fed in."""
    run = jax_runs[dtype]
    pmesh = meshes[dtype][1]
    t = _tally(pmesh, dtype, tolerance=1e-6)
    sig, ab = SRC.tables(pmesh.class_id.numpy())
    l2g = np.clip(t.partition.local2global, 0, pmesh.ntet - 1)
    cls_local = np.clip(pmesh.class_id.numpy()[l2g], 0, sig.shape[0] - 1)
    mega = make_partitioned_megastep(
        t.device_mesh, t.partition, n_moves=1, n_total=N, n_groups=2,
        class_local=cls_local, sigma_t=sig, absorb_t=ab,
        eps_near=source.near_epsilon(pmesh.coords),
        survival_weight=SRC.survival_weight, downscatter=SRC.downscatter,
        dtype=dtype, max_crossings=pmesh.ntet + 64, tolerance=1e-6)
    for m in range(MOVES):
        before, after = run["states"][m], run["states"][m + 1]
        s = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in before.items()}
        d = jsource.sample_move(jax.random.PRNGKey(SRC.seed), m,
                                jnp.asarray(before["pid"]), N, JDT[dtype])
        draws = [tuple(torch.from_numpy(np.array(a)) for a in d)]
        flux = s["flux"].clone()
        r = mega(s["pos"], s["elem"], s["material_id"], s["weight"],
                 s["group"], s["pid"], s["valid"], s["alive"], flux, m,
                 source.prng_key(SRC.seed), draws=draws)
        got = dict(pos=r.position.numpy(), elem=r.elem.numpy(),
                   material_id=r.material_id.numpy(),
                   weight=r.weight.numpy(), group=r.group.numpy(),
                   pid=r.particle_id.numpy(), valid=r.valid.numpy(),
                   alive=r.alive.numpy(), flux=r.flux.numpy())
        _assert_slots_close(got, after, dtype, f"move {m}")
        tail = staging.split_partitioned_megastep_tail(
            r.readback, dtype, integrity=False, convergence=False)
        p = source.phys_to_dict(tail["phys"])
        want = run["outs"][m]
        for f in PHYS:
            assert p[f] == want[f], (m, f)
        assert int(tail["n_segments"].sum()) == want["segments"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_run_source_moves_matches_jax(meshes, jax_runs, dtype):
    """The port's whole run with its own draws (uniforms bitwise,
    directions and lengths within ulps of JAX's) against the JAX run."""
    run = jax_runs[dtype]
    t = _tally(meshes[dtype][1], dtype, tolerance=1e-6, megastep=3)
    out = t.run_source_moves(MOVES, SRC, weights=run["w0"],
                             groups=run["g0"])
    got = dict(_jax_like(t), flux=t.flux_slabs.numpy())
    _assert_slots_close(got, run["states"][-1], dtype, "run")
    for f in PHYS:
        want = (run["outs"][-1][f] if f == "alive"
                else sum(o[f] for o in run["outs"]))
        assert out[f] == want, f
    assert out["segments"] == sum(o["segments"] for o in run["outs"])
    assert t.total_rounds == run["rounds"]
    t._sync_source_state()
    pos_tol, rtol, _ = TOL[dtype]
    for f in MIRRORS:
        if f in ("positions", "weights"):
            np.testing.assert_allclose(getattr(t, f), run["mirrors"][f],
                                       rtol=0, atol=pos_tol, err_msg=f)
        else:
            np.testing.assert_array_equal(getattr(t, f), run["mirrors"][f],
                                          err_msg=f)
    np.testing.assert_allclose(
        t.raw_flux, run["flux"], rtol=rtol,
        atol=_flux_atol(dtype, run["w0"]))


def _jax_like(t):
    return {k: v.numpy() for k, v in t._src.items()}


def test_megastep_batch_sd_and_truncation_match_jax(meshes):
    """sd_mode="batch" folds the squared bin totals once a fused move, and
    lanes left unfinished (by max_crossings, or frozen at a cut with
    max_rounds=0) stay alive and continue next move, counted and warned:
    K = 2 bitwise K = 1, and the counters, the state and both flux
    columns agree with the JAX facade's. Both packages run with
    ``unroll=1``: the JAX walk checks max_crossings once per unrolled
    block (tests/test_torch_truncation.py). With migration rounds, a lane
    that runs out of crossings in a later walk phase is where the two
    steps part: the JAX step's compacted follow-up rounds give it
    max_crossings a round (ROADMAP.md queue C)."""
    import warnings

    jmesh, pmesh = meshes[torch.float64]
    cfg = dict(n_groups=2, sd_mode="batch", max_crossings=5,
               tolerance=1e-6, unroll=1)
    pos = _pos().ravel()
    outs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for k in (1, 2):
            t = PartitionedTally(pmesh, N, TallyConfig(
                dtype=torch.float64, megastep=k, **cfg), n_parts=4,
                halo_layers=1, max_rounds=0, device="cpu")
            t.initialize_particle_location(pos.copy())
            outs[k] = (t, t.run_source_moves(4, SRC, weights=np.ones(N)))
        jt = JPartitionedTally(jmesh, N, jpt.TallyConfig(
            dtype=jnp.float64, megastep=2, **cfg), n_parts=4, halo_layers=1,
            max_rounds=0)
        jt.initialize_particle_location(pos.copy())
        jout = jt.run_source_moves(4, jsource.SourceParams(**SRC_KW),
                                   weights=np.ones(N))
    (a, oa), (b, ob) = outs[1], outs[2]
    _assert_out_equal(oa, ob)
    np.testing.assert_array_equal(a.raw_flux, b.raw_flux)
    _assert_mirrors_equal(a, b)
    assert ob["truncated"] > 0
    for f in ("moves", "segments") + PHYS:
        assert ob[f] == jout[f], f
    pos_tol, rtol, atol = TOL[torch.float64]
    jt._sync_source_state()
    np.testing.assert_allclose(b.positions, np.asarray(jt.positions),
                               rtol=0, atol=pos_tol)
    for f in ("elem_global", "material_id", "groups", "alive"):
        np.testing.assert_array_equal(getattr(b, f),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    np.testing.assert_allclose(b.raw_flux, np.asarray(jt.raw_flux),
                               rtol=rtol, atol=atol)
    with pytest.warns(RuntimeWarning, match="truncated"):
        b.run_source_moves(1, SRC)
