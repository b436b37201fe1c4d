"""The port's PartitionedTally against the JAX PartitionedTally and the
port's PumiTally, on the CPU.

Mirrors tests/test_partitioned_api.py's matches-PumiTally, VTK and
batch-sd cases (its checkpoint case is in
tests/test_torch_partitioned_checkpoint.py, its recorded-points case in
tests/test_torch_partitioned_xpoints.py), and runs every run feature and
debug surface the JAX facade accepts. The JAX facade runs
three times,
as module fixtures (float64, 8 parts, halo 1, packed; float32, 4 parts,
halo 0, legacy; float64, 2 parts, halo 2, overlap), so every part
count, halo depth, dtype and ``io_pipeline`` mode meets the JAX facade;
a grid of them is also held to the port's PumiTally.

Tolerances: float64 positions atol 1e-12 and flux atol 1e-11 (the JAX
test's own); float32 positions 1e-5, flux rtol 1e-4 with an absolute
allowance of 1e-5 (tests/torch_twins.py ``TOL``: the partitioned walk
takes a segment as |x1 - x0|, the single-device walk as t·|d|, and XLA
contracts multiply-adds). Material ids, flying resets and segment counts
equal; the three ``io_pipeline`` modes give the same bits.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.parallel.partitioned_api import (
    PartitionedTally as JPartitionedTally,
)
from pumiumtally_tpu_torch import PartitionedTally, PumiTally, TallyConfig

from torch_twins import JDT, TOL, twin_meshes

N = 256


@pytest.fixture(scope="module")
def meshes():
    return {dt: twin_meshes(dt, nx=5, classes=(1, 2))
            for dt in (torch.float64, torch.float32)}


def _drive(t, moves=2, seed=17):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.05, 0.95, (N, 3))
    t.initialize_particle_location(pos.ravel().copy(), N * 3)
    outs, prev = [], pos
    for _ in range(moves):
        dest = np.clip(prev + rng.normal(0, 0.25, (N, 3)),
                       [-0.1, -0.2, -0.3], [1.1, 1.2, 1.3])
        buf = dest.ravel().copy()
        flying = np.ones(N, np.int8)
        flying[::7] = 0  # parked lanes neither move nor score
        w = rng.uniform(0.5, 2.0, N)
        g = rng.integers(0, 2, N).astype(np.int32)
        mats = np.full(N, 9, np.int32)
        t.move_to_next_location(buf, flying, w, g, mats, buf.size)
        assert (flying == 0).all()
        outs.append((buf.reshape(N, 3).copy(), mats.copy()))
        prev = buf.reshape(N, 3).copy()
    return outs


def _cfg(dtype, **kw):
    return dict(n_groups=2, dtype=dtype, tolerance=1e-8, **kw)


def _assert_same_run(outs_a, outs_b, flux_a, flux_b, dtype):
    pos_tol, rtol, atol = TOL[dtype]
    if dtype == torch.float64:
        rtol, atol = 0.0, 1e-11
    for (pa, ma), (pb, mb) in zip(outs_a, outs_b):
        np.testing.assert_allclose(pa, pb, atol=pos_tol)
        np.testing.assert_array_equal(ma, mb)
    np.testing.assert_allclose(flux_a, flux_b, rtol=rtol, atol=atol)


@pytest.fixture(scope="module",
                params=[(torch.float64, 8, 1, "packed"),
                        (torch.float32, 4, 0, "legacy"),
                        (torch.float64, 2, 2, "overlap")],
                ids=["f64-8parts-halo1-packed", "f32-4parts-halo0-legacy",
                     "f64-2parts-halo2-overlap"])
def jax_run(request, meshes):
    dtype, n_parts, halo, io = request.param
    jm, pm = meshes[dtype]
    jt = JPartitionedTally(
        jm, N, jpt.TallyConfig(**_cfg(JDT[dtype], io_pipeline=io)),
        n_parts=n_parts, halo_layers=halo)
    outs = _drive(jt)
    pt = PartitionedTally(pm, N, TallyConfig(**_cfg(dtype, io_pipeline=io)),
                          n_parts=n_parts, halo_layers=halo, device="cpu")
    return jt, outs, pt, _drive(pt), dtype


def test_partitioned_tally_matches_jax(jax_run):
    jt, outs_j, pt, outs_p, dtype = jax_run
    _assert_same_run(outs_p, outs_j, pt.raw_flux, np.asarray(jt.raw_flux),
                     dtype)
    assert pt.total_segments == jt.total_segments
    assert pt.iter_count == jt.iter_count == 2
    # The partitions are the same, so the migration rounds are too.
    assert pt.total_rounds == jt.total_rounds
    snap_p, snap_j = pt.telemetry(), jt.telemetry()
    assert set(snap_p) == set(snap_j)
    for key in ("segments", "crossings", "moves", "migration_rounds"):
        assert snap_p["totals"][key] == snap_j["totals"][key], key


@pytest.mark.parametrize("n_parts,halo,dtype,io", [
    (2, 0, torch.float64, "packed"),
    (4, 1, torch.float64, "legacy"),
    (8, 2, torch.float64, "overlap"),
    (4, 1, torch.float32, "packed"),
    (8, 0, torch.float32, "overlap"),
    (2, 2, torch.float32, "legacy"),
])
def test_partitioned_tally_matches_pumitally(meshes, n_parts, halo, dtype,
                                             io):
    _, pm = meshes[dtype]
    cfg = TallyConfig(**_cfg(dtype, io_pipeline=io))
    single = PumiTally(pm, N, cfg, device="cpu")
    parted = PartitionedTally(pm, N, cfg, n_parts=n_parts, halo_layers=halo,
                              device="cpu")
    outs_s, outs_p = _drive(single), _drive(parted)
    _assert_same_run(outs_p, outs_s, parted.raw_flux, single.raw_flux,
                     dtype)
    assert parted.total_segments == single.total_segments
    if dtype == torch.float64:
        np.testing.assert_allclose(parted.normalized_flux(),
                                   single.normalized_flux(), atol=1e-11)
        sigma = np.array([[0.0, 0.0], [1.0, 2.0], [0.5, 0.25]])
        np.testing.assert_allclose(parted.reaction_rate(sigma),
                                   single.reaction_rate(sigma), atol=1e-11)
    snap = parted.telemetry()
    assert snap["totals"]["migration_rounds"] == parted.total_rounds >= 1
    assert snap["convergence"] == {"enabled": False}


def test_io_pipeline_modes_give_the_same_bits(meshes):
    _, pm = meshes[torch.float32]
    runs = []
    for io in ("legacy", "packed", "overlap"):
        t = PartitionedTally(pm, N, TallyConfig(**_cfg(torch.float32,
                                                       io_pipeline=io)),
                             n_parts=4, halo_layers=1, device="cpu")
        runs.append((_drive(t), t.raw_flux, t.telemetry()["totals"]))
    (outs0, flux0, tot0), *rest = runs
    for outs, flux, tot in rest:
        for (a, b), (c, d) in zip(outs0, outs):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
        np.testing.assert_array_equal(flux0, flux)
    # Packed and overlap stage one record each way a call.
    assert runs[1][2]["h2d_transfers"] == runs[1][2]["d2h_transfers"] == 3
    assert tot0["h2d_transfers"] > 3


def test_partitioned_tally_writes_vtk(meshes, tmp_path):
    _, pm = meshes[torch.float64]
    t = PartitionedTally(pm, 64, TallyConfig(n_groups=1,
                                             dtype=torch.float64),
                         n_parts=8, device="cpu")
    rng = np.random.default_rng(1)
    pos = rng.uniform(0.1, 0.9, (64, 3))
    t.initialize_particle_location(pos.ravel().copy())
    buf = np.clip(pos + 0.2, 0.0, 1.0).ravel().copy()
    t.move_to_next_location(buf, np.ones(64, np.int8), np.ones(64),
                            np.zeros(64, np.int32), np.zeros(64, np.int32))
    t.write_pumi_tally_mesh(str(tmp_path / "part_flux.vtu"))
    body = (tmp_path / "part_flux.vtu").read_text()
    assert "flux_group_0" in body and "volume" in body
    assert t.total_rounds >= 1 and t.iter_count == 1
    with pytest.raises(ValueError, match="group"):
        t.move_to_next_location(buf, np.ones(64, np.int8), np.ones(64),
                                np.full(64, 5, np.int32),
                                np.zeros(64, np.int32))


def test_partitioned_batch_sd_matches_pumitally(meshes):
    _, pm = meshes[torch.float64]
    cfg = TallyConfig(**_cfg(torch.float64, sd_mode="batch"))
    single = PumiTally(pm, N, cfg, device="cpu")
    parted = PartitionedTally(pm, N, cfg, n_parts=8, halo_layers=1,
                              device="cpu")
    _drive(single, moves=3)
    _drive(parted, moves=3)
    np.testing.assert_allclose(parted.raw_flux, single.raw_flux, rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(parted.normalized_flux(),
                               single.normalized_flux(), atol=1e-11)
    seg = PartitionedTally(pm, N, TallyConfig(**_cfg(torch.float64)),
                           n_parts=8, halo_layers=1, device="cpu")
    _drive(seg, moves=3)
    np.testing.assert_array_equal(seg.raw_flux[..., 0],
                                  parted.raw_flux[..., 0])
    assert not np.array_equal(seg.raw_flux[..., 1], parted.raw_flux[..., 1])
    with pytest.raises(NotImplementedError):
        parted.reaction_rate(np.ones((3, 2)))
    with pytest.raises(ValueError, match="convergence"):
        parted.end_batch()


@pytest.mark.parametrize("field,value", [
    ("integrity", "warn"),
    ("audit_lanes", 8),
    ("move_deadline_s", 30.0),
    ("quarantine", True),
    ("convergence", True),
    ("record_xpoints", 4),
    ("checkify_invariants", True),
    ("sort_by_element", True),
])
def test_unported_features_refused_naming_a9b(meshes, field, value):
    """The run features and the debug surfaces the JAX facade carries
    are accepted and run (none is refused now that the debug surfaces,
    ROADMAP.md A9d, are ported)."""
    _, pm = meshes[torch.float64]
    cfg = TallyConfig(**_cfg(torch.float64, **{field: value}))
    t = PartitionedTally(pm, N, cfg, n_parts=2, device="cpu")
    _drive(t, moves=1)
    assert np.isfinite(t.raw_flux).all()
    if field == "record_xpoints":
        assert t.intersection_points()[1].max() > 0


def test_unported_calls_refused_naming_a9b(meshes, tmp_path):
    """Checkpoints and the device-sourced loop run; without
    record_xpoints the recorded points raise, as in JAX."""
    _, pm = meshes[torch.float64]
    t = PartitionedTally(pm, N, TallyConfig(**_cfg(torch.float64)),
                         n_parts=2, device="cpu")
    _drive(t, moves=1)
    t.save_checkpoint(str(tmp_path / "c.npz"))
    t.restore_checkpoint(str(tmp_path / "c.npz"))
    assert t.run_source_moves(2)["moves"] == 2
    with pytest.raises(ValueError, match="record_xpoints"):
        t.intersection_points()


def test_truncation_retries_refused_when_a_lane_truncates(meshes):
    """Lanes that run past max_crossings: with re-walks asked for the
    port re-walks them (the truncated count and the re-walks reach the
    telemetry); without, it warns as the JAX facade does."""
    _, pm = meshes[torch.float64]
    src = np.random.default_rng(3).uniform(0.05, 0.95, (N, 3))
    t = PartitionedTally(
        pm, N, TallyConfig(**_cfg(torch.float64, max_crossings=2,
                                  truncation_retries=2)),
        n_parts=2, device="cpu")
    with pytest.warns(RuntimeWarning, match="truncated"):
        t.initialize_particle_location(src.ravel().copy())
    assert t.telemetry()["totals"]["rewalked"] > 0
    t = PartitionedTally(
        pm, N, TallyConfig(**_cfg(torch.float64, max_crossings=2,
                                  truncation_retries=0)),
        n_parts=2, device="cpu")
    with pytest.warns(RuntimeWarning, match="truncated"):
        t.initialize_particle_location(src.ravel().copy())


@pytest.mark.parametrize("kw,exc", [
    (dict(cap=N - 1), ValueError),
    (dict(compact_stages="adaptive"), NotImplementedError),
    (dict(kernel="pallas"), ValueError),
])
def test_refusals_like_jax(meshes, kw, exc):
    """Where the JAX facade refuses a combination itself, the port
    refuses it with the same exception and message."""
    jm, pm = meshes[torch.float64]
    cap = kw.pop("cap", None)
    msgs = []
    for cls, mesh, cfg in (
            (JPartitionedTally, jm, jpt.TallyConfig(**_cfg(jnp.float64,
                                                           **kw))),
            (PartitionedTally, pm, TallyConfig(**_cfg(torch.float64,
                                                      **kw)))):
        extra = {} if cls is JPartitionedTally else {"device": "cpu"}
        with pytest.raises(exc) as info:
            cls(mesh, N, cfg, n_parts=2, cap=cap, **extra)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_mesh_dtype_must_match(meshes):
    _, pm = meshes[torch.float64]
    with pytest.raises(ValueError, match="dtype"):
        PartitionedTally(pm, N, TallyConfig(dtype=torch.float32),
                         n_parts=2, device="cpu")
