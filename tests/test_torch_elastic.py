"""Elastic chip-loss recovery of the port (``resilience/elastic.py``, the
runner's ``_recover_chip_loss``, the coordinator's mesh positions) on
``device="cpu"``.

Mirrors the chip-down cases of tests/test_elastic.py (:220-457; its
chaos-plan cases wait for ROADMAP.md A11): a ``chip_down_at_move`` in a
partitioned run rolls every part back and re-partitions onto the
survivors, and the finished run matches a fault-free run at the shrunk
part count (flux atol 1e-11, elements equal; float64, the JAX test's
bars) and the JAX package's recovered run (tests/torch_twins.py TOL); the
chip named by ``chip:C`` is the one dropped; the megastep path equals a
deliberate migration at the same boundary bit for bit; a same-layout
rollback replays bit for bit; ``elastic=False`` and the plain facade
flush the last good generation and re-raise; the recovery statistics
accumulate.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pumiumtally_tpu_torch import PartitionedTally, PumiTally, TallyConfig
from pumiumtally_tpu_torch.mesh.box import build_box_arrays
from pumiumtally_tpu_torch.mesh.core import TetMesh
from pumiumtally_tpu_torch.ops.source import SourceParams
from pumiumtally_tpu_torch.resilience.faultinject import (
    ChipLostError,
    FaultInjector,
    FaultPlan,
    parse_faults,
)
from pumiumtally_tpu_torch.resilience.runner import ResilientRunner
from torch_twins import TOL

N = 16
CFG = dict(n_groups=2, dtype=torch.float64, tolerance=1e-8)


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv("PUMI_TPU_FAULTS", raising=False)
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)


def _arrays():
    coords, t2v = build_box_arrays(1.0, 1.0, 1.0, 4, 4, 4)
    cen = coords[t2v].mean(axis=1)
    return coords, t2v, np.where(cen[:, 0] < 0.5, 1, 2).astype(np.int32)


@pytest.fixture(scope="module")
def mesh():
    coords, t2v, cls = _arrays()
    return TetMesh.from_numpy(coords, t2v, class_id=cls,
                              dtype=torch.float64, device="cpu")


def _inputs(i):
    rng = np.random.default_rng(100 + i)
    return (rng.uniform(0.05, 0.95, (N, 3)).ravel().copy(),
            np.ones(N, np.int8), rng.uniform(0.5, 2.0, N),
            rng.integers(0, 2, N).astype(np.int32),
            np.full(N, -1, np.int32))


def _pos():
    return np.random.default_rng(42).uniform(0.1, 0.9, (N, 3)).ravel()


def _tally(mesh, n_parts, **kw):
    return PartitionedTally(mesh, N, TallyConfig(**CFG, **kw),
                            n_parts=n_parts, device="cpu")


def _reference(mesh, n_parts, moves):
    t = _tally(mesh, n_parts)
    t.initialize_particle_location(_pos())
    for i in range(1, moves + 1):
        t.move_to_next_location(*_inputs(i))
    return t


def _runner(t, path, faults, **kw):
    kw.setdefault("every_moves", 100)
    return ResilientRunner(t, str(path), handle_signals=False,
                           sleep=lambda s: None,
                           faults=FaultInjector(faults), **kw)


def test_chip_down_elastic_recovery(mesh, tmp_path):
    """chip_down_at_move on 8 parts → rollback and re-partition onto the
    7 survivors; the finished run matches a fault-free 7-part run and
    the JAX package's recovered run."""
    ref = _reference(mesh, 7, 5)
    t = _tally(mesh, 8)
    run = _runner(t, tmp_path / "cks", parse_faults("chip_down_at_move:3"),
                  every_moves=2)
    run.initialize_particle_location(_pos())
    for i in range(1, 6):
        run.move_to_next_location(*_inputs(i))

    assert run.tally.n_parts == 7 and run.tally is not t
    assert run.recovery_stats["reshards"] == 1
    assert run.recovery_stats["lost_moves"] == 0
    np.testing.assert_allclose(run.raw_flux, ref.raw_flux, rtol=0,
                               atol=1e-11)
    np.testing.assert_array_equal(run.tally.elem_global, ref.elem_global)
    m = t.metrics
    assert m.counter("pumi_elastic_reshards_total").value() == 1
    assert m.counter("pumi_rollbacks_total").value(cause="chip-lost") == 1
    assert run.tally.metrics is m
    assert m.gauge("pumi_chip_health").value(chip="7") == 0.0
    assert m.gauge("pumi_chip_health").value(chip="0") == 1.0
    assert run.store.find_latest() is not None
    run.checkpoint()
    assert run.store.last_shards == 7
    run.close()

    # The JAX package's runner on the same run.
    import jax.numpy as jnp

    import pumiumtally_tpu as jpt
    from pumiumtally_tpu.mesh.core import TetMesh as JTetMesh
    from pumiumtally_tpu.parallel.partitioned_api import (
        PartitionedTally as JPartitionedTally,
    )
    from pumiumtally_tpu.resilience import FaultInjector as JFaults
    from pumiumtally_tpu.resilience import ResilientRunner as JRunner
    from pumiumtally_tpu.resilience import parse_faults as jparse

    coords, t2v, cls = _arrays()
    jm = JTetMesh.from_numpy(coords, t2v, class_id=cls, dtype=jnp.float64)
    jt = JPartitionedTally(jm, N, jpt.TallyConfig(
        n_groups=2, dtype=jnp.float64, tolerance=1e-8), n_parts=8)
    jrun = JRunner(jt, str(tmp_path / "jcks"), every_moves=2,
                   handle_signals=False, sleep=lambda s: None,
                   faults=JFaults(jparse("chip_down_at_move:3")))
    jrun.initialize_particle_location(_pos())
    for i in range(1, 6):
        jrun.move_to_next_location(*_inputs(i))
    assert jrun.tally.n_parts == 7
    pos_tol, rtol, atol = TOL[torch.float64]
    np.testing.assert_allclose(run.raw_flux, np.asarray(jrun.raw_flux),
                               rtol=rtol, atol=atol)
    np.testing.assert_array_equal(run.tally.elem_global,
                                  np.asarray(jrun.tally.elem_global))
    np.testing.assert_allclose(run.tally.positions,
                               np.asarray(jrun.tally.positions), rtol=0,
                               atol=pos_tol)
    assert run.recovery_stats["reshards"] == jrun.recovery_stats["reshards"]
    jrun.close()


def test_chip_down_names_the_chip(mesh, tmp_path):
    """``chip:C`` kills chip C (its health reads 0, the others 1); on the
    re-indexed 7-part mesh every survivor probes healthy."""
    t = _tally(mesh, 8)
    run = _runner(t, tmp_path / "cks",
                  parse_faults("chip_down_at_move:2,chip:3"))
    run.initialize_particle_location(_pos())
    for i in range(1, 3):
        run.move_to_next_location(*_inputs(i))
    g = t.metrics.gauge("pumi_chip_health")
    assert [g.value(chip=str(i)) for i in range(8)] == [
        1.0, 1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0]
    assert run.tally.n_parts == 7
    health = run.coordinator.probe_chips()
    assert all(health.values()) and len(health) == 7
    assert not run.coordinator.downed
    run.close()


def test_chip_down_megastep_path(mesh, tmp_path):
    """The device-sourced loop recovers through the same path, bitwise a
    deliberate migration at the same boundary (2 moves on 8 parts, a
    checkpoint restored on 7, 4 more moves)."""
    src = SourceParams(default_sigma_t=4.0, seed=11)
    a = _tally(mesh, 8, megastep=2)
    a.initialize_particle_location(_pos())
    a.run_source_moves(2, src, weights=np.ones(N))
    a.save_checkpoint(str(tmp_path / "mig.npz"))
    ref = _tally(mesh, 7, megastep=2)
    ref.restore_checkpoint(str(tmp_path / "mig.npz"))
    ref.run_source_moves(4, src)

    t = _tally(mesh, 8, megastep=2)
    with _runner(t, tmp_path / "faulty", parse_faults("chip_down_at_move:3"),
                 every_moves=2) as run:
        run.initialize_particle_location(_pos())
        run.run_source_moves(6, src, weights=np.ones(N))
        got, stats = run.tally, run.recovery_stats
    assert got.n_parts == 7 and stats["reshards"] == 1
    np.testing.assert_array_equal(got.raw_flux, ref.raw_flux)


def test_same_layout_rollback_stays_bitwise(mesh, tmp_path):
    ref = _reference(mesh, 8, 3)
    t = _tally(mesh, 8)
    run = _runner(t, tmp_path / "cks", FaultPlan(transient_at_move=2))
    run.initialize_particle_location(_pos())
    for i in range(1, 4):
        run.move_to_next_location(*_inputs(i))
    assert t.n_parts == 8 and run.tally is t
    assert run.recovery_stats["rollbacks"] == 1
    assert run.recovery_stats["reshards"] == 0
    np.testing.assert_array_equal(t.raw_flux, ref.raw_flux)
    assert t.metrics.counter("pumi_rollbacks_total").value(
        cause="transient") == 1


def test_chip_loss_mis_attributed_rolls_back_in_place(mesh, tmp_path,
                                                       monkeypatch):
    """A chip-lost verdict whose probe finds every chip alive (a
    mis-attributed loss) rolls back in the same layout; the replay is
    bitwise."""
    ref = _reference(mesh, 8, 3)
    t = _tally(mesh, 8)
    run = _runner(t, tmp_path / "cks", parse_faults("chip_down_at_move:2"))
    monkeypatch.setattr(run.coordinator, "note_down", lambda chip: None)
    run.initialize_particle_location(_pos())
    for i in range(1, 4):
        run.move_to_next_location(*_inputs(i))
    assert run.tally is t and run.recovery_stats["reshards"] == 0
    np.testing.assert_array_equal(t.raw_flux, ref.raw_flux)


def test_chip_loss_without_elastic_flushes_and_raises(mesh, tmp_path):
    t = _tally(mesh, 8)
    run = _runner(t, tmp_path / "cks", parse_faults("chip_down_at_move:2"),
                  elastic=False)
    run.initialize_particle_location(_pos())
    run.move_to_next_location(*_inputs(1))
    with pytest.raises(ChipLostError):
        run.move_to_next_location(*_inputs(2))
    assert run.store.find_latest()[0] == 1
    assert t.metrics.counter("pumi_rollbacks_total").value(
        cause="chip-lost") == 1


def test_chip_loss_one_part_flushes_and_raises(mesh, tmp_path):
    """A one-part tally has nothing to shrink onto."""
    t = _tally(mesh, 1)
    run = _runner(t, tmp_path / "cks", parse_faults("chip_down_at_move:1"))
    run.initialize_particle_location(_pos())
    with pytest.raises(ChipLostError):
        run.move_to_next_location(*_inputs(1))
    assert run.store.find_latest()[0] == 0


def test_chip_loss_plain_facade_degrades_gracefully(tmp_path):
    from pumiumtally_tpu_torch import build_box

    t = PumiTally(build_box(1.0, 1.0, 1.0, 3, 3, 3, device="cpu"), N,
                  TallyConfig(tolerance=1e-6), device="cpu")
    rng = np.random.default_rng(42)
    run = _runner(t, tmp_path / "cks", parse_faults("chip_down_at_move:1"))
    run.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    dest = rng.uniform(0.05, 0.95, (N, 3)).ravel()
    with pytest.raises(ChipLostError):
        run.move_to_next_location(
            dest, np.ones(N, np.int8), np.ones(N), np.zeros(N, np.int32),
            np.full(N, -1, np.int32))
    assert run.store.find_latest()[0] == 0


def test_recovery_stats_surface(mesh, tmp_path):
    t = _tally(mesh, 8)
    run = _runner(t, tmp_path / "cks", FaultPlan(transient_at_move=2))
    run.initialize_particle_location(_pos())
    for i in (1, 2):
        run.move_to_next_location(*_inputs(i))
    st = run.recovery_stats
    assert st["rollbacks"] == 1 and st["reshards"] == 0
    assert st["recovery_seconds"] > 0.0
    assert st["lost_moves"] == 0
    # And across a reshard.
    t2 = _tally(mesh, 4)
    run2 = _runner(t2, tmp_path / "cks2",
                   parse_faults("chip_down_at_move:2"))
    run2.initialize_particle_location(_pos())
    for i in (1, 2, 3):
        run2.move_to_next_location(*_inputs(i))
    st2 = run2.recovery_stats
    assert st2["reshards"] == 1 and st2["rollbacks"] == 1
    assert st2["recovery_seconds"] > 0.0 and st2["lost_moves"] == 0
    assert run2.tally.n_parts == 3 and run2.tally.iter_count == 3
