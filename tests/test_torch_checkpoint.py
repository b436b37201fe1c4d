"""Checkpoint and resume on the port (``utils/checkpoint.py``,
``PumiTally.save_checkpoint`` / ``restore_checkpoint``) on
``device="cpu"``.

Mirrors test_checkpoint's four cases: a run saved, restored into a fresh
tally and continued is bitwise the uninterrupted run; the compaction
knobs (``compact_stages="adaptive"``, whose replan state the JAX
checkpoint carries) leave the round trip bitwise (the port's walk has no
compaction); a different mesh and a different run shape are refused.

Across the packages, in both directions: a JAX checkpoint restores in the
port and a port checkpoint in the JAX package, the restored state is the
saved state bit for bit, and the resumed fluxes agree with the other
package's uninterrupted run within the walk tolerance (``TOL`` of
tests/torch_twins.py); with the element sort on, the slot permutation
travels in the JAX layout. A single-device ``.shards`` generation the
JAX package wrote is verified and restored by the port, and a torn one
refused.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from pumiumtally_tpu.utils import checkpoint as jckpt
from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
from pumiumtally_tpu_torch.utils import checkpoint as ckpt
from torch_twins import TOL, move_both, twin_meshes, twin_tallies


def _inputs(rng, n, n_groups=2):
    return (
        rng.uniform(0.05, 0.95, (n, 3)).ravel().copy(),
        np.ones(n, np.int8),
        rng.uniform(0.5, 2.0, n),
        rng.integers(0, n_groups, n).astype(np.int32),
        np.full(n, -1, np.int32),
    )


def _drive(tally, moves, seed):
    rng = np.random.default_rng(seed)
    for _ in range(moves):
        tally.move_to_next_location(*_inputs(rng, tally.num_particles,
                                             tally.config.n_groups))


def _fresh(n=16, mesh=None, **cfg):
    mesh = mesh or build_box(1.0, 1.0, 1.0, 3, 3, 3, device="cpu")
    t = PumiTally(mesh, n, TallyConfig(tolerance=1e-6, **cfg), device="cpu")
    rng = np.random.default_rng(42)
    t.initialize_particle_location(rng.uniform(0.1, 0.9, (n, 3)).ravel())
    return t


def _state(t) -> dict:
    s = t.state
    out = {f: getattr(s, f).numpy().copy() for f in (
        "origin", "dest", "elem", "in_flight", "weight", "group",
        "material_id", "particle_id")}
    out["flux"] = t.raw_flux
    return out


def test_round_trip_matches_uninterrupted(tmp_path):
    path = str(tmp_path / "tally.npz")
    a = _fresh()
    _drive(a, 3, seed=1)
    a.save_checkpoint(path)
    _drive(a, 2, seed=2)

    b = _fresh()
    b.restore_checkpoint(path)
    assert b.iter_count == 3
    _drive(b, 2, seed=2)
    np.testing.assert_array_equal(a.raw_flux, b.raw_flux)
    np.testing.assert_array_equal(a.element_ids, b.element_ids)
    np.testing.assert_array_equal(a.state.origin.numpy(),
                                  b.state.origin.numpy())
    assert a.total_segments == b.total_segments
    meta = ckpt.verify_checkpoint(path)
    assert meta["dtype"] == "float32" and meta["iter_count"] == 3
    assert set(meta["array_sha256"]) >= {"flux", "origin", "perm"}


def test_adaptive_replan_state_rides_checkpoints(tmp_path):
    """compact_stages='adaptive' (resolved and replanned by the facade,
    ignored by the port's walk): the round trip stays bitwise and the
    replanned ladder rides the checkpoint, under the JAX keys."""
    path = str(tmp_path / "tally.npz")
    mesh = build_box(1.0, 1.0, 1.0, 3, 3, 3, device="cpu")
    n = 1024
    a = _fresh(n, mesh, compact_stages="adaptive")
    _drive(a, 1, seed=11)
    a.save_checkpoint(path)
    b = _fresh(n, mesh, compact_stages="adaptive")
    b.restore_checkpoint(path)
    _drive(a, 1, seed=12)
    _drive(b, 1, seed=12)
    np.testing.assert_array_equal(a.raw_flux, b.raw_flux)
    meta = ckpt.load_meta(path)
    assert meta["replanned"] is True and b._replanned
    assert meta["compact_stages_planned"] == [
        list(s) for s in a._compact_stages]
    assert b._compact_stages == a._compact_stages


def test_mesh_mismatch_rejected(tmp_path):
    path = str(tmp_path / "tally.npz")
    a = _fresh()
    a.save_checkpoint(path)
    other = PumiTally(build_box(1.0, 1.0, 1.0, 2, 2, 2, device="cpu"),
                      a.num_particles, TallyConfig(tolerance=1e-6),
                      device="cpu")
    with pytest.raises(ValueError, match="different mesh"):
        other.restore_checkpoint(path)


def test_shape_mismatches_rejected(tmp_path):
    path = str(tmp_path / "tally.npz")
    a = _fresh()
    a.save_checkpoint(path)
    mesh = build_box(1.0, 1.0, 1.0, 3, 3, 3, device="cpu")
    wrong_n = PumiTally(mesh, 8, TallyConfig(tolerance=1e-6), device="cpu")
    with pytest.raises(ValueError, match="particles"):
        wrong_n.restore_checkpoint(path)
    wrong_g = PumiTally(mesh, a.num_particles,
                        TallyConfig(tolerance=1e-6, n_groups=5), device="cpu")
    with pytest.raises(ValueError, match="energy groups"):
        wrong_g.restore_checkpoint(path)
    wrong_sd = PumiTally(mesh, a.num_particles,
                         TallyConfig(tolerance=1e-6, sd_mode="batch"),
                         device="cpu")
    with pytest.raises(ValueError, match="sd_mode"):
        wrong_sd.restore_checkpoint(path)
    wrong_dt = PumiTally(build_box(1.0, 1.0, 1.0, 3, 3, 3,
                                   dtype=torch.float64, device="cpu"),
                         a.num_particles,
                         TallyConfig(tolerance=1e-6, dtype=torch.float64),
                         device="cpu")
    with pytest.raises(ValueError):
        wrong_dt.restore_checkpoint(path)


def test_mesh_fingerprint_is_the_jax_packages():
    """One mesh, one fingerprint in both packages (int32 tet2vert and
    class ids, coordinates in the mesh dtype), in both dtypes."""
    for dtype in (torch.float64, torch.float32):
        jm, pm = twin_meshes(dtype, nx=3, jitter=0.1, classes=(2, 5))
        assert ckpt.mesh_fingerprint(pm) == jckpt.mesh_fingerprint(jm)


# --------------------------------------------------------------------- #
# Across the packages
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_checkpoints_cross_between_the_packages(tmp_path, dtype, sort):
    """JAX → port and port → JAX: the restored state is the saved state
    bit for bit, and the resumed run agrees with the other package's
    uninterrupted run within the walk tolerance."""
    n = 48
    cfg = dict(tolerance=1e-8, n_groups=2)
    if sort:
        cfg.update(sort_by_element=True, migration_period=2)
    meshes = twin_meshes(dtype, nx=4, jitter=0.1, classes=(0, 1))
    pos = np.random.default_rng(3).uniform(0.1, 0.9, (n, 3)).ravel()
    rngs = [np.random.default_rng(20 + i) for i in range(5)]
    moves = [_inputs(r, n) for r in rngs]

    def run(t, ms):
        for m in ms:
            t.move_to_next_location(*[np.array(a, copy=True) for a in m])

    for src_pkg in ("jax", "port"):
        jt, pt = twin_tallies(meshes, n, dtype, **cfg)
        for t in (jt, pt):
            t.initialize_particle_location(pos.copy())
        writer, reader_ref = (jt, pt) if src_pkg == "jax" else (pt, jt)
        run(writer, moves[:2])
        path = str(tmp_path / f"{src_pkg}-{sort}.npz")
        writer.save_checkpoint(path)
        jr, pr = twin_tallies(meshes, n, dtype, **cfg)
        reader = pr if src_pkg == "jax" else jr
        reader.restore_checkpoint(path)
        assert reader.iter_count == 2
        np.testing.assert_array_equal(np.asarray(reader.raw_flux),
                                      np.asarray(writer.raw_flux))
        np.testing.assert_array_equal(reader.element_ids,
                                      writer.element_ids)
        np.testing.assert_array_equal(np.asarray(reader.state.origin),
                                      np.asarray(writer.state.origin))
        if sort:
            assert reader._perm is not None
            np.testing.assert_array_equal(np.asarray(reader._perm),
                                          np.asarray(writer._perm))
        run(reader, moves[2:])
        run(reader_ref, moves)  # the other package, uninterrupted
        pos_tol, rtol, atol = TOL[dtype]
        np.testing.assert_allclose(np.asarray(reader.raw_flux),
                                   np.asarray(reader_ref.raw_flux),
                                   rtol=rtol, atol=atol)
        np.testing.assert_array_equal(reader.element_ids,
                                      reader_ref.element_ids)
        assert reader.total_segments == reader_ref.total_segments


def test_adaptive_replan_crosses_between_the_packages(tmp_path):
    """The adaptive replan's state crosses with the checkpoint: the port's
    replanned ladder (1024 lanes, one move) restores into a JAX tally
    under the JAX keys, and the JAX tally's file back into a fresh port
    tally, ``_replanned`` and ``_compact_stages`` equal both ways."""
    n = 1024
    meshes = twin_meshes(torch.float64, nx=3)
    jt, pt = twin_tallies(meshes, n, compact_stages="adaptive", n_groups=2)
    pos = np.random.default_rng(5).uniform(0.1, 0.9, (n, 3)).ravel()
    pt.initialize_particle_location(pos.copy())
    assert not pt._replanned
    pt.move_to_next_location(*_inputs(np.random.default_rng(6), n))
    assert pt._replanned and pt._compact_stages
    path = str(tmp_path / "port.npz")
    pt.save_checkpoint(path)
    jt.restore_checkpoint(path)
    assert jt._replanned and jt._compact_stages == pt._compact_stages
    back = str(tmp_path / "jax.npz")
    jt.save_checkpoint(back)
    fresh = twin_tallies(meshes, n, compact_stages="adaptive",
                         n_groups=2)[1]
    assert not fresh._replanned
    fresh.restore_checkpoint(back)
    assert fresh._replanned and fresh._compact_stages == pt._compact_stages
    np.testing.assert_array_equal(fresh.raw_flux, pt.raw_flux)


def test_jax_sharded_generation_restores(tmp_path):
    """A ``.shards`` generation the JAX package wrote for one device (two
    shards and the manifest): verified and restored by the port bit for
    bit; a torn shard or a missing manifest is corruption."""
    n = 32
    jt, pt = twin_tallies(twin_meshes(torch.float64, nx=3), n)
    rng = np.random.default_rng(1)
    pos = rng.uniform(0.1, 0.9, (n, 3)).ravel()
    for t in (jt, pt):
        t.initialize_particle_location(pos.copy())
    move_both((jt, pt), _inputs(rng, n))
    gen = str(tmp_path / "ckpt-00000001.shards")
    jt.save_checkpoint(gen, n_shards=2)
    meta = ckpt.verify_checkpoint(gen)
    assert meta["iter_count"] == 1
    fresh = twin_tallies(twin_meshes(torch.float64, nx=3), n)[1]
    fresh.restore_checkpoint(gen)
    np.testing.assert_array_equal(fresh.raw_flux, np.asarray(jt.raw_flux))
    np.testing.assert_array_equal(fresh.state.origin.numpy(),
                                  np.asarray(jt.state.origin))
    # The port writes the sharded layout too, and the JAX package reads it.
    mine = str(tmp_path / "mine.shards")
    fresh.save_checkpoint(mine, n_shards=2)
    assert ckpt.verify_checkpoint(mine)["iter_count"] == 1
    back = twin_tallies(twin_meshes(torch.float64, nx=3), n)[0]
    back.restore_checkpoint(mine)
    np.testing.assert_array_equal(np.asarray(back.raw_flux), fresh.raw_flux)
    shard = os.path.join(gen, "shard-001.npz")
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) // 2)
    with pytest.raises(ckpt.CheckpointIntegrityError):
        ckpt.verify_checkpoint(gen)
    os.unlink(os.path.join(gen, ckpt.MANIFEST_NAME))
    with pytest.raises(ckpt.CheckpointIntegrityError, match="MANIFEST"):
        fresh.restore_checkpoint(gen)


def test_restore_rebuilds_derived_state(tmp_path):
    """The derived state a restore resets: the slot permutation on the
    card (rebuilt from particle_id), the batch-sd snapshot (the even
    entries, own storage), and the quarantine counts."""
    path = str(tmp_path / "t.npz")
    mesh = build_box(1.0, 1.0, 1.0, 3, 3, 3, dtype=torch.float64,
                     device="cpu")
    cfg = dict(dtype=torch.float64, sd_mode="batch", sort_by_element=True,
               migration_period=1, quarantine=True)
    a = _fresh(16, mesh, **cfg)
    _drive(a, 2, seed=4)
    a.save_checkpoint(path)
    b = PumiTally(mesh, 16, TallyConfig(tolerance=1e-6, **cfg), device="cpu")
    b.restore_checkpoint(path)
    assert b._perm is not None and b._perm_dev is not None
    np.testing.assert_array_equal(b._perm_dev.numpy(), a._perm_dev.numpy())
    np.testing.assert_array_equal(b._prev_even.numpy(),
                                  b.flux[0::2].numpy())
    assert b._prev_even.data_ptr() != b.flux.data_ptr()
    np.testing.assert_array_equal(b.quarantined_lanes(),
                                  a.quarantined_lanes())
    _drive(a, 2, seed=5)
    _drive(b, 2, seed=5)
    for name, v in _state(a).items():
        np.testing.assert_array_equal(_state(b)[name], v, err_msg=name)
