"""The port's partitioned checkpoints (``utils/checkpoint.py``: the
partitioned payload, the sharded two-phase writer) and the resilient
runner over a PartitionedTally, on ``device="cpu"``.

Mirrors tests/test_partitioned_api.py's round trip across layouts (a
checkpoint of 8 parts with halo 1 resumes under halo 2 and under 4 parts
bit for bit, the continued runs agreeing to rounding), the partitioned
half of
tests/test_io_pipeline.py's restore across pipelines, and
tests/test_convergence.py's re-based batch statistics. Checkpoints cross
between the packages both ways, single-file and ``.shards``, for the
per-move calls and for the megastep's slot state: the restored flux and
particle state are bit for bit the writer's, and the continued runs agree
within the cross-package tolerances of tests/torch_twins.py (float64:
positions 1e-12, flux 1e-10 relative). The runner over a PartitionedTally
replays a transient bit for bit (per move and per megastep chunk) and
resumes a killed run bit for bit from its sharded generations.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.ops import source as jsource
from pumiumtally_tpu.parallel.partitioned_api import (
    PartitionedTally as JPartitionedTally,
)
from pumiumtally_tpu_torch import PartitionedTally, PumiTally, TallyConfig
from pumiumtally_tpu_torch.ops.source import SourceParams
from pumiumtally_tpu_torch.resilience.faultinject import (
    FaultInjector,
    InjectedKill,
    parse_faults,
)
from pumiumtally_tpu_torch.resilience.runner import ResilientRunner
from pumiumtally_tpu_torch.utils import checkpoint as ckpt
from torch_twins import TOL, twin_meshes

N = 64
SRC_KW = dict(sigma_t={1: 4.0, 2: 9.0}, absorption={1: 0.3, 2: 0.5},
              survival_weight=0.2, seed=13)
SRC = SourceParams(**SRC_KW)
MIRRORS = ("positions", "elem_global", "material_id", "weights", "groups",
           "alive")


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    monkeypatch.delenv("PUMI_TPU_FAULTS", raising=False)


@pytest.fixture(scope="module")
def meshes():
    return twin_meshes(torch.float64, nx=4, jitter=0.2, seed=11,
                       classes=(1, 2))


def _pt(meshes, n_parts=4, halo=1, **kw):
    kw.setdefault("n_groups", 2)
    kw.setdefault("tolerance", 1e-8)
    return PartitionedTally(meshes[1], N, TallyConfig(dtype=torch.float64,
                                                      **kw),
                            n_parts=n_parts, halo_layers=halo, device="cpu")


def _jt(meshes, n_parts=4, halo=1, **kw):
    kw.setdefault("n_groups", 2)
    kw.setdefault("tolerance", 1e-8)
    return JPartitionedTally(meshes[0], N, jpt.TallyConfig(
        dtype=jnp.float64, **kw), n_parts=n_parts, halo_layers=halo)


def _dests(seed=23, moves=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.05, 0.95, (N, 3))
    out = [pos]
    for _ in range(moves):
        out.append(np.clip(out[-1] + rng.normal(0, 0.2, (N, 3)), 0.0, 1.0))
    return out


def _move(t, dest, w=None):
    buf = dest.ravel().copy()
    mats = np.zeros(N, np.int32)
    t.move_to_next_location(buf, np.ones(N, np.int8),
                            np.ones(N) if w is None else w,
                            np.zeros(N, np.int32), mats)
    return buf, mats


def _assert_continued_alike(a_out, b_out, a, b, exact):
    if exact:
        np.testing.assert_array_equal(a_out[0], b_out[0])
        np.testing.assert_array_equal(a.raw_flux, np.asarray(b.raw_flux))
    else:
        pos_tol, rtol, atol = TOL[torch.float64]
        np.testing.assert_allclose(a_out[0], b_out[0], rtol=0, atol=pos_tol)
        np.testing.assert_allclose(a.raw_flux, np.asarray(b.raw_flux),
                                   rtol=rtol, atol=atol)
    np.testing.assert_array_equal(a_out[1], b_out[1])


# ===================================================================== #
# Layouts and pipelines
# ===================================================================== #
@pytest.mark.parametrize("name", ["ck.npz", "ck.shards"])
def test_partitioned_checkpoint_roundtrip_across_layouts(meshes, tmp_path,
                                                         name):
    """The stored flux is global: a checkpoint of 8 parts with halo 1
    resumes under halo 2 and under 4 parts bit for bit. The continued
    runs agree to rounding: another halo folds guest scores onto their
    owners in another order (the JAX facade's continued runs differ by the
    same ulps on this data), and the particle state stays equal."""
    d = _dests()
    a = _pt(meshes, n_parts=8, halo=1)
    a.initialize_particle_location(d[0].ravel().copy())
    _move(a, d[1])
    path = str(tmp_path / name)
    a.save_checkpoint(path)
    if name.endswith(".shards"):
        assert len([f for f in os.listdir(path) if f.startswith("shard-")]) \
            == 8
    others = [_pt(meshes, n_parts=8, halo=2), _pt(meshes, n_parts=4, halo=2)]
    for b in others:
        b.restore_checkpoint(path)
        np.testing.assert_array_equal(b.raw_flux, a.raw_flux)
        assert (b.iter_count, b.total_segments, b.total_rounds) == (
            a.iter_count, a.total_segments, a.total_rounds)
        np.testing.assert_array_equal(b.elem_global, a.elem_global)
    out_a = _move(a, d[2])
    for b in others:
        out_b = _move(b, d[2])
        np.testing.assert_array_equal(out_a[0], out_b[0])
        _assert_continued_alike(out_a, out_b, a, b, exact=False)


def test_checkpoint_restore_mid_run_across_pipelines(meshes, tmp_path):
    """Packed writes, overlap and legacy resume: the staging layout is
    derived state, never persisted."""
    d = _dests()
    c = _pt(meshes, io_pipeline="packed")
    c.initialize_particle_location(d[0].ravel().copy())
    _move(c, d[1])
    _move(c, d[2])
    ckp = str(tmp_path / "part.npz")
    c.save_checkpoint(ckp)
    outs = []
    for io in ("overlap", "legacy"):
        t = _pt(meshes, io_pipeline=io)
        t.restore_checkpoint(ckp)
        outs.append((t, _move(t, d[3])))
    out_c = _move(c, d[3])
    for t, out in outs:
        _assert_continued_alike(out_c, out, c, t, exact=True)


def test_restore_rebases_batch_statistics_and_quarantine(meshes, tmp_path):
    c = _pt(meshes, convergence=True, batch_moves=1, quarantine=True)
    d = _dests()
    c.initialize_particle_location(d[0].ravel().copy())
    for m in (1, 2):
        dest = d[m].copy()
        dest[4] = np.nan
        _move(c, dest)
    ckp = str(tmp_path / "conv_part.npz")
    c.save_checkpoint(ckp)
    e = _pt(meshes, convergence=True, batch_moves=1, quarantine=True)
    e.restore_checkpoint(ckp)
    assert e.telemetry()["convergence"]["n_batches"] == 0
    np.testing.assert_array_equal(e.quarantined_lanes(),
                                  c.quarantined_lanes())
    _move(e, d[3])
    assert e.telemetry()["convergence"]["n_batches"] == 1
    assert e.relative_error().shape == (meshes[1].ntet, 2)


def test_restore_refuses_mismatches(meshes, tmp_path):
    plain = PumiTally(meshes[1], N, TallyConfig(n_groups=2,
                                                dtype=torch.float64),
                      device="cpu")
    plain.initialize_particle_location(_dests()[0].ravel().copy())
    path = str(tmp_path / "plain.npz")
    plain.save_checkpoint(path)
    t = _pt(meshes)
    with pytest.raises(ValueError, match="kind"):
        t.restore_checkpoint(path)
    t.initialize_particle_location(_dests()[0].ravel().copy())
    part = str(tmp_path / "part.npz")
    t.save_checkpoint(part)
    with pytest.raises(ValueError, match="kind"):
        plain.restore_checkpoint(part)
    with pytest.raises(ValueError, match="sd_mode"):
        _pt(meshes, sd_mode="batch").restore_checkpoint(part)
    gen = str(tmp_path / "gen.shards")
    t.save_checkpoint(gen, n_shards=3)
    assert ckpt.verify_checkpoint(gen)["kind"] == "partitioned"
    shard = os.path.join(gen, ckpt.shard_name(2))
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) // 2)
    with pytest.raises(ckpt.CheckpointIntegrityError):
        _pt(meshes).restore_checkpoint(gen)


# ===================================================================== #
# Across the packages
# ===================================================================== #
@pytest.mark.parametrize("name", ["x.npz", "x.shards"])
def test_partitioned_checkpoints_cross_between_the_packages(meshes,
                                                            tmp_path, name):
    d = _dests()
    jt, pt = _jt(meshes), _pt(meshes)
    for t in (jt, pt):
        t.initialize_particle_location(d[0].ravel().copy())
        _move(t, d[1])
    jpath, ppath = str(tmp_path / f"j{name}"), str(tmp_path / f"p{name}")
    jt.save_checkpoint(jpath)
    pt.save_checkpoint(ppath)
    # JAX → port: the restored state is the JAX tally's, bit for bit.
    p2 = _pt(meshes, n_parts=2, halo=2)
    p2.restore_checkpoint(jpath)
    np.testing.assert_array_equal(p2.raw_flux, np.asarray(jt.raw_flux))
    np.testing.assert_array_equal(p2.positions, np.asarray(jt.positions))
    np.testing.assert_array_equal(p2.elem_global,
                                  np.asarray(jt.elem_global))
    # port → JAX.
    j2 = _jt(meshes, n_parts=2, halo=2)
    j2.restore_checkpoint(ppath)
    np.testing.assert_array_equal(np.asarray(j2.raw_flux), pt.raw_flux)
    np.testing.assert_array_equal(np.asarray(j2.positions), pt.positions)
    assert (j2.iter_count, j2.total_segments) == (pt.iter_count,
                                                  pt.total_segments)
    _assert_continued_alike(_move(p2, d[2]), _move(jt, d[2]), p2, jt,
                            exact=False)
    _assert_continued_alike(_move(pt, d[2]), _move(j2, d[2]), pt, j2,
                            exact=False)


def test_megastep_checkpoints_cross_between_the_packages(meshes, tmp_path):
    """The megastep's slot state rides the checkpoint both ways: the same
    layout restores it, and the continued runs agree with the writer's."""
    pos = _dests()[0].ravel()
    jsrc = jsource.SourceParams(**SRC_KW)
    jt, pt = _jt(meshes, megastep=2), _pt(meshes, megastep=2)
    for t, src in ((jt, jsrc), (pt, SRC)):
        t.initialize_particle_location(pos.copy())
        t.run_source_moves(2, src, weights=np.ones(N))
    jpath, ppath = str(tmp_path / "jm.npz"), str(tmp_path / "pm.npz")
    jt.save_checkpoint(jpath)
    pt.save_checkpoint(ppath)
    p2, j2 = _pt(meshes, megastep=2), _jt(meshes, megastep=2)
    p2.restore_checkpoint(jpath)
    j2.restore_checkpoint(ppath)
    assert p2._src is not None and j2._src is not None
    for k in jt._src:
        np.testing.assert_array_equal(p2._src[k].numpy(),
                                      np.asarray(jt._src[k]), err_msg=k)
        np.testing.assert_array_equal(np.asarray(j2._src[k]),
                                      pt._src[k].numpy(), err_msg=k)
    outs = [t.run_source_moves(2, src) for t, src in (
        (p2, SRC), (jt, jsrc), (pt, SRC), (j2, jsrc))]
    assert outs[0]["segments"] == outs[1]["segments"]
    assert outs[2]["segments"] == outs[3]["segments"]
    pos_tol, rtol, atol = TOL[torch.float64]
    for a, b in ((p2, jt), (pt, j2)):
        a._sync_source_state()
        b._sync_source_state()
        np.testing.assert_allclose(a.positions, np.asarray(b.positions),
                                   rtol=0, atol=pos_tol)
        for f in ("elem_global", "material_id", "groups", "alive"):
            np.testing.assert_array_equal(getattr(a, f),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f)
        np.testing.assert_allclose(a.raw_flux, np.asarray(b.raw_flux),
                                   rtol=rtol, atol=atol)


# ===================================================================== #
# The runner over a PartitionedTally
# ===================================================================== #
def test_runner_transient_retry_bitwise(meshes, tmp_path):
    d = _dests(moves=3)

    def run(tag, faults=None):
        t = _pt(meshes)
        run_ = ResilientRunner(t, str(tmp_path / tag), every_moves=1,
                               handle_signals=False, sleep=lambda s: None,
                               faults=faults)
        run_.initialize_particle_location(d[0].ravel().copy())
        outs = [_move(run_, d[m]) for m in (1, 2, 3)]
        run_.close()
        return t, outs

    a, outs_a = run("clean")
    b, outs_b = run("faulty",
                    FaultInjector(parse_faults("transient_at_move:2")))
    for x, y in zip(outs_a, outs_b):
        _assert_continued_alike(x, y, a, b, exact=True)
    assert b.metrics.counter("pumi_move_retries_total").value() == 1
    names = os.listdir(tmp_path / "faulty")
    assert names and all(n.endswith(".shards") for n in names)


def test_runner_megastep_transient_retry_bitwise(meshes, tmp_path):
    pos = _dests()[0].ravel()

    def run(tag, faults=None):
        t = _pt(meshes, megastep=2)
        with ResilientRunner(t, str(tmp_path / tag), every_moves=2,
                             handle_signals=False, sleep=lambda s: None,
                             faults=faults) as run_:
            run_.initialize_particle_location(pos.copy())
            run_.run_source_moves(2, SRC, weights=np.ones(N))
            run_.run_source_moves(4, SRC)
        t._sync_source_state()
        return t

    a = run("clean")
    b = run("faulty", FaultInjector(parse_faults("transient_at_move:3")))
    np.testing.assert_array_equal(b.raw_flux, a.raw_flux)
    for f in MIRRORS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                      err_msg=f)
    assert b.metrics.counter("pumi_move_retries_total").value() == 1


def test_runner_die_at_move_resume_bitwise(meshes, tmp_path):
    d = _dests(moves=5, seed=5)
    ref = _pt(meshes)
    ref.initialize_particle_location(d[0].ravel().copy())
    for m in range(1, 6):
        _move(ref, d[m])
    path = str(tmp_path / "cks")
    a = _pt(meshes)
    run_a = ResilientRunner(a, path, every_moves=1, handle_signals=False,
                            faults=FaultInjector(parse_faults(
                                "die_at_move:4")))
    run_a.initialize_particle_location(d[0].ravel().copy())
    with pytest.raises(InjectedKill):
        for m in range(1, 6):
            _move(run_a, d[m])
    assert a.iter_count == 3
    b = _pt(meshes)
    run_b = ResilientRunner(b, path, every_moves=1, handle_signals=False)
    assert run_b.resumed_from == 3
    run_b.initialize_particle_location(d[0].ravel().copy())
    for m in range(1, 6):
        if b.iter_count >= m:
            continue
        _move(run_b, d[m])
    run_b.close()
    np.testing.assert_array_equal(b.raw_flux, ref.raw_flux)
    np.testing.assert_array_equal(b.elem_global, ref.elem_global)


def test_chip_loss_still_names_a9c(meshes, tmp_path):
    t = _pt(meshes)
    run = ResilientRunner(
        t, str(tmp_path / "cks"), every_moves=1000, handle_signals=False,
        faults=FaultInjector(parse_faults("chip_down_at_move:2")),
        sleep=lambda s: None)
    d = _dests()
    run.initialize_particle_location(d[0].ravel().copy())
    _move(run, d[1])
    with pytest.raises(NotImplementedError, match="A9c"):
        _move(run, d[2])
    assert run.store.find_latest()[0] == 1
