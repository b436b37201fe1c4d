"""The port's four-call facade (``pumiumtally_tpu_torch.PumiTally``) on
``device="cpu"``.

* The reference oracle scenarios of ``tests/test_tally_oracle.py`` (6-tet
  unit box, 5 particles, hand-computed fluxes at 1e-8).
* The port facade against the JAX facade over the same moves on a 4^3
  box: raw flux, the write-backs into the caller's buffers, element ids.
* VTK bytes equal to the JAX writer's for the same normalized flux.
* The facade contracts of ``tests/test_api_contracts.py`` (out-params,
  group bounds, truncation warning), and the refusal of every unported
  ``TallyConfig`` field.
"""
from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.io.vtk import write_flux_vtk as jwrite_flux_vtk
from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
from pumiumtally_tpu_torch.convert import (
    MESH_FIELDS,
    load_tally_arrays,
    mesh_from_jax_arrays,
)
from pumiumtally_tpu_torch.io.vtk import write_flux_vtk

NUM = 5
TOL = 1e-8


# --------------------------------------------------------------------- #
# Reference oracle (tests/test_tally_oracle.py, first six scenarios)
# --------------------------------------------------------------------- #
@pytest.fixture()
def tally():
    mesh = build_box(dtype=torch.float64, device="cpu")
    return PumiTally(mesh, NUM, TallyConfig(dtype=torch.float64), device="cpu")


def _init(tally):
    pos = np.tile([0.1, 0.4, 0.5], NUM)
    tally.initialize_particle_location(pos, pos.size)
    return tally


def _move1(tally):
    dest = np.tile([1.2, 0.4, 0.5], NUM)
    flying = np.ones(NUM, dtype=np.int8)
    weights = np.ones(NUM)
    groups = np.zeros(NUM, dtype=np.int32)
    mats = np.zeros(NUM, dtype=np.int32)
    tally.move_to_next_location(dest, flying, weights, groups, mats, dest.size)
    return dest, flying, mats


def test_ctor_invariants(tally):
    assert tally.state.capacity == NUM
    assert tally.mesh.ntet == 6
    assert tally.raw_flux.shape == (6, 2, 2)
    np.testing.assert_allclose(
        tally.state.origin.numpy(), np.tile([0.5, 0.75, 0.25], (NUM, 1)),
        atol=TOL,
    )
    np.testing.assert_array_equal(tally.element_ids, 0)


def test_initial_search_lands_in_elem2_without_tallying(tally):
    _init(tally)
    np.testing.assert_array_equal(tally.element_ids, 2)
    np.testing.assert_allclose(tally.raw_flux, 0.0, atol=TOL)
    np.testing.assert_allclose(
        tally.state.origin.numpy(), np.tile([0.1, 0.4, 0.5], (NUM, 1)),
        atol=TOL,
    )


def test_move_crosses_2_3_4_and_clips_at_domain_boundary(tally):
    _init(tally)
    dest, flying, mats = _move1(tally)
    np.testing.assert_array_equal(tally.element_ids, 4)
    np.testing.assert_allclose(
        dest.reshape(NUM, 3), np.tile([1.0, 0.4, 0.5], (NUM, 1)), atol=TOL
    )
    np.testing.assert_array_equal(flying, 0)
    np.testing.assert_array_equal(mats, -1)
    flux = tally.raw_flux
    expected = np.zeros(6)
    expected[2], expected[3], expected[4] = 0.3 * NUM, 0.1 * NUM, 0.5 * NUM
    np.testing.assert_allclose(flux[:, 0, 0], expected, atol=TOL)
    np.testing.assert_allclose(flux[:, 1, :], 0.0, atol=TOL)
    expected_sq = np.zeros(6)
    expected_sq[2], expected_sq[3], expected_sq[4] = (
        0.09 * NUM, 0.01 * NUM, 0.25 * NUM,
    )
    np.testing.assert_allclose(flux[:, 0, 1], expected_sq, atol=TOL)


def test_second_move_accumulates_heterogeneous_weights(tally):
    _init(tally)
    _move1(tally)
    dest = np.tile([1.0, 0.4, 0.5], (NUM, 1))
    dest[0] = [0.15, 0.05, 0.20]
    dest[2] = [0.85, 0.05, 0.10]
    flying = np.zeros(NUM, dtype=np.int8)
    flying[0] = flying[2] = 1
    weights = np.ones(NUM)
    weights[0], weights[2] = 2.0, 0.5
    groups = np.zeros(NUM, dtype=np.int32)
    mats = np.zeros(NUM, dtype=np.int32)
    flat = dest.reshape(-1).copy()
    tally.move_to_next_location(flat, flying, weights, groups, mats, flat.size)
    np.testing.assert_allclose(flat.reshape(NUM, 3), dest, atol=TOL)
    np.testing.assert_array_equal(tally.element_ids, [3, 4, 4, 4, 4])
    flux = tally.raw_flux
    expected = np.zeros(6)
    expected[2] = 0.3 * NUM
    expected[3] = 0.1 * NUM + 0.08790490988459178 * 2.0
    expected[4] = (
        0.5 * NUM + 0.879049070406094 * 2.0 + 0.552268050859363 * 0.5
    )
    np.testing.assert_allclose(flux[:, 0, 0], expected, atol=TOL)


def test_normalization_and_vtk(tally, tmp_path):
    _init(tally)
    _move1(tally)
    norm = tally.normalized_flux()
    vol = 1.0 / 6.0
    assert norm[2, 0, 0] == pytest.approx(0.3 * NUM / (vol * NUM), abs=TOL)
    assert norm[4, 0, 0] == pytest.approx(0.5 * NUM / (vol * NUM), abs=TOL)
    assert np.isfinite(norm[..., 2]).all()
    out = tally.write_pumi_tally_mesh(str(tmp_path / "fluxresult.vtu"))
    text = open(out).read()
    assert "flux_group_0" in text and "flux_group_1" in text
    assert "volume" in text


def test_parked_particles_keep_position_and_material(tally):
    _init(tally)
    _move1(tally)
    before = tally.raw_flux.copy()
    dest = np.tile([0.5, 0.5, 0.5], NUM)
    flying = np.zeros(NUM, dtype=np.int8)
    mats = np.full(NUM, 7, dtype=np.int32)
    tally.move_to_next_location(
        dest, flying, np.ones(NUM), np.zeros(NUM, np.int32), mats, dest.size
    )
    np.testing.assert_allclose(
        dest.reshape(NUM, 3), np.tile([1.0, 0.4, 0.5], (NUM, 1)), atol=TOL
    )
    np.testing.assert_array_equal(tally.element_ids, 4)
    np.testing.assert_allclose(tally.raw_flux, before, atol=TOL)


# --------------------------------------------------------------------- #
# Port facade against the JAX facade
# --------------------------------------------------------------------- #
_JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}
# (positions atol, flux rtol, flux atol): XLA:CPU contracts multiply-adds
# into FMAs and the port does not, so the two agree to rounding; a flux
# bin also carries the absolute error of its segments' positions.
FACADE_TOL = {
    torch.float64: (1e-12, 1e-10, 1e-12),
    torch.float32: (1e-5, 1e-4, 1e-5),
}


def _two_facades(dtype, n, nx=4):
    cid = None
    jmesh = jpt.build_box(1.0, 1.0, 1.0, nx, nx, nx, dtype=_JDT[dtype])
    coords, tets = np.asarray(jmesh.coords), np.asarray(jmesh.tet2vert)
    cid = (coords[tets].mean(axis=1)[:, 0] > 0.5).astype(np.int32)
    jmesh = jpt.TetMesh.from_numpy(coords, tets, cid, dtype=_JDT[dtype])
    jt = jpt.PumiTally(
        jmesh, n, jpt.TallyConfig(n_groups=3, dtype=_JDT[dtype])
    )
    pmesh = mesh_from_jax_arrays(
        {f: np.asarray(getattr(jmesh, f)) for f in MESH_FIELDS}, "cpu"
    )
    pt = PumiTally(
        pmesh, n, TallyConfig(n_groups=3, dtype=dtype), device="cpu"
    )
    return jt, pt


def _move_inputs(rng, n, prev):
    direction = rng.normal(size=(n, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    dest = prev + direction * rng.exponential(0.3, (n, 1))
    flying = (rng.uniform(size=n) > 0.1).astype(np.int8)
    weights = rng.uniform(0.5, 2.0, n)
    groups = rng.integers(0, 3, n).astype(np.int32)
    return dest.reshape(-1), flying, weights, groups


def _move_both(jt, pt, inputs):
    outs = []
    for t in (jt, pt):
        dest, flying, weights, groups = (a.copy() for a in inputs)
        mats = np.zeros(len(flying), np.int32)
        t.move_to_next_location(dest, flying, weights, groups, mats)
        outs.append((dest, flying, mats))
    return outs


def _assert_facades_agree(jt, pt, outs, dtype):
    pos_tol, rtol, atol = FACADE_TOL[dtype]
    (jd, jf, jm), (pd, pf, pm) = outs
    np.testing.assert_allclose(pd, jd, rtol=0, atol=pos_tol)
    np.testing.assert_array_equal(pf, jf)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_array_equal(pt.element_ids, np.asarray(jt.element_ids))
    np.testing.assert_allclose(pt.raw_flux, jt.raw_flux, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_facade_matches_jax_over_three_moves(dtype):
    n = 64
    jt, pt = _two_facades(dtype, n)
    rng = np.random.default_rng(5)
    pos = rng.uniform(0.05, 0.95, (n, 3))
    jt.initialize_particle_location(pos.reshape(-1).copy())
    pt.initialize_particle_location(pos.reshape(-1).copy())
    np.testing.assert_array_equal(pt.element_ids, np.asarray(jt.element_ids))
    prev = pos
    for _ in range(3):
        inputs = _move_inputs(rng, n, prev)
        outs = _move_both(jt, pt, inputs)
        _assert_facades_agree(jt, pt, outs, dtype)
        prev = outs[1][0].reshape(n, 3)
    assert (outs[1][2] == 1).any() or (outs[1][2] == 0).any()  # stops
    assert pt.iter_count == 3 and pt.tally_times.n_moves == 3
    np.testing.assert_allclose(
        pt.normalized_flux(), jt.normalized_flux(),
        rtol=FACADE_TOL[dtype][1], atol=FACADE_TOL[dtype][2] * 100,
    )


def test_load_tally_arrays_continues_a_jax_run():
    """Seed the port from a JAX facade mid-run; the next moves agree."""
    n, dtype = 48, torch.float64
    jt, pt = _two_facades(dtype, n)
    rng = np.random.default_rng(8)
    pos = rng.uniform(0.05, 0.95, (n, 3))
    jt.initialize_particle_location(pos.reshape(-1).copy())
    inputs = _move_inputs(rng, n, pos)
    dest, flying, weights, groups = (a.copy() for a in inputs)
    jt.move_to_next_location(
        dest, flying, weights, groups, np.zeros(n, np.int32)
    )
    load_tally_arrays(
        pt, jt.raw_flux, np.asarray(jt.state.origin),
        np.asarray(jt.element_ids), np.asarray(jt.state.material_id),
    )
    prev = dest.reshape(n, 3)
    for _ in range(2):
        inputs = _move_inputs(rng, n, prev)
        outs = _move_both(jt, pt, inputs)
        _assert_facades_agree(jt, pt, outs, dtype)
        prev = outs[1][0].reshape(n, 3)


@pytest.mark.parametrize("ext", [".vtu", ".vtk"])
def test_vtk_bytes_equal_jax(tmp_path, ext):
    jmesh = jpt.build_box(1.0, 1.0, 1.0, 2, 2, 2, dtype=jnp.float32)
    pmesh = mesh_from_jax_arrays(
        {f: np.asarray(getattr(jmesh, f)) for f in MESH_FIELDS}, "cpu"
    )
    rng = np.random.default_rng(2)
    norm = rng.uniform(0, 3, (jmesh.ntet, 3, 3)).astype(np.float32)
    a, b = tmp_path / f"jax{ext}", tmp_path / f"port{ext}"
    jwrite_flux_vtk(str(a), jmesh, norm)
    write_flux_vtk(str(b), pmesh, norm)
    assert a.read_bytes() == b.read_bytes()


def test_mesh_path_constructor(tmp_path):
    from pumiumtally_tpu_torch.mesh.box import build_box_arrays

    coords, tets = build_box_arrays(1.0, 1.0, 1.0, 2, 2, 2)
    p = tmp_path / "box.npz"
    np.savez(p, coords=coords, tet2vert=tets,
             class_id=np.zeros(len(tets), np.int32))
    t = PumiTally(str(p), 4, TallyConfig(dtype=torch.float64), device="cpu")
    assert t.mesh.ntet == 48 and t.mesh.dtype == torch.float64


# --------------------------------------------------------------------- #
# Facade contracts (tests/test_api_contracts.py)
# --------------------------------------------------------------------- #
def _mk(n=3, **cfg_kw):
    cfg = TallyConfig(dtype=torch.float64, **cfg_kw)
    t = PumiTally(build_box(dtype=torch.float64, device="cpu"), n, cfg,
                  device="cpu")
    pos = np.tile([0.5, 0.6, 0.4], n)
    t.initialize_particle_location(pos, pos.size)
    return t


def _move_args(n, dest_xyz=(0.6, 0.6, 0.4)):
    return (
        np.tile(np.asarray(dest_xyz, dtype=np.float64), n),
        np.ones(n, dtype=np.int8),
        np.ones(n),
        np.zeros(n, dtype=np.int32),
        np.zeros(n, dtype=np.int32),
    )


def test_out_params_must_be_ndarrays():
    t = _mk()
    dest, flying, w, g, m = _move_args(3)
    with pytest.raises(TypeError, match="flying"):
        t.move_to_next_location(dest, [1, 1, 1], w, g, m, dest.size)
    with pytest.raises(TypeError, match="particle_destinations"):
        t.move_to_next_location(dest.tolist(), flying, w, g, m, dest.size)
    with pytest.raises(TypeError, match="material_ids"):
        t.move_to_next_location(
            dest, flying, w, g, m.astype(np.int64), dest.size
        )


def test_non_contiguous_out_param_rejected():
    t = _mk()
    _, flying, w, g, m = _move_args(3)
    strided = np.zeros((6, 4))[::2, :3]
    with pytest.raises(ValueError, match="contiguous"):
        t.move_to_next_location(strided, flying, w, g, m, 9)


def test_read_only_and_short_out_params_rejected():
    t = _mk()
    dest, flying, w, g, m = _move_args(3)
    ro = dest.copy()
    ro.flags.writeable = False
    with pytest.raises(ValueError, match="writable"):
        t.move_to_next_location(ro, flying, w, g, m)
    with pytest.raises(ValueError, match="must hold"):
        t.move_to_next_location(dest, flying[:2], w, g, m)


def test_group_out_of_range_rejected():
    t = _mk()
    dest, flying, w, _, m = _move_args(3)
    for bad in ([0, 5, 0], [0, -1, 0]):
        with pytest.raises(ValueError, match="energy group"):
            t.move_to_next_location(
                dest, flying, w, np.array(bad, np.int32), m, dest.size
            )


def test_move_before_initialize_rejected():
    t = PumiTally(build_box(dtype=torch.float64, device="cpu"), 3,
                  TallyConfig(dtype=torch.float64), device="cpu")
    with pytest.raises(RuntimeError, match="initialize_particle_location"):
        t.move_to_next_location(*_move_args(3))


def test_truncated_walk_warns():
    t = _mk(max_crossings=1)
    dest, flying, w, g, m = _move_args(3, dest_xyz=(0.95, 0.05, 0.05))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        t.move_to_next_location(dest, flying, w, g, m, dest.size)
    assert any("truncated" in str(r.message) for r in rec)
    assert t.last_stats["truncated"] == 3


def test_walk_stats_off_still_counts_segments():
    t = _mk(walk_stats=False)
    t.move_to_next_location(*_move_args(3))
    assert t.last_stats is None and t.total_segments > 0


@pytest.mark.parametrize("walk_stats", [True, False])
def test_record_capacity_covers_each_move(walk_stats):
    """The record buffers the facade asks for hold every record of the
    move (one per scored segment): before the first move from the mesh's
    face density and the move's path length, then from the last move."""
    n, G = 3000, 4
    mesh = build_box(1.0, 1.0, 1.0, 6, 6, 6, device="cpu")
    t = PumiTally(mesh, n, TallyConfig(n_groups=G, walk_stats=walk_stats),
                  device="cpu")
    rng = np.random.default_rng(5)
    prev = rng.uniform(0.05, 0.95, (n, 3))
    t.initialize_particle_location(prev.reshape(-1).copy())
    for move in range(3):
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        want = prev + d * rng.exponential(0.3, (n, 1))
        fly = rng.uniform(size=n) < 0.9
        cap = t._record_capacity(torch.from_numpy(want).float(),
                                 torch.from_numpy(fly))
        dest = want.reshape(-1).copy()
        before = t.total_segments
        t.move_to_next_location(dest, fly.astype(np.int8), np.ones(n),
                                rng.integers(0, G, n).astype(np.int32),
                                np.zeros(n, np.int32))
        segs = t.total_segments - before
        assert 4 * n < segs <= cap <= 2 * segs, (move, segs, cap)
        prev = dest.reshape(n, 3).copy()


def test_mesh_dtype_must_match_config():
    with pytest.raises(ValueError, match="dtype"):
        PumiTally(build_box(device="cpu"), 3,
                  TallyConfig(dtype=torch.float64), device="cpu")


@pytest.mark.parametrize("field,value", [
    ("tuning", "TUNING.json"),
])
def test_unported_config_fields_refused(field, value):
    """The fields once refused here are ported (``tuning``, A10): they
    construct and resolve as in the JAX package; nothing is refused. The
    name is kept from when they were refused."""
    cfg = TallyConfig(**{field: value})
    assert getattr(cfg, field) == value
    assert cfg.resolve_tuning() == jpt.TallyConfig(
        **{field: value}).resolve_tuning() == value


@pytest.mark.parametrize("field,value", [
    ("integrity", "warn"),
    ("integrity_tol", 1e-6),
    ("audit_lanes", 8),
    ("audit_every", 2),
    ("audit_tol", 1e-5),
    ("audit_seed", 3),
    ("move_deadline_s", 5.0),
])
def test_integrity_config_fields_accepted(field, value):
    """The integrity fields are ported: set away from their defaults they
    construct and resolve as in the JAX package."""
    cfg = TallyConfig(**{field: value})
    assert getattr(cfg, field) == value
    assert cfg.resolve_integrity() == (value if field == "integrity"
                                       else "off")


def _same_outcome(port_call, jax_call):
    """Both calls return the same value, or both raise ValueError with the
    same message."""
    try:
        want = jax_call()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_call()
        assert str(got.value) == str(e)
        return
    assert port_call() == want


@pytest.mark.parametrize("kw", [
    dict(kernel="xla"),
    dict(kernel="pallas"),
    dict(kernel="auto"),
    dict(kernel="mosaic"),
    dict(kernel="pallas", record_xpoints=4),
    dict(kernel="pallas", checkify_invariants=True),
    dict(kernel="pallas", megastep=4),
    dict(kernel="auto", megastep=4),
    dict(pallas_lane_block=256),
    dict(pallas_lane_block=100),
    dict(pallas_lane_block=0),
    dict(megastep=3),
    dict(megastep=0),
    dict(megastep=2, record_xpoints=4),
    dict(megastep=2, checkify_invariants=True),
])
def test_walk_backend_knobs_like_jax(kw):
    """``kernel``, ``pallas_lane_block`` and ``megastep`` construct as in
    the JAX package, and resolve to its values or raise its messages
    (``resolve_kernel``, ``resolve_lane_block`` clamped to a batch of 64,
    ``resolve_megastep``). The port has one walk whatever the kernel."""
    port, ref = TallyConfig(**kw), jpt.TallyConfig(**kw)
    _same_outcome(port.resolve_kernel, ref.resolve_kernel)
    _same_outcome(lambda: port.resolve_lane_block(64),
                  lambda: ref.resolve_lane_block(64))
    _same_outcome(port.resolve_megastep, ref.resolve_megastep)


@pytest.mark.parametrize("env,kw", [
    ("pallas", dict(kernel="xla")),
    ("pallas", dict(record_xpoints=4)),
    ("pallas", dict(checkify_invariants=True)),
    ("pallas", dict(kernel="pallas", record_xpoints=4)),
    ("bogus", dict()),
])
def test_kernel_env_override_like_jax(monkeypatch, env, kw):
    """``PUMI_TPU_KERNEL`` beats the field; an env-forced 'pallas' over a
    debug surface resolves to 'xla', the same conflict in the config
    raises (tests/test_kernel_pallas.py's policy tests)."""
    monkeypatch.setenv("PUMI_TPU_KERNEL", env)
    _same_outcome(TallyConfig(**kw).resolve_kernel,
                  jpt.TallyConfig(**kw).resolve_kernel)


def test_facade_construction_resolves_the_kernel_knob():
    """A conflict written into the config fails at the facade's
    construction, as in the JAX facade; a valid value constructs."""
    mesh = build_box(device="cpu")
    with pytest.raises(ValueError, match="intersection points"):
        PumiTally(mesh, 3, TallyConfig(kernel="pallas", record_xpoints=4),
                  device="cpu")
    t = PumiTally(mesh, 3, TallyConfig(kernel="auto", pallas_lane_block=8),
                  device="cpu")
    assert t._kernel_policy == "auto" and t._lane_block == 3


@pytest.mark.parametrize("field,value,ok", [
    ("tally_scatter", "auto", True),
    ("tally_scatter", "interleaved", True),
    ("tally_scatter", "pair", True),
    ("tally_scatter", "scalar", False),
    ("gathers", "merged", True),
    ("gathers", "split", True),
    ("gathers", "fused", False),
    ("compact_stages", "auto", True),
    ("compact_stages", "plan", True),
    ("compact_stages", "adaptive", True),
    ("compact_stages", ((16, 256),), True),
    ("compact_stages", "ladder", False),
])
def test_scheduling_knobs_refused_like_jax(field, value, ok):
    """The ignored scheduling knobs refuse what the JAX package refuses,
    with its message: ``tally_scatter`` and ``gathers`` as its walk does
    (ops/walk.py), a ``compact_stages`` string as
    ``resolve_compact_stages`` does; the port refuses at construction."""
    if ok:
        TallyConfig(**{field: value})
        return
    if field == "compact_stages":
        with pytest.raises(ValueError) as want:
            jpt.TallyConfig(compact_stages=value).resolve_compact_stages(
                2048)
    else:
        jmesh = jpt.build_box()
        n = 1
        args = (jmesh, jnp.zeros((n, 3)), jnp.zeros((n, 3)),
                jnp.zeros(n, jnp.int32), jnp.ones(n, bool), jnp.ones(n),
                jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
                jnp.zeros(jmesh.ntet * 2 * 2))
        from pumiumtally_tpu.ops.walk import trace_impl

        with pytest.raises(ValueError) as want:
            trace_impl(*args, initial=False, max_crossings=8, n_groups=2,
                       **{field: value})
    with pytest.raises(ValueError) as got:
        TallyConfig(**{field: value})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(sd_mode="batch"),
    dict(quarantine=True),
    dict(truncation_retries=2),
    dict(convergence=True),
    dict(convergence=True, batch_moves=2),
    dict(convergence=True, rel_err_target=0.1, converged_fraction=0.5),
])
def test_run_statistics_fields_accepted(kw):
    """The run-statistics and recovery fields construct, with the JAX
    package's validation (``resolve_convergence``)."""
    cfg = TallyConfig(**kw)
    for field, value in kw.items():
        assert getattr(cfg, field) == value
    want = kw.get("batch_moves", 1) if kw.get("convergence") else None
    assert cfg.resolve_convergence() == want


@pytest.mark.parametrize("field,value", [
    ("sort_by_element", True),
    ("migration_period", 50),
    ("checkify_invariants", True),
    ("record_xpoints", 4),
])
def test_feature_tail_fields_accepted(field, value):
    """The walk's feature tails construct; the two debug surfaces force
    ``io_pipeline="legacy"``, as in the JAX package."""
    cfg = TallyConfig(**{field: value})
    assert getattr(cfg, field) == value
    debug = field in ("checkify_invariants", "record_xpoints")
    assert (cfg.resolve_io_pipeline() == "legacy") == debug


@pytest.mark.parametrize("field,value", [
    ("compact_after", None),
    ("compact_stages", "auto"),
    ("unroll", 1),
    ("tally_scatter", "interleaved"),
    ("gathers", "split"),
    ("io_pipeline", "legacy"),
])
def test_scheduling_fields_accepted(field, value):
    assert getattr(TallyConfig(**{field: value}), field) == value


def test_config_rejects_jax_dtype():
    with pytest.raises(ValueError, match="dtype"):
        TallyConfig(dtype=jnp.float32)


@pytest.mark.parametrize("make", ["make_flux", "make_particle_state"])
def test_entry_points_default_to_the_card(make):
    """``make_flux`` and ``make_particle_state`` place their tensors as
    every entry point does (``utils/platform.py::resolve_device``): no
    ``device=`` means the CUDA card, which raises where there is none;
    ``device="cpu"`` is asked for explicitly."""
    from pumiumtally_tpu_torch.core.state import make_particle_state
    from pumiumtally_tpu_torch.core.tally import make_flux

    fn = {"make_flux": lambda **kw: make_flux(6, 2, **kw),
          "make_particle_state": lambda **kw: make_particle_state(
              3, **kw).origin}[make]
    assert fn(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert fn().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
