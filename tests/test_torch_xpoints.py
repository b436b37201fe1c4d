"""Recorded intersection points in the port on ``device="cpu"``:
``TallyConfig.record_xpoints``, ``PumiTally.intersection_points()`` (the
tracer's ``getIntersectionPoints()``), the walk's ``record_xpoints`` and
``xpoints`` continuation, and the pipeline's ``BatchResult.xpoints``.

Mirrors tests/test_tally_oracle.py :233 and :261 (the surface and its
errors), tests/test_truncation.py :139 (re-walks append), the compaction
case of tests/test_walk_compaction.py :105 (the port has no compaction:
its knobs leave the points unchanged), tests/test_obs.py :217 (points and
counts lane by lane against JAX's ``trace(record_xpoints=64)``) and
tests/test_pipeline.py :83 (``BatchResult.xpoints``).

Tolerances: recorded counts are equal; points agree within the position
limit of the walk's dtype (1e-12 in float64, 1e-5 in float32), the
packages' rounding differing by XLA:CPU's multiply-add contraction. The
JAX walk runs with ``unroll=1`` wherever counts or truncation enter: it
tests ``max_crossings`` once per unrolled block.
"""
from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.ops.walk import trace as jax_trace
from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
from pumiumtally_tpu_torch.models.pipeline import StreamingTallyPipeline
from pumiumtally_tpu_torch.ops import walk, walk_cuda
from torch_twins import TOL, move_both, twin_meshes, twin_tallies

NUM = 5
ORACLE_TOL = 1e-8


def _oracle_init(t):
    t.initialize_particle_location(np.tile([0.1, 0.4, 0.5], NUM))


def _oracle_move(t, dest_xyz=(1.2, 0.4, 0.5)):
    dest = np.tile(dest_xyz, NUM).astype(np.float64)
    t.move_to_next_location(dest, np.ones(NUM, np.int8), np.ones(NUM),
                            np.zeros(NUM, np.int32), np.zeros(NUM, np.int32),
                            dest.size)


def test_intersection_points_surface():
    """The oracle ray (0.1,0.4,0.5)→(1.2,0.4,0.5) crosses faces at x=0.4
    and x=0.5 and is clipped at the x=1 wall: three points in order, the
    JAX facade's points and counts; flag off, the surface refuses."""
    jt = jpt.PumiTally(jpt.build_box(dtype=jnp.float64), NUM,
                       jpt.TallyConfig(dtype=jnp.float64, record_xpoints=8))
    pt = PumiTally(build_box(dtype=torch.float64, device="cpu"), NUM,
                   TallyConfig(dtype=torch.float64, record_xpoints=8),
                   device="cpu")
    for t in (jt, pt):
        _oracle_init(t)
        _oracle_move(t)
    xp, counts = pt.intersection_points()
    assert xp.shape == (NUM, 8, 3) and xp.dtype == np.float64
    assert counts.dtype == np.int32
    np.testing.assert_array_equal(counts, 3)
    expected = np.array([[0.4, 0.4, 0.5], [0.5, 0.4, 0.5], [1.0, 0.4, 0.5]])
    for i in range(NUM):
        np.testing.assert_allclose(xp[i, :3], expected, atol=ORACLE_TOL)
    jxp, jcounts = jt.intersection_points()
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_allclose(xp, jxp, rtol=0, atol=TOL[torch.float64][0])
    off = PumiTally(build_box(dtype=torch.float64, device="cpu"), NUM,
                    TallyConfig(dtype=torch.float64), device="cpu")
    with pytest.raises(ValueError, match="record_xpoints"):
        off.intersection_points()


def test_intersection_points_no_crossing_and_pre_trace_errors():
    """Before any trace the surface raises; a lane that stays in its tet
    records no point; the initial search's points are the JAX facade's."""
    jt = jpt.PumiTally(jpt.build_box(dtype=jnp.float64), NUM,
                       jpt.TallyConfig(dtype=jnp.float64, record_xpoints=4))
    pt = PumiTally(build_box(dtype=torch.float64, device="cpu"), NUM,
                   TallyConfig(dtype=torch.float64, record_xpoints=4),
                   device="cpu")
    with pytest.raises(RuntimeError, match="no trace has run"):
        pt.intersection_points()
    for t in (jt, pt):
        _oracle_init(t)
    xp, counts = pt.intersection_points()
    jxp, jcounts = jt.intersection_points()
    assert (counts > 0).all()
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_allclose(xp, jxp, rtol=0, atol=TOL[torch.float64][0])
    _oracle_move(pt, (0.101, 0.4, 0.5))
    np.testing.assert_array_equal(pt.intersection_points()[1], 0)


def _trunc_inputs(n, i):
    rng = np.random.default_rng(300 + i)
    return (rng.uniform(0.02, 0.98, (n, 3)).ravel().copy(),
            np.ones(n, np.int8), rng.uniform(0.5, 2.0, n),
            rng.integers(0, 2, n).astype(np.int32),
            np.full(n, -1, np.int32))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_escalation_composes_with_xpoints(dtype):
    """A re-walk appends its points after the attempt before it, so the
    points are those of an uninterrupted walk; the JAX facade's escalated
    run records the same."""
    n = 32
    tol = 1e-8 if dtype == torch.float64 else 1e-6
    meshes = twin_meshes(dtype, nx=5)
    cfg = dict(tolerance=tol, record_xpoints=8, unroll=1)
    jt, pt = twin_tallies(meshes, n, dtype, max_crossings=2,
                          truncation_retries=6, **cfg)
    _, ref = twin_tallies(meshes, n, dtype, **cfg)
    pos = np.random.default_rng(42).uniform(0.1, 0.9, (n, 3)).ravel()
    for t in (jt, pt, ref):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t.initialize_particle_location(pos.copy())
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        move_both((jt, pt, ref), _trunc_inputs(n, 1))
    assert pt.telemetry()["totals"]["rewalked"] > 0
    xp_t, c_t = pt.intersection_points()
    xp_r, c_r = ref.intersection_points()
    xp_j, c_j = jt.intersection_points()
    assert (c_r > 2).any()  # the bound truncated some walks
    np.testing.assert_array_equal(c_t, c_r)
    np.testing.assert_array_equal(c_t, c_j)
    atol = TOL[dtype][0]
    np.testing.assert_allclose(xp_t, xp_r, rtol=0, atol=atol)
    np.testing.assert_allclose(xp_t, xp_j, rtol=0, atol=atol)


def _lanes(mesh_np, n, seed):
    rng = np.random.default_rng(seed)
    elem = rng.integers(0, mesh_np["ntet"], n).astype(np.int32)
    origin = mesh_np["centroids"][elem]
    dest = np.clip(origin + rng.normal(0, 0.4, (n, 3)), 0.02, 0.98)
    return origin, dest, elem


def _port_trace(pmesh, origin, dest, elem, in_flight=None, weight=None,
                group=None, **kw):
    n = origin.shape[0]
    t = torch.from_numpy
    kw.setdefault("initial", False)
    kw.setdefault("max_crossings", pmesh.ntet + 64)
    kw.setdefault("n_groups", 2)
    return walk.trace(
        pmesh, t(origin), t(dest), t(elem),
        torch.ones(n, dtype=torch.bool) if in_flight is None
        else t(in_flight),
        torch.ones(n, dtype=torch.float64) if weight is None else t(weight),
        torch.zeros(n, dtype=torch.int32) if group is None else t(group),
        torch.full((n,), -1, dtype=torch.int32),
        torch.zeros(pmesh.ntet * kw["n_groups"] * 2, dtype=torch.float64),
        **kw)


def _jax_trace(jmesh, origin, dest, elem, in_flight=None, weight=None,
               group=None, **kw):
    n = origin.shape[0]
    kw.setdefault("initial", False)
    kw.setdefault("max_crossings", jmesh.ntet + 64)
    kw.setdefault("n_groups", 2)
    return jax_trace(
        jmesh, jnp.asarray(origin), jnp.asarray(dest),
        jnp.asarray(elem, jnp.int32),
        jnp.ones(n, bool) if in_flight is None else jnp.asarray(in_flight),
        jnp.ones(n, jnp.float64) if weight is None else jnp.asarray(weight),
        jnp.zeros(n, jnp.int32) if group is None
        else jnp.asarray(group, jnp.int32),
        jnp.full(n, -1, jnp.int32),
        jpt.make_flux(jmesh.ntet, kw["n_groups"], jnp.float64),
        unroll=1, **kw)


def test_stats_match_recorded_crossings():
    """Points and counts lane by lane against JAX's
    ``trace(record_xpoints=64)``, and the stats counters against the
    recorded counts: total and max crossings, segments, loop iterations."""
    jmesh, pmesh = twin_meshes(nx=2)
    cent = np.asarray(jmesh.centroids())
    origin, dest, elem = _lanes({"ntet": jmesh.ntet, "centroids": cent},
                                32, 11)
    r = _port_trace(pmesh, origin, dest, elem, record_xpoints=64)
    j = _jax_trace(jmesh, origin, dest, elem, record_xpoints=64,
                   tolerance=1e-8)
    counts = r.n_xpoints.numpy()
    stats = dict(zip(("crossings", "max_crossings"),
                     r.stats[:2].tolist()))
    assert stats["crossings"] == counts.sum() > 0
    assert stats["max_crossings"] == counts.max()
    assert int(r.stats[7]) == int(r.n_crossings)
    np.testing.assert_array_equal(counts, np.asarray(j.n_xpoints))
    np.testing.assert_allclose(r.xpoints.numpy(), np.asarray(j.xpoints),
                               rtol=0, atol=TOL[torch.float64][0])
    # Rows past a lane's count stay zero.
    k = np.arange(64)[None, :] >= counts[:, None]
    assert not r.xpoints.numpy()[k].any()


@pytest.mark.parametrize("sched", [
    dict(compact_after=2, compact_size=16),
    dict(compact_stages=((2, 32), (6, 16), (10, 8))),
])
def test_record_xpoints_composes_with_compaction(sched):
    """The JAX walk compacted by ``sched`` records what the port's walk
    records (the port has no compaction; the knobs only schedule the JAX
    walk), lanes parked and lanes leaving the box included; the facade
    takes the knobs and records the same points bitwise."""
    jmesh, pmesh = twin_meshes(nx=4)
    n = 128
    rng = np.random.default_rng(11)
    cent = np.asarray(jmesh.centroids())
    elem = rng.integers(0, jmesh.ntet, n).astype(np.int32)
    origin = cent[elem]
    dest = origin + rng.normal(scale=0.05, size=(n, 3))
    dest[: n // 4] = rng.uniform(-0.5, 1.5, (n // 4, 3))
    in_flight = rng.random(n) > 0.2
    weight = rng.uniform(0.1, 3.0, n)
    group = rng.integers(0, 2, n).astype(np.int32)
    kw = dict(tolerance=1e-12, record_xpoints=6)
    r = _port_trace(pmesh, origin, dest, elem, in_flight, weight, group,
                    **kw)
    j = _jax_trace(jmesh, origin, dest, elem, in_flight, weight, group,
                   **sched, **kw)
    np.testing.assert_array_equal(r.n_xpoints.numpy(),
                                  np.asarray(j.n_xpoints))
    np.testing.assert_allclose(r.xpoints.numpy(), np.asarray(j.xpoints),
                               rtol=0, atol=TOL[torch.float64][0])
    assert (r.n_xpoints.numpy()[~in_flight] == 0).all()
    assert (r.n_xpoints.numpy() > 6).any()  # counts run past K

    pts = []
    for extra in ({}, sched):
        t = PumiTally(pmesh, n, TallyConfig(dtype=torch.float64,
                                            record_xpoints=6, **extra),
                      device="cpu")
        t.initialize_particle_location(origin.ravel().copy())
        buf = dest.ravel().copy()
        t.move_to_next_location(buf, in_flight.astype(np.int8), weight,
                                group, np.full(n, -1, np.int32))
        pts.append(t.intersection_points())
    np.testing.assert_array_equal(pts[0][0], pts[1][0])
    np.testing.assert_array_equal(pts[0][1], pts[1][1])


def test_rewalk_continues_the_point_buffers():
    """``rewalk_truncated`` hands each attempt the last one's buffers: the
    merged points and counts equal an uninterrupted walk's, and the card
    wrapper on CPU tensors records the same."""
    jmesh, pmesh = twin_meshes(nx=5)
    cent = np.asarray(jmesh.centroids())
    origin, dest, elem = _lanes({"ntet": jmesh.ntet, "centroids": cent},
                                48, 5)
    dest = np.random.default_rng(6).uniform(0.02, 0.98, dest.shape)
    full = _port_trace(pmesh, origin, dest, elem, record_xpoints=5)
    first = _port_trace(pmesh, origin, dest, elem, record_xpoints=5,
                        max_crossings=2)
    assert (~first.done).any()
    t = torch.from_numpy
    kw = dict(initial=False, max_crossings=2, n_groups=2, record_xpoints=5)
    merged, _, lost = walk_cuda.rewalk_truncated(
        pmesh, first, t(dest), torch.ones(48, dtype=torch.float64),
        torch.zeros(48, dtype=torch.int32), retries=6, **kw)
    assert lost == 0
    assert torch.equal(merged.n_xpoints, full.n_xpoints)
    np.testing.assert_allclose(merged.xpoints.numpy(), full.xpoints.numpy(),
                               rtol=0, atol=TOL[torch.float64][0])
    with pytest.raises(ValueError, match="xpoints"):
        _port_trace(pmesh, origin, dest, elem, record_xpoints=4,
                    xpoints=(full.xpoints, full.n_xpoints))


def _batches(pmesh, n, count, seed):
    rng = np.random.default_rng(seed)
    cent = pmesh.coords[pmesh.tet2vert.long()].mean(dim=1).numpy()
    for _ in range(count):
        elem = rng.integers(0, pmesh.ntet, n).astype(np.int32)
        origin = cent[elem]
        dest = np.clip(origin + rng.normal(0, 0.3, (n, 3)), 0.01, 0.99)
        yield (origin, dest, elem, rng.uniform(0.5, 2.0, n),
               rng.integers(0, 2, n).astype(np.int32))


def test_pipeline_records_xpoints_when_configured():
    """``record_xpoints`` applies on the pipeline path too: each
    ``BatchResult`` carries its batch's points and counts, those of the
    walk of that batch alone; None with the flag off."""
    pmesh = twin_meshes(nx=3)[1]
    cfg = TallyConfig(n_groups=2, dtype=torch.float64, tolerance=1e-6,
                      record_xpoints=8)
    pipe = StreamingTallyPipeline(pmesh, cfg, depth=2)
    batches = list(_batches(pmesh, 24, 2, 5))
    for b in batches:
        pipe.submit(*b)
    pipe.finish()
    got = list(pipe.results())
    assert len(got) == 2
    for res, (origin, dest, elem, w, g) in zip(got, batches):
        assert res.xpoints.shape == (24, 8, 3)
        assert res.n_xpoints.shape == (24,)
        assert (res.n_xpoints > 0).any()
        r = _port_trace(pmesh, origin, dest, elem, weight=w, group=g,
                        tolerance=1e-6, record_xpoints=8)
        np.testing.assert_array_equal(res.n_xpoints, r.n_xpoints.numpy())
        np.testing.assert_array_equal(res.xpoints, r.xpoints.numpy())
    off = StreamingTallyPipeline(
        pmesh, TallyConfig(n_groups=2, dtype=torch.float64, tolerance=1e-6),
        depth=2)
    off.submit(*batches[0])
    off.finish()
    assert all(b.xpoints is None and b.n_xpoints is None
               for b in off.results())
