"""Bad-particle quarantine in the port (``resilience/quarantine.py``,
``TallyConfig.quarantine``) on ``device="cpu"``.

Mirrors tests/test_resilience.py :425 (masking and per-lane, per-reason
reports), :466 (a lane with several reasons counts once) and :485 (the
initial positions); :397, :500 and :584, which need the
ResilientRunner, the fault injector and checkpoints, are in
tests/test_torch_resilience.py. The same inputs go
through the JAX facade: quarantined lanes, reasons and write-backs are
equal, the flux at the float64 parity bar (1e-10 relative); the scan's
verdicts equal the JAX module's on the same arrays, and a quarantined run
is bitwise the run in which those lanes are parked (``flying=0``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pumiumtally_tpu.resilience import quarantine as jquarantine
from pumiumtally_tpu_torch import PumiTally, TallyConfig
from pumiumtally_tpu_torch.resilience import quarantine
from torch_twins import assert_tallies_agree, move_both, twin_meshes, twin_tallies

N = 16


def _pair(**cfg):
    return twin_tallies(twin_meshes(nx=4), N, tolerance=1e-8,
                        quarantine=True, **cfg)


def _inputs(i):
    rng = np.random.default_rng(100 + i)
    return (
        rng.uniform(0.05, 0.95, (N, 3)).ravel().copy(),
        np.ones(N, np.int8),
        rng.uniform(0.5, 2.0, N),
        rng.integers(0, 2, N).astype(np.int32),
        np.full(N, -1, np.int32),
    )


def _pos():
    return np.random.default_rng(42).uniform(0.1, 0.9, (N, 3))


def test_scan_matches_jax():
    rng = np.random.default_rng(0)
    coords = rng.uniform(0, 2, (40, 3))
    bounds = quarantine.inflated_bounds(coords)
    jb = jquarantine.inflated_bounds(coords)
    np.testing.assert_array_equal(bounds[0], jb[0])
    np.testing.assert_array_equal(bounds[1], jb[1])
    dest = rng.uniform(0, 2, (50, 3))
    dest[3] = np.nan
    dest[5, 1] = 1e9
    dest[8, 2] = -np.inf
    w = rng.uniform(0.5, 2, 50)
    w[5] = np.nan
    w[11] = np.inf
    rep, jrep = (quarantine.scan(dest, w, bounds),
                 jquarantine.scan(dest, w, jb))
    np.testing.assert_array_equal(rep.mask, jrep.mask)
    assert rep.reasons == jrep.reasons
    assert rep.count == jrep.count == 4  # lane 5 has two reasons
    assert quarantine.scan(np.ones((4, 3)), np.ones(4), bounds) is None
    assert quarantine.REASONS == jquarantine.REASONS


@pytest.mark.parametrize("case", ["clean", "on_bounds", "nan", "inf_dest",
                                  "neg_inf", "out", "weight", "empty"])
def test_scan_fast_path_gives_the_jax_verdicts(case):
    """The column min/max test of a clean call decides as the JAX
    module's per-lane scan does, on each kind of input."""
    rng = np.random.default_rng(5)
    coords = rng.uniform(0, 1, (30, 3))
    bounds = quarantine.inflated_bounds(coords)
    dest = rng.uniform(-0.5, 1.5, (64, 3))
    w = rng.uniform(0.5, 2.0, 64)
    if case == "on_bounds":
        dest[3] = bounds[0]
        dest[4] = bounds[1]
    elif case == "nan":
        dest[7, 1] = np.nan
    elif case == "inf_dest":
        dest[9, 2] = np.inf
    elif case == "neg_inf":
        dest[9, 0] = -np.inf
    elif case == "out":
        dest[11, 0] = bounds[1][0] + 1e-9
    elif case == "weight":
        w[13] = np.nan
    elif case == "empty":
        dest, w = dest[:0], w[:0]
    for weights in (w, None):
        rep = quarantine.scan(dest, weights, bounds)
        jrep = jquarantine.scan(dest, weights, bounds)
        assert (rep is None) == (jrep is None), (case, weights is None)
        if rep is not None:
            np.testing.assert_array_equal(rep.mask, jrep.mask)
            assert rep.reasons == jrep.reasons


@pytest.mark.parametrize("io", ["packed", "overlap", "legacy"])
def test_quarantine_masks_and_reports_per_lane(io, monkeypatch):
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    jt, pt = _pair(io_pipeline=io)
    for t in (jt, pt):
        t.initialize_particle_location(_pos().ravel())
    dest, fly, w, g, mats = _inputs(1)
    d3 = dest.reshape(N, 3)
    d3[3] = np.nan          # nonfinite_dest
    d3[5] = 1e9             # out_of_mesh
    w = w.copy()
    w[7] = np.inf           # nonfinite_weight
    outs = move_both((jt, pt), (dest, fly, w, g, mats))
    lanes = pt.quarantined_lanes()
    assert set(np.nonzero(lanes)[0]) == {3, 5, 7}
    np.testing.assert_array_equal(lanes, jt.quarantined_lanes())
    held = outs[1][0].reshape(N, 3)
    clean = PumiTally(twin_meshes(nx=4)[1], N,
                      TallyConfig(dtype=torch.float64, tolerance=1e-8),
                      device="cpu")
    clean.initialize_particle_location(_pos().ravel())
    np.testing.assert_allclose(held[[3, 5, 7]],
                               clean.state.origin.numpy()[[3, 5, 7]],
                               atol=1e-12)
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][2], outs[0][2])
    assert np.isfinite(pt.raw_flux).all()
    assert_tallies_agree(jt, pt)
    c = pt.metrics.counter("pumi_quarantine_reasons_total")
    assert c.value(reason="nonfinite_dest") == 1
    assert c.value(reason="out_of_mesh") == 1
    assert c.value(reason="nonfinite_weight") == 1
    assert pt.telemetry()["quarantined"] == 3
    assert pt.telemetry()["totals"]["quarantined"] == 3
    assert np.isinf(w[7])  # the caller's weights are never written
    assert np.isnan(dest.reshape(N, 3)[3]).all()  # nor its destinations


def test_multi_reason_lane_counts_once():
    jt, pt = _pair()
    for t in (jt, pt):
        t.initialize_particle_location(_pos().ravel())
    dest, fly, w, g, mats = _inputs(1)
    dest.reshape(N, 3)[3] = 1e9
    w = w.copy()
    w[3] = np.nan
    move_both((jt, pt), (dest, fly, w, g, mats))
    assert pt.telemetry()["quarantined"] == 1
    assert pt.quarantined_lanes().sum() == 1
    c = pt.metrics.counter("pumi_quarantine_reasons_total")
    assert c.value(reason="out_of_mesh") == 1
    assert c.value(reason="nonfinite_weight") == 1
    recs = [r for r in pt.telemetry()["per_move"]
            if r["kind"] == "quarantine"]
    jrecs = [r for r in jt.telemetry()["per_move"]
             if r["kind"] == "quarantine"]
    assert [{k: v for k, v in r.items() if k != "seq"} for r in recs] == \
        [{k: v for k, v in r.items() if k != "seq"} for r in jrecs]


@pytest.mark.parametrize("io", ["packed", "legacy"])
def test_quarantine_initial_positions(io, monkeypatch):
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    jt, pt = _pair(io_pipeline=io)
    pos = _pos()
    pos[2] = np.nan
    for t in (jt, pt):
        t.initialize_particle_location(pos.ravel())
    assert pt.quarantined_lanes()[2] == 1
    assert np.isfinite(pt.state.origin.numpy()).all()
    np.testing.assert_array_equal(pt.element_ids, jt.element_ids)
    assert pt.element_ids[2] == 0  # still at element 0's centroid
    assert np.isnan(pos[2]).all()


def test_quarantined_run_is_bitwise_the_parked_run():
    """A quarantined lane is a parked lane: the flux, write-backs and
    element ids are bitwise those of a run given ``flying=0`` (and inert
    finite values) on those lanes."""
    pmesh = twin_meshes(nx=4)[1]
    q = PumiTally(pmesh, N, TallyConfig(dtype=torch.float64,
                                        quarantine=True), device="cpu")
    p = PumiTally(pmesh, N, TallyConfig(dtype=torch.float64), device="cpu")
    for t in (q, p):
        t.initialize_particle_location(_pos().ravel())
    bad = [1, 4, 9]
    for i in range(1, 4):
        dest, fly, w, g, mats = _inputs(i)
        dq = dest.copy()
        dq.reshape(N, 3)[bad] = np.nan
        dp = dest.copy()
        fp = fly.copy()
        fp[bad] = 0
        mq, mp = mats.copy(), mats.copy()
        q.move_to_next_location(dq, fly.copy(), w, g, mq)
        p.move_to_next_location(dp, fp, w, g, mp)
        np.testing.assert_array_equal(dq, dp)
        np.testing.assert_array_equal(mq, mp)
    np.testing.assert_array_equal(q.raw_flux, p.raw_flux)
    np.testing.assert_array_equal(q.element_ids, p.element_ids)
    np.testing.assert_array_equal(q.quarantined_lanes()[bad], 3)


def test_quarantine_off_reports_nothing():
    t = PumiTally(twin_meshes(nx=4)[1], N,
                  TallyConfig(dtype=torch.float64), device="cpu")
    with pytest.raises(ValueError, match="quarantine=True"):
        t.quarantined_lanes()
    assert t.telemetry()["quarantined"] == 0
