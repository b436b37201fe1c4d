"""The port's PartitionedTally run features on ``device="cpu"``: integrity
(warn, retry, halt) with shadow audits and ``move_deadline_s``,
quarantine, truncation re-walks and convergence, on the per-move calls
and on ``run_source_moves``.

Mirrors the partitioned cases of tests/test_integrity.py (invariants
clean against their oracle, a flipped flux bit detected), of
tests/test_convergence.py (the summary against a float64 oracle and the
single-device tally, one transfer each way with convergence on, the
batch statistics re-based by a restore) and of tests/test_truncation.py
(the escalation recovers the unbounded run's flux, sd_mode="batch" folds
once a move, a warning without re-walks). Against the JAX package
(float64, 4 parts, halo 1, the 4^3 box): the integrity records and audit
counts, the quarantine counts, the convergence summaries and relative
errors, the re-walk totals and the flux (within 1e-10 relative per bin;
the integrity fields within 1e-12 relative) agree.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.ops import source as jsource
from pumiumtally_tpu.parallel.partitioned_api import (
    PartitionedTally as JPartitionedTally,
)
from pumiumtally_tpu_torch import PartitionedTally, PumiTally, TallyConfig
from pumiumtally_tpu_torch.integrity import (
    DispatchTimeoutError,
    FatalIntegrityViolation,
    TransientIntegrityViolation,
)
from pumiumtally_tpu_torch.ops.source import SourceParams
from pumiumtally_tpu_torch.resilience.runner import ResilientRunner
from torch_twins import TOL, twin_meshes

N = 64
SRC_KW = dict(sigma_t={1: 4.0, 2: 9.0}, absorption={1: 0.3, 2: 0.5},
              survival_weight=0.2, seed=13)


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    monkeypatch.delenv("PUMI_TPU_FAULTS", raising=False)


@pytest.fixture(scope="module")
def meshes():
    return twin_meshes(torch.float64, nx=4, classes=(1, 2))


def _cfg(**kw):
    kw.setdefault("n_groups", 2)
    kw.setdefault("tolerance", 1e-8)
    return kw


def _pt(meshes, n_parts=4, halo=1, max_rounds=None, **kw):
    return PartitionedTally(meshes[1], N, TallyConfig(
        dtype=torch.float64, **_cfg(**kw)), n_parts=n_parts,
        halo_layers=halo, max_rounds=max_rounds, device="cpu")


def _jt(meshes, n_parts=4, halo=1, max_rounds=None, **kw):
    import jax.numpy as jnp

    return JPartitionedTally(meshes[0], N, jpt.TallyConfig(
        dtype=jnp.float64, **_cfg(**kw)), n_parts=n_parts, halo_layers=halo,
        max_rounds=max_rounds)


def _inputs(rng, n=N, spread=None):
    dest = (rng.uniform(0.05, 0.95, (n, 3)) if spread is None
            else np.clip(spread + rng.normal(0, 0.3, (n, 3)), 0.0, 1.0))
    return (dest.ravel().copy(), np.ones(n, np.int8),
            rng.uniform(0.5, 2.0, n), rng.integers(0, 2, n).astype(np.int32),
            np.full(n, -1, np.int32))


def _drive(t, moves=3, seed=42):
    rng = np.random.default_rng(seed)
    t.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    outs = []
    for _ in range(moves):
        dest, fly, w, g, mats = _inputs(rng)
        t.move_to_next_location(dest, fly, w, g, mats)
        outs.append((dest.reshape(N, 3).copy(), mats.copy()))
    return outs


def _records(t, kind):
    return [r for r in t.telemetry()["per_move"] if r["kind"] == kind]


def _assert_runs_agree(pt, jt, outs_p, outs_j):
    pos_tol, rtol, atol = TOL[torch.float64]
    for (pa, ma), (pb, mb) in zip(outs_p, outs_j):
        np.testing.assert_allclose(pa, pb, rtol=0, atol=pos_tol)
        np.testing.assert_array_equal(ma, mb)
    np.testing.assert_allclose(pt.raw_flux, np.asarray(jt.raw_flux),
                               rtol=rtol, atol=atol)


# ===================================================================== #
# Integrity
# ===================================================================== #
@pytest.mark.parametrize("io", ["legacy", "packed"])
def test_partitioned_invariants_clean_oracle_and_jax(meshes, io):
    pt, jt = (f(meshes, integrity="warn", audit_lanes=4, io_pipeline=io)
              for f in (_pt, _jt))
    outs = []
    for t in (pt, jt):
        rng = np.random.default_rng(42)
        t.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
        pos_before = np.asarray(t.positions).copy()
        dest, fly, w, g, mats = _inputs(rng)
        t.move_to_next_location(dest, fly, w, g, mats)
        outs.append((dest, w, pos_before))
    tm = pt.telemetry()["integrity"]
    assert tm["violations"] == {}
    assert tm["audit_mismatches"] == 0 and tm["audited_lanes"] > 0
    # The oracle: Σ w·|final − before| (material boundaries stop lanes
    # short of their destinations).
    dest, w, pos_before = outs[0]
    rec = [r for r in _records(pt, "integrity") if r["move"] == 1][-1]
    oracle = float((w * np.linalg.norm(dest.reshape(N, 3) - pos_before,
                                       axis=1)).sum())
    assert rec["scored_wlen"] == pytest.approx(oracle, abs=1e-9 * oracle)
    assert rec["path_wlen"] == pytest.approx(oracle, abs=1e-9 * oracle)
    assert rec["lanes_flying"] == N and rec["lanes_done"] == N
    jrec = [r for r in jt.telemetry()["per_move"]
            if r["kind"] == "integrity" and r["move"] == 1][-1]
    for f in ("bad_flux", "lanes_flying", "lanes_done"):
        assert rec[f] == jrec[f], f
    for f in ("scored_wlen", "path_wlen"):
        assert rec[f] == pytest.approx(jrec[f], rel=1e-12), f
    assert abs(rec["max_residual"] - jrec["max_residual"]) <= 1e-12 * oracle
    ours, theirs = _records(pt, "audit"), [
        r for r in jt.telemetry()["per_move"] if r["kind"] == "audit"]
    assert [(a["audited"], a["mismatches"], a["skipped"]) for a in ours] == [
        (a["audited"], a["mismatches"], a["skipped"]) for a in theirs]
    assert ours[0]["max_dev"] == pytest.approx(theirs[0]["max_dev"],
                                               abs=1e-12)


def test_integrity_off_and_warn_bit_identical(meshes):
    a, b = _pt(meshes), _pt(meshes, integrity="warn", audit_lanes=4)
    outs_a, outs_b = _drive(a), _drive(b)
    for (pa, ma), (pb, mb) in zip(outs_a, outs_b):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ma, mb)
    np.testing.assert_array_equal(a.raw_flux, b.raw_flux)


def test_partitioned_bitflip_detected(meshes, monkeypatch):
    monkeypatch.setenv("PUMI_TPU_FAULTS", "bitflip_flux:1")
    t = _pt(meshes, integrity="warn")
    rng = np.random.default_rng(42)
    t.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    t.move_to_next_location(*_inputs(rng))
    with pytest.warns(RuntimeWarning, match="integrity violation"):
        t.move_to_next_location(*_inputs(rng))
    assert t.telemetry()["integrity"]["violations"].get("flux", 0) >= 1
    inj = t.metrics.counter("pumi_injected_faults_total")
    assert inj.value(kind="bitflip_flux") == 1


@pytest.mark.parametrize("mode,exc", [("halt", FatalIntegrityViolation),
                                      ("retry", TransientIntegrityViolation)])
def test_partitioned_bitflip_escalates_through_the_runner(
        meshes, monkeypatch, tmp_path, mode, exc):
    """integrity="halt" flushes the last good generation and raises;
    "retry" rolls back and replays until the retries run out (the flip
    recurs: it is keyed by the move)."""
    monkeypatch.setenv("PUMI_TPU_FAULTS", "bitflip_flux:1")
    t = _pt(meshes, integrity=mode)
    rng = np.random.default_rng(42)
    run = ResilientRunner(t, str(tmp_path / "cks"), every_moves=1000,
                          handle_signals=False, max_retries=2,
                          sleep=lambda s: None)
    run.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    run.move_to_next_location(*_inputs(rng))
    with pytest.raises(exc) as info:
        run.move_to_next_location(*_inputs(rng))
    assert "flux" in info.value.checks
    if mode == "halt":
        assert run.store.find_latest()[0] == 1
        assert os_listdir_shards(tmp_path / "cks")
    else:
        assert t.metrics.counter("pumi_move_retries_total").value() == 2


def os_listdir_shards(path):
    """The runner's generations of a partitioned tally are sharded."""
    import os

    return [n for n in os.listdir(path) if n.endswith(".shards")]


def test_partitioned_sdc_walk_caught_by_shadow_audit(meshes, monkeypatch):
    monkeypatch.setenv("PUMI_TPU_FAULTS", "sdc_walk:2")
    t = _pt(meshes, integrity="warn", audit_lanes=4)
    rng = np.random.default_rng(42)
    t.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    t.move_to_next_location(*_inputs(rng))
    with pytest.warns(RuntimeWarning, match="sdc_audit"):
        t.move_to_next_location(*_inputs(rng))
    tm = t.telemetry()["integrity"]
    assert tm["violations"].get("sdc_audit", 0) == 1
    assert [a["mismatches"] for a in _records(t, "audit")] == [0, 1]


def test_partitioned_hang_watchdog_rearm_bitwise(meshes, monkeypatch,
                                                 tmp_path):
    ref = _pt(meshes)
    ref_outs = _drive(ref, moves=3, seed=9)
    monkeypatch.setenv("PUMI_TPU_FAULTS", "hang_at_move:2,hang_seconds:1.0")
    t = _pt(meshes, move_deadline_s=0.25)
    run = ResilientRunner(t, str(tmp_path / "cks"), every_moves=1000,
                          handle_signals=False, sleep=lambda s: None)
    outs = _drive(run, moves=3, seed=9)
    assert t.metrics.counter("pumi_move_retries_total").value() == 1
    assert t.telemetry()["integrity"]["violations"]["watchdog"] == 1
    for (pa, ma), (pb, mb) in zip(ref_outs, outs):
        np.testing.assert_array_equal(pb, pa)
        np.testing.assert_array_equal(mb, ma)
    np.testing.assert_array_equal(t.raw_flux, ref.raw_flux)


@pytest.mark.parametrize("io", ["packed", "overlap", "legacy"])
def test_partitioned_deadline_passes_on_healthy_moves(meshes, io):
    ref = _pt(meshes, io_pipeline=io)
    t = _pt(meshes, io_pipeline=io, move_deadline_s=30.0)
    for (pa, ma), (pb, mb) in zip(_drive(ref, 2, 5), _drive(t, 2, 5)):
        np.testing.assert_array_equal(pb, pa)
        np.testing.assert_array_equal(mb, ma)
    np.testing.assert_array_equal(t.raw_flux, ref.raw_flux)
    assert "watchdog" not in t.telemetry()["integrity"]["violations"]


def test_partitioned_hang_without_runner_propagates(meshes, monkeypatch):
    monkeypatch.setenv("PUMI_TPU_FAULTS", "hang_at_move:2,hang_seconds:1.0")
    t = _pt(meshes, move_deadline_s=0.25)
    rng = np.random.default_rng(3)
    t.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    t.move_to_next_location(*_inputs(rng))  # warm-up: no deadline
    with pytest.raises(DispatchTimeoutError):
        t.move_to_next_location(*_inputs(rng))


# ===================================================================== #
# Quarantine
# ===================================================================== #
def test_partitioned_quarantine_matches_jax(meshes):
    pt, jt = _pt(meshes, quarantine=True), _jt(meshes, quarantine=True)
    outs = []
    for t in (pt, jt):
        rng = np.random.default_rng(7)
        pos = rng.uniform(0.1, 0.9, (N, 3))
        pos[3] = np.nan  # parked at the seed from the start
        t.initialize_particle_location(pos.ravel().copy())
        runs = []
        for m in range(2):
            dest, fly, w, g, mats = _inputs(rng)
            d3 = dest.reshape(N, 3)
            d3[5 + m] = np.inf
            d3[9] = 50.0  # far outside the mesh
            w[11] = np.nan
            keep = dest.copy()
            t.move_to_next_location(dest, fly, w, g, mats)
            assert (fly == 0).all()
            runs.append((dest.reshape(N, 3).copy(), mats.copy()))
            np.testing.assert_array_equal(keep[~np.isfinite(keep)],
                                          keep[~np.isfinite(keep)])
        outs.append(runs)
    np.testing.assert_array_equal(pt.quarantined_lanes(),
                                  np.asarray(jt.quarantined_lanes()))
    assert pt.quarantined_lanes().sum() >= 6
    assert np.isfinite(pt.raw_flux).all()
    assert pt.telemetry()["quarantined"] == jt.telemetry()["quarantined"]
    _assert_runs_agree(pt, jt, *outs)


# ===================================================================== #
# Truncation re-walks
# ===================================================================== #
def _trunc_drive(t, moves=2):
    rng = np.random.default_rng(11)
    pos = rng.uniform(0.05, 0.95, (N, 3))
    t.initialize_particle_location(pos.ravel().copy())
    outs = []
    for _ in range(moves):
        dest, fly, w, g, mats = _inputs(rng, spread=pos)
        t.move_to_next_location(dest, fly, w, g, mats)
        pos = dest.reshape(N, 3).copy()
        outs.append((pos, mats.copy()))
    return outs


def test_partitioned_escalation_recovers_and_matches_jax(meshes):
    """Re-walks of the same step on the truncated lanes reproduce the
    unbounded run's flux; the JAX facade re-walks and loses the same
    lanes."""
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        t = _pt(meshes, n_parts=8, max_rounds=1, truncation_retries=8)
        outs = _trunc_drive(t)
        jt = _jt(meshes, n_parts=8, max_rounds=1, truncation_retries=8)
        jouts = _trunc_drive(jt)
    ref = _pt(meshes, n_parts=8)
    ref_outs = _trunc_drive(ref)
    np.testing.assert_allclose(t.raw_flux, ref.raw_flux, rtol=0, atol=1e-11)
    for (pa, ma), (pb, mb) in zip(outs, ref_outs):
        np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(ma, mb)
    tm, jtm = t.telemetry()["totals"], jt.telemetry()["totals"]
    assert tm["rewalked"] > 0 and tm["lost"] == 0
    assert (tm["rewalked"], tm["lost"], tm["segments"]) == (
        jtm["rewalked"], jtm["lost"], jtm["segments"])
    _assert_runs_agree(t, jt, outs, jouts)


def test_partitioned_escalation_batch_sd_folds_once_per_move(meshes):
    def drive(**kw):
        t = _pt(meshes, n_parts=8, sd_mode="batch", **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _trunc_drive(t)
        return t

    esc = drive(max_rounds=1, truncation_retries=8)
    ref = drive()
    assert esc.telemetry()["totals"]["rewalked"] > 0
    np.testing.assert_allclose(esc.raw_flux, ref.raw_flux, rtol=0,
                               atol=1e-11)


def test_partitioned_truncation_warns_without_retries(meshes):
    t = _pt(meshes, n_parts=8, max_rounds=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the initial search truncates too
        t.initialize_particle_location(
            np.random.default_rng(11).uniform(0.05, 0.95, (N, 3)).ravel())
    with pytest.warns(RuntimeWarning, match="truncated"):
        t.move_to_next_location(*_inputs(np.random.default_rng(1)))
    assert t.telemetry()["totals"]["lost"] > 0


# ===================================================================== #
# Convergence
# ===================================================================== #
def _oracle(evens):
    """Float64 batch statistics of a run from its even entries after each
    move (batch_moves=1): the N-batch relative error per bin."""
    e = np.stack([np.zeros_like(evens[0])] + evens)
    t = np.diff(e, axis=0)
    s1, s2, n = e[-1], (t * t).sum(axis=0), t.shape[0]
    scored = s1 > 0
    rel = np.where(scored, np.sqrt(np.maximum(n * s2 - s1 * s1, 0.0)
                                   / (n - 1)) / np.where(scored, s1, 1.0),
                   0.0)
    return rel, int(scored.sum())


@pytest.mark.parametrize("io", ["legacy", "packed"])
def test_partitioned_convergence_matches_oracle_and_jax(meshes, io):
    pt, jt = (f(meshes, convergence=True, batch_moves=1, io_pipeline=io)
              for f in (_pt, _jt))
    evens = []
    rng = np.random.default_rng(2)
    pos = rng.uniform(0.1, 0.9, (N, 3)).ravel()
    for t in (pt, jt):
        t.initialize_particle_location(pos.copy())
    for _ in range(3):
        args = _inputs(rng)
        for t in (pt, jt):
            t.move_to_next_location(*[np.array(a, copy=True) for a in args])
        evens.append(pt.raw_flux[..., 0].reshape(-1).copy())
    rel, scored = _oracle(evens)
    got, want = pt.telemetry()["convergence"], jt.telemetry()["convergence"]
    assert got["n_batches"] == want["n_batches"] == 3
    assert got["scored"] == want["scored"] == scored
    for f in ("rel_err_mean", "rel_err_max", "converged_fraction"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-9)
    np.testing.assert_allclose(pt.relative_error().reshape(-1), rel,
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(pt.relative_error(),
                               np.asarray(jt.relative_error()), rtol=1e-9,
                               atol=1e-12)
    assert pt.converged() == jt.converged()
    # The same problem through the single-device tally.
    s = PumiTally(meshes[1], N, TallyConfig(dtype=torch.float64, **_cfg(
        convergence=True, batch_moves=1, io_pipeline=io)), device="cpu")
    s.initialize_particle_location(pos.copy())
    rng = np.random.default_rng(2)
    rng.uniform(0.1, 0.9, (N, 3))
    for _ in range(3):
        s.move_to_next_location(*_inputs(rng))
    np.testing.assert_allclose(pt.relative_error(), s.relative_error(),
                               rtol=1e-9, atol=1e-12)
    a, b = pt.end_batch(), jt.end_batch()
    assert a["n_batches"] == b["n_batches"] == 4
    np.testing.assert_allclose(a["rel_err_mean"], b["rel_err_mean"],
                               rtol=1e-9)


def test_partitioned_steady_state_transfers_with_convergence(meshes):
    t = _pt(meshes, convergence=True, batch_moves=2, integrity="warn")
    rng = np.random.default_rng(0)
    t.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    t.move_to_next_location(*_inputs(rng))
    tot0 = t.telemetry()["totals"]
    t.move_to_next_location(*_inputs(rng))
    tot1 = t.telemetry()["totals"]
    assert tot1["h2d_transfers"] - tot0["h2d_transfers"] == 1
    assert tot1["d2h_transfers"] - tot0["d2h_transfers"] == 1
    assert t.telemetry()["convergence"]["n_batches"] == 1


def test_partitioned_convergence_off_bit_identical_and_vtk(meshes, tmp_path):
    a, b = _pt(meshes), _pt(meshes, convergence=True, batch_moves=1)
    _drive(a, 2)
    _drive(b, 2)
    np.testing.assert_array_equal(a.raw_flux, b.raw_flux)
    out = b.write_pumi_tally_mesh(str(tmp_path / "flux.vtu"),
                                  uncertainty=True)
    text = open(out).read()
    assert 'Name="rel_err_group_0"' in text
    assert 'Name="rel_err_group_1"' in text
    with pytest.raises(ValueError, match="convergence"):
        a.relative_error()


# ===================================================================== #
# The features through run_source_moves
# ===================================================================== #
def test_megastep_integrity_and_convergence_match_jax(meshes):
    """Integrity and convergence ride the partitioned megastep's tail:
    its batch cadence counts fused moves, and the summaries, the flux and
    the counters agree with the JAX facade's."""
    cfg = dict(integrity="warn", convergence=True, batch_moves=2,
               megastep=2, tolerance=1e-6)
    pt, jt = _pt(meshes, **cfg), _jt(meshes, **cfg)
    pos = np.random.default_rng(3).uniform(0.1, 0.9, (N, 3)).ravel()
    outs = []
    for t, src in ((pt, SourceParams(**SRC_KW)),
                   (jt, jsource.SourceParams(**SRC_KW))):
        t.initialize_particle_location(pos.copy())
        outs.append(t.run_source_moves(4, src, weights=np.ones(N)))
    for f in ("moves", "segments", "collisions", "escaped", "rouletted",
              "alive", "truncated"):
        assert outs[0][f] == outs[1][f], f
    got, want = pt.telemetry(), jt.telemetry()
    assert got["integrity"]["violations"] == {} == want["integrity"][
        "violations"]
    cg, cw = got["convergence"], want["convergence"]
    assert cg["n_batches"] == cw["n_batches"] == 2
    assert cg["scored"] == cw["scored"]
    np.testing.assert_allclose(cg["rel_err_mean"], cw["rel_err_mean"],
                               rtol=1e-9)
    recs = [[r for r in t.telemetry()["per_move"] if r["kind"] == "integrity"]
            for t in (pt, jt)]
    assert [(r["move"], r["lanes_done"], r["bad_flux"]) for r in recs[0]] == [
        (r["move"], r["lanes_done"], r["bad_flux"]) for r in recs[1]]
    _, rtol, atol = TOL[torch.float64]
    np.testing.assert_allclose(pt.raw_flux, np.asarray(jt.raw_flux),
                               rtol=rtol, atol=atol)


def test_megastep_bitflip_halts(meshes, monkeypatch):
    monkeypatch.setenv("PUMI_TPU_FAULTS", "bitflip_flux:2")
    t = _pt(meshes, integrity="halt", megastep=2)
    t.initialize_particle_location(
        np.random.default_rng(3).uniform(0.1, 0.9, (N, 3)).ravel())
    src = SourceParams(**SRC_KW)
    t.run_source_moves(2, src)
    with pytest.raises(FatalIntegrityViolation) as info:
        t.run_source_moves(2, src)
    assert "flux" in info.value.checks
