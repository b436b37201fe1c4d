"""The port's integrity layer (``integrity/``, ``ops/walk.py::
integrity_vector``, the facade's hooks) on ``device="cpu"``.

Mirrors every single-device case of test_integrity (its two partitioned
cases wait for ROADMAP.md A9):

* integrity "off" and "warn" (with audits) leave the outputs bit for bit
  those of the default run;
* the invariant scalars equal the host oracle sums (Σ w·|final − origin|
  from the write-backs, and the move's Σc delta) on jittered meshes, in
  both dtypes and all three io_pipeline modes, and equal the JAX
  package's ``integrity_vector`` on the same walk (the port's walk
  outputs fed to both: 1e-12 relative in float64, 1e-5 in float32; lane
  counts and ``bad_flux`` equal) and the JAX facade's vector on the same
  moves;
* ``bitflip_flux`` flips the JAX hook's bit on the JAX hook's entry and is
  caught by the next move's flux check under "warn" (both packages flag
  it), "halt" (the runner flushes the last good generation) and "retry"
  (the bounded retries run out and the violation propagates);
* ``sdc_walk`` is caught by the float64 shadow audit, which samples the
  lanes the JAX facade samples;
* ``hang_at_move`` under ``move_deadline_s``: the runner re-arms and the
  run ends bitwise equal to an undisturbed one; without a runner the
  timeout propagates; a generous deadline never fires;
* ``nan_src`` is quarantined with the invariants clean;
* the fault grammar, the config validation (with the JAX messages), the
  checkpoint directory's fsync after rotation, and the megastep's
  integrity tail (bitwise the same flux as off, no violation, the chunk's
  vector the sum of its moves').
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.ops.walk import integrity_vector as jintegrity_vector
from pumiumtally_tpu_torch import PumiTally, TallyConfig
from pumiumtally_tpu_torch.integrity import (
    IIDX,
    INTEGRITY_FIELDS,
    DispatchTimeoutError,
    FatalIntegrityViolation,
    TransientIntegrityViolation,
)
from pumiumtally_tpu_torch.integrity.invariants import integrity_to_dict
from pumiumtally_tpu_torch.ops import walk
from pumiumtally_tpu_torch.resilience.faultinject import parse_faults
from pumiumtally_tpu_torch.resilience.runner import ResilientRunner
from pumiumtally_tpu_torch.resilience.store import CheckpointStore
from torch_twins import JDT, move_both, twin_meshes, twin_tallies

N = 64
# Relative tolerance of the integrity fields across the packages.
FIELD_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    """The integrity CI step may force an io_pipeline; the tests that
    parametrize it set the field themselves."""
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    monkeypatch.delenv("PUMI_TPU_FAULTS", raising=False)


@pytest.fixture(scope="module")
def meshes():
    return twin_meshes(torch.float64, nx=4)


def _tally(meshes, **cfg):
    cfg.setdefault("dtype", torch.float64)
    return PumiTally(meshes[1], N, TallyConfig(**cfg), device="cpu")


def _inputs(rng, n=N):
    return (
        rng.uniform(0.05, 0.95, (n, 3)).ravel().copy(),
        np.ones(n, np.int8),
        rng.uniform(0.5, 2.0, n),
        rng.integers(0, 2, n).astype(np.int32),
        np.full(n, -1, np.int32),
    )


def _drive(t, moves=3, seed=42, n=N):
    rng = np.random.default_rng(seed)
    t.initialize_particle_location(rng.uniform(0.1, 0.9, (n, 3)).ravel())
    outs = []
    for _ in range(moves):
        dest, fly, w, g, mats = _inputs(rng, n)
        t.move_to_next_location(dest, fly, w, g, mats)
        outs.append((dest.reshape(n, 3).copy(), mats.copy()))
    return outs


def _records(t, kind):
    return [r for r in t.telemetry()["per_move"] if r["kind"] == kind]


def _assert_fields_close(ours: dict, theirs: dict, dtype) -> None:
    for f in ("lanes_flying", "lanes_done", "bad_flux"):
        assert ours[f] == theirs[f], f
    scale = max(1.0, abs(theirs["path_wlen"]))
    for f in ("scored_wlen", "path_wlen"):
        assert ours[f] == pytest.approx(theirs[f],
                                        rel=FIELD_RTOL[dtype]), f
    # The residual is rounding noise of the sums' terms: held at the
    # fields' scale.
    assert abs(ours["max_residual"] - theirs["max_residual"]) <= (
        FIELD_RTOL[dtype] * scale)


# ===================================================================== #
# Bit identity: off == the default, and the checks never write
# ===================================================================== #
def test_integrity_off_and_warn_bit_identical(meshes):
    base = _tally(meshes)
    off = _tally(meshes, integrity="off")
    warn = _tally(meshes, integrity="warn", audit_lanes=4)
    outs = {id(t): _drive(t) for t in (base, off, warn)}
    for t in (off, warn):
        for (pa, ma), (pb, mb) in zip(outs[id(base)], outs[id(t)]):
            np.testing.assert_array_equal(pb, pa)
            np.testing.assert_array_equal(mb, ma)
        np.testing.assert_array_equal(t.raw_flux, base.raw_flux)
        np.testing.assert_array_equal(t.element_ids, base.element_ids)
    tm = warn.telemetry()["integrity"]
    assert tm["audited_lanes"] > 0 and tm["audit_mismatches"] == 0
    assert tm["violations"] == {}
    # A packed move with the checks on still makes one copy each way.
    assert warn.io["d2h_transfers"] == base.io["d2h_transfers"] == 4
    assert warn.io["h2d_transfers"] == base.io["h2d_transfers"] == 4


# ===================================================================== #
# The invariant scalars: oracle sums and the JAX package
# ===================================================================== #
@pytest.mark.parametrize("io", ["legacy", "packed", "overlap"])
@pytest.mark.parametrize("dtype,tol", [
    (torch.float64, 1e-9),
    (torch.float32, 2e-3),
])
def test_conservation_invariants_match_oracle(io, dtype, tol):
    jt, pt = twin_tallies(
        twin_meshes(dtype, nx=5, jitter=0.15, seed=11, classes=(0, 1)),
        256, dtype, tolerance=1e-6, integrity="warn", io_pipeline=io,
        n_groups=2)
    n = 256
    rng = np.random.default_rng(4)
    cents = pt.mesh.centroids().double().numpy()
    pos = cents[rng.integers(0, pt.mesh.ntet, n)]
    for t in (jt, pt):
        t.initialize_particle_location(pos.ravel().copy())
    prev_pos = pos
    prev_flux = pt.raw_flux[..., 0].astype(np.float64).sum()
    for mv in range(1, 3):
        inputs = _inputs(rng, n)
        outs = move_both((jt, pt), inputs)
        w = inputs[2]
        out = outs[1][0].reshape(n, 3)
        rec = [r for r in _records(pt, "integrity") if r["move"] == mv][-1]
        assert rec["violations"] == []
        assert rec["lanes_flying"] == n and rec["lanes_done"] == n
        oracle = float((w * np.linalg.norm(out - prev_pos, axis=1)).sum())
        scale = max(1.0, oracle)
        assert rec["path_wlen"] == pytest.approx(oracle, abs=tol * scale)
        assert rec["scored_wlen"] == pytest.approx(oracle, abs=tol * scale)
        flux_now = pt.raw_flux[..., 0].astype(np.float64).sum()
        assert rec["scored_wlen"] == pytest.approx(
            float(flux_now - prev_flux), abs=tol * scale)
        # The JAX facade's vector on the same move.
        jrec = [r for r in jt.telemetry()["per_move"]
                if r["kind"] == "integrity" and r["move"] == mv][-1]
        fields = {f: rec[f] for f in INTEGRITY_FIELDS}
        jfields = {f: jrec[f] for f in INTEGRITY_FIELDS}
        _assert_fields_close(fields, jfields, dtype)
        prev_pos, prev_flux = out.copy(), flux_now


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("initial", [False, True])
def test_integrity_vector_matches_jax_on_the_same_walk(dtype, initial):
    """One walk of the port (some lanes parked, some truncated, a
    negative and a NaN flux entry planted): the port's vector and the JAX
    package's integrity_vector of the same outputs."""
    jm, pm = twin_meshes(dtype, nx=4, jitter=0.2, seed=3, classes=(0, 1))
    rng = np.random.default_rng(9)
    n = 200
    elem = rng.integers(0, pm.ntet, n).astype(np.int32)
    origin = pm.centroids()[torch.as_tensor(elem).long()]
    dest = torch.as_tensor(rng.uniform(0.02, 0.98, (n, 3)), dtype=dtype)
    fly = torch.as_tensor(rng.random(n) < 0.8)
    weight = torch.as_tensor(rng.uniform(0.5, 2.0, n), dtype=dtype)
    flux = torch.zeros(pm.ntet * 2 * 2, dtype=dtype)
    flux[5], flux[9] = -1.0, float("nan")
    r = walk.trace(pm, origin, dest, torch.as_tensor(elem), fly, weight,
                   torch.as_tensor(rng.integers(0, 2, n), dtype=torch.int32),
                   torch.full((n,), -1, dtype=torch.int32), flux,
                   initial=initial, max_crossings=6, n_groups=2,
                   integrity=True)
    assert not bool(r.done[fly].all())  # some lanes truncated
    want = np.asarray(jintegrity_vector(
        jnp.asarray(fly.numpy()), jnp.asarray(r.done.numpy()),
        jnp.asarray(weight.numpy()), jnp.asarray(r.track_length.numpy()),
        jnp.asarray(r.position.numpy()), jnp.asarray(origin.numpy()),
        jnp.asarray(r.flux.numpy()), JDT[dtype], initial))
    assert r.integrity.dtype == dtype
    got = integrity_to_dict(r.integrity.numpy())
    _assert_fields_close(got, integrity_to_dict(want), dtype)
    assert got["bad_flux"] == 2


@pytest.mark.parametrize("io", ["packed", "legacy"])
def test_rewalk_merges_the_integrity_vector(io):
    """A truncated move re-walked (truncation_retries): the merged vector
    closes the lane count (lanes_flying the move's, lanes_done every
    finisher), as the JAX merge does (both packages with unroll=1, so the
    JAX walk checks the crossing bound every iteration, as the port's)."""
    jt, pt = twin_tallies(twin_meshes(torch.float64, nx=4), N,
                          max_crossings=3, truncation_retries=3,
                          integrity="warn", unroll=1, io_pipeline=io)
    rng = np.random.default_rng(2)
    pos = rng.uniform(0.1, 0.9, (N, 3)).ravel()
    for t in (jt, pt):
        t.initialize_particle_location(pos.copy())
    move_both((jt, pt), _inputs(rng))
    rec = _records(pt, "integrity")[-1]
    assert rec["violations"] == []
    assert rec["lanes_flying"] == rec["lanes_done"] == N
    assert pt.telemetry()["totals"]["rewalked"] > 0
    jrec = [r for r in jt.telemetry()["per_move"]
            if r["kind"] == "integrity"][-1]
    _assert_fields_close({f: rec[f] for f in INTEGRITY_FIELDS},
                         {f: jrec[f] for f in INTEGRITY_FIELDS},
                         torch.float64)


# ===================================================================== #
# bitflip_flux → the flux check
# ===================================================================== #
def test_bitflip_flux_detected_and_warned(meshes, monkeypatch):
    monkeypatch.setenv("PUMI_TPU_FAULTS", "bitflip_flux:1")
    jt, pt = twin_tallies(meshes, N, integrity="warn")
    rng = np.random.default_rng(42)
    pos = rng.uniform(0.1, 0.9, (N, 3)).ravel()
    for t in (jt, pt):
        t.initialize_particle_location(pos.copy())
    move_both((jt, pt), _inputs(rng))  # the flip lands after move 1
    # The JAX hook's entry, the JAX hook's bit.
    ours, theirs = pt.raw_flux.reshape(-1), np.asarray(jt.raw_flux).reshape(-1)
    np.testing.assert_array_equal(np.nonzero(ours < 0)[0],
                                  np.nonzero(theirs < 0)[0])
    assert (ours < 0).sum() == 1
    inputs = _inputs(rng)
    with pytest.warns(RuntimeWarning, match="integrity violation"):
        move_both((jt, pt), inputs)
    for t in (jt, pt):
        assert t.telemetry()["integrity"]["violations"].get("flux", 0) >= 1
        inj = t.metrics.counter("pumi_injected_faults_total")
        assert inj.value(kind="bitflip_flux") == 1


def test_bitflip_of_an_empty_accumulator_writes_nan(meshes, monkeypatch):
    """Before any score lands (a move of parked lanes), the hook writes
    NaN into entry 0, as the JAX hook does."""
    monkeypatch.setenv("PUMI_TPU_FAULTS", "bitflip_flux:1")
    t = _tally(meshes, integrity="warn")
    rng = np.random.default_rng(1)
    t.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    dest, fly, w, g, mats = _inputs(rng)
    t.move_to_next_location(dest, np.zeros(N, np.int8), w, g, mats)
    flat = t.raw_flux.reshape(-1)
    assert np.isnan(flat[0]) and not np.isnan(flat[1:]).any()
    with pytest.warns(RuntimeWarning, match="flux"):
        t.move_to_next_location(*_inputs(rng))


def test_bitflip_flux_halt_flushes_last_good(meshes, monkeypatch, tmp_path):
    monkeypatch.setenv("PUMI_TPU_FAULTS", "bitflip_flux:1")
    t = _tally(meshes, integrity="halt")
    rng = np.random.default_rng(42)
    run = ResilientRunner(t, str(tmp_path / "cks"), every_moves=1000,
                          handle_signals=False, sleep=lambda s: None)
    run.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    run.move_to_next_location(*_inputs(rng))
    with pytest.raises(FatalIntegrityViolation) as exc:
        run.move_to_next_location(*_inputs(rng))
    assert "flux" in exc.value.checks
    latest = run.store.find_latest()
    assert latest is not None and latest[0] == 1


def test_bitflip_retry_policy_exhausts_and_propagates(
    meshes, monkeypatch, tmp_path
):
    monkeypatch.setenv("PUMI_TPU_FAULTS", "bitflip_flux:1")
    t = _tally(meshes, integrity="retry")
    rng = np.random.default_rng(42)
    run = ResilientRunner(t, str(tmp_path / "cks"), every_moves=1000,
                          handle_signals=False, max_retries=2,
                          sleep=lambda s: None)
    run.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    run.move_to_next_location(*_inputs(rng))
    with pytest.raises(TransientIntegrityViolation):
        run.move_to_next_location(*_inputs(rng))
    assert t.metrics.counter("pumi_move_retries_total").value() == 2


# ===================================================================== #
# sdc_walk → the shadow audit
# ===================================================================== #
def test_sdc_walk_caught_by_shadow_audit(meshes, monkeypatch):
    monkeypatch.setenv("PUMI_TPU_FAULTS", "sdc_walk:2")
    jt, pt = twin_tallies(meshes, N, integrity="warn", audit_lanes=4)
    rng = np.random.default_rng(42)
    pos = rng.uniform(0.1, 0.9, (N, 3)).ravel()
    for t in (jt, pt):
        t.initialize_particle_location(pos.copy())
    move_both((jt, pt), _inputs(rng))  # a clean audit
    with pytest.warns(RuntimeWarning, match="sdc_audit"):
        move_both((jt, pt), _inputs(rng))
    tm = pt.telemetry()["integrity"]
    assert tm["violations"].get("sdc_audit", 0) == 1
    assert tm["audit_mismatches"] == 1
    assert tm["audited_lanes"] >= 8
    audits = _records(pt, "audit")
    assert [a["mismatches"] for a in audits] == [0, 1]
    inj = pt.metrics.counter("pumi_injected_faults_total")
    assert inj.value(kind="sdc_walk") == 1
    # Both packages audited the same lanes: the same counts, and the
    # clean move's deviation agrees.
    jaudits = [r for r in jt.telemetry()["per_move"] if r["kind"] == "audit"]
    for a, b in zip(audits, jaudits):
        assert (a["audited"], a["mismatches"], a["skipped"]) == (
            b["audited"], b["mismatches"], b["skipped"])
    assert audits[0]["max_dev"] == pytest.approx(jaudits[0]["max_dev"],
                                                 abs=1e-12)


def test_audit_samples_the_jax_facades_lanes(meshes):
    """The sample is np.random.default_rng([audit_seed, move]) over the
    lanes that flew and finished, as in the JAX facade: after an element
    sort (slot order differs from particle order) the port's audit still
    takes the same particles."""
    jt, pt = twin_tallies(meshes, N, integrity="warn", audit_lanes=8,
                          audit_seed=5, sort_by_element=True,
                          migration_period=1)
    rng = np.random.default_rng(8)
    pos = rng.uniform(0.1, 0.9, (N, 3)).ravel()
    for t in (jt, pt):
        t.initialize_particle_location(pos.copy())
    for _ in range(3):
        move_both((jt, pt), _inputs(rng))
    assert pt._perm is not None
    ours, theirs = _records(pt, "audit"), [
        r for r in jt.telemetry()["per_move"] if r["kind"] == "audit"]
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert (a["audited"], a["mismatches"], a["skipped"]) == (
            b["audited"], b["mismatches"], b["skipped"])
        assert a["max_dev"] == pytest.approx(b["max_dev"], abs=1e-12)


# ===================================================================== #
# hang_at_move → the watchdog
# ===================================================================== #
def test_hang_watchdog_rearm_bitwise_identical(meshes, monkeypatch,
                                               tmp_path):
    ref = _tally(meshes)
    ref_outs = _drive(ref, moves=3, seed=9)
    monkeypatch.setenv("PUMI_TPU_FAULTS", "hang_at_move:2,hang_seconds:1.0")
    t = _tally(meshes, move_deadline_s=0.25)
    run = ResilientRunner(t, str(tmp_path / "cks"), every_moves=1000,
                          handle_signals=False, sleep=lambda s: None)
    rng = np.random.default_rng(9)
    run.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    outs = []
    for _ in range(3):
        dest, fly, w, g, mats = _inputs(rng)
        run.move_to_next_location(dest, fly, w, g, mats)
        outs.append((dest.reshape(N, 3).copy(), mats.copy()))
    assert t.metrics.counter("pumi_move_retries_total").value() == 1
    assert t.telemetry()["integrity"]["violations"]["watchdog"] == 1
    for (pa, ma), (pb, mb) in zip(ref_outs, outs):
        np.testing.assert_array_equal(pb, pa)
        np.testing.assert_array_equal(mb, ma)
    np.testing.assert_array_equal(t.raw_flux, ref.raw_flux)


def test_hang_without_runner_propagates_timeout(meshes, monkeypatch):
    monkeypatch.setenv("PUMI_TPU_FAULTS", "hang_at_move:2,hang_seconds:1.0")
    t = _tally(meshes, move_deadline_s=0.25)
    rng = np.random.default_rng(3)
    t.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    t.move_to_next_location(*_inputs(rng))  # warm-up: no deadline
    with pytest.raises(DispatchTimeoutError):
        t.move_to_next_location(*_inputs(rng))


@pytest.mark.parametrize("io", ["packed", "overlap", "legacy"])
def test_deadline_passes_on_healthy_moves(meshes, io):
    ref = _tally(meshes, io_pipeline=io)
    t = _tally(meshes, io_pipeline=io, move_deadline_s=30.0)
    ref_outs = _drive(ref, moves=2, seed=5)
    outs = _drive(t, moves=2, seed=5)
    for (pa, ma), (pb, mb) in zip(ref_outs, outs):
        np.testing.assert_array_equal(pb, pa)
        np.testing.assert_array_equal(mb, ma)
    np.testing.assert_array_equal(t.raw_flux, ref.raw_flux)
    assert "watchdog" not in t.telemetry()["integrity"]["violations"]
    assert t.io == ref.io


# ===================================================================== #
# nan_src under the integrity layer
# ===================================================================== #
def test_nan_src_quarantined_with_clean_invariants(meshes, monkeypatch,
                                                   tmp_path):
    monkeypatch.setenv("PUMI_TPU_FAULTS", "nan_src:0.3,seed:7")
    t = _tally(meshes, integrity="warn", quarantine=True)
    run = ResilientRunner(t, str(tmp_path / "cks"), every_moves=1000,
                          handle_signals=False, sleep=lambda s: None)
    rng = np.random.default_rng(42)
    run.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    for _ in range(2):
        run.move_to_next_location(*_inputs(rng))
    tm = t.telemetry()
    assert tm["quarantined"] > 0
    assert np.isfinite(t.raw_flux).all()
    assert tm["integrity"]["violations"] == {}


# ===================================================================== #
# The megastep's integrity tail
# ===================================================================== #
def test_megastep_integrity_tail():
    from pumiumtally_tpu_torch.ops.source import SourceParams

    src = SourceParams(sigma_t={1: 4.0, 2: 9.0}, absorption={1: 0.3, 2: 0.5},
                       survival_weight=0.2, seed=13)
    _, pm = twin_meshes(torch.float64, nx=4, jitter=0.2, seed=11,
                        classes=(1, 2))
    pos = np.random.default_rng(3).uniform(0.1, 0.9, (N, 3)).ravel()

    def run(**kw):
        t = PumiTally(pm, N, TallyConfig(dtype=torch.float64, n_groups=2,
                                         megastep=2, **kw), device="cpu")
        t.initialize_particle_location(pos.copy())
        t.run_source_moves(4, src, weights=np.ones(N))
        return t

    off, on = run(), run(integrity="warn")
    np.testing.assert_array_equal(on.raw_flux, off.raw_flux)
    recs = _records(on, "integrity")
    assert [r["move"] for r in recs] == [0, 2, 4]
    assert all(r["violations"] == [] for r in recs)
    assert on.telemetry()["integrity"]["violations"] == {}
    # The chunk's scored sum is its moves' flux delta.
    flux = on.raw_flux[..., 0].sum()
    assert sum(r["scored_wlen"] for r in recs[1:]) == pytest.approx(
        flux, rel=1e-12)


def test_megastep_bitflip_detected(monkeypatch):
    from pumiumtally_tpu_torch.ops.source import SourceParams

    monkeypatch.setenv("PUMI_TPU_FAULTS", "bitflip_flux:2")
    _, pm = twin_meshes(torch.float64, nx=4, classes=(1, 2))
    t = PumiTally(pm, N, TallyConfig(dtype=torch.float64, megastep=2,
                                     integrity="halt"), device="cpu")
    t.initialize_particle_location(
        np.random.default_rng(3).uniform(0.1, 0.9, (N, 3)).ravel())
    src = SourceParams(sigma_t={1: 4.0, 2: 9.0}, seed=13)
    t.run_source_moves(2, src)  # the flip lands after this chunk
    with pytest.raises(FatalIntegrityViolation) as exc:
        t.run_source_moves(2, src)
    assert exc.value.checks == ("flux",)


# ===================================================================== #
# Fault grammar, config validation, rotation durability
# ===================================================================== #
def test_new_fault_grammar():
    p = parse_faults(
        "bitflip_flux:2,sdc_walk:3,hang_at_move:4,hang_seconds:0.5")
    assert (p.bitflip_flux, p.sdc_walk, p.hang_at_move) == (2, 3, 4)
    assert p.hang_seconds == 0.5 and p.any()
    with pytest.raises(ValueError, match="hang_seconds"):
        parse_faults("hang_seconds:0")
    with pytest.raises(ValueError, match="unknown fault"):
        parse_faults("bitflip:1")


@pytest.mark.parametrize("kw", [
    dict(), dict(integrity="warn"), dict(integrity="maybe"),
    dict(integrity="warn", ledger=False), dict(audit_lanes=4, ledger=False),
    dict(audit_every=0), dict(audit_lanes=-1), dict(move_deadline_s=0.0),
    dict(integrity="halt", audit_lanes=8, move_deadline_s=2.0),
])
def test_config_validation(kw):
    """resolve_integrity gives the JAX package's value or its ValueError
    message."""
    jkw = {k: v for k, v in kw.items()}
    try:
        want = jpt.TallyConfig(**jkw).resolve_integrity()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TallyConfig(**kw).resolve_integrity()
        assert str(got.value) == str(e)
        return
    assert TallyConfig(**kw).resolve_integrity() == want


def test_rotation_fsyncs_directory(meshes, tmp_path, monkeypatch):
    import pumiumtally_tpu_torch.resilience.store as store_mod

    calls = []
    monkeypatch.setattr(store_mod, "fsync_dir", lambda d: calls.append(d))
    store = CheckpointStore(str(tmp_path / "cks"), keep=1)
    t = _tally(meshes)
    rng = np.random.default_rng(0)
    t.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    store.save(t)
    assert not calls
    t.move_to_next_location(*_inputs(rng))
    store.save(t)
    assert calls == [store.directory]
    assert [it for it, _ in store.entries()] == [1]


def test_integrity_field_order_is_the_jax_packages():
    from pumiumtally_tpu.integrity import invariants as jinv

    assert INTEGRITY_FIELDS == jinv.INTEGRITY_FIELDS
    assert IIDX == jinv.IIDX


def test_run_with_deadline_passes_values_and_errors():
    """The watchdog: a value and an error pass through its worker thread
    unchanged, no deadline runs inline, and a call past its deadline
    raises the retryable timeout while the worker is abandoned."""
    import threading

    from pumiumtally_tpu_torch.integrity.watchdog import run_with_deadline

    assert run_with_deadline(lambda: threading.get_ident(), 5.0) != (
        threading.get_ident())
    assert run_with_deadline(lambda: threading.get_ident(), None) == (
        threading.get_ident())
    with pytest.raises(KeyError):
        run_with_deadline(lambda: {}["x"], 5.0)
    release = threading.Event()
    with pytest.raises(DispatchTimeoutError, match="move_deadline_s"):
        run_with_deadline(release.wait, 0.05)
    release.set()
