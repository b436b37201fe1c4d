"""Statistical convergence in the port (``obs/convergence.py``,
``TallyConfig.convergence``) on ``device="cpu"``.

Mirrors tests/test_convergence.py: the float64 batch-statistics oracle
in every ``io_pipeline`` mode (:138), the read-only contract (:216), one
H2D and one D2H a packed move with convergence on (:254), the early stop
at the expected batch (:295), the ``batch_moves`` cadence and
``end_batch`` (:333), the re-base of the batch history (:382, through
``_reset_convergence``; its checkpoint form is in
tests/test_torch_resilience.py), the VTK
uncertainty fields (:417), the config validation (:440) and the gauges
and per-batch records (:475). The same inputs go through the JAX facade:
its summary agrees with the port's at 1e-9 relative in float64 (the
tests' oracle tolerance), its flux at the parity bar (1e-10 relative).
The convergence tail of the readback holds the JAX package's bytes.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumiumtally_tpu.obs import convergence as jconv
from pumiumtally_tpu.ops import staging as jstaging
from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
from pumiumtally_tpu_torch.obs import convergence as conv
from pumiumtally_tpu_torch.ops import staging
from torch_twins import TOL, assert_tallies_agree, twin_meshes, twin_tallies

N = 96
TARGET = 0.3


def _cfg(io="packed", **kw):
    """Fields shared by the tests' configurations (the dtype is the
    caller's: ``twin_tallies`` passes its own)."""
    kw.setdefault("convergence", True)
    kw.setdefault("rel_err_target", TARGET)
    return dict(n_groups=2, io_pipeline=io, **kw)


def _port(pmesh, **kw):
    """A float64 port tally on the CPU with ``_cfg(**kw)``."""
    return PumiTally(pmesh, N, TallyConfig(dtype=torch.float64,
                                           tolerance=1e-8, **_cfg(**kw)),
                     device="cpu")


def _tol(dtype):
    return 1e-8 if dtype == torch.float64 else 1e-6


def _drive(tallies, moves=4, seed=17, evens=None):
    """``_drive`` of tests/test_convergence.py for several tallies on the
    same inputs; ``evens`` collects the last tally's per-move even (Σc)
    entries in float64."""
    rng = np.random.default_rng(seed)
    n = tallies[0].num_particles
    pos = rng.uniform(0.05, 0.95, (n, 3))
    for t in tallies:
        t.initialize_particle_location(pos.ravel().copy(), n * 3)
    outs, prev = [], pos
    for _ in range(moves):
        dest = np.clip(prev + rng.normal(0, 0.25, (n, 3)), -0.1, 1.1)
        flying = np.ones(n, np.int8)
        flying[::7] = 0
        w = rng.uniform(0.5, 2.0, n)
        g = rng.integers(0, 2, n).astype(np.int32)
        per = []
        for t in tallies:
            buf = dest.ravel().copy()
            mats = np.full(n, 9, np.int32)
            t.move_to_next_location(buf, flying.copy(), w, g, mats,
                                    buf.size)
            per.append((buf.reshape(n, 3).copy(), mats.copy()))
        outs.append(per)
        if evens is not None:
            evens.append(np.asarray(tallies[-1].raw_flux)[..., 0]
                         .astype(np.float64).reshape(-1))
        prev = per[-1][0]
    return outs


def _oracle(evens, target=TARGET):
    """Float64 batch statistics from per-move even snapshots (every move
    one batch)."""
    snaps = np.stack([np.zeros_like(evens[0])] + list(evens))
    T = np.diff(snaps, axis=0)
    B = T.shape[0]
    s1, s2 = T.sum(0), (T * T).sum(0)
    scored = s1 > 0
    rel = np.where(
        scored,
        np.sqrt(np.maximum(B * s2 - s1 * s1, 0.0) / max(B - 1, 1))
        / np.where(scored, s1, 1.0),
        0.0,
    )
    if B < 2:
        rel = np.where(scored, 1.0, 0.0)
    return {
        "n_batches": B,
        "scored": int(scored.sum()),
        "rel": rel,
        "rel_err_mean": float(rel.sum() / max(scored.sum(), 1)),
        "rel_err_max": float(rel.max(initial=0.0)),
        "converged_fraction": float(
            (scored & (rel <= target)).sum() / max(scored.sum(), 1)),
    }


# --------------------------------------------------------------------- #
# Oracle parity, every io_pipeline mode (:138)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "dtype,io,rtol",
    [
        (torch.float64, "legacy", 1e-9),
        (torch.float64, "packed", 1e-9),
        (torch.float64, "overlap", 1e-9),
        (torch.float32, "packed", 3e-2),
    ],
)
def test_single_chip_matches_float64_oracle(dtype, io, rtol, monkeypatch):
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    meshes = twin_meshes(dtype, jitter=0.2, classes=(1, 2))
    jt, pt = twin_tallies(meshes, N, dtype, tolerance=_tol(dtype),
                          **_cfg(io))
    evens = []
    _drive((jt, pt), moves=4, evens=evens)
    assert_tallies_agree(jt, pt, dtype)
    want = _oracle(evens)
    got = pt.telemetry()["convergence"]
    assert got["enabled"] and got["n_batches"] == want["n_batches"]
    assert got["scored"] == want["scored"]
    np.testing.assert_allclose(got["rel_err_mean"], want["rel_err_mean"],
                               rtol=rtol)
    np.testing.assert_allclose(got["rel_err_max"], want["rel_err_max"],
                               rtol=rtol)
    near = int((np.abs(want["rel"] - TARGET) < 1e3 * rtol * TARGET).sum())
    assert abs(got["converged_fraction"] * got["scored"]
               - want["converged_fraction"] * want["scored"]) <= near
    assert got["fom"] > 0
    np.testing.assert_allclose(pt.relative_error().reshape(-1),
                               want["rel"], rtol=rtol, atol=rtol)
    theirs = jt.telemetry()["convergence"]
    assert got["n_batches"] == theirs["n_batches"]
    if dtype == torch.float64:
        assert got["scored"] == theirs["scored"]
        for key in ("rel_err_mean", "rel_err_max", "converged_fraction"):
            np.testing.assert_allclose(got[key], theirs[key], rtol=1e-9)
        np.testing.assert_allclose(pt.relative_error(),
                                   jt.relative_error(), rtol=1e-9,
                                   atol=1e-12)


# --------------------------------------------------------------------- #
# Read-only and one transfer each way (:216, :254)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("io", ["packed", "overlap", "legacy"])
def test_outputs_bit_identical_with_convergence_on(io, monkeypatch):
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    pmesh = twin_meshes(jitter=0.2, classes=(1, 2))[1]
    a, b = _port(pmesh, io=io, convergence=False), _port(pmesh, io=io)
    for (pa, ma), (pb, mb) in _drive((a, b), moves=3):
        np.testing.assert_array_equal(pb, pa)
        np.testing.assert_array_equal(mb, ma)
    np.testing.assert_array_equal(b.raw_flux, a.raw_flux)
    np.testing.assert_array_equal(b.element_ids, a.element_ids)


def test_steady_state_one_transfer_each_way_with_convergence(monkeypatch):
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    t = PumiTally(build_box(1.0, 1.0, 1.0, 3, 3, 3, device="cpu"), 64,
                  TallyConfig(tolerance=1e-6, convergence=True,
                              rel_err_target=TARGET), device="cpu")
    rng = np.random.default_rng(0)
    t.initialize_particle_location(rng.uniform(0.1, 0.9, (64, 3)).ravel())

    def move():
        t.move_to_next_location(
            rng.uniform(0.1, 0.9, 64 * 3), np.ones(64, np.int8),
            rng.uniform(0.5, 2.0, 64),
            rng.integers(0, 2, 64).astype(np.int32),
            np.full(64, -1, np.int32))

    move()
    totals = t.telemetry()["totals"]
    h0, d0 = totals["h2d_transfers"], totals["d2h_transfers"]
    move()
    totals = t.telemetry()["totals"]
    assert (totals["h2d_transfers"] - h0, totals["d2h_transfers"] - d0) \
        == (1, 1)
    assert t.telemetry()["convergence"]["n_batches"] == 2


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_readback_with_convergence_tail_is_the_jax_bytes(dtype):
    """The summary rides the readback as walk-dtype floats in carrier
    words after the stats tail, as the JAX package packs it, and comes
    back bit for bit."""
    np_dt = {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    rng = np.random.default_rng(2)
    n = 11
    pos = rng.uniform(-1, 2, (n, 3)).astype(np_dt)
    mats = rng.integers(-1, 5, n).astype(np.int32)
    done = rng.uniform(size=n) > 0.3
    stats = rng.integers(0, 2**40, 8).astype(np.int64)
    vec = np.array([3, 2**20 + 1, 123.456, 0.987, 7], np_dt)
    args = (pos, mats, done, stats, np.int64(5))
    rb = staging.pack_trace_readback(
        *(torch.as_tensor(a) for a in args),
        convergence=torch.as_tensor(vec))
    jrb = np.asarray(jstaging.pack_trace_readback(
        *(jnp.asarray(a) for a in args), None, None, jnp.asarray(vec)))
    assert rb.numpy().tobytes() == jrb.tobytes()
    p, m, d, tail, integ, c = staging.split_trace_readback(
        rb, n, dtype, convergence=True)
    assert integ is None
    np.testing.assert_array_equal(tail, stats)
    np.testing.assert_array_equal(c, vec.astype(np.float64))
    assert np.ascontiguousarray(p).tobytes() == pos.tobytes()
    np.testing.assert_array_equal(m, mats)
    np.testing.assert_array_equal(d, done)


@pytest.mark.parametrize("batch_moves", [1, 3])
def test_fold_and_reduce_matches_jax(batch_moves):
    """Five moves of a growing accumulator folded by both packages'
    ``fold_and_reduce``: the batch accumulators bitwise, the summary at
    the float64 parity bar."""
    rng = np.random.default_rng(6)
    nbins = 200
    flux = np.zeros(2 * nbins)
    state = conv.ConvState.zeros(nbins, torch.float64, "cpu")
    jstate = (jnp.zeros(nbins), jnp.zeros(nbins),
              jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
    for _ in range(5):
        add = rng.exponential(1.0, nbins) * (rng.uniform(size=nbins) < 0.6)
        flux[0::2] += add
        flux[1::2] += add * add
        vec = conv.fold_and_reduce(torch.from_numpy(flux), state,
                                   batch_moves=batch_moves,
                                   rel_err_target=TARGET)
        jstate, jvec = jconv.fold_and_reduce(
            jnp.asarray(flux), *jstate, batch_moves=batch_moves,
            rel_err_target=TARGET)
        np.testing.assert_array_equal(state.snap.numpy(),
                                      np.asarray(jstate[0]))
        np.testing.assert_array_equal(state.sumsq.numpy(),
                                      np.asarray(jstate[1]))
        assert state.n_batches == int(jstate[2])
        assert state.moves == int(jstate[3])
        np.testing.assert_allclose(vec.numpy(), np.asarray(jvec),
                                   rtol=1e-12, atol=0)
        assert conv.conv_to_dict(vec) == pytest.approx(
            jconv.conv_to_dict(np.asarray(jvec)), rel=1e-12)
    # The explicit close: force a batch now, restart the cadence.
    vec = conv.fold_and_reduce(torch.from_numpy(flux), state,
                               batch_moves=batch_moves,
                               rel_err_target=TARGET, force=True)
    jstate, jvec = jconv.end_batch_fold(jnp.asarray(flux), *jstate,
                                       rel_err_target=TARGET)
    assert (state.n_batches, state.moves) == (int(jstate[2]),
                                              int(jstate[3]))
    np.testing.assert_allclose(vec.numpy(), np.asarray(jvec), rtol=1e-12)


# --------------------------------------------------------------------- #
# Early stop, cadence, explicit batches, re-base (:295, :333, :382)
# --------------------------------------------------------------------- #
def test_converged_flips_at_expected_batch_count():
    """Each move retraces the same chord, so every batch's totals are
    equal to rounding: the estimator is defined from batch 2 on, and
    converged() must flip exactly there."""
    n = 8
    t = PumiTally(
        build_box(1.0, 1.0, 1.0, 3, 3, 3, dtype=torch.float64, device="cpu"),
        n, TallyConfig(dtype=torch.float64, tolerance=1e-8,
                       convergence=True, rel_err_target=0.01,
                       converged_fraction=1.0), device="cpu")
    rng = np.random.default_rng(5)
    a = rng.uniform(0.15, 0.45, (n, 3))
    b = a + 0.35
    t.initialize_particle_location(a.ravel().copy())
    for move in range(4):
        buf = (b if move % 2 == 0 else a).ravel().copy()
        t.move_to_next_location(buf, np.ones(n, np.int8), np.ones(n),
                                np.zeros(n, np.int32),
                                np.full(n, -1, np.int32))
        assert t.converged() == (move + 1 >= 2), move
    c = t.telemetry()["convergence"]
    assert c["n_batches"] == 4
    assert c["rel_err_max"] <= 1e-6
    assert c["converged_fraction"] == 1.0


def test_batch_moves_cadence_and_explicit_end_batch(monkeypatch):
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    meshes = twin_meshes(jitter=0.2, classes=(1, 2))
    jt, pt = twin_tallies(meshes, N, tolerance=1e-8, **_cfg(batch_moves=3))
    evens = []
    _drive((jt, pt), moves=4, evens=evens)
    c = pt.telemetry()["convergence"]
    assert c["n_batches"] == 1 and c["batch_moves"] == 3
    out, jout = pt.end_batch(), jt.end_batch()
    assert out["n_batches"] == jout["n_batches"] == 2
    snaps = np.stack([np.zeros_like(evens[0]), evens[2], evens[3]])
    T = np.diff(snaps, axis=0)
    s1, s2 = T.sum(0), (T * T).sum(0)
    scored = s1 > 0
    rel = np.where(scored, np.sqrt(np.maximum(2 * s2 - s1 * s1, 0.0))
                   / np.where(scored, s1, 1.0), 0.0)
    np.testing.assert_allclose(out["rel_err_max"], rel.max(), rtol=1e-9)
    np.testing.assert_allclose(out["rel_err_mean"], jout["rel_err_mean"],
                               rtol=1e-9)
    rng = np.random.default_rng(23)

    def more(moves):
        for _ in range(moves):
            dest = rng.uniform(0.05, 0.95, (N, 3)).ravel()
            pt.move_to_next_location(dest.copy(), np.ones(N, np.int8),
                                     np.ones(N), np.zeros(N, np.int32),
                                     np.full(N, 9, np.int32))

    more(2)
    assert pt.telemetry()["convergence"]["n_batches"] == 2
    more(1)
    assert pt.telemetry()["convergence"]["n_batches"] == 3


def test_reset_rebases_batch_statistics():
    """Re-basing (what a checkpoint restore does) restarts the batch
    history on the current accumulator: no batches, not converged, and
    the next batches count from the restored flux."""
    pmesh = twin_meshes(jitter=0.2, classes=(1, 2))[1]
    t = _port(pmesh)
    _drive((t,), moves=3)
    assert t.telemetry()["convergence"]["n_batches"] == 3
    t._reset_convergence()
    c = t.telemetry()["convergence"]
    assert c["n_batches"] == 0 and not t.converged()
    assert torch.equal(t._conv.snap, t.flux[0::2])
    _drive((t,), moves=2, seed=29)
    assert t.telemetry()["convergence"]["n_batches"] == 2
    assert t.relative_error().shape == (pmesh.ntet, 2)


# --------------------------------------------------------------------- #
# Uncertainty export, validation, gauges (:417, :440, :475)
# --------------------------------------------------------------------- #
def test_vtk_uncertainty_field(tmp_path):
    pmesh = twin_meshes(jitter=0.2, classes=(1, 2))[1]
    t = _port(pmesh)
    _drive((t,), moves=2)
    text = open(t.write_pumi_tally_mesh(str(tmp_path / "flux.vtu"),
                                        uncertainty=True)).read()
    assert 'Name="flux_group_0"' in text
    assert 'Name="rel_err_group_0"' in text
    assert 'Name="rel_err_group_1"' in text
    plain = t.write_pumi_tally_mesh(str(tmp_path / "plain.vtu"))
    assert "rel_err_group" not in open(plain).read()
    off = _port(pmesh, convergence=False)
    _drive((off,), moves=1)
    with pytest.raises(ValueError, match="convergence"):
        off.write_pumi_tally_mesh(str(tmp_path / "no.vtu"),
                                  uncertainty=True)


def test_config_validation():
    assert TallyConfig().resolve_convergence() is None
    assert TallyConfig(convergence=True).resolve_convergence() == 1
    assert TallyConfig(convergence=True,
                       batch_moves=5).resolve_convergence() == 5
    with pytest.raises(ValueError, match="batch_moves"):
        TallyConfig(batch_moves=4).resolve_convergence()
    with pytest.raises(ValueError, match="rel_err_target"):
        TallyConfig(convergence=True,
                    rel_err_target=0.0).resolve_convergence()
    with pytest.raises(ValueError, match="converged_fraction"):
        TallyConfig(convergence=True,
                    converged_fraction=1.5).resolve_convergence()
    with pytest.raises(ValueError, match="batch_moves"):
        TallyConfig(convergence=True, batch_moves=0).resolve_convergence()
    with pytest.raises(ValueError, match="sd_mode"):
        TallyConfig(sd_mode="bogus")
    with pytest.raises(ValueError, match="truncation_retries"):
        TallyConfig(truncation_retries=-1)
    t = PumiTally(build_box(1.0, 1.0, 1.0, 2, 2, 2, device="cpu"), 8,
                  TallyConfig(tolerance=1e-6), device="cpu")
    for call in (t.converged, t.end_batch, t.relative_error):
        with pytest.raises(ValueError, match="convergence"):
            call()


def test_gauges_and_per_batch_flight_records():
    meshes = twin_meshes(jitter=0.2, classes=(1, 2))
    jt, pt = twin_tallies(meshes, N, tolerance=1e-8, **_cfg())
    _drive((jt, pt), moves=3)
    text = pt.metrics.render_prometheus()
    for name in ("pumi_rel_err_max", "pumi_rel_err_mean",
                 "pumi_converged_fraction", "pumi_fom",
                 "pumi_batches_total"):
        assert name in text, name
        assert (pt.metrics.snapshot()[name]["help"]
                == jt.metrics.snapshot()[name]["help"])
    assert pt.metrics.counter("pumi_batches_total").value() == 3
    recs = [r for r in pt.telemetry()["per_move"]
            if r["kind"] == "convergence"]
    assert [r["batch"] for r in recs] == [1, 2, 3]
    jrecs = [r for r in jt.telemetry()["per_move"]
             if r["kind"] == "convergence"]
    for r, jr in zip(recs, jrecs):
        assert r["scored"] == jr["scored"]
        assert r["rel_err_mean"] == pytest.approx(jr["rel_err_mean"],
                                                  rel=1e-8)
    assert all("rel_err_mean" in r and "fom" in r for r in recs)
    missing = [name for name, m in pt.metrics.snapshot().items()
               if not m["help"]]
    assert not missing
    _, rtol, atol = TOL[torch.float64]
    np.testing.assert_allclose(pt.raw_flux, jt.raw_flux, rtol=rtol,
                               atol=atol)
