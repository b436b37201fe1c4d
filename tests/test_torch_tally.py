"""The port's tally math on ``device="cpu"``: the sd estimators
(``sd_mode="segment"`` and ``"batch"``), ``accumulate_batch_squares``,
the reaction rate, and ``sd_mode="batch"`` through the facade.

Mirrors the analytic oracles of tests/test_tally_oracle.py (:171, the
segment sd; :283, the batch sd; :334, batch sd through the facade) and
the reaction-rate tests of tests/test_multitally_depletion.py (:42, :54)
and tests/test_flat_flux.py (:114). The oracles hold at the JAX tests'
tolerances (the finite-sample identities at 1e-8 relative, the analytic
values within their sampling error); against the JAX package the same
inputs give the same numbers at the float64 parity bar (1e-10
relative), and bitwise where the arithmetic is the same elementwise
operation.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumiumtally_tpu.core import tally as jtally
from pumiumtally_tpu_torch.core.tally import (
    accumulate_batch_squares,
    normalize_flux_host,
    reaction_rate,
    reaction_rate_host,
)
from torch_twins import assert_tallies_agree, move_both, twin_meshes, twin_tallies


# --------------------------------------------------------------------- #
# Analytic variance oracles (tests/test_tally_oracle.py :171, :283)
# --------------------------------------------------------------------- #
def test_sd_matches_analytic_variance():
    """N particles each make M moves; in one tet of volume V every
    (particle, move) scores y = w·L with Var(w) = 1/12, so the flux's sd
    is L·sqrt(M·Var(w)/N)/V. The exact finite-sample identity holds to
    rounding and the analytic value within sampling error; the
    reference's sqrt(m2 − m1²) is NaN under multi-move accumulation."""
    rng = np.random.default_rng(123)
    N, M = 40_000, 7
    L, V = 0.25, 1.0 / 6.0
    w = rng.uniform(0.5, 1.5, (N, M))
    y = (w * L).reshape(-1)
    flux = np.zeros((1, 1, 2))
    flux[0, 0, 0] = y.sum()
    flux[0, 0, 1] = (y * y).sum()

    norm = normalize_flux_host(flux, np.asarray([V]), N, M)
    got_sd = norm[0, 0, 2]
    h = N * M
    s2y = ((y * y).sum() - y.sum() ** 2 / h) / (h - 1)
    assert got_sd == pytest.approx(np.sqrt(M * s2y / N) / V, rel=1e-8)
    assert got_sd == pytest.approx(L * np.sqrt(M / (12 * N)) / V, rel=0.05)
    m1 = flux[0, 0, 0] / (V * N)
    m2 = flux[0, 0, 1] / (V * V * N)
    assert m2 - m1 * m1 < 0
    assert norm[0, 0, 0] == pytest.approx(M * 1.0 * L / V, rel=0.01)
    jnorm = np.asarray(jtally.normalize_flux(
        jnp.asarray(flux), jnp.asarray([V]), N, M))
    np.testing.assert_allclose(norm, jnorm, rtol=1e-10, atol=0)


def test_batch_sd_matches_analytic_variance():
    """Batch mode reads slot 1 as Σ T² of the M per-move bin totals: the
    finite-sample identity sd = sqrt(M·s²_T)/(V·N) holds to rounding, and
    the analytic sd within the estimator's own noise, 1/sqrt(2(M−1))."""
    rng = np.random.default_rng(321)
    N, M = 40_000, 64
    L, V = 0.25, 1.0 / 6.0
    t = (rng.uniform(0.5, 1.5, (N, M)) * L).sum(axis=0)
    flux = np.zeros((1, 1, 2))
    flux[0, 0, 0] = t.sum()
    flux[0, 0, 1] = (t * t).sum()

    norm = normalize_flux_host(flux, np.asarray([V]), N, M, sd_mode="batch")
    got_sd = norm[0, 0, 2]
    s2t = ((t * t).sum() - t.sum() ** 2 / M) / (M - 1)
    assert got_sd == pytest.approx(np.sqrt(M * s2t) / (V * N), rel=1e-8)
    sd_true = L * np.sqrt(M / (12 * N)) / V
    assert got_sd == pytest.approx(sd_true, rel=4 / np.sqrt(2 * (M - 1)))
    assert norm[0, 0, 0] == pytest.approx(M * 1.0 * L / V, rel=0.01)
    jnorm = np.asarray(jtally.normalize_flux(
        jnp.asarray(flux), jnp.asarray([V]), N, M, sd_mode="batch"))
    np.testing.assert_allclose(norm, jnorm, rtol=1e-10, atol=0)


@pytest.mark.parametrize("sd_mode", ["segment", "batch"])
def test_normalize_matches_jax_on_random_tallies(sd_mode):
    rng = np.random.default_rng(4)
    flux = rng.uniform(0, 3, (50, 3, 2))
    flux[..., 1] *= flux[..., 0]
    flux[:5] = 0.0  # unscored bins
    vols = rng.uniform(0.01, 0.1, 50)
    got = normalize_flux_host(flux, vols, 300, 6, sd_mode=sd_mode)
    want = jtally.normalize_flux_host(flux, vols, 300, 6, sd_mode=sd_mode)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    with pytest.raises(ValueError, match="sd_mode"):
        normalize_flux_host(flux, vols, 300, 6, sd_mode="bogus")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_accumulate_batch_squares_matches_jax(dtype):
    """Three moves' worth of growing even entries folded one move at a
    time, in place, against the JAX fold on the same inputs: the same
    two elementwise operations, bitwise equal."""
    rng = np.random.default_rng(9)
    nbins = 97
    np_dt = {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    flux = np.zeros(2 * nbins, np_dt)
    prev = np.zeros(nbins, np_dt)
    ours_f = torch.from_numpy(flux.copy())
    ours_p = torch.from_numpy(prev.copy())  # JAX may alias prev
    jf, jp = jnp.asarray(flux), jnp.asarray(prev)
    for _ in range(3):
        add = rng.uniform(0, 1, nbins).astype(np_dt)
        add[rng.uniform(size=nbins) < 0.3] = 0
        ours_f[0::2] += torch.from_numpy(add)
        jf = jf.at[0::2].add(jnp.asarray(add))
        out_f, out_p = accumulate_batch_squares(ours_f, ours_p)
        assert out_f is ours_f and out_p is ours_p  # in place
        jf, jp = jtally.accumulate_batch_squares(jf, jp)
        np.testing.assert_array_equal(ours_f.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(ours_p.numpy(), np.asarray(jp))


# --------------------------------------------------------------------- #
# Reaction rates (tests/test_multitally_depletion.py :42, :54;
# tests/test_flat_flux.py :114)
# --------------------------------------------------------------------- #
def _driven(n=48, n_groups=3, moves=4, seed=0, **cfg):
    jt, pt = twin_tallies(twin_meshes(nx=3, classes=(0, 1)), n,
                          n_groups=n_groups, tolerance=1e-8, **cfg)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.1, 0.9, (n, 3)).ravel()
    for t in (jt, pt):
        t.initialize_particle_location(pos.copy())
    for _ in range(moves):
        move_both((jt, pt), (
            rng.uniform(0.05, 0.95, (n, 3)).ravel(), np.ones(n, np.int8),
            rng.uniform(0.5, 2.0, n),
            rng.integers(0, n_groups, n).astype(np.int32),
            np.full(n, -1, np.int32)))
    assert_tallies_agree(jt, pt)
    return jt, pt


def test_reaction_rate_identity():
    jt, pt = _driven()
    sigma = np.array([[0.5, 1.0, 2.0], [3.0, 0.25, 0.0]])
    rr = pt.reaction_rate(sigma)
    flux = pt.raw_flux
    cid = pt.mesh.class_id.numpy()
    np.testing.assert_allclose(rr[..., 0], flux[..., 0] * sigma[cid],
                               rtol=1e-12)
    np.testing.assert_allclose(rr[..., 1], flux[..., 1] * sigma[cid] ** 2,
                               rtol=1e-12)
    np.testing.assert_allclose(rr, jt.reaction_rate(sigma), rtol=1e-10,
                               atol=1e-12)


def test_reaction_rate_out_of_range_region_scores_zero():
    jt, pt = _driven()
    sigma = np.array([[1.0, 1.0, 1.0]])  # only region 0 covered
    rr = pt.reaction_rate(sigma)
    cid = pt.mesh.class_id.numpy()
    assert np.all(rr[cid == 1] == 0.0)
    assert rr[cid == 0, :, 0].sum() > 0
    np.testing.assert_allclose(rr, jt.reaction_rate(sigma), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reaction_rate_torch_matches_host_and_jax(dtype):
    rng = np.random.default_rng(0)
    np_dt = {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    flux = rng.uniform(0, 2, (40, 4, 2)).astype(np_dt)
    cid = rng.integers(-1, 4, 40).astype(np.int32)  # -1 and 3: no region
    sigma = rng.uniform(0.1, 2.0, (3, 4)).astype(np_dt)
    dev = reaction_rate(torch.from_numpy(flux), torch.from_numpy(cid),
                        torch.from_numpy(sigma)).numpy()
    host = reaction_rate_host(flux, cid, sigma)
    np.testing.assert_array_equal(dev, host)
    jdev = np.asarray(jtally.reaction_rate(
        jnp.asarray(flux), jnp.asarray(cid), jnp.asarray(sigma)))
    np.testing.assert_array_equal(host, jtally.reaction_rate_host(
        flux, cid, sigma))
    np.testing.assert_allclose(dev, jdev, rtol=1e-6 if dtype ==
                               torch.float32 else 1e-12, atol=0)
    assert (dev[(cid < 0) | (cid >= 3)] == 0).all()


def test_reaction_rate_refused_under_batch_sd():
    _, pt = _driven(moves=1, sd_mode="batch")
    with pytest.raises(NotImplementedError, match="sd_mode='segment'"):
        pt.reaction_rate(np.ones((2, 3)))


# --------------------------------------------------------------------- #
# sd_mode="batch" through the facade (tests/test_tally_oracle.py :334)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("io", ["packed", "legacy"])
def test_batch_sd_mode_through_facade(io, monkeypatch):
    """Batch mode gives the segment run's mean accumulator bit for bit;
    slot 1 holds Σ over moves of the squared bin totals (a float64 host
    recomputation from the per-move even entries, and the JAX facade's
    value, at 1e-10 relative); the sd estimates the segment sd within the
    batch estimator's noise."""
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    meshes = twin_meshes(nx=4)
    pmesh = meshes[1]
    cents = (pmesh.coords[pmesh.tet2vert.long()].mean(dim=1)).numpy()
    N, M = 256, 6
    runs = {}
    for mode in ("segment", "batch"):
        jt, pt = twin_tallies(meshes, N, n_groups=2, sd_mode=mode,
                              io_pipeline=io)
        rng = np.random.default_rng(7)
        elem = rng.integers(0, pmesh.ntet, N)
        pos = cents[elem]
        for t in (jt, pt):
            t.initialize_particle_location(pos.reshape(-1).copy())
        prev, evens = pos, [np.zeros(pmesh.ntet * 2)]
        for _ in range(M):
            d = rng.normal(0, 1, (N, 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            # Clipped per axis at unequal bounds: a point clipped to
            # (0.01, 0.01, z) lies on the box's x = y diagonal faces, a
            # tie the two packages' rounding may break differently.
            dest = np.clip(prev + d * rng.exponential(0.2, (N, 1)),
                           [0.011, 0.013, 0.017], [0.989, 0.987, 0.983])
            outs = move_both((jt, pt), (
                dest.reshape(-1), np.ones(N, np.int8), np.ones(N),
                rng.integers(0, 2, N).astype(np.int32),
                np.full(N, -1, np.int32)))
            prev = outs[1][0].reshape(N, 3)
            evens.append(pt.raw_flux[..., 0].reshape(-1).copy())
        assert_tallies_agree(jt, pt)
        np.testing.assert_allclose(pt.normalized_flux(),
                                   jt.normalized_flux(), rtol=1e-10,
                                   atol=1e-12)
        runs[mode] = (pt.raw_flux.copy(), pt.normalized_flux(),
                      np.diff(np.stack(evens), axis=0))
    seg_raw, seg_norm, _ = runs["segment"]
    bat_raw, bat_norm, totals = runs["batch"]
    np.testing.assert_array_equal(seg_raw[..., 0], bat_raw[..., 0])
    np.testing.assert_array_equal(seg_norm[..., 0], bat_norm[..., 0])
    np.testing.assert_allclose(bat_raw[..., 1].reshape(-1),
                               (totals * totals).sum(axis=0), rtol=1e-10,
                               atol=0)
    assert not np.array_equal(seg_raw[..., 1], bat_raw[..., 1])
    mask = seg_raw[..., 0] > np.percentile(seg_raw[..., 0], 90)
    ratio = bat_norm[..., 2][mask] / seg_norm[..., 2][mask]
    assert 0.5 < np.median(ratio) < 2.0, np.median(ratio)


def test_batch_sd_with_squares_off_does_no_squares_work():
    """score_squares=False means no squares in either mode: slot 1 stays
    zero under sd_mode="batch" too, as in the JAX facade."""
    jt, pt = _driven(moves=2, sd_mode="batch", score_squares=False)
    assert pt._prev_even is None
    assert (pt.raw_flux[..., 1] == 0).all()
    assert (np.asarray(jt.raw_flux)[..., 1] == 0).all()
