"""The walk's invariant checks in the port on ``device="cpu"``:
``TallyConfig.checkify_invariants``, the walk's ``debug_checks``
(``ops/walk.py`` ``CHECKS``, ``WalkInvariantError``), the facade's
finite-input guard and the configuration rules that come with them.

Mirrors tests/test_debug_checks.py :32, :43 and :55 (a clean walk passes,
a NaN destination and a wrong parent element trip their checks), the
``resolve_io_pipeline`` cases of tests/test_io_pipeline.py :282-287 (the
debug surfaces force ``"legacy"``) and tests/test_convergence.py :462
(convergence does not compose with the checks). Each violation raises
the JAX walk's checkify message: the port's message is held to the text
of JAX's ``checked_trace`` error on the same inputs. The port reports
the lowest violated check of its precedence (``CHECKS`` order, the JAX
walk's order within one iteration) and leaves the flux as it was.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.ops.walk import checked_trace
from pumiumtally_tpu_torch import PumiTally, TallyConfig
from pumiumtally_tpu_torch.ops import walk, walk_cuda
from pumiumtally_tpu_torch.ops.walk import CHECKS, WalkInvariantError
from torch_twins import twin_meshes

F32 = torch.float32


@pytest.fixture(scope="module")
def meshes():
    """The JAX test's 3^3 box in float32, in both packages."""
    return twin_meshes(F32, nx=3)


def _inputs(mesh_j, dest, seed=0, elem=None):
    rng = np.random.default_rng(seed)
    n = dest.shape[0]
    if elem is None:
        elem = rng.integers(0, mesh_j.ntet, n).astype(np.int32)
    origin = np.asarray(mesh_j.centroids())[elem]
    return origin, np.asarray(dest, np.float64), elem


def _both(meshes, origin, dest, elem, weight=None):
    """JAX's ``checked_trace`` error message (None when clean) and the
    port's raised exception (None when clean) with its flux, on the same
    inputs; the port's flux starts at ones, to show it is left alone."""
    jmesh, pmesh = meshes
    n = origin.shape[0]
    w = np.ones(n) if weight is None else weight
    err, jr = checked_trace(
        jmesh, jnp.asarray(origin, jnp.float32), jnp.asarray(dest, jnp.float32),
        jnp.asarray(elem), jnp.ones(n, bool), jnp.asarray(w, jnp.float32),
        jnp.zeros(n, jnp.int32), jnp.full(n, -1, jnp.int32),
        jpt.make_flux(jmesh.ntet, 1, jnp.float32),
        initial=False, max_crossings=jmesh.ntet + 8, tolerance=1e-6,
    )
    flux = torch.ones(pmesh.ntet * 2, dtype=F32)
    t = torch.from_numpy
    raised, r = None, None
    try:
        r = walk_cuda.trace(
            pmesh, t(origin.astype(np.float32)), t(dest.astype(np.float32)),
            t(elem), torch.ones(n, dtype=torch.bool),
            t(w.astype(np.float32)), torch.zeros(n, dtype=torch.int32),
            torch.full((n,), -1, dtype=torch.int32), flux,
            initial=False, max_crossings=pmesh.ntet + 8, n_groups=1,
            tolerance=1e-6, debug_checks=True)
    except WalkInvariantError as e:
        raised = e
    return err.get(), jr, raised, r, flux


def test_clean_walk_passes_checks(meshes):
    """A clean walk passes in both packages and scores what the unchecked
    walk scores, bitwise."""
    dest = np.random.default_rng(1).uniform(0.1, 0.9, (32, 3))
    origin, dest, elem = _inputs(meshes[0], dest)
    jerr, jr, raised, r, flux = _both(meshes, origin, dest, elem)
    assert jerr is None and raised is None
    assert float(r.flux[0::2].sum()) > 32  # scored onto the ones
    t = torch.from_numpy
    plain = walk.trace(
        meshes[1], t(origin).float(), t(dest).float(), t(elem),
        torch.ones(32, dtype=torch.bool), torch.ones(32, dtype=F32),
        torch.zeros(32, dtype=torch.int32),
        torch.full((32,), -1, dtype=torch.int32),
        torch.ones(meshes[1].ntet * 2, dtype=F32), initial=False,
        max_crossings=meshes[1].ntet + 8, n_groups=1, tolerance=1e-6)
    assert torch.equal(plain.flux, flux)
    assert torch.equal(plain.position, r.position)
    np.testing.assert_allclose(flux.numpy()[0::2] - 1,
                               np.asarray(jr.flux)[..., 0].ravel(),
                               rtol=1e-4, atol=1e-5)


def test_nan_destination_trips_check(meshes):
    dest = np.random.default_rng(1).uniform(0.1, 0.9, (32, 3))
    dest[5] = np.nan
    jerr, _, raised, _, flux = _both(meshes, *_inputs(meshes[0], dest))
    assert raised is not None and jerr is not None
    assert str(raised) == CHECKS[1]
    assert str(raised) in jerr
    assert torch.equal(flux, torch.ones_like(flux))  # left as it was


def test_wrong_parent_element_trips_consistency_check(meshes):
    """A lane that claims the element farthest from its position trips
    the containment check."""
    jmesh = meshes[0]
    rng = np.random.default_rng(2)
    n = 8
    elem = rng.integers(0, jmesh.ntet, n).astype(np.int32)
    cents = np.asarray(jmesh.centroids())
    origin = cents[elem]
    elem[0] = int(np.argmax(np.linalg.norm(cents - origin[0], axis=1)))
    dest = rng.uniform(0.1, 0.9, (n, 3))
    jerr, _, raised, _, flux = _both(meshes, origin, dest, elem)
    assert raised is not None and str(raised) == CHECKS[0]
    assert "outside its parent element" in str(raised)
    assert str(raised) in jerr
    assert torch.equal(flux, torch.ones_like(flux))


def test_negative_weight_trips_contribution_check(meshes):
    dest = np.random.default_rng(1).uniform(0.1, 0.9, (16, 3))
    w = np.ones(16)
    w[3] = -1.0
    jerr, _, raised, _, _ = _both(meshes, *_inputs(meshes[0], dest),
                                  weight=w)
    assert raised is not None and str(raised) == CHECKS[3]
    assert str(raised) in jerr


def test_corrupt_neighbor_trips_element_range_check(meshes):
    """A topology code naming an element past the table trips the hop's
    range check (the plain walk on a copy of the mesh)."""
    pmesh = meshes[1]
    geo = pmesh.geo20.clone()
    codes = geo[:, 16:20].view(torch.int32)
    interior = torch.nonzero((codes & 0xFFFFFF) > 0)
    e, f = (int(v) for v in interior[0])
    codes[e, f] = (codes[e, f] & ~0xFFFFFF) | (pmesh.ntet + 5)
    bad = dataclasses.replace(pmesh, geo20=geo)
    # A lane from element e's centroid through its face f.
    v = pmesh.coords[pmesh.tet2vert[e].long()].double()
    cen = v.mean(dim=0)
    others = [k for k in range(4) if k != f]  # face f is opposite vertex f
    face_c = v[others].mean(dim=0)
    dest = (cen + 3 * (face_c - cen)).clamp(0.01, 0.99)
    with pytest.raises(WalkInvariantError, match="element id out of range"):
        walk.trace(bad, cen[None].float(), dest[None].float(),
                   torch.tensor([e], dtype=torch.int32),
                   torch.ones(1, dtype=torch.bool), torch.ones(1, dtype=F32),
                   torch.zeros(1, dtype=torch.int32),
                   torch.full((1,), -1, dtype=torch.int32),
                   torch.zeros(pmesh.ntet * 2, dtype=F32), initial=False,
                   max_crossings=8, n_groups=1, tolerance=1e-6,
                   debug_checks=True)


def test_track_length_check_and_precedence():
    """The post-loop check's bound, and the lowest violated check wins."""
    origin = torch.zeros(2, 3, dtype=torch.float64)
    dest = torch.tensor([[1.0, 0, 0], [0, 2.0, 0]], dtype=torch.float64)
    track = torch.tensor([1.0, 2.0], dtype=torch.float64)
    it = torch.tensor(3)
    assert not bool(walk.track_length_violated(dest, origin, dest, track,
                                               it, 1e-8))
    assert bool(walk.track_length_violated(dest, origin, dest,
                                           track + 1e-6, it, 1e-8))
    with pytest.raises(WalkInvariantError) as e:
        walk.raise_on_violation(0b11000)
    assert str(e.value) == CHECKS[3]
    with pytest.raises(WalkInvariantError, match="track length"):
        walk.raise_on_violation(1 << walk.TRACK_CHECK)
    walk.raise_on_violation(0)


def test_resolve_io_pipeline_debug_surfaces(monkeypatch):
    """Debug surfaces that need the unpacked result force legacy, over
    the field and the environment alike."""
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    assert TallyConfig(record_xpoints=4).resolve_io_pipeline() == "legacy"
    assert TallyConfig(
        checkify_invariants=True).resolve_io_pipeline() == "legacy"
    assert TallyConfig(io_pipeline="overlap", record_xpoints=4
                       ).resolve_io_pipeline() == "legacy"
    monkeypatch.setenv("PUMI_TPU_IO_PIPELINE", "packed")
    assert TallyConfig(
        checkify_invariants=True).resolve_io_pipeline() == "legacy"
    monkeypatch.setenv("PUMI_TPU_IO_PIPELINE", "nope")
    with pytest.raises(ValueError, match="io_pipeline"):
        TallyConfig(checkify_invariants=True).resolve_io_pipeline()


def test_convergence_refuses_checks():
    with pytest.raises(ValueError, match="checkify"):
        TallyConfig(convergence=True,
                    checkify_invariants=True).resolve_convergence()
    with pytest.raises(ValueError, match="checkify"):
        PumiTally(twin_meshes(nx=2)[1], 4,
                  TallyConfig(dtype=torch.float64, convergence=True,
                              checkify_invariants=True), device="cpu")


def test_facade_guards_inputs_and_checks_every_walk(monkeypatch):
    """``checkify_invariants`` on the facade: non-finite host inputs are
    refused before any walk (the JAX facade's message), every walk of a
    call takes the checks, re-walks included, and a clean run is bitwise
    the unchecked one."""
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    meshes = twin_meshes(nx=4)
    pmesh = meshes[1]
    n = 24
    cfg = dict(dtype=torch.float64, max_crossings=3, truncation_retries=6)
    rng = np.random.default_rng(8)
    pos = rng.uniform(0.1, 0.9, (n, 3)).ravel()
    dest = rng.uniform(0.05, 0.95, (n, 3)).ravel()
    args = (np.ones(n, np.int8), np.ones(n), np.zeros(n, np.int32),
            np.zeros(n, np.int32))
    seen = []
    real = walk.trace

    def spy(*a, **kw):
        seen.append(kw.get("debug_checks"))
        return real(*a, **kw)

    monkeypatch.setattr(walk_cuda, "trace_plain", spy)
    runs = []
    for checks in (False, True):
        t = PumiTally(pmesh, n, TallyConfig(checkify_invariants=checks,
                                            **cfg), device="cpu")
        t.initialize_particle_location(pos.copy())
        buf = dest.copy()
        t.move_to_next_location(buf, *(a.copy() for a in args))
        runs.append((t, buf))
    assert seen.count(True) > 2  # the init, the move and their re-walks
    assert runs[1][0].telemetry()["totals"]["rewalked"] > 0
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    np.testing.assert_array_equal(runs[0][0].raw_flux, runs[1][0].raw_flux)

    checked = runs[1][0]
    jt = jpt.PumiTally(meshes[0], n, jpt.TallyConfig(
        dtype=jnp.float64, checkify_invariants=True))
    jt.initialize_particle_location(pos.copy())
    for name, bad_args in (
            ("particle_destinations", (np.full(n * 3, np.nan), *args)),
            ("weights", (dest.copy(), args[0], np.full(n, np.inf),
                         *args[2:]))):
        for t in (checked, jt):
            with pytest.raises(ValueError,
                               match=f"{name} contains non-finite"):
                t.move_to_next_location(*(np.array(a, copy=True)
                                          for a in bad_args))
    with pytest.raises(ValueError, match="init_particle_positions"):
        checked.initialize_particle_location(np.full(n * 3, np.inf))
