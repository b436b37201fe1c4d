"""The periodic element sort in the port on ``device="cpu"``:
``TallyConfig.sort_by_element`` with ``migration_period``, the slot
permutation of the packed records (``ops/staging.py``) and the facade's
host-order mapping of inputs, write-backs, quarantine, crossing points
and ``element_ids``.

Mirrors tests/test_api_contracts.py :91 (host observables identical with
the sort on) and tests/test_io_pipeline.py :126 (packed and legacy
bitwise with ``migration_period=1``), adds a port-vs-JAX case with the
sort on in float64 at the parity bar (flux 1e-10 relative), and a case
with many lanes in one element, which shows the sort is stable.

The sort permutes the lanes, so the ordered tally's keys (iteration ·
n + lane) and with them the add order of a bin change: against the
sort-off run positions, material ids and element ids are bitwise equal
and the flux agrees to rounding (rtol 1e-12 in float64).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pumiumtally_tpu.mesh.box import build_box_arrays
from pumiumtally_tpu_torch import PumiTally, TallyConfig
from pumiumtally_tpu_torch.mesh.core import TetMesh
from torch_twins import assert_tallies_agree, move_both, twin_meshes, twin_tallies

N = 128


@pytest.fixture(scope="module")
def mesh64():
    """The JAX test's two-material 4^3 box (class 1 for x < 0.5, 2
    beyond), so moves stop on material boundaries too."""
    coords, t2v = build_box_arrays(1.0, 1.0, 1.0, 4, 4, 4)
    cls = np.where(coords[t2v].mean(axis=1)[:, 0] < 0.5, 1, 2)
    return TetMesh.from_numpy(coords, t2v, class_id=cls.astype(np.int32),
                              dtype=torch.float64, device="cpu")


def _drive(t, moves=3, seed=17, nan_move=None):
    """The JAX test's drive: init, then moves with parked lanes, random
    weights and groups; returns each move's write-backs."""
    rng = np.random.default_rng(seed)
    n = t.num_particles
    pos = rng.uniform(0.05, 0.95, (n, 3))
    t.initialize_particle_location(pos.ravel().copy(), n * 3)
    outs, prev = [], pos
    for k in range(1, moves + 1):
        dest = np.clip(prev + rng.normal(0, 0.25, (n, 3)), -0.1, 1.1)
        if k == nan_move:
            dest[3::11] = np.nan
        buf = dest.ravel().copy()
        flying = np.ones(n, np.int8)
        flying[::7] = 0  # parked lanes ride along
        w = rng.uniform(0.5, 2.0, n)
        g = rng.integers(0, 2, n).astype(np.int32)
        mats = np.full(n, 9, np.int32)
        t.move_to_next_location(buf, flying, w, g, mats, buf.size)
        outs.append((buf.reshape(n, 3).copy(), mats.copy()))
        prev = np.nan_to_num(buf.reshape(n, 3), nan=0.5)
    return outs


def _tally(mesh, **kw):
    cfg = TallyConfig(n_groups=2, dtype=torch.float64, tolerance=1e-8, **kw)
    return PumiTally(mesh, N, cfg, device="cpu")


def _same_write_backs(a, b):
    for (pa, ma), (pb, mb) in zip(a, b):
        np.testing.assert_array_equal(pb, pa)
        np.testing.assert_array_equal(mb, ma)


@pytest.mark.parametrize("period", [1, 2])
def test_sort_by_element_preserves_host_order(mesh64, period, monkeypatch):
    """The same walk with and without the sort: write-backs, element ids
    and crossing points bitwise, the flux to rounding; the sort fires
    every ``period`` moves and the slots then run in element order."""
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    runs = []
    for sort in (False, True):
        t = _tally(mesh64, sort_by_element=sort, migration_period=period,
                   record_xpoints=6)
        runs.append((t, _drive(t, moves=4)))
    (off, outs_off), (on, outs_on) = runs
    _same_write_backs(outs_off, outs_on)
    np.testing.assert_array_equal(on.element_ids, off.element_ids)
    for a, b in zip(on.intersection_points(), off.intersection_points()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(on.raw_flux, off.raw_flux, rtol=1e-12,
                               atol=0)
    assert off._perm is None
    assert sorted(on._perm.tolist()) == list(range(N))
    slot_elems = on.state.elem.numpy()
    assert np.array_equal(slot_elems, np.sort(slot_elems))
    np.testing.assert_array_equal(on.element_ids[on._perm], slot_elems)


def test_pipeline_parity_with_sorted_layout(mesh64, monkeypatch):
    """With the sort firing every move, the packed and overlap modes
    permute the records on the device exactly as legacy permutes its
    inputs on the host: write-backs, flux and element ids bitwise."""
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    kw = dict(sort_by_element=True, migration_period=1)
    runs = {io: _tally(mesh64, io_pipeline=io, **kw)
            for io in ("legacy", "packed", "overlap")}
    outs = {io: _drive(t) for io, t in runs.items()}
    for io in ("packed", "overlap"):
        _same_write_backs(outs["legacy"], outs[io])
        np.testing.assert_array_equal(runs[io].raw_flux,
                                      runs["legacy"].raw_flux)
        np.testing.assert_array_equal(runs[io].element_ids,
                                      runs["legacy"].element_ids)
    assert runs["packed"].io["h2d_transfers"] == 1 + 3
    # A packed move: one record each way, and a sort's permutation read.
    assert runs["packed"].io["d2h_transfers"] == 1 + 3 * 2


def test_sorted_run_matches_jax(monkeypatch):
    """Port against JAX, both sorting every other move: the float64
    parity bar on the flux, element ids and write-backs."""
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    meshes = twin_meshes(nx=4, jitter=0.15, classes=(1, 2))
    jt, pt = twin_tallies(meshes, 64, n_groups=2, tolerance=1e-8,
                          sort_by_element=True, migration_period=2)
    rng = np.random.default_rng(23)
    pos = rng.uniform(0.05, 0.95, (64, 3)).ravel()
    for t in (jt, pt):
        t.initialize_particle_location(pos.copy())
    for k in range(4):
        inputs = (rng.uniform(0.03, 0.97, (64, 3)).ravel(),
                  (rng.random(64) > 0.1).astype(np.int8),
                  rng.uniform(0.5, 2.0, 64),
                  rng.integers(0, 2, 64).astype(np.int32),
                  np.full(64, -1, np.int32))
        (jd, _, jm), (pd, _, pm) = move_both((jt, pt), inputs)
        np.testing.assert_allclose(pd, jd, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(pm, jm)
    assert pt._perm is not None
    np.testing.assert_array_equal(pt._perm, np.asarray(jt._perm))
    assert_tallies_agree(jt, pt)


def test_sort_is_stable_with_many_lanes_in_one_element(mesh64):
    """Every lane starts in one element and about half of them stay
    there: a stable sort keeps equal elements in their slot order, so the
    permutation is numpy's stable argsort of the slots' elements, and two
    runs give the same permutation and flux bits."""
    n = 256
    start = (0.3, 0.35, 0.4)

    def run():
        t = PumiTally(mesh64, n, TallyConfig(
            n_groups=2, dtype=torch.float64, sort_by_element=True,
            migration_period=1), device="cpu")
        t.initialize_particle_location(np.tile(start, n))
        assert (t.element_ids == t.element_ids[0]).all()
        rng = np.random.default_rng(4)
        perms = []
        for _ in range(2):
            before = np.arange(n) if t._perm is None else t._perm.copy()
            stay = rng.random(n) < 0.5
            dest = np.where(stay[:, None], np.asarray(start),
                            rng.uniform(0.05, 0.95, (n, 3)))
            t.move_to_next_location(dest.ravel().copy(), np.ones(n, np.int8),
                                    np.ones(n), np.zeros(n, np.int32),
                                    np.zeros(n, np.int32))
            slots = t.element_ids[before]  # the slots' elements, unsorted
            assert np.bincount(slots).max() >= n // 4
            np.testing.assert_array_equal(
                t._perm, before[np.argsort(slots, kind="stable")])
            perms.append(t._perm.copy())
        return perms, t.raw_flux.copy()

    (p1, f1), (p2, f2) = run(), run()
    for a, b in zip(p1, p2):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(f1, f2)


def test_quarantine_and_inputs_map_between_orders(mesh64, monkeypatch):
    """After a sort, the quarantine's mask, the caller's inputs and the
    write-backs travel between host particle order and device slot order:
    a quarantined sorted run equals the quarantined unsorted run (write
    backs bitwise, counts per particle, flux to rounding)."""
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    outs, tallies = [], []
    for sort in (False, True):
        for io in ("legacy", "packed"):
            t = _tally(mesh64, quarantine=True, sort_by_element=sort,
                       migration_period=1, io_pipeline=io)
            outs.append(_drive(t, moves=3, nan_move=3))
            tallies.append(t)
    ref = tallies[0]
    assert ref.quarantined_lanes().sum() == len(range(3, N, 11))
    for t, o in zip(tallies[1:], outs[1:]):
        _same_write_backs(outs[0], o)
        np.testing.assert_array_equal(t.quarantined_lanes(),
                                      ref.quarantined_lanes())
        np.testing.assert_allclose(t.raw_flux, ref.raw_flux, rtol=1e-12,
                                   atol=0)
    np.testing.assert_array_equal(tallies[3].raw_flux, tallies[2].raw_flux)
