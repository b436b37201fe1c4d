"""Truncated walks in the port on ``device="cpu"``: the warn-and-count
path, and the bounded re-walk escalation (``ops/walk.py::
rewalk_truncated``, ``TallyConfig.truncation_retries``).

Mirrors tests/test_truncation.py :60, :74, :92 and :121 (the
``record_xpoints`` case :139 is held in tests/test_torch_xpoints.py; the
partitioned case waits for ROADMAP.md A9). Each test
drives the JAX facade with the same inputs: lost and re-walked counts
are equal, the flux agrees at the float64 parity bar (1e-10 relative;
the re-walks of both packages fold their records after the first walk's,
in the same order). An escalated run holds the ample-bound run's flux at
the JAX test's ``atol=1e-5`` and its element ids exactly.

Both packages run with ``unroll=1``: the JAX walk checks
``max_crossings`` once per unrolled block, so with its default
``unroll=8`` a lane may run past the bound (27 of 32 lanes truncate at
``max_crossings=2`` in the initial search below, against 32 with
``unroll=1``). The port checks the bound every iteration, as the JAX
walk does with ``unroll=1``; ``unroll`` is only a schedule elsewhere.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from pumiumtally_tpu_torch.ops import walk, walk_cuda
from torch_twins import TOL, assert_tallies_agree, move_both, twin_meshes, twin_tallies

N = 32


def _init(tallies):
    rng = np.random.default_rng(42)
    pos = rng.uniform(0.1, 0.9, (N, 3)).ravel()
    for t in tallies:
        t.initialize_particle_location(pos.copy())
    return tallies


def _inputs(i, n=N):
    rng = np.random.default_rng(300 + i)
    return (
        # Long moves: many crossings a walk, so a tiny bound truncates.
        rng.uniform(0.02, 0.98, (n, 3)).ravel().copy(),
        np.ones(n, np.int8),
        rng.uniform(0.5, 2.0, n),
        rng.integers(0, 2, n).astype(np.int32),
        np.full(n, -1, np.int32),
    )


def _pair(dtype=torch.float64, **cfg):
    tol = 1e-8 if dtype == torch.float64 else 1e-6
    return _init(twin_tallies(twin_meshes(dtype, nx=5), N, dtype,
                              tolerance=tol, unroll=1, **cfg))


@pytest.mark.parametrize("io", ["packed", "legacy"])
def test_truncated_walks_warn_and_count(io, monkeypatch):
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    jt, pt = _pair(max_crossings=2, io_pipeline=io)
    with pytest.warns(RuntimeWarning, match="truncated"):
        move_both((jt, pt), _inputs(1))
    tm, jtm = pt.telemetry()["totals"], jt.telemetry()["totals"]
    assert tm["truncated"] > 0
    assert tm["lost"] == tm["truncated"] == jtm["lost"]
    assert tm["rewalked"] == 0
    assert_tallies_agree(jt, pt)


def test_truncated_fallback_without_walk_stats():
    """walk_stats=False: the truncation count comes from the done flags
    of the readback, and the facade still warns."""
    jt, pt = _pair(max_crossings=2, walk_stats=False)
    with pytest.warns(RuntimeWarning, match="truncated"):
        move_both((jt, pt), _inputs(1))
    assert pt.telemetry()["totals"]["lost"] == \
        jt.telemetry()["totals"]["lost"] > 0


@pytest.mark.parametrize("io", ["packed", "overlap", "legacy"])
def test_escalation_recovers_truncated_walks(io, monkeypatch):
    """With retries, a tiny-bound run recovers every lane (no warning)
    and reproduces the ample-bound flux; the JAX facade's escalation
    gives the same flux at the parity bar."""
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        jt, pt = _pair(max_crossings=2, truncation_retries=5,
                       io_pipeline=io)
        for i in range(1, 4):
            outs = move_both((jt, pt), _inputs(i))
            np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=0,
                                       atol=TOL[torch.float64][0])
            np.testing.assert_array_equal(outs[1][2], outs[0][2])
    assert_tallies_agree(jt, pt)
    ref = _pair(io_pipeline=io)[1]
    for i in range(1, 4):
        move_both((ref,), _inputs(i))
    np.testing.assert_allclose(pt.raw_flux, ref.raw_flux, atol=1e-5)
    np.testing.assert_array_equal(pt.element_ids, ref.element_ids)
    tm, jtm = pt.telemetry()["totals"], jt.telemetry()["totals"]
    assert tm["rewalked"] > 0 and tm["lost"] == 0
    assert tm["rewalked"] == jtm["rewalked"]
    assert tm["segments"] == jtm["segments"] == ref.total_segments
    # The initial search truncates and re-walks too.
    recs = [r for r in pt.telemetry()["per_move"] if r["kind"] == "rewalk"]
    assert [r["move"] for r in recs] == [0, 1, 2, 3]
    assert all(r["lost"] == 0 for r in recs)
    # A call with a re-walk makes one more device→host copy: the
    # refreshed readback (legacy: the summary, positions and materials).
    assert tm["d2h_transfers"] == 4 * 2


def test_escalation_bounded_then_lost():
    jt, pt = _pair(max_crossings=1, truncation_retries=1)
    with pytest.warns(RuntimeWarning, match="truncated"):
        move_both((jt, pt), _inputs(1))
    tm, jtm = pt.telemetry()["totals"], jt.telemetry()["totals"]
    assert tm["rewalked"] > 0 and tm["lost"] > 0
    assert (tm["rewalked"], tm["lost"]) == (jtm["rewalked"], jtm["lost"])
    assert_tallies_agree(jt, pt)


def test_escalation_in_float32_matches_the_ample_run():
    """The JAX test's own dtype: float32 at tolerance 1e-6."""
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        _, pt = _pair(torch.float32, max_crossings=2, truncation_retries=5)
        for i in range(1, 4):
            move_both((pt,), _inputs(i))
    ref = _pair(torch.float32)[1]
    for i in range(1, 4):
        move_both((ref,), _inputs(i))
    np.testing.assert_allclose(pt.raw_flux, ref.raw_flux, atol=1e-5)
    np.testing.assert_array_equal(pt.element_ids, ref.element_ids)


def test_rewalk_walks_only_the_truncated_lanes(monkeypatch):
    """Each attempt puts exactly the lanes the last one left unfinished in
    flight, from its mid-walk positions and elements, with the crossing
    bound doubled; the card wrapper on CPU tensors is the same walk, and
    sizes each attempt's record buffers from its lanes in flight."""
    pmesh = twin_meshes(nx=5)[1]
    rng = np.random.default_rng(3)
    n = 64
    t = torch.from_numpy
    origin = t(rng.uniform(0.1, 0.9, (n, 3)))
    r0 = walk.trace(pmesh, torch.full((n, 3), 0.5, dtype=torch.float64),
                    origin, torch.zeros(n, dtype=torch.int32),
                    torch.ones(n, dtype=torch.bool),
                    torch.ones(n, dtype=torch.float64),
                    torch.zeros(n, dtype=torch.int32),
                    torch.zeros(n, dtype=torch.int32),
                    torch.zeros(pmesh.ntet * 4, dtype=torch.float64),
                    initial=True, max_crossings=pmesh.ntet + 64, n_groups=2)
    dest = t(rng.uniform(0.02, 0.98, (n, 3)))
    args = (pmesh, r0.position, dest, r0.elem,
            torch.ones(n, dtype=torch.bool),
            t(rng.uniform(0.5, 2.0, n)),
            t(rng.integers(0, 2, n).astype(np.int32)),
            torch.zeros(n, dtype=torch.int32))
    kw = dict(initial=False, max_crossings=2, n_groups=2, tolerance=1e-8)
    first = walk.trace(*args, torch.zeros(pmesh.ntet * 4,
                                          dtype=torch.float64), **kw)
    assert (~first.done).any()
    calls = []

    def spy(mesh, origin, dest, elem, in_flight, *rest, max_crossings,
            **kw2):
        calls.append((in_flight.clone(), max_crossings))
        return walk.trace(mesh, origin, dest, elem, in_flight, *rest,
                          max_crossings=max_crossings, **kw2)

    def fresh():
        return walk.TraceResult(**{
            f: (v.clone() if isinstance(v, torch.Tensor) else v)
            for f, v in vars(first).items()})

    merged, retried, lost = walk.rewalk_truncated(
        pmesh, fresh(), dest, args[5], args[6], retries=6, trace_fn=spy,
        **kw)
    assert lost == 0 and retried == sum(int(c[0].sum()) for c in calls)
    assert calls[0][0].equal(~first.done)
    assert [c[1] for c in calls] == [4 * 2 ** k for k in range(len(calls))]
    capacities = []
    card_trace = walk_cuda.trace

    def sized(*a, capacity, **kw2):
        capacities.append(capacity)
        return card_trace(*a, capacity=capacity, **kw2)

    monkeypatch.setattr(walk_cuda, "trace", sized)
    card, retried2, lost2 = walk_cuda.rewalk_truncated(
        pmesh, fresh(), dest, args[5], args[6], retries=6, **kw)
    assert (retried2, lost2) == (retried, lost)
    assert capacities == [min(int(c[0].sum()) * c[1], 8 * n) for c in calls]
    assert torch.equal(card.flux, merged.flux)
    assert torch.equal(card.position, merged.position)
    assert merged.stats[3] == 0  # truncated: the final count
    ample = walk.trace(*args, torch.zeros(pmesh.ntet * 4,
                                          dtype=torch.float64),
                       **dict(kw, max_crossings=pmesh.ntet + 64))
    assert torch.equal(merged.elem, ample.elem)
    assert int(merged.n_segments) == int(ample.n_segments)
    torch.testing.assert_close(merged.flux, ample.flux, rtol=0, atol=1e-12)
    torch.testing.assert_close(merged.track_length, ample.track_length,
                               rtol=0, atol=1e-12)
