"""The port's CUDA kernels on the card (marker ``cuda``; skipped without
one): the walk, the tally scatter and the row gather, and the move-loop
I/O around them (pinned staging, the ``io_pipeline`` modes, the streaming
pipeline, the guard on a walk's record count).

This file imports nothing of JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The walk kernel (``csrc/walk.cu``, built with ``--fmad=false``) computes
the plain walk's arithmetic operation for operation, so elements, material
ids, done flags, stats and positions must agree exactly, whichever thread
walks a lane and when (its threads stay resident and take lane after lane
in element order). With the ordered
tally (the default) each bin gets its adds in the plain walk's order, so
the flux is bitwise equal too, and equal across runs. With the atomic
tally it agrees to the reordering of its adds (rtol 1e-10 in float64,
1e-4 in float32). The ordered scatter (on its bucket path and on its
crowded path, which the counters show) and the gather are bitwise equal
to their plain versions; the atomic scatter agrees within rtol 1e-5. The
lane schedule writes each lane's record with the plain version's bytes,
in key order (within a key the order is the device's), in 3 launches a
walk; a relaunch after an overflow runs no second schedule. Packed and overlap staging
give the legacy path's bits, and the pipeline those of the same batches
walked one after another.
"""
from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

FLUX_RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _jittered(nx, dtype, device):
    from pumiumtally_tpu_torch.mesh.box import build_box_arrays
    from pumiumtally_tpu_torch.mesh.core import TetMesh

    coords, tets = build_box_arrays(1.0, 1.0, 1.0, nx, nx, nx)
    rng = np.random.default_rng(4)
    interior = (coords > 1e-9).all(axis=1) & (coords < 1 - 1e-9).all(axis=1)
    coords = coords.copy()
    coords[interior] += rng.uniform(-0.2 / nx, 0.2 / nx, (interior.sum(), 3))
    cid = (coords[tets].mean(axis=1)[:, 0] > 0.5).astype(np.int32)
    return TetMesh.from_numpy(coords, tets, cid, dtype=dtype, device=device)


def _walk_inputs(mesh, cuda, dtype, n=4096, G=4, seed=9):
    rng = np.random.default_rng(seed)

    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda, dt)

    elem = t(rng.integers(0, mesh.ntet, n).astype(np.int32), torch.int32)
    origin = mesh.centroids()[elem.long()].contiguous()
    dest = t(rng.uniform(-0.1, 1.1, (n, 3)), dtype)
    fly = t(rng.uniform(size=n) > 0.1, torch.bool)
    w = t(rng.uniform(0.5, 2.0, n), dtype)
    g = t(rng.integers(0, G + 1, n).astype(np.int32), torch.int32)
    mat = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    return (mesh, origin, dest, elem, fly, w, g, mat)


def _flux0(mesh, G, dtype, cuda):
    """A nonzero seed, so the folds start from the flux's own values."""
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.uniform(0, 1, mesh.ntet * G * 2)).to(
        cuda, dtype)


def _lanes_equal(k, p):
    for name in ("elem", "material_id", "done", "stats", "lane_iters",
                 "position", "track_length"):
        assert torch.equal(getattr(k, name), getattr(p, name)), name


@pytest.mark.parametrize("robust", [True, False])
@pytest.mark.parametrize("initial", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain(cuda, dtype, initial, robust):
    """The default (ordered) walk: lanes and flux bitwise equal to the
    plain walk's, and the flux equal across two runs."""
    from pumiumtally_tpu_torch.ops import scatter, walk, walk_cuda

    mesh = _jittered(6, dtype, cuda)
    G = 4
    args = _walk_inputs(mesh, cuda, dtype, G=G)
    kw = dict(initial=initial, max_crossings=mesh.ntet + 8, n_groups=G,
              robust=robust)
    before = walk_cuda.LAUNCHES
    scattered = scatter.ORDERED_LAUNCHES
    scheduled = walk_cuda.SCHEDULE_LAUNCHES
    k = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
    again = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
    p = walk.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
    torch.cuda.synchronize()
    assert walk_cuda.LAUNCHES - before >= 2
    assert walk_cuda.SCHEDULE_LAUNCHES - scheduled == 2 * 3  # 3 a walk
    assert scatter.ORDERED_LAUNCHES - scattered == (0 if initial else 2)
    _lanes_equal(k, p)
    assert torch.equal(k.flux, p.flux)
    assert torch.equal(k.flux, again.flux)


@pytest.mark.parametrize("robust", [True, False])
@pytest.mark.parametrize("initial", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_unpacked_kernel_matches_plain(cuda, dtype, initial, robust):
    """The unpacked layout (a mesh without geo20: 65 classes, one more
    than the codes hold): lanes and flux bitwise the plain walk's, through
    the unpacked instantiation (its own launch count), with material
    stops at the class boundaries."""
    from pumiumtally_tpu_torch.mesh.box import build_box_arrays
    from pumiumtally_tpu_torch.mesh.core import TetMesh
    from pumiumtally_tpu_torch.ops import walk, walk_cuda

    coords, tets = build_box_arrays(1.0, 1.0, 1.0, 6, 6, 6)
    cid = (np.arange(len(tets)) % 65).astype(np.int32)
    mesh = TetMesh.from_numpy(coords, tets, cid, dtype=dtype, device=cuda)
    assert mesh.geo20 is None
    G = 4
    args = _walk_inputs(mesh, cuda, dtype, G=G)
    kw = dict(initial=initial, max_crossings=mesh.ntet + 8, n_groups=G,
              robust=robust)
    before = walk_cuda.UNPACKED_LAUNCHES
    k = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
    p = walk.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
    torch.cuda.synchronize()
    assert walk_cuda.UNPACKED_LAUNCHES - before >= 1
    _lanes_equal(k, p)
    assert torch.equal(k.flux, p.flux)
    if not initial:
        assert (p.material_id >= 0).any()


def _unpacked_jittered(nx, dtype, device):
    """The jittered two-region box built without geo20."""
    from pumiumtally_tpu_torch.mesh.box import build_box_arrays
    from pumiumtally_tpu_torch.mesh.core import TetMesh

    coords, tets = build_box_arrays(1.0, 1.0, 1.0, nx, nx, nx)
    rng = np.random.default_rng(4)
    interior = (coords > 1e-9).all(axis=1) & (coords < 1 - 1e-9).all(axis=1)
    coords = coords.copy()
    coords[interior] += rng.uniform(-0.2 / nx, 0.2 / nx, (interior.sum(), 3))
    cid = (coords[tets].mean(axis=1)[:, 0] > 0.5).astype(np.int32)
    return TetMesh.from_numpy(coords, tets, cid, dtype=dtype, device=device,
                              packed=False)


@pytest.mark.parametrize("robust", [True, False])
@pytest.mark.parametrize("initial", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_unpacked_features_kernel_matches_plain(cuda, dtype, initial,
                                                robust):
    """The feature instantiations of the unpacked layout (recorded points
    and the checks on a mesh without geo20): points, counts, lanes and
    flux bitwise the plain walk's, the flux bitwise the run without the
    features; a corrupted parent element and a NaN destination raise the
    plain walk's messages, the flux left as it was."""
    from pumiumtally_tpu_torch.ops import walk, walk_cuda
    from pumiumtally_tpu_torch.ops.walk import CHECKS, WalkInvariantError

    mesh = _unpacked_jittered(6, dtype, cuda)
    assert mesh.geo20 is None
    G, K = 4, 5
    args = list(_walk_inputs(mesh, cuda, dtype, G=G))
    kw = dict(initial=initial, max_crossings=mesh.ntet + 8, n_groups=G,
              robust=robust)
    feats = walk_cuda.FEATURE_UNPACKED_LAUNCHES
    k = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda),
                        record_xpoints=K, debug_checks=True, **kw)
    assert walk_cuda.FEATURE_UNPACKED_LAUNCHES - feats >= 1
    p = walk.trace(*args, _flux0(mesh, G, dtype, cuda), record_xpoints=K,
                   debug_checks=True, **kw)
    off = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
    torch.cuda.synchronize()
    _lanes_equal(k, p)
    _lanes_equal(k, off)
    assert torch.equal(k.flux, p.flux) and torch.equal(k.flux, off.flux)
    assert torch.equal(k.n_xpoints, p.n_xpoints)
    assert torch.equal(k.xpoints, p.xpoints)
    assert int(k.n_xpoints.max()) > K
    far = int(torch.argmax(((mesh.centroids() - args[1][0]) ** 2).sum(1)))
    bad_elem, bad_dest = args[3].clone(), args[2].clone()
    bad_elem[0] = far
    bad_dest[5] = float("nan")
    for i, bad_arg, msg in ((3, bad_elem, CHECKS[0]),
                            (2, bad_dest, CHECKS[1])):
        bad = list(args)
        bad[i] = bad_arg
        flux = _flux0(mesh, G, dtype, cuda)
        with pytest.raises(WalkInvariantError) as e:
            walk_cuda.trace(*bad, flux, debug_checks=True, **kw)
        assert str(e.value) == msg
        assert torch.equal(flux, _flux0(mesh, G, dtype, cuda))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_atomic_kernel_matches_plain(cuda, dtype):
    from pumiumtally_tpu_torch.ops import walk, walk_cuda

    mesh = _jittered(6, dtype, cuda)
    G = 4
    args = _walk_inputs(mesh, cuda, dtype, G=G)
    kw = dict(initial=False, max_crossings=mesh.ntet + 8, n_groups=G)
    before = walk_cuda.LAUNCHES
    k = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda), tally="atomic",
                        **kw)
    p = walk.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
    torch.cuda.synchronize()
    assert walk_cuda.LAUNCHES == before + 1
    _lanes_equal(k, p)
    torch.testing.assert_close(k.flux, p.flux, rtol=FLUX_RTOL[dtype], atol=0)


@pytest.mark.parametrize("initial", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_persistent_walk_refills_lanes(cuda, dtype, initial):
    """Three times as many lanes as a launch keeps resident, so every
    thread walks several: short hops beside long rays, parked lanes and
    lanes truncated at max_crossings. Ordered: lanes and flux bitwise the
    plain walk's; atomic: lanes equal, flux within FLUX_RTOL. The warps'
    loop trips cover the lane iterations."""
    from pumiumtally_tpu_torch.ops import walk, walk_cuda

    mesh = _jittered(6, dtype, cuda)
    G = 4
    n = 3 * walk_cuda.resident_threads(dtype, initial=initial) + 77
    args = list(_walk_inputs(mesh, cuda, dtype, n=n, G=G, seed=11))
    hop = torch.from_numpy(np.random.default_rng(12).normal(
        scale=0.02, size=(n, 3))).to(cuda, dtype)
    short = torch.arange(n, device=cuda) % 3 == 0
    args[2] = torch.where(short[:, None], args[1] + hop, args[2])
    kw = dict(initial=initial, max_crossings=20, n_groups=G)
    k = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
    trips = int(walk_cuda.WARP_TRIPS)
    p = walk.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
    torch.cuda.synchronize()
    _lanes_equal(k, p)
    assert torch.equal(k.flux, p.flux)
    assert bool((~args[4]).any()) and bool((k.lane_iters == 0).any())
    assert bool((~k.done).any())  # truncated lanes
    assert int(k.lane_iters.sum()) <= 32 * trips
    assert trips >= int(k.lane_iters.max())
    if not initial:
        a = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda),
                            tally="atomic", **kw)
        _lanes_equal(a, p)
        torch.testing.assert_close(a.flux, p.flux, rtol=FLUX_RTOL[dtype],
                                   atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["one element", "random", "descending",
                                  "out of range", "initial"])
def test_lane_order_kernel(cuda, case, dtype):
    """The lane schedule (``walk_cuda.lane_records``, three kernels): each
    lane's record equals the plain version's bytes (matched through
    Lane.index), keys are non-decreasing in slot order, and the key
    counts and the scan's ticket are left at zero for the next call. The
    initial search's keys (destination cells, some destinations outside
    the box or not finite) are computed in the kernel; a move's elements
    outside the mesh take the nearest key."""
    from pumiumtally_tpu_torch.ops import walk_cuda

    mesh = _jittered(12, dtype, cuda)
    n, ntet = 100003, mesh.ntet
    _, origin, dest, _, fly, w, g, _ = _walk_inputs(mesh, cuda, dtype, n=n)
    dest[:3] = torch.tensor([[float("nan")] * 3, [float("inf")] * 3,
                             [-float("inf"), 0.5, 2.0]], dtype=dtype)
    rng = np.random.default_rng(6)
    elem = {
        "one element": np.full(n, 17),
        "random": rng.integers(0, ntet, n),
        "descending": (ntet - 1 - np.arange(n) * ntet // n),
        "out of range": rng.integers(-40, ntet + 40, n),
        "initial": np.zeros(n),
    }[case]
    elem = torch.from_numpy(elem.astype(np.int32)).to(cuda)
    initial = case == "initial"
    before = walk_cuda.SCHEDULE_LAUNCHES
    rec = walk_cuda.lane_records(mesh, origin, dest, elem, fly, w, g,
                                 initial=initial)
    torch.cuda.synchronize()
    assert walk_cuda.SCHEDULE_LAUNCHES == before + 3
    assert tuple(rec.shape) == (n, walk_cuda.LANE_BYTES[dtype])
    keys, _ = walk_cuda.lane_keys(mesh, elem, dest, initial)
    plain = walk_cuda.lane_records_plain(keys, origin, dest, elem, fly, w, g)
    idx = walk_cuda.decode_lanes(rec, dtype)["index"].long()
    assert torch.equal(torch.sort(idx).values, torch.arange(n, device=cuda))
    by_lane = torch.empty_like(rec)
    by_lane[idx] = rec
    assert torch.equal(by_lane, plain[torch.argsort(
        walk_cuda.decode_lanes(plain, dtype)["index"].long())])
    assert bool((keys[idx][1:] >= keys[idx][:-1]).all())
    for ws in walk_cuda._WORKSPACES.values():
        assert not ws["counts"].any() and not ws["ticket"].any()


def test_overflow_relaunches_the_walk(cuda):
    """Records past the capacity are dropped and the walk runs again with
    buffers of its count; the flux is the same bits. The walk's records,
    scattered apart, give them too."""
    from pumiumtally_tpu_torch.ops import scatter, walk, walk_cuda

    dtype, G = torch.float32, 4
    mesh = _jittered(6, dtype, cuda)
    args = _walk_inputs(mesh, cuda, dtype, G=G)
    kw = dict(initial=False, max_crossings=mesh.ntet + 8, n_groups=G)
    before, re = walk_cuda.LAUNCHES, walk_cuda.RELAUNCHES
    scheduled = walk_cuda.SCHEDULE_LAUNCHES
    k = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda), capacity=7,
                        **kw)
    torch.cuda.synchronize()
    assert walk_cuda.RELAUNCHES == re + 1
    assert walk_cuda.LAUNCHES == before + 2
    # The relaunch walks the same lane records: no second schedule.
    assert walk_cuda.SCHEDULE_LAUNCHES == scheduled + 3
    p = walk.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
    _lanes_equal(k, p)
    assert torch.equal(k.flux, p.flux)
    flux = _flux0(mesh, G, dtype, cuda)
    r, rec = walk_cuda.walk_records(*args, flux, max_crossings=mesh.ntet + 8,
                                    n_groups=G)
    assert torch.equal(flux, _flux0(mesh, G, dtype, cuda))  # untouched
    assert 7 < rec.bin.numel() <= int(r.n_segments)
    scatter.scatter_ordered(flux, rec.bin, rec.order, rec.c)
    assert torch.equal(flux, p.flux)


def test_facade_on_card_conserves_track_length(cuda):
    from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
    from pumiumtally_tpu_torch.ops import walk_cuda

    n = 2048
    mesh = build_box(1.0, 1.0, 1.0, 8, 8, 8, dtype=torch.float64)
    tally = PumiTally(mesh, n, TallyConfig(n_groups=2, dtype=torch.float64))
    assert tally.device.type == "cuda"
    before, re = walk_cuda.LAUNCHES, walk_cuda.RELAUNCHES
    rng = np.random.default_rng(2)
    prev = rng.uniform(0.05, 0.95, (n, 3))
    tally.initialize_particle_location(prev.reshape(-1).copy())
    path = 0.0
    for _ in range(3):
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        dest = (prev + d * rng.exponential(0.2, (n, 1))).reshape(-1)
        flying = np.ones(n, np.int8)
        mats = np.zeros(n, np.int32)
        tally.move_to_next_location(
            dest, flying, np.ones(n), rng.integers(0, 2, n).astype(np.int32),
            mats,
        )
        final = dest.reshape(n, 3)
        path += np.linalg.norm(final - prev, axis=1).sum()
        prev = final.copy()
        assert not flying.any() and (mats == -1).all()
    # The facade sizes each move's record buffers (from the mesh's face
    # density before the first move, then from the last move's segments),
    # so no walk runs twice.
    assert walk_cuda.RELAUNCHES == re
    assert walk_cuda.LAUNCHES - before == 4
    np.testing.assert_allclose(tally.raw_flux[..., 0].sum(), path, rtol=1e-9)


def test_kernel_rejects_mixed_devices(cuda):
    from pumiumtally_tpu_torch.ops import walk_cuda

    mesh = _jittered(2, torch.float32, cuda)
    n = 8
    args = [
        mesh,
        torch.zeros(n, 3, device=cuda),
        torch.zeros(n, 3, device=cuda),
        torch.zeros(n, dtype=torch.int32),  # on the CPU: refused
        torch.ones(n, dtype=torch.bool, device=cuda),
        torch.ones(n, device=cuda),
        torch.zeros(n, dtype=torch.int32, device=cuda),
        torch.zeros(n, dtype=torch.int32, device=cuda),
        torch.zeros(mesh.ntet * 2, device=cuda),
    ]
    with pytest.raises(ValueError, match="elem"):
        walk_cuda.trace(*args, initial=False, max_crossings=10, n_groups=1)


def test_point_source_bin_holds_most_records(cuda):
    """Every lane starts in one element with one group: that bin's records
    go through the block sort and merge passes of the ordered scatter."""
    from pumiumtally_tpu_torch.ops import scatter, walk, walk_cuda

    dtype, G, n = torch.float32, 1, 8192
    mesh = _jittered(6, dtype, cuda)
    rng = np.random.default_rng(3)
    e0 = mesh.ntet // 2
    elem = torch.full((n,), e0, dtype=torch.int32, device=cuda)
    origin = mesh.centroids()[e0].expand(n, 3).contiguous()
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dest = origin + torch.from_numpy(d * rng.exponential(0.2, (n, 1))).to(
        cuda, dtype)
    fly = torch.ones(n, dtype=torch.bool, device=cuda)
    w = torch.ones(n, dtype=dtype, device=cuda)
    g = torch.zeros(n, dtype=torch.int32, device=cuda)
    mat = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    args = (mesh, origin, dest, elem, fly, w, g, mat)
    kw = dict(max_crossings=mesh.ntet + 8, n_groups=G)
    _, rec = walk_cuda.walk_records(*args, _flux0(mesh, G, dtype, cuda),
                                    **kw)
    assert int(torch.bincount(rec.bin).max()) >= n
    k = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda), initial=False,
                        **kw)
    p = walk.trace(*args, _flux0(mesh, G, dtype, cuda), initial=False, **kw)
    _lanes_equal(k, p)
    assert torch.equal(k.flux, p.flux)
    before = scatter.ORDERED_LAUNCHES
    f = scatter.scatter_ordered(_flux0(mesh, G, dtype, cuda), rec.bin,
                                rec.order, rec.c)
    assert scatter.ORDERED_LAUNCHES == before + 1
    assert torch.equal(f, p.flux)


def _records(m, nbins, dtype, cuda, seed=0, hot=0.0):
    """m records with many collisions, shuffled; a share ``hot`` of them in
    bin 0."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, nbins, m)
    b[rng.uniform(size=m) < hot] = 0
    order = rng.permutation(m * 3)[:m]
    t = torch.from_numpy
    return (t(b.astype(np.int32)).to(cuda), t(order.astype(np.int64)).to(cuda),
            t(rng.uniform(0.01, 2.0, m)).to(cuda, dtype))


@pytest.mark.parametrize("nbins", [700, 2000, 20000])  # ~43, ~15, ~1.5 a bin
@pytest.mark.parametrize("hot", [0.0, 0.6])
@pytest.mark.parametrize("score_squares", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_scatter_kernels_match_plain(cuda, dtype, score_squares, hot, nbins):
    from pumiumtally_tpu_torch.ops import scatter

    m = 30000
    b, order, c = _records(m, nbins, dtype, cuda, hot=hot)
    seed = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, 2 * nbins)).to(cuda, dtype)
    a0, o0 = scatter.ATOMIC_LAUNCHES, scatter.ORDERED_LAUNCHES
    got = scatter.scatter_ordered(seed.clone(), b, order, c, score_squares)
    ref = scatter.scatter_ordered_plain(seed.clone(), b, order, c,
                                        score_squares)
    assert torch.equal(got, ref)
    got = scatter.scatter_atomic(seed.clone(), b, c, score_squares)
    ref = scatter.scatter_atomic_plain(seed.clone(), b, c, score_squares)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)
    assert scatter.ATOMIC_LAUNCHES == a0 + 1
    assert scatter.ORDERED_LAUNCHES == o0 + 1
    if not score_squares:
        assert torch.equal(got[1::2], seed[1::2])


@pytest.mark.parametrize("m", [1, 3, 4, 30001])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("score_squares", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_atomic_scatter_tails_and_offsets(cuda, dtype, score_squares, offset,
                                          m):
    """K3 outer takes 4 records a thread: counts that leave a tail, and
    records that start off a 16 B boundary (loaded one by one)."""
    from pumiumtally_tpu_torch.ops import scatter

    nbins = 2000
    b, _, c = _records(m + offset, nbins, dtype, cuda, seed=m)
    b, c = b[offset:], c[offset:]
    seed = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, 2 * nbins)).to(cuda, dtype)
    got = scatter.scatter_atomic(seed.clone(), b, c, score_squares)
    ref = scatter.scatter_atomic_plain(seed.clone(), b, c, score_squares)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)


def test_atomic_scatter_refuses_an_unaligned_flux(cuda):
    from pumiumtally_tpu_torch.ops import scatter

    b, _, c = _records(100, 50, torch.float32, cuda)
    flux = torch.zeros(101, device=cuda)[1:]  # 4 B past an 8 B boundary
    with pytest.raises(ValueError, match="aligned"):
        scatter.scatter_atomic(flux, b, c)


def test_scatter_ordered_breaks_ties_in_record_order(cuda):
    from pumiumtally_tpu_torch.ops import scatter

    m = 5000
    b = torch.zeros(m, dtype=torch.int32, device=cuda)
    order = torch.from_numpy(
        np.random.default_rng(2).integers(0, 4, m)).to(cuda)
    c = torch.from_numpy(
        np.random.default_rng(3).uniform(0, 1, m)).to(cuda, torch.float32)
    f0 = torch.zeros(2, device=cuda)
    got = scatter.scatter_ordered(f0.clone(), b, order, c)
    assert torch.equal(got, scatter.scatter_ordered_plain(f0.clone(), b,
                                                          order, c))


def _bucket_case(case, cuda, dtype):
    """Records for one case of the bucket path (bin, order, c, nbins) and
    the path the call must take."""
    from pumiumtally_tpu_torch.ops import scatter

    rng = np.random.default_rng(len(case))
    path = None  # the bucket path, by the density's fold
    if case in ("uniform", "ties", "unaligned", "wide keys"):
        m, nbins = 30000, 20000
        b = rng.integers(0, nbins, m + 1)
    elif case == "bin sizes":  # bins of 1, 8, 9, 32, 33 and 600 records
        nbins = 4096
        sizes = {3: 1, 40: 8, 41: 9, 300: 32, 301: 33, 1000: 600}
        b = np.concatenate([np.full(k, x) for x, k in sizes.items()]
                           + [rng.integers(2048, nbins, 5000)])
        m = b.size
    elif case in ("capacity", "capacity + 1"):  # all in the first bucket
        m, nbins = scatter.BUCKET_CAPACITY + (case != "capacity"), 1 << 16
        width = 1 << scatter.bucket_shift(m, nbins)
        b = rng.integers(0, width, m)
        b[:300] = 5  # a bin ranked by the block
        path = None if case == "capacity" else "crowded"
    elif case == "ragged":  # a short last bucket, its last bin crowded
        m, nbins = 20000, 20001
        b = rng.integers(0, nbins, m)
        b[:500] = nbins - 1
    elif case.startswith("sparse"):  # 2^26 bins, far below the crossover
        m, nbins = 300_000, 1 << 26
        b = rng.integers(0, nbins, m)
        if case == "sparse capacity":  # bucket 7 at the capacity
            width = 1 << scatter.bucket_shift(m, nbins)
            b[b // width == 7] += width
            b[:scatter.BUCKET_CAPACITY] = 7 * width + rng.integers(
                0, width, scatter.BUCKET_CAPACITY)
            b[:300] = 7 * width + 5
        elif case == "sparse bin of 40":
            b[:40] = 12345
        path = "sparse"
    else:  # "empty", "one"
        m, nbins = {"empty": 0, "one": 1}[case], 1000
        b = rng.integers(0, nbins, m)
    b = rng.permutation(b)
    order = (rng.integers(0, max(m // 8, 1), b.size) if case == "ties"
             else rng.permutation(3 * b.size)[:b.size])
    if case == "wide keys":  # (bin, order, index) does not fit 63 bits
        order = rng.integers(-2**61, 2**61, b.size)
        order[:2] = -2**61, 2**61
        path = "crowded"
    t = torch.from_numpy
    rec = (t(b.astype(np.int32)).to(cuda), t(order.astype(np.int64)).to(cuda),
           t(rng.uniform(0.01, 2.0, b.size)).to(cuda, dtype))
    if case == "unaligned":  # 4 B / 8 B past the arrays' start
        rec = tuple(r[1:] for r in rec)
    else:
        rec = tuple(r[:m] for r in rec)
    if path is None:
        path = "sparse" if m < scatter.SPARSE_BELOW * nbins else "bucket"
    return rec, nbins, path


@pytest.mark.parametrize("case", [
    "uniform", "ties", "bin sizes", "capacity", "capacity + 1", "empty", "one",
    "ragged", "unaligned", "wide keys", "sparse", "sparse capacity",
    "sparse bin of 40"])
@pytest.mark.parametrize("score_squares", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bucket_path_matches_plain(cuda, dtype, score_squares, case,
                                   monkeypatch):
    """The ordered scatter's bucket path, bitwise its plain version, and
    the path each case takes: a bucket at exactly the capacity fits, one
    more record sends the call to the crowded path, and so do order keys
    too wide for a bucket key; below the crossover the sparse fold. Each
    call on the bucket path is repeated with each fold forced: the dense
    and the sparse fold (``SPARSE_BELOW`` at 0 and at infinity) give the
    plain version's bits."""
    from pumiumtally_tpu_torch.ops import scatter

    (b, order, c), nbins, path = _bucket_case(case, cuda, dtype)
    m = b.numel()
    seed = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, 2 * nbins)).to(cuda, dtype)

    def counts():
        return (scatter.ORDERED_LAUNCHES, scatter.BUCKET_LAUNCHES,
                scatter.SPARSE_LAUNCHES, scatter.CROWDED_LAUNCHES)

    before = counts()
    got = scatter.scatter_ordered(seed.clone(), b, order, c, score_squares)
    ref = scatter.scatter_ordered_plain(seed.clone(), b, order, c,
                                        score_squares)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if not score_squares:
        assert torch.equal(got[1::2], seed[1::2])
    ran = [a - z for a, z in zip(counts(), before)]
    if m == 0:
        assert ran == [0, 0, 0, 0]
        return
    assert ran == {"bucket": [1, 1, 0, 0], "sparse": [1, 1, 1, 0],
                   "crowded": [1, 0, 0, 1]}[path]
    info = dict(scatter.LAST_BUCKETS)
    shift = scatter.bucket_shift(m, nbins)
    sizes = scatter.bucket_counts_plain(b, nbins, shift)
    assert info["path"] == path and info["shift"] == shift
    assert info["largest"] == int(sizes.max())
    assert (info["key_bits"] > 63) == (case == "wide keys")
    if case in ("capacity", "sparse capacity"):
        assert info["largest"] == scatter.BUCKET_CAPACITY
    if path != "crowded":
        for fold, below in (("bucket", 0.0), ("sparse", math.inf)):
            monkeypatch.setattr(scatter, "SPARSE_BELOW", below)
            forced = scatter.ordered_cuda(seed.clone(), b, order, c,
                                          score_squares, nbins)
            assert scatter.LAST_BUCKETS["path"] == fold
            assert torch.equal(forced, ref), fold


@pytest.mark.parametrize("cols,dtype,idx_dtype,n,shift,piece", [
    (20, torch.float32, torch.int32, 70000, 0, 16),  # a geo20 row, 5 x 16 B
    (16, torch.float32, torch.int64, 70000, 0, 16),  # the JAX probe's 64 B
    (20, torch.float64, torch.int32, 70000, 0, 16),  # float64 geo20, 160 B
    (20, torch.float64, torch.int64, 70001, 0, 16),  # count off the tile
    (3, torch.float32, torch.int32, 70000, 0, 4),    # 12 B rows, 4 B pieces
    (3, torch.float64, torch.int64, 70000, 0, 8),    # 24 B rows, 8 B pieces
    (2, torch.float32, torch.int64, 513, 0, 8),      # 8 B rows
    (20, torch.float32, torch.int32, 70001, 1, 4),   # table 4 B off 16 B
    (20, torch.float32, torch.int64, 70001, 2, 8),   # table 8 B off 16 B
    (20, torch.float64, torch.int32, 70001, 1, 8),   # table 8 B off 16 B
    (5, torch.float32, torch.int32, 1, 0, 4),        # one row
])
def test_gather_matches_plain(cuda, cols, dtype, idx_dtype, n, shift, piece):
    """Each piece size of the kernel bitwise against ``tbl[idx]`` (the
    table's words drawn as integers, so NaN patterns and codes are among
    them); a misaligned table view takes narrower pieces; indices out of
    range raise before any launch."""
    from pumiumtally_tpu_torch.ops import gather

    rng = np.random.default_rng(4)
    R = 5000
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    words = torch.from_numpy(rng.integers(-2**31, 2**31, R * cols + shift))
    tbl = words.to(cuda, bits).view(dtype)[shift:].view(R, cols)
    assert tbl.is_contiguous()
    idx = torch.from_numpy(rng.integers(0, R, n)).to(cuda, idx_dtype)
    row_bytes = cols * tbl.element_size()
    assert gather.piece_bytes(row_bytes, tbl.data_ptr(), 256) == piece
    before = gather.LAUNCHES
    out = gather.gather_rows(tbl, idx)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == before + 1
    assert torch.equal(out.view(bits), gather.gather_rows_plain(
        tbl, idx).view(bits))
    for bad in (R, -1):
        with pytest.raises(IndexError):
            gather.gather_rows(tbl, idx.clone().index_fill_(0, idx[:1] * 0,
                                                            bad))
    assert gather.LAUNCHES == before + 1


def test_gather_past_2_31_pieces(cuda):
    """More than 2^31 pieces of 4 B (a table view 4 B off alignment, rows
    of 4,000 B, an 8.6 GB output): the launch takes its 64-bit piece
    index and every word lands; compared in slices to bound the memory."""
    from pumiumtally_tpu_torch.ops import gather

    R, cols = 4099, 1000
    n = (1 << 31) // cols + 7
    g = torch.Generator(device=cuda).manual_seed(9)
    words = torch.randint(-2**31, 2**31, (R * cols + 1,), generator=g,
                          device=cuda, dtype=torch.int32)
    tbl = words[1:].view(torch.float32).view(R, cols)
    idx = torch.randint(0, R, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    assert gather.piece_bytes(cols * 4, tbl.data_ptr()) == 4
    out = gather.gather_rows(tbl, idx)
    torch.cuda.synchronize()
    assert out.numel() > 2**31
    for a in range(0, n, 1 << 20):
        b = min(n, a + (1 << 20))
        assert torch.equal(out[a:b].view(torch.int32),
                           tbl[idx[a:b].long()].view(torch.int32)), a


def test_gather_empty_and_zero_width(cuda):
    from pumiumtally_tpu_torch.ops import gather

    tbl = torch.zeros(4, 20, device=cuda)
    before = gather.LAUNCHES
    out = gather.gather_rows(tbl, torch.zeros(0, dtype=torch.int32,
                                              device=cuda))
    assert out.shape == (0, 20) and out.device.type == "cuda"
    out = gather.gather_rows(torch.zeros(4, 0, device=cuda),
                             torch.tensor([3, 0], device=cuda))
    assert out.shape == (2, 0)
    assert gather.LAUNCHES == before  # nothing to launch


def test_gather_output_past_2_31_bytes(cuda):
    """A float64 gather whose output passes 2^31 bytes (the float64 walk
    shape writes 2.71 GB): offsets are 64-bit, every word lands."""
    from pumiumtally_tpu_torch.ops import gather

    R, cols = 998_250, 20
    n = (1 << 31) // (cols * 8) + 4099
    g = torch.Generator(device=cuda).manual_seed(8)
    tbl = torch.randint(-2**62, 2**62, (R, cols), generator=g,
                        device=cuda).view(torch.float64)
    idx = torch.randint(0, R, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    before = gather.LAUNCHES
    out = gather.gather_rows(tbl, idx)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == before + 1
    assert out.numel() * 8 > 2**31
    assert torch.equal(out.view(torch.int64),
                       gather.gather_rows_plain(tbl, idx).view(torch.int64))


# --------------------------------------------------------------------- #
# Move-loop I/O on the card (ops/staging.py, io_pipeline, the pipeline)
# --------------------------------------------------------------------- #
def _drive_facade(io, dtype, cuda, n=4096, moves=3):
    """A facade run on a two-material box; returns each move's write-backs,
    the raw flux and the transfers of the last move."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig

    mesh = _jittered(6, dtype, cuda)
    t = PumiTally(mesh, n, TallyConfig(n_groups=3, dtype=dtype,
                                       io_pipeline=io))
    rng = np.random.default_rng(6)
    prev = rng.uniform(0.05, 0.95, (n, 3))
    t.initialize_particle_location(prev.reshape(-1).copy())
    outs = []
    for _ in range(moves):
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        dest = (prev + d * rng.exponential(0.2, (n, 1))).reshape(-1)
        flying = (rng.uniform(size=n) > 0.1).astype(np.int8)
        mats = np.full(n, 9, np.int32)
        before = dict(t.io)
        t.move_to_next_location(dest, flying, rng.uniform(0.5, 2.0, n),
                                rng.integers(0, 3, n).astype(np.int32), mats)
        outs.append((dest.copy(), mats.copy()))
        prev = dest.reshape(n, 3).copy()
    io = {k: t.io[k] - before[k] for k in before}
    return outs, t.raw_flux, t.element_ids, io


@pytest.mark.parametrize("io", ["packed", "overlap"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_packed_io_matches_legacy(cuda, dtype, io):
    """Packed and overlap staging give the legacy path's write-backs, flux
    and elements bit for bit, with one transfer each way a move."""
    outs_a, flux_a, elems_a, io_a = _drive_facade("legacy", dtype, cuda)
    outs_b, flux_b, elems_b, io_b = _drive_facade(io, dtype, cuda)
    for (da, ma), (db, mb) in zip(outs_a, outs_b):
        np.testing.assert_array_equal(db, da)
        np.testing.assert_array_equal(mb, ma)
    np.testing.assert_array_equal(flux_b, flux_a)
    np.testing.assert_array_equal(elems_b, elems_a)
    assert (io_a["h2d_transfers"], io_a["d2h_transfers"]) == (4, 1)
    assert (io_b["h2d_transfers"], io_b["d2h_transfers"]) == (1, 1)


def test_host_stager_buffers_are_pinned(cuda):
    from pumiumtally_tpu_torch.ops.staging import HostStager

    st = HostStager(depth=2, device=cuda)
    a = st.buf((64, 6), torch.int32, "move")
    b = st.buf((64, 6), torch.int32, "move")
    assert a.is_pinned() and b.is_pinned()
    assert a.data_ptr() != b.data_ptr()
    assert st.buf((64, 6), torch.int32, "move").data_ptr() == a.data_ptr()


def test_pipeline_depth2_matches_sequential(cuda):
    """Four batches through the pipeline (copy stream, depth 2) give the
    flux and positions of the same batches walked one after another."""
    from pumiumtally_tpu_torch import TallyConfig
    from pumiumtally_tpu_torch.models.pipeline import StreamingTallyPipeline
    from pumiumtally_tpu_torch.ops import walk_cuda

    dtype, G, n = torch.float32, 4, 4096
    mesh = _jittered(6, dtype, cuda)
    cfg = TallyConfig(n_groups=G, dtype=dtype)
    rng = np.random.default_rng(12)
    cent = mesh.centroids().double().cpu().numpy()
    batches = []
    for _ in range(4):
        elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
        dest = rng.uniform(-0.05, 1.05, (n, 3))
        w = rng.uniform(0.5, 2.0, n)
        g = rng.integers(0, G, n).astype(np.int32)
        batches.append((cent[elem], dest, elem, w, g))
    pipe = StreamingTallyPipeline(mesh, cfg, depth=2)
    for b in batches:
        pipe.submit(*b)
    flux = pipe.finish()
    ref = torch.zeros(mesh.ntet * G * 2, dtype=dtype, device=cuda)
    positions = []
    for origin, dest, elem, w, g in batches:
        def t(a, dt):
            return torch.from_numpy(a).to(cuda, dt)

        r = walk_cuda.trace(
            mesh, t(origin, dtype), t(dest, dtype), t(elem, torch.int32),
            torch.ones(n, dtype=torch.bool, device=cuda), t(w, dtype),
            t(g, torch.int32),
            torch.full((n,), -1, dtype=torch.int32, device=cuda), ref,
            initial=False, max_crossings=mesh.ntet + 64, n_groups=G)
        positions.append(r.position.cpu().numpy())
    np.testing.assert_array_equal(flux.reshape(-1), ref.cpu().numpy())
    got = list(pipe.results())
    assert [b.index for b in got] == [0, 1, 2, 3]
    for b, want in zip(got, positions):
        np.testing.assert_array_equal(b.position, want)


def test_record_guard_raises_before_any_allocation(cuda, monkeypatch):
    """A walk that made 2^31 records raises in the walk wrapper before
    the relaunch's buffers are allocated, and the ordered scatter refuses
    2^31 records before it allocates (expanded tensors: no memory)."""
    from pumiumtally_tpu_torch.ops import scatter, walk_cuda

    dtype = torch.float32
    mesh = _jittered(2, dtype, cuda)
    args = _walk_inputs(mesh, cuda, dtype, n=64, G=2)
    calls = []

    def fake_launch(*a, **kw):
        calls.append(kw["capacity"])
        return {}, None, 2**31

    monkeypatch.setattr(walk_cuda, "_launch", fake_launch)
    with pytest.raises(ValueError, match="tally records"):
        walk_cuda.trace(*args, torch.zeros(mesh.ntet * 4, device=cuda),
                        initial=False, max_crossings=64, n_groups=2)
    assert len(calls) == 1
    m = 2**31
    one = torch.zeros(1, device=cuda)
    held = torch.cuda.memory_allocated()
    with pytest.raises(ValueError, match="int32"):
        scatter.ordered_cuda(
            one.expand(2),
            torch.zeros(1, dtype=torch.int32, device=cuda).expand(m),
            torch.zeros(1, dtype=torch.int64, device=cuda).expand(m),
            one.expand(m), True, 1)
    assert torch.cuda.memory_allocated() == held


# --------------------------------------------------------------------- #
# Run statistics and recovery on the card (sd_mode="batch", convergence,
# truncation re-walks, quarantine, telemetry)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("point", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_walk_without_squares_leaves_odd_entries(cuda, dtype, point):
    """score_squares=False reaches the ordered scatter's bucket path and
    (a point source) its crowded path: even entries bitwise the plain
    walk's, odd entries untouched."""
    from pumiumtally_tpu_torch.ops import scatter, walk, walk_cuda

    mesh = _jittered(8, dtype, cuda)
    args = list(_walk_inputs(mesh, cuda, dtype, n=20000, G=2))
    if point:
        args[1] = args[1][:1].expand_as(args[1]).contiguous()
        args[3] = args[3][:1].expand_as(args[3]).contiguous()
    kw = dict(initial=False, max_crossings=mesh.ntet + 64, n_groups=2,
              score_squares=False)
    seed = _flux0(mesh, 2, dtype, cuda)
    paths = (scatter.BUCKET_LAUNCHES, scatter.CROWDED_LAUNCHES)
    got = walk_cuda.trace(*args, seed.clone(), **kw)
    ref = walk.trace(*args, seed.clone(), **kw)
    took = (scatter.BUCKET_LAUNCHES - paths[0],
            scatter.CROWDED_LAUNCHES - paths[1])
    assert took == ((0, 1) if point else (1, 0))
    assert torch.equal(got.flux, ref.flux)
    assert torch.equal(got.flux[1::2], seed[1::2])
    assert not torch.equal(got.flux[0::2], seed[0::2])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rewalk_kernel_matches_plain(cuda, dtype):
    """Truncated lanes re-walked by the kernel from the device-resident
    mid-walk state: positions, elements, material ids and the flux
    bitwise those of the plain walk over the same attempts."""
    from pumiumtally_tpu_torch.ops import walk, walk_cuda

    mesh = _jittered(8, dtype, cuda)
    args = _walk_inputs(mesh, cuda, dtype, n=8192)
    kw = dict(initial=False, n_groups=4)
    seed = _flux0(mesh, 4, dtype, cuda)
    first = walk_cuda.trace(*args, seed.clone(), max_crossings=3, **kw)
    plain_first = walk.trace(*args, seed.clone(), max_crossings=3, **kw)
    assert torch.equal(first.flux, plain_first.flux)
    assert int((~first.done).sum()) > 1000
    before = walk_cuda.LAUNCHES
    got, retried, lost = walk_cuda.rewalk_truncated(
        mesh, first, args[2], args[5], args[6], retries=6,
        max_crossings=3, **kw)
    ref, retried_p, lost_p = walk.rewalk_truncated(
        mesh, plain_first, args[2], args[5], args[6], retries=6,
        max_crossings=3, **kw)
    assert walk_cuda.LAUNCHES > before
    assert (retried, lost) == (retried_p, lost_p) and lost == 0
    for f in ("position", "elem", "material_id", "done", "flux"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert torch.equal(got.stats, ref.stats)


def _stats_facade(cuda, dtype, n=8192, moves=4, flag_nan=(), **cfg):
    """A facade run on the card with ``cfg``; returns the tally, each
    move's write-backs and the even entries after each move (float64)."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig

    mesh = _jittered(8, dtype, cuda)
    t = PumiTally(mesh, n, TallyConfig(n_groups=4, dtype=dtype, **cfg))
    rng = np.random.default_rng(12)
    prev = rng.uniform(0.05, 0.95, (n, 3))
    t.initialize_particle_location(prev.reshape(-1).copy())
    outs, evens = [], []
    for _ in range(moves):
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        dest = (prev + d * rng.exponential(0.08, (n, 1))).reshape(-1)
        flying = np.ones(n, np.int8)
        if flag_nan == "park":
            flying[:100] = 0
        elif flag_nan == "nan":
            dest.reshape(n, 3)[:100] = np.nan
        mats = np.zeros(n, np.int32)
        t.move_to_next_location(dest, flying, np.ones(n),
                                rng.integers(0, 4, n).astype(np.int32),
                                mats)
        outs.append((dest.copy(), mats.copy()))
        evens.append(t.raw_flux[..., 0].astype(np.float64).reshape(-1))
        prev = dest.reshape(n, 3).copy()
    return t, outs, evens


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_convergence_and_batch_sd_on_card(cuda, dtype):
    """Convergence only reads (flux bitwise that of a run without it,
    one transfer each way a move) and its summary is the float64 host
    recomputation from the moves' even entries; batch sd gives the same
    even entries and Σ of squared per-move bin totals in the odd ones."""
    rtol = 1e-9 if dtype == torch.float64 else 1e-5
    base, outs0, evens = _stats_facade(cuda, dtype)
    conv_t, outs1, _ = _stats_facade(cuda, dtype, convergence=True,
                                     batch_moves=2)
    assert np.array_equal(conv_t.raw_flux, base.raw_flux)
    for (a, b), (c, d) in zip(outs0, outs1):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    tm = conv_t.telemetry()
    assert (tm["totals"]["h2d_transfers"], tm["totals"]["d2h_transfers"]) \
        == (5, 5)
    c = tm["convergence"]
    assert c["n_batches"] == 2
    snaps = np.stack([np.zeros_like(evens[0]), evens[1], evens[3]])
    T = np.diff(snaps, axis=0)
    s1, s2 = T.sum(0), (T * T).sum(0)
    scored = s1 > 0
    rel = np.where(scored, np.sqrt(np.maximum(2 * s2 - s1 * s1, 0.0))
                   / np.where(scored, s1, 1.0), 0.0)
    assert c["scored"] == int(scored.sum())
    np.testing.assert_allclose(c["rel_err_max"], rel.max(), rtol=rtol)
    np.testing.assert_allclose(c["rel_err_mean"],
                               rel.sum() / scored.sum(), rtol=rtol)
    batch, _, _ = _stats_facade(cuda, dtype, sd_mode="batch")
    assert np.array_equal(batch.raw_flux[..., 0], base.raw_flux[..., 0])
    totals = np.diff(np.stack([np.zeros_like(evens[0])] + evens), axis=0)
    np.testing.assert_allclose(batch.raw_flux[..., 1].reshape(-1),
                               (totals * totals).sum(0), rtol=rtol,
                               atol=0)


def test_truncation_and_quarantine_on_card(cuda):
    """A tiny crossing bound with retries recovers every lane and gives
    the ample run's elements; quarantined NaN lanes give the flux of the
    run in which those lanes are parked, bit for bit."""
    dtype = torch.float32
    ample, outs_a, _ = _stats_facade(cuda, dtype)
    esc, outs_e, _ = _stats_facade(cuda, dtype, max_crossings=2,
                                   truncation_retries=5)
    tm = esc.telemetry()["totals"]
    assert tm["rewalked"] > 0 and tm["lost"] == 0
    np.testing.assert_array_equal(esc.element_ids, ample.element_ids)
    np.testing.assert_allclose(esc.raw_flux, ample.raw_flux, rtol=1e-5,
                               atol=1e-5)
    parked, outs_p, _ = _stats_facade(cuda, dtype, flag_nan="park")
    quar, outs_q, _ = _stats_facade(cuda, dtype, flag_nan="nan",
                                    quarantine=True)
    assert quar.quarantined_lanes().sum() == 4 * 100
    assert np.isfinite(quar.raw_flux).all()
    assert np.array_equal(quar.raw_flux, parked.raw_flux)
    for (a, b), (c, d) in zip(outs_p, outs_q):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_device_memory_stats_on_card(cuda):
    from pumiumtally_tpu_torch.utils.profiling import device_memory_stats

    x = torch.ones(1 << 20, device=cuda)
    stats = device_memory_stats()
    rec = stats[f"cuda:{x.device.index}"]
    assert rec["peak_bytes_in_use"] >= rec["bytes_in_use"] >= x.nbytes
    assert rec["bytes_limit"] > rec["peak_bytes_in_use"]


# --------------------------------------------------------------------- #
# The walk's feature tails on the card (record_xpoints, the element sort,
# the invariant checks)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("robust", [True, False])
@pytest.mark.parametrize("initial", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_xpoints_kernel_matches_plain(cuda, dtype, initial, robust):
    """The feature instantiation records each lane's points and counts
    bitwise the plain walk's (counts past K keep counting), and walks and
    scores as the default one does; a forced overflow relaunch records
    afresh, not twice."""
    from pumiumtally_tpu_torch.ops import walk, walk_cuda

    mesh = _jittered(6, dtype, cuda)
    G, K = 4, 5
    args = _walk_inputs(mesh, cuda, dtype, G=G)
    kw = dict(initial=initial, max_crossings=mesh.ntet + 8, n_groups=G,
              robust=robust)
    feats, re = walk_cuda.FEATURE_LAUNCHES, walk_cuda.RELAUNCHES
    k = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda),
                        record_xpoints=K, **kw)
    # One launch, and one more if its records overflowed the buffers.
    assert walk_cuda.FEATURE_LAUNCHES - feats == 1 + walk_cuda.RELAUNCHES - re
    off = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
    p = walk.trace(*args, _flux0(mesh, G, dtype, cuda), record_xpoints=K,
                   **kw)
    torch.cuda.synchronize()
    _lanes_equal(k, p)
    _lanes_equal(k, off)
    assert torch.equal(k.flux, p.flux) and torch.equal(k.flux, off.flux)
    assert torch.equal(k.n_xpoints, p.n_xpoints)
    assert torch.equal(k.xpoints, p.xpoints)
    assert int(k.n_xpoints.max()) > K
    if not initial:
        again = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda),
                                record_xpoints=K, capacity=7, **kw)
        assert torch.equal(again.n_xpoints, p.n_xpoints)
        assert torch.equal(again.xpoints, p.xpoints)
        assert torch.equal(again.flux, p.flux)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rewalk_appends_points_on_card(cuda, dtype):
    """Re-walks continue the point buffers in place: points and counts
    bitwise the plain walk's over the same attempts."""
    from pumiumtally_tpu_torch.ops import walk, walk_cuda

    mesh = _jittered(8, dtype, cuda)
    args = _walk_inputs(mesh, cuda, dtype, n=8192)
    kw = dict(initial=False, n_groups=4, record_xpoints=6)
    seed = _flux0(mesh, 4, dtype, cuda)
    first = walk_cuda.trace(*args, seed.clone(), max_crossings=3, **kw)
    pfirst = walk.trace(*args, seed.clone(), max_crossings=3, **kw)
    got, _, lost = walk_cuda.rewalk_truncated(
        mesh, first, args[2], args[5], args[6], retries=6, max_crossings=3,
        **kw)
    ref, _, _ = walk.rewalk_truncated(
        mesh, pfirst, args[2], args[5], args[6], retries=6, max_crossings=3,
        **kw)
    assert lost == 0
    for f in ("xpoints", "n_xpoints", "position", "flux"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert int(got.n_xpoints.max()) > 3


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_checks_on_card_raise_and_leave_the_context(cuda, dtype):
    """A clean checked walk is bitwise the unchecked one; a corrupted
    parent element and a NaN destination raise the plain walk's messages
    (the error word, no device assert), the flux is left as it was, and
    the next walk in the process runs and gives its bits; the atomic
    tally refuses the features."""
    from pumiumtally_tpu_torch.ops import walk, walk_cuda
    from pumiumtally_tpu_torch.ops.walk import CHECKS, WalkInvariantError

    mesh = _jittered(6, dtype, cuda)
    G = 4
    args = list(_walk_inputs(mesh, cuda, dtype, G=G))
    kw = dict(initial=False, max_crossings=mesh.ntet + 8, n_groups=G)
    ref = walk.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
    k = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda),
                        debug_checks=True, **kw)
    assert torch.equal(k.flux, ref.flux)
    _lanes_equal(k, ref)
    cents = mesh.centroids()
    far = int(torch.argmax(((cents - args[1][0]) ** 2).sum(dim=1)))
    bad_elem = args[3].clone()
    bad_elem[0] = far
    bad_dest = args[2].clone()
    bad_dest[5] = float("nan")
    for i, msg in ((3, CHECKS[0]), (2, CHECKS[1])):
        bad = list(args)
        bad[i] = bad_elem if i == 3 else bad_dest
        for fn in (walk.trace, walk_cuda.trace):
            flux = _flux0(mesh, G, dtype, cuda)
            with pytest.raises(WalkInvariantError) as e:
                fn(*bad, flux, debug_checks=True, **kw)
            assert str(e.value) == msg
            assert torch.equal(flux, _flux0(mesh, G, dtype, cuda))
        after = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
        torch.cuda.synchronize()
        assert torch.equal(after.flux, ref.flux)
    with pytest.raises(ValueError, match="atomic"):
        walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda), tally="atomic",
                        debug_checks=True, **kw)


def test_sort_on_card_across_modes_and_runs(cuda):
    """The element sort every move on the card: the three io_pipeline
    modes bitwise equal, two runs bitwise equal (the stable sort), and
    against the sort-off run the write-backs and elements bitwise, the
    flux to its add order."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig

    dtype, n = torch.float32, 8192
    mesh = _jittered(8, dtype, cuda)

    def run(io, **cfg):
        t = PumiTally(mesh, n, TallyConfig(n_groups=4, dtype=dtype,
                                           io_pipeline=io, **cfg))
        rng = np.random.default_rng(12)
        prev = rng.uniform(0.05, 0.95, (n, 3))
        t.initialize_particle_location(prev.reshape(-1).copy())
        outs = []
        for _ in range(3):
            d = rng.normal(size=(n, 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            dest = (prev + d * rng.exponential(0.08, (n, 1))).reshape(-1)
            mats = np.zeros(n, np.int32)
            t.move_to_next_location(dest, np.ones(n, np.int8), np.ones(n),
                                    rng.integers(0, 4, n).astype(np.int32),
                                    mats)
            outs.append((dest.copy(), mats.copy()))
            prev = dest.reshape(n, 3).copy()
        return t, outs

    sort = dict(sort_by_element=True, migration_period=1)
    runs = [run(io, **sort) for io in ("legacy", "packed", "overlap",
                                       "packed")]
    off, outs_off = run("packed")
    base, outs_base = runs[0]
    assert base._perm is not None
    for t, outs in runs[1:] + [(off, outs_off)]:
        for (a, b), (c, d) in zip(outs_base, outs):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
        np.testing.assert_array_equal(t.element_ids, base.element_ids)
    for t, _ in runs[1:]:
        assert np.array_equal(t.raw_flux, base.raw_flux)
    np.testing.assert_allclose(off.raw_flux, base.raw_flux, rtol=1e-4,
                               atol=1e-6)


# --------------------------------------------------------------------- #
# The device source (csrc/source.cu) and the megastep
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sample_flight_kernel_matches_plain(cuda, dtype):
    """The flight kernel's uniforms bitwise the plain threefry's, its
    collision and roulette draws bitwise, its destinations within one ulp
    of the plain version's on the card (cos, sin, log1p from the same
    libdevice: expected bitwise), dead lanes at their origin."""
    from pumiumtally_tpu_torch.ops import source, source_cuda

    mesh = _jittered(6, dtype, cuda)
    n = 20000
    rng = np.random.default_rng(3)
    pid = torch.from_numpy(np.arange(-1, n - 1, dtype=np.int32)).to(cuda)
    elem = torch.from_numpy(rng.integers(0, mesh.ntet, n).astype(
        np.int32)).to(cuda)
    alive = torch.from_numpy(rng.uniform(size=n) < 0.8).to(cuda)
    origin = mesh.centroids()[elem.long()].contiguous()
    sig = torch.tensor([3.0, 7.0], dtype=dtype, device=cuda)
    key = source.fold_in(source.prng_key(2**33 + 7), 5)
    u = torch.empty(n, 5, dtype=dtype, device=cuda)
    before = source_cuda.LAUNCHES
    dest, cu, ru = source_cuda.sample_flight(key, pid, n, elem, alive, origin,
                                             mesh.class_id, sig, u_out=u)
    torch.cuda.synchronize()
    assert source_cuda.LAUNCHES == before + 1
    want_u = source.lane_uniforms(key, pid, n, dtype)
    assert torch.equal(u.view(torch.uint8), want_u.view(torch.uint8))
    pd, pc, pr = source.sample_flight_plain(key, pid, n, elem, alive, origin,
                                            mesh.class_id, sig)
    assert torch.equal(cu, pc) and torch.equal(ru, pr)
    assert torch.equal(dest[~alive], origin[~alive])
    ulp = torch.finfo(dtype).eps * pd.abs().clamp_min(1.0)
    assert ((dest - pd).abs() <= ulp).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_megastep_k_bitwise_on_card(cuda, dtype):
    """run_source_moves with megastep=2 gives the bits of megastep=1 on
    the card (the flux ordered), and launches the flight kernel once a
    move."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.ops import source, source_cuda

    mesh = _jittered(8, dtype, cuda)
    n = 4096
    src = source.SourceParams(sigma_t={0: 4.0, 1: 9.0},
                              absorption={0: 0.3, 1: 0.5},
                              survival_weight=0.2, seed=13)
    pos = np.random.default_rng(3).uniform(0.1, 0.9, (n, 3))

    def run(k):
        t = PumiTally(mesh, n, TallyConfig(n_groups=2, dtype=dtype,
                                           megastep=k), device=cuda)
        t.initialize_particle_location(pos.reshape(-1).copy())
        before = source_cuda.LAUNCHES
        out = t.run_source_moves(4, src, weights=np.ones(n),
                                 groups=np.zeros(n, np.int32))
        assert source_cuda.LAUNCHES - before == out["moves"] == 4
        return t, out

    a, oa = run(1)
    b, ob = run(2)
    for f in ("segments", "collisions", "escaped", "rouletted", "alive",
              "truncated"):
        assert oa[f] == ob[f], f
    assert torch.equal(a.flux, b.flux)
    for f in ("origin", "elem", "material_id", "weight", "group",
              "in_flight"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


# --------------------------------------------------------------------- #
# Integrity, checkpoints and the runner on the card
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_integrity_vector_kernel_matches_plain(cuda, dtype, initial):
    """walk_cuda.trace(integrity=True): the walk kernel's outputs give the
    plain walk's integrity vector (counts and bad_flux equal; the sums to
    rounding, 1e-12 relative in float64 and 1e-5 in float32), and the
    flux bitwise that of the walk with the vector off."""
    from pumiumtally_tpu_torch.integrity.invariants import integrity_to_dict
    from pumiumtally_tpu_torch.ops import walk, walk_cuda

    mesh = _jittered(6, dtype, cuda)
    args = list(_walk_inputs(mesh, cuda, dtype, n=2048, G=2))
    kw = dict(initial=initial, max_crossings=mesh.ntet + 8, n_groups=2)
    f_on, f_off, f_plain = (_flux0(mesh, 2, dtype, cuda) for _ in range(3))
    f_on[7] = -1.0  # a planted bad entry
    f_off[7] = f_plain[7] = -1.0
    on = walk_cuda.trace(*args, f_on, integrity=True, **kw)
    off = walk_cuda.trace(*args, f_off, **kw)
    plain = walk.trace(*args, f_plain, integrity=True, **kw)
    assert torch.equal(on.flux, off.flux)
    got = integrity_to_dict(on.integrity.cpu().numpy())
    want = integrity_to_dict(plain.integrity.cpu().numpy())
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    for f in ("bad_flux", "lanes_flying", "lanes_done"):
        assert got[f] == want[f], f
    assert got["bad_flux"] == 1
    for f in ("scored_wlen", "path_wlen", "max_residual"):
        assert got[f] == pytest.approx(want[f], rel=rtol,
                                       abs=rtol * max(1.0, want["path_wlen"]))


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_integrity_vector_fused_kernel_matches_plain(cuda, dtype, initial):
    """The fused kernel (csrc/integrity.cu) on a walk's outputs and a
    flux with planted negative, NaN and infinite entries, against the
    plain vector on the same tensors: counts and bad_flux equal, the sums
    within 1e-12 relative in float64 and 1e-5 in float32 (as
    test_integrity_vector_kernel_matches_plain), the max residual within
    that part of itself plus 4 ulps of max |pseg| (a max does not depend
    on the fold's order, only on the norm's rounding), the same bits from
    two launches, the flux untouched; one launch each. Then a residual of
    0.25 planted on a lane in flight and done, and one of 1.0 on a lane
    not in flight: the fused max finds the first and skips the second."""
    from pumiumtally_tpu_torch.integrity.invariants import integrity_to_dict
    from pumiumtally_tpu_torch.ops import integrity_cuda, walk, walk_cuda

    mesh = _jittered(6, dtype, cuda)
    args = list(_walk_inputs(mesh, cuda, dtype, n=300_000, G=2))
    flux = _flux0(mesh, 2, dtype, cuda)
    r = walk_cuda.trace(*args, flux, initial=initial,
                        max_crossings=mesh.ntet + 8, n_groups=2)
    flux[3], flux[11], flux[12] = -1.0, float("nan"), float("inf")
    vec = (args[4], r.done, args[5], r.track_length, r.position, args[1],
           flux, initial)
    kept = flux.clone()
    before = integrity_cuda.LAUNCHES
    a = integrity_cuda.integrity_vector(*vec)
    b = integrity_cuda.integrity_vector(*vec)
    want = walk.integrity_vector(*vec)
    torch.cuda.synchronize()
    assert integrity_cuda.LAUNCHES - before == 2
    assert torch.equal(a, b)
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(flux.view(bits), kept.view(bits))
    got = integrity_to_dict(a.cpu().numpy())
    ref = integrity_to_dict(want.cpu().numpy())
    for f in ("bad_flux", "lanes_flying", "lanes_done"):
        assert got[f] == ref[f], f
    assert got["bad_flux"] == 3
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    _residual_close(got, ref, vec[3], rtol)
    if initial:
        assert got["scored_wlen"] == got["path_wlen"] == 0.0
        return
    pseg = vec[3].clone()
    i, j = (int(torch.nonzero(m)[0]) for m in (vec[0] & vec[1], ~vec[0]))
    pseg[i] += 0.25
    pseg[j] += 1.0
    planted = vec[:3] + (pseg,) + vec[4:]
    got = integrity_to_dict(integrity_cuda.integrity_vector(*planted)
                            .cpu().numpy())
    ref = integrity_to_dict(walk.integrity_vector(*planted).cpu().numpy())
    assert 0.2 < ref["max_residual"] < 0.3
    _residual_close(got, ref, pseg, rtol)


def _residual_close(got: dict, ref: dict, pseg, rtol: float) -> None:
    """The two sums within ``rtol`` of path_wlen; the max residual within
    ``rtol`` of itself plus 4 ulps of max |pseg|."""
    for f in ("scored_wlen", "path_wlen"):
        assert got[f] == pytest.approx(ref[f], rel=rtol,
                                       abs=rtol * max(1.0, ref["path_wlen"]))
    ulps = 4 * torch.finfo(pseg.dtype).eps * float(pseg.abs().max())
    assert got["max_residual"] == pytest.approx(ref["max_residual"],
                                                rel=rtol, abs=ulps)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_checkpoint_round_trip_on_card(cuda, dtype, tmp_path):
    """Save after move 2, restore into a fresh tally on the card, run
    moves 3-4: flux, positions, elements and write-backs bitwise the
    uninterrupted run's; a transient retried under the runner too."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.resilience.faultinject import (
        FaultInjector,
        parse_faults,
    )
    from pumiumtally_tpu_torch.resilience.runner import ResilientRunner

    mesh = _jittered(6, dtype, cuda)
    n = 4096
    rng = np.random.default_rng(2)
    pos = rng.uniform(0.05, 0.95, (n, 3)).reshape(-1)
    moves = [(rng.uniform(0.05, 0.95, (n, 3)).reshape(-1),
              np.ones(n, np.int8), rng.uniform(0.5, 2.0, n),
              rng.integers(0, 2, n).astype(np.int32),
              np.full(n, -1, np.int32)) for _ in range(4)]

    def tally(**kw):
        t = PumiTally(mesh, n, TallyConfig(n_groups=2, dtype=dtype,
                                           integrity="warn", **kw),
                      device=cuda)
        return t

    def move(t, i):
        a = [np.array(x, copy=True) for x in moves[i]]
        t.move_to_next_location(*a)
        return a[0], a[4]

    ref = tally()
    ref.initialize_particle_location(pos.copy())
    outs = [move(ref, i) for i in range(4)]
    a = tally()
    a.initialize_particle_location(pos.copy())
    move(a, 0)
    move(a, 1)
    path = str(tmp_path / "card.npz")
    a.save_checkpoint(path)
    b = tally()
    b.restore_checkpoint(path)
    got = [move(b, i) for i in (2, 3)]
    assert torch.equal(b.flux, ref.flux)
    assert torch.equal(b.state.origin, ref.state.origin)
    assert torch.equal(b.state.elem, ref.state.elem)
    for (p, m), (q, k) in zip(got, outs[2:]):
        np.testing.assert_array_equal(p, q)
        np.testing.assert_array_equal(m, k)
    c = tally()
    run = ResilientRunner(c, str(tmp_path / "cks"), every_moves=100,
                          handle_signals=False, sleep=lambda s: None,
                          faults=FaultInjector(parse_faults(
                              "transient_at_move:3")))
    run.initialize_particle_location(pos.copy())
    for i in range(4):
        run.move_to_next_location(*[np.array(x, copy=True)
                                    for x in moves[i]])
    assert torch.equal(c.flux, ref.flux)
    assert c.telemetry()["integrity"]["violations"] == {}


def _part_inputs(dtype, cuda, n_parts, halo, n=8192, seed=5, tight=False):
    """A jittered 12^3 two-region box split into parts on the card, and
    n distributed lanes (flights of mean 0.15, some leaving the box);
    ``tight`` sends every lane 0.8 of the way to a corner of the box and
    gives each part only as many slots as the most any part starts with,
    so that the corner's part drops immigrants."""
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp
    from pumiumtally_tpu_torch.parallel.mesh_partition import partition_mesh

    mesh = _jittered(12, dtype, cuda)
    part = partition_mesh(mesh, n_parts, halo_layers=halo)
    rng = np.random.default_rng(seed)
    elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
    origin = mesh.centroids().double().cpu().numpy()[elem]
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    dest = origin + u * rng.exponential(0.15, (n, 1))
    if tight:
        dest = origin + 0.8 * (np.array([0.95, 0.95, 0.95]) - origin)
    placed = wp.distribute_particles(part, None, elem, dict(
        origin=origin.astype(np.float32 if dtype == torch.float32
                             else np.float64),
        dest=dest.astype(np.float32 if dtype == torch.float32
                         else np.float64),
        weight=rng.uniform(0.5, 2.0, n).astype(
            np.float32 if dtype == torch.float32 else np.float64),
        group=rng.integers(0, 4, n).astype(np.int32),
        material_id=np.full(n, -1, np.int32)),
        cap=(int(np.bincount(part.owner[elem], minlength=n_parts).max())
             if tight else None))
    return mesh, part, placed


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("halo", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_partitioned_walk_phase_kernel_matches_plain(cuda, dtype, halo,
                                                     initial):
    """One walk phase of the stacked parts: the kernel's partitioned
    layout against its plain version on the same lanes, three times as
    many as a launch keeps resident (every thread walks several): every
    lane's position, row, material, target, done flag, carried state and
    counters bitwise, and the slab flux bitwise."""
    from pumiumtally_tpu_torch.ops import walk_cuda
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp

    n = 3 * walk_cuda.resident_threads(dtype, initial=initial,
                                       layout=walk_cuda.PARTITIONED) + 77
    mesh, part, placed = _part_inputs(dtype, cuda, 4, halo, n=n)
    slots = torch.nonzero(placed["valid"])[:, 0].contiguous()
    total = placed["valid"].shape[0]
    cap = total // 4
    rows = ((slots // cap) * part.max_local
            + placed["elem"][slots]).to(torch.int32)
    m = slots.numel()
    i32 = dict(dtype=torch.int32, device=cuda)
    args = (wp.stacked_tables(part), placed["origin"][slots],
            placed["dest"][slots], rows, placed["weight"][slots],
            placed["group"][slots], placed["material_id"][slots],
            torch.zeros(m, dtype=dtype, device=cuda),
            torch.full((m,), -1, **i32), torch.zeros(m, **i32), slots)
    kw = dict(stride=total, max_local=part.max_local, initial=initial,
              max_crossings=mesh.ntet + 8, n_groups=4)
    flux0 = torch.zeros(part.n_parts * part.max_local * 8, dtype=dtype,
                        device=cuda)
    before = walk_cuda.PART_LAUNCHES
    k, _ = walk_cuda.walk_rows(*args, flux0.clone(), **kw)
    fk = flux0.clone()
    _, rk = walk_cuda.walk_rows(*args, fk, **kw)
    fp = flux0.clone()
    p, rp = wp.walk_rows_plain(*args, fp, **kw)
    for f, rec, plain in ((fk, rk, False), (fp, rp, True)):
        if rec is not None:  # the records folded as the step folds them
            wp.fold_records(f, [rec], True, f.numel() // 2, plain)
    torch.cuda.synchronize()
    assert walk_cuda.PART_LAUNCHES - before >= 2
    for name in ("pos", "elem", "mat", "done", "pseg", "ncross", "nchase",
                 "nseg", "iters", "target", "target_elem", "prev", "stuck"):
        assert torch.equal(k[name], p[name]), name
    assert torch.equal(fk, fp)
    assert (p["target"] >= 0).any()  # lanes froze at cuts


@pytest.mark.parametrize("robust", [True, False])
@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_partitioned_xpoints_kernel_matches_plain(cuda, dtype, initial,
                                                  robust):
    """The feature instantiations of the partitioned layout (recorded
    points; the step has no checks): one walk phase of the stacked parts
    records each lane's points, the crossing into another part included,
    and its count bitwise the plain version's, continuing given buffers;
    every lane's state and the slab flux bitwise, and the same as the
    launch without points. The layout refuses the checks."""
    from pumiumtally_tpu_torch.ops import walk_cuda
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp

    n = 3 * walk_cuda.resident_threads(dtype, initial=initial,
                                       layout=walk_cuda.PARTITIONED) + 77
    mesh, part, placed = _part_inputs(dtype, cuda, 4, 1, n=n)
    slots = torch.nonzero(placed["valid"])[:, 0].contiguous()
    total = placed["valid"].shape[0]
    rows = ((slots // (total // 4)) * part.max_local
            + placed["elem"][slots]).to(torch.int32)
    m, K = slots.numel(), 4
    i32 = dict(dtype=torch.int32, device=cuda)
    args = (wp.stacked_tables(part), placed["origin"][slots],
            placed["dest"][slots], rows, placed["weight"][slots],
            placed["group"][slots], placed["material_id"][slots],
            torch.zeros(m, dtype=dtype, device=cuda),
            torch.full((m,), -1, **i32), torch.zeros(m, **i32), slots)
    kw = dict(stride=total, max_local=part.max_local, initial=initial,
              max_crossings=mesh.ntet + 8, n_groups=4, robust=robust)
    flux0 = torch.zeros(part.n_parts * part.max_local * 8, dtype=dtype,
                        device=cuda)
    # Buffers that continue: one point recorded already on every lane.
    xp0 = torch.full((m, K, 3), 7.0, dtype=dtype, device=cuda)
    kx0 = torch.ones(m, **i32)

    def given():
        return (xp0.clone(), kx0.clone())

    outs = []
    feats = walk_cuda.FEATURE_PART_LAUNCHES
    for fn, plain, pts in ((walk_cuda.walk_rows, False, given()),
                           (wp.walk_rows_plain, True, given()),
                           (walk_cuda.walk_rows, False, None)):
        f = flux0.clone()
        extra = {} if pts is None else dict(record_xpoints=K, xpoints=pts)
        out, rec = fn(*args, f, **kw, **extra)
        if rec is not None:
            wp.fold_records(f, [rec], True, f.numel() // 2, plain)
        outs.append((out, f))
    torch.cuda.synchronize()
    assert walk_cuda.FEATURE_PART_LAUNCHES - feats >= 1
    (k, fk), (p, fp), (off, foff) = outs
    for name in ("pos", "elem", "mat", "done", "pseg", "ncross", "nchase",
                 "nseg", "iters", "target", "target_elem", "prev", "stuck"):
        assert torch.equal(k[name], p[name]), name
        assert torch.equal(k[name], off[name]), name
    assert torch.equal(fk, fp) and torch.equal(fk, foff)
    assert torch.equal(k["kx"], p["kx"]) and torch.equal(k["xp"], p["xp"])
    assert torch.equal(k["kx"] - 1, k["ncross"])  # genuine crossings
    assert bool((k["xp"][:, 0] == 7.0).all())  # the given row kept
    assert int(k["kx"].max()) > K and (k["target"] >= 0).any()
    with pytest.raises(RuntimeError, match="cudaError_t"):
        walk_cuda._launch(None, *args[1:3], args[3], torch.ones(
            m, dtype=torch.bool, device=cuda), *args[4:7], flux0.clone(),
            initial=initial, max_crossings=8, n_groups=4,
            score_squares=True, tolerance=1e-8, robust=robust, ledger=True,
            stats=True, ordered=not initial, capacity=8 * m,
            lanes=walk_cuda.lane_records(None, *args[1:3], args[3],
                                         torch.ones(m, dtype=torch.bool,
                                                    device=cuda),
                                         *args[4:6], initial=initial,
                                         nkeys=args[0][0].shape[0]),
            debug_checks=True, part=dict(
                tables=args[0], slot=slots, stride=total,
                max_local=part.max_local, reset=0, prev=args[8],
                stuck=args[9], mat=args[6], pseg=args[7]))


@pytest.mark.parametrize("halo", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_partitioned_step_kernel_matches_plain(cuda, dtype, halo):
    """A whole partitioned step (4 parts): the kernel against the plain
    walk phases on the card, slot for slot, the slab flux and the rounds
    bitwise; two kernel runs give the same bits."""
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp

    mesh, part, placed = _part_inputs(dtype, cuda, 4, halo)
    dm = [cuda] * 4
    L = part.max_local

    def run(plain):
        step = wp.make_partitioned_step(dm, part, n_groups=4,
                                        max_crossings=mesh.ntet + 8,
                                        plain=plain)
        flux = torch.zeros(4, L * 8, dtype=dtype, device=cuda)
        return step(placed["origin"], placed["dest"], placed["elem"],
                    torch.zeros_like(placed["valid"]),
                    placed["material_id"], placed["weight"],
                    placed["group"], placed["particle_id"],
                    placed["valid"], flux)

    k, again, p = run(False), run(False), run(True)
    torch.cuda.synchronize()
    for name in ("position", "elem", "material_id", "done", "valid",
                 "particle_id", "track_length", "flux", "n_rounds",
                 "n_segments", "round_stats", "stats", "n_dropped"):
        assert torch.equal(getattr(k, name), getattr(p, name)), name
        assert torch.equal(getattr(k, name), getattr(again, name)), name
    assert int(k.n_rounds[0]) >= 1 and int(k.n_dropped.sum()) == 0
    assert bool(k.done[k.valid].all())


@pytest.mark.parametrize("case", ["default", "xpoints8", "overflow_drops"])
@pytest.mark.parametrize("halo", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_exchange_kernel_matches_plain(cuda, dtype, halo, case):
    """The step through the exchange kernels (csrc/exchange.cu) against
    the step through ``_exchange_plain`` (and the plain walk phases) on
    the card: every slot field, the recorded points and their counts,
    the rounds' stats, ``n_dropped`` and the slab flux bitwise, and two
    kernel runs the same bits. ``xpoints8`` carries 8 recorded points a
    slot in the send rows; ``overflow_drops`` takes 2 rows a destination
    a round and a slot layout of the most any part starts with, so that
    emigrants wait rounds and full parts drop immigrants."""
    from pumiumtally_tpu_torch.ops import exchange_cuda

    tight = case == "overflow_drops"
    mesh, part, placed = _part_inputs(dtype, cuda, 4, halo,
                                      n=512 if tight else 8192, tight=tight)
    kw = dict(max_crossings=mesh.ntet + 8)
    if case == "xpoints8":
        kw["record_xpoints"] = 8
    if tight:
        kw["exchange_size"] = 2
    runs = []
    for plain in (False, True, False):
        before = exchange_cuda.BUCKET_LAUNCHES, exchange_cuda.ADOPT_LAUNCHES
        runs.append(_part_step(part, placed, [cuda] * 4, cuda, dtype,
                               plain=plain, **kw))
        torch.cuda.synchronize()
        launched = (exchange_cuda.BUCKET_LAUNCHES - before[0],
                    exchange_cuda.ADOPT_LAUNCHES - before[1])
        rounds = int(runs[-1].n_rounds[0])
        assert launched == ((0, 0) if plain else (rounds, rounds))
    k, p, again = runs
    for K in (0, 8):  # the buffer's rows are the kernels' stride
        assert exchange_cuda.kernel_row_bytes(dtype, K) == \
            exchange_cuda.row_bytes(dtype, K)
    names = STEP_OUT + ("dest", "weight", "group") + (
        ("xpoints", "n_xpoints") if case == "xpoints8" else ())
    for name in names:
        assert torch.equal(getattr(k, name), getattr(p, name)), name
        assert torch.equal(getattr(k, name), getattr(again, name)), name
    rs = k.round_stats
    assert int(k.n_rounds[0]) >= 1 and int(rs[:, 1].sum()) > 0
    if case == "overflow_drops":
        assert int(k.n_dropped.sum()) > 0
        assert bool((rs[:, 1] < rs[:, 0]).any())


def test_partitioned_tally_on_card_matches_pumitally(cuda):
    """The partitioned facade on the card (4 parts, halo 1) against the
    single-device facade on the same inputs: elements, materials and
    segments equal, positions within 1e-12, the flux within 1e-10
    (float64: the partitioned segment is |x1 - x0|)."""
    from pumiumtally_tpu_torch import PartitionedTally, PumiTally, TallyConfig

    mesh = _jittered(10, torch.float64, cuda)
    n = 20000
    cfg = TallyConfig(dtype=torch.float64, n_groups=2)
    single = PumiTally(mesh, n, cfg, device=cuda)
    parted = PartitionedTally(mesh, n, cfg, n_parts=4, halo_layers=1,
                              device=cuda)
    rng = np.random.default_rng(3)
    src = rng.uniform(0.05, 0.95, (n, 3))
    dest = np.clip(src + rng.normal(0, 0.2, (n, 3)), -0.1, 1.1)
    outs = []
    for t in (single, parted):
        t.initialize_particle_location(src.copy())
        d, m = dest.copy(), np.zeros(n, np.int32)
        t.move_to_next_location(d, np.ones(n, np.int8), np.ones(n),
                                np.zeros(n, np.int32), m)
        outs.append((d, m, t.raw_flux, t.total_segments))
    (ds, ms, fs, ss), (dp, mp, fpart, sp) = outs
    np.testing.assert_allclose(dp, ds, atol=1e-12)
    np.testing.assert_array_equal(mp, ms)
    np.testing.assert_allclose(fpart, fs, rtol=1e-10, atol=1e-12)
    assert sp == ss


# --------------------------------------------------------------------- #
# The partitioned megastep: the flight on stacked rows
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stacked_row_flight_kernel_matches_plain(cuda, dtype):
    """The flight kernel on the partitioned megastep's stacked slots (4
    blocks of cap slots, each lane's region at its part-local row of the
    stacked class table): uniforms and draws bitwise the plain version's,
    destinations within one ulp, empty (pid −1) and dead lanes at their
    origin."""
    from pumiumtally_tpu_torch.ops import source, source_cuda

    P, cap, max_local = 4, 5000, 700
    n = P * cap
    rng = np.random.default_rng(8)
    pid = torch.from_numpy(np.where(rng.uniform(size=n) < 0.7,
                                    rng.permutation(n), -1).astype(
                                        np.int32)).to(cuda)
    elem = torch.from_numpy(rng.integers(-2, max_local + 3, n).astype(
        np.int32)).to(cuda)
    alive = (pid >= 0) & torch.from_numpy(rng.uniform(size=n) < 0.9).to(cuda)
    origin = torch.from_numpy(rng.uniform(size=(n, 3))).to(cuda, dtype)
    cls = torch.from_numpy(rng.integers(0, 3, P * max_local).astype(
        np.int32)).to(cuda)
    sig = torch.tensor([3.0, 7.0, 11.0], dtype=dtype, device=cuda)
    key = source.fold_in(source.prng_key(13), 4)
    u = torch.empty(n, 5, dtype=dtype, device=cuda)
    before = source_cuda.LAUNCHES
    dest, cu, ru = source_cuda.sample_flight(
        key, pid, n, elem, alive, origin, cls, sig, u_out=u, cap=cap,
        max_local=max_local)
    torch.cuda.synchronize()
    assert source_cuda.LAUNCHES == before + 1
    want_u = source.lane_uniforms(key, pid, n, dtype)
    assert torch.equal(u.view(torch.uint8), want_u.view(torch.uint8))
    pd, pc, pr = source.sample_flight_plain(key, pid, n, elem, alive, origin,
                                            cls, sig, cap=cap,
                                            max_local=max_local)
    assert torch.equal(cu, pc) and torch.equal(ru, pr)
    assert torch.equal(dest[~alive], origin[~alive])
    ulp = torch.finfo(dtype).eps * pd.abs().clamp_min(1.0)
    assert ((dest - pd).abs() <= ulp).all()
    # The single-device form is the same kernel with cap = n and
    # max_local = ntet: the defaults give what the stacked form gives for
    # one block.
    one = source_cuda.sample_flight(key, pid[:cap], cap, elem[:cap],
                                    alive[:cap], origin[:cap],
                                    cls[:max_local], sig)
    blk = source_cuda.sample_flight(key, pid[:cap], cap, elem[:cap],
                                    alive[:cap], origin[:cap], cls, sig,
                                    cap=cap, max_local=max_local)
    torch.cuda.synchronize()
    for a, b in zip(one, blk):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_partitioned_megastep_kernels_match_plain(cuda, dtype):
    """A small partitioned run_source_moves on the card: the megastep with
    the kernels against the same megastep with the plain flight and the
    plain walk, slot state and slab flux bitwise; megastep=3 gives the
    bits of megastep=1, and the flight kernel launches once a move."""
    from pumiumtally_tpu_torch import PartitionedTally, TallyConfig
    from pumiumtally_tpu_torch.ops import source, source_cuda, walk_cuda
    from pumiumtally_tpu_torch.ops.walk_partitioned import (
        make_partitioned_megastep,
    )

    mesh = _jittered(8, dtype, cuda)
    n = 4096
    src = source.SourceParams(sigma_t={0: 4.0, 1: 9.0},
                              absorption={0: 0.3, 1: 0.5},
                              survival_weight=0.2, seed=3)
    pos = np.random.default_rng(2).uniform(0.1, 0.9, (n, 3))
    runs = []
    for k in (1, 3):
        t = PartitionedTally(mesh, n, TallyConfig(dtype=dtype, n_groups=2,
                                                  megastep=k),
                             n_parts=4, halo_layers=1, device=cuda)
        t.initialize_particle_location(pos.copy())
        f0, p0 = source_cuda.LAUNCHES, walk_cuda.PART_LAUNCHES
        out = t.run_source_moves(3, src, weights=np.ones(n))
        torch.cuda.synchronize()
        assert source_cuda.LAUNCHES - f0 == 3
        assert walk_cuda.PART_LAUNCHES - p0 >= 3
        runs.append((t, out))
    (a, oa), (b, ob) = runs
    assert oa["segments"] == ob["segments"] and oa["alive"] == ob["alive"]
    assert torch.equal(a.flux_slabs, b.flux_slabs)
    for key_ in a._src:
        assert torch.equal(a._src[key_], b._src[key_]), key_
    # Kernels against plain on one chunk from the same state.
    sig, ab = src.tables(mesh.class_id.cpu().numpy())
    l2g = np.clip(a.partition.local2global, 0, mesh.ntet - 1)
    cls_local = np.clip(mesh.class_id.cpu().numpy()[l2g], 0, sig.size - 1)
    kw = dict(n_moves=2, n_total=n, n_groups=2, class_local=cls_local,
              sigma_t=sig, absorb_t=ab,
              eps_near=source.near_epsilon(mesh.coords),
              survival_weight=src.survival_weight,
              downscatter=src.downscatter, dtype=dtype,
              max_crossings=mesh.ntet + 64)
    s = a._src
    outs = []
    for plain in (False, True):
        mega = make_partitioned_megastep(a.device_mesh, a.partition,
                                         plain=plain, **kw)
        flux = a.flux_slabs.clone()
        outs.append(mega(s["pos"], s["elem"], s["material_id"], s["weight"],
                         s["group"], s["pid"], s["valid"], s["alive"], flux,
                         3, source.prng_key(src.seed)))
    torch.cuda.synchronize()
    k_, p_ = outs
    for f in ("position", "elem", "material_id", "weight", "group",
              "particle_id", "valid", "alive", "flux", "readback"):
        assert torch.equal(getattr(k_, f), getattr(p_, f)), f


# --------------------------------------------------------------------- #
# The crossing budget's later rounds; the step in a one-rank NCCL group
# --------------------------------------------------------------------- #
STEP_OUT = ("position", "elem", "material_id", "done", "valid",
            "particle_id", "track_length", "flux", "n_rounds", "n_segments",
            "round_stats", "stats", "n_dropped")


def _part_step(part, placed, dm, cuda, dtype, **kw):
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp

    step = wp.make_partitioned_step(dm, part, n_groups=4, **kw)
    return step(placed["origin"], placed["dest"], placed["elem"],
                torch.zeros_like(placed["valid"]), placed["material_id"],
                placed["weight"], placed["group"], placed["particle_id"],
                placed["valid"],
                torch.zeros(part.n_parts, part.max_local * 8, dtype=dtype,
                            device=cuda))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_budget_rounds_kernel_matches_plain(cuda, dtype):
    """max_crossings=6, the first phase compacted from crossing 3 (the
    kernel restarts the chase hash's count there) and later rounds of 256
    lanes: the later rounds' launches give the lanes that ran out a fresh
    budget, through the kernel and through the plain walk phases on the
    card, every output bitwise and the same lanes re-launched."""
    from pumiumtally_tpu_torch.ops import walk_partitioned as wp

    mesh, part, placed = _part_inputs(dtype, cuda, 4, 1)
    kw = dict(max_crossings=6, compact_after=3, compact_size=512,
              followup_compact_size=256)
    got = []
    for plain in (False, True):
        r0, l0 = wp.BUDGET_RELAUNCHES, wp.BUDGET_LANES
        res = _part_step(part, placed, [cuda] * 4, cuda, dtype, plain=plain,
                         **kw)
        torch.cuda.synchronize()
        got.append((res, wp.BUDGET_RELAUNCHES - r0, wp.BUDGET_LANES - l0))
    (k, kr, kl), (p, pr, pl) = got
    for name in STEP_OUT:
        assert torch.equal(getattr(k, name), getattr(p, name)), name
    assert (kr, kl) == (pr, pl) and kl > 0


def test_one_rank_nccl_step_matches_stacked(cuda, tmp_path):
    """The step over the MeshEntry mesh of a one-rank NCCL group (its
    exchange through the exchange kernels and the collectives, its stop
    test and halo fold through the collectives) equals the stacked step
    bit for bit; write_parallel_vtk on that rank writes its piece and the
    index."""
    import torch.distributed as dist

    from pumiumtally_tpu_torch.ops import exchange_cuda
    from pumiumtally_tpu_torch.parallel import multihost

    mesh, part, placed = _part_inputs(torch.float32, cuda, 4, 1)
    assert multihost.init_distributed(
        "file://" + str(tmp_path / "rendezvous"), 1, 0, device=cuda,
        group_of_one=True, timeout_s=60)
    try:
        assert dist.get_backend() == "nccl"
        dm = multihost.global_device_mesh(4)
        assert [e.rank for e in dm] == [0] * 4
        kw = dict(max_crossings=mesh.ntet + 8)
        before = exchange_cuda.BUCKET_LAUNCHES
        ranked = _part_step(part, placed, dm, cuda, torch.float32, **kw)
        torch.cuda.synchronize()
        assert exchange_cuda.BUCKET_LAUNCHES - before == int(
            ranked.n_rounds[0])  # its exchanges through the kernels
        stacked = _part_step(part, placed, [cuda] * 4, cuda, torch.float32,
                             **kw)
        torch.cuda.synchronize()
        for name in STEP_OUT:
            assert torch.equal(getattr(ranked, name),
                               getattr(stacked, name)), name
        assert int(ranked.n_rounds[0]) >= 1
        flux = np.zeros((mesh.ntet, 4, 2))
        piece = multihost.write_parallel_vtk(str(tmp_path / "out"), mesh,
                                             flux)
        assert os.path.getsize(piece) > 100
        assert "out_p0000.vtu" in (tmp_path / "out.pvtu").read_text()
    finally:
        dist.destroy_process_group()
        multihost._initialized = False


@pytest.mark.parametrize("block", [64, 256, 512])
@pytest.mark.parametrize("initial", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_block_width_matches_plain(cuda, dtype, initial, block):
    """The walk kernel built at another block width (the packed, robust
    initial search and ordered move): lanes and flux bitwise the plain
    walk's, over three times the lanes the width keeps resident, launched
    at that width (``BLOCK_LAUNCHES``)."""
    from pumiumtally_tpu_torch.ops import walk, walk_cuda

    mesh = _jittered(6, dtype, cuda)
    G = 4
    n = 3 * walk_cuda.resident_threads(dtype, initial=initial,
                                       block=block) + 77
    args = _walk_inputs(mesh, cuda, dtype, n=n, G=G, seed=13)
    kw = dict(initial=initial, max_crossings=mesh.ntet + 8, n_groups=G)
    before = walk_cuda.BLOCK_LAUNCHES[block]
    k = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda), block=block,
                        **kw)
    p = walk.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
    torch.cuda.synchronize()
    assert walk_cuda.BLOCK_LAUNCHES[block] > before
    _lanes_equal(k, p)
    assert torch.equal(k.flux, p.flux)
    with pytest.raises(ValueError, match="block width"):
        walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda), block=block,
                        robust=False, **kw)


def test_hardware_tuner_on_smoke1(cuda, tmp_path):
    """``mode="hardware"`` on the smoke1 class: every candidate passes the
    bitwise gate, the winners are built values, the section is the card's,
    and a facade built from the database launches the winning width."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.ops import walk_cuda
    from pumiumtally_tpu_torch.tuning import environment, env_key, search
    from pumiumtally_tpu_torch.tuning.db import write_tuning

    data = search.tune({"smoke1": search.SPECS["smoke1"]}, mode="hardware",
                       reps=2, moves=2, mega_moves=4)
    sec = data["environments"][env_key(environment(cuda))]
    (key, entry), = sec["entries"].items()
    assert sec["mode"] == "hardware"
    assert all(c["parity"] == "bitwise" for c in entry["candidates"])
    assert entry["block"] in walk_cuda.BLOCKS and entry["megastep"] in (1, 4)
    assert [c["block"] for c in entry["candidates"]
            if c["kind"] == "kernel"] == [128, 64, 256]
    path = str(tmp_path / "tuning.json")
    write_tuning(path, data)
    w = search.build_workload(search.SPECS["smoke1"], moves=1, seed=0,
                              device=cuda)
    t = PumiTally(w["mesh"], w["n_particles"], TallyConfig(tuning=path),
                  device=cuda)
    assert t.shape_key == key and t._block == entry["block"]
    before = walk_cuda.BLOCK_LAUNCHES[entry["block"]]
    t.initialize_particle_location(
        w["origin_host"].astype(np.float64).reshape(-1).copy())
    assert walk_cuda.BLOCK_LAUNCHES[entry["block"]] > before


# --------------------------------------------------------------------- #
# Serving: the library bank over nvcc, the scheduler on the card
# --------------------------------------------------------------------- #
def test_library_bank_over_nvcc(cuda, tmp_path):
    """A cold bank builds the facade's libraries together with nvcc; a
    fresh bank over it is pure hits; a truncated library is named "torn"
    and a META from another nvcc "stale", each rebuilt and rewritten,
    after which the entries load clean."""
    import json

    from pumiumtally_tpu_torch.serving import ProgramBank
    from pumiumtally_tpu_torch.serving.bank import FACADE_LIBRARIES, META_FILE

    cold = ProgramBank(str(tmp_path))
    paths = cold.libraries(FACADE_LIBRARIES)
    assert (cold.misses, cold.hits, cold.rewrites) == (3, 0, 0)
    assert cold.compile_seconds > 0
    metas = [json.load(open(os.path.join(os.path.dirname(p), META_FILE)))
             for p in paths]
    assert all(m["ptxas"] and m["nvcc"] and m["symbols"] for m in metas)
    warm = ProgramBank(str(tmp_path))
    assert warm.libraries(FACADE_LIBRARIES) == paths
    assert (warm.misses, warm.hits, warm.compile_seconds) == (0, 3, 0.0)
    # The torn library is written as a new file: this process has the
    # old one mapped (the warm bank's load check), and cutting a mapped
    # library in place would fault the process, not the bank.
    size = os.path.getsize(paths[0])
    with open(paths[0], "rb") as f:
        half = f.read(size // 2)
    with open(paths[0] + ".cut", "wb") as f:
        f.write(half)
    os.replace(paths[0] + ".cut", paths[0])
    meta = os.path.join(os.path.dirname(paths[1]), META_FILE)
    doc = json.load(open(meta))
    doc["nvcc"] = "Build cuda_0.0.r0.0/compiler.0_0"
    json.dump(doc, open(meta, "w"))
    hurt = ProgramBank(str(tmp_path))
    assert hurt.libraries(FACADE_LIBRARIES) == paths
    assert sorted(f["cause"] for f in hurt.findings) == ["stale", "torn"]
    assert (hurt.hits, hurt.rewrites) == (1, 2)
    assert os.path.getsize(paths[0]) == size
    clean = ProgramBank(str(tmp_path))
    clean.libraries(FACADE_LIBRARIES)
    assert (clean.hits, clean.findings) == (3, [])


_SERVED_SCRIPT = """
import json, os, sys
sys.path.insert(0, sys.argv[2])
from pumiumtally_tpu_torch import TallyConfig, build_box
from pumiumtally_tpu_torch.ops import _build
from pumiumtally_tpu_torch.serving import (
    ProgramBank, TallyScheduler, synthetic_requests)
from pumiumtally_tpu_torch.serving.bank import FACADE_LIBRARIES
from torch_serving_twins import solo_reference

tmp = sys.argv[1]
assert not any(_build.loaded_path(n) for n in FACADE_LIBRARIES)
mesh = build_box(1.0, 1.0, 1.0, 8, 8, 8, device="cuda")
cfg = TallyConfig(n_groups=4, tolerance=1e-6)
bank = ProgramBank(os.path.join(tmp, "bank"))
sched = TallyScheduler(mesh, cfg, bank=bank, max_resident=1,
                       quantum_moves=2, preempt_after=1,
                       checkpoint_dir=os.path.join(tmp, "ck"), device="cuda")
reqs = synthetic_requests(mesh, 2, class_sizes=(3000, 1024), n_moves=4,
                          seed=4)
ids = [sched.submit(r) for r in reqs]
sched.run()
sched.close()
same = [sched.result(j).tobytes()
        == solo_reference(mesh, r, 2, cfg, device="cuda").tobytes()
        for r, j in zip(reqs, ids)]
print(json.dumps(dict(
    stats=bank.stats(), preemptions=sched.stats()["preemptions"],
    outcomes=[sched.job(j).outcome for j in ids], same=same,
    loaded={n: _build.loaded_path(n) for n in FACADE_LIBRARIES},
    entries={n: bank.library_file(n) for n in FACADE_LIBRARIES})))
"""


def test_served_jobs_bitwise_their_facade_runs(cuda, tmp_path):
    """Two jobs through the scheduler on the card (one preempted and
    re-admitted) give each job's uninterrupted facade run, bit for bit,
    with the facades' libraries resolved through the bank. It runs in a
    fresh process, so that the libraries it launches are the bank's
    entries and not a build this process loaded before."""
    import json
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", _SERVED_SCRIPT, str(tmp_path), here],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(here))
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["preemptions"] >= 1
    assert out["outcomes"] == ["completed", "completed"]
    assert out["stats"]["entries"] == 3 and out["stats"]["misses"] == 3
    assert out["loaded"] == out["entries"]
    assert all(p.startswith(str(tmp_path / "bank"))
               for p in out["loaded"].values())
    assert out["same"] == [True, True]


def test_fleet_migration_bitwise_on_card(cuda, tmp_path):
    """A 2-member fleet on the 20^3 box, one job migrated after its first
    quantum: every job's flux bitwise the same job served by one
    ``TallyScheduler`` on the card."""
    from pumiumtally_tpu_torch import TallyConfig, build_box
    from pumiumtally_tpu_torch.serving import (
        FleetRouter,
        TallyScheduler,
        synthetic_requests,
    )

    mesh = build_box(1.0, 1.0, 1.0, 20, 20, 20, device=cuda)
    cfg = TallyConfig(n_groups=8, tolerance=1e-6)
    reqs = synthetic_requests(mesh, 2, class_sizes=(65536, 32768),
                              n_moves=4, seed=0)
    solo = TallyScheduler(mesh, cfg, max_resident=1, quantum_moves=2,
                          handle_signals=False, device=cuda)
    ids = [solo.submit(r) for r in reqs]
    solo.run()
    want = {j: solo.result(j).tobytes() for j in ids}
    solo.close()
    router = FleetRouter(mesh, cfg, fleet_dir=str(tmp_path / "fleet"),
                         n_members=2, quantum_moves=2, max_resident=1,
                         device=cuda)
    try:
        for r in reqs:
            router.submit(r, idempotency_key=f"key-{r.job_id}")
        router.step()
        src = router.member_of(ids[0])
        assert router.migrate(ids[0]) != src
        router.run()
        assert router.stats()["migrations"] == 1
        assert router.stats()["outcomes"] == {"completed": 2}
        for j in ids:
            assert router.result(j).tobytes() == want[j], j
    finally:
        router.close()


# --------------------------------------------------------------------- #
# The resource and program contracts (analysis/costmodel.py, contracts.py)
# --------------------------------------------------------------------- #
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fresh_build_capture_equals_committed(cuda):
    """A build of every source here gives the ptxas capture committed in
    PERF_CONTRACTS_TORCH.json, instantiation for instantiation (float64
    SASS counts included), at the tree's source digests."""
    from pumiumtally_tpu_torch.analysis import costmodel as M
    from pumiumtally_tpu_torch.ops import _build

    _build.build_many(M.SOURCES)
    logs = M.find_logs()
    fresh = M.capture_ptxas(logs, f64=M.sass_census(logs))
    committed = M.load_perf_contracts(
        os.path.join(_ROOT, M.PERF_CONTRACTS_FILE))["ptxas"]
    assert M.check_stale(committed) == []
    assert [f.render() for f in M.diff_cost(fresh, committed)] == []
    assert fresh["sources"] == committed["sources"]


def test_smem_mirror_matches_the_c_entries(cuda):
    """cost.smem: the mirror of dynamic_bytes and bucket_smem gives the
    bytes each source's pumi_*_smem entry says a launch passes."""
    from pumiumtally_tpu_torch.analysis import costmodel as M

    assert [f.render() for f in M.check_smem_entries()] == []
    assert M.entry_smem("walk", "d", 512) == 80 * 2 * 512
    assert M.entry_smem("walk", "f", 512) == 0


def test_cuda_contract_family_is_clean(cuda):
    """The kernel path's program contracts: a packed move and a megastep
    chunk through the kernels, every invariant of check_structural."""
    from pumiumtally_tpu_torch.analysis import contracts as C
    from pumiumtally_tpu_torch.analysis import load_baseline

    cap = C.capture_cuda()
    entries = load_baseline(os.path.join(_ROOT, "LINT_BASELINE_TORCH.json"))
    assert [f.render() for f in C.check_structural(cap, entries)] == []
    w = cap["families"]["cuda"]
    assert w["move"]["io"]["h2d_transfers"] == 1
    assert w["chunk"]["launches"]["flight"] == w["chunk"]["moves"]
