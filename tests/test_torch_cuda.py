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
to their plain versions; the atomic scatter agrees within rtol 1e-5. The lane
order is a permutation whose elements are those of its plain version
(within an element the order is the device's). Packed and overlap staging
give the legacy path's bits, and the pipeline those of the same batches
walked one after another.
"""
from __future__ import annotations

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
    k = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
    again = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
    p = walk.trace(*args, _flux0(mesh, G, dtype, cuda), **kw)
    torch.cuda.synchronize()
    assert walk_cuda.LAUNCHES - before >= 2
    assert scatter.ORDERED_LAUNCHES - scattered == (0 if initial else 2)
    _lanes_equal(k, p)
    assert torch.equal(k.flux, p.flux)
    assert torch.equal(k.flux, again.flux)


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


@pytest.mark.parametrize("case", ["one element", "random", "descending"])
def test_lane_order_kernel(cuda, case):
    from pumiumtally_tpu_torch.ops import scatter

    n, nbins = 100003, 5000
    rng = np.random.default_rng(6)
    elem = {
        "one element": np.full(n, 17),
        "random": rng.integers(0, nbins, n),
        "descending": (nbins - 1 - np.arange(n) * nbins // n),
    }[case]
    elem = torch.from_numpy(elem.astype(np.int32)).to(cuda)
    before = scatter.ORDER_LAUNCHES
    perm = scatter.lane_order(elem, nbins)
    torch.cuda.synchronize()
    assert scatter.ORDER_LAUNCHES == before + 1
    assert perm.dtype == torch.int32
    assert torch.equal(torch.sort(perm.long()).values,
                       torch.arange(n, device=cuda))
    plain = scatter.lane_order_plain(elem)
    assert torch.equal(elem[perm.long()], elem[plain.long()])
    with pytest.raises(IndexError):
        scatter.lane_order(elem, 17)


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
    k = walk_cuda.trace(*args, _flux0(mesh, G, dtype, cuda), capacity=7,
                        **kw)
    torch.cuda.synchronize()
    assert walk_cuda.RELAUNCHES == re + 1
    assert walk_cuda.LAUNCHES == before + 2
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
    path = "bucket"
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
        path = "bucket" if case == "capacity" else "crowded"
    elif case == "ragged":  # a short last bucket, its last bin crowded
        m, nbins = 20000, 20001
        b = rng.integers(0, nbins, m)
        b[:500] = nbins - 1
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
    return rec, nbins, path


@pytest.mark.parametrize("case", [
    "uniform", "ties", "bin sizes", "capacity", "capacity + 1", "empty", "one",
    "ragged", "unaligned", "wide keys"])
@pytest.mark.parametrize("score_squares", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bucket_path_matches_plain(cuda, dtype, score_squares, case):
    """The ordered scatter's bucket path, bitwise its plain version, and
    the path each case takes: a bucket at exactly the capacity fits, one
    more record sends the call to the crowded path, and so do order keys
    too wide for a bucket key."""
    from pumiumtally_tpu_torch.ops import scatter

    (b, order, c), nbins, path = _bucket_case(case, cuda, dtype)
    m = b.numel()
    seed = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, 2 * nbins)).to(cuda, dtype)
    before = (scatter.ORDERED_LAUNCHES, scatter.BUCKET_LAUNCHES,
              scatter.CROWDED_LAUNCHES)
    got = scatter.scatter_ordered(seed.clone(), b, order, c, score_squares)
    ref = scatter.scatter_ordered_plain(seed.clone(), b, order, c,
                                        score_squares)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if not score_squares:
        assert torch.equal(got[1::2], seed[1::2])
    after = (scatter.ORDERED_LAUNCHES, scatter.BUCKET_LAUNCHES,
             scatter.CROWDED_LAUNCHES)
    ran = [a - z for a, z in zip(after, before)]
    if m == 0:
        assert ran == [0, 0, 0]
        return
    assert ran == ([1, 1, 0] if path == "bucket" else [1, 0, 1])
    info = scatter.LAST_BUCKETS
    shift = scatter.bucket_shift(m, nbins)
    sizes = scatter.bucket_counts_plain(b, nbins, shift)
    assert info["path"] == path and info["shift"] == shift
    assert info["largest"] == int(sizes.max())
    assert (info["key_bits"] > 63) == (case == "wide keys")
    if case == "capacity":
        assert info["largest"] == scatter.BUCKET_CAPACITY


@pytest.mark.parametrize("cols,dtype,idx_dtype", [
    (20, torch.float32, torch.int32),   # a geo20 row, 16 B pieces
    (16, torch.float32, torch.int64),
    (20, torch.float64, torch.int32),
    (3, torch.float32, torch.int32),    # 12 B rows, 4 B pieces
    (3, torch.float64, torch.int64),    # 24 B rows, 8 B pieces
])
def test_gather_matches_plain(cuda, cols, dtype, idx_dtype):
    from pumiumtally_tpu_torch.ops import gather

    rng = np.random.default_rng(4)
    tbl = torch.from_numpy(rng.normal(size=(5000, cols))).to(cuda, dtype)
    idx = torch.from_numpy(rng.integers(0, 5000, 70000)).to(cuda, idx_dtype)
    before = gather.LAUNCHES
    out = gather.gather_rows(tbl, idx)
    assert gather.LAUNCHES == before + 1
    assert torch.equal(out, gather.gather_rows_plain(tbl, idx))
    with pytest.raises(IndexError):
        gather.gather_rows(tbl, idx.clone().fill_(5000))


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
