"""Move-loop I/O of the port (``pumiumtally_tpu_torch/ops/staging.py``,
``TallyConfig.io_pipeline``, ``walk.trace_packed``) on ``device="cpu"``.

Mirrors the single-chip parts of ``tests/test_io_pipeline.py`` and holds
them against the JAX package:

* the records round-trip bit for bit in float32 and float64, int32 -1
  material ids and NaN/±inf float bits included, and the port's move,
  initial-search and readback records are the JAX package's bytes;
* the facade's ``"packed"``, ``"overlap"`` and ``"legacy"`` modes give
  bitwise-equal flux, positions and material ids; a steady-state packed
  move makes one transfer each way, a legacy move four host→device;
* the knob's validation and its environment override;
* the port's packed facade against the JAX facade's
  (``io_pipeline="packed"``) on a two-class float64 box: positions within
  1e-12, flux within 1e-10 relative per bin;
* the ordered walk's record-count guard at 2^31 − 1 and 2^31.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.mesh.box import build_box_arrays
from pumiumtally_tpu.ops import staging as jstaging
from pumiumtally_tpu.ops.walk import trace_packed as jtrace_packed
from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
from pumiumtally_tpu_torch.convert import MESH_FIELDS, mesh_from_jax_arrays
from pumiumtally_tpu_torch.obs.convergence import CONV_LEN
from pumiumtally_tpu_torch.ops import scatter, staging, walk, walk_cuda

N = 128
DTYPES = [torch.float32, torch.float64]
_NP = {torch.float32: np.float32, torch.float64: np.float64}
_JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _special(rng, n):
    """[n, 3] float64 values with NaN, ±inf, ±0, subnormals and values that
    round differently to float32 among ordinary ones."""
    d = rng.normal(size=(n, 3))
    d.flat[:9] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-324, 1e-40,
                  1 + 2.0**-24, -(1 + 3 * 2.0**-24)]
    return d


def _move_inputs(rng, n):
    dest = _special(rng, n)
    w = rng.uniform(0.5, 2.0, n)
    w[:2] = [np.nan, np.inf]
    g = rng.integers(0, 4, n).astype(np.int32)
    fly = rng.uniform(size=n) > 0.3
    return dest, w, g, fly


# --------------------------------------------------------------------- #
# Records
# --------------------------------------------------------------------- #
@pytest.mark.filterwarnings("ignore:invalid value encountered in cast")
@pytest.mark.parametrize("dtype", DTYPES)
def test_move_record_round_trip_and_jax_bytes(dtype):
    rng = np.random.default_rng(3)
    dest, w, g, fly = _move_inputs(rng, 33)
    rec = staging.pack_move_record(staging.HostStager(device="cpu"), dest,
                                   w, g, fly, dtype)
    jrec = jstaging.pack_move_record(jstaging.HostStager(), dest, w, g, fly,
                                     _NP[dtype])
    assert rec.shape == (33, staging.MOVE_COLS)
    assert rec.numpy().tobytes() == jrec.tobytes()
    d, f, ww, gg = staging.unpack_move_record(rec, dtype, None, False)
    npdt = _NP[dtype]
    assert d.is_contiguous() and ww.is_contiguous() and gg.is_contiguous()
    assert d.numpy().tobytes() == dest.astype(npdt).tobytes()
    assert ww.numpy().tobytes() == w.astype(npdt).tobytes()
    np.testing.assert_array_equal(gg.numpy(), g)
    assert gg.dtype == torch.int32 and f.dtype == torch.bool
    np.testing.assert_array_equal(f.numpy(), fly)


@pytest.mark.filterwarnings("ignore:invalid value encountered in cast")
@pytest.mark.parametrize("dtype", DTYPES)
def test_init_record_round_trip_and_jax_bytes(dtype):
    rng = np.random.default_rng(4)
    dest = _special(rng, 17)
    fly = rng.uniform(size=17) > 0.5
    rec = staging.pack_init_record(staging.HostStager(device="cpu"), dest,
                                   fly, dtype)
    jrec = jstaging.pack_init_record(jstaging.HostStager(), dest, fly,
                                     _NP[dtype])
    assert rec.numpy().tobytes() == jrec.tobytes()
    d, f, w, g = staging.unpack_move_record(rec, dtype, None, True)
    assert w is None and g is None
    assert d.numpy().tobytes() == dest.astype(_NP[dtype]).tobytes()
    np.testing.assert_array_equal(f.numpy(), fly)


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_readback_round_trip_and_jax_bytes(dtype, stats):
    rng = np.random.default_rng(5)
    n = 19
    pos = _special(rng, n).astype(_NP[dtype])
    mats = rng.integers(-1, 5, n).astype(np.int32)
    mats[:3] = [-1, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    done = rng.uniform(size=n) > 0.2
    vec = np.array([5, -1, 2**40, 0, 7, -(2**62), 3, 1], np.int64)
    segs = np.int64(2**33 + 5)
    args = (pos, mats, done, vec if stats else None, segs)
    rb = staging.pack_trace_readback(
        *(None if a is None else torch.as_tensor(a) for a in args))
    jrb = np.asarray(jstaging.pack_trace_readback(
        *(None if a is None else jnp.asarray(a) for a in args), None))
    assert rb.numpy().tobytes() == jrb.tobytes()
    p, m, d, tail, integ, conv = staging.split_trace_readback(rb, n, dtype)
    assert integ is None and conv is None
    assert np.ascontiguousarray(p).tobytes() == pos.tobytes()
    np.testing.assert_array_equal(m, mats)
    assert m.dtype == np.int32
    np.testing.assert_array_equal(d, done)
    np.testing.assert_array_equal(tail, vec if stats else [segs])
    jp, jm, jd, jtail, _, _ = jstaging.split_trace_readback(
        jrb, n, _NP[dtype])
    assert np.ascontiguousarray(p).tobytes() == jp.tobytes()
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(tail, jtail)


def test_unported_record_parts_raise():
    """Only a carrier width other than 4 or 8 bytes is refused now. The
    integrity tail is ported: it rides after the stats tail and before
    the convergence summary, bit for bit, in the JAX package's layout
    (the JAX split reads the port's record). The slot permutation of the
    element sort is ported: the unpack gathers host rows into slots and
    the readback scatters slots back into host order."""
    dest = np.arange(6, dtype=np.float64).reshape(2, 3)
    rec = staging.pack_init_record(staging.HostStager(device="cpu"),
                                   dest, np.array([True, False]),
                                   torch.float64)
    perm = torch.tensor([1, 0])
    d, fly, _, _ = staging.unpack_move_record(rec, torch.float64, perm, True)
    np.testing.assert_array_equal(d.numpy(), dest[::-1])
    np.testing.assert_array_equal(fly.numpy(), [False, True])
    integ = torch.tensor([1.5, 1.25, 1e-9, 0.0, 2.0, 1.0],
                         dtype=torch.float64)
    conv = torch.arange(CONV_LEN, dtype=torch.float64) / 7
    rb = staging.pack_trace_readback(
        d, torch.tensor([7, 8], dtype=torch.int32), fly, None,
        torch.tensor(5), perm=perm, integrity=integ, convergence=conv)
    pos, mats, done, tail, got, c = staging.split_trace_readback(
        rb, 2, torch.float64, integrity=True, convergence=True)
    np.testing.assert_array_equal(pos, dest)
    np.testing.assert_array_equal(mats, [8, 7])
    np.testing.assert_array_equal(done, [True, False])
    np.testing.assert_array_equal(tail, [5])
    np.testing.assert_array_equal(got, integ.numpy())
    np.testing.assert_array_equal(c, conv.numpy())
    jp, jm, jd, jtail, jinteg, jconv = jstaging.split_trace_readback(
        rb.numpy().view(np.uint64), 2, np.float64, integrity=True,
        convergence=True)
    np.testing.assert_array_equal(jinteg, integ.numpy())
    np.testing.assert_array_equal(jconv, conv.numpy())
    np.testing.assert_array_equal(jtail, [5])
    with pytest.raises(NotImplementedError, match="4- or 8-byte"):
        staging.np_carrier(torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_megastep_tail_integrity_slot_is_the_jax_packages(dtype):
    """The megastep tail with the integrity vector: the port's pack, split
    by the port and by the JAX package, gives the same words."""
    from pumiumtally_tpu_torch.ops.source import MEGA_PHYS_LEN

    stats = torch.arange(8, dtype=torch.int64)
    integ = torch.tensor([3.5, 3.25, 1e-6, 0.0, 64.0, 60.0], dtype=dtype)
    phys = torch.arange(MEGA_PHYS_LEN, dtype=dtype) + 0.5
    vec = staging.pack_megastep_tail(stats, None, integ, None, phys, dtype)
    tail, got, conv, p = staging.split_megastep_tail(vec, dtype, True, True,
                                                     False)
    np.testing.assert_array_equal(tail, stats.numpy())
    np.testing.assert_array_equal(got, integ.numpy().astype(np.float64))
    assert conv is None
    np.testing.assert_array_equal(p, phys.numpy().astype(np.float64))
    npdt = np.float32 if dtype == torch.float32 else np.float64
    jtail, jinteg, _, jp = jstaging.split_megastep_tail(
        vec.numpy().view(staging.np_carrier(dtype)), npdt, True, True, False)
    np.testing.assert_array_equal(jtail, tail)
    np.testing.assert_array_equal(jinteg, got)
    np.testing.assert_array_equal(jp, p)


def test_host_stager_ring_on_cpu_allocates_fresh():
    """On the CPU a record is the device tensor itself, so every buffer
    is new; the ring (depth, oldest-first reuse) is the card's."""
    st = staging.HostStager(depth=2, device="cpu")
    a, b = st.buf((4, 6), torch.int32), st.buf((4, 6), torch.int32)
    assert a.data_ptr() != b.data_ptr()
    assert not st.pinned and st.depth == 2
    assert staging.to_host(st, a) is a


def test_host_stager_defaults_to_the_card():
    """Built bare, a stager is the card's (pinned buffers), as every entry
    point defaults to the card; without CUDA it raises PumiTally's error."""
    from pumiumtally_tpu_torch import PumiTally
    from pumiumtally_tpu_torch.utils.platform import resolve_device

    if torch.cuda.is_available():
        assert staging.HostStager().pinned
        return
    with pytest.raises(RuntimeError) as stager_err:
        staging.HostStager()
    with pytest.raises(RuntimeError) as tally_err:
        PumiTally(None, 4)
    with pytest.raises(RuntimeError) as device_err:
        resolve_device()
    assert str(stager_err.value) == str(tally_err.value) == str(
        device_err.value)
    assert "device='cpu'" in str(stager_err.value)


# --------------------------------------------------------------------- #
# The packed step
# --------------------------------------------------------------------- #
def _jax_and_port_mesh(dtype, nx=4):
    coords, t2v = build_box_arrays(1.0, 1.0, 1.0, nx, nx, nx)
    cen = coords[t2v].mean(axis=1)
    cls = np.where(cen[:, 0] < 0.5, 1, 2).astype(np.int32)
    jmesh = jpt.TetMesh.from_numpy(coords, t2v, class_id=cls,
                                   dtype=_JDT[dtype])
    pmesh = mesh_from_jax_arrays(
        {f: np.asarray(getattr(jmesh, f)) for f in MESH_FIELDS}, "cpu")
    return jmesh, pmesh


def test_trace_packed_is_the_walk_between_the_records():
    """``trace_packed`` (plain, and the card wrapper on CPU tensors) is the
    walk of the unpacked record, bit for bit, with its readback; against
    the JAX ``trace_packed`` the positions agree within 1e-12 (float64)."""
    dtype, G, n = torch.float64, 2, 64
    jmesh, pmesh = _jax_and_port_mesh(dtype)
    rng = np.random.default_rng(9)
    elem = rng.integers(0, pmesh.ntet, n).astype(np.int32)
    origin = pmesh.centroids()[torch.from_numpy(elem).long()]
    dest, w, g, fly = (rng.uniform(-0.1, 1.1, (n, 3)),
                       rng.uniform(0.5, 2.0, n),
                       rng.integers(0, G, n).astype(np.int32),
                       rng.uniform(size=n) > 0.1)
    rec = staging.pack_move_record(staging.HostStager(device="cpu"), dest,
                                   w, g, fly, dtype)
    mat = torch.full((n,), -1, dtype=torch.int32)
    kw = dict(initial=False, max_crossings=pmesh.ntet + 64, n_groups=G)
    flux = torch.zeros(pmesh.ntet * G * 2, dtype=dtype)
    r, rb, d, f, ww, gg = walk.trace_packed(
        pmesh, origin, torch.from_numpy(elem), mat, rec, flux.clone(), **kw)
    r2, rb2, *_ = walk_cuda.trace_packed(
        pmesh, origin, torch.from_numpy(elem), mat, rec, flux.clone(), **kw)
    ref = walk.trace(pmesh, origin, d, torch.from_numpy(elem), f, ww, gg,
                     mat, flux.clone(), **kw)
    assert torch.equal(r.flux, ref.flux) and torch.equal(r2.flux, ref.flux)
    assert torch.equal(rb, rb2)
    assert torch.equal(rb, staging.pack_trace_readback(
        ref.position, ref.material_id, ref.done, ref.stats,
        ref.n_segments))
    jr, jrb, *_ = jtrace_packed(
        jmesh, jnp.asarray(origin.numpy()), jnp.asarray(elem),
        jnp.asarray(mat.numpy()), jnp.asarray(rec.numpy().view(np.uint64)),
        jnp.zeros(pmesh.ntet * G * 2, jnp.float64), None, **kw)
    p, m, dn, tail, _, _ = staging.split_trace_readback(rb, n, dtype)
    jp, jm, jd, jtail, _, _ = jstaging.split_trace_readback(
        np.asarray(jrb), n, np.float64)
    np.testing.assert_allclose(p, jp, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(dn, jd)
    np.testing.assert_array_equal(tail, jtail)


# --------------------------------------------------------------------- #
# The facade's io_pipeline modes
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mesh64():
    return _jax_and_port_mesh(torch.float64)


def _drive(t, moves=3, seed=17):
    """tests/test_io_pipeline.py::_drive: parked lanes ride along."""
    rng = np.random.default_rng(seed)
    n = t.num_particles
    pos = rng.uniform(0.05, 0.95, (n, 3))
    t.initialize_particle_location(pos.ravel().copy(), n * 3)
    outs, prev = [], pos
    for _ in range(moves):
        dest = np.clip(prev + rng.normal(0, 0.25, (n, 3)), -0.1, 1.1)
        buf = dest.ravel().copy()
        flying = np.ones(n, np.int8)
        flying[::7] = 0
        w = rng.uniform(0.5, 2.0, n)
        g = rng.integers(0, 2, n).astype(np.int32)
        mats = np.full(n, 9, np.int32)
        t.move_to_next_location(buf, flying, w, g, mats, buf.size)
        outs.append((buf.reshape(n, 3).copy(), mats.copy()))
        prev = buf.reshape(n, 3).copy()
    return outs


def _cfg(io):
    return TallyConfig(n_groups=2, dtype=torch.float64, tolerance=1e-8,
                       io_pipeline=io)


@pytest.fixture(scope="module")
def single_legacy(mesh64):
    t = PumiTally(mesh64[1], N, _cfg("legacy"), device="cpu")
    outs = _drive(t)
    return outs, t.raw_flux, t.element_ids, t.total_segments


@pytest.mark.parametrize("io", ["packed", "overlap"])
def test_single_chip_pipeline_parity(mesh64, single_legacy, io):
    outs_a, flux_a, elems_a, segs_a = single_legacy
    b = PumiTally(mesh64[1], N, _cfg(io), device="cpu")
    outs_b = _drive(b)
    for (pa, ma), (pb, mb) in zip(outs_a, outs_b):
        np.testing.assert_array_equal(pb, pa)
        np.testing.assert_array_equal(mb, ma)
    np.testing.assert_array_equal(b.raw_flux, flux_a)
    np.testing.assert_array_equal(b.element_ids, elems_a)
    assert b.total_segments == segs_a


def _move(t, seed):
    rng = np.random.default_rng(seed)
    n = t.num_particles
    buf = rng.uniform(0.1, 0.9, (n, 3)).ravel()
    t.move_to_next_location(
        buf, np.ones(n, np.int8), rng.uniform(0.5, 2.0, n),
        rng.integers(0, 2, n).astype(np.int32), np.full(n, -1, np.int32),
    )


@pytest.mark.parametrize("io,h2d,d2h", [
    ("packed", 1, 1), ("overlap", 1, 1), ("legacy", 4, 1),
])
def test_steady_state_transfers(io, h2d, d2h):
    """A steady-state move's transfers (``PumiTally.io``): one each way
    packed, four host→device legacy; the initial search one each way
    packed. Bytes follow the record layouts."""
    n = 64
    t = PumiTally(build_box(1.0, 1.0, 1.0, 3, 3, 3, device="cpu"), n,
                  TallyConfig(tolerance=1e-6, io_pipeline=io), device="cpu")
    rng = np.random.default_rng(0)
    t.initialize_particle_location(rng.uniform(0.1, 0.9, (n, 3)).ravel())
    if io != "legacy":
        assert t.io == dict(h2d_transfers=1, h2d_bytes=n * 4 * 4,
                            d2h_transfers=1, d2h_bytes=n * 5 * 4 + 64)
    _move(t, 1)
    before = dict(t.io)
    _move(t, 2)
    delta = {k: t.io[k] - before[k] for k in before}
    assert (delta["h2d_transfers"], delta["d2h_transfers"]) == (h2d, d2h)
    if io == "legacy":
        assert delta["h2d_bytes"] == n * (12 + 1 + 4 + 4)
        assert delta["d2h_bytes"] == 64 + n * (12 + 4)
    else:
        assert delta["h2d_bytes"] == n * staging.MOVE_COLS * 4
        assert delta["d2h_bytes"] == n * staging.READBACK_COLS * 4 + 64


def test_packed_walk_stats_off_and_truncation_warn():
    """walk_stats=False: the readback's tail is the segment count and the
    truncations come from its done flags, as in the legacy summary."""
    n = 3
    counts = {}
    for io in ("packed", "legacy"):
        t = PumiTally(build_box(dtype=torch.float64, device="cpu"), n,
                      TallyConfig(dtype=torch.float64, walk_stats=False,
                                  max_crossings=1, io_pipeline=io),
                      device="cpu")
        with pytest.warns(RuntimeWarning, match="truncated"):
            t.initialize_particle_location(np.tile([0.95, 0.05, 0.05], n))
        dest = np.tile([0.05, 0.95, 0.95], n)
        with pytest.warns(RuntimeWarning, match="3 particle walk"):
            t.move_to_next_location(dest, np.ones(n, np.int8), np.ones(n),
                                    np.zeros(n, np.int32),
                                    np.zeros(n, np.int32))
        counts[io] = (t.total_segments, dest.copy())
    assert counts["packed"][0] == counts["legacy"][0] > 0
    np.testing.assert_array_equal(counts["packed"][1], counts["legacy"][1])


def test_io_pipeline_knob_validation_and_overrides(monkeypatch):
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    assert TallyConfig().resolve_io_pipeline() == "packed"
    assert TallyConfig(io_pipeline="overlap").resolve_io_pipeline() == \
        "overlap"
    with pytest.raises(ValueError, match="io_pipeline"):
        TallyConfig(io_pipeline="bogus").resolve_io_pipeline()
    monkeypatch.setenv("PUMI_TPU_IO_PIPELINE", "legacy")
    assert TallyConfig(io_pipeline="packed").resolve_io_pipeline() == \
        "legacy"
    t = PumiTally(build_box(device="cpu"), 2, TallyConfig(), device="cpu")
    assert t._io == "legacy" and t._stager.depth == 1
    monkeypatch.setenv("PUMI_TPU_IO_PIPELINE", "nope")
    with pytest.raises(ValueError, match="io_pipeline"):
        TallyConfig().resolve_io_pipeline()
    with pytest.raises(ValueError, match="io_pipeline"):
        PumiTally(build_box(device="cpu"), 2, TallyConfig(), device="cpu")
    monkeypatch.setenv("PUMI_TPU_IO_PIPELINE", "overlap")
    t = PumiTally(build_box(device="cpu"), 2, TallyConfig(), device="cpu")
    assert t._io == "overlap" and t._stager.depth == 2


def test_packed_facade_matches_jax_packed(mesh64):
    """The port's packed facade against the JAX facade's on the two-class
    float64 box: positions within 1e-12, flux within 1e-10 relative per
    bin (plus 1e-12 absolute for bins of rounding-sized segments)."""
    jmesh, pmesh = mesh64
    jt = jpt.PumiTally(jmesh, N, jpt.TallyConfig(
        n_groups=2, dtype=jnp.float64, tolerance=1e-8, io_pipeline="packed"))
    pt = PumiTally(pmesh, N, _cfg("packed"), device="cpu")
    outs_j, outs_p = _drive(jt), _drive(pt)
    for (pj, mj), (pp, mp) in zip(outs_j, outs_p):
        np.testing.assert_allclose(pp, pj, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(mp, mj)
    np.testing.assert_array_equal(pt.element_ids, np.asarray(jt.element_ids))
    np.testing.assert_allclose(pt.raw_flux, jt.raw_flux, rtol=1e-10,
                               atol=1e-12)
    assert pt.total_segments == jt.total_segments


# --------------------------------------------------------------------- #
# The ordered walk's record-count guard
# --------------------------------------------------------------------- #
def test_record_count_guard_at_the_int32_edge():
    """A walk's records reach the ordered scatter only if they fit int32:
    2^31 − 1 passes, 2^31 raises (before the relaunch's buffers and the
    scatter, which counts in int32)."""
    edge = 2**31 - 1
    assert walk_cuda.check_record_count(edge) == edge
    with pytest.raises(ValueError, match="2147483648 tally records"):
        walk_cuda.check_record_count(edge + 1)
    scatter.check_counts(edge, 10)
    with pytest.raises(ValueError, match="int32"):
        scatter.check_counts(edge + 1, 10)
    with pytest.raises(ValueError, match="int32"):
        scatter.check_counts(1, edge)
