"""The walk's lane schedule on the CPU: ``walk_cuda.lane_records_plain``.

The schedule writes every lane's walk inputs as one ``LaneRecord<T>``
(``csrc/walk.cu``) in slot order: keys non-decreasing, lanes of one key in
any order. The plain version sorts stably by key. Here its bytes are held
to a numpy structured dtype laid out as the C struct (32 B aligned, so a
record fills whole sectors; padding zero), its order to the keys over the sizes where a warp or a scan tile
is ragged, and a walk fed from its decoded records to the JAX package's
walk on the same seeded inputs: positions within 1e-12 and flux within
rtol 1e-10 in float64, the tolerances of ``tests/test_torch_walk.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pumiumtally_tpu import build_box as jbuild_box
from pumiumtally_tpu import make_flux as jmake_flux
from pumiumtally_tpu.ops import walk as jwalk
from pumiumtally_tpu.ops.geometry import locate_points as jlocate_points
from pumiumtally_tpu_torch.convert import MESH_FIELDS, mesh_from_jax_arrays
from pumiumtally_tpu_torch.ops.geometry import locate_points
from pumiumtally_tpu_torch.mesh.box import build_box
from pumiumtally_tpu_torch.ops import scatter, walk, walk_cuda

POS_TOL, FLUX_RTOL = 1e-12, 1e-10


def _locate(jm, origin) -> np.ndarray:
    """The lanes' parent elements by the port's locate_points on the port's
    copy of ``jm``, checked against the JAX package's."""
    pm = mesh_from_jax_arrays({f: np.asarray(getattr(jm, f))
                               for f in MESH_FIELDS}, "cpu")
    elem = locate_points(pm, torch.as_tensor(origin), 1e-12).numpy()
    np.testing.assert_array_equal(
        elem, np.asarray(jlocate_points(jm, jnp.asarray(origin), 1e-12)))
    return elem
G = 2
DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def lane_dtype(real) -> np.dtype:
    """``LaneRecord<T>`` as a numpy structured dtype: C's field offsets
    (``align=True``) and the struct's 32 B alignment on its size."""
    fields = [("o", real, (3,)), ("d", real, (3,)), ("w", real),
              ("elem", np.int32), ("group", np.int32), ("index", np.int32),
              ("fly", np.int32)]
    c = np.dtype(fields, align=True)
    return np.dtype({"names": c.names,
                     "formats": [c.fields[k][0] for k in c.names],
                     "offsets": [c.fields[k][1] for k in c.names],
                     "itemsize": -(-c.itemsize // 32) * 32})


def lane_inputs(n: int, ntet: int, dtype, seed: int = 0):
    rng = np.random.default_rng(seed)
    real = DTYPES[dtype]
    return dict(
        origin=rng.uniform(size=(n, 3)).astype(real),
        dest=rng.uniform(-0.2, 1.2, size=(n, 3)).astype(real),
        elem=rng.integers(0, ntet, n).astype(np.int32),
        fly=rng.uniform(size=n) > 0.3,
        w=rng.uniform(0.1, 3.0, n).astype(real),
        g=rng.integers(0, 3, n).astype(np.int32),
    )


def torch_args(a):
    t = torch.from_numpy
    return (t(a["origin"]), t(a["dest"]), t(a["elem"]), t(a["fly"]),
            t(a["w"]), t(a["g"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lane_records_plain_bytes_match_the_c_struct(dtype):
    lane = lane_dtype(DTYPES[dtype])
    assert lane.itemsize == walk_cuda.LANE_BYTES[dtype]
    n = 257
    a = lane_inputs(n, 50, dtype)
    keys = np.random.default_rng(1).integers(0, 9, n).astype(np.int32)
    got = walk_cuda.lane_records_plain(torch.from_numpy(keys),
                                       *torch_args(a))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (n, lane.itemsize)

    order = np.argsort(keys, kind="stable")
    want = np.zeros(n, lane)  # padding zero
    want["o"], want["d"], want["w"] = (a["origin"][order], a["dest"][order],
                                       a["w"][order])
    want["elem"], want["group"] = a["elem"][order], a["g"][order]
    want["index"], want["fly"] = order, a["fly"][order]
    np.testing.assert_array_equal(got.numpy(),
                                  want.view(np.uint8).reshape(n, -1))

    f = walk_cuda.decode_lanes(got, dtype)
    np.testing.assert_array_equal(f["origin"].numpy(), want["o"])
    np.testing.assert_array_equal(f["dest"].numpy(), want["d"])
    np.testing.assert_array_equal(f["weight"].numpy(), want["w"])
    for name, field in (("elem", "elem"), ("group", "group"),
                        ("index", "index")):
        np.testing.assert_array_equal(f[name].numpy(), want[field])
    np.testing.assert_array_equal(f["in_flight"].numpy(), want["fly"] != 0)


@settings(max_examples=40, deadline=None)
@given(n=st.sampled_from([0, 1, 31, 33, 2**12 + 7]),
       keys=st.sampled_from(["one key", "top key", "random", "descending"]),
       dtype=st.sampled_from([torch.float32, torch.float64]),
       seed=st.integers(0, 2**32 - 1))
def test_plain_schedule_is_a_permutation_by_key(n, keys, dtype, seed):
    nbins = 97
    rng = np.random.default_rng(seed)
    k = {
        "one key": np.full(n, rng.integers(0, nbins)),
        "top key": np.full(n, nbins - 1),
        "random": rng.integers(0, nbins, n),
        "descending": nbins - 1 - np.arange(n) * nbins // max(n, 1),
    }[keys].astype(np.int32)
    a = lane_inputs(n, 50, dtype, seed % 1000)
    rec = walk_cuda.lane_records_plain(torch.from_numpy(k), *torch_args(a))
    idx = walk_cuda.decode_lanes(rec, dtype)["index"].numpy()
    np.testing.assert_array_equal(np.sort(idx), np.arange(n))
    assert (np.diff(k[idx]) >= 0).all()
    assert (idx == np.argsort(k, kind="stable")).all()  # stable in a key


@pytest.mark.parametrize("cells", [(4, 4, 4), (3, 5, 2)])
def test_lane_keys_of_a_move_are_coarse_elements(cells):
    """A move's lane key is its start element, one key an element."""
    mesh = build_box(1, 1, 1, *cells, device="cpu")
    elem = torch.tensor([0, 7, 8, mesh.ntet - 1, -3, mesh.ntet + 40],
                        dtype=torch.int32)
    keys, nkeys = walk_cuda.lane_keys(mesh, elem, None, False)
    assert nkeys == mesh.ntet == 6 * cells[0] * cells[1] * cells[2]
    assert keys.dtype == torch.int32
    # Out-of-range elements take the nearest key, as in the kernel.
    assert keys.tolist() == [0, 7, 8, nkeys - 1, 0, nkeys - 1]


def test_lane_records_on_the_cpu_run_no_kernel():
    mesh = build_box(1, 1, 1, 4, 4, 4, device="cpu")
    a = lane_inputs(100, mesh.ntet, torch.float32)
    before = walk_cuda.SCHEDULE_LAUNCHES
    for initial in (False, True):
        rec = walk_cuda.lane_records(mesh, *torch_args(a), initial=initial)
        keys, _ = walk_cuda.lane_keys(mesh, torch.from_numpy(a["elem"]),
                                      torch.from_numpy(a["dest"]), initial)
        want = walk_cuda.lane_records_plain(keys, *torch_args(a))
        assert torch.equal(rec, want)
    assert walk_cuda.SCHEDULE_LAUNCHES == before


def test_lane_order_refuses_a_device_tensor():
    keys = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="lane_records"):
        scatter.lane_order(keys, 10)


def _jax_case(initial: bool):
    """128 lanes on the 4^3 float64 box (the inputs of
    tests/test_torch_schedule.py's compaction case): short hops, long
    diagonals, destinations outside the domain, some lanes parked; the
    initial search starts every lane in element 0."""
    jm = jbuild_box(1, 1, 1, 4, 4, 4, dtype=jnp.float64)
    n = 128
    rng = np.random.default_rng(5)
    origin = rng.uniform(0.05, 0.95, (n, 3))
    dest = origin + rng.normal(scale=0.05, size=(n, 3))
    dest[: n // 4] = rng.uniform(-0.5, 1.5, (n // 4, 3))
    fly = rng.random(n) > 0.2
    w = rng.uniform(0.1, 3.0, n)
    g = rng.integers(0, G, n).astype(np.int32)
    elem = _locate(jm, origin)
    if initial:
        origin = np.tile(origin[:1], (n, 1))
        elem = np.full(n, int(elem[0]))
        dest = rng.uniform(0.02, 0.98, (n, 3))
        fly = np.ones(n, bool)
    return jm, dict(origin=origin, dest=dest, elem=elem.astype(np.int32),
                    fly=fly, w=w, g=g, mat=np.full(n, -1, np.int32))


@pytest.mark.parametrize("initial", [False, True],
                         ids=["move", "initial"])
def test_scheduled_walk_matches_jax(initial):
    """The records of the schedule, decoded and walked in slot order by
    the plain walk (records keyed by each lane's own index), unpermuted
    through Lane.index, hold against the JAX walk."""
    jm, a = _jax_case(initial)
    pm = mesh_from_jax_arrays(
        {f: np.asarray(getattr(jm, f)) for f in MESH_FIELDS}, "cpu")
    n = len(a["elem"])
    t = torch.from_numpy
    rec = walk_cuda.lane_records(pm, t(a["origin"]), t(a["dest"]),
                                 t(a["elem"]), t(a["fly"]), t(a["w"]),
                                 t(a["g"]), initial=initial)
    f = walk_cuda.decode_lanes(rec, torch.float64)
    idx = f["index"].long()
    keys, _ = walk_cuda.lane_keys(pm, t(a["elem"]), t(a["dest"]), initial)
    assert bool((keys[idx][1:] >= keys[idx][:-1]).all())
    kw = dict(max_crossings=jm.ntet + 64, n_groups=G, tolerance=1e-12)
    flux = torch.zeros(pm.ntet * G * 2, dtype=torch.float64)
    args = (pm, f["origin"].contiguous(), f["dest"].contiguous(),
            f["elem"].contiguous(), f["in_flight"].contiguous(),
            f["weight"].contiguous(), f["group"].contiguous(),
            t(a["mat"]))
    if initial:
        r = walk.trace(*args, flux, initial=True, **kw)
    else:
        r, recs = walk.trace_records(*args, flux, lane_ids=idx, n_keys=n,
                                     **kw)
        scatter.scatter_ordered_plain(flux, recs.bin, recs.order, recs.c)
    pos = torch.empty_like(r.position)
    pos[idx] = r.position
    elem = torch.empty_like(r.elem)
    elem[idx] = r.elem
    done = torch.empty_like(r.done)
    done[idx] = r.done

    ref = jwalk.trace(
        jm, *(jnp.asarray(a[k]) for k in ("origin", "dest", "elem", "fly",
                                          "w", "g", "mat")),
        jmake_flux(jm.ntet, G, jnp.float64, flat=True), initial=initial,
        unroll=1, compact_after=None, **kw,
    )
    np.testing.assert_array_equal(elem.numpy(), np.asarray(ref.elem))
    np.testing.assert_array_equal(done.numpy(), np.asarray(ref.done))
    np.testing.assert_allclose(pos.numpy(), np.asarray(ref.position),
                               rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(flux.numpy(), np.asarray(ref.flux),
                               rtol=FLUX_RTOL, atol=POS_TOL * a["w"].max())
    if not initial:
        assert flux.any()
