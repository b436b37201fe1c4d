"""A walk's result does not depend on how its lanes are scheduled.

The walk kernel (``csrc/walk.cu``) keeps its threads resident: each
thread walks lane after lane, taking them in the order of their start
elements, and writes a lane's outputs when that lane is done or truncated.
Every lane keeps its own iteration count, and its tally records are keyed
``iteration · n + lane``, so the ordered fold lands each bin's adds in the
same sequence whatever the schedule.

Here that schedule is played on the CPU with the plain walk: the lanes of
a move are walked in a permuted order, in chunks, each chunk into records
keyed by its lanes' own indices (``ops/walk.py::trace_records``), and all
records are folded once with ``scatter_ordered_plain``. The flux must be
bitwise the one-shot plain walk's and every per-lane output equal. Mirrors
``tests/test_walk_compaction.py::test_compaction_matches_flat`` and
``::test_compaction_with_truncation_reports_not_done`` (the JAX walk's
straggler compaction is the same kind of scheduling change), with their
inputs. Against the JAX walk the result is held to the tolerances of
``tests/test_torch_walk.py``: positions within 1e-12, flux within rtol
1e-10 and an absolute allowance of 1e-12 times the largest weight
(float64).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumiumtally_tpu import build_box as jbuild_box
from pumiumtally_tpu import make_flux as jmake_flux
from pumiumtally_tpu.ops import walk as jwalk
from pumiumtally_tpu.ops.geometry import locate_points as jlocate_points
from pumiumtally_tpu_torch.convert import MESH_FIELDS, mesh_from_jax_arrays
from pumiumtally_tpu_torch.ops.geometry import locate_points
from pumiumtally_tpu_torch.ops import scatter, walk, walk_cuda

POS_TOL, FLUX_RTOL = 1e-12, 1e-10  # float64, as tests/test_torch_walk.py


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
LANE_OUTPUTS = ("position", "elem", "material_id", "done", "lane_iters",
                "track_length")


def _port_mesh(jm):
    return mesh_from_jax_arrays(
        {f: np.asarray(getattr(jm, f)) for f in MESH_FIELDS}, "cpu"
    )


def _compaction_inputs():
    """The inputs of test_compaction_matches_flat: 4^3 box, float64, 128
    lanes of short hops, long diagonals and out-of-domain destinations,
    about 20% parked."""
    jm = jbuild_box(1, 1, 1, 4, 4, 4, dtype=jnp.float64)
    n = 128
    rng = np.random.default_rng(5)
    origin = rng.uniform(0.05, 0.95, (n, 3))
    dest = origin + rng.normal(scale=0.05, size=(n, 3))
    dest[: n // 4] = rng.uniform(-0.5, 1.5, (n // 4, 3))
    in_flight = rng.random(n) > 0.2
    weight = rng.uniform(0.1, 3.0, n)
    group = rng.integers(0, G, n).astype(np.int32)
    elem = _locate(jm, origin)
    assert (elem >= 0).all()
    lanes = dict(origin=origin, dest=dest, elem=elem.astype(np.int32),
                 fly=in_flight, w=weight, g=group,
                 mat=np.full(n, -1, np.int32))
    return jm, lanes, 3.0


def _bar_inputs():
    """The inputs of test_compaction_with_truncation_reports_not_done: 4
    lanes along a 20-cell bar that need ~100 crossings."""
    jm = jbuild_box(20.0, 1.0, 1.0, 20, 1, 1, dtype=jnp.float64)
    n = 4
    origin = np.tile([0.05, 0.4, 0.5], (n, 1))
    dest = np.tile([19.95, 0.4, 0.5], (n, 1))
    elem = _locate(jm, origin)
    lanes = dict(origin=origin, dest=dest, elem=elem.astype(np.int32),
                 fly=np.ones(n, bool), w=np.ones(n), g=np.zeros(n, np.int32),
                 mat=np.full(n, -1, np.int32))
    return jm, lanes, 1.0


def _args(pm, a, idx=None):
    sel = slice(None) if idx is None else idx
    t = torch.from_numpy
    return (pm, t(np.ascontiguousarray(a["origin"][sel])),
            t(np.ascontiguousarray(a["dest"][sel])), t(a["elem"][sel]),
            t(a["fly"][sel]), t(a["w"][sel]), t(a["g"][sel]),
            t(a["mat"][sel]))


def _scheduled(pm, a, order, chunk, kw):
    """The move walked ``chunk`` lanes at a time in the lane order
    ``order``, every chunk into records keyed by its lanes' own indices,
    then one ordered fold of all records. Returns the per-lane outputs in
    lane order, the flux and the summed segment count."""
    n = len(order)
    out = {name: None for name in LANE_OUTPUTS}
    bins, keys, cs = [], [], []
    segments = 0
    for lo in range(0, n, chunk):
        ids = order[lo:lo + chunk].astype(np.int64)
        ids_t = torch.from_numpy(ids)
        flux = torch.zeros(pm.ntet * G * 2, dtype=torch.float64)
        r, rec = walk.trace_records(*_args(pm, a, ids), flux,
                                    lane_ids=ids_t, n_keys=n, **kw)
        assert not flux.any()  # records only
        for name in LANE_OUTPUTS:
            v = getattr(r, name)
            if out[name] is None:
                out[name] = torch.empty((n, *v.shape[1:]), dtype=v.dtype)
            out[name][ids_t] = v
        bins.append(rec.bin)
        keys.append(rec.order)
        cs.append(rec.c)
        segments += int(r.n_segments)
    flux = scatter.scatter_ordered_plain(
        torch.zeros(pm.ntet * G * 2, dtype=torch.float64), torch.cat(bins),
        torch.cat(keys), torch.cat(cs))
    return out, flux, segments


@pytest.mark.parametrize("chunk", [1, 13, 128])
@pytest.mark.parametrize("lane_order", ["random", "element", "records"])
@pytest.mark.parametrize("truncate", [False, True],
                         ids=["whole", "truncated"])
def test_schedule_matches_one_shot(truncate, lane_order, chunk):
    jm, a, w_max = _compaction_inputs()
    pm = _port_mesh(jm)
    n = len(a["elem"])
    kw = dict(max_crossings=3 if truncate else jm.ntet + 64, n_groups=G,
              tolerance=1e-12)
    if lane_order == "element":
        order = scatter.lane_order(torch.from_numpy(a["elem"]),
                                   pm.ntet).numpy()
    elif lane_order == "records":  # the lane schedule's slot order
        rec = walk_cuda.lane_records(*_args(pm, a)[:7], initial=False)
        order = walk_cuda.decode_lanes(rec, torch.float64)["index"].numpy()
    else:
        order = np.random.default_rng(1).permutation(n)
    lanes, flux, segments = _scheduled(pm, a, order, chunk, kw)

    one = walk.trace(*_args(pm, a), torch.zeros(pm.ntet * G * 2,
                                                dtype=torch.float64),
                     initial=False, **kw)
    assert torch.equal(flux, one.flux)
    for name in LANE_OUTPUTS:
        assert torch.equal(lanes[name], getattr(one, name)), name
    assert segments == int(one.n_segments)
    assert bool(lanes["done"].all()) != truncate

    ref = jwalk.trace(
        jm, *(jnp.asarray(a[k]) for k in ("origin", "dest", "elem", "fly",
                                          "w", "g", "mat")),
        jmake_flux(jm.ntet, G, jnp.float64, flat=True), initial=False,
        unroll=1, compact_after=None, **kw,
    )
    for name in ("elem", "material_id", "done"):
        np.testing.assert_array_equal(lanes[name].numpy(),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_allclose(lanes["position"].numpy(),
                               np.asarray(ref.position), rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(flux.numpy(), np.asarray(ref.flux),
                               rtol=FLUX_RTOL, atol=POS_TOL * w_max)
    assert segments == int(ref.n_segments)


def test_schedule_with_truncation_reports_not_done():
    jm, a, _ = _bar_inputs()
    pm = _port_mesh(jm)
    kw = dict(max_crossings=10, n_groups=G, tolerance=1e-8)
    lanes, flux, _ = _scheduled(pm, a, np.array([2, 0, 3, 1]), 2, kw)
    one = walk.trace(*_args(pm, a), torch.zeros(pm.ntet * G * 2,
                                                dtype=torch.float64),
                     initial=False, **kw)
    assert not bool(lanes["done"].any())
    assert (lanes["lane_iters"] == 10).all()
    assert torch.equal(flux, one.flux)
    for name in LANE_OUTPUTS:
        assert torch.equal(lanes[name], getattr(one, name)), name


@pytest.mark.parametrize("elem", [
    np.zeros(97, np.int32),  # the initial search: every lane in element 0
    np.random.default_rng(3).integers(0, 384, 500).astype(np.int32),
    np.arange(64, dtype=np.int32)[::-1].copy(),
    np.zeros(0, np.int32),
])
def test_plain_lane_order_is_a_permutation_by_element(elem):
    perm = scatter.lane_order(torch.from_numpy(elem), 384)
    assert perm.dtype == torch.int32
    assert torch.equal(torch.sort(perm.long()).values,
                       torch.arange(len(elem)))
    by_elem = torch.from_numpy(elem)[perm.long()]
    assert bool((by_elem[1:] >= by_elem[:-1]).all())


def test_lane_order_rejects_other_types():
    with pytest.raises(TypeError, match="int32"):
        scatter.lane_order(torch.zeros(4, dtype=torch.int64), 10)


def test_cpu_walk_records_complete_the_walk():
    """``walk_cuda.walk_records`` on CPU tensors: the plain walk's records,
    whose ordered fold gives ``trace``'s flux, bitwise."""
    jm, a, _ = _compaction_inputs()
    pm = _port_mesh(jm)
    kw = dict(max_crossings=jm.ntet + 64, n_groups=G)
    flux = torch.zeros(pm.ntet * G * 2, dtype=torch.float64)
    r, rec = walk_cuda.walk_records(*_args(pm, a), flux, **kw)
    assert not flux.any()
    assert rec.bin.dtype == torch.int32 and rec.order.dtype == torch.int64
    assert rec.bin.numel() <= int(r.n_segments)
    one = walk.trace(*_args(pm, a), torch.zeros_like(flux), initial=False,
                     **kw)
    scatter.scatter_ordered(flux, rec.bin, rec.order, rec.c)
    assert torch.equal(flux, one.flux)
    assert torch.equal(r.position, one.position)


def test_destination_cells_cover_the_mesh_box():
    """The initial search's lane keys: one cell per 6 elements on the box
    (its hexahedra), in raster order, destinations outside the box in the
    nearest cell."""
    from pumiumtally_tpu_torch.mesh.box import build_box

    mesh = build_box(2.0, 1.0, 1.0, 8, 4, 4, device="cpu")
    pts = torch.tensor([[0.01, 0.01, 0.01], [0.26, 0.01, 0.01],
                        [0.01, 0.26, 0.01], [0.01, 0.01, 0.26],
                        [1.99, 0.99, 0.99], [-5.0, 0.5, 9.0],
                        [float("nan"), float("inf"), -float("inf")]],
                       dtype=torch.float32)
    keys, cells = walk_cuda.destination_cells(mesh, pts)
    assert cells == mesh.ntet // 6 == 8 * 4 * 4
    assert keys.dtype == torch.int32
    assert keys.tolist() == [0, 1, 8, 32, cells - 1, 3 * 32 + 2 * 8, 3 * 8]
