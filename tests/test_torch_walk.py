"""The port's plain walk (``pumiumtally_tpu_torch.ops.walk.trace``) against
the JAX walk.

Both walk identical tables: the port mesh is made from the JAX mesh's
arrays (``convert.mesh_from_jax_arrays``). The JAX reference runs its flat
loop (``kernel="xla"``, ``unroll=1``, no compaction, so its iteration
count is exact) and, once, its Pallas kernel in interpret mode, as
``tests/test_kernel_pallas.py`` runs it on the CPU.

Tolerances: element, material id, done flag and the stats vector must be
equal on every lane. XLA:CPU contracts multiply-adds into FMAs where LLVM
chooses, the port does not, so positions and flux agree to rounding only:
positions within 1e-12 (f64) / 1e-5 (f32) absolute, per-bin flux within
rtol 1e-10 (f64) / 1e-4 (f32). A segment's length is a difference of
positions, so it carries their absolute error: a bin that holds only a
sliver (a ray grazing a corner) cannot meet a relative bound in float32,
and each bin also gets an absolute allowance of the position tolerance
times the largest weight.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumiumtally_tpu import make_flux as jmake_flux
from pumiumtally_tpu.mesh.box import build_box_arrays
from pumiumtally_tpu.mesh.core import TetMesh as JTetMesh
from pumiumtally_tpu.ops import geometry as jgeom
from pumiumtally_tpu.ops import walk as jwalk
from pumiumtally_tpu.ops.walk_pallas import trace_pallas_impl
from pumiumtally_tpu_torch.convert import MESH_FIELDS, mesh_from_jax_arrays
from pumiumtally_tpu_torch.ops import geometry as tgeom
from pumiumtally_tpu_torch.ops import walk as twalk
from pumiumtally_tpu_torch.ops import walk_cuda

_JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}
TOL = {  # (positions atol, flux rtol) — see the module docstring
    torch.float64: (1e-12, 1e-10),
    torch.float32: (1e-5, 1e-4),
}
G = 3
W_MAX = 2.0  # largest particle weight the inputs use


def _meshes(dtype, nx=5, jitter=0.25, seed=11):
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, nx, nx, nx)
    rng = np.random.default_rng(seed)
    interior = (coords > 1e-9).all(axis=1) & (coords < 1 - 1e-9).all(axis=1)
    coords = coords.copy()
    coords[interior] += rng.uniform(
        -jitter / nx, jitter / nx, (interior.sum(), 3)
    )
    # Two materials: x > 0.5 is class 1, so walks stop at the interface.
    cid = (coords[tets].mean(axis=1)[:, 0] > 0.5).astype(np.int32)
    jm = JTetMesh.from_numpy(coords, tets, cid, dtype=_JDT[dtype])
    pm = mesh_from_jax_arrays(
        {f: np.asarray(getattr(jm, f)) for f in MESH_FIELDS}, "cpu"
    )
    return jm, pm


def _lanes(jm, dtype, initial, n=240, seed=3, vertex_aimed=False):
    """numpy inputs: random rays, some leaving the domain, some parked,
    some with an out-of-range group; in move mode also axis-aligned rays
    that graze faces and, with ``vertex_aimed``, rays that end on mesh
    vertices."""
    rng = np.random.default_rng(seed)
    nd = np.float32 if dtype == torch.float32 else np.float64
    if initial:
        elem = np.zeros(n, np.int32)
        origin = np.repeat(np.asarray(jm.centroids())[:1], n, axis=0)
        dest = rng.uniform(-0.05, 1.05, (n, 3))
    else:
        elem = rng.integers(0, jm.ntet, n).astype(np.int32)
        origin = np.asarray(jm.centroids())[elem]
        dest = rng.uniform(-0.1, 1.1, (n, 3))
        k = n // 6
        dest[:k, 1:] = origin[:k, 1:]  # pure-x rays
        if vertex_aimed:
            verts = np.asarray(jm.coords)
            dest[k:2 * k] = verts[rng.integers(0, verts.shape[0], k)]
    fly = rng.uniform(size=n) > 0.1
    w = rng.uniform(0.5, W_MAX, n)
    g = rng.integers(0, G, n).astype(np.int32)
    g[::17] = G  # out of range: walks, scores nothing
    mat = np.full(n, -1, np.int32)
    return dict(
        origin=origin.astype(nd), dest=dest.astype(nd), elem=elem, fly=fly,
        w=w.astype(nd), g=g, mat=mat,
    )


def _jax_args(jm, a):
    return (jm, jnp.asarray(a["origin"]), jnp.asarray(a["dest"]),
            jnp.asarray(a["elem"]), jnp.asarray(a["fly"]),
            jnp.asarray(a["w"]), jnp.asarray(a["g"]), jnp.asarray(a["mat"]))


def _torch_args(pm, a):
    t = torch.from_numpy
    return (pm, t(a["origin"]), t(a["dest"]), t(a["elem"]), t(a["fly"]),
            t(a["w"]), t(a["g"]), t(a["mat"]))


def _assert_match(ref, got, dtype):
    pos_tol, flux_rtol = TOL[dtype]
    for name in ("elem", "material_id", "done", "stats"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
            err_msg=name,
        )
    assert int(got.n_segments) == int(ref.n_segments)
    assert int(got.n_crossings) == int(ref.n_crossings)
    np.testing.assert_allclose(
        got.position.numpy(), np.asarray(ref.position), rtol=0, atol=pos_tol
    )
    np.testing.assert_allclose(
        got.track_length.numpy(), np.asarray(ref.track_length),
        rtol=0, atol=pos_tol,
    )
    np.testing.assert_allclose(
        got.flux.numpy(), np.asarray(ref.flux), rtol=flux_rtol,
        atol=pos_tol * W_MAX,
    )


@pytest.mark.parametrize("robust", [True, False], ids=["robust", "plain"])
@pytest.mark.parametrize("initial", [True, False], ids=["initial", "move"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_trace_matches_jax(dtype, initial, robust):
    jm, pm = _meshes(dtype)
    a = _lanes(jm, dtype, initial)
    kw = dict(initial=initial, max_crossings=jm.ntet + 8, n_groups=G,
              robust=robust, tolerance=1e-8)
    ref = jwalk.trace(
        *_jax_args(jm, a), jmake_flux(jm.ntet, G, _JDT[dtype], flat=True),
        unroll=1, compact_after=None, **kw,
    )
    flux = torch.zeros(jm.ntet * G * 2, dtype=dtype)
    got = twalk.trace(*_torch_args(pm, a), flux, **kw)
    assert got.flux is flux  # updated in place
    assert bool(got.done.all())
    st = got.stats.numpy()
    assert st[3] == 0 and st[6] == int(got.n_segments)
    if not initial:
        assert (got.material_id.numpy() == 1).any()  # material stops
        assert (got.material_id.numpy() == -1).any()  # reached or exited
        assert st[6] > 0
    _assert_match(ref, got, dtype)


@pytest.mark.parametrize("robust", [True, False], ids=["robust", "plain"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_vertex_aimed_rays(dtype, robust):
    """Rays that end exactly on mesh vertices. In float64 the port and JAX
    agree lane by lane. In float32, XLA:CPU's FMA contraction decides a
    few of these ties differently: the lane stops at the same point (within
    the float32 position tolerance) but is assigned to another of the
    elements sharing the vertex, and may score a rounding-sized sliver in
    another bin. Measured on this input: 7 of 240 lanes, all vertex-aimed.
    So in float32 the contract is the final positions and track lengths,
    per lane, and the total scored flux."""
    jm, pm = _meshes(dtype)
    a = _lanes(jm, dtype, initial=False, vertex_aimed=True)
    kw = dict(initial=False, max_crossings=jm.ntet + 8, n_groups=G,
              robust=robust, tolerance=1e-8)
    ref = jwalk.trace(
        *_jax_args(jm, a), jmake_flux(jm.ntet, G, _JDT[dtype], flat=True),
        unroll=1, compact_after=None, **kw,
    )
    got = twalk.trace(
        *_torch_args(pm, a), torch.zeros(jm.ntet * G * 2, dtype=dtype), **kw
    )
    if dtype == torch.float64:
        _assert_match(ref, got, dtype)
        return
    pos_tol, flux_rtol = TOL[dtype]
    differ = np.asarray(ref.elem) != got.elem.numpy()
    k = len(differ) // 6
    assert not differ[:k].any() and not differ[2 * k:].any()
    assert differ.sum() <= k // 4
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(ref.done))
    np.testing.assert_allclose(
        got.position.numpy(), np.asarray(ref.position), rtol=0, atol=pos_tol
    )
    np.testing.assert_allclose(
        got.track_length.numpy(), np.asarray(ref.track_length),
        rtol=0, atol=pos_tol,
    )
    np.testing.assert_allclose(
        got.flux.numpy().sum(dtype=np.float64),
        np.asarray(ref.flux).sum(dtype=np.float64), rtol=flux_rtol,
    )


def test_trace_matches_pallas_interpret():
    """Once against the TPU kernel itself, interpreted on the CPU."""
    dtype = torch.float32
    jm, pm = _meshes(dtype, nx=4)
    a = _lanes(jm, dtype, initial=False, n=64)
    kw = dict(initial=False, max_crossings=jm.ntet + 8, n_groups=G,
              tolerance=1e-8)
    ref = trace_pallas_impl(
        *_jax_args(jm, a), jmake_flux(jm.ntet, G, jnp.float32, flat=True),
        unroll=1, interpret=True, **kw,
    )
    got = twalk.trace(
        *_torch_args(pm, a), torch.zeros(jm.ntet * G * 2, dtype=dtype), **kw
    )
    _assert_match(ref, got, dtype)


def test_truncation_reported_per_lane():
    jm, pm = _meshes(torch.float64)
    a = _lanes(jm, torch.float64, initial=False)
    kw = dict(initial=False, max_crossings=2, n_groups=G)
    ref = jwalk.trace(
        *_jax_args(jm, a), jmake_flux(jm.ntet, G, jnp.float64, flat=True),
        unroll=1, compact_after=None, **kw,
    )
    got = twalk.trace(
        *_torch_args(pm, a), torch.zeros(jm.ntet * G * 2, dtype=torch.float64), **kw
    )
    assert int(got.stats[3]) > 0 and int(got.n_crossings) == 2
    _assert_match(ref, got, torch.float64)


def test_cpu_tensors_take_the_plain_walk():
    jm, pm = _meshes(torch.float64, nx=3)
    a = _lanes(jm, torch.float64, initial=False, n=50)
    kw = dict(initial=False, max_crossings=jm.ntet + 8, n_groups=G)
    before = walk_cuda.LAUNCHES
    x = walk_cuda.trace(
        *_torch_args(pm, a), torch.zeros(jm.ntet * G * 2, dtype=torch.float64), **kw
    )
    y = twalk.trace(
        *_torch_args(pm, a), torch.zeros(jm.ntet * G * 2, dtype=torch.float64), **kw
    )
    assert walk_cuda.LAUNCHES == before
    for name in ("position", "elem", "material_id", "done", "flux", "stats"):
        assert torch.equal(getattr(x, name), getattr(y, name)), name


def test_walk_rejects_bad_arguments():
    jm, pm = _meshes(torch.float64, nx=2)
    a = _lanes(jm, torch.float64, initial=False, n=8)
    args = list(_torch_args(pm, a))
    flux = torch.zeros(jm.ntet * G * 2, dtype=torch.float64)
    kw = dict(initial=False, max_crossings=10, n_groups=G)
    bad = list(args)
    bad[3] = bad[3].long()  # elem must be int32
    with pytest.raises(TypeError, match="elem"):
        twalk.trace(*bad, flux, **kw)
    with pytest.raises(ValueError, match="flux"):
        twalk.trace(*args, flux[:-2], **kw)


# --------------------------------------------------------------------- #
# The walk's primitives, one by one against their JAX counterparts
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_exit_face_matches_jax(dtype):
    rng = np.random.default_rng(7)
    nd = np.float32 if dtype == torch.float32 else np.float64
    n = 400
    normals = rng.normal(size=(n, 4, 3)).astype(nd)
    d = rng.normal(size=(n, 4)).astype(nd)
    cur = rng.normal(size=(n, 3)).astype(nd)
    dirv = rng.normal(size=(n, 3)).astype(nd)
    dirv[:20] = 0.0  # zero-length rays: no exit
    exclude = rng.uniform(size=(n, 4)) < 0.3
    exclude[20:40] = True  # everything masked: the stranded fallback
    for ex in (None, exclude):
        ref = jgeom.exit_face(
            jnp.asarray(normals), jnp.asarray(d), jnp.asarray(cur),
            jnp.asarray(dirv),
            exclude=None if ex is None else jnp.asarray(ex),
            return_num=True,
        )
        got = tgeom.exit_face(
            torch.from_numpy(normals), torch.from_numpy(d),
            torch.from_numpy(cur), torch.from_numpy(dirv),
            exclude=None if ex is None else torch.from_numpy(ex),
            return_num=True,
        )
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        rtol = 1e-12 if dtype == torch.float64 else 1e-4
        np.testing.assert_allclose(
            got[0].numpy(), np.asarray(ref[0]), rtol=rtol, atol=0
        )
        np.testing.assert_allclose(
            got[3].numpy(), np.asarray(ref[3]), rtol=rtol, atol=rtol
        )


@pytest.mark.parametrize("it", [0, 7, 123457, 2**31 - 1])
def test_chase_face_choice_matches_jax(it):
    """The hash wraps int32 in JAX; the port's int64 low bits agree."""
    rng = np.random.default_rng(it % 1000)
    n = 300
    sd = rng.normal(size=(n, 4))
    elem = rng.integers(0, 2**24, n).astype(np.int32)
    interior = rng.uniform(size=(n, 4)) < 0.7
    interior[:30] = False  # no interior face: all faces compete
    ref = jwalk.chase_face_choice(
        jnp.asarray(sd), jnp.asarray(elem), jnp.int32(np.int32(it)),
        jnp.float64, jnp.asarray(interior),
    )
    got = twalk.chase_face_choice(
        torch.from_numpy(sd), torch.from_numpy(elem), it, torch.float64,
        torch.from_numpy(interior),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_exp2i_and_escalated_bump_match_jax(dtype):
    k = np.arange(49, dtype=np.int32)
    ref = jwalk._exp2i(jnp.asarray(k), _JDT[dtype])
    got = twalk._exp2i(torch.from_numpy(k), dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    rng = np.random.default_rng(1)
    nd = np.float32 if dtype == torch.float32 else np.float64
    n = 200
    stuck = rng.integers(0, 49, n).astype(np.int32)
    contained = rng.uniform(size=n) < 0.5
    continuing = rng.uniform(size=n) < 0.7
    t_step = (rng.uniform(size=n) * 10.0 ** rng.integers(-9, 0, n)).astype(nd)
    cur = rng.uniform(-2, 2, (n, 3)).astype(nd)
    dnorm = rng.uniform(0, 1, n).astype(nd)
    dnorm[:10] = 0
    tol_eff = np.maximum(1e-8 / np.where(dnorm > 0, dnorm, 1), 1e-9).astype(nd)
    tol_floor = 8 * float(np.finfo(nd).eps)
    ref = jwalk.escalated_bump(
        jnp.asarray(stuck), jnp.asarray(contained), jnp.asarray(continuing),
        jnp.asarray(t_step), tol_floor, jnp.asarray(tol_eff),
        jnp.asarray(cur), jnp.asarray(dnorm), _JDT[dtype],
    )
    got = twalk.escalated_bump(
        torch.from_numpy(stuck), torch.from_numpy(contained),
        torch.from_numpy(continuing), torch.from_numpy(t_step), tol_floor,
        torch.from_numpy(tol_eff), torch.from_numpy(cur),
        torch.from_numpy(dnorm),
    )
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(
        got[0].numpy(), np.asarray(ref[0]), rtol=1e-6, atol=0
    )


def test_stats_vector_layout_matches_jax():
    from pumiumtally_tpu.obs.walk_stats import WALK_STATS_FIELDS as JF
    from pumiumtally_tpu_torch.obs.walk_stats import (
        WALK_STATS_FIELDS,
        stats_to_dict,
    )

    assert WALK_STATS_FIELDS == JF
    ncross = torch.tensor([3, 0, 5], dtype=torch.int32)
    nchase = torch.tensor([0, 1, 0], dtype=torch.int32)
    done = torch.tensor([True, False, True])
    got = twalk.walk_stats_vector(ncross, nchase, done, 7, 9)
    ref = jwalk.walk_stats_vector(
        jnp.asarray(ncross.numpy()), jnp.asarray(nchase.numpy()),
        jnp.asarray(done.numpy()), jnp.int64(0), jnp.int64(0),
        jnp.int64(7), jnp.int32(9),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    d = stats_to_dict(got.numpy())
    assert d["crossings"] == 8 and d["truncated"] == 1
    assert d["occupancy"] is None
    assert jax.config.jax_enable_x64  # the JAX side counts in int64
