"""The port's native host runtime (``pumiumtally_tpu_torch/native``,
``csrc/host/pumi_native.cpp``) against its numpy path and the JAX
package's.

Mirrors tests/test_native.py: the face-adjacency hash, the derived tables
(orientation, volumes, face normals and offsets) and the Gmsh tokenizer
(v2.2, v4.1, point and line elements skipped, non-manifold meshes
refused). The port's library is built without FMA contraction and sums in
numpy's order, so its tables are held BITWISE to the port's numpy path and
to the JAX package's numpy functions; the JAX package's own library is
built with ``-march=native`` (fused products where the host has FMA) and is
held to the JAX test's tolerances (atol 1e-15 volumes, 1e-14 planes),
integers exact. The dispatch of ``TetMesh.from_numpy``, ``build_tet2tet``
and ``parse_gmsh`` goes through the library (``native.CALLS``), and
``PUMI_TPU_NATIVE=0`` gives the same mesh bit for bit. Skips only where
g++ is missing, as the JAX test does.
"""
from __future__ import annotations

import textwrap
from unittest import mock

import numpy as np
import pytest
import torch

from pumiumtally_tpu import native as jax_native
from pumiumtally_tpu.mesh import core as jax_core
from pumiumtally_tpu.mesh import io as jax_io
from pumiumtally_tpu_torch import native
from pumiumtally_tpu_torch.mesh import box, core
from pumiumtally_tpu_torch.mesh import io as mesh_io

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain (g++) unavailable"
)

MSH_V2 = """\
    $MeshFormat
    2.2 0 8
    $EndMeshFormat
    $Nodes
    5
    1 0 0 0
    2 1 0 0
    3 0 1 0
    4 0 0 1
    7 1 1 1
    $EndNodes
    $Elements
    3
    1 2 2 5 1 1 2 3
    2 4 2 9 1 1 2 3 4
    3 4 2 11 2 2 3 4 7
    $EndElements
    """

MSH_POINTS = """\
    $MeshFormat
    2.2 0 8
    $EndMeshFormat
    $Nodes
    4
    1 0 0 0
    2 1 0 0
    3 0 1 0
    4 0 0 1
    $EndNodes
    $Elements
    3
    1 15 2 1 1 1
    2 1 2 3 1 1 2
    3 4 2 9 1 1 2 3 4
    $EndElements
    """

MSH_V41 = """\
    $MeshFormat
    4.1 0 8
    $EndMeshFormat
    $Nodes
    2 5 1 7
    3 1 0 3
    1
    2
    3
    0 0 0
    1 0 0
    0 1 0
    3 2 0 2
    4
    7
    0 0 1
    1 1 1
    $EndNodes
    $Elements
    3 3 1 3
    2 5 2 1
    1 1 2 3
    3 9 4 1
    2 1 2 3 4
    3 11 4 1
    3 2 3 4 7
    $EndElements
    """


def _box_arrays(nx, ny, nz, jitter=0.0):
    coords, tets = box.build_box_arrays(1.0, 1.2, 0.8, nx, ny, nz)
    coords = np.asarray(coords, np.float64)
    rng = np.random.default_rng(7)
    if jitter:
        coords = coords + rng.uniform(-jitter, jitter, coords.shape) / nx
    class_id = rng.integers(0, 3, tets.shape[0]).astype(np.int32)
    return coords, np.asarray(tets, np.int64), class_id


def _scrambled(tets):
    """Half the tets with their last two vertices swapped, so the
    orientation pass has work to do."""
    flip = np.random.default_rng(3).random(tets.shape[0]) < 0.5
    out = tets.copy()
    out[flip, 2], out[flip, 3] = tets[flip, 3], tets[flip, 2]
    return out


def _numpy_tables(coords, tets):
    t2v = core._canonicalize_orientation(coords, tets.copy())
    return (t2v, core._tet_volumes(coords, t2v),
            *core._face_planes(coords, t2v))


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(textwrap.dedent(text))
    return p


def test_tet2tet_matches_numpy():
    _, tets, _ = _box_arrays(5, 4, 3)
    got = native.build_tet2tet(tets)
    assert got is not None
    with mock.patch.object(native, "build_tet2tet", return_value=None):
        want = core.build_tet2tet(tets)
    _same_bits(got, want)
    _same_bits(got, jax_native.build_tet2tet(tets))
    with mock.patch.object(jax_native, "build_tet2tet", return_value=None):
        _same_bits(got, jax_core.build_tet2tet(tets))


@pytest.mark.parametrize("cells,jitter", [((4, 3, 5), 0.0), ((9, 8, 7), 0.25)],
                         ids=["box", "jittered"])
def test_derive_geometry_matches_numpy(cells, jitter):
    coords, tets, _ = _box_arrays(*cells, jitter=jitter)
    scrambled = _scrambled(tets)
    out = native.derive_geometry(coords, scrambled.copy())
    assert out is not None
    t2v, vol, nrm, d = out
    want = _numpy_tables(coords, scrambled)
    for got_a, want_a in zip((t2v, vol, nrm, d), want):
        _same_bits(got_a, want_a)
    # The JAX package's numpy functions: the same bits.
    jt2v = jax_core._canonicalize_orientation(coords, scrambled.copy())
    jn, jd = jax_core._face_planes(coords, jt2v)
    for got_a, want_a in zip(
        (t2v, vol, nrm, d),
        (jt2v, jax_core._tet_volumes(coords, jt2v), jn, jd),
    ):
        _same_bits(got_a, want_a)
    assert (vol > 0).all()
    # The JAX package's library (built with -march=native): the JAX
    # test's tolerances, integers exact.
    jt, jv, jnrm, jdd = jax_native.derive_geometry(coords, scrambled.copy())
    _same_bits(t2v, jt)
    np.testing.assert_allclose(vol, jv, rtol=0, atol=1e-15)
    np.testing.assert_allclose(nrm, jnrm, rtol=0, atol=1e-14)
    np.testing.assert_allclose(d, jdd, rtol=0, atol=1e-14)


@pytest.mark.parametrize("text,parser,cids", [
    (MSH_V2, "_parse_gmsh_v2", [9, 11]),
    (MSH_V41, "_parse_gmsh_v4", [9, 11]),
], ids=["v2.2", "v4.1"])
def test_gmsh_native_matches_python(tmp_path, text, parser, cids):
    p = _write(tmp_path, "two_tets.msh", text)
    got = native.parse_gmsh(str(p))
    assert got is not None, "the native tokenizer should read this file"
    ref = getattr(mesh_io, parser)(p.read_text().split("\n"))
    jax_ref = getattr(jax_io, parser)(p.read_text().split("\n"))
    jax_fast = jax_native.parse_gmsh(str(p))
    for g, r, jr, jf in zip(got, ref, jax_ref, jax_fast):
        _same_bits(g, np.asarray(r, g.dtype))
        _same_bits(g, np.asarray(jr, g.dtype))
        _same_bits(g, jf)
    assert list(got[2]) == cids


def test_gmsh_skips_point_elements(tmp_path):
    # Physical-point (type 15) and line (type 1) elements are skipped, not
    # fatal: they appear in most real Gmsh exports.
    p = _write(tmp_path, "with_points.msh", MSH_POINTS)
    got = native.parse_gmsh(str(p))
    assert got is not None
    coords, tets, cids = got
    assert tets.shape == (1, 4) and list(cids) == [9]
    assert coords.shape == (4, 3)


def test_nonmanifold_raises():
    # Three tets sharing one face: the native build and the numpy path
    # both refuse rather than emit a corrupt table.
    tets = np.array([[0, 1, 2, 3], [0, 1, 2, 4], [0, 1, 2, 5]], np.int64)
    with pytest.raises(ValueError, match="non-manifold"):
        native.build_tet2tet(tets)
    with mock.patch.object(native, "build_tet2tet", return_value=None):
        with pytest.raises(ValueError, match="non-manifold"):
            core.build_tet2tet(tets)


def test_gmsh_parse_dispatches_to_native(tmp_path):
    p = _write(tmp_path, "two_tets.msh", MSH_V41)
    before = native.CALLS["parse_gmsh"]
    got = mesh_io.parse_gmsh(str(p))
    assert native.CALLS["parse_gmsh"] == before + 1
    with mock.patch.object(native, "parse_gmsh", return_value=None):
        want = mesh_io.parse_gmsh(str(p))
    for g, w in zip(got, want):
        _same_bits(g, np.asarray(w, g.dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mesh_build_dispatches_and_matches_numpy(monkeypatch, dtype):
    """``TetMesh.from_numpy`` takes the library (both of its calls) and
    gives the mesh the numpy path gives, every table bitwise."""
    coords, tets, cid = _box_arrays(6, 5, 4, jitter=0.2)
    scrambled = _scrambled(tets)
    before = dict(native.CALLS)
    fast = core.TetMesh.from_numpy(coords, scrambled, cid, dtype=dtype,
                                   device="cpu")
    assert native.CALLS["derive_geometry"] == before["derive_geometry"] + 1
    assert native.CALLS["build_tet2tet"] == before["build_tet2tet"] + 1
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PUMI_TPU_NATIVE", "0")
    assert native.load() is None
    slow = core.TetMesh.from_numpy(coords, scrambled, cid, dtype=dtype,
                                   device="cpu")
    assert native.CALLS["derive_geometry"] == before["derive_geometry"] + 1
    for field in ("coords", "tet2vert", "tet2tet", "class_id",
                  "face_normals", "face_d", "volumes", "geo20",
                  "class_values"):
        a, b = getattr(fast, field), getattr(slow, field)
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.uint8) if a.is_floating_point() else a,
            b.view(torch.uint8) if b.is_floating_point() else b), field


def test_library_path_tracks_source_and_flags():
    p = native.library_path()
    assert p.startswith(native.BUILD_DIR) and "libpumi_native-" in p
    assert "-ffp-contract=off" in native.GXX_FLAGS
    assert not any(f.startswith("-march") for f in native.GXX_FLAGS)
