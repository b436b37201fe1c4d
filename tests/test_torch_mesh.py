"""Mesh tables of the PyTorch port against the JAX package.

The same numpy inputs go to ``pumiumtally_tpu.mesh.core.TetMesh.from_numpy``
and to ``pumiumtally_tpu_torch.mesh.core.TetMesh.from_numpy(device="cpu")``.
Integer tables and the geo20 topology-code bits must be equal. The float
tables must be bit-equal to the JAX package's numpy helpers (the port
copies their maths), and within 1e-14 of the JAX TetMesh, which derives
its geometry through a native C++ library that agrees with numpy only to
that bound.
"""
from __future__ import annotations

import textwrap
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumiumtally_tpu import native
from pumiumtally_tpu.mesh import core as jcore
from pumiumtally_tpu.mesh.box import build_box_arrays
from pumiumtally_tpu.mesh.io import parse_gmsh as jparse_gmsh
from pumiumtally_tpu_torch import build_box, load_mesh
from pumiumtally_tpu_torch.mesh import io as tio
from pumiumtally_tpu_torch.mesh.core import TetMesh

_JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}
_NDT = {torch.float32: np.float32, torch.float64: np.float64}
_IDT = {torch.float32: np.int32, torch.float64: np.int64}


def _box(nx):
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, nx, nx, nx)
    return coords, tets, None


def _jittered(nx, jitter=0.25, seed=11):
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, nx, nx, nx)
    rng = np.random.default_rng(seed)
    interior = (coords > 1e-9).all(axis=1) & (coords < 1 - 1e-9).all(axis=1)
    coords = coords.copy()
    coords[interior] += rng.uniform(
        -jitter / nx, jitter / nx, (interior.sum(), 3)
    )
    cid = (coords[tets].mean(axis=1)[:, 0] > 0.5).astype(np.int32)
    return coords, tets, cid


def _two_class():
    coords, tets = build_box_arrays(2.0, 1.0, 1.0, 4, 2, 2)
    cid = np.where(coords[tets].mean(axis=1)[:, 0] > 1.0, 7, 3)
    return coords, tets, cid.astype(np.int32)


CASES = {
    "box3": lambda: _box(3),
    "box4": lambda: _box(4),
    "jittered6": lambda: _jittered(6),
    "two_class": _two_class,
}


def _numpy_reference(coords, tets):
    """The JAX package's numpy-path tables (native library bypassed)."""
    coords = np.asarray(coords, np.float64)
    t2v = jcore._canonicalize_orientation(coords, np.asarray(tets, np.int64))
    with mock.patch.object(native, "build_tet2tet", return_value=None):
        t2t = jcore.build_tet2tet(t2v)
    normals, d = jcore._face_planes(coords, t2v)
    return t2v, t2t, normals, d, jcore._tet_volumes(coords, t2v)


def _codes(geo20: np.ndarray, dtype) -> np.ndarray:
    return np.ascontiguousarray(geo20[:, 16:20]).view(_IDT[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tables_match_jax(case, dtype):
    coords, tets, cid = CASES[case]()
    jm = jcore.TetMesh.from_numpy(coords, tets, cid, dtype=_JDT[dtype])
    pm = TetMesh.from_numpy(coords, tets, cid, dtype=dtype, device="cpu")
    assert pm.device == torch.device("cpu") and pm.dtype == dtype
    for name in ("tet2vert", "tet2tet", "class_id", "class_values"):
        got = getattr(pm, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(jm, name)), err_msg=name
        )
    np.testing.assert_array_equal(
        _codes(pm.geo20.numpy(), dtype), _codes(np.asarray(jm.geo20), dtype)
    )

    t2v, t2t, normals, d, volumes = _numpy_reference(coords, tets)
    np.testing.assert_array_equal(pm.tet2vert.numpy(), t2v)
    np.testing.assert_array_equal(pm.tet2tet.numpy(), t2t)
    nd = _NDT[dtype]
    # Bit-equal to the copied numpy maths, cast once to the mesh dtype.
    for name, ref in (
        ("face_normals", normals), ("face_d", d), ("volumes", volumes),
    ):
        np.testing.assert_array_equal(
            getattr(pm, name).numpy(), ref.astype(nd), err_msg=name
        )
    geo = pm.geo20.numpy()
    np.testing.assert_array_equal(geo[:, :12], normals.reshape(-1, 12).astype(nd))
    np.testing.assert_array_equal(geo[:, 12:16], d.astype(nd))
    # Within 1e-14 of the JAX TetMesh (native geometry); in float32 a
    # 1e-14 difference before the cast may round to the neighbouring
    # float, one ulp of a unit-scale value.
    atol = 1e-14 if dtype == torch.float64 else 1e-14 + 2.0**-23
    for name in ("face_normals", "face_d", "volumes", "coords"):
        np.testing.assert_allclose(
            getattr(pm, name).numpy(), np.asarray(getattr(jm, name)),
            rtol=0, atol=atol, err_msg=name,
        )


def test_geo20_codes_survive_as_float_bits():
    """The code columns hold int bits (some are NaN/inf patterns); the
    table must carry them through placement unchanged."""
    coords, tets, cid = _two_class()
    pm = TetMesh.from_numpy(coords, tets, cid, dtype=torch.float32, device="cpu")
    codes = pm.geo20[:, 16:20].contiguous().view(torch.int32)
    t2t = pm.tet2tet
    np.testing.assert_array_equal(
        ((codes & 0xFFFFFF) - 1).numpy(), t2t.numpy()
    )
    stop = ((codes >> 30) & 1).numpy()
    cls = pm.class_values[((codes >> 24) & 0x3F).long()].numpy()
    nbr_cls = np.where(
        t2t.numpy() >= 0, pm.class_id.numpy()[np.maximum(t2t.numpy(), 0)],
        pm.class_id.numpy()[:, None],
    )
    interior = t2t.numpy() >= 0
    np.testing.assert_array_equal(cls[interior], nbr_cls[interior])
    np.testing.assert_array_equal(
        stop, (t2t.numpy() >= 0) & (nbr_cls != pm.class_id.numpy()[:, None])
    )


def test_tangled_mesh_rejected_at_build():
    coords, tets, cid = _jittered(6, jitter=0.35, seed=11)
    with pytest.raises(ValueError, match="tangled"):
        TetMesh.from_numpy(coords, tets, cid, dtype=torch.float64, device="cpu")


def test_nonmanifold_mesh_rejected():
    tets = np.array([[0, 1, 2, 3], [0, 1, 2, 4], [0, 1, 2, 5]])
    coords = np.array([
        [0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, -1], [1, 1, 1],
    ], dtype=np.float64)
    with pytest.raises(ValueError, match="non-manifold"):
        TetMesh.from_numpy(coords, tets, device="cpu")


def test_box_oracle_numbering_and_centroid():
    m = build_box(dtype=torch.float64, device="cpu")
    assert m.ntet == 6 and m.nverts == 8
    np.testing.assert_allclose(m.centroids()[0].numpy(), [0.5, 0.75, 0.25])
    np.testing.assert_allclose(m.volumes.numpy(), 1.0 / 6.0, atol=1e-15)
    assert int((m.tet2tet == -1).sum()) == 12


_MSH_V2 = """\
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

_MSH_V41 = """\
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
2 1 2 1
1 1 2 3
3 9 4 1
2 1 2 3 4
3 11 4 1
3 2 3 4 7
$EndElements
"""


@pytest.mark.parametrize("text", [_MSH_V2, _MSH_V41], ids=["v2.2", "v4.1"])
def test_gmsh_parse_matches_jax(tmp_path, text):
    p = tmp_path / "two_tets.msh"
    p.write_text(textwrap.dedent(text))
    got = tio.parse_gmsh(str(p))
    ref = jparse_gmsh(str(p))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    m = load_mesh(str(p), dtype=torch.float64, device="cpu")
    assert m.ntet == 2
    np.testing.assert_array_equal(m.class_id.numpy(), [9, 11])


def test_npz_load_and_osh_refused(tmp_path):
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, 2, 2, 2)
    p = tmp_path / "box.npz"
    np.savez(p, coords=coords, tet2vert=tets,
             class_id=np.zeros(len(tets), np.int32))
    m = load_mesh(str(p), device="cpu")
    assert m.ntet == 48 and m.dtype == torch.float32
    # An .osh directory whose stream is not the subset format (genuine
    # Omega_h bytes) is refused, naming the offline converter.
    foreign = tmp_path / "mesh.osh"
    foreign.mkdir()
    (foreign / "nparts").write_text("1\n")
    (foreign / "0.osh").write_bytes(b"\x00mega_h!" + b"\x00" * 64)
    with pytest.raises(NotImplementedError, match="osh2npz"):
        load_mesh(str(foreign), device="cpu")
