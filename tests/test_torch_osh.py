"""The port's ``.osh`` mesh directories (``mesh/osh.py`` and the ``.osh``
branch of ``mesh/io.py::load_mesh``) on ``device="cpu"``.

Mirrors all five tests of tests/test_osh.py (the converter test builds
``native/osh2npz.cpp`` against the Omega_h stub and loads its ``.npz``
through the port's loader), plus the cross-package case: a directory
written by either package reads back bitwise in the other. Arrays are
compared bitwise.
"""
from __future__ import annotations

import os
import shutil
import struct
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumiumtally_tpu.mesh import osh as josh
from pumiumtally_tpu.mesh.box import build_box_arrays
from pumiumtally_tpu.mesh.io import load_mesh as jload_mesh
from pumiumtally_tpu_torch.mesh.core import TetMesh
from pumiumtally_tpu_torch.mesh.io import load_mesh
from pumiumtally_tpu_torch.mesh.osh import MAGIC, read_osh, write_osh


def test_osh_roundtrip(tmp_path):
    coords, tets = build_box_arrays(1.0, 2.0, 3.0, 3, 2, 4)
    cid = (np.arange(tets.shape[0]) % 5).astype(np.int32)
    path = str(tmp_path / "mesh.osh")
    write_osh(path, coords, tets, cid)
    assert os.path.isfile(os.path.join(path, "nparts"))
    assert os.path.isfile(os.path.join(path, "0.osh"))
    rc, rt, rcid = read_osh(path)
    np.testing.assert_array_equal(rc, coords)
    np.testing.assert_array_equal(rt, tets)
    np.testing.assert_array_equal(rcid, cid)

    mesh = load_mesh(path, dtype=torch.float64, device="cpu")
    assert mesh.ntet == tets.shape[0]
    direct = TetMesh.from_numpy(coords, tets, cid, dtype=torch.float64,
                                device="cpu")
    for field in ("tet2tet", "class_id", "volumes", "geo20"):
        assert torch.equal(getattr(mesh, field), getattr(direct, field))
    jmesh = jload_mesh(path, dtype=jnp.float64)
    np.testing.assert_array_equal(mesh.tet2tet.numpy(),
                                  np.asarray(jmesh.tet2tet))
    np.testing.assert_array_equal(mesh.class_id.numpy(),
                                  np.asarray(jmesh.class_id))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_osh_written_by_either_package_reads_in_the_other(tmp_path,
                                                          writer):
    rng = np.random.default_rng(4)
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, 3, 3, 2)
    coords = coords + rng.uniform(-1e-3, 1e-3, coords.shape)
    cid = rng.integers(0, 9, tets.shape[0]).astype(np.int32)
    path = str(tmp_path / f"{writer}.osh")
    (josh.write_osh if writer == "jax" else write_osh)(path, coords, tets,
                                                       cid)
    reader = read_osh if writer == "jax" else josh.read_osh
    got = reader(path)
    for a, b in zip(got, (coords, tets, cid)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, (josh.read_osh if writer == "jax" else read_osh)(
            path)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    other = str(tmp_path / "other.osh")
    (write_osh if writer == "jax" else josh.write_osh)(other, *got)
    for name in ("nparts", "0.osh"):
        with open(os.path.join(path, name), "rb") as f, \
                open(os.path.join(other, name), "rb") as g:
            assert f.read() == g.read()
    assert MAGIC == josh.MAGIC


def test_osh_foreign_stream_rejected(tmp_path):
    path = tmp_path / "foreign.osh"
    path.mkdir()
    (path / "nparts").write_text("1\n")
    (path / "0.osh").write_bytes(b"\x00mega_h!" + b"\x00" * 64)
    with pytest.raises(NotImplementedError, match="osh2npz"):
        read_osh(str(path))


def test_osh_missing_nparts(tmp_path):
    d = tmp_path / "empty.osh"
    d.mkdir()
    with pytest.raises(FileNotFoundError, match="nparts"):
        read_osh(str(d))


def test_osh2npz_emitter_roundtrip(tmp_path):
    """Build native/osh2npz.cpp against the minimal Omega_h stub in
    tests/osh2npz_stub and load the .npz it emits through the port's
    loader, bit for bit."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ in environment")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    exe = str(tmp_path / "osh2npz")
    r = subprocess.run(
        [gxx, "-std=c++17", "-O1",
         "-I", os.path.join(root, "tests", "osh2npz_stub"),
         os.path.join(root, "native", "osh2npz.cpp"), "-o", exe],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    out = str(tmp_path / "out.npz")
    r = subprocess.run([exe, "fake.osh", out], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    mesh = load_mesh(out, dtype=torch.float64, device="cpu")
    assert mesh.ntet == 2
    np.testing.assert_array_equal(mesh.tet2vert.numpy(),
                                  [[0, 1, 2, 3], [1, 2, 3, 4]])
    np.testing.assert_array_equal(mesh.class_id.numpy(), [7, 9])
    np.testing.assert_array_equal(mesh.coords.numpy()[1], [1.0, 0.0, 0.0])


def test_osh_multipart_concatenates(tmp_path):
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, 2, 2, 2)
    cid = np.arange(tets.shape[0], dtype=np.int32) % 3
    path = str(tmp_path / "two.osh")
    write_osh(path, coords, tets, cid)
    coords2 = coords + 10.0
    with open(os.path.join(path, "1.osh"), "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<i", 3))
        f.write(struct.pack("<q", coords2.shape[0]))
        f.write(struct.pack("<q", tets.shape[0]))
        f.write(coords2.astype("<f8").tobytes())
        f.write(tets.astype("<i4").tobytes())
        f.write((cid + 100).astype("<i4").tobytes())
    with open(os.path.join(path, "nparts"), "w") as f:
        f.write("2\n")
    rc, rt, rcid = read_osh(path)
    nv, nt = coords.shape[0], tets.shape[0]
    assert rc.shape == (2 * nv, 3) and rt.shape == (2 * nt, 4)
    np.testing.assert_array_equal(rc[nv:], coords2)
    np.testing.assert_array_equal(rt[nt:], tets + nv)
    np.testing.assert_array_equal(rcid[nt:], cid + 100)
    for a, b in zip((rc, rt, rcid), josh.read_osh(path)):
        assert a.tobytes() == b.tobytes()
