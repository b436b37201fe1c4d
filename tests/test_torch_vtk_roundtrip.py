"""VTU output round trip on the port (``io/vtk.py::write_vtu`` and the
facade's ``write_pumi_tally_mesh``), on ``device="cpu"``.

Mirrors test_vtk_roundtrip: parse the base64 XML the port writes and
check that coordinates, connectivity and per-cell fields come back bit
for bit; and the facade's file carries the same bytes as the JAX
facade's for the same tally.
"""
from __future__ import annotations

import base64
import re
import struct

import numpy as np
import torch

from pumiumtally_tpu_torch import build_box
from pumiumtally_tpu_torch.io.vtk import write_vtu
from torch_twins import move_both, twin_meshes, twin_tallies

_TYPES = {
    "Float64": np.float64, "Float32": np.float32, "Int64": np.int64,
    "Int32": np.int32, "UInt8": np.uint8,
}


def _parse_data_arrays(text):
    out = {}
    for m in re.finditer(
        r'<DataArray type="(\w+)" Name="([^"]+)"[^>]*format="binary">\s*'
        r"([A-Za-z0-9+/=\s]+?)\s*</DataArray>",
        text,
    ):
        vtype, name, payload = m.groups()
        raw = base64.b64decode("".join(payload.split()))
        (nbytes,) = struct.unpack("<I", raw[:4])
        out[name] = np.frombuffer(raw[4:4 + nbytes], dtype=_TYPES[vtype])
    return out


def test_vtu_round_trip(tmp_path):
    mesh = build_box(1.0, 2.0, 0.5, 2, 3, 1, device="cpu")
    coords = mesh.coords.numpy().astype(np.float64)
    tets = mesh.tet2vert.numpy().astype(np.int64)
    rng = np.random.default_rng(0)
    fields = {
        "flux_group_0": rng.random(mesh.ntet),
        "volume": mesh.volumes.numpy().astype(np.float64),
    }
    path = str(tmp_path / "mesh.vtu")
    write_vtu(path, coords, tets, fields)
    text = open(path).read()

    arrays = _parse_data_arrays(text)
    np.testing.assert_array_equal(arrays["Points"].reshape(-1, 3), coords)
    np.testing.assert_array_equal(arrays["connectivity"].reshape(-1, 4),
                                  tets)
    np.testing.assert_array_equal(arrays["offsets"],
                                  (np.arange(mesh.ntet) + 1) * 4)
    assert (arrays["types"] == 10).all()  # VTK_TETRA
    np.testing.assert_array_equal(arrays["flux_group_0"],
                                  fields["flux_group_0"])
    np.testing.assert_array_equal(arrays["volume"], fields["volume"])
    m = re.search(r'NumberOfPoints="(\d+)" NumberOfCells="(\d+)"', text)
    assert (int(m.group(1)), int(m.group(2))) == (mesh.nverts, mesh.ntet)


def test_facade_vtu_matches_jax(tmp_path):
    """The same two moves in both packages (float64): the written files
    hold the same arrays, the flux fields within the walk tolerance."""
    jt, pt = twin_tallies(twin_meshes(torch.float64, nx=3), 32,
                          tolerance=1e-8)
    rng = np.random.default_rng(5)
    pos = rng.uniform(0.1, 0.9, (32, 3)).ravel()
    for t in (jt, pt):
        t.initialize_particle_location(pos.copy())
    for _ in range(2):
        move_both((jt, pt), (rng.uniform(0.05, 0.95, (32, 3)).ravel(),
                             np.ones(32, np.int8), rng.uniform(0.5, 2, 32),
                             rng.integers(0, 2, 32).astype(np.int32),
                             np.full(32, -1, np.int32)))
    ours = _parse_data_arrays(open(pt.write_pumi_tally_mesh(
        str(tmp_path / "p.vtu"))).read())
    theirs = _parse_data_arrays(open(jt.write_pumi_tally_mesh(
        str(tmp_path / "j.vtu"))).read())
    assert set(ours) == set(theirs)
    for name in ("Points", "connectivity", "offsets", "types", "volume"):
        np.testing.assert_array_equal(ours[name], theirs[name])
    for name in ours:
        if name.startswith("flux_group_"):
            np.testing.assert_allclose(ours[name], theirs[name],
                                       rtol=1e-10, atol=1e-12)
