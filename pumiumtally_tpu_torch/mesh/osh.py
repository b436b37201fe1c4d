"""Omega_h ``.osh`` mesh directories: the subset reader and writer.

Counterpart of ``pumiumtally_tpu/mesh/osh.py``, byte for byte the same
format, so a directory written by either package reads back in the
other. The reference reads its meshes with ``Omega_h::binary::read`` of
a binary ``.osh`` directory. This module implements that directory
layout (a text ``nparts`` file and one ``<rank>.osh`` binary stream per
part) with a versioned stream encoding that carries exactly what the
tally consumes: vertex coordinates, tet→vertex connectivity and the
``class_id`` region tag. Streams written by Omega_h itself (version- and
compression-dependent) are detected by their magic and refused with a
pointer to the offline converter ``native/osh2npz.cpp``, which links
against Omega_h and dumps any genuine ``.osh`` to the ``.npz`` layout
``mesh/io.py`` loads.

Stream encoding of one ``<rank>.osh`` part file (all little-endian):

    bytes 0..7   magic  b"PUMIOSH1"
    i32          dim            (must be 3)
    i64          nverts
    i64          ntets
    f64[nverts,3]  coords
    i32[ntets,4]   tet2vert   (part-local vertex ids)
    i32[ntets]     class_id
"""
from __future__ import annotations

import os
import struct

import numpy as np

MAGIC = b"PUMIOSH1"


def write_osh(path: str, coords, tet2vert, class_id) -> str:
    """Write a single-part .osh-subset directory. Returns the path."""
    coords = np.ascontiguousarray(coords, np.float64)
    tet2vert = np.ascontiguousarray(tet2vert, np.int32)
    class_id = np.ascontiguousarray(class_id, np.int32)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "nparts"), "w") as f:
        f.write("1\n")
    with open(os.path.join(path, "0.osh"), "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<i", 3))
        f.write(struct.pack("<q", coords.shape[0]))
        f.write(struct.pack("<q", tet2vert.shape[0]))
        f.write(coords.astype("<f8").tobytes())
        f.write(tet2vert.astype("<i4").tobytes())
        f.write(class_id.astype("<i4").tobytes())
    return path


def read_osh(path: str):
    """Read a .osh-subset directory -> (coords, tet2vert, class_id).

    Multi-part directories are concatenated with per-part vertex-id
    offsets (each part is a self-contained local numbering, so the
    concatenation is a valid global mesh only when parts share no
    vertices; the single-part case, all the reference writes, is
    exact).
    """
    nparts_file = os.path.join(path, "nparts")
    if not os.path.isfile(nparts_file):
        raise FileNotFoundError(
            f"{path!r} is not an .osh directory (missing 'nparts')"
        )
    with open(nparts_file) as f:
        nparts = int(f.read().strip())
    all_coords, all_tets, all_cids = [], [], []
    vert_off = 0
    for rank in range(nparts):
        part = os.path.join(path, f"{rank}.osh")
        with open(part, "rb") as f:
            magic = f.read(8)
            if magic != MAGIC:
                raise NotImplementedError(
                    f"{part!r} is not a PUMIOSH1 subset stream "
                    "(full-fidelity Omega_h streams are version- and "
                    "compression-dependent); convert it once with the "
                    "offline tool native/osh2npz.cpp in your Omega_h "
                    "environment, then load the resulting .npz"
                )
            (dim,) = struct.unpack("<i", f.read(4))
            if dim != 3:
                raise ValueError(f"{part!r}: only 3-D meshes (got dim={dim})")
            (nverts,) = struct.unpack("<q", f.read(8))
            (ntets,) = struct.unpack("<q", f.read(8))
            coords = np.frombuffer(
                f.read(nverts * 3 * 8), "<f8"
            ).reshape(nverts, 3)
            tets = np.frombuffer(
                f.read(ntets * 4 * 4), "<i4"
            ).reshape(ntets, 4)
            cids = np.frombuffer(f.read(ntets * 4), "<i4")
        all_coords.append(coords)
        all_tets.append(tets.astype(np.int64) + vert_off)
        all_cids.append(cids)
        vert_off += nverts
    return (
        np.concatenate(all_coords),
        np.concatenate(all_tets),
        np.concatenate(all_cids).astype(np.int32),
    )
