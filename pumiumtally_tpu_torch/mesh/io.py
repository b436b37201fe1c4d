"""Mesh ingest: .npz snapshots (and ``save_npz`` to write them), ASCII Gmsh
.msh (v2.2 and v4.1) and Omega_h-layout .osh directories.

Counterpart of ``pumiumtally_tpu/mesh/io.py`` without the native C++
tokenizer: the pure-Python parsers are copied, and ``.osh`` goes through
the subset reader of ``mesh/osh.py``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .core import TetMesh
from .osh import read_osh


def save_npz(filename: str, coords, tet2vert, class_id) -> None:
    """Write a mesh snapshot (float64 coordinates, int64 connectivity,
    int32 class ids: the JAX package's layout) through the atomic writer
    of ``utils/checkpoint.py``, so a crash never leaves a torn ``.npz``
    under the real name. Arrays may be numpy arrays or tensors."""
    from ..utils.checkpoint import _host, atomic_savez

    atomic_savez(
        filename,
        coords=_host(coords).astype(np.float64),
        tet2vert=_host(tet2vert).astype(np.int64),
        class_id=_host(class_id).astype(np.int32),
    )


def load_npz_arrays(filename: str):
    with np.load(filename) as z:
        return z["coords"], z["tet2vert"], z["class_id"]


def parse_gmsh(filename: str):
    """Parse an ASCII Gmsh .msh file (v2.2 and v4.1), keeping only 4-node
    tetrahedra (element type 4). Returns (coords, tet2vert, class_id) with
    class_id from the first element tag (v2.2) or the entity tag (v4.1)."""
    with open(filename) as f:
        lines = f.read().split("\n")
    try:
        i = [ln.strip() for ln in lines].index("$MeshFormat") + 1
    except ValueError:
        raise ValueError(f"section $MeshFormat not found in {filename}")
    version = float(lines[i].split()[0])
    if version >= 4.0:
        return _parse_gmsh_v4(lines)
    return _parse_gmsh_v2(lines)


def _parse_gmsh_v2(lines):
    i = lines.index("$Nodes") + 1
    n_nodes = int(lines[i])
    i += 1
    node_ids = np.empty(n_nodes, np.int64)
    coords = np.empty((n_nodes, 3), np.float64)
    for k in range(n_nodes):
        parts = lines[i + k].split()
        node_ids[k] = int(parts[0])
        coords[k] = [float(parts[1]), float(parts[2]), float(parts[3])]
    i += n_nodes
    i = lines.index("$Elements", i) + 1
    n_elems = int(lines[i])
    i += 1
    tets, cids = [], []
    for k in range(n_elems):
        parts = lines[i + k].split()
        if int(parts[1]) != 4:  # linear tetrahedron
            continue
        ntags = int(parts[2])
        cids.append(int(parts[3]) if ntags > 0 else 0)
        tets.append([int(v) for v in parts[3 + ntags: 7 + ntags]])
    return _renumber(node_ids, coords, tets, cids)


def _parse_gmsh_v4(lines):
    i = lines.index("$Nodes") + 1
    num_blocks, n_nodes = (int(x) for x in lines[i].split()[:2])
    i += 1
    node_ids = np.empty(n_nodes, np.int64)
    coords = np.empty((n_nodes, 3), np.float64)
    k = 0
    for _ in range(num_blocks):
        _, _, _, n_in_block = (int(x) for x in lines[i].split())
        i += 1
        for b in range(n_in_block):
            node_ids[k + b] = int(lines[i + b])
        i += n_in_block
        for b in range(n_in_block):
            coords[k + b] = [float(x) for x in lines[i + b].split()[:3]]
        i += n_in_block
        k += n_in_block
    i = lines.index("$Elements", i) + 1
    num_blocks, _ = (int(x) for x in lines[i].split()[:2])
    i += 1
    tets, cids = [], []
    for _ in range(num_blocks):
        _, entity_tag, etype, n_in_block = (int(x) for x in lines[i].split())
        i += 1
        if etype == 4:
            for b in range(n_in_block):
                parts = lines[i + b].split()
                tets.append([int(v) for v in parts[1:5]])
                cids.append(entity_tag)
        i += n_in_block
    return _renumber(node_ids, coords, tets, cids)


def _renumber(node_ids, coords, tets, cids):
    if not tets:
        raise ValueError("no tetrahedra found in mesh file")
    remap = {int(nid): k for k, nid in enumerate(node_ids)}
    tet2vert = np.array(
        [[remap[v] for v in tet] for tet in tets], dtype=np.int64
    )
    return coords, tet2vert, np.asarray(cids, np.int32)


def load_mesh(
    filename: str, dtype: torch.dtype = torch.float32, device=None
) -> TetMesh:
    """Load a .npz, .msh or .osh mesh onto ``device`` (default: the CUDA
    card)."""
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".npz":
        coords, tet2vert, class_id = load_npz_arrays(filename)
    elif ext == ".msh":
        coords, tet2vert, class_id = parse_gmsh(filename)
    elif ext == ".osh":
        coords, tet2vert, class_id = read_osh(filename)
    else:
        raise ValueError(
            f"unsupported mesh format '{ext}' (.npz, .msh and .osh "
            "supported)"
        )
    return TetMesh.from_numpy(
        coords, tet2vert, class_id, dtype=dtype, device=device
    )
