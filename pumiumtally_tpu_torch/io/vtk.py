"""VTK output for tet meshes with cell data.

Counterpart of ``pumiumtally_tpu/io/vtk.py``, copied (pure numpy): XML
UnstructuredGrid (.vtu), its parallel index (.pvtu) and legacy ASCII
.vtk.
The bytes written equal the JAX package's for the same arrays. Mesh
tensors are brought to the host as numpy before writing.
"""
from __future__ import annotations

import base64
import os
import struct

import numpy as np

_VTK_TETRA = 10


def _b64(arr: np.ndarray) -> str:
    raw = arr.tobytes()
    header = struct.pack("<I", len(raw))
    return base64.b64encode(header + raw).decode("ascii")


def _data_array(name: str, arr: np.ndarray, n_components: int = 1) -> str:
    if arr.dtype == np.float64:
        vtype = "Float64"
    elif arr.dtype == np.float32:
        vtype = "Float32"
    elif arr.dtype == np.int64:
        vtype = "Int64"
    elif arr.dtype == np.int32:
        vtype = "Int32"
    elif arr.dtype == np.uint8:
        vtype = "UInt8"
    else:
        arr = arr.astype(np.float64)
        vtype = "Float64"
    comp = f' NumberOfComponents="{n_components}"' if n_components != 1 else ""
    return (
        f'<DataArray type="{vtype}" Name="{name}"{comp} format="binary">\n'
        f"{_b64(np.ascontiguousarray(arr))}\n</DataArray>\n"
    )


def write_vtu(
    filename: str,
    coords: np.ndarray,
    tet2vert: np.ndarray,
    cell_data: dict[str, np.ndarray] | None = None,
) -> None:
    """Write one UnstructuredGrid piece with per-cell scalar fields."""
    coords = np.asarray(coords, dtype=np.float64)
    tet2vert = np.asarray(tet2vert, dtype=np.int64)
    ncell, nvert = tet2vert.shape[0], coords.shape[0]
    cell_data = cell_data or {}

    parts = [
        '<?xml version="1.0"?>\n'
        '<VTKFile type="UnstructuredGrid" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt32">\n'
        "<UnstructuredGrid>\n"
        f'<Piece NumberOfPoints="{nvert}" NumberOfCells="{ncell}">\n'
    ]
    parts.append("<Points>\n")
    parts.append(_data_array("Points", coords, n_components=3))
    parts.append("</Points>\n<Cells>\n")
    parts.append(_data_array("connectivity", tet2vert.ravel()))
    parts.append(
        _data_array("offsets", (np.arange(ncell, dtype=np.int64) + 1) * 4)
    )
    parts.append(
        _data_array("types", np.full(ncell, _VTK_TETRA, dtype=np.uint8))
    )
    parts.append("</Cells>\n<CellData>\n")
    for name, arr in cell_data.items():
        parts.append(_data_array(name, np.asarray(arr)))
    parts.append("</CellData>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")

    with open(filename, "w") as f:
        f.write("".join(parts))


def write_pvtu(
    filename: str,
    piece_files: list[str],
    cell_data_names: list[str],
    float_type: str = "Float64",
) -> None:
    """Write the parallel index referencing per-process .vtu pieces by
    their base names."""
    parts = [
        '<?xml version="1.0"?>\n'
        '<VTKFile type="PUnstructuredGrid" version="1.0" '
        'byte_order="LittleEndian">\n'
        '<PUnstructuredGrid GhostLevel="0">\n'
        "<PPoints>\n"
        f'<PDataArray type="{float_type}" Name="Points" '
        'NumberOfComponents="3"/>\n'
        "</PPoints>\n<PCellData>\n"
    ]
    for name in cell_data_names:
        parts.append(f'<PDataArray type="{float_type}" Name="{name}"/>\n')
    parts.append("</PCellData>\n")
    for piece in piece_files:
        parts.append(f'<Piece Source="{os.path.basename(piece)}"/>\n')
    parts.append("</PUnstructuredGrid>\n</VTKFile>\n")
    with open(filename, "w") as f:
        f.write("".join(parts))


def write_legacy_vtk(
    filename: str,
    coords: np.ndarray,
    tet2vert: np.ndarray,
    cell_data: dict[str, np.ndarray] | None = None,
) -> None:
    """Write legacy ASCII VTK ('# vtk DataFile') — the format VTK readers
    select for a .vtk extension."""
    coords = np.asarray(coords, dtype=np.float64)
    tet2vert = np.asarray(tet2vert, dtype=np.int64)
    ncell = tet2vert.shape[0]
    cell_data = cell_data or {}
    with open(filename, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("pumiumtally_tpu flux tally\nASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {coords.shape[0]} double\n")
        np.savetxt(f, coords, fmt="%.17g")
        f.write(f"CELLS {ncell} {ncell * 5}\n")
        cells = np.column_stack(
            [np.full(ncell, 4, dtype=np.int64), tet2vert]
        )
        np.savetxt(f, cells, fmt="%d")
        f.write(f"CELL_TYPES {ncell}\n")
        np.savetxt(f, np.full(ncell, _VTK_TETRA, dtype=np.int64), fmt="%d")
        if cell_data:
            f.write(f"CELL_DATA {ncell}\n")
            for name, arr in cell_data.items():
                f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                np.savetxt(f, np.asarray(arr, dtype=np.float64), fmt="%.17g")


def write_flux_vtk(
    filename: str,
    mesh,
    normalized_flux: np.ndarray,
    volumes: np.ndarray | None = None,
    rel_err: np.ndarray | None = None,
) -> None:
    """Write the finalized tally in the reference's output layout: one
    'flux_group_<g>' cell field per energy group plus a 'volume' field
    (finalizeAndWritePumiFlux, cpp:685-705). The format follows the
    extension: .vtu → XML UnstructuredGrid, .vtk → legacy ASCII.

    ``rel_err`` (the [ntet, n_groups] per-bin relative error from the
    convergence accumulators — ``tally.relative_error()``) additionally
    writes one 'rel_err_group_<g>' cell field next to each flux group,
    so the uncertainty map rides the same file as the answer it
    qualifies."""
    normalized_flux = np.asarray(normalized_flux)
    cell_data: dict[str, np.ndarray] = {}
    for g in range(normalized_flux.shape[1]):
        cell_data[f"flux_group_{g}"] = normalized_flux[:, g, 0]
    if rel_err is not None:
        rel_err = np.asarray(rel_err)
        if rel_err.shape != normalized_flux.shape[:2]:
            raise ValueError(
                f"rel_err must be [ntet, n_groups] = "
                f"{normalized_flux.shape[:2]}, got {rel_err.shape}"
            )
        for g in range(rel_err.shape[1]):
            cell_data[f"rel_err_group_{g}"] = rel_err[:, g]
    cell_data["volume"] = (
        np.asarray(volumes)
        if volumes is not None
        else mesh.volumes.cpu().numpy()
    )
    if not filename.endswith((".vtu", ".vtk")):
        filename += ".vtu"
    writer = write_legacy_vtk if filename.endswith(".vtk") else write_vtu
    writer(
        filename,
        mesh.coords.cpu().numpy().astype(np.float64),
        mesh.tet2vert.cpu().numpy().astype(np.int64),
        cell_data,
    )
