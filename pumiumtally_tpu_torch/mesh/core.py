"""Tetrahedral mesh as a dataclass of torch tensors.

Counterpart of ``pumiumtally_tpu/mesh/core.py``. The derived tables are
built on the host in float64, by the native host runtime
(``native/__init__.py``) where it builds and by numpy otherwise (the same
maths as the JAX package's numpy path, copied here so the port imports
nothing of it; the two give the same bits), then placed on the requested
device in the requested dtype.

Face ``f`` of a tet is the face opposite local vertex ``f``. A point x is
outside face f of tet e when ``dot(n[e, f], x) > d[e, f]``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import native
from ..utils.platform import resolve_device

# Local vertex triples of the face opposite each local vertex.
FACE_LOCAL_VERTS = np.array(
    [[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=np.int64
)

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def can_pack_walk_tables(ntet: int, nclasses: int, itemsize: int) -> bool:
    """Whether the merged geo20 walk table can encode this mesh: neighbor
    ids + 1 must fit 24 bits, class indices 6 bits, and the float dtype
    must be 4 or 8 bytes wide for the int-bits view."""
    return ntet < (1 << 24) and nclasses <= 64 and itemsize in (4, 8)


@dataclasses.dataclass(frozen=True)
class TetMesh:
    """Unstructured tetrahedral mesh on one torch device.

    Attributes:
      coords: [nverts, 3] vertex coordinates (mesh dtype).
      tet2vert: [ntet, 4] int32 element→vertex connectivity (positively
        oriented).
      tet2tet: [ntet, 4] int32 neighbor across face f (-1 = boundary).
      class_id: [ntet] int32 material region per element.
      face_normals: [ntet, 4, 3] outward unit face normals.
      face_d: [ntet, 4] plane offsets.
      volumes: [ntet] positive tet volumes.
      geo20: [ntet, 20] walk table: 12 normal components, 4 plane offsets,
        then the 4 per-face topology codes stored as the raw bits of the
        float dtype (int32 bits for float32, int64 bits for float64).
        Code layout: bits 0..23 neighbor id + 1 (0 = boundary), bits
        24..29 the neighbor's class index into ``class_values``, bit 30
        set when the neighbor's class differs (material boundary). Some
        codes are NaN or inf bit patterns, so the table is only ever
        gathered or viewed, never cast. None when the mesh exceeds the
        packing limits or was built with ``packed=False``; the walk then
        reads the unpacked tables (``face_normals``, ``face_d``,
        ``tet2tet``, ``class_index``, ``nbr_class_index``).
      class_values: [nclasses] int32 sorted distinct class ids.
    """

    coords: torch.Tensor
    tet2vert: torch.Tensor
    tet2tet: torch.Tensor
    class_id: torch.Tensor
    face_normals: torch.Tensor
    face_d: torch.Tensor
    volumes: torch.Tensor
    geo20: torch.Tensor | None
    class_values: torch.Tensor

    @property
    def ntet(self) -> int:
        return int(self.tet2vert.shape[0])

    @property
    def nverts(self) -> int:
        return int(self.coords.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.coords.dtype

    @property
    def device(self) -> torch.device:
        return self.coords.device

    @functools.cached_property
    def bounds(self) -> tuple[list[float], list[float]]:
        """(lower corner, extent) of the vertices' bounding box as host
        floats, read from the device once per mesh."""
        lo = self.coords.amin(dim=0)
        ext = self.coords.amax(dim=0) - lo
        lo_h, ext_h = torch.stack([lo, ext]).double().cpu().tolist()
        return lo_h, ext_h

    @functools.cached_property
    def class_index(self) -> torch.Tensor:
        """[ntet] int32 index of each element's class in ``class_values``:
        the unpacked walk's material codes are these indices, as the
        packed codes' bits 24..29 are."""
        return torch.searchsorted(
            self.class_values, self.class_id).to(torch.int32)

    @functools.cached_property
    def nbr_class_index(self) -> torch.Tensor:
        """[ntet, 4] int32 ``class_index`` of the neighbor across each
        face, the element's own on the domain boundary: the unpacked
        walk's material-boundary test needs no second hop."""
        nbr = self.tet2tet.long()
        return torch.where(nbr >= 0, self.class_index[nbr.clamp_min(0)],
                           self.class_index[:, None]).contiguous()

    def centroids(self) -> torch.Tensor:
        """Element centroids, summed in vertex order in the mesh dtype."""
        v = self.coords[self.tet2vert.long()]
        return (((v[:, 0] + v[:, 1]) + v[:, 2]) + v[:, 3]) / 4.0

    @classmethod
    def from_numpy(
        cls,
        coords: np.ndarray,
        tet2vert: np.ndarray,
        class_id: np.ndarray | None = None,
        dtype: torch.dtype = torch.float32,
        device=None,
        packed: bool = True,
    ) -> "TetMesh":
        """Build all derived tables on the host in float64 (the native
        runtime where it builds, numpy otherwise: the same bits), then
        place them on ``device`` (default: the CUDA card) in ``dtype``.
        ``packed=False`` leaves ``geo20`` None, as a mesh past the packing
        limits does (``can_pack_walk_tables``)."""
        dev = resolve_device(device)
        if dtype not in _NP_DTYPES:
            raise ValueError(f"mesh dtype must be float32 or float64: {dtype}")
        np_dtype = np.dtype(_NP_DTYPES[dtype])
        coords = np.asarray(coords, dtype=np.float64)
        tet2vert = np.asarray(tet2vert, dtype=np.int64)
        ntet = tet2vert.shape[0]
        if class_id is None:
            class_id = np.zeros(ntet, dtype=np.int32)
        class_id = np.asarray(class_id, dtype=np.int32)

        derived = native.derive_geometry(coords, tet2vert.copy())
        if derived is not None:
            tet2vert, volumes, normals, d = derived
        else:
            tet2vert = _canonicalize_orientation(coords, tet2vert)
            volumes = _tet_volumes(coords, tet2vert)
            normals, d = _face_planes(coords, tet2vert)
        tet2tet = build_tet2tet(tet2vert)
        _check_not_tangled(normals, tet2tet)
        class_values, geo20 = _pack_geo20(
            normals, d, tet2tet, class_id, np_dtype, packed
        )

        def put(a, np_dt):
            return torch.from_numpy(np.ascontiguousarray(a, np_dt)).to(dev)

        return cls(
            coords=put(coords, np_dtype),
            tet2vert=put(tet2vert, np.int32),
            tet2tet=put(tet2tet, np.int32),
            class_id=put(class_id, np.int32),
            face_normals=put(normals, np_dtype),
            face_d=put(d, np_dtype),
            volumes=put(volumes, np_dtype),
            # Already in the mesh dtype with the code bits in place:
            # moved as bytes, never converted.
            geo20=None if geo20 is None else put(geo20, np_dtype),
            class_values=put(class_values, np.int32),
        )


def _pack_geo20(normals, d, tet2tet, class_id, np_dtype, packed=True):
    """(class_values, geo20 or None): the packed walk table in ``np_dtype``
    with the topology codes stored as that dtype's integer bits; None
    without ``packed`` or past the packing limits."""
    ntet = tet2tet.shape[0]
    nbr_safe = np.maximum(tet2tet, 0)
    nbr_class = np.where(tet2tet >= 0, class_id[nbr_safe], class_id[:, None])
    differs = ((tet2tet >= 0) & (nbr_class != class_id[:, None])).astype(
        np.int64
    )
    class_values, class_idx = np.unique(class_id, return_inverse=True)
    if not packed or not can_pack_walk_tables(
        ntet, class_values.shape[0], np_dtype.itemsize
    ):
        return class_values.astype(np.int64), None
    code = (
        (tet2tet + 1)
        | (class_idx[nbr_safe].astype(np.int64) << 24)
        | (differs << 30)
    )
    int_t = np.int32 if np_dtype.itemsize == 4 else np.int64
    geo20 = np.concatenate(
        [
            normals.reshape(ntet, 12).astype(np_dtype),
            d.astype(np_dtype),
            code.astype(int_t).view(np_dtype),
        ],
        axis=1,
    )
    return class_values.astype(np.int64), geo20


def _canonicalize_orientation(
    coords: np.ndarray, tet2vert: np.ndarray
) -> np.ndarray:
    """Ensure det(v1-v0, v2-v0, v3-v0) > 0 for every tet by swapping the last
    two vertices of negatively oriented tets."""
    v = coords[tet2vert]
    det = np.einsum(
        "ij,ij->i",
        v[:, 1] - v[:, 0],
        np.cross(v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]),
    )
    flipped = tet2vert.copy()
    neg = det < 0
    flipped[neg, 2], flipped[neg, 3] = tet2vert[neg, 3], tet2vert[neg, 2]
    return flipped


def _tet_volumes(coords: np.ndarray, tet2vert: np.ndarray) -> np.ndarray:
    v = coords[tet2vert]
    det = np.einsum(
        "ij,ij->i",
        v[:, 1] - v[:, 0],
        np.cross(v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]),
    )
    return det / 6.0


def _face_planes(coords: np.ndarray, tet2vert: np.ndarray):
    """Outward unit face normals and plane offsets for each of the 4 faces;
    the opposite vertex fixes the orientation."""
    v = coords[tet2vert]
    nt = tet2vert.shape[0]
    normals = np.empty((nt, 4, 3), dtype=np.float64)
    d = np.empty((nt, 4), dtype=np.float64)
    for f in range(4):
        a, b, c = (v[:, i] for i in FACE_LOCAL_VERTS[f])
        n = np.cross(b - a, c - a)
        opp = v[:, f]
        flip = np.einsum("ij,ij->i", n, opp - a) > 0
        n[flip] = -n[flip]
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        norm = np.where(norm == 0.0, 1.0, norm)
        n = n / norm
        normals[:, f] = n
        d[:, f] = np.einsum("ij,ij->i", n, a)
    return normals, d


def _check_not_tangled(normals: np.ndarray, tet2tet: np.ndarray) -> None:
    """Reject tangled (overlapping) meshes at load time: on a valid mesh an
    interior face's two outward unit normals are opposite; parallel ones
    mean the two elements overlap and no face walk can terminate."""
    ntet = tet2tet.shape[0]
    e = np.repeat(np.arange(ntet, dtype=np.int64), 4)
    f = np.tile(np.arange(4, dtype=np.int64), ntet)
    nbr = tet2tet.reshape(-1)
    interior = nbr > e
    e, f, nbr = e[interior], f[interior], nbr[interior]
    back = np.argmax(tet2tet[nbr] == e[:, None], axis=1)
    dots = np.einsum("ic,ic->i", normals[e, f], normals[nbr, back])
    tangled = dots > 0
    if tangled.any():
        bad = np.unique(np.concatenate([e[tangled], nbr[tangled]]))
        raise ValueError(
            f"tangled mesh: {bad.size} element(s) overlap a neighbor "
            f"across a shared face (first few: {bad[:8].tolist()}); "
            "face-adjacency walks cannot terminate on overlapping "
            "geometry — fix the mesh (inverted/pushed-through vertices)"
        )


def build_tet2tet(tet2vert: np.ndarray) -> np.ndarray:
    """Face-adjacency table: neighbor across the face opposite local vertex
    f, -1 on the domain boundary: the native runtime's hash where it
    builds, else a lexicographic sort of the sorted vertex triples of every
    face (the same table)."""
    fast = native.build_tet2tet(tet2vert)
    if fast is not None:
        return fast
    nt = tet2vert.shape[0]
    faces = tet2vert[:, FACE_LOCAL_VERTS]
    faces = np.sort(faces.reshape(nt * 4, 3), axis=1)
    owner = np.repeat(np.arange(nt, dtype=np.int64), 4)
    local = np.tile(np.arange(4, dtype=np.int64), nt)

    order = np.lexsort((faces[:, 2], faces[:, 1], faces[:, 0]))
    fs = faces[order]
    os_, ls = owner[order], local[order]

    tet2tet = np.full((nt, 4), -1, dtype=np.int64)
    same = np.all(fs[1:] == fs[:-1], axis=1)
    if np.any(same[1:] & same[:-1]):
        raise ValueError(
            "non-manifold mesh: some face is shared by more than two "
            "tetrahedra"
        )
    i = np.nonzero(same)[0]
    tet2tet[os_[i], ls[i]] = os_[i + 1]
    tet2tet[os_[i + 1], ls[i + 1]] = os_[i]
    return tet2tet
