"""Mesh partitioning: element → part assignment and the per-part walk
tables.

Counterpart of ``pumiumtally_tpu/parallel/mesh_partition.py`` (its own
copy: the port imports nothing of the JAX package). Elements are ordered
along a Morton (Z-order) curve of their centroids and cut into
``n_parts`` contiguous blocks; each part's rows are its owned block, then
``halo_layers`` rings of neighboring parts' elements (buffered picparts).
The host fields are numpy and bit-equal to the JAX partition's; the
walk tables are torch tensors ``[n_parts, max_local, ...]`` on one
device: the parts are stacked on that device (a card, or the CPU), which
is the layout the JAX package gives each chip's block.

Neighbor codes in ``tet2tet_enc[p, l, f]``: ``>= 0`` a row of part p,
``-1`` the domain boundary, ``<= -2`` an element of another part,
``-2 - (owner * max_local + owner_row)`` (``decode_remote``).
``nbr_class[p, l, f]`` is the class id across the face (the element's own
on the boundary), so the walk's material test needs no remote row.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..utils.platform import resolve_device


def morton_order(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """Order of points along a Z-order curve (stable argsort of the
    interleaved-bit Morton codes of the quantized coordinates)."""
    p = np.asarray(points, np.float64)
    lo, hi = p.min(axis=0), p.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    q = np.minimum(
        ((p - lo) / span * (1 << bits)).astype(np.uint64), (1 << bits) - 1
    )
    code = np.zeros(len(p), np.uint64)
    for b in range(bits):
        for axis in range(3):
            code |= ((q[:, axis] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                3 * b + axis
            )
    return np.argsort(code, kind="stable")


@dataclasses.dataclass(frozen=True)
class MeshPartition:
    """Host partition description and the stacked per-part tables.

    Host (numpy) fields:
      owner: [ntet] part owning each element.
      global2local: [ntet] int64 row of each element on its owner.
      local2global: [n_parts, max_local] int64 inverse map, -1 padding;
        each part's owned rows first (counts[p]), then its halo rows.
      counts: [n_parts] owned elements a part.
      halo_layers: face-adjacency depth of the halo (0: none).

    Device (torch, leading axis = part) fields:
      face_normals [n_parts, max_local, 4, 3], face_d [.., 4] (mesh
      dtype), tet2tet_enc [.., 4] int32 (codes above), class_id [..]
      int32, nbr_class [.., 4] int32, volumes [..] (mesh dtype).
    The device fields hold the parts ``first_part`` to ``first_part +
      n_held`` (all of them unless ``partition_mesh(parts=...)`` asked
      for a block: a rank of the step over ranks holds its own parts).
    Halo fields (None when halo_layers == 0): row_owner and
      row_owner_local [n_parts, max_local] int32 (each row's owner and
      its row there; -1 and 0 for padding), halo_send_rows [n_parts,
      n_parts, Eh] int32 (sender p's halo rows owned by q, padded with
      max_local) and halo_recv_rows [n_parts, n_parts, Eh] int32
      (receiver q's owned rows for block p, padded with max_local).
    """

    n_parts: int
    max_local: int
    owner: np.ndarray
    global2local: np.ndarray
    local2global: np.ndarray
    counts: np.ndarray
    face_normals: Any
    face_d: Any
    tet2tet_enc: Any
    class_id: Any
    nbr_class: Any
    volumes: Any
    halo_layers: int = 0
    first_part: int = 0
    row_owner: Any = None
    row_owner_local: Any = None
    halo_send_rows: Any = None
    halo_recv_rows: Any = None

    @property
    def ntet(self) -> int:
        return int(self.owner.shape[0])

    @property
    def device(self) -> torch.device:
        return self.face_normals.device

    @property
    def n_held(self) -> int:
        """The parts whose tables the device fields hold."""
        return int(self.face_normals.shape[0])


def decode_remote(enc: np.ndarray, max_local: int):
    """Inverse of the remote-neighbor encoding: (owner part, its row)."""
    code = -2 - enc
    return code // max_local, code % max_local


def partition_mesh(
    mesh,
    n_parts: int,
    *,
    order: np.ndarray | None = None,
    halo_layers: int = 0,
    device=None,
    parts: tuple | None = None,
) -> MeshPartition:
    """Partition a TetMesh into ``n_parts`` Morton-contiguous element
    blocks and build the stacked per-part tables on ``device`` (default:
    the mesh's device); with ``parts=(lo, hi)`` only those parts' tables
    (the host fields stay whole).

    ``order`` overrides the element order (tests force skewed cuts with
    it). ``halo_layers`` buffers that many face-adjacency rings of the
    neighboring parts' elements on each part: particles walk and score
    through them as guests and migrate only when they leave the buffered
    region; the walk folds the guests' scores onto the owners' rows.
    """
    dev = mesh.device if device is None else resolve_device(device)
    ntet = mesh.ntet
    if n_parts < 1 or n_parts > ntet:
        raise ValueError(f"n_parts={n_parts} out of range for {ntet} elements")
    if halo_layers < 0:
        raise ValueError(f"halo_layers must be >= 0: {halo_layers}")
    lo, hi = (0, n_parts) if parts is None else (int(parts[0]),
                                                 int(parts[1]))
    if not 0 <= lo < hi <= n_parts:
        raise ValueError(f"parts={parts} is not a block of {n_parts} parts")

    tet2tet = mesh.tet2tet.cpu().numpy().astype(np.int64)
    if order is None:
        order = morton_order(mesh.centroids().cpu().numpy().astype(np.float64))
    order = np.asarray(order, np.int64)

    # Contiguous cut of the curve into n_parts near-equal blocks.
    bounds = np.linspace(0, ntet, n_parts + 1).astype(np.int64)
    owner = np.empty(ntet, np.int32)
    global2local = np.empty(ntet, np.int64)
    counts = np.diff(bounds).astype(np.int64)
    for p in range(n_parts):
        block = order[bounds[p]: bounds[p + 1]]
        owner[block] = p
        global2local[block] = np.arange(block.size)

    # Halo: per part, halo_layers rings of face neighbors not yet present,
    # after the owned block in row order.
    halos: list[np.ndarray] = []
    if halo_layers > 0 and n_parts > 1:
        for p in range(n_parts):
            present = np.zeros(ntet, bool)
            block = order[bounds[p]: bounds[p + 1]]
            present[block] = True
            frontier = block
            ring_all = []
            for _ in range(halo_layers):
                nb = tet2tet[frontier].ravel()
                nb = nb[nb >= 0]
                nb = np.unique(nb[~present[nb]])
                if nb.size == 0:
                    break
                present[nb] = True
                ring_all.append(nb)
                frontier = nb
            halos.append(np.concatenate(ring_all) if ring_all
                         else np.empty(0, np.int64))
    else:
        halos = [np.empty(0, np.int64) for _ in range(n_parts)]

    max_local = int(max(counts[p] + halos[p].size for p in range(n_parts)))
    local2global = np.full((n_parts, max_local), -1, np.int64)
    loc_of = np.full(ntet, -1, np.int64)
    enc = np.full((n_parts, max_local, 4), -1, np.int64)
    nbr_class_rows = np.zeros((n_parts, max_local, 4), np.int32)
    g_cls = mesh.class_id.cpu().numpy().astype(np.int32)
    for p in range(n_parts):
        block = order[bounds[p]: bounds[p + 1]]
        rows = np.concatenate([block, halos[p]])
        local2global[p, : rows.size] = rows
        loc_of[:] = -1
        loc_of[rows] = np.arange(rows.size)
        nbr = tet2tet[rows]
        nbr_safe = np.maximum(nbr, 0)
        nbr_loc = loc_of[nbr_safe]
        nbr_owner = owner[nbr_safe]
        nbr_owner_local = global2local[nbr_safe]
        enc[p, : rows.size] = np.where(
            nbr < 0,
            -1,
            np.where(
                nbr_loc >= 0,
                nbr_loc,
                # A remote code names the owner's row: leaving the
                # buffered region migrates the particle home in one hop.
                -2 - (nbr_owner * max_local + nbr_owner_local),
            ),
        )
        nbr_class_rows[p, : rows.size] = np.where(
            nbr < 0, g_cls[rows][:, None], g_cls[nbr_safe]
        )

    # Padded rows repeat the part's row 0; no code addresses them.
    g = np.where(local2global >= 0, local2global, local2global[:, :1])

    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a[lo:hi]))
        return t.to(dev, dtype) if dtype is not None else t.to(dev)

    fields = dict(
        face_normals=put(mesh.face_normals.cpu().numpy()[g]),
        face_d=put(mesh.face_d.cpu().numpy()[g]),
        tet2tet_enc=put(enc.astype(np.int32)),
        class_id=put(g_cls[g]),
        nbr_class=put(nbr_class_rows),
        volumes=put(mesh.volumes.cpu().numpy()[g]),
    )

    # A one-part partition has no cut, hence no halo.
    halo_kwargs: dict = dict(
        halo_layers=int(halo_layers) if n_parts > 1 else 0)
    if halo_layers > 0 and n_parts > 1:
        row_owner = np.where(local2global >= 0, owner[g], -1).astype(np.int32)
        row_owner_local = np.where(
            local2global >= 0, global2local[g], 0).astype(np.int32)
        # Sender p's halo rows owned by q, beside their owner rows at q,
        # padded to the largest (p, q) block with max_local.
        send_lists = [
            [
                np.nonzero(row_owner[p, : counts[p] + halos[p].size] == q)[0]
                if q != p else np.empty(0, np.int64)
                for q in range(n_parts)
            ]
            for p in range(n_parts)
        ]
        Eh = max(max((len(sl) for row in send_lists for sl in row),
                     default=0), 1)
        halo_send = np.full((n_parts, n_parts, Eh), max_local, np.int32)
        halo_recv = np.full((n_parts, n_parts, Eh), max_local, np.int32)
        for p in range(n_parts):
            for q in range(n_parts):
                sl = send_lists[p][q]
                if len(sl) == 0:
                    continue
                halo_send[p, q, : len(sl)] = sl
                halo_recv[q, p, : len(sl)] = row_owner_local[p, sl]
        halo_kwargs.update(
            row_owner=put(row_owner),
            row_owner_local=put(row_owner_local),
            halo_send_rows=put(halo_send),
            halo_recv_rows=put(halo_recv),
        )

    return MeshPartition(
        n_parts=n_parts,
        max_local=max_local,
        owner=owner,
        global2local=global2local,
        local2global=local2global,
        counts=counts,
        first_part=lo,
        **fields,
        **halo_kwargs,
    )


def disassemble_global_flux(partition: MeshPartition,
                            global_flux: np.ndarray) -> np.ndarray:
    """Inverse of ``assemble_global_flux``: a global [ntet, g, 2]
    accumulator into per-part owned slabs [n_parts, max_local, g, 2]
    (numpy), halo and padding rows zero."""
    global_flux = np.asarray(global_flux)
    slabs = np.zeros(
        (partition.n_parts, partition.max_local) + global_flux.shape[1:],
        global_flux.dtype,
    )
    for p in range(partition.n_parts):
        n = int(partition.counts[p])
        slabs[p, :n] = global_flux[partition.local2global[p, :n]]
    return slabs


def assemble_global_flux(partition: MeshPartition,
                         flux_slabs) -> np.ndarray:
    """Per-part flux slabs [n_parts, max_local, g, 2] (numpy or a tensor)
    back into global element order [ntet, g, 2]: each element is owned by
    one part, so this is a permutation, not a reduction."""
    if isinstance(flux_slabs, torch.Tensor):
        flux_slabs = flux_slabs.cpu().numpy()
    slabs = np.asarray(flux_slabs)
    _, _, g, s = slabs.shape
    out = np.zeros((partition.ntet, g, s), slabs.dtype)
    for p in range(partition.n_parts):
        n = int(partition.counts[p])
        out[partition.local2global[p, :n]] = slabs[p, :n]
    return out
