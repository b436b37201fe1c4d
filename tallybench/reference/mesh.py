"""The reference's mesh tables, worked out from the raw arrays.

Face f of a tet is the face opposite its local vertex f. Its plane is
``n·x = d`` with ``n`` the unit normal pointing away from vertex f; a point
lies outside face f when ``n·x > d``. Neighbours are found by matching the
sorted vertex triples of all faces; a face without a match is the domain's
boundary (-1).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

FACE_VERTS = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))


@dataclasses.dataclass
class Tables:
    normals: torch.Tensor   # [ntet, 4, 3]
    d: torch.Tensor         # [ntet, 4]
    nbr: torch.Tensor       # [ntet, 4] int64, -1 on the boundary
    region: torch.Tensor    # [ntet] int64
    coords: torch.Tensor    # [nverts, 3]
    tets: torch.Tensor      # [ntet, 4] int64
    eps_near: float         # the reached-destination distance

    @property
    def ntet(self) -> int:
        return int(self.tets.shape[0])


def build(coords, tets, class_id, dtype, device) -> Tables:
    """Tables of the mesh in ``dtype`` on ``device`` (planes worked out in
    float64, then cast)."""
    dev = torch.device(device)
    x = torch.as_tensor(np.asarray(coords, np.float64), device=dev)
    t = torch.as_tensor(np.asarray(tets, np.int64), device=dev)
    ntet = t.shape[0]
    normals = torch.empty(ntet, 4, 3, dtype=torch.float64, device=dev)
    d = torch.empty(ntet, 4, dtype=torch.float64, device=dev)
    keys = torch.empty(ntet, 4, dtype=torch.int64, device=dev)
    nv = x.shape[0]
    for f, (a, b, c) in enumerate(FACE_VERTS):
        pa, pb, pc, po = x[t[:, a]], x[t[:, b]], x[t[:, c]], x[t[:, f]]
        n = torch.linalg.cross(pb - pa, pc - pa)
        n = n / torch.linalg.vector_norm(n, dim=1, keepdim=True)
        flip = ((po - pa) * n).sum(1) > 0
        n = torch.where(flip[:, None], -n, n)
        normals[:, f] = n
        d[:, f] = (n * pa).sum(1)
        tri = torch.sort(torch.stack([t[:, a], t[:, b], t[:, c]], 1), 1)[0]
        keys[:, f] = (tri[:, 0] * nv + tri[:, 1]) * nv + tri[:, 2]
    flat = keys.reshape(-1)
    order = torch.argsort(flat)
    sk = flat[order]
    same = sk[1:] == sk[:-1]
    nbr = torch.full((ntet * 4,), -1, dtype=torch.int64, device=dev)
    i, j = order[:-1][same], order[1:][same]
    nbr[i] = j // 4
    nbr[j] = i // 4
    lo, hi = x.amin(0), x.amax(0)
    return Tables(
        normals=normals.to(dtype), d=d.to(dtype), nbr=nbr.reshape(ntet, 4),
        region=torch.as_tensor(np.asarray(class_id), device=dev).long(),
        coords=x.to(dtype), tets=t,
        eps_near=1e-4 * float(torch.linalg.vector_norm(hi - lo)))


def locate(tab: Tables, points: torch.Tensor, cand: torch.Tensor
           ) -> torch.Tensor:
    """The element of each point among its candidates ``cand`` [m, k]: the
    one whose worst face violation is least."""
    nrm = tab.normals[cand]                      # [m, k, 4, 3]
    sd = (nrm * points[:, None, None, :].to(nrm.dtype)).sum(-1) - tab.d[cand]
    worst = sd.amax(-1)                          # [m, k]
    return cand.gather(1, worst.argmin(1, keepdim=True))[:, 0]
