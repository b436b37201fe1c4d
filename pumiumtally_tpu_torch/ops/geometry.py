"""Ray/tet exit-face geometry on face planes (torch).

Counterpart of ``pumiumtally_tpu/ops/geometry.py::exit_face``. Dot products
are written out as ``n0*x0 + n1*x1 + n2*x2`` in that order, and the argmin
is a sequential strict-less scan (first index wins a tie), so that the
CUDA walk kernel (``csrc/walk.cu``), compiled without FMA contraction,
computes the same values operation for operation.
"""
from __future__ import annotations

import torch


def dot3(n: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``n [..., 4, 3] · x [..., 3]`` → ``[..., 4]`` as n0*x0 + n1*x1 + n2*x2."""
    x = x.unsqueeze(-2)
    return (n[..., 0] * x[..., 0] + n[..., 1] * x[..., 1]) + n[..., 2] * x[..., 2]


def argmin4(t: torch.Tensor):
    """(min, first index of the min) over the last axis of size 4, by a
    strict-less scan."""
    best = t[:, 0]
    idx = torch.zeros(t.shape[0], dtype=torch.int32, device=t.device)
    for f in range(1, 4):
        better = t[:, f] < best
        best = torch.where(better, t[:, f], best)
        idx = torch.where(better, f, idx)
    return best, idx


def argmax4(s: torch.Tensor) -> torch.Tensor:
    """First index of the max over the last axis of size 4 (strict-greater
    scan)."""
    best = s[:, 0]
    idx = torch.zeros(s.shape[0], dtype=torch.int32, device=s.device)
    for f in range(1, 4):
        better = s[:, f] > best
        best = torch.where(better, s[:, f], best)
        idx = torch.where(better, f, idx)
    return idx


def exit_face(normals, d, cur, dirv, exclude=None, return_num=False):
    """Exit crossing of rays r(t) = cur + t*dirv, t ∈ [0, 1], out of tets
    given by face planes (normals [n,4,3], d [n,4]).

    Among faces the ray heads out through (dot(n_f, dirv) > 0) the exit is
    the one with the least plane parameter t_f. Faces marked True in
    ``exclude`` [n,4] are removed; if that strands a lane that had a
    qualifying face, the unmasked choice is taken instead.

    Returns (t_exit [n], face [n] int32, has_exit [n] bool), plus the
    plane numerators ``d - n·cur`` [n,4] (the negated signed distances of
    ``cur``) with ``return_num``.
    """
    denom = dot3(normals, dirv)
    num = d - dot3(normals, cur)
    inf = torch.tensor(float("inf"), dtype=cur.dtype, device=cur.device)
    qualifies = denom > 0
    t_all = torch.where(qualifies, num / torch.where(qualifies, denom, 1.0), inf)
    t_all = torch.where(t_all < 0, 0.0, t_all)
    t = t_all if exclude is None else torch.where(exclude, inf, t_all)
    t_exit, face = argmin4(t)
    has_exit = torch.isfinite(t_exit)
    if exclude is not None:
        t_exit0, face0 = argmin4(t_all)
        stranded = ~has_exit & torch.isfinite(t_exit0)
        t_exit = torch.where(stranded, t_exit0, t_exit)
        face = torch.where(stranded, face0, face)
        has_exit = has_exit | stranded
    if return_num:
        return t_exit, face, has_exit, num
    return t_exit, face, has_exit
