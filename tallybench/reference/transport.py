"""The plain reference: a tet walk with track-length scoring and the device
source's one-speed physics, over whole batches.

Written from the problem's statement, in plain torch ops over whole arrays
of lanes, in any float type:

* **walk**: a lane goes from ``cur`` toward ``dest`` element by element.
  In its element it leaves through the face whose plane the ray meets
  first among the faces it heads out of (the face back to the element it
  came from is skipped while another exists). A destination within
  ``tolerance`` (at least 8 ulps of the ray) of that crossing is reached.
  Each element a lane passes through scores one segment, ``(w·len,
  (w·len)²)`` into bin ``element·G + group`` (the flat flux holds the pair
  of each bin side by side); a zero-length segment still counts. Crossing
  into no element is a domain exit (the lane stops on the boundary);
  crossing into another region is a material stop (the lane stops on the
  face, in the new element, and reports the new region). A lane that runs
  ``MAX_ITERS`` iterations in one walk is truncated where it is.
* **source batch**: every lane starts at its source site with weight 1 in
  group 0. Each move, every alive lane draws (``sampler.py``) an isotropic
  direction and a flight of ``ell / Σt`` of its element's region and walks
  it. A lane that ended its walk within ``eps_near`` of its destination,
  with no material stop, collided: it scores ``w·absorption`` as absorbed
  weight, keeps ``w·(1 - absorption)`` of its region, and drops one group
  (to the last at most) when its collision draw is under ``downscatter``.
  One that ended farther away escaped and dies. Then a lane whose weight is
  under ``survival_weight`` survives roulette with its weight doubled when
  its roulette draw is under 0.5, and dies otherwise. The batch ends when
  no lane is alive or after ``max_moves`` moves.
"""
from __future__ import annotations

import numpy as np
import torch

from . import sampler
from .mesh import Tables, locate

MAX_ITERS = 4096   # far above the crossings of any flight through the box


class Lanes:
    """The walk state of all lanes: position, element, destination, the
    element a lane came from and its material code (-2 while walking)."""

    def __init__(self, pos, elem, dest=None):
        n, dev = pos.shape[0], pos.device
        self.pos, self.elem = pos, elem
        self.dest = pos.clone() if dest is None else dest
        self.prev = torch.full((n,), -1, dtype=torch.int64, device=dev)
        self.mat = torch.full((n,), -2, dtype=torch.int64, device=dev)


def step(tab: Tables, L: Lanes, act, weight, group, flux, *, n_groups,
         tolerance):
    """One crossing of the lanes ``act`` (their state updated in place,
    their segments scored); returns which of them ended."""
    dtype, dev = L.pos.dtype, L.pos.device
    floor = 8.0 * torch.finfo(dtype).eps
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    e, c, p = L.elem[act], L.pos[act], L.prev[act]
    dv = L.dest[act] - c
    nrm, nb4 = tab.normals[e], tab.nbr[e]
    denom = (nrm * dv[:, None, :]).sum(-1)
    num = tab.d[e] - (nrm * c[:, None, :]).sum(-1)
    out = denom > 0
    t = torch.where(out, num / torch.where(out, denom, 1.0), inf)
    t = torch.clamp_min(t, 0.0)
    back = (p[:, None] >= 0) & (nb4 == p[:, None])
    te, f = torch.where(back, inf, t).min(1)
    t0, f0 = t.min(1)
    stranded = torch.isinf(te) & torch.isfinite(t0)
    te, f = torch.where(stranded, t0, te), torch.where(stranded, f0, f)
    has = torch.isfinite(te)
    dn = torch.linalg.vector_norm(dv, dim=1)
    tol = torch.clamp_min(tolerance / torch.where(dn > 0, dn, 1.0), floor)
    reached = ~has | (te >= 1.0 - tol)
    ts = torch.clamp_max(te, 1.0)
    cw = ts * dn * weight[act]
    b = 2 * (e * n_groups + group[act])
    flux.index_add_(0, b, cw.to(flux.dtype))
    flux.index_add_(0, b + 1, (cw * cw).to(flux.dtype))
    nb = nb4.gather(1, f[:, None])[:, 0]
    hop = ~reached & (nb >= 0)
    exited = ~reached & (nb < 0)
    nreg = tab.region[nb.clamp_min(0)]
    stop = hop & (nreg != tab.region[e])
    L.pos[act] = c + ts[:, None] * dv
    L.elem[act] = torch.where(hop, nb, e)
    L.prev[act] = torch.where(hop, e, p)
    L.mat[act] = torch.where(stop, nreg, torch.where(
        reached | exited, -1, L.mat[act]))
    return reached | exited | stop


def locate_sites(tab: Tables, sites: torch.Tensor, cand: np.ndarray,
                 block: int = 1 << 18) -> torch.Tensor:
    """Each site's element, in blocks of ``block`` sites."""
    out = []
    for lo in range(0, sites.shape[0], block):
        c = torch.as_tensor(cand[lo:lo + block], device=sites.device)
        out.append(locate(tab, sites[lo:lo + block], c))
    return torch.cat(out)


def source_batch(tab: Tables, sites, elem, flux, *, seed, move0, n_groups,
                 sigma_t, absorption, survival_weight, downscatter,
                 max_moves, tolerance, udtype) -> dict:
    """One device-sourced batch from ``sites`` (located in ``elem``),
    scoring into ``flux``. ``sigma_t``/``absorption`` are per-region
    tables (host sequences), ``udtype`` the type of the drawn uniforms.
    Returns the batch's scored segments.

    Lanes do not interact, so each goes through its own moves at its own
    pace: a lane whose walk ended takes its physics at once and waits for
    its next flight, and waiting lanes draw their flights together once
    they are as many as the lanes still walking (any schedule gives the
    same sums)."""
    dtype, dev = tab.normals.dtype, sites.device
    n = sites.shape[0]
    sig = torch.as_tensor(np.asarray(sigma_t, np.float64), device=dev).to(
        dtype)
    ab = torch.as_tensor(np.asarray(absorption, np.float64),
                         device=dev).to(dtype)
    L = Lanes(sites.to(dtype).clone(), elem.clone())
    w = torch.ones(n, dtype=dtype, device=dev)
    g = torch.zeros(n, dtype=torch.int64, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    k = torch.zeros(n, dtype=torch.int64, device=dev)      # moves run
    iters = torch.zeros(n, dtype=torch.int64, device=dev)
    coll_u = torch.zeros(n, dtype=dtype, device=dev)
    roul_u = torch.zeros(n, dtype=dtype, device=dev)
    act = torch.zeros(0, dtype=torch.int64, device=dev)
    need = torch.arange(n, device=dev)
    waiting = torch.zeros(0, dtype=torch.int64, device=dev)
    segments = 0
    while True:
        waiting = torch.cat([waiting, need])
        if waiting.numel() and waiting.numel() >= act.numel():
            u = sampler.uniforms(seed, move0 + k[waiting], waiting, udtype)
            direction, ell, cu, ru = sampler.draws(u, dtype)
            s = sig[tab.region[L.elem[waiting]]]
            L.dest[waiting] = (L.pos[waiting]
                               + direction * (ell / s)[:, None])
            coll_u[waiting], roul_u[waiting] = cu, ru
            L.prev[waiting], L.mat[waiting], iters[waiting] = -1, -2, 0
            act = torch.cat([act, waiting])
            waiting = waiting[:0]
        if act.numel() == 0:
            break
        fin = step(tab, L, act, w, g, flux, n_groups=n_groups,
                   tolerance=tolerance)
        segments += act.numel()
        iters[act] += 1
        ended = fin | (iters[act] >= MAX_ITERS)     # walked, or truncated
        lanes = act[fin]
        if lanes.numel():
            w0, g0 = w[lanes], g[lanes]
            near = torch.linalg.vector_norm(
                L.pos[lanes] - L.dest[lanes], dim=1) < tab.eps_near
            out = L.mat[lanes] < 0
            coll, esc = out & near, out & ~near
            a = ab[tab.region[L.elem[lanes]]]
            w1 = torch.where(coll, w0 * (1.0 - a), w0)
            if n_groups > 1:
                down = coll & (coll_u[lanes] < downscatter)
                g0 = torch.where(down, torch.clamp_max(g0 + 1, n_groups - 1),
                                 g0)
            live = ~esc
            low = live & (w1 < survival_weight)
            lucky = low & (roul_u[lanes] < 0.5)
            w1 = torch.where(lucky, w1 * 2.0, w1)
            killed = low & ~lucky
            w[lanes], g[lanes] = w1, g0
            alive[lanes] = live & ~killed
        done = act[ended]
        k[done] += 1
        need = done[alive[done] & (k[done] < max_moves)]
        act = act[~ended]
    return dict(segments=segments)
