"""The partitioned walk: per-part mesh blocks and particle migration, with
the parts stacked on one device.

Counterpart of ``pumiumtally_tpu/ops/walk_partitioned.py`` (the step of
``make_partitioned_step``; its megastep is not ported here, ROADMAP.md
A9b). A step alternates

  1. a *walk phase*: every active slot (valid, not done, not pending)
     walks as in ``ops/walk.py``, over its part's rows of the stacked
     tables (``parallel/mesh_partition.py``), except that a crossing into
     another part's element freezes the lane as pending with its
     ``(target, target_elem)`` decoded from the neighbor code, and a
     material boundary at a cut hops, marks the lane done and migrates
     it (the classes compare through ``nbr_class``, so the walk never
     reads a remote row). ``prev`` holds neighbor codes, so the entry-face
     mask holds across a cut. Guests score into their host part's halo
     rows. On the card the phase is the walk kernel's partitioned layout
     (``csrc/walk.cu``, ``walk_cuda.walk_rows``): one launch walks every
     part's active lanes, keyed by row; its records fold into the stacked
     flat slab ``[P·max_local·G·2]`` (bin ``(p·max_local + row)·G + g``)
     through the ordered scatter, keyed ``it·(P·cap) + slot`` with ``it``
     the lane's iteration in the phase. On the CPU (or with ``plain``)
     it is ``walk_rows_plain``, the kernel's plain version, bitwise equal.
  2. an *exchange*: pending lanes are bucketed by destination with a
     per-destination cumsum rank into ``E`` rows a destination, overflow
     staying resident for the next round; the send blocks
     ``[P, P, E, fields]`` are transposed over their first two axes (the
     JAX package's ``all_to_all`` over devices, here on one device); each
     part adopts its i-th immigrant into its i-th free slot and counts
     what it cannot adopt in ``n_dropped``.

The rounds end when no part has pending lanes, one host read a round
(``ROUND_WAITS`` counts them; each walk phase also reads its active count
and, scoring, its record count and bucket information). With a halo the
guests' scores fold onto their owners' rows after the last round, one
``index_add_`` a sending part in part order (a one-to-one row map each,
so the fold is deterministic and adds in the JAX fold's order), and the
halo rows are zeroed. The flux is the same bits from run to run and
between the kernel and the plain version.

The JAX step's compaction, unroll and scatter knobs only schedule its
arithmetic; they are accepted and ignored. A phase's lanes each count
their own iterations, as the JAX follow-up rounds' compacted lanes do.
``SPANS``, when a list, collects ``(name, round, start, end)`` CUDA events
around each walk phase, exchange and halo fold of the steps run on the
card.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..utils.platform import resolve_device
from .geometry import exit_face
from .scatter import scatter_ordered_plain
from .walk import _norm3, chase_face_choice, escalated_bump

ROUND_WAITS = 0
SPANS: list | None = None
A9B = "ROADMAP.md A9b"
# The exchange payload's columns: floats cur(3) dest(3) weight track; ints
# pid group material target_elem occupied done back_code.
_F_COLS, _I_COLS = 8, 7


@dataclasses.dataclass
class PartitionedTraceResult:
    """Per-slot outputs ``[n_parts·cap]`` (slot-major) and per-part ones.

    position, dest, elem (the row on the part holding the slot),
    material_id, weight, group, particle_id, valid, done, track_length:
      per slot; ``valid`` marks occupied slots.
    flux: the per-part slabs in the caller's layout ([n_parts, max_local,
      G, 2] or flat [n_parts, max_local·G·2]), updated in place.
    n_segments, n_rounds, n_dropped: [n_parts] int64 (n_rounds the same
      in every part).
    round_stats: [n_parts, 6, rounds_bound] int64: pending before the
      exchange, sent, received, free slots, adopted, the follow-up walk's
      iterations.
    stats: [n_parts, 8] int64 walk stats vectors (``obs/walk_stats.py``
      order; the compaction occupancy is 0, 0: there is no compaction).
    readback: the packed step's readback (``staging``), else None.
    """

    position: torch.Tensor
    dest: torch.Tensor
    elem: torch.Tensor
    material_id: torch.Tensor
    weight: torch.Tensor
    group: torch.Tensor
    particle_id: torch.Tensor
    valid: torch.Tensor
    done: torch.Tensor
    flux: torch.Tensor
    n_segments: torch.Tensor
    n_rounds: torch.Tensor
    n_dropped: torch.Tensor
    track_length: torch.Tensor
    round_stats: torch.Tensor
    stats: torch.Tensor
    readback: torch.Tensor | None = None


def stacked_tables(partition) -> tuple:
    """The partition's walk tables with the parts' rows one after the
    other, in ``csrc/walk.cu``'s ``Tables`` order: face planes, face
    offsets, neighbor codes, classes, neighbor classes (views)."""
    rows = partition.n_parts * partition.max_local
    return (partition.face_normals.view(rows, 4, 3),
            partition.face_d.view(rows, 4),
            partition.tet2tet_enc.view(rows, 4),
            partition.class_id.view(rows),
            partition.nbr_class.view(rows, 4))


def walk_rows_plain(tables, origin, dest, rows, weight, group, material_id,
                    pseg, prev, stuck, slot, flux, *, stride: int,
                    max_local: int, initial: bool, max_crossings: int,
                    n_groups: int, score_squares: bool = True,
                    tolerance: float = 1e-8, robust: bool = True,
                    capacity=None):
    """The plain version of ``walk_cuda.walk_rows`` (same arguments, same
    outputs; ``capacity`` is ignored): the crossing body of the JAX
    ``_walk_phase`` over the m lanes, written operation for operation
    like the kernel's partitioned layout. Returns ``(out, None)``."""
    del capacity
    normals_t, d_t, nbr_t, cls_t, nbrcls_t = tables
    dtype, dev = origin.dtype, origin.device
    m = origin.shape[0]
    tol_floor = 8 * torch.finfo(dtype).eps
    good_group = (group >= 0) & (group < n_groups)
    i32 = dict(dtype=torch.int32, device=dev)
    cur = origin.clone()
    row = rows.long()
    base = row // max_local * max_local
    done = torch.zeros(m, dtype=torch.bool, device=dev)
    mat, pseg = material_id.clone(), pseg.clone()
    prev, stuck = prev.clone(), stuck.clone()
    target = torch.full((m,), -1, **i32)
    target_elem = torch.zeros(m, **i32)
    ncross, nchase, nseg, iters = (torch.zeros(m, **i32) for _ in range(4))
    held = []
    it = 0
    while it < max_crossings:
        active = ~done & (target < 0)
        if not bool(active.any()):
            break
        iters += active.to(torch.int32)
        normals, dplane, nbrs_all = normals_t[row], d_t[row], nbr_t[row]
        dirv = dest - cur
        if robust:
            backward = (prev[:, None] != -1) & (nbrs_all == prev[:, None])
            t_exit, face, has_exit, plane_num = exit_face(
                normals, dplane, cur, dirv, exclude=backward,
                return_num=True)
            sd = -plane_num
            contained = sd.amax(dim=-1) <= 0.0
            chase = active & (stuck >= 4) & ~contained
            chase_face = chase_face_choice(sd, row - base, it, dtype,
                                           nbrs_all != -1)
            face = torch.where(chase, chase_face, face)
            t_exit = torch.where(chase, 0.0, t_exit)
            has_exit = has_exit | chase
        else:
            t_exit, face, has_exit = exit_face(normals, dplane, cur, dirv)
            chase = torch.zeros_like(done)
        dnorm = _norm3(dirv)
        tol_eff = torch.maximum(
            torch.full_like(dnorm, tolerance)
            / torch.where(dnorm > 0, dnorm, 1.0),
            torch.full_like(dnorm, tol_floor),
        )
        reached = (t_exit >= 1.0 - tol_eff) | ~has_exit
        t_step = torch.clamp_max(t_exit, 1.0)
        xpoint = cur + t_step[:, None] * dirv
        crossed = active & ~reached & has_exit
        ncross += (crossed & ~chase).to(torch.int32)
        nchase += chase.to(torch.int32)
        face_l = face.long()[:, None]
        nb = torch.gather(nbrs_all, 1, face_l)[:, 0]
        next_elem = torch.where(crossed, nb, -1)
        if not initial:
            seg = _norm3(xpoint - cur)
            scored = active & ~chase
            contrib = seg * weight
            hit = scored & good_group
            held.append((row[hit] * n_groups + group[hit].long(),
                         it * stride + slot[hit], contrib[hit]))
            nseg += scored.to(torch.int32)
            pseg = pseg + torch.where(scored, seg, 0.0)
        domain_exit = crossed & (next_elem == -1)
        if initial:
            material_stop = torch.zeros_like(domain_exit)
        else:
            stop_class = torch.gather(nbrcls_t[row], 1, face_l)[:, 0]
            material_stop = (crossed & (next_elem != -1) & ~chase
                             & (stop_class != cls_t[row]))
            mat = torch.where(
                material_stop, stop_class,
                torch.where((active & reached) | domain_exit, -1, mat))
        newly_done = (active & reached) | domain_exit | material_stop
        remote = crossed & (next_elem < -1)
        code = -2 - next_elem
        target = torch.where(remote, code // max_local, target)
        target_elem = torch.where(remote, code % max_local, target_elem)
        hopped = crossed & (next_elem >= 0)
        if robust:
            prev = torch.where(hopped, torch.where(chase, -1, row - base),
                               prev).to(torch.int32)
        row = torch.where(hopped, base + next_elem, row)
        cur = torch.where(active[:, None], xpoint, cur)
        if robust:
            continuing = hopped & ~newly_done
            extra, stuck = escalated_bump(stuck, contained, continuing,
                                          t_step, tol_floor, tol_eff, cur,
                                          dnorm)
            cur = torch.where(continuing[:, None], cur + extra[:, None] * dirv,
                              cur)
        done = done | newly_done
        it += 1
    if held:
        scatter_ordered_plain(flux, *(torch.cat(c) for c in zip(*held)),
                              score_squares)
    out = dict(pos=cur, elem=(row - base).to(torch.int32), mat=mat,
               done=done, pseg=pseg, ncross=ncross, nchase=nchase, nseg=nseg,
               iters=iters, target=target, target_elem=target_elem,
               prev=prev, stuck=stuck.to(torch.int32))
    return out, None


@contextlib.contextmanager
def _span(dev, name: str, rnd: int):
    """CUDA events around a block into ``SPANS`` (a list) on the card."""
    if SPANS is None or dev.type != "cuda":
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    SPANS.append((name, rnd, start, end))


def _flat_slabs(flux, n_parts: int, max_local: int, n_groups: int):
    """The stacked flat slab view of the caller's flux, after the JAX
    step's layout checks."""
    shapes = ((n_parts, max_local, n_groups, 2),
              (n_parts, max_local * n_groups * 2))
    if tuple(flux.shape) not in shapes:
        raise ValueError(
            f"flux must be {shapes[0]} or flat {shapes[1]}; got "
            f"{tuple(flux.shape)}")
    if not flux.is_contiguous():
        raise ValueError("flux must be contiguous")
    return flux.view(-1)


def make_partitioned_step(
    device_mesh,
    partition,
    *,
    n_groups: int,
    initial: bool = False,
    max_crossings: int = 4096,
    max_rounds: int | None = None,
    exchange_size: int | None = None,
    tolerance: float = 1e-8,
    score_squares: bool = True,
    unroll: int = 1,
    compact_after: int | None = None,
    compact_size: int | None = None,
    compact_stages: tuple | None = None,
    followup_compact_size: int | None = None,
    robust: bool = True,
    tally_scatter: str = "auto",
    record_xpoints: int | None = None,
    packed_io: bool = False,
    integrity: bool = False,
    convergence: bool = False,
    rel_err_target: float = 0.05,
    batch_moves: int = 1,
    plain: bool = False,
    face_rate: float | None = None,
):
    """The partitioned step for one partition, with the arguments of
    the JAX ``make_partitioned_step``: ``device_mesh``
    (``parallel/particle_sharding.py::make_device_mesh``) must list
    ``partition.n_parts`` devices, all the partition's device (the parts
    are stacked there).
    ``exchange_size`` is the emigrant rows a destination takes a round
    (default ``max(cap // (2·n_parts), 64)``, at most cap);
    ``max_rounds`` bounds the walk/exchange rounds (default ``4·n_parts +
    8``; lanes still pending then end not done). ``plain`` walks with the
    plain version on whatever device (the kernel's yardstick on the
    card).

    Returns ``step(cur, dest, elem, done, material_id, weight, group,
    pid, valid, flux, capacity=None) -> PartitionedTraceResult``
    (per-slot tensors ``[n_parts·cap]``, ``elem`` part-local rows), or
    with ``packed_io`` ``step(record, flux, capacity=None)`` over the
    record of ``staging.pack_partitioned_record``, whose result carries
    the ``readback``. ``capacity`` sizes the first walk phase's record
    buffers on the card. With ``face_rate`` (``walk_cuda.face_rate`` of
    the partitioned mesh) a move sizes each later phase's buffers from
    the pending lanes' remaining paths (``walk_cuda.path_records``' rule),
    read with the round's stop test; without it a later phase has 4
    records a lane and walks again when it makes more. The flux is
    updated in place.

    ``record_xpoints``, ``integrity`` and ``convergence`` raise
    NotImplementedError (ROADMAP.md A9b)."""
    del unroll, compact_after, compact_size, compact_stages
    del followup_compact_size, rel_err_target, batch_moves
    for name, on in (("record_xpoints", record_xpoints is not None),
                     ("integrity", integrity),
                     ("convergence", convergence)):
        if on:
            raise NotImplementedError(
                f"the partitioned step's {name} is not ported yet ({A9B})")
    if tally_scatter not in ("auto", "interleaved", "pair"):
        raise ValueError(
            f"tally_scatter must be 'auto', 'interleaved' or 'pair': "
            f"{tally_scatter!r}")
    n_parts, max_local = partition.n_parts, partition.max_local
    devs = list(device_mesh)
    if len(devs) != n_parts:
        raise ValueError(
            f"device mesh has {len(devs)} devices, partition has {n_parts} "
            "parts")
    dev = partition.device
    if any(resolve_device(d) != dev for d in devs):
        raise ValueError(
            f"the parts are stacked on {dev}; every device of the mesh must "
            "be that device (parts on several devices: ROADMAP.md A9b)")
    if 2 * max_local * n_groups >= 2**31:
        raise NotImplementedError(
            "flat tally keys overflow int32: max_local*n_groups*2 = "
            f"{2 * max_local * n_groups} >= 2^31; use more partitions")
    if n_parts * max_local * n_groups >= 2**31:
        raise NotImplementedError(
            "the stacked parts' bins overflow int32: n_parts*max_local*"
            f"n_groups = {n_parts * max_local * n_groups} >= 2^31")
    rounds_bound = max_rounds if max_rounds is not None else 4 * n_parts + 8
    tables = stacked_tables(partition)
    halo = _halo_fold_rows(partition) if partition.halo_layers else None
    if partition.halo_layers:
        canon = -2 - (partition.row_owner.long() * max_local
                      + partition.row_owner_local.long()).view(-1)
    else:
        canon = None
    if plain:
        walk_fn = walk_rows_plain
    else:
        from .walk_cuda import walk_rows as walk_fn
    sizing = face_rate is not None and not initial
    if sizing:
        from .walk_cuda import record_capacity
    walk_kw = dict(max_local=max_local, initial=initial,
                   max_crossings=max_crossings, n_groups=n_groups,
                   score_squares=score_squares, tolerance=tolerance,
                   robust=robust)

    def run(cur, dest, elem, done, material_id, weight, group, pid, valid,
            flux, capacity=None):
        global ROUND_WAITS
        if cur.device != dev:
            raise ValueError(f"the slots are on {cur.device}, the parts on "
                             f"{dev}")
        total = cur.shape[0]
        if total % n_parts:
            raise ValueError(
                f"{total} slots do not split into {n_parts} parts")
        cap = total // n_parts
        E = min(exchange_size if exchange_size is not None
                else max(cap // (2 * n_parts), 64), cap)
        flat = _flat_slabs(flux, n_parts, max_local, n_groups)
        i32 = dict(dtype=torch.int32, device=dev)
        cur, dest, weight = cur.clone(), dest.clone(), weight.clone()
        elem, done = elem.clone().to(torch.int32), done.clone()
        material_id, group = material_id.clone(), group.clone()
        pid, valid = pid.clone(), valid.clone()
        target = torch.full((total,), -1, **i32)
        target_elem = torch.zeros(total, **i32)
        prev = torch.full((total,), -1, **i32)
        stuck = torch.zeros(total, **i32)
        pseg = torch.zeros(total, dtype=cur.dtype, device=dev)
        ncross = torch.zeros(total, **i32)
        nchase = torch.zeros(total, **i32)
        nseg = torch.zeros(n_parts, dtype=torch.int64, device=dev)
        dropped = torch.zeros(n_parts, dtype=torch.int64, device=dev)
        part_of = torch.arange(total, device=dev) // cap

        def walk_phase(rnd, cap_records=None):
            """Walk every active slot; returns each part's iterations."""
            slots = torch.nonzero(valid & ~done & (target < 0))[:, 0]
            slots = slots.contiguous()
            iters = torch.zeros(n_parts, dtype=torch.int64, device=dev)
            if slots.numel() == 0:
                return iters
            p = part_of[slots]
            rows = (p * max_local + elem[slots]).to(torch.int32)
            with _span(dev, "walk", rnd):
                out, _ = walk_fn(
                    tables, cur[slots], dest[slots], rows, weight[slots],
                    group[slots], material_id[slots], pseg[slots],
                    prev[slots], stuck[slots], slots, flat,
                    stride=total, capacity=cap_records, **walk_kw)
            cur[slots] = out["pos"]
            elem[slots] = out["elem"]
            material_id[slots] = out["mat"]
            done[slots] = out["done"]
            pseg[slots] = out["pseg"]
            prev[slots] = out["prev"]
            stuck[slots] = out["stuck"]
            target[slots] = out["target"]
            target_elem[slots] = out["target_elem"]
            ncross[slots] += out["ncross"]
            nchase[slots] += out["nchase"]
            nseg.index_add_(0, p, out["nseg"].to(torch.int64))
            return iters.scatter_reduce_(0, p, out["iters"].to(torch.int64),
                                         "amax")

        def exchange(rnd):
            with _span(dev, "exchange", rnd):
                return _exchange(n_parts, cap, E, max_local, canon, state,
                                 dropped)

        state = dict(cur=cur, dest=dest, weight=weight, pseg=pseg, pid=pid,
                     group=group, material_id=material_id, elem=elem,
                     done=done, valid=valid, target=target,
                     target_elem=target_elem, prev=prev, stuck=stuck)
        w0 = walk_phase(0, capacity)
        round_stats = torch.zeros(n_parts, 6, rounds_bound,
                                  dtype=torch.int64, device=dev)
        rnd = 0
        while rnd < rounds_bound:
            ROUND_WAITS += 1
            pend = valid & (target >= 0)
            if sizing:
                n_pend, path = _pending_path(pend, cur, dest)
                records = record_capacity(n_pend, n_pend + face_rate * path)
            else:
                n_pend, records = int(bool(pend.any())), None
            if not n_pend:
                break
            ex = exchange(rnd + 1)
            w = walk_phase(rnd + 1, records)
            round_stats[:, :5, rnd] = ex
            round_stats[:, 5, rnd] = w
            rnd += 1
        if halo is not None:
            with _span(dev, "halo", rnd):
                _fold_halo(flat, halo, n_parts, max_local, n_groups)
        i64 = torch.int64
        nc = ncross.view(n_parts, cap)
        zero = torch.zeros(n_parts, dtype=i64, device=dev)
        stats = torch.stack([
            nc.sum(1, dtype=i64), nc.amax(1).to(i64),
            nchase.view(n_parts, cap).sum(1, dtype=i64),
            (valid & ~done).view(n_parts, cap).sum(1, dtype=i64),
            zero, zero, nseg, w0 + round_stats[:, 5].sum(1),
        ], dim=1)
        return PartitionedTraceResult(
            position=cur, dest=dest, elem=elem, material_id=material_id,
            weight=weight, group=group, particle_id=pid, valid=valid,
            done=done, flux=flux, n_segments=nseg,
            n_rounds=torch.full((n_parts,), rnd, dtype=i64, device=dev),
            n_dropped=dropped, track_length=pseg, round_stats=round_stats,
            stats=stats)

    if not packed_io:
        return run

    from .staging import pack_partitioned_readback, unpack_partitioned_record

    def packed(record, flux, capacity=None):
        res = run(*unpack_partitioned_record(record), flux,
                  capacity=capacity)
        res.readback = pack_partitioned_readback(res, n_parts)
        return res

    return packed


def _pending_path(pend, cur, dest) -> tuple:
    """(the pending lanes, the sum of their remaining paths |dest − cur|)
    in one host read: an upper estimate of the next phase's lanes and
    their paths (overflow stays pending; a lane freezes again at the
    next cut)."""
    path = torch.where(pend, _norm3(dest - cur), 0.0).sum(
        dtype=torch.float64)
    n, path = torch.stack([pend.sum(dtype=torch.float64), path]).tolist()
    return int(n), path


def _row_ranks(mask: torch.Tensor) -> torch.Tensor:
    """Each True entry's rank among its row's True entries ([R, C] bool →
    int64; other entries meaningless): one scan over the flattened mask
    less each row's start (a scan along the last axis of a few long rows
    is a slow kernel on the card, a 1-D scan a fast one)."""
    c = torch.cumsum(mask.reshape(-1), 0).view(mask.shape)
    start = torch.cat([c.new_zeros(1), c[:-1, -1]])
    return c - start[:, None] - 1


def _exchange(P, cap, E, max_local, canon, s, dropped):
    """One exchange round over the stacked slot state ``s`` (updated in
    place): bucket, send blocks, transpose, adopt. Returns the [P, 5]
    int64 round stats (pending, sent, received, free, adopted)."""
    dev = s["cur"].device
    valid, target = s["valid"], s["target"]
    emig = (valid & (target >= 0)).view(P, cap)
    tgt = target.view(P, cap)
    slot = torch.full((P, cap), P * E, dtype=torch.int64, device=dev)
    sendable = torch.zeros(P, cap, dtype=torch.bool, device=dev)
    for d in range(P):
        m_d = emig & (tgt == d)
        rank_d = _row_ranks(m_d)
        ok_d = m_d & (rank_d < E)
        slot = torch.where(ok_d, d * E + rank_d, slot)
        sendable |= ok_d
    src = torch.nonzero(sendable.view(-1))[:, 0]
    sp = src // cap
    dst = sp * (P * E) + slot.view(-1)[src]
    elem = s["elem"][src].long()
    if canon is None:  # the element left, as the receiver's codes name it
        back = -2 - (sp * max_local + elem)
    else:
        back = canon[sp * max_local + elem]
    back = torch.where(s["stuck"][src] >= 4, -1, back)
    dtype = s["cur"].dtype
    fbuf = torch.zeros(P * P * E, _F_COLS, dtype=dtype, device=dev)
    ibuf = torch.zeros(P * P * E, _I_COLS, dtype=torch.int32, device=dev)
    fbuf[dst] = torch.cat([s["cur"][src], s["dest"][src],
                           s["weight"][src][:, None],
                           s["pseg"][src][:, None]], 1)
    ibuf[dst] = torch.stack([
        s["pid"][src], s["group"][src], s["material_id"][src],
        s["target_elem"][src], torch.ones_like(s["pid"][src]),
        s["done"][src].to(torch.int32), back.to(torch.int32)], 1)
    valid[src] = False
    target[src] = -1
    # The all_to_all of the JAX step: block d of sender p goes to part d.
    recv_f = fbuf.view(P, P, E, _F_COLS).transpose(0, 1).reshape(
        P, P * E, _F_COLS)
    recv_i = ibuf.view(P, P, E, _I_COLS).transpose(0, 1).reshape(
        P, P * E, _I_COLS)
    mine = recv_i[:, :, 4] == 1
    free = ~valid.view(P, cap)
    n_mine, n_free = mine.sum(1), free.sum(1)
    take = torch.minimum(n_mine, n_free)
    dropped += (n_mine - n_free).clamp_min(0)
    # The i-th immigrant row into the i-th free slot.
    rank_src = _row_ranks(mine)
    rank_free = _row_ranks(free)
    qf, kf = torch.nonzero(free, as_tuple=True)
    free_at = torch.full((P, cap), cap, dtype=torch.int64, device=dev)
    free_at[qf, rank_free[qf, kf]] = kf
    qs, js = torch.nonzero(mine & (rank_src < take[:, None]), as_tuple=True)
    at = qs * cap + free_at[qs, rank_src[qs, js]]
    rf, ri = recv_f[qs, js], recv_i[qs, js]
    s["cur"][at] = rf[:, 0:3]
    s["dest"][at] = rf[:, 3:6]
    s["weight"][at] = rf[:, 6]
    s["pseg"][at] = rf[:, 7]
    s["pid"][at] = ri[:, 0]
    s["group"][at] = ri[:, 1]
    s["material_id"][at] = ri[:, 2]
    s["elem"][at] = ri[:, 3]
    s["done"][at] = ri[:, 5] != 0
    s["prev"][at] = ri[:, 6]
    s["stuck"][at] = 0
    valid[at] = True
    i64 = torch.int64
    return torch.stack([emig.sum(1, dtype=i64), sendable.sum(1, dtype=i64),
                        n_mine.to(i64), n_free.to(i64), take.to(i64)], 1)


def _halo_fold_rows(partition) -> list:
    """Per sending part p: (its halo rows, the owners' rows) as stacked
    row ids, int64 on the partition's device, one-to-one."""
    P, L = partition.n_parts, partition.max_local
    send = partition.halo_send_rows.cpu().numpy().astype(np.int64)
    recv = partition.halo_recv_rows.cpu().numpy().astype(np.int64)
    out = []
    for p in range(P):
        src, dst = [], []
        for q in range(P):
            ok = send[p, q] < L
            src.append(p * L + send[p, q][ok])
            dst.append(q * L + recv[q, p][ok])
        out.append(tuple(torch.from_numpy(np.concatenate(a)).to(
            partition.device) for a in (src, dst)))
    owned = torch.from_numpy(
        np.arange(L)[None, :] < partition.counts[:, None]).reshape(-1)
    return [owned.to(partition.device), out]


def _fold_halo(flat, halo, P, L, G):
    """Guest scores onto their owners' rows, then the halo rows zeroed:
    one ``index_add_`` a sending part, in part order."""
    owned, pairs = halo
    flux2 = flat.view(P * L, 2 * G)
    sent = [flux2[src] for src, _ in pairs]
    flux2.masked_fill_(~owned[:, None], 0.0)
    for (_, dst), rows in zip(pairs, sent):
        flux2.index_add_(0, dst, rows)


# ---------------------------------------------------------------------- #
# Host-side placement of particles onto their owner parts.
# ---------------------------------------------------------------------- #
def slot_layout(partition, global_elem, cap: int | None = None):
    """``(slot_of [n] int64, cap)``: particle i's slot, its owner part's
    block of ``cap`` slots (default n), in particle order within a part."""
    global_elem = np.asarray(global_elem)
    n = int(global_elem.shape[0])
    n_parts = partition.n_parts
    cap = int(cap) if cap is not None else n
    owner = partition.owner[global_elem].astype(np.int64)
    counts = np.bincount(owner, minlength=n_parts)
    if counts.max(initial=0) > cap:
        raise ValueError(
            f"chip {int(counts.argmax())} needs {int(counts.max())} slots at "
            f"seed time but cap={cap}")
    order = np.argsort(owner, kind="stable")
    start = np.searchsorted(owner[order], np.arange(n_parts))
    rank_in_part = np.arange(n, dtype=np.int64) - start[owner[order]]
    slot_of = np.empty(n, np.int64)
    slot_of[order] = owner[order] * cap + rank_in_part
    return slot_of, cap


def distribute_particles(partition, device_mesh, global_elem, fields: dict,
                         cap: int | None = None) -> dict:
    """Host particle arrays into the slot layout on the partition's
    device: ``fields`` (name → [n, ...] host array; 'origin' and 'dest'
    at least) as ``[n_parts·cap, ...]`` tensors, plus 'valid',
    'particle_id' (-1 in empty slots) and 'elem' (part-local rows).
    ``cap`` slots a part (default n)."""
    del device_mesh  # every part lives on the partition's device
    slot_of, cap = slot_layout(partition, global_elem, cap)
    n = slot_of.shape[0]
    total = partition.n_parts * cap
    dev = partition.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out = {}
    for name, arr in fields.items():
        arr = np.asarray(arr)
        buf = np.zeros((total,) + arr.shape[1:], arr.dtype)
        buf[slot_of] = arr
        out[name] = put(buf)
    valid = np.zeros(total, bool)
    valid[slot_of] = True
    pid = np.full(total, -1, np.int32)
    pid[slot_of] = np.arange(n, dtype=np.int32)
    elem_local = np.zeros(total, np.int32)
    elem_local[slot_of] = partition.global2local[np.asarray(global_elem)]
    out["valid"], out["particle_id"], out["elem"] = (
        put(valid), put(pid), put(elem_local))
    return out


def collect_by_particle_id(result, n: int, partition=None) -> dict:
    """Per-particle outputs back in host particle order (numpy): position,
    material_id, done, elem (the row on the part holding the particle),
    weight, group, track_length; with ``partition`` also ``elem_global``
    (through the holding part's local2global)."""
    pid = result.particle_id.cpu().numpy()
    valid = result.valid.cpu().numpy()
    sel = valid & (pid >= 0)
    idx = pid[sel]
    out = {}
    for name in ("position", "material_id", "done", "elem", "weight",
                 "group", "track_length"):
        arr = getattr(result, name).cpu().numpy()
        buf = np.zeros((n,) + arr.shape[1:], arr.dtype)
        buf[idx] = arr[sel]
        out[name] = buf
    if partition is not None:
        cap = pid.shape[0] // partition.n_parts
        chip = (np.arange(pid.shape[0]) // cap)[sel]
        eg = partition.local2global[chip, result.elem.cpu().numpy()[sel]]
        buf = np.full(n, -1, np.int64)
        buf[idx] = eg
        out["elem_global"] = buf
    return out
