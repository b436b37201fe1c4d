"""The partitioned walk: per-part mesh blocks and particle migration,
the parts stacked on one device or spread over the ranks of a process
group.

Counterpart of ``pumiumtally_tpu/ops/walk_partitioned.py``: the step of
``make_partitioned_step`` and the K fused device-sourced moves of
``make_partitioned_megastep`` (``partitioned_megastep`` here). A process
walks a block of parts stacked on its device (``rank_layout``: every part
when the device mesh names no ranks). A step alternates

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
     local part's active lanes, keyed by row; its records fold into the
     stacked flat slab ``[P·max_local·G·2]`` (bin ``(p·max_local +
     row)·G + g``) through the ordered scatter, keyed ``it·(n_parts·cap)
     + slot`` with ``it`` the lane's iteration in the phase and ``slot``
     the global slot number. On the CPU (or with ``plain``) it is
     ``walk_rows_plain``, the kernel's plain version, bitwise equal.
     The phase follows the JAX phase's crossing budgets: the JAX step
     walks its later phases, and with ``compact_after`` its first phase
     past it, in compacted rounds, each taking a part's first S active
     slots with a fresh ``max_crossings`` budget and a fresh loop count
     (which the stuck-lane chase hash reads), at most ceil(cap/S) + 1
     rounds. A lane's first round is one launch over every lane (the
     kernel restarts the hash's count at ``compact_after``); the lanes
     that run out of budget there are found with the round's stop test
     and walk again, one launch a later round that takes one
     (``BUDGET_RELAUNCHES``; ``BUDGET_LANES`` counts the lanes), as the
     JAX schedule gives them rounds. A schedule of several stages walks
     each stage as a launch over the lanes it takes, the phase's records
     folded in one scatter keyed by the lanes' iterations in the phase. A
     phase with later rounds folds its records after the stop test, so
     that a lane the JAX rounds never take (lanes that ran out fill every
     round; ``BUDGET_STARVED`` counts them) gets back its state from
     before its first round, that round's counters and records taken
     off.
  2. an *exchange*: pending lanes are bucketed by destination with a
     per-destination cumsum rank into ``E`` rows a destination, overflow
     staying resident for the next round; the send blocks
     ``[P_local, P, E, row]`` (float and int columns in one byte row, the
     recorded points and their count among them with ``record_xpoints``)
     go to their parts in one all_to_all (``Collectives``:
     ``dist.all_to_all_single`` over ranks, its input itself when the
     parts are stacked); each part adopts its i-th immigrant into its
     i-th free slot and counts what it cannot adopt in ``n_dropped``.
     ``SEND_BYTES`` keeps the largest send buffer allocated, in bytes.

The rounds end when no part of any rank has pending lanes: one
all_reduce and one host read a round (``ROUND_WAITS`` counts them; each
walk phase also reads its active count and, scoring, its record count
and bucket information). With a halo the guests' scores go to their
owners' parts in one all_to_all after the last round and fold onto the
owners' rows, one ``index_add_`` a sending part in part order (a
one-to-one row map each, so the fold is deterministic and adds in the JAX
fold's order), and the halo rows are zeroed. The flux is the same bits
from run to run, between the kernel and the plain version, and between
the stacked step and the step over ranks. With ``integrity`` each part's
``PART_INTEGRITY_FIELDS`` counters, and with ``convergence`` each part's
batch fold and summary (``obs/convergence.py``), follow the halo fold.

With ``record_xpoints=K`` every walk phase records each lane's first K
genuine crossings (the crossing into another part once, by the part it
leaves) into per-slot buffers that migrate with the lanes, as the JAX
phase's ``record_crossing`` does. The megastep runs over ranks as the
step does; its physics sums are per-part partial sums added in part
order after one collective, so its bits do not depend on the ranks.

The JAX step's unroll and scatter knobs only schedule its arithmetic;
they are accepted and ignored. ``SPANS``, when a list, collects ``(name,
round, start, end)`` CUDA events around each walk phase, exchange and
halo fold of the steps run on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..obs.convergence import fold_and_reduce
from ..parallel.ranks import RankLayout, rank_layout
from .geometry import exit_face
from .scatter import scatter_ordered_plain
from .walk import _norm3, chase_face_choice, escalated_bump, xpoint_buffers

ROUND_WAITS = 0
BUDGET_RELAUNCHES = 0
BUDGET_LANES = 0
BUDGET_STARVED = 0
SEND_BYTES = 0
SPANS: list | None = None
# The exchange payload's columns: floats cur(3) dest(3) weight track, then
# with record_xpoints=K the points (3K); ints pid group material
# target_elem occupied done back_code, then the point count (else
# padding: the int block is 8 columns either way).
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
    xpoints, n_xpoints: with ``record_xpoints=K``, per slot ``[K, 3]``
      crossing points and the int32 count of genuine crossings (may
      exceed K), migrated with their particles; else None.
    integrity: [n_parts, PART_INTEGRITY_LEN] int64 (``integrity``), else
      None.
    convergence: [n_parts, CONV_LEN] summaries in the walk dtype
      (``convergence``), else None.
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
    integrity: torch.Tensor | None = None
    convergence: torch.Tensor | None = None
    xpoints: torch.Tensor | None = None
    n_xpoints: torch.Tensor | None = None


def stacked_tables(partition, parts: tuple | None = None) -> tuple:
    """The walk tables of the parts the partition holds (or of the block
    ``parts=(lo, hi)`` of them, global part numbers), the parts' rows one
    after the other, in ``csrc/walk.cu``'s ``Tables`` order: face planes,
    face offsets, neighbor codes, classes, neighbor classes (views)."""
    f = partition.first_part
    lo, hi = ((0, partition.n_held) if parts is None
              else (parts[0] - f, parts[1] - f))
    if not 0 <= lo < hi <= partition.n_held:
        raise ValueError(
            f"the partition holds parts {f} to {f + partition.n_held}, "
            f"not {parts}")
    rows = (hi - lo) * partition.max_local
    return (partition.face_normals[lo:hi].view(rows, 4, 3),
            partition.face_d[lo:hi].view(rows, 4),
            partition.tet2tet_enc[lo:hi].view(rows, 4),
            partition.class_id[lo:hi].view(rows),
            partition.nbr_class[lo:hi].view(rows, 4))


def normalize_compact_stages(compact_stages, compact_after, compact_size,
                             n: int, size_floor: int):
    """The JAX walks' compaction schedule (``ops/walk.py``'s rule, own
    copy): the single-stage knobs folded into a one-entry schedule
    ``((start, size),)``, entries ``(start, size[, unroll])`` with
    strictly increasing starts; None when compaction is off."""
    if compact_stages is None and compact_after is not None:
        compact_stages = ((compact_after, compact_size
                           if compact_size is not None else size_floor),)
    if compact_stages is None:
        return None
    if len(compact_stages) == 0:
        raise ValueError("compact_stages must be None or a non-empty schedule")
    for st in compact_stages:
        if len(st) not in (2, 3):
            raise ValueError(
                "compact_stages entries must be (start, size) or "
                f"(start, size, unroll): {st!r}")
    starts = [st[0] for st in compact_stages]
    if starts != sorted(set(starts)):
        raise ValueError(
            f"compact_stages starts must be strictly increasing: {starts}")
    for st in compact_stages:
        if st[1] < 1 or (len(st) == 3 and st[2] < 1):
            raise ValueError(
                f"compact_stages size/unroll must be >= 1: {st!r}")
    return compact_stages


def walk_rows_plain(tables, origin, dest, rows, weight, group, material_id,
                    pseg, prev, stuck, slot, flux, *, stride: int,
                    max_local: int, initial: bool, max_crossings: int,
                    n_groups: int, score_squares: bool = True,
                    tolerance: float = 1e-8, robust: bool = True,
                    capacity=None, reset: int = 0,
                    record_xpoints: int | None = None, xpoints=None):
    """The plain version of ``walk_cuda.walk_rows`` (same arguments, same
    outputs; ``capacity`` is ignored): the crossing body of the JAX
    ``_walk_phase`` over the m lanes, written operation for operation
    like the kernel's partitioned layout. With ``record_xpoints`` each
    genuine crossing (not a chase hop), the crossing into another part
    too, is recorded as the JAX phase's ``record_crossing`` does, into
    ``xpoints`` (updated in place) or fresh buffers. Returns ``(out,
    (bin, order, c))``, the records None when the launch made none."""
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
    xp = kx = None
    if record_xpoints is not None:
        xp, kx = xpoint_buffers(m, record_xpoints, dtype, dev, xpoints)
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
            chase_face = chase_face_choice(
                sd, row - base, it - reset if 0 < reset <= it else it,
                dtype, nbrs_all != -1)
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
        real_cross = crossed & ~chase
        ncross += real_cross.to(torch.int32)
        nchase += chase.to(torch.int32)
        if xp is not None:
            hit = torch.nonzero(real_cross & (kx < record_xpoints))[:, 0]
            xp[hit, kx[hit].long()] = xpoint[hit]
            kx += real_cross.to(torch.int32)
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
    records = tuple(torch.cat(c) for c in zip(*held)) if held else None
    out = dict(pos=cur, elem=(row - base).to(torch.int32), mat=mat,
               done=done, pseg=pseg, ncross=ncross, nchase=nchase, nseg=nseg,
               iters=iters, target=target, target_elem=target_elem,
               prev=prev, stuck=stuck.to(torch.int32), xp=xp, kx=kx)
    return out, records


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
    the JAX ``make_partitioned_step``. ``device_mesh`` lists
    ``partition.n_parts`` entries: torch devices, all one device (the
    parts stacked there, ``particle_sharding.make_device_mesh``), or
    entries carrying a rank and a device (``parallel/ranks.py::MeshEntry``,
    ``parallel/multihost.py::global_device_mesh``), each rank's in one
    block, in rank order: this process walks its block of parts
    (``rank_layout``), stacked on its device, and the exchange, the stop
    test and the halo fold are collectives over the default process
    group. ``partition`` holds every part's tables or just this rank's
    (``partition_mesh(parts=...)``).
    ``exchange_size`` is the emigrant rows a destination takes a round
    (default ``max(cap // (2·n_parts), 64)``, at most cap);
    ``max_rounds`` bounds the walk/exchange rounds (default ``4·n_parts +
    8``; lanes still pending then end not done). ``compact_after``,
    ``compact_size``, ``compact_stages`` and ``followup_compact_size``
    set each walk phase's crossing budgets and loop counters as the JAX
    step's compacted rounds do (module docstring); ``unroll`` and
    ``tally_scatter`` schedule the JAX arithmetic only. ``plain`` walks
    with the plain version on whatever device (the kernel's yardstick on
    the card).

    Returns ``step(cur, dest, elem, done, material_id, weight, group,
    pid, valid, flux, conv=None, capacity=None) -> PartitionedTraceResult``
    (per-slot tensors ``[n_local·cap]`` of this process's parts, ``elem``
    part-local rows; ``flux`` their slabs), or
    with ``packed_io`` ``step(record, flux, conv=None, capacity=None)``
    over the record of ``staging.pack_partitioned_record``, whose result
    carries the ``readback``. ``conv`` is ``(ConvState of [n_parts, L]
    accumulators, enable)`` with ``convergence`` (the JAX step's five
    trailing inputs: the accumulators, and the gate the facade closes for
    its initial search and re-walks), updated in place. ``capacity``
    sizes the first walk phase's record buffers on the card. With
    ``face_rate`` (``walk_cuda.face_rate`` of the partitioned mesh) a move
    sizes each later phase's buffers from
    the pending lanes' remaining paths (``walk_cuda.path_records``' rule),
    read with the round's stop test; without it a later phase has 4
    records a lane and walks again when it makes more. The flux is
    updated in place.

    ``record_xpoints=K`` records each particle's first K genuine crossing
    points of the step (the crossing into another part once, by the part
    it leaves) into per-slot buffers that start at zero each step and
    migrate with their particles in the exchange's send rows
    (``PartitionedTraceResult.xpoints``); each launch walks its slots'
    rows of them. The packed-I/O step refuses it, as JAX's does."""
    del unroll
    if packed_io and record_xpoints is not None:
        raise NotImplementedError(
            "packed_io does not carry the intersection-point buffers; use "
            "the unpacked step for record_xpoints")
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
    lay = rank_layout(devs)
    lo, hi, dev = lay.lo, lay.hi, lay.device
    P_l = hi - lo
    if partition.device != dev:
        raise ValueError(f"the partition's tables are on {partition.device}, "
                         f"this process's parts on {dev}")
    if 2 * max_local * n_groups >= 2**31:
        raise NotImplementedError(
            "flat tally keys overflow int32: max_local*n_groups*2 = "
            f"{2 * max_local * n_groups} >= 2^31; use more partitions")
    if n_parts * max_local * n_groups >= 2**31:
        raise NotImplementedError(
            "the stacked parts' bins overflow int32: n_parts*max_local*"
            f"n_groups = {n_parts * max_local * n_groups} >= 2^31")
    rounds_bound = max_rounds if max_rounds is not None else 4 * n_parts + 8
    comm = Collectives(lay)
    tables = stacked_tables(partition, (lo, hi))
    halo = (_halo_fold_rows(partition, lo, hi, n_groups)
            if partition.halo_layers else None)
    if partition.halo_layers:
        f = lo - partition.first_part
        canon = -2 - (partition.row_owner[f:f + P_l].long() * max_local
                      + partition.row_owner_local[f:f + P_l].long()).view(-1)
    else:
        canon = None
    if plain:
        walk_fn = walk_rows_plain
    else:
        from .walk_cuda import walk_rows as walk_fn
    sizing = face_rate is not None and not initial
    if sizing:
        from .walk_cuda import record_capacity
    nbins = P_l * max_local * n_groups
    walk_kw = dict(max_local=max_local, initial=initial, n_groups=n_groups,
                   score_squares=score_squares, tolerance=tolerance,
                   robust=robust)
    K = record_xpoints
    if K is not None:
        walk_kw["record_xpoints"] = K = int(K)

    def run(cur, dest, elem, done, material_id, weight, group, pid, valid,
            flux, conv=None, capacity=None):
        global ROUND_WAITS
        if convergence and conv is None:
            raise ValueError(
                "this step was built with convergence=True and needs the "
                "(ConvState, enable) pair")
        if cur.device != dev:
            raise ValueError(f"the slots are on {cur.device}, the parts on "
                             f"{dev}")
        total = cur.shape[0]
        if total % P_l:
            raise ValueError(
                f"{total} slots do not split into {P_l} parts")
        cap = total // P_l
        E = min(exchange_size if exchange_size is not None
                else max(cap // (2 * n_parts), 64), cap)
        first = normalize_compact_stages(compact_stages, compact_after,
                                         compact_size, cap, max(cap // 8, 64))
        follow = ((0, min(followup_compact_size
                          if followup_compact_size is not None
                          else max(cap // 16, 64), cap)),)
        flat = _flat_slabs(flux, P_l, max_local, n_groups)
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
        nseg = torch.zeros(P_l, dtype=torch.int64, device=dev)
        dropped = torch.zeros(P_l, dtype=torch.int64, device=dev)
        xp = kx = None
        if K is not None:  # the step's points, from zero (the JAX step's)
            xp = torch.zeros(total, K, 3, dtype=cur.dtype, device=dev)
            kx = torch.zeros(total, **i32)
        part_of = torch.arange(total, device=dev) // cap
        # Order keys in global slot numbers: it·(n_parts·cap) + slot.
        stride = n_parts * cap
        gslot0 = lo * cap

        def active():
            return valid & ~done & (target < 0)

        def walk(slots, bound, reset, it0=None, records=None,
                 cap_records=None):
            """Walk ``slots`` (sorted) for at most ``bound`` iterations;
            their tally records join ``records`` keyed as if the phase's
            iterations ``it0`` before had been this launch's. Returns the
            lanes' outputs, their parts and the lanes' state before the
            launch."""
            p = part_of[slots]
            keys = slots + gslot0
            if it0 is not None:
                keys = keys + it0.to(torch.int64) * stride
            ins = dict(cur=cur[slots], rows=(p * max_local + elem[slots]).to(
                torch.int32), mat=material_id[slots], pseg=pseg[slots],
                prev=prev[slots], stuck=stuck[slots])
            pts = {}
            if K is not None:  # the slots' rows, continued by the launch
                ins["kx"] = kx[slots]
                pts["xpoints"] = (xp[slots], ins["kx"].clone())
            out, rec = walk_fn(
                tables, ins["cur"], dest[slots], ins["rows"], weight[slots],
                group[slots], ins["mat"], ins["pseg"], ins["prev"],
                ins["stuck"], keys, flat, stride=stride,
                capacity=cap_records, max_crossings=bound, reset=reset,
                **walk_kw, **pts)
            if K is not None:
                xp[slots] = out["xp"]
                kx[slots] = out["kx"]
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
            if records is not None and rec is not None:
                records.append(rec)
            return out, p, ins

        def fold(records):
            if records:
                fold_records(flat, records, score_squares, nbins, plain)

        def walk_phase(rnd, stages, cap_records=None):
            """One walk phase in the JAX phase's schedule. Returns each
            part's iterations (the longest lane's) and, when the schedule
            has compacted rounds, what ``rounds`` needs: the phase's
            records, not yet folded, and the last launch's lanes, their
            state before it and what it added to the counters."""
            slots = torch.nonzero(active())[:, 0].contiguous()
            iters = torch.zeros(P_l, dtype=torch.int64, device=dev)
            if slots.numel() == 0:
                return iters, None
            records = []
            b0 = (max_crossings if stages is None
                  else min(stages[0][0], max_crossings))
            with _span(dev, "walk", rnd):
                if b0 >= max_crossings:  # one loop, one budget
                    out, p, _ = walk(slots, max_crossings, 0,
                                     records=records, cap_records=cap_records)
                    lane_it = out["iters"].to(torch.int64)
                    final = None
                elif len(stages) == 1:
                    # Iterations b0.. are each lane's first compacted round
                    # (a fresh count, a fresh budget): one launch.
                    mark = len(records)
                    out, p, ins = walk(slots, b0 + max_crossings, b0,
                                       records=records,
                                       cap_records=cap_records)
                    lane_it = out["iters"].to(torch.int64)
                    final = (slots, lane_it > b0, b0 + max_crossings, b0,
                             out, ins)
                else:
                    lane_it = torch.zeros(total, dtype=torch.int64,
                                          device=dev)
                    if b0 > 0:
                        out, _, _ = walk(slots, b0, 0, records=records,
                                         cap_records=cap_records)
                        lane_it[slots] = out["iters"].to(torch.int64)
                    for i, (start, size, *_r) in enumerate(stages[:-1]):
                        span = min(stages[i + 1][0], max_crossings) - start
                        sub = _first_active(active(), P_l, cap,
                                            min(cap, max(int(size), 1)))
                        if span > 0 and sub.numel():
                            out, _, _ = walk(sub, span, 0, lane_it[sub],
                                             records)
                            lane_it[sub] += out["iters"].to(torch.int64)
                    last = torch.nonzero(active())[:, 0].contiguous()
                    final, mark = None, len(records)
                    if last.numel():
                        out, _, ins = walk(last, max_crossings, 0,
                                           lane_it[last], records)
                        lane_it[last] += out["iters"].to(torch.int64)
                        final = (last, torch.ones_like(last, dtype=torch.bool),
                                 max_crossings, 0, out, ins)
                    lane_it, p = lane_it[slots], part_of[slots]
                if final is None:
                    fold(records)
            iters.scatter_reduce_(0, p, lane_it, "amax")
            if final is None:
                return iters, None
            lanes, entered, bound, cut, out, ins = final
            return iters, dict(
                slots=lanes, entered=entered,
                ran_out=entered & _ran_out(out, bound),
                S=min(cap, max(int(stages[-1][1]), 1)), iters=iters,
                records=records, cut=cut, ins=ins,
                last=mark if len(records) > mark else None,
                added={k: out[k] for k in ("ncross", "nchase", "nseg")})

        def unwalk(ph, lanes: list) -> None:
            """Lanes that the JAX rounds never take (lanes that ran out
            fill every round) keep their state from before the phase's
            last launch, walked on for its first ``cut`` iterations (the
            compacted phase's full-width ones), as the JAX step leaves
            them: their state goes back to the launch's inputs, what the
            launch added to the counters comes off, the launch's records
            of their later iterations are dropped, and the first ``cut``
            iterations walk again, their records not kept (the launch's
            are). Their recorded points go back to the launch's count,
            the rows past it to zero."""
            sl = torch.as_tensor(lanes, dtype=torch.int64, device=dev)
            at = torch.searchsorted(ph["slots"], sl)
            ins, added, cut = ph["ins"], ph["added"], ph["cut"]
            if ph["last"] is not None:  # the last launch's records
                bins, order, c = ph["records"][ph["last"]]
                drop = (torch.isin(order % stride, sl + gslot0)
                        & (order // stride >= cut))
                ph["records"][ph["last"]] = (bins[~drop], order[~drop],
                                             c[~drop])
            cur[sl] = ins["cur"][at]
            elem[sl] = (ins["rows"][at].long()
                        - part_of[sl] * max_local).to(torch.int32)
            material_id[sl] = ins["mat"][at]
            pseg[sl] = ins["pseg"][at]
            prev[sl] = ins["prev"][at]
            stuck[sl] = ins["stuck"][at]
            done[sl] = False
            target[sl] = -1
            target_elem[sl] = 0
            if K is not None:
                k0 = ins["kx"][at]
                kx[sl] = k0
                keep = torch.arange(K, device=dev)[None, :] < k0[:, None]
                xp[sl] = torch.where(keep[..., None], xp[sl], 0.0)
            ncross[sl] -= added["ncross"][at]
            nchase[sl] -= added["nchase"][at]
            nseg.index_add_(0, part_of[sl],
                            -added["nseg"][at].to(torch.int64))
            if cut:
                walk(sl, cut, 0)

        def rounds(ph):
            """The JAX phase's later compacted rounds, for lanes that ran
            out of budget in their first: up to ceil(cap/S) + 1 rounds a
            part, each taking its first S active lanes in slot order; a
            lane walks again (a fresh budget and count) in each round that
            takes it after its first. One launch a round that takes such
            a lane; its records fold after the phase's, in round order."""
            global BUDGET_RELAUNCHES, BUDGET_LANES, BUDGET_STARVED
            S = ph["S"]
            sl = ph["slots"][ph["entered"]].cpu().numpy()
            ran_out = ph["ran_out"][ph["entered"]].cpu().numpy()
            part = sl // cap
            queues = [sl[part == q] for q in range(P_l)]
            again = [set(sl[(part == q) & ran_out].tolist())
                     for q in range(P_l)]
            seen = [set() for _ in range(P_l)]
            later = []
            for _ in range(-(-cap // S) + 1):
                if not any(qu.size for qu in queues):
                    break
                taken = [qu[:S] for qu in queues]
                need = [s for q in range(P_l) for s in taken[q].tolist()
                        if s in seen[q]]
                for q in range(P_l):
                    seen[q].update(taken[q].tolist())
                if need:
                    BUDGET_RELAUNCHES += 1
                    BUDGET_LANES += len(need)
                    sub = torch.as_tensor(need, dtype=torch.int64,
                                          device=dev)
                    later.append([])
                    out, p, _ = walk(sub, max_crossings, 0,
                                     records=later[-1])
                    ph["iters"].scatter_reduce_(
                        0, p, out["iters"].to(torch.int64), "amax")
                    still = _ran_out(out, max_crossings).tolist()
                    for s, st in zip(need, still):
                        if not st:
                            again[s // cap].discard(s)
                for q in range(P_l):
                    keep = np.asarray([s in again[q]
                                       for s in taken[q].tolist()], bool)
                    queues[q] = np.concatenate(
                        [taken[q][keep], queues[q][len(taken[q]):]])
            starved = sorted(s for qu, se in zip(queues, seen)
                             for s in qu.tolist() if s not in se)
            if starved:
                BUDGET_STARVED += len(starved)
                unwalk(ph, starved)
            fold(ph["records"])
            for recs in later:
                fold(recs)

        def exchange(rnd):
            with _span(dev, "exchange", rnd):
                return _exchange(comm, n_parts, lo, P_l, cap, E, max_local,
                                 canon, state, dropped)

        state = dict(cur=cur, dest=dest, weight=weight, pseg=pseg, pid=pid,
                     group=group, material_id=material_id, elem=elem,
                     done=done, valid=valid, target=target,
                     target_elem=target_elem, prev=prev, stuck=stuck,
                     xp=xp, kx=kx)
        w0, ph = walk_phase(0, first, capacity)
        round_stats = torch.zeros(P_l, 6, rounds_bound,
                                  dtype=torch.int64, device=dev)

        def settle(ph, col, later_rounds: bool) -> None:
            """Fold a phase with compacted rounds: its later rounds first
            when lanes ran out (its iterations in ``round_stats``; the
            first phase's are ``w0`` itself)."""
            with _span(dev, "walk", 0 if col is None else col + 1):
                if later_rounds:
                    rounds(ph)
                else:
                    fold(ph["records"])
            if later_rounds and col is not None:
                round_stats[:, 5, col] = ph["iters"]

        rnd = 0
        while True:
            col = rnd - 1 if rnd else None
            if rnd >= rounds_bound:
                if ph is not None:
                    settle(ph, col, bool(ph["ran_out"].any()))
                break
            ROUND_WAITS += 1
            n_pend, path, n_out, mine_out = comm.stop_test(
                valid & (target >= 0), cur, dest,
                None if ph is None else ph["ran_out"], sizing)
            if ph is not None:
                settle(ph, col, mine_out > 0)
                ph = None
            if n_out:
                ROUND_WAITS += 1
                n_pend, path, _, _ = comm.stop_test(
                    valid & (target >= 0), cur, dest, None, sizing)
            if not n_pend:
                break
            records = (record_capacity(n_pend, n_pend + face_rate * path)
                       if sizing else None)
            ex = exchange(rnd + 1)
            w, ph = walk_phase(rnd + 1, follow, records)
            round_stats[:, :5, rnd] = ex
            round_stats[:, 5, rnd] = w
            rnd += 1
        if halo is not None:
            with _span(dev, "halo", rnd):
                _fold_halo(comm, flat, halo, P_l, max_local, n_groups)
        i64 = torch.int64
        ivec = cvec = None
        if integrity:
            # PART_INTEGRITY_FIELDS: non-finite or negative entries of the
            # part's slab (the accumulator a bit flip poisons) and its
            # slot accounting, after the halo fold.
            slab = flat.view(P_l, -1)
            vp = valid.view(P_l, cap)
            ivec = torch.stack([
                (~torch.isfinite(slab) | (slab < 0)).sum(1, dtype=i64),
                vp.sum(1, dtype=i64),
                (vp & done.view(P_l, cap)).sum(1, dtype=i64)], dim=1)
        if convergence:
            # After the halo fold: the even entries read are the parts'
            # complete owned scores (halo rows are zero).
            cstate, enable = conv
            cvec = fold_and_reduce(flat.view(P_l, -1), cstate,
                                   batch_moves=batch_moves,
                                   rel_err_target=rel_err_target,
                                   enable=bool(enable))
        nc = ncross.view(P_l, cap)
        zero = torch.zeros(P_l, dtype=i64, device=dev)
        stats = torch.stack([
            nc.sum(1, dtype=i64), nc.amax(1).to(i64),
            nchase.view(P_l, cap).sum(1, dtype=i64),
            (valid & ~done).view(P_l, cap).sum(1, dtype=i64),
            zero, zero, nseg, w0 + round_stats[:, 5].sum(1),
        ], dim=1)
        return PartitionedTraceResult(
            position=cur, dest=dest, elem=elem, material_id=material_id,
            weight=weight, group=group, particle_id=pid, valid=valid,
            done=done, flux=flux, n_segments=nseg,
            n_rounds=torch.full((P_l,), rnd, dtype=i64, device=dev),
            n_dropped=dropped, track_length=pseg, round_stats=round_stats,
            stats=stats, integrity=ivec, convergence=cvec, xpoints=xp,
            n_xpoints=kx)

    if not packed_io:
        return run

    from .staging import pack_partitioned_readback, unpack_partitioned_record

    def packed(record, flux, conv=None, capacity=None):
        res = run(*unpack_partitioned_record(record), flux, conv=conv,
                  capacity=capacity)
        res.readback = pack_partitioned_readback(res, P_l)
        return res

    return packed


# ---------------------------------------------------------------------- #
# The partitioned megastep: K device-sourced moves over the stacked parts.
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class PartitionedMegastepResult:
    """Outputs of one partitioned megastep chunk. The per-slot state
    (``[n_parts·cap]``) stays on the device for the next chunk; the flux
    and ``prev_even`` are updated in place; ``readback``
    (``staging.pack_partitioned_megastep_tail``: each part's stats,
    rounds, drops and segments, integrity counters and convergence
    summary, and the physics vector) is what the host copies."""

    position: torch.Tensor
    dest: torch.Tensor
    elem: torch.Tensor
    material_id: torch.Tensor
    weight: torch.Tensor
    group: torch.Tensor
    particle_id: torch.Tensor
    valid: torch.Tensor
    alive: torch.Tensor
    flux: torch.Tensor
    readback: torch.Tensor
    prev_even: torch.Tensor | None = None


def make_partitioned_megastep(
    device_mesh,
    partition,
    *,
    n_moves: int,
    n_total: int,
    n_groups: int,
    class_local,
    sigma_t,
    absorb_t,
    eps_near: float,
    survival_weight: float,
    downscatter: float,
    dtype,
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
    integrity: bool = False,
    convergence: bool = False,
    rel_err_target: float = 0.05,
    batch_moves: int = 1,
    plain: bool = False,
    face_rate: float | None = None,
):
    """The partitioned megastep, counterpart of the JAX
    ``make_partitioned_megastep`` (``walk_partitioned.py:1260-1521``):
    ``n_moves`` complete moves a call, each the re-source keyed by
    (seed, move, particle id), the partitioned step (walk phases,
    exchanges, halo fold) and the collision and termination physics.

    ``device_mesh`` is the step's: the parts stacked in this process, or
    spread over the ranks of the default process group, each rank
    keeping its parts' slot state and per-part tail; the physics sums
    are per-part partial sums, gathered over the ranks at the end of a
    call (``Collectives.part_rows``) and added in part order, so the
    megastep over ranks gives the stacked one's bits.

    The JAX builder takes the per-row Σt and absorption values; here
    ``class_local`` (``[n_parts, max_local]`` region ids of the stacked
    rows, clipped into the tables; a process over ranks reads its
    parts' block) and the region tables ``sigma_t`` / ``absorb_t`` (host float64) give the same values, looked up by the
    flight kernel (``source_cuda.sample_flight`` with ``cap`` and
    ``max_local``: ``csrc/source.cu``) and by ``source.lane_sigma``.
    ``n_total`` is the particle count (the random stream's width). The
    other knobs are the step's (``make_partitioned_step``); ``plain``
    runs the plain flight and the plain walk (the kernels' yardstick on
    the card), ``face_rate`` sizes the later walk phases' record buffers.

    Returns ``mega(cur, elem, material_id, weight, group, pid, valid,
    alive, flux, move0, rng_key, conv=None, prev_even=None,
    capacity=None, draws=None) -> PartitionedMegastepResult``: per-slot
    tensors ``[n_local·cap]`` of this process's parts (and their slabs,
    accumulators and draws), ``move0`` the facade's move counter (a
    host int: each move's key reaches the kernel as two arguments),
    ``rng_key`` the seed's key words (``source.prng_key``), ``conv`` the
    ``[n_parts, L]`` ConvState (folded once a fused move), ``prev_even``
    the sd_mode="batch" snapshot, ``capacity`` the first walk phase's
    record buffers of each move on the card, ``draws`` a sequence of
    ``(direction, ell, coll_u, roul_u)`` per fused move in place of the
    sampling (a test feeds the JAX draws).

    The moves are a host loop: the K moves make the launches of K calls
    of one move, and each move's step keeps its per-round host reads
    (``ROUND_WAITS``). As in the JAX body, a lane that walks keeps its
    slot's collision and roulette draws: the physics reads the draws of
    the slot, and a slot an immigrant took holds the draws of its
    previous occupant. The alive flag needs no payload: dead lanes never
    walk (they start done), so never change slots, and every immigrant
    was walking: after the step, ``alive = valid & (pid changed or
    alive)``."""
    from ..core.tally import accumulate_batch_squares
    from ..integrity.invariants import PART_INTEGRITY_LEN
    from ..obs.walk_stats import WALK_STATS_FIELDS, WALK_STATS_LEN
    from . import source_cuda
    from .source import (
        MEGA_PHYS_LEN,
        apply_physics,
        flight_dest,
        fold_in,
        lane_sigma,
        sample_flight_plain,
    )
    from .staging import pack_partitioned_megastep_tail

    lay = rank_layout(device_mesh)
    P_l = lay.hi - lay.lo
    step = make_partitioned_step(
        device_mesh, partition, n_groups=n_groups, initial=False,
        max_crossings=max_crossings, max_rounds=max_rounds,
        exchange_size=exchange_size, tolerance=tolerance,
        score_squares=score_squares, unroll=unroll,
        compact_after=compact_after, compact_size=compact_size,
        compact_stages=compact_stages,
        followup_compact_size=followup_compact_size, robust=robust,
        tally_scatter=tally_scatter, integrity=integrity,
        convergence=convergence, rel_err_target=rel_err_target,
        batch_moves=batch_moves, plain=plain, face_rate=face_rate)
    n_parts, max_local = partition.n_parts, partition.max_local
    dev = partition.device
    cls = np.asarray(class_local, np.int32).reshape(-1)
    if cls.shape[0] != n_parts * max_local:
        raise ValueError(
            f"class_local must have {n_parts}×{max_local} rows, got "
            f"{cls.shape[0]}")
    cls = torch.as_tensor(cls[lay.lo * max_local:lay.hi * max_local],
                          device=dev)
    comm = Collectives(lay)
    sig = torch.as_tensor(np.asarray(sigma_t, np.float64), dtype=dtype,
                          device=dev)
    ab = torch.as_tensor(np.asarray(absorb_t, np.float64), dtype=dtype,
                         device=dev)
    sample = sample_flight_plain if plain else source_cuda.sample_flight
    phys_kw = dict(eps_near=eps_near, survival_weight=survival_weight,
                   downscatter=downscatter, n_groups=n_groups)
    i64 = torch.int64
    max_cross = WALK_STATS_FIELDS.index("max_crossings")

    def mega(cur, elem, material_id, weight, group, pid, valid, alive, flux,
             move0: int, rng_key, conv=None, prev_even=None, capacity=None,
             draws=None):
        cap = cur.shape[0] // P_l
        sacc = torch.zeros(P_l, WALK_STATS_LEN, dtype=i64, device=dev)
        iacc = (torch.zeros(P_l, PART_INTEGRITY_LEN, dtype=i64,
                            device=dev) if integrity else None)
        cvec = None
        # Each local part's physics sums over the chunk (the alive count
        # the last move's): gathered over the ranks after the last move
        # and added in part order, so the stacked megastep and the
        # megastep over ranks give the same bits.
        pacc = torch.zeros(P_l, MEGA_PHYS_LEN, dtype=cur.dtype, device=dev)
        rounds, dropped, nseg = (torch.zeros(P_l, dtype=i64, device=dev)
                                 for _ in range(3))
        alive = alive.to(torch.bool)
        dest, mat = cur, material_id
        for k in range(n_moves):
            go = valid & alive
            if draws is None:
                dest, coll_u, roul_u = sample(
                    fold_in(rng_key, move0 + k), pid, n_total, elem, go, cur,
                    cls, sig, cap=cap, max_local=max_local)
            else:
                direction, ell, coll_u, roul_u = draws[k]
                dest = flight_dest(cur, direction, ell,
                                   lane_sigma(cls, elem, sig, cap, max_local),
                                   go)
            res = step(cur, dest, elem, ~go, mat, weight, group, pid, valid,
                       flux, conv=None if conv is None else (conv, True),
                       capacity=capacity)
            alive_w = res.valid & torch.where(res.particle_id != pid, True,
                                              alive)
            absorb = lane_sigma(cls, res.elem, ab, cap, max_local)
            weight2, group2, alive2, phys4 = apply_physics(
                res.position, res.dest, res.done, res.material_id,
                res.weight, res.group, alive_w, absorb, coll_u, roul_u,
                parts=P_l, **phys_kw)
            if prev_even is not None:
                accumulate_batch_squares(flux.view(-1), prev_even)
            # Sums everywhere, the max of max_crossings (JAX :1424-1427).
            s2 = sacc + res.stats
            s2[:, max_cross] = torch.maximum(sacc[:, max_cross],
                                             res.stats[:, max_cross])
            sacc = s2
            if iacc is not None:
                # bad_flux is the last move's (the final accumulator); the
                # slot counts add (JAX :1433-1436).
                iacc = torch.cat([res.integrity[:, :1],
                                  iacc[:, 1:] + res.integrity[:, 1:]], 1)
            if conv is not None:
                cvec = res.convergence
            n_trunc = (alive_w & ~res.done).view(P_l, cap).sum(1).to(
                cur.dtype)
            pacc = torch.cat([pacc[:, :4] + phys4,
                              alive2.view(P_l, cap).sum(1).to(
                                  cur.dtype)[:, None],
                              (pacc[:, 5] + n_trunc)[:, None]], 1)
            rounds = rounds + res.n_rounds
            dropped = dropped + res.n_dropped
            nseg = nseg + res.n_segments
            cur, dest, elem, mat = (res.position, res.dest, res.elem,
                                    res.material_id)
            weight, group, pid, valid = (weight2, group2, res.particle_id,
                                         res.valid)
            alive = alive2
        rows = comm.part_rows(pacc, n_parts)
        phys = rows[0]
        for p in range(1, n_parts):
            phys = phys + rows[p]
        readback = pack_partitioned_megastep_tail(
            sacc, rounds, dropped, nseg, iacc, cvec, phys, cur.dtype)
        return PartitionedMegastepResult(
            position=cur, dest=dest, elem=elem, material_id=mat,
            weight=weight, group=group, particle_id=pid, valid=valid,
            alive=alive, flux=flux, readback=readback, prev_even=prev_even)

    return mega


class Collectives:
    """The step's collectives over the ranks of a ``RankLayout``: the
    all_to_all of the exchange and of the halo fold, and the stop test's
    all_reduce, on the default process group (NCCL for CUDA tensors,
    gloo for CPU ones). Without ranks the all_to_all hands back its input
    and the all_reduce sums one row, so the stacked step and the step
    over ranks are one code path."""

    def __init__(self, layout: RankLayout):
        self.layout = layout

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """``send`` ``[n_local, n_parts, ...]`` (block ``[p, d]`` from
        local part p to part d) → ``[n_parts, n_local, ...]`` (block
        ``[p, q]`` from part p to local part q): one
        ``all_to_all_single``."""
        bounds = self.layout.bounds
        if bounds is None:
            return send
        import torch.distributed as dist

        n_local, tail = send.shape[0], send.shape[2:]
        chunks = [send[:, a:b].reshape(-1) for a, b in bounds]
        inp = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
        row = n_local * int(np.prod(tail, dtype=np.int64))
        out_sizes = [(b - a) * row for a, b in bounds]
        out = torch.empty(sum(out_sizes), dtype=send.dtype,
                          device=send.device)
        dist.all_to_all_single(out, inp.contiguous(), out_sizes,
                               [c.numel() for c in chunks])
        return out.view(-1, n_local, *tail)

    def part_rows(self, rows: torch.Tensor, n_parts: int) -> torch.Tensor:
        """Every part's row of a per-part tensor (``rows`` this process's
        ``[n_local, ...]``) as ``[n_parts, ...]`` on every rank: one
        all_reduce of the rows placed among zeros (adding zeros keeps
        every bit); the rows themselves without ranks."""
        if self.layout.bounds is None:
            return rows
        import torch.distributed as dist

        full = torch.zeros((n_parts,) + tuple(rows.shape[1:]),
                           dtype=rows.dtype, device=rows.device)
        full[self.layout.lo:self.layout.hi] = rows
        dist.all_reduce(full)
        return full

    def stop_test(self, pend, cur, dest, ran_out, sizing: bool) -> tuple:
        """One host read a round: (the pending lanes of every rank, the
        sum of their remaining paths |dest − cur| when ``sizing``, the
        lanes of every rank that ran out of budget in a phase with later
        rounds, this rank's such lanes). The pending lanes and paths are
        an upper estimate of the next phase's lanes and paths (overflow
        stays pending; a lane freezes again at the next cut)."""
        f64 = torch.float64
        zero = torch.zeros((), dtype=f64, device=cur.device)
        path = (torch.where(pend, _norm3(dest - cur), 0.0).sum(dtype=f64)
                if sizing else zero)
        out = zero if ran_out is None else ran_out.sum(dtype=f64)
        vec = torch.stack([pend.sum(dtype=f64), path, out])
        bounds = self.layout.bounds
        if bounds is None:
            rows = vec[None]
        else:
            import torch.distributed as dist

            rows = torch.zeros(len(bounds), 3, dtype=f64, device=cur.device)
            rows[self.layout.rank] = vec
            dist.all_reduce(rows)
        vals = rows.tolist()
        n, p, o = (sum(v[k] for v in vals) for k in range(3))
        return int(n), p, int(o), int(vals[0 if bounds is None
                                           else self.layout.rank][2])


def _ran_out(out: dict, bound: int) -> torch.Tensor:
    """The lanes of a walk's outputs that stopped at its budget: neither
    done nor frozen at a cut after ``bound`` iterations."""
    return ~out["done"] & (out["target"] < 0) & (out["iters"] >= bound)


def _first_active(active, n_local: int, cap: int, size: int):
    """Each part's first ``size`` active slots, in slot order."""
    m = active.view(n_local, cap)
    return torch.nonzero((m & (_row_ranks(m) < size)).view(-1))[:, 0]


def fold_records(flat, records: list, score_squares: bool, nbins: int,
                 plain: bool) -> None:
    """A phase's tally records, from one launch or several, folded into
    the stacked slab in one ordered scatter (bins in key order)."""
    bins, orders, cs = (x[0] if len(x) == 1 else torch.cat(x)
                        for x in zip(*records))
    if plain or flat.device.type == "cpu":
        scatter_ordered_plain(flat, bins, orders, cs, score_squares)
    else:
        from .scatter import ordered_cuda

        ordered_cuda(flat, bins, orders, cs, score_squares, nbins)


def _row_ranks(mask: torch.Tensor) -> torch.Tensor:
    """Each True entry's rank among its row's True entries ([R, C] bool →
    int64; other entries meaningless): one scan over the flattened mask
    less each row's start (a scan along the last axis of a few long rows
    is a slow kernel on the card, a 1-D scan a fast one)."""
    c = torch.cumsum(mask.reshape(-1), 0).view(mask.shape)
    start = torch.cat([c.new_zeros(1), c[:-1, -1]])
    return c - start[:, None] - 1


def _exchange(comm, P, lo, P_l, cap, E, max_local, canon, s, dropped):
    """One exchange round over this process's slot state ``s`` (updated
    in place): bucket, send blocks, all_to_all, adopt. The send blocks'
    float columns (_F_COLS, then 3K point columns when ``s["xp"]`` holds
    recorded points) and int columns (_I_COLS and the point count, or
    padding, 8) share one byte buffer, so a round is one collective; an
    adopted lane takes its points and count into its slot, a sent slot
    keeps its old ones (it is free). Returns the [P_l, 5] int64 round
    stats (pending, sent, received, free, adopted)."""
    dev = s["cur"].device
    valid, target = s["valid"], s["target"]
    emig = (valid & (target >= 0)).view(P_l, cap)
    tgt = target.view(P_l, cap)
    slot = torch.full((P_l, cap), P * E, dtype=torch.int64, device=dev)
    sendable = torch.zeros(P_l, cap, dtype=torch.bool, device=dev)
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
        back = -2 - ((lo + sp) * max_local + elem)
    else:
        back = canon[sp * max_local + elem]
    back = torch.where(s["stuck"][src] >= 4, -1, back)
    dtype = s["cur"].dtype
    xp = s["xp"]
    K3 = 0 if xp is None else 3 * xp.shape[1]
    fb = (_F_COLS + K3) * torch.finfo(dtype).bits // 8
    buf = torch.zeros(P_l * P * E, fb + 4 * 8, dtype=torch.uint8,
                      device=dev)
    global SEND_BYTES
    SEND_BYTES = max(SEND_BYTES, buf.numel())
    fbuf, ibuf = buf[:, :fb].view(dtype), buf[:, fb:].view(torch.int32)
    f_cols = [s["cur"][src], s["dest"][src], s["weight"][src][:, None],
              s["pseg"][src][:, None]]
    i_cols = [s["pid"][src], s["group"][src], s["material_id"][src],
              s["target_elem"][src], torch.ones_like(s["pid"][src]),
              s["done"][src].to(torch.int32), back.to(torch.int32)]
    if xp is not None:
        f_cols.append(xp[src].view(-1, K3))
        i_cols.append(s["kx"][src])
    fbuf[dst] = torch.cat(f_cols, 1)
    ibuf[dst, :len(i_cols)] = torch.stack(i_cols, 1)
    valid[src] = False
    target[src] = -1
    # The JAX step's all_to_all: block d of sender p goes to part d.
    recv = comm.all_to_all(buf.view(P_l, P, E, -1)).transpose(0, 1)
    recv = recv.reshape(P_l, P * E, -1)
    recv_f, recv_i = recv[..., :fb].view(dtype), recv[..., fb:].view(
        torch.int32)
    mine = recv_i[:, :, 4] == 1
    free = ~valid.view(P_l, cap)
    n_mine, n_free = mine.sum(1), free.sum(1)
    take = torch.minimum(n_mine, n_free)
    dropped += (n_mine - n_free).clamp_min(0)
    # The i-th immigrant row into the i-th free slot.
    rank_src = _row_ranks(mine)
    rank_free = _row_ranks(free)
    qf, kf = torch.nonzero(free, as_tuple=True)
    free_at = torch.full((P_l, cap), cap, dtype=torch.int64, device=dev)
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
    if xp is not None:
        xp[at] = rf[:, _F_COLS:].reshape(-1, K3 // 3, 3)
        s["kx"][at] = ri[:, _I_COLS]
    valid[at] = True
    i64 = torch.int64
    return torch.stack([emig.sum(1, dtype=i64), sendable.sum(1, dtype=i64),
                        n_mine.to(i64), n_free.to(i64), take.to(i64)], 1)


def _halo_fold_rows(partition, lo: int, hi: int, n_groups: int) -> dict:
    """The halo fold's tables for parts ``lo`` to ``hi``, int64 on the
    partition's device: ``send`` [P_l, P, Eh] the local rows each local
    part sends each owner (-1 padding), ``pairs`` per sending part p (the
    received rows' places in the all_to_all's output, the local owners'
    rows), one-to-one, and ``owned`` the local parts' owned rows."""
    P, L, f = partition.n_parts, partition.max_local, partition.first_part
    P_l = hi - lo
    send = partition.halo_send_rows[lo - f:hi - f].cpu().numpy().astype(
        np.int64)
    recv = partition.halo_recv_rows[lo - f:hi - f].cpu().numpy().astype(
        np.int64)
    Eh = send.shape[2]
    local = np.arange(P_l)[:, None, None] * L + send
    send_rows = np.where(send < L, local, -1)
    pairs = []
    for p in range(P):
        at, dst = [], []
        for q in range(P_l):
            ok = np.nonzero(recv[q, p] < L)[0]
            at.append((p * P_l + q) * Eh + ok)
            dst.append(q * L + recv[q, p][ok])
        pairs.append(tuple(torch.from_numpy(np.concatenate(a)).to(
            partition.device) for a in (at, dst)))
    owned = torch.from_numpy(
        np.arange(L)[None, :] < partition.counts[lo:hi, None]).reshape(-1)
    return dict(send=torch.from_numpy(send_rows).to(partition.device),
                pairs=pairs, owned=owned.to(partition.device))


def _fold_halo(comm, flat, halo, P_l, L, G):
    """Guest scores onto their owners' rows, then the halo rows zeroed:
    the guest rows go to their owners in one all_to_all (the JAX step's,
    :1011-1027), then one ``index_add_`` a sending part, in part order,
    so each owned row adds its guests' scores in the stacked order."""
    flux2 = flat.view(P_l * L, 2 * G)
    rows = halo["send"]
    sent = torch.where((rows >= 0)[..., None], flux2[rows.clamp_min(0)],
                       0.0)
    got = comm.all_to_all(sent).reshape(-1, 2 * G)
    flux2.masked_fill_(~halo["owned"][:, None], 0.0)
    for at, dst in halo["pairs"]:
        if dst.numel():
            flux2.index_add_(0, dst, got[at])


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
    """Host particle arrays into the slot layout: ``fields`` (name →
    [n, ...] host array; 'origin' and 'dest' at least) as
    ``[n_local·cap, ...]`` tensors of this process's parts
    (``rank_layout``: every part without ranks) on their device, plus
    'valid', 'particle_id' (-1 in empty slots) and 'elem' (part-local
    rows). ``cap`` slots a part (default n). A ``device_mesh`` of None
    places every part on the partition's device."""
    lay = (RankLayout(0, partition.n_parts, partition.device)
           if device_mesh is None else rank_layout(device_mesh))
    slot_of, cap = slot_layout(partition, global_elem, cap)
    n = slot_of.shape[0]
    total = partition.n_parts * cap
    mine = slice(lay.lo * cap, lay.hi * cap)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a[mine])).to(
            lay.device)

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


def gather_parts(arrays: dict, device_mesh) -> dict:
    """Per-part host arrays (name → numpy, leading axis this process's
    parts or slots) of every process of a mesh over ranks, concatenated
    in part order on every rank (``all_gather_object``); unchanged when
    the mesh names no ranks."""
    if rank_layout(device_mesh).bounds is None:
        return arrays
    import torch.distributed as dist

    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, arrays)
    return {k: np.concatenate([g[k] for g in got]) for k in arrays}


def collect_by_particle_id(result, n: int, partition=None,
                           device_mesh=None) -> dict:
    """Per-particle outputs back in host particle order (numpy): position,
    material_id, done, elem (the row on the part holding the particle),
    weight, group, track_length, and with recorded points xpoints and
    n_xpoints; with ``partition`` also ``elem_global`` (through the
    holding part's local2global). With a ``device_mesh`` over ranks every
    rank's slots are gathered first (``gather_parts``), so every rank gets
    every particle."""
    names = ("particle_id", "valid", "position", "material_id", "done",
             "elem", "weight", "group", "track_length")
    if result.xpoints is not None:
        names += ("xpoints", "n_xpoints")
    host = {k: getattr(result, k).cpu().numpy() for k in names}
    if device_mesh is not None:
        host = gather_parts(host, device_mesh)
    pid, valid = host["particle_id"], host["valid"]
    sel = valid & (pid >= 0)
    idx = pid[sel]
    out = {}
    for name in names[2:]:
        arr = host[name]
        buf = np.zeros((n,) + arr.shape[1:], arr.dtype)
        buf[idx] = arr[sel]
        out[name] = buf
    if partition is not None:
        cap = pid.shape[0] // partition.n_parts
        chip = (np.arange(pid.shape[0]) // cap)[sel]
        eg = partition.local2global[chip, host["elem"][sel]]
        buf = np.full(n, -1, np.int64)
        buf[idx] = eg
        out["elem_global"] = buf
    return out
