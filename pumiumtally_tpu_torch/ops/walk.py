"""The walk: advance every particle to its destination through the tet
mesh, scoring track-length flux along the way (plain PyTorch version).

Counterpart of the flat loop of
``pumiumtally_tpu/ops/walk.py::trace_impl`` (its crossing body). Each
iteration is one element-boundary crossing for every lane that is not yet
done: gather the geo20 row of the lane's element (or, for a mesh without
geo20, its face planes, neighbors and class tables: the JAX body's
four-gather layout), find the exit face,
score ``(w·len, (w·len)²)`` into the flat ``[ntet·G·2]`` flux, apply the
boundary conditions (destination reached, domain exit, material stop) and
hop to the neighbor. With ``robust`` the walk also masks the entry face,
runs the relocation chase and the escalated bump (the JAX module
docstring's "Degeneracy robustness").

This is the plain version of the CUDA kernel ``csrc/walk.cu``: on the CPU
it is what the facade runs (``ops/walk_cuda.trace`` sends CPU tensors
here), on the card it is only the kernel's yardstick. It writes every
product and sum in the order the kernel computes it, so that the kernel,
built without FMA contraction, agrees with it lane by lane. The flux is
updated in place (the JAX walk donates it) and returned. Each bin gets its
adds in (iteration, lane) order, the JAX walk's scatter-add order, through
``scatter_ordered_plain`` (keyed ``iteration · n + lane``), on the card as
on the CPU, so the flux is reproducible bit for bit.

Two feature tails ride the loop, as in the JAX walk. ``record_xpoints=K``
records each lane's first K genuine boundary crossings (``crossed`` and
not a relocation-chase hop) into ``[n, K, 3]`` points, counting past K;
``xpoints`` continues given buffers, so a re-walk appends after the
attempt before it. ``debug_checks`` evaluates the JAX walk's checkify
invariants (the four in-loop checks and the post-loop track-length
check, with its bounds and messages) into an error word whose lowest set
bit is raised as ``WalkInvariantError`` after the walk, before any score
reaches the flux.

With ``integrity`` the walk also returns the conservation vector of
``integrity/invariants.py`` (``integrity_vector``: end-of-walk reductions
over the per-lane outputs and the flux, in torch ops, after the walk's
scores reached the flux); the plain walk and ``walk_cuda.trace`` share
that one definition. The flux math is the same with it on or off.

Straggler compaction, loop unrolling and the scatter/gather strategy knobs
of the JAX walk only schedule the same arithmetic; they have no
counterpart here. The kernel schedules lanes its own way (each thread
walks lane after lane, in element order); ``trace_records`` walks any
subset of a move's lanes into records keyed by each lane's own index, so
a schedule's result can be checked against the one-shot walk.
"""
from __future__ import annotations

import dataclasses

import torch

from ..integrity.invariants import IIDX, INTEGRITY_LEN
from ..obs.convergence import fold_and_reduce
from ..obs.walk_stats import WALK_STATS_FIELDS
from .geometry import argmax4, exit_face
from .scatter import scatter_ordered_plain
from .staging import pack_trace_readback, unpack_move_record


def chase_face_choice(sd, elem, it: int, dtype, interior):
    """Stochastic visibility-walk face choice for the relocation chase: the
    face the point violates most, scaled by per-face weights hashed from
    (element, iteration), boundary faces excluded while any interior face
    exists.

    The JAX walk hashes ``elem*int32(-1640531527) + it*int32(40503)`` with
    int32 wraparound and uses bits 0..7 only; int64 arithmetic gives the
    same low bits without overflow."""
    h = elem.to(torch.int64) * -1640531527 + it * 40503
    shifts = torch.arange(0, 8, 2, device=elem.device)
    wf = 1.0 + ((h[:, None] >> shifts) & 3).to(dtype) * 0.125
    big = torch.finfo(dtype).max
    any_interior = interior.any(dim=-1, keepdim=True)
    score = torch.where(interior | ~any_interior, sd * wf, -big)
    return argmax4(score)


def _exp2i(k: torch.Tensor, dtype) -> torch.Tensor:
    """2**k as ``dtype`` for small non-negative integer k, assembled from
    the float's exponent bits."""
    if dtype == torch.float32:
        return ((k.to(torch.int32) + 127) << 23).view(torch.float32)
    if dtype == torch.float64:
        return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)
    raise ValueError(f"unsupported walk dtype {dtype}")


def escalated_bump(stuck, contained, continuing, t_step, tol_floor,
                   tol_eff, cur, dnorm):
    """Doubling forward bump for zero-progress crossings: a continuing
    particle advances at least ~32 ulps per crossing, doubling per
    consecutive zero-progress crossing up to the walk tolerance. Returns
    (extra_t, stuck_next)."""
    scale1 = 1.0 + cur.abs().amax(dim=-1)
    nudge0 = 4.0 * tol_floor * scale1 / torch.where(dnorm > 0, dnorm, 1.0)
    nudge_t = torch.minimum(
        nudge0 * _exp2i(stuck, cur.dtype), torch.maximum(tol_eff, nudge0)
    )
    zero_step = continuing & (t_step < nudge0) & ~contained
    stuck_next = torch.where(
        zero_step,
        torch.clamp_max(stuck + 1, 48),
        torch.where(continuing, 0, stuck),
    )
    extra = torch.clamp_min(nudge_t - t_step, 0.0)
    return extra, stuck_next


class WalkInvariantError(RuntimeError):
    """A walk invariant failed under ``debug_checks``
    (``TallyConfig.checkify_invariants``); the message is the JAX walk's
    checkify message."""


# The walk's invariant checks in their precedence: bit k of an error word
# is CHECKS[k], and the lowest set bit is the one raised, so the message
# does not depend on which lane or thread found its violation first. The
# order is the JAX walk's order within one iteration
# (pumiumtally_tpu/ops/walk.py, trace_impl).
CHECKS = (
    "particle position outside its parent element "
    "(corrupted walk state or degenerate geometry)",
    "non-finite intersection point in walk",
    "element id out of range after hop",
    "negative or non-finite tally contribution",
    "scored track length disagrees with net displacement "
    "(missed or double-scored segment)",
)
TRACK_CHECK = len(CHECKS) - 1  # the post-loop check's bit


def raise_on_violation(bits: int) -> None:
    """Raise ``WalkInvariantError`` for the lowest set bit of ``bits``."""
    if bits:
        raise WalkInvariantError(CHECKS[(bits & -bits).bit_length() - 1])


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1])
                      + v[:, 2] * v[:, 2])


def track_length_violated(position, origin, dest, track, n_iters,
                          tolerance: float) -> torch.Tensor:
    """The post-loop check of ``debug_checks``: a [] bool tensor, True
    where some lane's scored track length differs from its net
    displacement by more than the JAX walk's bound, ``(n_iters + 1) ·
    (tolerance + 64·tol_floor·(1 + max(|origin|, |dist|) + |ray|))``, with
    ``n_iters`` the walk's iteration count (the most any lane ran)."""
    dtype = origin.dtype
    tol_floor = 8 * torch.finfo(dtype).eps
    dist = _norm3(position - origin)
    raylen = _norm3(dest - origin)
    scale = 1.0 + torch.maximum(_norm3(origin), dist)
    bound = (n_iters.to(dtype) + 1.0) * (
        tolerance + 64.0 * tol_floor * (scale + raylen))
    return ~(torch.abs(track - dist) <= bound).all()


def integrity_vector(in_flight, done, weight, pseg, cur, origin, flux,
                     initial: bool) -> torch.Tensor:
    """End-of-walk conservation reductions → the [INTEGRITY_LEN] vector in
    the walk dtype (``integrity/invariants.py`` field order), as
    ``pumiumtally_tpu/ops/walk.py::integrity_vector``: over lanes in
    flight and done, Σ weight·track, Σ weight·|final − origin| and the
    max per-lane |track − |final − origin||; the count of flux entries
    that are not finite or negative; lanes in flight; lanes in flight and
    done. The initial search scores nothing, so its first three are 0. A
    truncated lane holds a partial track (the re-walk merge keeps the sums
    consistent across attempts, ``merge_rewalk``). ``flux`` is the flat
    accumulator after this walk's scores; it is read, never written.

    Few torch ops, each over whole arrays (on the card their launches,
    not their bytes, set much of the time): the two weighted sums are
    dot products, the bad entries are counted from one bool pass over
    the flux, and the counts travel as int64 until the one cast at the
    end (exact, as the JAX package's cast of its counts)."""
    dtype = flux.dtype
    comp = in_flight & done
    if initial or comp.numel() == 0:
        sums = flux.new_zeros(3)
    else:
        dist = torch.linalg.vector_norm(cur - origin, dim=1)
        wc = torch.where(comp, weight, 0.0)
        resid = torch.where(comp, (pseg - dist).abs_(), 0.0).amax()
        sums = torch.stack([torch.dot(wc, pseg), torch.dot(wc, dist), resid])
    good = torch.count_nonzero(
        (flux >= 0).logical_and_(flux <= torch.finfo(dtype).max))
    counts = torch.stack([flux.numel() - good, in_flight.sum(), comp.sum()])
    return torch.cat([sums, counts.to(dtype)])


def walk_stats_vector(ncross_l, nchase_l, done, nseg, it) -> torch.Tensor:
    """The [8] per-move stats vector in ``obs/walk_stats.py`` field order:
    crossings, max crossings per lane, chase hops, truncated walks,
    compaction occupancy (always 0, 0: there is no compaction), segments,
    loop iterations."""
    i64 = torch.int64
    zero = torch.zeros((), dtype=i64, device=done.device)
    return torch.stack([
        ncross_l.sum(dtype=i64),
        ncross_l.max().to(i64) if ncross_l.numel() else zero,
        nchase_l.sum(dtype=i64),
        (~done).sum(dtype=i64),
        zero,
        zero,
        torch.as_tensor(nseg, dtype=i64, device=done.device),
        torch.as_tensor(it, dtype=i64, device=done.device),
    ])


@dataclasses.dataclass
class Records:
    """The scored crossings of one walk: ``c = seg·w`` goes to bin
    ``elem·G + g`` with key ``order = iteration·n + lane``."""

    bin: torch.Tensor    # [m] int32
    order: torch.Tensor  # [m] int64
    c: torch.Tensor      # [m], the walk's dtype


@dataclasses.dataclass
class TraceResult:
    """Outputs of one walk.

    position: [n,3] final positions (destination, or clipped at a domain or
      material boundary).
    elem: [n] int32 parent element after the walk.
    material_id: [n] int32 updated material ids.
    flux: the flat [ntet·G·2] accumulator, updated in place.
    n_segments: scalar int64 count of scored particle-segments.
    n_crossings: scalar int64 count of loop iterations (the most any lane
      ran).
    done: [n] bool, False where the walk was truncated by max_crossings.
    lane_iters: [n] int32 iterations each lane ran (geo20 rows it read).
    track_length: [n] scored track length per lane (None without ledger).
    stats: [8] int64 walk stats vector (None without stats).
    n_records: the tally records the ordered walk made on the card, a
      host int (None elsewhere): the walk wrapper reads it anyway.
    convergence: the [CONV_LEN] convergence summary of a packed step
      with ``conv_state`` (``obs/convergence.py``), else None.
    xpoints: [n,K,3] recorded crossing points with ``record_xpoints=K``
      (only each lane's first ``n_xpoints`` rows, at most K, are set).
    n_xpoints: [n] int32 genuine crossings per lane (may exceed K).
    integrity: [INTEGRITY_LEN] conservation vector in the walk dtype with
      ``integrity`` (``integrity_vector``), else None.
    """

    position: torch.Tensor
    elem: torch.Tensor
    material_id: torch.Tensor
    flux: torch.Tensor
    n_segments: torch.Tensor
    n_crossings: torch.Tensor
    done: torch.Tensor
    lane_iters: torch.Tensor
    track_length: torch.Tensor | None = None
    stats: torch.Tensor | None = None
    n_records: int | None = None
    convergence: torch.Tensor | None = None
    xpoints: torch.Tensor | None = None
    n_xpoints: torch.Tensor | None = None
    integrity: torch.Tensor | None = None


def check_integrity_args(integrity: bool, ledger: bool) -> None:
    """The conservation check reads the per-lane track ledger."""
    if integrity and not ledger:
        raise ValueError(
            "integrity=True needs the per-particle track-length ledger "
            "(ledger=True) for the conservation invariant"
        )


def with_integrity(r: "TraceResult", origin, in_flight, weight,
                   initial: bool) -> "TraceResult":
    """``r`` with its ``integrity`` vector (``integrity_vector`` over the
    walk's inputs and outputs, after its scores reached the flux)."""
    r.integrity = integrity_vector(in_flight, r.done, weight,
                                   r.track_length, r.position, origin,
                                   r.flux, initial)
    return r


def check_walk_args(mesh, origin, dest, elem, in_flight, weight, group,
                    material_id, flux, n_groups):
    """Shape/dtype/device checks shared by the plain walk and the kernel
    wrapper. Raises on anything the walk does not take."""
    dtype, dev = origin.dtype, origin.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"walk dtype must be float32 or float64: {dtype}")
    n = origin.shape[0]
    ntet = mesh.ntet
    if mesh.geo20 is not None:
        tables = {"geo20": (mesh.geo20, (ntet, 20), dtype)}
    else:  # the unpacked layout: the four tables the walk reads
        tables = {
            "face_normals": (mesh.face_normals, (ntet, 4, 3), dtype),
            "face_d": (mesh.face_d, (ntet, 4), dtype),
            "tet2tet": (mesh.tet2tet, (ntet, 4), torch.int32),
            "class_id": (mesh.class_id, (ntet,), torch.int32),
        }
    expect = {
        **tables,
        "origin": (origin, (n, 3), dtype),
        "dest": (dest, (n, 3), dtype),
        "elem": (elem, (n,), torch.int32),
        "in_flight": (in_flight, (n,), torch.bool),
        "weight": (weight, (n,), dtype),
        "group": (group, (n,), torch.int32),
        "material_id": (material_id, (n,), torch.int32),
        "flux": (flux, (ntet * n_groups * 2,), dtype),
    }
    for name, (t, shape, dt) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, origin on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def xpoint_buffers(n: int, k: int, dtype, device, xpoints=None):
    """The ``record_xpoints=k`` buffers of a walk of ``n`` lanes: the given
    ``(points [n,k,3], counts [n] int32)`` to continue, checked, or fresh
    zeros."""
    if xpoints is None:
        return (torch.zeros(n, k, 3, dtype=dtype, device=device),
                torch.zeros(n, dtype=torch.int32, device=device))
    xp, kx = xpoints
    if (tuple(xp.shape) != (n, k, 3) or xp.dtype != dtype
            or tuple(kx.shape) != (n,) or kx.dtype != torch.int32):
        raise ValueError(
            f"xpoints must be ([{n},{k},3] {dtype}, [{n}] int32) buffers")
    if xp.device != device or kx.device != device:
        raise ValueError(f"xpoints must lie on {device}")
    if not (xp.is_contiguous() and kx.is_contiguous()):
        raise ValueError("xpoints must be contiguous")
    return xp, kx


def merge_recorded_xpoints(xa, ka, xb, kb, rows_a, rows_b) -> None:
    """Append a re-walk's recorded points after an earlier attempt's, in
    place (host numpy, the JAX package's ``merge_recorded_xpoints``): for
    each pair ``(rows_a[j], rows_b[j])`` the points of ``xb`` go after
    those of ``xa``, up to the K-point buffer; the counts add, past K
    too (the caller's sign of truncation)."""
    K = xa.shape[1]
    for ra, rb in zip(rows_a, rows_b):
        kept = min(int(ka[ra]), K)
        take = min(int(kb[rb]), K - kept)
        if take > 0:
            xa[ra, kept:kept + take] = xb[rb, :take]
    ka[rows_a] += kb[rows_b]


def resolve_material(mat_code, material_id, class_values):
    """Material codes → class values: -2 keeps the caller's id, -1 means
    destination reached or domain exit, >= 0 indexes ``class_values``."""
    return torch.where(
        mat_code == -2,
        material_id,
        torch.where(
            mat_code == -1,
            -1,
            class_values[mat_code.clamp_min(0).long()],
        ),
    ).to(torch.int32)


def trace(
    mesh,
    origin,
    dest,
    elem,
    in_flight,
    weight,
    group,
    material_id,
    flux,
    *,
    initial: bool,
    max_crossings: int,
    n_groups: int,
    score_squares: bool = True,
    tolerance: float = 1e-8,
    robust: bool = True,
    ledger: bool = True,
    stats: bool = True,
    record_xpoints: int | None = None,
    xpoints: tuple | None = None,
    debug_checks: bool = False,
    integrity: bool = False,
) -> TraceResult:
    """Walk every lane from origin to dest (plain PyTorch).

    Args:
      mesh: TetMesh, with a geo20 table or the unpacked layout.
      origin, dest: [n,3] ray endpoints in the mesh dtype.
      elem: [n] int32 current parent elements.
      in_flight: [n] bool; False lanes are parked (not walked, not scored).
      weight, group: [n] statistical weight and int32 energy group; lanes
        whose group is outside [0, n_groups) score nothing.
      material_id: [n] int32, updated on material stops and exits.
      flux: flat [ntet·n_groups·2] accumulator, updated in place.
      initial: the location search: nothing is scored and material
        boundaries do not stop a particle; only the domain boundary clips.
      max_crossings: bound on loop iterations.
      tolerance: geometric tolerance; a destination within it of the exit
        face counts as reached.
      robust: entry-face mask, relocation chase and escalated bump.
      record_xpoints: K, to record each lane's first K crossing points.
      xpoints: ``(points, counts)`` buffers to continue (updated in place),
        as ``TraceResult.xpoints`` and ``n_xpoints`` of an earlier walk.
      debug_checks: the invariant checks; a violation raises
        ``WalkInvariantError`` and the flux is left as it was.
      integrity: return the conservation vector (``integrity_vector``,
        needs ``ledger``).
    """
    check_walk_args(mesh, origin, dest, elem, in_flight, weight, group,
                    material_id, flux, n_groups)
    check_integrity_args(integrity, ledger)
    n = origin.shape[0]
    lane = torch.arange(n, device=origin.device)
    held = []

    def score(it, hit, bins, c):
        if debug_checks:  # scattered once the checks have passed
            held.append((bins, it * n + lane[hit], c))
        else:
            scatter_ordered_plain(flux, bins, it * n + lane[hit], c,
                                  score_squares)

    r = _walk(mesh, origin, dest, elem, in_flight, weight, group,
              material_id, flux, score, initial=initial,
              max_crossings=max_crossings, n_groups=n_groups,
              tolerance=tolerance, robust=robust, ledger=ledger,
              stats=stats, record_xpoints=record_xpoints, xpoints=xpoints,
              debug_checks=debug_checks)
    if held:
        scatter_ordered_plain(flux, *(torch.cat(col) for col in zip(*held)),
                              score_squares)
    if integrity:
        with_integrity(r, origin, in_flight, weight, initial)
    return r


def trace_packed(mesh, origin, elem, material_id, record, flux, perm=None,
                 weight=None, group=None, **kwargs):
    """The packed-I/O step (plain version), counterpart of
    ``pumiumtally_tpu/ops/walk.py::trace_packed_impl``: unpack the move
    record (``staging.unpack_move_record``), walk (``trace``, keywords as
    there), fold the convergence batch (``conv_state``), pack the
    readback (``staging.pack_trace_readback``).

    ``record`` is a ``[n, MOVE_COLS]`` (``[n, INIT_COLS]`` when
    ``initial``) carrier-word record from ``staging.pack_move_record`` /
    ``pack_init_record``; for the initial search ``weight`` and ``group``
    come from the arguments (the device state). ``perm`` must be None
    (the element sort is A5). ``conv_state`` (an
    ``obs/convergence.py::ConvState``, with ``batch_moves`` and
    ``rel_err_target``) folds the move into the batch accumulators after
    the walk and appends the summary to the readback. Returns
    ``(TraceResult, readback, dest, in_flight, weight, group)``: the
    staged tensors ride along so the facade can keep them as its state
    and re-walk truncated lanes from them."""
    return packed_step(trace, mesh, origin, elem, material_id, record,
                       flux, perm, weight, group, **kwargs)


def packed_step(walk, mesh, origin, elem, material_id, record, flux, perm,
                weight, group, conv_state=None, batch_moves=1,
                rel_err_target=0.05, **kwargs):
    """``trace_packed`` with ``walk`` as the walk (``trace`` here,
    ``walk_cuda.trace`` on the card)."""
    if conv_state is not None and kwargs["initial"]:
        raise ValueError(
            "conv_state is a move-loop feature: the initial location "
            "search scores nothing and must not advance the batch cadence"
        )
    dest, in_flight, w, g = unpack_move_record(record, origin.dtype, perm,
                                               kwargs["initial"])
    if w is None:
        w, g = weight, group
    r = walk(mesh, origin, dest, elem, in_flight, w, g, material_id, flux,
             **kwargs)
    if conv_state is not None:
        r.convergence = fold_and_reduce(
            r.flux, conv_state, batch_moves=batch_moves,
            rel_err_target=rel_err_target)
    readback = pack_trace_readback(r.position, r.material_id, r.done,
                                   r.stats, r.n_segments, perm,
                                   integrity=r.integrity,
                                   convergence=r.convergence)
    return r, readback, dest, in_flight, w, g


def trace_records(
    mesh,
    origin,
    dest,
    elem,
    in_flight,
    weight,
    group,
    material_id,
    flux,
    *,
    lane_ids: torch.Tensor,
    n_keys: int,
    max_crossings: int,
    n_groups: int,
    tolerance: float = 1e-8,
    robust: bool = True,
    ledger: bool = True,
    stats: bool = True,
):
    """The move of ``trace`` (``initial=False``) for some of a move's
    lanes, scoring into records instead of the flux: returns the
    TraceResult (its flux left as it was) and the Records, keyed
    ``iteration · n_keys + lane_ids[k]`` for the walk's lane k.
    ``scatter_ordered_plain`` of the records of every lane of a move,
    walked in any chunks and order, gives the flux of ``trace``, bitwise."""
    check_walk_args(mesh, origin, dest, elem, in_flight, weight, group,
                    material_id, flux, n_groups)
    if tuple(lane_ids.shape) != (origin.shape[0],):
        raise ValueError("lane_ids must hold one index per lane")
    lane_ids = lane_ids.to(origin.device, torch.int64)
    parts = []

    def score(it, hit, bins, c):
        parts.append((bins.to(torch.int32), it * n_keys + lane_ids[hit], c))

    r = _walk(mesh, origin, dest, elem, in_flight, weight, group,
              material_id, flux, score, initial=False,
              max_crossings=max_crossings, n_groups=n_groups,
              tolerance=tolerance, robust=robust, ledger=ledger, stats=stats)
    if not parts:
        dev = origin.device
        parts.append((torch.zeros(0, dtype=torch.int32, device=dev),
                      torch.zeros(0, dtype=torch.int64, device=dev),
                      torch.zeros(0, dtype=origin.dtype, device=dev)))
    return r, Records(*(torch.cat(col) for col in zip(*parts)))


def _walk(mesh, origin, dest, elem, in_flight, weight, group, material_id,
          flux, score, *, initial, max_crossings, n_groups, tolerance,
          robust, ledger, stats, record_xpoints=None, xpoints=None,
          debug_checks=False) -> TraceResult:
    """The loop of ``trace``: ``score(it, hit, bins, c)`` takes each
    iteration's scored crossings (the lanes ``hit``, their int64 bins and
    contributions, in lane order). Raises ``WalkInvariantError`` after the
    loop when a check of ``debug_checks`` failed."""
    dtype, dev = origin.dtype, origin.device
    n = origin.shape[0]
    geo20 = mesh.geo20
    if geo20 is None:  # the unpacked layout's class tables
        cls_idx, nbr_cls_idx = mesh.class_index, mesh.nbr_class_index
    code_int = torch.int32 if dtype == torch.float32 else torch.int64
    tol_floor = 8 * torch.finfo(dtype).eps
    good_group = (group >= 0) & (group < n_groups)

    cur = origin.clone()
    elem = elem.clone()
    done = ~in_flight
    mat = torch.full((n,), -2, dtype=torch.int32, device=dev)
    prev = torch.full((n,), -1, dtype=torch.int32, device=dev)
    stuck = torch.zeros(n, dtype=torch.int32, device=dev)
    pseg = weight * 0
    ncross = torch.zeros(n, dtype=torch.int32, device=dev)
    nchase = torch.zeros(n, dtype=torch.int32, device=dev)
    iters = torch.zeros(n, dtype=torch.int32, device=dev)
    nseg = torch.zeros((), dtype=torch.int64, device=dev)
    xp = kx = None
    if record_xpoints is not None:
        xp, kx = xpoint_buffers(n, record_xpoints, dtype, dev, xpoints)
    # One flag per check of CHECKS, read once after the walk.
    bad = (torch.zeros(len(CHECKS), dtype=torch.bool, device=dev)
           if debug_checks else None)

    it = 0
    while it < max_crossings and not bool(done.all()):
        active = ~done
        iters += active.to(torch.int32)
        e = elem.long()
        if geo20 is None:
            # The four-gather layout of the JAX walk body without geo20.
            normals = mesh.face_normals[e]
            dplane = mesh.face_d[e]
            nbrs_all = mesh.tet2tet[e]
        else:
            row = geo20[e]
            normals = row[:, :12].reshape(-1, 4, 3)
            dplane = row[:, 12:16]
            codes = row[:, 16:20].contiguous().view(code_int).to(torch.int32)
            nbrs_all = (codes & 0xFFFFFF) - 1

        dirv = dest - cur
        if robust:
            backward = (prev[:, None] >= 0) & (nbrs_all == prev[:, None])
            t_exit, face, has_exit, plane_num = exit_face(
                normals, dplane, cur, dirv, exclude=backward, return_num=True
            )
            sd = -plane_num
            contained = sd.amax(dim=-1) <= 0.0
            chase = active & (stuck >= 4) & ~contained
            chase_face = chase_face_choice(sd, elem, it, dtype, nbrs_all >= 0)
            face = torch.where(chase, chase_face, face)
            t_exit = torch.where(chase, 0.0, t_exit)
            has_exit = has_exit | chase
        elif debug_checks:
            t_exit, face, has_exit, plane_num = exit_face(
                normals, dplane, cur, dirv, return_num=True)
            sd = -plane_num
            chase = torch.zeros_like(done)
        else:
            t_exit, face, has_exit = exit_face(normals, dplane, cur, dirv)
            chase = torch.zeros_like(done)

        dnorm = torch.sqrt(
            (dirv[:, 0] * dirv[:, 0] + dirv[:, 1] * dirv[:, 1])
            + dirv[:, 2] * dirv[:, 2]
        )
        # A true division (``scalar / tensor`` would multiply by a
        # rounded reciprocal).
        tol_eff = torch.maximum(
            torch.full_like(dnorm, tolerance)
            / torch.where(dnorm > 0, dnorm, 1.0),
            torch.full_like(dnorm, tol_floor),
        )
        reached = (t_exit >= 1.0 - tol_eff) | ~has_exit
        t_step = torch.clamp_max(t_exit, 1.0)
        xpoint = cur + t_step[:, None] * dirv
        if debug_checks:
            # Each active lane lies in its parent element, within the
            # tolerance and rounding.
            scale = cur.abs().amax(dim=-1) + 1.0
            bound = 10.0 * tolerance + 64.0 * tol_floor * scale
            bad[0] |= (active & ~(sd.amax(dim=-1) <= bound)).any()

        crossed = active & ~reached & has_exit
        real_cross = crossed & ~chase
        ncross += real_cross.to(torch.int32)
        nchase += chase.to(torch.int32)
        if xp is not None:
            rows = torch.nonzero(real_cross & (kx < record_xpoints))[:, 0]
            xp[rows, kx[rows].long()] = xpoint[rows]
            kx += real_cross.to(torch.int32)
        face_l = face.long()[:, None]
        nbr = torch.gather(nbrs_all, 1, face_l)[:, 0]
        next_elem = torch.where(crossed, nbr, -1)
        if debug_checks:
            bad[1] |= (active[:, None] & ~torch.isfinite(xpoint)).any()
            # A hop out of the table ends the lane as a domain exit (the
            # walk cannot read that row); the check reports it.
            beyond = (next_elem < -1) | (next_elem >= mesh.ntet)
            bad[2] |= beyond.any()
            next_elem = torch.where(beyond, -1, next_elem)

        if not initial:
            seg = t_step * dnorm
            scored = active & in_flight & ~chase
            contrib = seg * weight
            if debug_checks:
                bad[3] |= (scored & ~((contrib >= 0)
                                      & torch.isfinite(contrib))).any()
            hit = scored & good_group
            score(it, hit, elem[hit].long() * n_groups + group[hit].long(),
                  contrib[hit])
            nseg += scored.sum()
            pseg = pseg + torch.where(scored, seg, 0.0)

        domain_exit = crossed & (next_elem == -1)
        if initial:
            material_stop = torch.zeros_like(domain_exit)
        elif geo20 is None:
            # Class indices compared, as the JAX walk compares class ids.
            nbr_class = torch.gather(nbr_cls_idx[e], 1, face_l)[:, 0]
            material_stop = (crossed & (next_elem >= 0)
                             & (nbr_class != cls_idx[e]) & ~chase)
        else:
            code = torch.gather(codes, 1, face_l)[:, 0]
            material_stop = crossed & (((code >> 30) & 1) == 1) & ~chase
            nbr_class = (code >> 24) & 0x3F
        newly_done = (active & reached) | domain_exit | material_stop
        if not initial:
            mat = torch.where(
                material_stop,
                nbr_class,
                torch.where((active & reached) | domain_exit, -1, mat),
            )

        hopped = crossed & (next_elem != -1)
        if robust:
            prev = torch.where(hopped, torch.where(chase, -1, elem), prev)
        elem = torch.where(hopped, next_elem, elem)
        cur = torch.where(active[:, None], xpoint, cur)
        if robust:
            continuing = crossed & ~newly_done
            extra, stuck = escalated_bump(
                stuck, contained, continuing, t_step, tol_floor, tol_eff,
                cur, dnorm,
            )
            cur = torch.where(
                continuing[:, None], cur + extra[:, None] * dirv, cur
            )
        done = done | newly_done
        it += 1

    material_out = resolve_material(mat, material_id, mesh.class_values)
    n_crossings = torch.tensor(it, dtype=torch.int64, device=dev)
    if debug_checks:
        if not initial and ledger:
            bad[TRACK_CHECK] = track_length_violated(
                cur, origin, dest, pseg, n_crossings, tolerance)
        raise_on_violation(sum(1 << k for k, b in enumerate(bad.tolist())
                               if b))
    return TraceResult(
        position=cur,
        elem=elem,
        material_id=material_out,
        flux=flux,
        n_segments=nseg,
        n_crossings=n_crossings,
        done=done,
        lane_iters=iters,
        track_length=pseg if ledger else None,
        stats=(
            walk_stats_vector(ncross, nchase, done, nseg, n_crossings)
            if stats else None
        ),
        xpoints=xp,
        n_xpoints=kx,
    )


# --------------------------------------------------------------------- #
# Truncated-lane escalation
# --------------------------------------------------------------------- #
_MAX_CROSS = WALK_STATS_FIELDS.index("max_crossings")
_TRUNCATED = WALK_STATS_FIELDS.index("truncated")
_RESID = IIDX["max_residual"]
_BAD_FLUX = IIDX["bad_flux"]
_FLYING = IIDX["lanes_flying"]


def merge_rewalk(a: TraceResult, b: TraceResult) -> TraceResult:
    """Fold a re-walk's result ``b`` (only the lanes ``a`` left unfinished
    were in flight) into the prior attempt ``a``, as
    ``pumiumtally_tpu/ops/walk.py::_merge_rewalk`` does: per-lane outputs
    come from ``b`` (parked lanes pass through a walk untouched), run
    totals add. In the stats vector ``max_crossings`` is a max and
    ``truncated`` is ``b``'s, the final count. ``b`` recorded its crossing
    points into ``a``'s buffers (``rewalk_truncated`` passes them on), so
    they are ``b``'s."""
    stats = None
    if a.stats is not None and b.stats is not None:
        stats = a.stats + b.stats
        stats[_MAX_CROSS] = torch.maximum(a.stats[_MAX_CROSS],
                                          b.stats[_MAX_CROSS])
        stats[_TRUNCATED] = b.stats[_TRUNCATED]
    track = None
    if a.track_length is not None and b.track_length is not None:
        track = a.track_length + b.track_length
    records = None
    if a.n_records is not None and b.n_records is not None:
        records = a.n_records + b.n_records
    integ = b.integrity
    if a.integrity is not None and b.integrity is not None:
        integ = a.integrity + b.integrity
        integ[_RESID] = torch.maximum(a.integrity[_RESID],
                                      b.integrity[_RESID])
        integ[_BAD_FLUX] = b.integrity[_BAD_FLUX]
        integ[_FLYING] = a.integrity[_FLYING]
    return TraceResult(
        position=b.position,
        elem=b.elem,
        material_id=b.material_id,
        flux=b.flux,
        n_segments=a.n_segments + b.n_segments,
        n_crossings=a.n_crossings + b.n_crossings,
        done=b.done,
        lane_iters=a.lane_iters + b.lane_iters,
        track_length=track,
        stats=stats,
        n_records=records,
        xpoints=b.xpoints,
        n_xpoints=b.n_xpoints,
        integrity=integ,
    )


def rewalk_truncated(mesh, result: TraceResult, dest, weight, group, *,
                     retries: int, trace_fn=None, **trace_kwargs):
    """Escalation for truncated walks, counterpart of
    ``pumiumtally_tpu/ops/walk.py::rewalk_truncated``: re-walk only the
    truncated lanes with doubled ``max_crossings``, up to ``retries``
    attempts, before declaring them lost.

    A truncated lane holds a mid-walk position and parent element, and
    flux is additive per segment, so continuing the walk from where it
    stopped scores exactly the segments the truncation dropped. Each
    attempt doubles the crossing bound and puts only the still
    unfinished lanes in flight, from ``result``'s position, element and
    material id (the device tensors of the walk that truncated); the
    others ride along parked. Each attempt's records fold into the flux
    after the previous attempt's (the ordered tally keys records per
    call), so the flux matches an uninterrupted walk's within rounding,
    not bit for bit. With ``record_xpoints`` each attempt records into the
    last one's point buffers, after its points, so the points and counts
    are those of an uninterrupted walk.

    Args:
      result: the truncated TraceResult (``done`` has False lanes).
      dest, weight, group: the move's per-lane inputs on the device.
      retries: the most re-walk attempts.
      trace_fn: the walk, called as this module's ``trace`` is (the
        default).
      trace_kwargs: the first walk's keywords, ``max_crossings`` (the
        doubling base) and ``initial`` included.

    Returns ``(merged TraceResult, n_retried, n_lost)``: ``n_retried``
    sums lanes over attempts, ``n_lost`` counts lanes still unfinished
    after the last attempt. Each attempt reads its count of unfinished
    lanes to the host.
    """
    kwargs = dict(trace_kwargs)
    max_crossings = kwargs.pop("max_crossings")
    n_retried = 0
    for _ in range(retries):
        todo = ~result.done
        n_todo = int(todo.sum())
        if n_todo == 0:
            break
        n_retried += n_todo
        max_crossings *= 2
        if result.xpoints is not None:
            kwargs["xpoints"] = (result.xpoints, result.n_xpoints)
        r2 = (trace_fn or trace)(
            mesh, result.position, dest, result.elem, todo, weight, group,
            result.material_id, result.flux, max_crossings=max_crossings,
            **kwargs,
        )
        result = merge_rewalk(result, r2)
    n_lost = int((~result.done).sum())
    return result, n_retried, n_lost


# --------------------------------------------------------------------- #
# Megastep: K device-sourced moves a chunk
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class MegastepResult:
    """Outputs of one megastep chunk (the flux, ``prev_even`` and the
    convergence state are updated in place). The per-lane state stays on
    the device for the next chunk; ``readback`` (the packed stats,
    convergence and physics tail, ``staging.pack_megastep_tail``) is what
    the host copies. ``n_records`` is the last walk's tally records on the
    card (a host int the walk read anyway; None on the CPU): the next
    chunk's first walk sizes its record buffers from it."""

    position: torch.Tensor
    dest: torch.Tensor
    elem: torch.Tensor
    material_id: torch.Tensor
    weight: torch.Tensor
    group: torch.Tensor
    alive: torch.Tensor
    flux: torch.Tensor
    readback: torch.Tensor
    n_records: int | None = None


def merge_megastep_stats(acc, stats):
    """Fold one fused move's stats vector into the chunk's: sums
    everywhere, the max of ``max_crossings``, and ``truncated`` summed
    (each fused move's truncation is a lane that would have warned on the
    per-move facade)."""
    out = acc + stats
    out[_MAX_CROSS] = torch.maximum(acc[_MAX_CROSS], stats[_MAX_CROSS])
    return out


def merge_megastep_integrity(acc, integ):
    """Fold one fused move's integrity vector into the chunk's, as
    ``pumiumtally_tpu/ops/walk.py::merge_megastep_integrity``: the
    conservation sums and lane counts add, the residual is a max, and
    ``bad_flux`` is the last move's (the final accumulator)."""
    out = acc + integ
    out[_RESID] = torch.maximum(acc[_RESID], integ[_RESID])
    out[_BAD_FLUX] = integ[_BAD_FLUX]
    return out


def megastep(
    mesh,
    origin,
    elem,
    material_id,
    weight,
    group,
    alive,
    pid,
    flux,
    move0: int,
    rng_key,
    sigma_t,
    absorb_t,
    prev_even=None,
    conv_state=None,
    *,
    n_moves: int,
    n_groups: int,
    survival_weight: float,
    downscatter: float,
    eps_near: float,
    max_crossings: int,
    score_squares: bool = True,
    tolerance: float = 1e-8,
    compact_after: int | None = None,
    compact_size: int | None = None,
    compact_stages=None,
    unroll: int = 1,
    robust: bool = True,
    tally_scatter: str = "auto",
    gathers: str = "merged",
    ledger: bool = True,
    stats: bool = True,
    integrity: bool = False,
    rel_err_target: float = 0.05,
    batch_moves: int = 1,
    capacity: int | None = None,
    draws=None,
    plain: bool = False,
) -> MegastepResult:
    """Run ``n_moves`` device-sourced moves, counterpart of
    ``pumiumtally_tpu/ops/walk.py::megastep_impl`` with its arguments in
    its order and meaning.

    Each fused move ``m = move0 + k``: every lane draws its flight keyed
    by ``(rng_key, m, pid)`` over its region's Σt
    (``ops/source_cuda.py::sample_flight``: the kernel ``csrc/source.cu``
    on the card, the plain version on the CPU; dead lanes keep their
    origin), the walk moves the alive lanes (``walk_cuda.trace``: the
    walk kernel and the ordered scatter on the card, the plain walk on the
    CPU), the physics of ``ops/source.py::apply_physics`` runs with the
    absorption of each lane's final region, then the batch-sd fold
    (``prev_even``) and the convergence fold (``conv_state``) once per
    fused move, and ``n_trunc = Σ(alive & ~done)``.

    ``move0`` is the facade's move counter, a host int that reaches the
    kernel as its move key (an argument, not a copy); ``rng_key`` the
    seed's key words (``source.prng_key``); ``pid`` the particle-id lane.
    Per-lane state, the flux (updated in place), ``prev_even`` and the
    accumulators stay on the device between moves; nothing is read to the
    host but what the walk itself reads (its record count and bucket
    information on the card), so K moves are a host loop of K moves: the
    bits are those of K calls of one move, and K saves no launches
    (ROADMAP.md B2 is the graph capture).

    The compaction, unroll, scatter and gather knobs schedule the JAX
    walk only and are ignored. ``integrity`` folds each walk's integrity
    vector into the chunk's (``merge_megastep_integrity``), which rides
    the tail.
    ``capacity`` sizes the first walk's record buffers on the card; later
    walks take the previous walk's record count. ``draws``, a sequence of
    ``(direction, ell, coll_u, roul_u)`` per fused move, replaces the
    sampling (a test feeds the JAX package's draws). Each fused move's
    steps are rows of the bound clock (``utils/timing.py::step``:
    ``sample``, ``walk`` with the wrapper's waits inside it, ``physics``,
    ``folds``). ``plain`` runs the plain
    sampling (``source.sample_flight_plain``) and the plain walk
    (``trace``) on whatever device the tensors are on: the kernels'
    yardstick on the card."""
    from ..core.tally import accumulate_batch_squares
    from ..utils.timing import step
    from . import source_cuda, walk_cuda
    from .source import (
        MEGA_PHYS_LEN,
        apply_physics,
        flight_dest,
        fold_in,
        lane_sigma,
        sample_flight_plain,
    )
    from .staging import pack_megastep_tail

    dtype, dev = origin.dtype, origin.device
    n = origin.shape[0]
    walk_kw = dict(initial=False, max_crossings=max_crossings,
                   n_groups=n_groups, score_squares=score_squares,
                   tolerance=tolerance, robust=robust, ledger=ledger,
                   stats=stats, integrity=integrity)
    phys_kw = dict(eps_near=eps_near, survival_weight=survival_weight,
                   downscatter=downscatter, n_groups=n_groups)
    sacc = (torch.zeros(len(WALK_STATS_FIELDS), dtype=torch.int64,
                        device=dev) if stats else None)
    cvec = None
    iacc = (torch.zeros(INTEGRITY_LEN, dtype=dtype, device=dev)
            if integrity else None)
    pacc = torch.zeros(MEGA_PHYS_LEN, dtype=dtype, device=dev)
    nseg = torch.zeros((), dtype=torch.int64, device=dev)
    alive = alive.to(torch.bool)
    mat, dest, records = material_id, origin, None
    for k in range(n_moves):
        with step("sample"):
            if draws is None:
                sample = (sample_flight_plain if plain
                          else source_cuda.sample_flight)
                dest, coll_u, roul_u = sample(
                    fold_in(rng_key, move0 + k), pid, n, elem, alive,
                    origin, mesh.class_id, sigma_t)
            else:
                direction, ell, coll_u, roul_u = draws[k]
                dest = flight_dest(origin, direction, ell,
                                   lane_sigma(mesh.class_id, elem, sigma_t),
                                   alive)
        with step("walk"):
            if plain:
                r = trace(mesh, origin, dest, elem, alive, weight, group,
                          mat, flux, **walk_kw)
            else:
                r = walk_cuda.trace(mesh, origin, dest, elem, alive, weight,
                                    group, mat, flux, capacity=capacity,
                                    **walk_kw)
        with step("physics"):
            absorb = lane_sigma(mesh.class_id, r.elem, absorb_t)
            weight, group, alive2, phys4 = apply_physics(
                r.position, dest, r.done, r.material_id, weight, group,
                alive, absorb, coll_u, roul_u, **phys_kw)
        with step("folds"):
            if prev_even is not None:
                accumulate_batch_squares(flux, prev_even)
            if sacc is not None:
                sacc = merge_megastep_stats(sacc, r.stats)
            if iacc is not None:
                iacc = merge_megastep_integrity(iacc, r.integrity)
            if conv_state is not None:
                cvec = fold_and_reduce(flux, conv_state,
                                       batch_moves=batch_moves,
                                       rel_err_target=rel_err_target)
            n_trunc = (alive & ~r.done).sum().to(dtype)
            pacc = torch.cat([pacc[:4] + phys4,
                              alive2.sum().to(dtype).reshape(1),
                              (pacc[5] + n_trunc).reshape(1)])
            nseg = nseg + r.n_segments
        origin, elem, mat, alive = r.position, r.elem, r.material_id, alive2
        if r.n_records is not None:
            records = r.n_records
            capacity = walk_cuda.record_capacity(n, records)
    readback = pack_megastep_tail(sacc, nseg, iacc, cvec, pacc, dtype)
    return MegastepResult(
        position=origin, dest=dest, elem=elem, material_id=mat,
        weight=weight, group=group, alive=alive, flux=flux,
        readback=readback, n_records=records,
    )
