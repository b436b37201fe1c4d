"""Wrapper of the CUDA walk kernel ``csrc/walk.cu``.

Counterpart of ``pumiumtally_tpu/ops/walk_pallas.py::trace_pallas_impl``:
the same call as the plain walk (``ops/walk.py::trace``), one kernel launch
for the whole move, then the per-lane outputs are reduced to the stats
vector with torch ops outside the kernel. The kernel's threads stay
resident and refill: each walks lane after lane, so no thread idles while
its warp finishes. The lanes are taken in an order that keeps the rows of
the lanes in flight close: before the walk, the lane schedule
(``lane_records``, three kernels of ``csrc/walk.cu``) writes every lane's
inputs as one record, in order of its key (``lane_keys``).

The tally is ``"ordered"`` by default: the walk appends one record per
scored crossing and ``ops/scatter.py``'s ordered kernel folds each bin in
(iteration, lane) order, so the flux is bitwise that of the plain walk and
the same on every run, as the JAX walk's is. ``"atomic"`` adds in the walk
with atomics (the flux then varies in its last bits from run to run); it
is kept for the probes and for timing.

A CPU tensor goes to the plain walk. A CUDA tensor goes to the kernel,
which is built with nvcc at first use; a failed build or launch raises.
``LAUNCHES`` counts walk kernel launches (and nothing else), so a run can
show that its path went through the kernel; ``RELAUNCHES`` counts the
ordered walks that were run again because their records overflowed the
buffers (a relaunch reuses the lane records: it runs no schedule).
``SCHEDULE_LAUNCHES`` counts the lane schedule's kernel launches, three a
schedule. The scatter counts its own launches.
``WARP_TRIPS`` is the last launch's device counter (an int64 on the card,
read only when the caller reads it): its warps' loop trips, summed, so
Σ ``lane_iters`` / (32 · ``WARP_TRIPS``) is the share of the warps' lane
slots that did work.

The wrapper's host steps are spans of ``utils/timing.py``:
``walk.schedule`` (``lane_records``), ``walk.launch`` (the per-lane and
record buffers and the kernel's entry), ``walk.result`` (``_result``'s
reductions) and the row ``count_wait`` around each read of an ordered
launch's record count (a relaunch reads twice), which counts as the host
read ``count``; with the invariant checks the count rides the read of the
check bits, ``checks``.

The ordered scatter takes at most 2^31 − 1 records a call
(``check_record_count``): a walk that makes more raises before its
records reach the scatter. ``record_capacity``, ``face_rate``,
``path_records`` and ``source_records`` size an ordered walk's record
buffers from an estimate on the host; ``trace_packed`` is ``trace``
between the move-loop records of ``ops/staging.py``;
``rewalk_truncated`` walks a move's truncated lanes again.

The feature tails (``record_xpoints``, ``xpoints``, ``debug_checks``, as
in ``ops/walk.py::trace``) take the kernel's feature instantiation, for
the initial search and the ordered move on every table layout (the
partitioned walk phase records points and has no checks); the atomic
tally refuses them.
The invariant checks' error word comes back with the record count in the
same read, with the post-loop track-length check computed on the card
beside it; a violation raises ``walk.WalkInvariantError`` before the
records reach the scatter, so the flux is left as it was. ``FEATURE_LAUNCHES``
counts the walk launches with a feature on (they count in ``LAUNCHES``
too), ``FEATURE_UNPACKED_LAUNCHES`` and ``FEATURE_PART_LAUNCHES`` those
of them on the unpacked and partitioned layouts.

A mesh without geo20 (``packed=False``, or past the packing limits) takes
the kernel's unpacked layout: each crossing reads the element's face
planes and neighbors from ``face_normals``, ``face_d`` and ``tet2tet``,
and at a crossing the class tables ``class_index`` and
``nbr_class_index``, as the JAX walk body's four-gather fallback does;
``UNPACKED_LAUNCHES`` counts those launches. ``walk_rows`` launches the
partitioned layout (``ops/walk_partitioned.py``'s walk phase over the
stacked parts' tables); ``PART_LAUNCHES`` counts its launches. Both count
in ``LAUNCHES`` too, and both have the initial search and the ordered
move only, each with and without the feature tails.

``block`` is the kernel's threads per block, the counterpart of the JAX
kernel's ``lane_block``: every instantiation is built at 128
(``DEFAULT_BLOCK``), and the packed, non-feature, robust initial search
and ordered move, the main path's, at each width of ``BLOCKS``. Another
combination raises, as a width that fails to build or launch does; there
is no fallback to 128. ``block_for`` maps a resolved value to a built
width (the largest at or below it, 64 the least). Every width gives the
same bits. ``BLOCK_LAUNCHES`` counts the walk launches by width; the plain
walk (CPU tensors) ignores the width.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..utils import timing
from . import _build, integrity_cuda, scatter
from .walk import (
    TRACK_CHECK,
    Records,
    TraceResult,
    check_integrity_args,
    check_walk_args,
    packed_step,
    raise_on_violation,
    resolve_material,
    rewalk_truncated as rewalk_truncated_with,
    trace as trace_plain,
    trace_records as trace_records_plain,
    track_length_violated,
    walk_stats_vector,
    xpoint_buffers,
)

LAUNCHES = 0
BLOCKS = (64, 128, 256, 512)
DEFAULT_BLOCK = 128
BLOCK_LAUNCHES = dict.fromkeys(BLOCKS, 0)
FEATURE_LAUNCHES = 0
FEATURE_UNPACKED_LAUNCHES = 0
FEATURE_PART_LAUNCHES = 0
UNPACKED_LAUNCHES = 0
PART_LAUNCHES = 0
RELAUNCHES = 0
SCHEDULE_LAUNCHES = 0
SCHEDULE_KERNELS = 3  # count, scan, place (csrc/walk.cu schedule)
WARP_TRIPS: torch.Tensor | None = None
TALLIES = ("ordered", "atomic")
_INT32_MAX = 2**31 - 1

_WALK_ARGTYPES = (
    [ctypes.c_int] * 3               # robust, initial, ordered
    + [ctypes.c_void_p] * 2          # geo, lane records
    + [ctypes.c_int] * 3             # n, n_groups, max_crossings
    + [ctypes.c_double, ctypes.c_int]  # tolerance, score_squares
    + [ctypes.c_void_p] * 14         # flux, 9 per-lane outputs, 3 record
                                     # buffers, counters
    + [ctypes.c_longlong]            # capacity
    + [ctypes.c_void_p] * 2          # crossing points and counts
    + [ctypes.c_int] * 4             # k, record, checks, ntet
    + [ctypes.c_double, ctypes.c_int]  # 10 * tolerance, layout
    + [ctypes.c_void_p] * 6          # normals, d, nbr, cls, nbr_cls, slot
    + [ctypes.c_longlong] + [ctypes.c_int] * 2  # stride, max_local, reset
    + [ctypes.c_void_p] * 4          # prev, stuck, target, target_elem
    + [ctypes.c_int, ctypes.c_void_p]  # block, stream
)
# csrc/walk.cu's table layouts.
PACKED, UNPACKED, PARTITIONED = 0, 1, 2
_LANES_ARGTYPES = (
    [ctypes.c_void_p] * 6            # origin, dest, elem, fly, weight, group
    + [ctypes.c_int] * 3             # n, cell, nkeys
    + [ctypes.c_double] * 6          # lo, scale
    + [ctypes.c_int] * 3             # cells
    + [ctypes.c_void_p] * 6          # counts, offsets, tile_sums, ticket,
                                     # lane records, stream
)
_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}
# csrc/walk.cu LaneRecord<T>: o[3], d[3], w in the walk's type, then int32
# elem, group, index, fly, and zero padding to whole 32 B sectors.
LANE_BYTES = {torch.float32: 64, torch.float64: 96}
# The Lane<T> a record carries, the bytes the walk reads of it.
LANE_PAYLOAD = {torch.float32: 48, torch.float64: 80}
_SCAN_TILE = 4096  # csrc/walk.cu SCAN_TILE
#: The C entries of csrc/walk.cu this module binds.
SYMBOLS = tuple(f"pumi_{name}_{tag}" for name in ("walk", "lanes",
                                                  "walk_resident", "walk_smem")
                for tag in _DTYPE_TAG.values())
_entries: dict = {}


def _entry(name: str, dtype):
    """The C entry ``pumi_<name>_<t>`` with its argument types set (once)."""
    key = (name, dtype)
    fn = _entries.get(key)
    if fn is None:
        fn = _build.bind("walk", f"pumi_{name}_{_DTYPE_TAG[dtype]}", SYMBOLS)
        fn.argtypes = {"walk": _WALK_ARGTYPES, "lanes": _LANES_ARGTYPES}[name]
        fn.restype = ctypes.c_int
        _entries[key] = fn
    return fn


def dynamic_smem(dtype, block: int) -> int:
    """The dynamic shared memory bytes a walk launch of ``block`` threads
    passes (``pumi_walk_smem_<t>``; the resource contracts' check of
    their mirror, analysis/costmodel.py)."""
    fn = _build.bind("walk", f"pumi_walk_smem_{_DTYPE_TAG[dtype]}", SYMBOLS)
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    return int(fn(int(block)))


def block_for(value: int | None) -> int:
    """The built block width for a resolved ``pallas_lane_block`` value
    (``TallyConfig.resolve_lane_block``): ``DEFAULT_BLOCK`` for None, else
    the largest width of ``BLOCKS`` at or below it, 64 the least (so 100
    runs at 64, 300 at 256 and 1024 at 512)."""
    if value is None:
        return DEFAULT_BLOCK
    below = [b for b in BLOCKS if b <= int(value)]
    return below[-1] if below else BLOCKS[0]


def launch_block(value: int | None, *, packed: bool, robust: bool,
                 feature: bool) -> int:
    """The width a facade's walks launch at for a resolved
    ``pallas_lane_block`` value: ``block_for(value)`` where the kernel is
    built at every width (a packed mesh, the robust walk, no feature
    tails), else ``DEFAULT_BLOCK``."""
    if packed and robust and not feature:
        return block_for(value)
    return DEFAULT_BLOCK


def _check_block(block: int, *, layout: int, feature: bool, robust: bool,
                 initial: bool, ordered: bool) -> None:
    """Raise unless ``csrc/walk.cu`` has the instantiation at ``block``."""
    if block not in BLOCKS:
        raise ValueError(f"block must be one of {BLOCKS}: {block!r}")
    if block != DEFAULT_BLOCK and (layout != PACKED or feature
                                   or not robust
                                   or not (initial or ordered)):
        raise ValueError(
            f"the walk kernel is built at block width {block} for the "
            "packed, robust initial search and ordered move without "
            f"feature tails only; use block={DEFAULT_BLOCK}")


def resident_threads(dtype, *, initial: bool, robust: bool = True,
                     ordered: bool = True, layout: int = PACKED,
                     block: int = DEFAULT_BLOCK) -> int:
    """Threads a walk launch keeps resident on the current card (its grid
    for a large n): the lanes in flight at once."""
    ordered = ordered and not initial
    _check_block(block, layout=layout, feature=False, robust=robust,
                 initial=initial, ordered=ordered)
    fn = _build.bind("walk", f"pumi_walk_resident_{_DTYPE_TAG[dtype]}",
                     SYMBOLS)
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(int(robust), int(initial), int(ordered), int(layout),
             int(block), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"walk occupancy query failed: cudaError_t {err}")
    return out.value


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
    tally: str = "ordered",
    capacity: int | None = None,
    record_xpoints: int | None = None,
    xpoints: tuple | None = None,
    debug_checks: bool = False,
    integrity: bool = False,
    block: int = DEFAULT_BLOCK,
) -> TraceResult:
    """The walk of ``ops/walk.py::trace`` (same arguments, same result):
    the CUDA kernel for CUDA tensors, the plain walk for CPU tensors. The
    flux is updated in place. ``block`` is the kernel's threads per block
    (see the module docstring; the plain walk ignores it). ``integrity``
    adds the conservation vector of ``ops/walk.py::integrity_vector``
    (one launch of ``csrc/integrity.cu`` after the scatter,
    ``integrity_cuda``; no host read).

    ``tally`` is ``"ordered"`` (flux bitwise equal to the plain walk's) or
    ``"atomic"``. ``capacity`` is the number of records the ordered walk's
    buffers hold (default 4 per lane; the facade passes its estimate of
    the move's records); a walk that makes more is run again with buffers
    of its count."""
    if tally not in TALLIES:
        raise ValueError(f"tally must be one of {TALLIES}, not {tally!r}")
    kw = dict(
        initial=initial, max_crossings=max_crossings, n_groups=n_groups,
        score_squares=score_squares, tolerance=tolerance, robust=robust,
        ledger=ledger, stats=stats, record_xpoints=record_xpoints,
        xpoints=xpoints, debug_checks=debug_checks,
    )
    args = (mesh, origin, dest, elem, in_flight, weight, group,
            material_id, flux)
    if origin.device.type == "cpu":
        return trace_plain(*args, **kw, integrity=integrity)
    check_integrity_args(integrity, ledger)
    if origin.device.type != "cuda":
        raise ValueError(f"the walk runs on 'cuda' or 'cpu', not {origin.device}")
    _check_cuda(*args, n_groups, max_crossings)
    if tally == "atomic" and flux.data_ptr() % 8:
        raise ValueError("flux must be 8-byte aligned for the pair adds")
    if tally == "atomic" and mesh.geo20 is None:
        raise ValueError(
            "the atomic tally walks geo20 rows only: use the ordered tally "
            "on a mesh without geo20")
    if tally == "atomic" and not initial and (
            record_xpoints is not None or debug_checks):
        raise ValueError(
            "the atomic tally has no feature tails (record_xpoints, "
            "debug_checks): use the ordered tally")
    if tally == "atomic" or initial:
        lanes = lane_records(mesh, origin, dest, elem, in_flight, weight,
                             group, initial=initial)
        r = _result(_launch(*args, **kw, ordered=False, lanes=lanes,
                            block=block), **kw)
    else:
        out, rec = _walk_ordered(*args, **kw, capacity=capacity,
                                 block=block)
        scatter.ordered_cuda(flux, rec.bin, rec.order, rec.c, score_squares,
                             mesh.ntet * n_groups)
        r = _result(out, **kw, records=rec.bin.numel())
    if integrity:
        r.integrity = integrity_cuda.integrity_vector(
            in_flight, r.done, weight, r.track_length, r.position, origin,
            r.flux, initial)
    return r


def trace_packed(mesh, origin, elem, material_id, record, flux, perm=None,
                 weight=None, group=None, **kwargs) -> tuple:
    """The packed-I/O step of ``ops/walk.py::trace_packed`` around this
    module's ``trace`` (keywords as there, ``tally`` and ``capacity``
    included): the record is unpacked and the readback packed with torch
    ops on the record's device, the walk is the kernel for CUDA tensors
    and the plain walk for CPU tensors. Returns ``(TraceResult,
    readback, dest, in_flight, weight, group)``."""
    return packed_step(trace, mesh, origin, elem, material_id, record,
                       flux, perm, weight, group, **kwargs)


def rewalk_truncated(mesh, result, dest, weight, group, *, retries: int,
                     **kwargs):
    """``ops/walk.py::rewalk_truncated`` with this module's ``trace`` as
    the walk: on the card each attempt is a walk kernel launch (and its
    ordered scatter) with only the truncated lanes in flight, from the
    device-resident mid-walk state of ``result``, its record buffers
    sized for the attempt; on the CPU the plain walk."""
    return rewalk_truncated_with(mesh, result, dest, weight, group,
                                 retries=retries, trace_fn=_rewalk_attempt,
                                 **kwargs)


def _rewalk_attempt(mesh, origin, dest, elem, in_flight, *rest,
                    max_crossings: int, **kwargs):
    """One re-walk attempt: ``trace`` with record buffers for the lanes in
    flight times the doubled bound (a lane scores at most once an
    iteration), at most 8 a lane of the move; a walk that makes more runs
    again with buffers of its count. Reads the count of lanes in flight
    to the host."""
    n = in_flight.shape[0]
    capacity = min(int(in_flight.sum()) * max_crossings, 8 * n)
    return trace(mesh, origin, dest, elem, in_flight, *rest,
                 max_crossings=max_crossings, capacity=capacity, **kwargs)


def walk_records(mesh, origin, dest, elem, in_flight, weight, group,
                 material_id, flux, *, max_crossings: int, n_groups: int,
                 score_squares: bool = True, tolerance: float = 1e-8,
                 robust: bool = True, ledger: bool = True, stats: bool = True,
                 capacity: int | None = None, block: int = DEFAULT_BLOCK):
    """The ordered walk of a move (``initial=False``) without its scatter:
    returns its TraceResult, whose flux is left as it was, and its
    Records. ``scatter.scatter_ordered`` of the records into the flux
    completes ``trace``. CPU tensors take the plain walk
    (``ops/walk.py::trace_records``; ``block`` is then ignored)."""
    args = (mesh, origin, dest, elem, in_flight, weight, group,
            material_id, flux)
    kw = dict(max_crossings=max_crossings, n_groups=n_groups,
              tolerance=tolerance, robust=robust, ledger=ledger, stats=stats)
    if origin.device.type == "cpu":
        n = origin.shape[0]
        return trace_records_plain(*args, lane_ids=torch.arange(n),
                                   n_keys=n, **kw)
    if origin.device.type != "cuda":
        raise ValueError(f"the walk runs on 'cuda' or 'cpu', not {origin.device}")
    _check_cuda(*args, n_groups, max_crossings)
    kw.update(initial=False, score_squares=score_squares)
    out, rec = _walk_ordered(*args, **kw, capacity=capacity, block=block)
    return _result(out, **kw), rec


def unpacked_tables(mesh) -> tuple:
    """The unpacked layout's five tables of a mesh without geo20, in the
    order of ``csrc/walk.cu``'s ``Tables``: face planes, neighbors, the
    class index and the neighbors' class index."""
    return (mesh.face_normals, mesh.face_d, mesh.tet2tet, mesh.class_index,
            mesh.nbr_class_index)


def walk_rows(tables, origin, dest, rows, weight, group, material_id, pseg,
              prev, stuck, slot, flux, *, stride: int, max_local: int,
              initial: bool, max_crossings: int, n_groups: int,
              score_squares: bool = True, tolerance: float = 1e-8,
              robust: bool = True, capacity: int | None = None,
              reset: int = 0, record_xpoints: int | None = None,
              xpoints: tuple | None = None):
    """One partitioned walk launch on the card (``csrc/walk.cu``'s
    partitioned layout), for ``ops/walk_partitioned.py``: the m lanes
    walk from ``origin`` toward ``dest`` over the stacked parts' tables
    (``tables``: face planes, neighbor codes, classes, neighbor classes,
    the rows of all parts one after the other, ``max_local`` a part),
    each from its row ``rows`` (part · max_local + local row), until it
    is done, freezes at a crossing into another part, or has run
    ``max_crossings`` iterations. From iteration ``reset`` on (0: never)
    the chase hash counts iterations from ``reset``, as a compacted round
    of the JAX phase restarts its loop counter. ``material_id``,
    ``pseg``, ``prev`` and ``stuck`` are each lane's carried state
    (read, not written). A move's tally records, for ``flux`` (the
    stacked flat slab, bins ``row · G + g``), are keyed ``it · stride +
    slot[k]``; ``walk_partitioned.fold_records`` folds them (a phase's
    launches in one ordered scatter), ``flux`` itself is not written.
    The lanes are scheduled by row (``lane_records``). Returns ``(out,
    records)``: the per-lane outputs of ``_launch`` (``elem`` part-local,
    ``target``/``target_elem`` the frozen lanes' destination, -1 for the
    others) and the records ``(bin, order, c)`` (None for the initial
    search). ``record_xpoints=K`` records each lane's first K genuine
    crossings, the crossing into another part too, into ``xpoints``
    (``[m, K, 3]`` points and ``[m]`` int32 counts, continued in place;
    fresh zeros when None), returned as ``out["xp"]`` and ``out["kx"]``;
    the partitioned layout has no invariant checks. CPU tensors take the
    plain version (``walk_partitioned.walk_rows_plain``)."""
    dev = origin.device
    kw = dict(stride=stride, max_local=max_local, initial=initial,
              max_crossings=max_crossings, n_groups=n_groups,
              score_squares=score_squares, tolerance=tolerance,
              robust=robust, reset=reset, record_xpoints=record_xpoints,
              xpoints=xpoints)
    if dev.type == "cpu":
        from .walk_partitioned import walk_rows_plain

        return walk_rows_plain(tables, origin, dest, rows, weight, group,
                               material_id, pseg, prev, stuck, slot, flux,
                               **kw)
    if dev.type != "cuda":
        raise ValueError(f"the walk runs on 'cuda' or 'cpu', not {dev}")
    m = origin.shape[0]
    nrows = tables[0].shape[0]
    if m and (stride * max_crossings >= 2**63 or nrows * n_groups >= 2**31):
        raise ValueError("the stacked parts' keys or bins overflow")
    part = dict(tables=tables, slot=slot, stride=stride,
                max_local=max_local, reset=reset, prev=prev, stuck=stuck,
                mat=material_id, pseg=pseg)
    fly = torch.ones(m, dtype=torch.bool, device=dev)
    args = (None, origin, dest, rows, fly, weight, group, material_id, flux)
    kw = dict(initial=initial, max_crossings=max_crossings,
              n_groups=n_groups, score_squares=score_squares,
              tolerance=tolerance, robust=robust, ledger=True, stats=True,
              part=part, record_xpoints=record_xpoints, xpoints=xpoints)
    if initial:
        lanes = lane_records(*args[:7], initial=True, nkeys=nrows)
        return _launch(*args, **kw, ordered=False, lanes=lanes), None
    out, rec = _walk_ordered(*args, **kw, capacity=capacity, nkeys=nrows)
    return out, (rec.bin, rec.order, rec.c)


def _check_cuda(mesh, origin, dest, elem, in_flight, weight, group,
                material_id, flux, n_groups, max_crossings):
    check_walk_args(mesh, origin, dest, elem, in_flight, weight, group,
                    material_id, flux, n_groups)
    for t in ((mesh.geo20,) if mesh.geo20 is not None
              else unpacked_tables(mesh)[:3]):
        if t.data_ptr() % 16:
            raise ValueError("the walk tables must be 16-byte aligned for "
                             "the row loads")
    if max_crossings >= 2**31:
        raise ValueError(f"max_crossings must fit int32: {max_crossings}")
    if mesh.ntet * n_groups >= 2**31:
        raise ValueError("ntet * n_groups must fit int32 (the tally's bins)")


def check_record_count(made: int) -> int:
    """``made``, the tally records an ordered walk made, if the ordered
    scatter can take them (at most 2^31 − 1: it counts records in int32);
    else ValueError. The walk counts in 64 bits, so the count is exact."""
    if made > _INT32_MAX:
        raise ValueError(
            f"the walk made {made} tally records, more than the ordered "
            f"scatter takes in one call ({_INT32_MAX}); walk fewer "
            "particles per move"
        )
    return made


def record_capacity(n: int, estimate: float) -> int:
    """Records an ordered walk's buffers are given for ``n`` lanes and an
    estimate of the records it makes: 5/4 of the estimate, at least 4 per
    lane."""
    return max(4 * n, math.ceil(1.25 * estimate))


def face_rate(mesh) -> float:
    """Faces an isotropic straight line crosses per unit length in the
    mesh, S/(4V) with S the elements' summed face areas and V their
    volume (elementwise ops in the mesh dtype, sums in float64; one read
    to the host)."""
    f64 = torch.float64
    v = mesh.coords[mesh.tet2vert.long()]
    area = 0.0
    for a, b, c in ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)):
        p, q = v[:, b] - v[:, a], v[:, c] - v[:, a]
        x = p[:, 1] * q[:, 2] - p[:, 2] * q[:, 1]
        y = p[:, 2] * q[:, 0] - p[:, 0] * q[:, 2]
        z = p[:, 0] * q[:, 1] - p[:, 1] * q[:, 0]
        area = area + (x * x + y * y + z * z).sqrt().sum(dtype=f64)
    return float(area / 2 / (4 * mesh.volumes.sum(dtype=f64)))


def path_records(rate: float, origin, dest, in_flight,
                 sample: int = 65536) -> float:
    """An estimate of the records a walk makes, from host arrays (numpy or
    CPU tensors): one segment per flying lane plus the faces its straight
    path from ``origin`` to ``dest`` crosses at ``rate`` (``face_rate``).
    The paths are summed over every k-th lane, at most ``sample`` lanes
    (all of them up to ``sample``), and scaled to all lanes."""
    fly = np.asarray(in_flight, bool)
    n = fly.shape[0]
    k = max(1, n // sample)
    d = (np.asarray(dest, np.float64)[::k]
         - np.asarray(origin, np.float64)[::k])
    path = np.sqrt((d * d).sum(axis=1))[fly[::k]].sum() * (n / len(d))
    return int(fly.sum()) + rate * float(path)


def source_records(rate: float, lanes: int, sigma_min: float) -> float:
    """An estimate of the records a device-sourced move makes: a segment
    per lane plus the faces (``face_rate``) a mean flight of the longest
    mean free path 1/``sigma_min`` crosses."""
    return lanes * (1.0 + rate / max(sigma_min, 1e-30))


def _walk_ordered(*args, capacity, nkeys=None, **kw):
    global RELAUNCHES
    cap = capacity if capacity is not None else 4 * args[1].shape[0]
    lanes = lane_records(*args[:7], initial=kw["initial"], nkeys=nkeys)
    counts0 = None
    if kw.get("record_xpoints") is not None and kw.get("xpoints"):
        counts0 = kw["xpoints"][1].clone()  # a relaunch records afresh
    out, rec, made = _launch(*args, **kw, ordered=True, capacity=cap,
                             lanes=lanes)
    check_record_count(made)
    if made > cap:
        if counts0 is not None:
            kw["xpoints"][1].copy_(counts0)
        elif kw.get("record_xpoints") is not None:
            kw = dict(kw, xpoints=(out["xp"], out["kx"].zero_()))
        out, rec, again = _launch(*args, **kw, ordered=True, capacity=made,
                                  lanes=lanes)
        RELAUNCHES += 1
        if again != made:
            raise RuntimeError(
                f"the walk made {made} records, then {again} from the same "
                "inputs"
            )
    return out, Records(rec[0][:made], rec[1][:made], rec[2][:made])


def destination_cells(mesh, dest):
    """Each lane's cell on a grid over the mesh's bounding box with about
    one cell per 6 elements (a hexahedron's worth), in raster order, as
    int32 keys; and the number of cells. Destinations outside the box
    take the nearest cell (a non-finite one a cell of the box). The plain
    version of the lane schedule's initial-search key."""
    lo, scale, cells = _cell_grid(mesh)
    c = [((dest[:, k] - lo[k]) * scale[k]).nan_to_num_(0.0)
         .floor_().clamp_(0, cells[k] - 1).to(torch.int32) for k in range(3)]
    keys = (c[2] * cells[1] + c[1]) * cells[0] + c[0]
    return keys, cells[0] * cells[1] * cells[2]


def _cell_grid(mesh):
    """The initial search's key grid: per axis the box's lower corner, the
    cells per unit length and the number of cells (host floats and ints)."""
    lo, ext = mesh.bounds
    ext = [max(e, 1e-30) for e in ext]
    side = (ext[0] * ext[1] * ext[2] * 6.0 / max(mesh.ntet, 1)) ** (1 / 3)
    cells = [max(1, min(1024, round(e / side))) for e in ext]
    return lo, [c / e for c, e in zip(cells, ext)], cells


def lane_keys(mesh, elem, dest, initial: bool, nkeys: int | None = None):
    """The schedule's key of every lane (int32) and the number of keys: a
    move's lanes by start element, the initial search's
    by ``destination_cells``; clamped to the keys' range, as the kernel
    clamps them. A given ``nkeys`` keys every lane by its element (the
    partitioned walk's rows)."""
    if nkeys is not None:
        keys = elem
    elif initial:
        keys, nkeys = destination_cells(mesh, dest)
    else:
        keys, nkeys = elem, max(1, mesh.ntet)
    return keys.clamp(0, nkeys - 1).to(torch.int32), nkeys


def lane_records_plain(keys, origin, dest, elem, in_flight, weight, group):
    """The lanes' ``LaneRecord<T>`` records (``csrc/walk.cu``) in slot order, as
    a ``uint8 [n, LANE_BYTES]`` tensor: lanes sorted stably by key, each
    record origin, dest and weight in the walk's type, then int32 element,
    group, lane index and flying flag, padding zero."""
    dtype, n = origin.dtype, origin.shape[0]
    idx = torch.argsort(keys, stable=True)
    words = LANE_BYTES[dtype] // origin.element_size()
    rec = torch.zeros(n, words, dtype=dtype, device=origin.device)
    rec[:, 0:3] = origin[idx]
    rec[:, 3:6] = dest[idx]
    rec[:, 6] = weight[idx]
    ints = rec.view(torch.int32)
    first = 7 * origin.element_size() // 4
    ints[:, first] = elem[idx]
    ints[:, first + 1] = group[idx]
    ints[:, first + 2] = idx.to(torch.int32)
    ints[:, first + 3] = in_flight[idx].to(torch.int32)
    return rec.view(torch.uint8).view(n, LANE_BYTES[dtype])


def decode_lanes(records, dtype) -> dict:
    """The fields of ``LaneRecord<T>`` records (``uint8 [n, LANE_BYTES]``):
    origin and dest ``[n, 3]`` and weight in ``dtype``, int32 elem, group
    and index, and the flying flags as bool."""
    n, item = records.shape[0], torch.finfo(dtype).bits // 8
    flat = records.contiguous().view(-1)
    real = flat.view(dtype).view(n, LANE_BYTES[dtype] // item)
    ints = flat.view(torch.int32).view(n, LANE_BYTES[dtype] // 4)
    first = 7 * item // 4
    return dict(origin=real[:, 0:3], dest=real[:, 3:6], weight=real[:, 6],
                elem=ints[:, first], group=ints[:, first + 1],
                index=ints[:, first + 2], in_flight=ints[:, first + 3] != 0)


def lane_records(mesh, origin, dest, elem, in_flight, weight, group, *,
                 initial: bool, nkeys: int | None = None):
    """The walk's lane schedule: every lane's inputs as one
    ``LaneRecord<T>``, in order of its key (``lane_keys``; within a key the device's
    order), ``uint8 [n, LANE_BYTES]``. A CPU tensor takes
    ``lane_records_plain``; a CUDA tensor the three kernels of
    ``csrc/walk.cu`` (count, scan, place), which compute the key from
    ``elem`` or ``dest`` themselves, or raises. ``nkeys``: key by element
    among that many (``lane_keys``)."""
    with timing.span("walk.schedule"):
        if origin.device.type == "cpu":
            keys, _ = lane_keys(mesh, elem, dest, initial, nkeys)
            return lane_records_plain(keys, origin, dest, elem, in_flight,
                                      weight, group)
        if origin.device.type != "cuda":
            raise ValueError(
                f"the walk runs on 'cuda' or 'cpu', not {origin.device}")
        return _schedule(mesh, origin, dest, elem, in_flight, weight,
                         group, initial, nkeys)


# Per (device, stream): the schedule's key counts and scan ticket (zero
# between calls: the place pass spends the counts as cursors and the scan
# resets its ticket), with scratch for the offsets and tile sums.
_WORKSPACES: dict = {}


def _workspace(dev, stream: int, nkeys: int) -> dict:
    key = (dev.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws["counts"].numel() < nkeys:
        i32 = dict(dtype=torch.int32, device=dev)
        ws = _WORKSPACES[key] = dict(
            counts=torch.zeros(nkeys, **i32),
            offsets=torch.empty(nkeys, **i32),
            tile_sums=torch.empty(-(-nkeys // _SCAN_TILE), **i32),
            ticket=torch.zeros(1, **i32),
        )
    return ws


def _schedule(mesh, origin, dest, elem, in_flight, weight, group, initial,
              nkeys=None):
    """Launch the lane schedule on checked walk inputs."""
    global SCHEDULE_LAUNCHES
    dtype, dev, n = origin.dtype, origin.device, origin.shape[0]
    lanes = torch.empty(n, LANE_BYTES[dtype], dtype=torch.uint8, device=dev)
    if n == 0:
        return lanes
    cell = initial and nkeys is None
    if cell:
        lo, scale, cells = _cell_grid(mesh)
        nkeys = cells[0] * cells[1] * cells[2]
    else:
        lo, scale, cells = [0.0] * 3, [0.0] * 3, [1] * 3
        nkeys = max(1, mesh.ntet if nkeys is None else nkeys)
    fn = _entry("lanes", dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = _workspace(dev, stream, nkeys)
        err = fn(origin.data_ptr(), dest.data_ptr(), elem.data_ptr(),
                 in_flight.data_ptr(), weight.data_ptr(), group.data_ptr(),
                 n, int(cell), nkeys, *lo, *scale, *cells,
                 ws["counts"].data_ptr(), ws["offsets"].data_ptr(),
                 ws["tile_sums"].data_ptr(), ws["ticket"].data_ptr(),
                 lanes.data_ptr(), stream)
    if err != 0:
        # The counts may be left part spent: the next call starts afresh.
        _WORKSPACES.pop((dev.index, stream), None)
        raise RuntimeError(f"lane schedule launch failed with cudaError_t {err}")
    SCHEDULE_LAUNCHES += SCHEDULE_KERNELS
    return lanes


def _launch(mesh, origin, dest, elem, in_flight, weight, group, material_id,
            flux, *, initial, max_crossings, n_groups, score_squares,
            tolerance, robust, ledger, stats, ordered, lanes, capacity=0,
            record_xpoints=None, xpoints=None, debug_checks=False,
            part=None, block=DEFAULT_BLOCK):
    """One walk launch over the lane records ``lanes`` (``lane_records``):
    slot s walks the lane of record s. Returns the per-lane outputs and,
    when ordered, the record buffers and the number of records the walk
    made. With ``debug_checks`` it reads the check bits (with the record
    count, in one read) and raises on a violation. ``part`` (the dict of
    ``walk_rows``) launches the partitioned layout; a mesh without geo20
    the unpacked one."""
    global LAUNCHES, FEATURE_LAUNCHES, WARP_TRIPS
    global UNPACKED_LAUNCHES, PART_LAUNCHES
    global FEATURE_UNPACKED_LAUNCHES, FEATURE_PART_LAUNCHES
    with timing.span("walk.launch"):
        dtype, dev = origin.dtype, origin.device
        n = origin.shape[0]
        if part is not None:
            layout, tables = PARTITIONED, part["tables"]
        elif mesh.geo20 is None:
            layout, tables = UNPACKED, unpacked_tables(mesh)
        else:
            layout, tables = PACKED, (None,) * 5
        slot = prev = stuck = None
        if part is not None:  # in/out lane state: fresh copies each launch
            slot = part["slot"]
            prev, stuck = part["prev"].clone(), part["stuck"].clone()
        record = record_xpoints is not None
        _check_block(block, layout=layout,
                     feature=record or bool(debug_checks),
                     robust=bool(robust), initial=bool(initial),
                     ordered=bool(ordered))
        xp = kx = None
        if record:
            xp, kx = xpoint_buffers(n, record_xpoints, dtype, dev, xpoints)

        def per_lane(dt):
            return torch.empty(n, dtype=dt, device=dev)

        pos = torch.empty_like(origin)
        elem_o, mat, ncross, nchase, nseg_l, iters = (
            per_lane(torch.int32) for _ in range(6)
        )
        done = per_lane(torch.bool)
        pseg = per_lane(dtype)
        target = target_elem = None
        if part is not None:  # material ids and track lengths carry in
            mat, pseg = part["mat"].clone(), part["pseg"].clone()
            target = per_lane(torch.int32)
            target_elem = per_lane(torch.int32)

        def ptr(t):
            return None if t is None else t.data_ptr()

        cap = capacity if ordered else 0
        rec = (
            torch.empty(cap, dtype=torch.int32, device=dev),
            torch.empty(cap, dtype=torch.int64, device=dev),
            torch.empty(cap, dtype=dtype, device=dev),
        )
        # Records made, lane slots taken, warp loop trips, check bits.
        counters = torch.zeros(4, dtype=torch.int64, device=dev)

        fn = _entry("walk", dtype)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(
                int(bool(robust)), int(bool(initial)), int(bool(ordered)),
                ptr(mesh.geo20) if layout == PACKED else None,
                lanes.data_ptr(), n, n_groups,
                max_crossings, float(tolerance),
                int(bool(score_squares)), flux.data_ptr(), pos.data_ptr(),
                elem_o.data_ptr(), mat.data_ptr(), done.data_ptr(),
                pseg.data_ptr(), ncross.data_ptr(), nchase.data_ptr(),
                nseg_l.data_ptr(), iters.data_ptr(), rec[0].data_ptr(),
                rec[1].data_ptr(), rec[2].data_ptr(), counters.data_ptr(),
                cap,
                xp.data_ptr() if record else None,
                kx.data_ptr() if record else None,
                int(record_xpoints or 0), int(record),
                int(bool(debug_checks)),
                mesh.ntet if mesh is not None else 0,
                10.0 * float(tolerance),
                layout, *(ptr(t) for t in tables), ptr(slot),
                part["stride"] if part else 0,
                part["max_local"] if part else 0,
                part["reset"] if part else 0, ptr(prev), ptr(stuck),
                ptr(target), ptr(target_elem), int(block), stream,
            )
        if err != 0:
            raise RuntimeError(
                f"walk kernel launch failed with cudaError_t {err}"
            )
        LAUNCHES += 1
        BLOCK_LAUNCHES[block] += 1
        feat = int(record or bool(debug_checks))
        FEATURE_LAUNCHES += feat
        FEATURE_UNPACKED_LAUNCHES += feat * int(layout == UNPACKED)
        FEATURE_PART_LAUNCHES += feat * int(layout == PARTITIONED)
        UNPACKED_LAUNCHES += int(layout == UNPACKED)
        PART_LAUNCHES += int(layout == PARTITIONED)
        WARP_TRIPS = counters[2]
        out = dict(mesh=mesh, material_id=material_id, flux=flux,
                   pos=pos, elem=elem_o, mat=mat, done=done, pseg=pseg,
                   ncross=ncross, nchase=nchase, nseg=nseg_l, iters=iters,
                   xp=xp, kx=kx, target=target, target_elem=target_elem,
                   prev=prev, stuck=stuck)
    if debug_checks:
        bits = counters[3]
        if not initial and ledger and n:
            bad = track_length_violated(pos, origin, dest, pseg,
                                        iters.max(), tolerance)
            bits = bits | (bad.to(torch.int64) << TRACK_CHECK)
        made, bits = torch.stack([counters[0], bits]).tolist()  # one read
        timing.count("checks")
        raise_on_violation(bits)
        return (out, rec, made) if ordered else out
    if not ordered:
        return out
    with timing.step("count_wait"):
        made = int(counters[0].item())
    timing.count("count")
    return out, rec, made


def _result(o, *, ledger, stats, records=None, **_) -> TraceResult:
    with timing.span("walk.result"):
        iters, dev = o["iters"], o["iters"].device
        nseg = o["nseg"].sum(dtype=torch.int64)
        n_crossings = (
            iters.max().to(torch.int64) if iters.numel()
            else torch.zeros((), dtype=torch.int64, device=dev)
        )
        return TraceResult(
            position=o["pos"],
            elem=o["elem"],
            material_id=resolve_material(o["mat"], o["material_id"],
                                         o["mesh"].class_values),
            flux=o["flux"],
            n_segments=nseg,
            n_crossings=n_crossings,
            done=o["done"],
            lane_iters=iters,
            track_length=o["pseg"] if ledger else None,
            stats=(
                walk_stats_vector(o["ncross"], o["nchase"], o["done"], nseg,
                                  n_crossings)
                if stats else None
            ),
            n_records=records,
            xpoints=o["xp"],
            n_xpoints=o["kx"],
        )
