"""Wrapper of the CUDA walk kernel ``csrc/walk.cu``.

Counterpart of ``pumiumtally_tpu/ops/walk_pallas.py::trace_pallas_impl``:
the same call as the plain walk (``ops/walk.py::trace``), one kernel launch
for the whole move, then the per-lane outputs are reduced to the stats
vector with torch ops outside the kernel. The kernel's threads stay
resident and refill: each walks lane after lane, so no thread idles while
its warp finishes. The lanes are taken in an order that keeps the rows of
the lanes in flight close (``lane_slots``, one ``scatter.lane_order`` pass
before every launch).

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
buffers. The scatter and the lane order count their own launches.
``WARP_TRIPS`` is the last launch's device counter (an int64 on the card,
read only when the caller reads it): its warps' loop trips, summed, so
Σ ``lane_iters`` / (32 · ``WARP_TRIPS``) is the share of the warps' lane
slots that did work. ``LAST_WAIT_S`` is the host time the last ordered
launch spent waiting at its one host read, the record count.

The ordered scatter takes at most 2^31 − 1 records a call
(``check_record_count``): a walk that makes more raises before its
records reach the scatter. ``record_capacity``, ``face_rate`` and
``path_records`` size an ordered walk's record buffers from an estimate
on the host; ``trace_packed`` is ``trace`` between the move-loop records
of ``ops/staging.py``.
"""
from __future__ import annotations

import ctypes
import math
import time

import numpy as np
import torch

from . import _build, scatter
from .walk import (
    Records,
    TraceResult,
    check_walk_args,
    packed_step,
    resolve_material,
    trace as trace_plain,
    trace_records as trace_records_plain,
    walk_stats_vector,
)

LAUNCHES = 0
RELAUNCHES = 0
WARP_TRIPS: torch.Tensor | None = None
LAST_WAIT_S = 0.0
TALLIES = ("ordered", "atomic")
_INT32_MAX = 2**31 - 1

_ARGTYPES = (
    [ctypes.c_int] * 3               # robust, initial, ordered
    + [ctypes.c_void_p] * 9          # geo, origin, dest, elem, fly, weight,
                                     # group, perm, lane records
    + [ctypes.c_int] * 3             # n, n_groups, max_crossings
    + [ctypes.c_double, ctypes.c_int]  # tolerance, score_squares
    + [ctypes.c_void_p] * 14         # flux, 9 per-lane outputs, 3 record
                                     # buffers, counters
    + [ctypes.c_longlong, ctypes.c_void_p]  # capacity, stream
)
_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}
_LANE_BYTES = {torch.float32: 48, torch.float64: 80}  # csrc/walk.cu Lane<T>


def _entry(dtype):
    fn = getattr(_build.load("walk"), f"pumi_walk_{_DTYPE_TAG[dtype]}")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def resident_threads(dtype, *, initial: bool, robust: bool = True,
                     ordered: bool = True) -> int:
    """Threads a walk launch keeps resident on the current card (its grid
    for a large n): the lanes in flight at once."""
    fn = getattr(_build.load("walk"),
                 f"pumi_walk_resident_{_DTYPE_TAG[dtype]}")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(int(robust), int(initial), int(ordered and not initial),
             ctypes.addressof(out))
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
) -> TraceResult:
    """The walk of ``ops/walk.py::trace`` (same arguments, same result):
    the CUDA kernel for CUDA tensors, the plain walk for CPU tensors. The
    flux is updated in place.

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
        ledger=ledger, stats=stats,
    )
    args = (mesh, origin, dest, elem, in_flight, weight, group,
            material_id, flux)
    if origin.device.type == "cpu":
        return trace_plain(*args, **kw)
    if origin.device.type != "cuda":
        raise ValueError(f"the walk runs on 'cuda' or 'cpu', not {origin.device}")
    _check_cuda(*args, n_groups, max_crossings)
    if tally == "atomic" and flux.data_ptr() % 8:
        raise ValueError("flux must be 8-byte aligned for the pair adds")
    if tally == "atomic" or initial:
        return _result(_launch(*args, **kw, ordered=False,
                               perm=lane_slots(mesh, elem, dest, initial)),
                       **kw)
    out, rec = _walk_ordered(*args, **kw, capacity=capacity)
    scatter.ordered_cuda(flux, rec.bin, rec.order, rec.c, score_squares,
                         mesh.ntet * n_groups)
    return _result(out, **kw, records=rec.bin.numel())


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


def walk_records(mesh, origin, dest, elem, in_flight, weight, group,
                 material_id, flux, *, max_crossings: int, n_groups: int,
                 score_squares: bool = True, tolerance: float = 1e-8,
                 robust: bool = True, ledger: bool = True, stats: bool = True,
                 capacity: int | None = None):
    """The ordered walk of a move (``initial=False``) without its scatter:
    returns its TraceResult, whose flux is left as it was, and its
    Records. ``scatter.scatter_ordered`` of the records into the flux
    completes ``trace``. CPU tensors take the plain walk
    (``ops/walk.py::trace_records``)."""
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
    out, rec = _walk_ordered(*args, **kw, capacity=capacity)
    return _result(out, **kw), rec


def _check_cuda(mesh, origin, dest, elem, in_flight, weight, group,
                material_id, flux, n_groups, max_crossings):
    check_walk_args(mesh, origin, dest, elem, in_flight, weight, group,
                    material_id, flux, n_groups)
    if mesh.geo20.data_ptr() % 16:
        raise ValueError("geo20 must be 16-byte aligned for the row loads")
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


def _walk_ordered(*args, capacity, **kw):
    global RELAUNCHES
    cap = capacity if capacity is not None else 4 * args[1].shape[0]
    perm = lane_slots(args[0], args[3], args[2], kw["initial"])
    out, rec, made = _launch(*args, **kw, ordered=True, capacity=cap,
                             perm=perm)
    check_record_count(made)
    if made > cap:
        out, rec, again = _launch(*args, **kw, ordered=True, capacity=made,
                                  perm=perm)
        RELAUNCHES += 1
        if again != made:
            raise RuntimeError(
                f"the walk made {made} records, then {again} from the same "
                "inputs"
            )
    return out, Records(rec[0][:made], rec[1][:made], rec[2][:made])


def lane_slots(mesh, elem, dest, initial: bool):
    """The order in which a walk launch's threads take the lanes (slot s
    walks lane ``perm[s]``): a move's lanes by start element; the initial
    search's, which all start from one point, by the cell of their
    destination on a grid over the mesh's bounding box, so lanes that
    walk the same rows run side by side."""
    if not initial:
        return scatter.lane_order_cuda(elem, mesh.ntet)
    return scatter.lane_order_cuda(*destination_cells(mesh, dest))


def destination_cells(mesh, dest):
    """Each lane's cell on a grid over the mesh's bounding box with about
    one cell per 6 elements (a hexahedron's worth), in raster order, as
    int32 keys; and the number of cells. Destinations outside the box
    take the nearest cell (a non-finite one a cell of the box)."""
    lo, ext = mesh.bounds
    ext = [max(e, 1e-30) for e in ext]
    side = (ext[0] * ext[1] * ext[2] * 6.0 / max(mesh.ntet, 1)) ** (1 / 3)
    cells = [max(1, min(1024, round(e / side))) for e in ext]
    c = [((dest[:, k] - lo[k]) * (cells[k] / ext[k])).nan_to_num_(0.0)
         .floor_().clamp_(0, cells[k] - 1).to(torch.int32) for k in range(3)]
    keys = (c[2] * cells[1] + c[1]) * cells[0] + c[0]
    return keys, cells[0] * cells[1] * cells[2]


def _launch(mesh, origin, dest, elem, in_flight, weight, group, material_id,
            flux, *, initial, max_crossings, n_groups, score_squares,
            tolerance, robust, ledger, stats, ordered, perm, capacity=0):
    """One walk launch; slot s walks lane ``perm[s]`` (lane s when
    ``perm`` is None). Returns the per-lane outputs and, when ordered,
    the record buffers and the number of records the walk made."""
    global LAUNCHES, WARP_TRIPS, LAST_WAIT_S
    dtype, dev = origin.dtype, origin.device
    n = origin.shape[0]

    def lanes(dt):
        return torch.empty(n, dtype=dt, device=dev)

    pos = torch.empty_like(origin)
    elem_o, mat, ncross, nchase, nseg_l, iters = (
        lanes(torch.int32) for _ in range(6)
    )
    done = lanes(torch.bool)
    pseg = lanes(dtype)
    cap = capacity if ordered else 0
    rec = (
        torch.empty(cap, dtype=torch.int32, device=dev),
        torch.empty(cap, dtype=torch.int64, device=dev),
        torch.empty(cap, dtype=dtype, device=dev),
    )
    # Records made, lane slots taken, warp loop trips.
    counters = torch.zeros(3, dtype=torch.int64, device=dev)
    packed = torch.empty(n * _LANE_BYTES[dtype], dtype=torch.uint8,
                         device=dev)

    fn = _entry(dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            int(bool(robust)), int(bool(initial)), int(bool(ordered)),
            mesh.geo20.data_ptr(), origin.data_ptr(), dest.data_ptr(),
            elem.data_ptr(), in_flight.data_ptr(), weight.data_ptr(),
            group.data_ptr(), 0 if perm is None else perm.data_ptr(),
            packed.data_ptr(), n, n_groups, max_crossings, float(tolerance),
            int(bool(score_squares)), flux.data_ptr(), pos.data_ptr(),
            elem_o.data_ptr(), mat.data_ptr(), done.data_ptr(),
            pseg.data_ptr(), ncross.data_ptr(), nchase.data_ptr(),
            nseg_l.data_ptr(), iters.data_ptr(), rec[0].data_ptr(),
            rec[1].data_ptr(), rec[2].data_ptr(), counters.data_ptr(), cap,
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"walk kernel launch failed with cudaError_t {err}"
        )
    LAUNCHES += 1
    WARP_TRIPS = counters[2]
    out = dict(mesh=mesh, material_id=material_id, flux=flux, pos=pos,
               elem=elem_o, mat=mat, done=done, pseg=pseg, ncross=ncross,
               nchase=nchase, nseg=nseg_l, iters=iters)
    if not ordered:
        return out
    t0 = time.perf_counter()
    made = int(counters[0].item())
    LAST_WAIT_S = time.perf_counter() - t0
    return out, rec, made


def _result(o, *, ledger, stats, records=None, **_) -> TraceResult:
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
    )
