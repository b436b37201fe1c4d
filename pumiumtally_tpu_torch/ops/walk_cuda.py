"""Wrapper of the CUDA walk kernel ``csrc/walk.cu``.

Counterpart of ``pumiumtally_tpu/ops/walk_pallas.py::trace_pallas_impl``:
the same call as the plain walk (``ops/walk.py::trace``), one kernel launch
for the whole move, then the per-lane outputs are reduced to the stats
vector with torch ops outside the kernel.

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
buffers. The scatter counts its own launches.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build, scatter
from .walk import (
    TraceResult,
    check_walk_args,
    resolve_material,
    trace as trace_plain,
    walk_stats_vector,
)

LAUNCHES = 0
RELAUNCHES = 0
TALLIES = ("ordered", "atomic")

_ARGTYPES = (
    [ctypes.c_int] * 3               # robust, initial, ordered
    + [ctypes.c_void_p] * 7          # geo, origin, dest, elem, fly, weight, group
    + [ctypes.c_int] * 3             # n, n_groups, max_crossings
    + [ctypes.c_double, ctypes.c_int]  # tolerance, score_squares
    + [ctypes.c_void_p] * 14         # flux, 9 per-lane outputs, 4 record buffers
    + [ctypes.c_longlong, ctypes.c_void_p]  # capacity, stream
)
_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}


@dataclasses.dataclass
class Records:
    """The scored crossings of one ordered walk: ``c = seg·w`` goes to bin
    ``elem·G + g`` with key ``order = iteration·n + lane``."""

    bin: torch.Tensor    # [m] int32
    order: torch.Tensor  # [m] int64
    c: torch.Tensor      # [m], the walk's dtype


def _entry(dtype):
    fn = getattr(_build.load("walk"), f"pumi_walk_{_DTYPE_TAG[dtype]}")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


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
    if tally == "atomic" or initial:
        return _result(_launch(*args, **kw, ordered=False), **kw)
    out, rec = _walk_ordered(*args, **kw, capacity=capacity)
    scatter.ordered_cuda(flux, rec.bin, rec.order, rec.c, score_squares,
                         mesh.ntet * n_groups)
    return _result(out, **kw)


def walk_records(mesh, origin, dest, elem, in_flight, weight, group,
                 material_id, flux, *, max_crossings: int, n_groups: int,
                 score_squares: bool = True, tolerance: float = 1e-8,
                 robust: bool = True, ledger: bool = True, stats: bool = True,
                 capacity: int | None = None):
    """The ordered walk of a move (``initial=False``) on the card without
    its scatter: returns its TraceResult, whose flux is left as it was,
    and its Records. ``scatter.scatter_ordered`` of the records into the
    flux completes ``trace``."""
    args = (mesh, origin, dest, elem, in_flight, weight, group,
            material_id, flux)
    if origin.device.type != "cuda":
        raise ValueError("walk records come from the CUDA kernel only")
    _check_cuda(*args, n_groups, max_crossings)
    kw = dict(initial=False, max_crossings=max_crossings, n_groups=n_groups,
              score_squares=score_squares, tolerance=tolerance,
              robust=robust, ledger=ledger, stats=stats)
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


def _walk_ordered(*args, capacity, **kw):
    global RELAUNCHES
    cap = capacity if capacity is not None else 4 * args[1].shape[0]
    out, rec, made = _launch(*args, **kw, ordered=True, capacity=cap)
    if made > cap:
        out, rec, again = _launch(*args, **kw, ordered=True, capacity=made)
        RELAUNCHES += 1
        if again != made:
            raise RuntimeError(
                f"the walk made {made} records, then {again} from the same "
                "inputs"
            )
    return out, Records(rec[0][:made], rec[1][:made], rec[2][:made])


def _launch(mesh, origin, dest, elem, in_flight, weight, group, material_id,
            flux, *, initial, max_crossings, n_groups, score_squares,
            tolerance, robust, ledger, stats, ordered, capacity=0):
    """One walk launch. Returns the per-lane outputs and, when ordered,
    the record buffers and the number of records the walk made."""
    global LAUNCHES
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
    count = torch.zeros(1, dtype=torch.int64, device=dev)

    fn = _entry(dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            int(bool(robust)), int(bool(initial)), int(bool(ordered)),
            mesh.geo20.data_ptr(), origin.data_ptr(), dest.data_ptr(),
            elem.data_ptr(), in_flight.data_ptr(), weight.data_ptr(),
            group.data_ptr(), n, n_groups, max_crossings, float(tolerance),
            int(bool(score_squares)), flux.data_ptr(), pos.data_ptr(),
            elem_o.data_ptr(), mat.data_ptr(), done.data_ptr(),
            pseg.data_ptr(), ncross.data_ptr(), nchase.data_ptr(),
            nseg_l.data_ptr(), iters.data_ptr(), rec[0].data_ptr(),
            rec[1].data_ptr(), rec[2].data_ptr(), count.data_ptr(), cap,
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"walk kernel launch failed with cudaError_t {err}"
        )
    LAUNCHES += 1
    out = dict(mesh=mesh, material_id=material_id, flux=flux, pos=pos,
               elem=elem_o, mat=mat, done=done, pseg=pseg, ncross=ncross,
               nchase=nchase, nseg=nseg_l, iters=iters)
    if not ordered:
        return out
    return out, rec, int(count.item())


def _result(o, *, ledger, stats, **_) -> TraceResult:
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
    )
