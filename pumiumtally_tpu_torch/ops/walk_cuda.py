"""Wrapper of the CUDA walk kernel ``csrc/walk.cu``.

Counterpart of ``pumiumtally_tpu/ops/walk_pallas.py::trace_pallas_impl``:
the same call as the plain walk (``ops/walk.py::trace``), one kernel launch
for the whole move, then the per-lane outputs are reduced to the stats
vector with torch ops outside the kernel.

A CPU tensor goes to the plain walk. A CUDA tensor goes to the kernel,
which is built with nvcc at first use; a failed build or launch raises.
``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .walk import (
    TraceResult,
    check_walk_args,
    resolve_material,
    trace as trace_plain,
    walk_stats_vector,
)

LAUNCHES = 0

_ARGTYPES = (
    [ctypes.c_void_p] * 7            # geo, origin, dest, elem, fly, weight, group
    + [ctypes.c_int] * 3             # n, n_groups, max_crossings
    + [ctypes.c_double, ctypes.c_int]  # tolerance, score_squares
    + [ctypes.c_void_p] * 11         # flux, 9 per-lane outputs, stream
)
_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}


def _entry(dtype, robust: bool, initial: bool):
    lib = _build.load("walk")
    fn = getattr(
        lib, f"pumi_walk_{_DTYPE_TAG[dtype]}_r{int(robust)}_i{int(initial)}"
    )
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
) -> TraceResult:
    """The walk of ``ops/walk.py::trace`` (same arguments, same result):
    the CUDA kernel for CUDA tensors, the plain walk for CPU tensors. The
    flux is updated in place."""
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
    return _trace_cuda(*args, **kw)


def _trace_cuda(mesh, origin, dest, elem, in_flight, weight, group,
                material_id, flux, *, initial, max_crossings, n_groups,
                score_squares, tolerance, robust, ledger, stats):
    global LAUNCHES
    check_walk_args(mesh, origin, dest, elem, in_flight, weight, group,
                    material_id, flux, n_groups)
    if mesh.geo20.data_ptr() % 16:
        raise ValueError("geo20 must be 16-byte aligned for the row loads")
    if max_crossings >= 2**31:
        raise ValueError(f"max_crossings must fit int32: {max_crossings}")
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

    fn = _entry(dtype, robust, initial)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            mesh.geo20.data_ptr(), origin.data_ptr(), dest.data_ptr(),
            elem.data_ptr(), in_flight.data_ptr(), weight.data_ptr(),
            group.data_ptr(), n, n_groups, max_crossings, float(tolerance),
            int(bool(score_squares)), flux.data_ptr(), pos.data_ptr(),
            elem_o.data_ptr(), mat.data_ptr(), done.data_ptr(),
            pseg.data_ptr(), ncross.data_ptr(), nchase.data_ptr(),
            nseg_l.data_ptr(), iters.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"walk kernel launch failed with cudaError_t {err}"
        )
    LAUNCHES += 1

    nseg = nseg_l.sum(dtype=torch.int64)
    n_crossings = (
        iters.max().to(torch.int64) if n
        else torch.zeros((), dtype=torch.int64, device=dev)
    )
    return TraceResult(
        position=pos,
        elem=elem_o,
        material_id=resolve_material(mat, material_id, mesh.class_values),
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
    )
