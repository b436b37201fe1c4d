"""Wrapper of the fused integrity-vector kernel ``csrc/integrity.cu``.

``integrity_vector`` gives the walk's end-of-walk conservation vector
(``integrity/invariants.py`` field order, the walk's dtype), the
counterpart of ``pumiumtally_tpu/ops/walk.py::integrity_vector`` (:274),
which the JAX package left to XLA: one launch reads the lanes and the
flux once, with no host read and no float atomics (the vector is the
same bits from run to run). A CPU tensor goes to the plain version
(``ops/walk.py::integrity_vector``); a CUDA tensor goes to the kernel,
built with nvcc at first use (``ops/_build.py``), or raises; any other
device raises. The counts and ``bad_flux`` equal the plain version's;
the sums agree to their order (the plain version's dot products add in
cuBLAS's). ``walk_cuda.trace`` calls it for ``integrity``, on the
facade's moves and in the megastep. ``LAUNCHES`` counts kernel launches
and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from ..integrity.invariants import INTEGRITY_LEN
from . import _build
from .walk import integrity_vector as integrity_vector_plain

LAUNCHES = 0

_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}
_ARGTYPES = (
    [ctypes.c_void_p] * 6               # in_flight, done, weight, pseg,
                                        # cur, origin
    + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]  # n, flux,
                                                               # nflux
    + [ctypes.c_int]                    # initial
    + [ctypes.c_void_p] * 4             # partials, ticket, out, stream
)
#: The C entries of csrc/integrity.cu this module binds.
SYMBOLS = tuple(f"pumi_integrity_{t}" for t in _DTYPE_TAG.values()) + (
    "pumi_integrity_partial_bytes", "pumi_integrity_smem")
_FNS: dict = {}
# Per (device, stream): the blocks' partials and the last-block ticket
# (zero between launches: the last block resets it).
_WORKSPACES: dict = {}


def _entry(dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        fn = _build.bind("integrity", f"pumi_integrity_{_DTYPE_TAG[dtype]}",
                         SYMBOLS)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def _host_entry(name: str) -> int:
    fn = _build.bind("integrity", name, SYMBOLS)
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return int(fn())


def dynamic_smem() -> int:
    """The dynamic shared memory bytes a launch passes
    (``pumi_integrity_smem``; analysis/costmodel.py checks its mirror)."""
    return _host_entry("pumi_integrity_smem")


def _workspace(dev, stream: int) -> dict:
    key = (dev.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = _WORKSPACES[key] = dict(
            partials=torch.empty(
                _host_entry("pumi_integrity_partial_bytes"),
                dtype=torch.uint8, device=dev),
            ticket=torch.zeros(1, dtype=torch.int32, device=dev))
    return ws


def check(in_flight, done, weight, pseg, cur, origin, flux) -> None:
    """Raise ValueError unless the vector's inputs are what the kernel
    takes: float32 or float64 lanes and flux of one dtype, bool flags,
    ``[n]`` lanes and ``[n, 3]`` positions, all contiguous on one
    device."""
    dtype, dev = flux.dtype, flux.device
    if dtype not in _DTYPE_TAG:
        raise ValueError(
            f"the integrity vector is float32 or float64, not {dtype}")
    n = in_flight.shape[0] if in_flight.dim() == 1 else -1
    expect = {
        "in_flight": (in_flight, (n,), torch.bool),
        "done": (done, (n,), torch.bool),
        "weight": (weight, (n,), dtype), "pseg": (pseg, (n,), dtype),
        "cur": (cur, (n, 3), dtype), "origin": (origin, (n, 3), dtype),
    }
    for name, (t, shape, dt) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the flux on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not flux.is_contiguous():
        raise ValueError("flux must be contiguous")


def integrity_vector(in_flight, done, weight, pseg, cur, origin, flux,
                     initial: bool) -> torch.Tensor:
    """The ``[INTEGRITY_LEN]`` vector of ``ops/walk.py::integrity_vector``
    (same arguments): the plain version for CPU tensors, the fused kernel
    for CUDA tensors. The flux is read, never written."""
    global LAUNCHES
    check(in_flight, done, weight, pseg, cur, origin, flux)
    dev = flux.device
    if dev.type == "cpu":
        return integrity_vector_plain(in_flight, done, weight, pseg, cur,
                                      origin, flux, initial)
    if dev.type != "cuda":
        raise ValueError(
            f"the integrity vector runs on 'cuda' or 'cpu', not {dev}")
    out = torch.empty(INTEGRITY_LEN, dtype=flux.dtype, device=dev)
    fn = _entry(flux.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = _workspace(dev, stream)
        err = fn(in_flight.data_ptr(), done.data_ptr(), weight.data_ptr(),
                 pseg.data_ptr(), cur.data_ptr(), origin.data_ptr(),
                 in_flight.shape[0], flux.data_ptr(), flux.numel(),
                 int(bool(initial)), ws["partials"].data_ptr(),
                 ws["ticket"].data_ptr(), out.data_ptr(), stream)
    if err != 0:
        # A launch that failed may leave the ticket part counted.
        _WORKSPACES.pop((dev.index, stream), None)
        raise RuntimeError(
            f"integrity vector kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return out
